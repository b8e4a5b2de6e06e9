"""The Cornell box (port of ``optix_ray_tracer_tpu/scene/cornell.py``;
BASELINE benchmark config 4).

White floor, ceiling and back, a red left and a green right wall, one
0.3 x 0.3 area light under the ceiling, optionally two blocks; the unit
box [0, 1]^3 with the camera on +z looking down -z.
"""

from __future__ import annotations

import numpy as np

from optix_ray_tracer_tpu_torch.io.meshgen import box, quad
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder


def build_cornell_box(light_radiance=(15.0, 15.0, 15.0),
                      with_blocks: bool = True,
                      sphere_instead_of_tall_block: bool = False,
                      device=None):
    """Returns (scene, materials, camera) on ``device`` (None: the card);
    the caller collects the lights (``scene/lights.collect_area_lights``)."""
    mb = MaterialBuilder()
    white = mb.add_rough((0.73, 0.73, 0.73))
    red = mb.add_rough((0.65, 0.05, 0.05))
    green = mb.add_rough((0.12, 0.45, 0.15))
    light = mb.add_emissive(light_radiance)
    mirror = mb.add_metal((0.9, 0.9, 0.9), 0.0)
    vs, ns, ms = [], [], []

    def add(vn, mat):
        v, n = vn
        vs.append(v)
        ns.append(n)
        ms.append(np.full(len(v), mat, np.int32))

    add(quad([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]), white)   # floor
    add(quad([0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0]), white)   # ceiling
    add(quad([0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0]), white)   # back
    add(quad([0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0]), red)     # left
    add(quad([1, 0, 0], [1, 1, 0], [1, 1, 1], [1, 0, 1]), green)   # right
    # the area light: a 0.3 x 0.3 panel just below the ceiling
    add(quad([0.35, 0.999, 0.35], [0.65, 0.999, 0.35],
             [0.65, 0.999, 0.65], [0.35, 0.999, 0.65]), light)
    spheres = Spheres.empty(device)
    if with_blocks:
        add(box([0.12, 0.0, 0.10], [0.47, 0.60, 0.45]), white)     # tall
        add(box([0.55, 0.0, 0.45], [0.85, 0.30, 0.75]), white)     # short
    if sphere_instead_of_tall_block:
        spheres = Spheres.from_list([((0.30, 0.75, 0.28), 0.12, mirror)],
                                    device)
    tris = Triangles.from_arrays(np.concatenate(vs, 0),
                                 np.concatenate(ns, 0),
                                 np.concatenate(ms, 0), device=device)
    camera = Camera.look_at((0.5, 0.5, 2.30), (0.5, 0.5, 0.0),
                            (0.0, 1.0, 0.0), device=device)
    return Scene(spheres=spheres, triangles=tris), mb.build(device), camera
