"""The five BASELINE.md benchmark configurations as ready-made scenes
(port of ``optix_ray_tracer_tpu/models/benchmarks.py``).

1. a Lambertian sphere on a ground sphere, 256x256, 16 spp;
2. specular and dielectric spheres, depth-8 Whitted;
3. a triangle mesh (bunny-class), diffuse;
4. the Cornell box, area-light NEE+MIS, 1024x1024, 1024 spp;
5. a Sponza-class atrium (110k triangles) with a checker texture and a
   sun-sky environment map, 1920x1088.

Each builder returns a dict with everything :func:`run` needs; its
tensors lie on ``device`` (None: the card).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.io.meshgen import (
    quad, sphere_with_n_triangles,
)
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder


def config1_sphere_ground(device=None):
    """A Lambertian sphere on a ground sphere, lit by the background."""
    mb = MaterialBuilder()
    ground = mb.add_rough((0.70, 0.60, 0.50))
    red = mb.add_rough((0.65, 0.05, 0.05))
    scene = Scene(
        spheres=Spheres.from_list([((0, 0, -1000.5), 1000.0, ground),
                                   ((0, 0, 0), 0.5, red)], device),
        triangles=Triangles.empty(device))
    cam = Camera.look_at((5.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=device)
    return dict(name="sphere_ground", scene=scene,
                materials=mb.build(device), camera=cam, width=256,
                height=256, spp=16, max_depth=5, integrator="whitted",
                background=(0.7, 0.8, 0.9))


def config2_whitted_spheres(device=None):
    """Specular and dielectric spheres, depth 8."""
    mb = MaterialBuilder()
    ground = mb.add_rough((0.5, 0.5, 0.5))
    glass = mb.add_dielectric(1.5)
    metal = mb.add_metal((0.7, 0.6, 0.5), 0.0)
    fuzzy = mb.add_metal((0.8, 0.8, 0.9), 0.3)
    diffuse = mb.add_rough((0.4, 0.2, 0.1))
    rows = [((0, 0, -1000.5), 1000.0, ground),
            ((0, 0, 0), 0.5, glass),
            ((0, -1.1, 0), 0.5, diffuse),
            ((0, 1.1, 0), 0.5, metal)]
    rng = np.random.default_rng(3)
    for _ in range(20):
        p = rng.uniform([-3, -3, -0.4], [1.5, 3, -0.3])
        rows.append((tuple(p), 0.1,
                     int(rng.choice([glass, metal, fuzzy, diffuse]))))
    scene = Scene(spheres=Spheres.from_list(rows, device),
                  triangles=Triangles.empty(device))
    cam = Camera.look_at((5.0, 0.0, 0.6), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=device)
    return dict(name="whitted_spheres", scene=scene,
                materials=mb.build(device), camera=cam, width=512,
                height=512, spp=16, max_depth=8, integrator="whitted",
                background=(0.7, 0.8, 0.9))


def config3_mesh_diffuse(n_tris: int = 70_000, device=None):
    """A bunny-class mesh (two blended tessellated spheres), diffuse."""
    mb = MaterialBuilder()
    ground = mb.add_rough((0.6, 0.6, 0.6))
    body = mb.add_rough((0.7, 0.55, 0.35))
    v1, n1 = sphere_with_n_triangles(int(n_tris * 0.7), (0, 0, 0), 0.5)
    v2, n2 = sphere_with_n_triangles(n_tris - int(n_tris * 0.7),
                                     (0.25, 0, 0.45), 0.3)
    tris = Triangles.from_arrays(np.concatenate([v1, v2]),
                                 np.concatenate([n1, n2]), body,
                                 device=device)
    scene = Scene(spheres=Spheres.from_list([((0, 0, -1000.5), 1000.0,
                                              ground)], device),
                  triangles=tris)
    cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.1), (0.0, 0.0, 1.0),
                         device=device)
    return dict(name="mesh_diffuse", scene=scene, materials=mb.build(device),
                camera=cam, width=1024, height=1024, spp=4, max_depth=5,
                integrator="whitted", background=(0.7, 0.8, 0.9))


def config3_bunny(obj_path: str, device=None):
    """Config 3 with a user's OBJ file (e.g. the Stanford bunny)."""
    from optix_ray_tracer_tpu_torch.io.obj import obj_to_scene
    tris, materials, _ = obj_to_scene(obj_path, device=device)
    scene = Scene(spheres=Spheres.empty(device), triangles=tris)
    v = tris.vertices.reshape(-1, 3).cpu().numpy()
    center = v.mean(0)
    size = (v.max(0) - v.min(0)).max()
    cam = Camera.look_at(center + np.asarray([2.5 * size, 0, 0.5 * size]),
                         center, (0.0, 0.0, 1.0), device=device)
    return dict(name="bunny", scene=scene, materials=materials, camera=cam,
                width=1024, height=1024, spp=4, max_depth=5,
                integrator="whitted", background=(0.7, 0.8, 0.9))


def config4_cornell(device=None):
    """The Cornell box, NEE+MIS on its area light."""
    from optix_ray_tracer_tpu_torch.scene.cornell import build_cornell_box
    from optix_ray_tracer_tpu_torch.scene.lights import collect_area_lights
    scene, materials, camera = build_cornell_box(device=device)
    return dict(name="cornell", scene=scene, materials=materials,
                camera=camera, lights=collect_area_lights(scene, materials),
                width=1024, height=1024, spp=1024, max_depth=8,
                integrator="path", background=(0.0, 0.0, 0.0))


def config5_sponza_class(n_cols: int = 8, device=None):
    """A Sponza-class atrium, procedural: a floor, walls, two rows of
    columns of stacked tessellated drums (~110k triangles), a
    checker-textured floor and a sun-sky environment map."""
    from optix_ray_tracer_tpu_torch.render.envmap import gradient_sky
    from optix_ray_tracer_tpu_torch.scene.textures import (
        build_texture_set, checker_texture,
    )

    mb = MaterialBuilder()
    floor_mat = mb.add_rough((0.9, 0.9, 0.9))
    wall_mat = mb.add_rough((0.75, 0.70, 0.62))
    column_mat = mb.add_rough((0.82, 0.80, 0.75))
    vs, ns, ms, uvs = [], [], [], []

    def add(vn, mat, uv=None):
        v, n = vn
        vs.append(v)
        ns.append(n)
        ms.append(np.full(len(v), mat, np.int32))
        uvs.append(uv if uv is not None
                   else np.zeros((len(v), 3, 2), np.float32))

    # a 20 x 10 floor with planar uvs
    fv, fn = quad([-10, -5, 0], [10, -5, 0], [10, 5, 0], [-10, 5, 0])
    fuv = (fv[..., :2] + [10, 5]) / [20, 10]
    add((fv, fn), floor_mat, fuv.astype(np.float32))
    # side and end walls
    add(quad([-10, -5, 0], [-10, -5, 6], [10, -5, 6], [10, -5, 0]), wall_mat)
    add(quad([-10, 5, 0], [10, 5, 0], [10, 5, 6], [-10, 5, 6]), wall_mat)
    add(quad([-10, -5, 0], [-10, 5, 0], [-10, 5, 6], [-10, -5, 6]), wall_mat)
    # two rows of columns of stacked sphere drums (the triangle mass)
    per_col = max(110_000 // (2 * n_cols * 4), 800)
    for i in range(n_cols):
        x = -8.0 + i * (16.0 / max(n_cols - 1, 1))
        for y in (-3.0, 3.0):
            for k in range(4):
                add(sphere_with_n_triangles(per_col, (x, y, 0.6 + k * 1.1),
                                            0.55), column_mat)

    tris = Triangles.from_arrays(np.concatenate(vs), np.concatenate(ns),
                                 np.concatenate(ms), np.concatenate(uvs),
                                 device=device)
    scene = Scene(spheres=Spheres.empty(device), triangles=tris)
    mat_tex = [-1] * len(mb)
    mat_tex[floor_mat] = 0
    textures = build_texture_set([checker_texture(256, tiles=20)], mat_tex,
                                 device=device)
    env = gradient_sky(sun_dir=(0.4, 0.25, 0.88), sun_cos=0.9995,
                       device=device)
    # |target - center| sets the field of view (tan(half-fov) = 1/|W|)
    cam = Camera.look_at((-9.0, 0.0, 2.0), (-7.6, 0.25, 1.95),
                         (0.0, 0.0, 1.0), device=device)
    return dict(name="sponza_class", scene=scene,
                materials=mb.build(device), camera=cam, width=1920,
                height=1088, spp=4, max_depth=6, integrator="path",
                lights=None, env=env, textures=textures,
                background=(0.0, 0.0, 0.0))


ALL_CONFIGS = {
    1: config1_sphere_ground,
    2: config2_whitted_spheres,
    3: config3_mesh_diffuse,
    4: config4_cornell,
    5: config5_sponza_class,
}


def run(config: dict, spp: int | None = None, width: int | None = None,
        height: int | None = None, seed: int = 0, intersector=None):
    """Render a benchmark config once; returns ((image, albedo, normal),
    stats).  The intersector is ``models/common.choose_intersector``'s
    (built here and timed as ``build_s``) unless one is given.  On the
    card the render is timed to a ``torch.cuda.synchronize()``."""
    from optix_ray_tracer_tpu_torch.models.common import choose_intersector
    from optix_ray_tracer_tpu_torch.render import pathtracer, wavefront

    scene = config["scene"]
    w = width or config["width"]
    h = height or config["height"]
    s = spp or config["spp"]
    cuda = scene.triangles.vertices.is_cuda

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    if intersector is None:
        intersector = choose_intersector(scene)
    sync()
    build_s = time.perf_counter() - t0

    kwargs = dict(spp=s, seed=seed, max_depth=config["max_depth"],
                  intersector=intersector)
    t0 = time.perf_counter()
    if config["integrator"] == "path":
        out = pathtracer.render_path(
            scene, config["materials"], config.get("lights"),
            config["camera"], w, h, background=config["background"],
            env=config.get("env"), textures=config.get("textures"), **kwargs)
    else:
        out = wavefront.render(
            scene, config["materials"], config["camera"], w, h,
            background=config["background"], env=config.get("env"),
            **kwargs)
    sync()
    render_s = time.perf_counter() - t0
    stats = dict(name=config["name"], width=w, height=h, spp=s,
                 triangles=scene.triangle_count, spheres=scene.sphere_count,
                 build_s=build_s, render_s=render_s,
                 spp_per_sec=s / render_s,
                 mpaths_per_sec=w * h * s / render_s / 1e6)
    return out, stats
