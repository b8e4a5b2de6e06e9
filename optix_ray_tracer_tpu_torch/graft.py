"""Entry points of the port in the form of the repository's
``__graft_entry__.py``: the flagship render step with LBVH traversal,
and a dry run of the sharded paths on an n-shard mesh.

    python -c "from optix_ray_tracer_tpu_torch.graft import \\
        dryrun_multichip; dryrun_multichip(8, device='cpu')"
"""

from __future__ import annotations

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.utils.tensors import resolve_device


def _flagship_scene(n_tris: int = 2048, device=None):
    """A small instance of the flagship workload: a sphere mesh (ROUGH)
    beside a METAL sphere over a ground sphere."""
    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, Spheres, Triangles,
    )
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    dev = resolve_device(device)
    mb = MaterialBuilder()
    ground = mb.add_rough((0.70, 0.60, 0.50))
    red = mb.add_rough((0.65, 0.05, 0.05))
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.1)
    v, n = sphere_with_n_triangles(n_tris, center=(0, 0, 0), radius=0.5)
    scene = Scene(
        spheres=Spheres.from_list([((0.0, 0.0, -100.5), 100.0, ground),
                                   ((0.0, 1.2, 0.3), 0.5, metal)], dev),
        triangles=Triangles.from_arrays(v, n, red, device=dev))
    cam = Camera.look_at((4.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=dev)
    return scene, mb.build(dev), cam


def entry(device=None):
    """(fn, example_args): the flagship Whitted step (64x64, 1 spp, depth
    5) through the LBVH intersector; ``fn(*example_args)`` is the image."""
    from optix_ray_tracer_tpu_torch.ops.traverse import make_intersector
    from optix_ray_tracer_tpu_torch.render import wavefront

    scene, mats, cam = _flagship_scene(device=device)
    intersector = make_intersector(scene)

    def fn(scene, materials, camera, intersector, seed):
        img, _, _ = wavefront.render(scene, materials, camera, 64, 64,
                                     spp=1, seed=seed,
                                     intersector=intersector)
        return img

    return fn, (scene, mats, cam, intersector, 0)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Build an n-shard mesh (``device`` repeated, None: the card) and run
    one sharded Whitted, path and fused step and two ReSTIR frames on
    tiny shapes, checking shapes and finiteness."""
    from optix_ray_tracer_tpu_torch.models.fused import fused_chunk
    from optix_ray_tracer_tpu_torch.parallel.sharding import (
        make_mesh, render_path_sharded, render_restir_sharded,
        render_sharded,
    )
    from optix_ray_tracer_tpu_torch.render import temporal as tmod
    from optix_ray_tracer_tpu_torch.render.restir import (
        empty_reservoir_state,
    )
    from optix_ray_tracer_tpu_torch.scene.geometry import Scene, Triangles
    from optix_ray_tracer_tpu_torch.scene.lights import collect_area_lights
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    dev = resolve_device(device)
    if n_devices >= 4:
        tile, sample = n_devices // 2, 2
    else:
        tile, sample = n_devices, 1
    mesh = make_mesh(tile=tile, sample=sample, devices=[dev] * n_devices)

    scene, mats, cam = _flagship_scene(n_tris=64, device=dev)
    height = 8 * tile
    spp = 2 * sample
    img = render_sharded(scene, mats, cam, 16, height, spp, mesh, seed=0)
    assert img.shape == (height, 16, 3) and torch.isfinite(img).all()

    # the NEE+MIS path integrator: an emissive quad over the spheres
    mb = MaterialBuilder()
    mb.add_rough((0.73, 0.73, 0.73))
    emit = mb.add_emissive((15.0, 15.0, 12.0))
    quad = np.asarray([[[-.5, -.5, 1.5], [.5, -.5, 1.5], [.5, .5, 1.5]],
                       [[-.5, -.5, 1.5], [.5, .5, 1.5], [-.5, .5, 1.5]]],
                      np.float32)
    nrm = np.tile(np.asarray([0.0, 0.0, -1.0], np.float32), (2, 3, 1))
    pscene = Scene(spheres=scene.spheres, triangles=Triangles.from_arrays(
        quad, nrm, np.asarray([emit, emit], np.int32), device=dev))
    pmats = mb.build(dev)
    lights = collect_area_lights(pscene, pmats)
    pimg = render_path_sharded(pscene, pmats, lights, cam, 16, height, spp,
                               mesh, seed=0, max_depth=4)
    assert pimg.shape == (height, 16, 3) and torch.isfinite(pimg).all()

    # the sharded fused step: instance motion, render, temporal
    # reprojection, denoise and uint8 quantisation of two frames
    t8 = np.zeros((8, 3, 3), np.float32)
    t8[:, 1, 0] = 0.4
    t8[:, 2, 1] = 0.4
    t8 += np.linspace(-1.0, 1.0, 8, dtype=np.float32)[:, None, None]
    n8 = np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (8, 3, 1))
    fd = dict(
        vertices=torch.as_tensor(t8, device=dev),
        normals=torch.as_tensor(n8, device=dev),
        tri_particle=torch.zeros(8, dtype=torch.int32, device=dev),
        tri_valid=torch.ones(8, dtype=torch.bool, device=dev),
        velocities=torch.tensor([[0.1, 0.0, 0.0]], device=dev),
        particle_mat=torch.zeros(1, dtype=torch.int32, device=dev),
        duration=np.float32(1.0), inv_frame_count=np.float32(0.5),
        particle_shift=np.zeros(3, np.float32),
        particle_scale=np.float32(1.0))
    (frames,), _ = fused_chunk(
        fd, [0, 1], [0, 1], None, mats, cam, scene.spheres,
        Triangles.empty(dev), None, None, None, (0.7, 0.8, 0.9),
        tmod.empty_state(16, height, dev), mode="mesh", width=16,
        height=height, spp=spp, integrator="whitted", do_denoise=True,
        max_depth=3, use_march=False, has_extras=False, quantize=True,
        want_guides=False, temporal=True, mesh=mesh)
    assert frames.shape == (2, height, 16, 4) and frames.dtype == torch.uint8

    # ReSTIR DI over a tile-only mesh, two frames (temporal reuse and
    # spatial taps across band edges)
    rmesh = make_mesh(tile=n_devices, devices=[dev] * n_devices)
    rheight = 8 * n_devices
    rstate = empty_reservoir_state(16, rheight, dev)
    for f in range(2):
        rimg, _, _, rstate = render_restir_sharded(
            pscene, pmats, lights, cam, 16, rheight, rmesh, seed=0, frame=f,
            state=rstate, m_candidates=4, spatial_taps=2, spatial_radius=8)
    assert rimg.shape == (rheight, 16, 3) and torch.isfinite(rimg).all()

    print(f"dryrun_multichip ok: mesh=(tile={tile}, sample={sample}) on "
          f"{dev}, whitted {tuple(img.shape)} mean {float(img.mean()):.4f}, "
          f"path {tuple(pimg.shape)} mean {float(pimg.mean()):.4f}, "
          f"fused chunk {tuple(frames.shape)} mean "
          f"{float(frames.float().mean()):.1f}, restir {tuple(rimg.shape)} "
          f"mean {float(rimg.mean()):.4f}")
