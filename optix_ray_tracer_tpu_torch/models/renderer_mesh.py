"""Mesh-mode frontend (port of
``optix_ray_tracer_tpu/models/renderer_mesh.py``; the reference's
``RendererMesh``, ``src/Global/RendererMesh.cu``).

Each VTK file carries full per-particle triangle geometry; files are
baked to a binary cache, loaded in a thread pool, and animated by
shifting each particle along its velocity across the file's duration
(``RendererMesh.cu:379-391``: shift = velocity * duration *
frame / frameCount, composed with the global particle offset and scale).
Per-file geometry is padded to one shape (the largest file's triangle
count), so one intersector serves every file: a host build on the first
file, a device rebuild on each later one, a device refit per frame.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.io import cache as cache_io
from optix_ray_tracer_tpu_torch.io.series import read_series
from optix_ray_tracer_tpu_torch.models import common
from optix_ray_tracer_tpu_torch.render.film import Film, U8Frame
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.utils import debug
from optix_ray_tracer_tpu_torch.utils.logging import LOG
from optix_ray_tracer_tpu_torch.utils.tensors import resolve_device


@dataclasses.dataclass
class MeshRendererData:
    """Committed scene state: tensors on the render device plus host
    metadata."""
    config: object
    materials: object             # MaterialTable
    material_offset: int
    extra_spheres: Spheres
    extra_triangles: Triangles    # static config meshes (appended per frame)
    env: object | None
    textures: object | None
    durations: list[float]
    # per-file tensors, padded to the max triangle / particle count
    vertices: torch.Tensor        # (F, Tmax, 3, 3) object space
    normals: torch.Tensor         # (F, Tmax, 3, 3)
    tri_particle: torch.Tensor    # (F, Tmax) int32 particle slot
    tri_valid: torch.Tensor       # (F, Tmax) bool
    velocities: torch.Tensor      # (F, Pmax, 3)
    particle_mat: torch.Tensor    # (F, Pmax) int32 material row
    file_count: int
    max_triangles: int
    camera: object
    update_fn: Callable | None = None   # analog of setAddGeoInsUpdateFunc


def commit(config, device=None) -> MeshRendererData:
    """Load the series and its caches and move the arrays to ``device``
    (None: the card) (``RendererMesh::commitRendererData``)."""
    dev = resolve_device(device)
    series = read_series(config.resolve(config.series_path),
                         config.series_name)
    LOG.info("mesh mode: %d files in series", series.count)

    frames = cache_io.load_or_bake(
        config.resolve(config.cache_path), series.paths,
        use_cache=True, thread_count=config.cache_process_thread_count)

    max_cells = max((len(f.ids) for f in frames), default=0)
    materials, bases = common.build_materials(config, max_cells, dev)
    extra_spheres = common.build_extra_spheres(config, bases, dev)
    extra_triangles = common.build_extra_triangles(config, bases, dev)
    env = common.build_envmap(config, dev)
    textures = common.build_textures(config, bases, materials.count, dev)

    verts = common.pad_stack([f.vertices for f in frames])
    normals = common.pad_stack([f.normals for f in frames])
    tmax = verts.shape[1] if verts.ndim > 1 else 0
    pmax = max(max_cells, 1)
    F = len(frames)
    tri_pid = np.zeros((F, tmax), np.int32)
    tri_valid = np.zeros((F, tmax), bool)
    vels = np.zeros((F, pmax, 3), np.float32)
    pmat = np.zeros((F, pmax), np.int32)
    for i, f in enumerate(frames):
        for p, (off, cnt) in enumerate(zip(f.tri_offsets, f.tri_counts)):
            tri_pid[i, off:off + cnt] = p
            tri_valid[i, off:off + cnt] = True
        vels[i, :len(f.velocities)] = f.velocities
        # per-particle material = ramp row id + materialOffset
        # (RendererMesh.cu:274-276)
        pmat[i, :len(f.ids)] = f.ids.astype(np.int32) + bases.material_offset

    def t(a):
        return torch.as_tensor(a, device=dev)

    return MeshRendererData(
        config=config, materials=materials,
        material_offset=bases.material_offset,
        extra_spheres=extra_spheres, extra_triangles=extra_triangles,
        env=env, textures=textures, durations=series.durations,
        vertices=t(verts.reshape(F, tmax, 3, 3)),
        normals=t(normals.reshape(F, tmax, 3, 3)),
        tri_particle=t(tri_pid), tri_valid=t(tri_valid), velocities=t(vels),
        particle_mat=t(pmat), file_count=series.count, max_triangles=tmax,
        camera=common.camera_from_config(config, dev))


def write_cache_files(config) -> dict:
    """Bake the caches and return their metadata (the reference's
    ``writeCacheFilesAndExit``, ``RendererMesh.cu:502-508``, without the
    exit)."""
    series = read_series(config.resolve(config.series_path),
                         config.series_name)
    return cache_io.write_mesh_cache(
        config.resolve(config.cache_path), series.paths,
        config.cache_process_thread_count)


def set_update_fn(data: MeshRendererData, fn: Callable) -> None:
    """Per-frame hook (``setAddGeoInsUpdateFunc``, Main.cu:5-9): called
    with (spheres, frame_index); may return replacement spheres.  A hook
    sends the frontend to its per-frame loop."""
    data.update_fn = fn


def _frame_world(verts, normals, tri_pid, tri_valid, vels, pmat,
                 shift_scale, particle_shift, particle_scale):
    """World vertices v * scale + (offset + velocity * progress), gathered
    per triangle on the device; padding slots are zero."""
    dev = verts.device
    shift = (torch.as_tensor(particle_shift, dtype=torch.float32,
                             device=dev)[None, :]
             + vels * torch.as_tensor(shift_scale, dtype=torch.float32,
                                      device=dev))
    pid = tri_pid.long()
    world_v = (verts * torch.as_tensor(particle_scale, dtype=torch.float32,
                                       device=dev)
               + shift[pid][:, None, :])
    world_v = torch.where(tri_valid[:, None, None], world_v,
                          torch.zeros_like(world_v))
    return world_v, normals, pmat[pid]


def prev_world_points(fd, k, x, prim):
    """Previous-frame world positions of this frame's hit points.  Mesh
    motion is a translation by velocity * duration / frame_count per
    frame, so a point on packed triangle ``prim`` (particle
    ``tri_particle[prim]``) was at x - vel * step.  Static extras
    (prim >= packed count), spheres and misses (prim < 0) and frame 0 of
    a file map to themselves.

    fd: the fused loop's file-data dict (``models/fused.mesh_file_data``);
    k: frame index; x (..., 3); prim (...) int32."""
    t_pack = fd["tri_particle"].shape[0]
    dynamic = (prim >= 0) & (prim < t_pack) & (float(k) > 0.0)
    pid = fd["tri_particle"][torch.clamp(prim, 0, max(t_pack - 1, 0)).long()]
    step = fd["duration"] * fd["inv_frame_count"]
    x_prev = x - fd["velocities"][pid.long()] * step
    return torch.where(dynamic[..., None], x_prev, x)


def frame_scene(data: MeshRendererData, file_index: int, frame_index: int,
                frame_count: int) -> Scene:
    """The world-space Scene of one animation frame."""
    ld = data.config.loop_data
    duration = data.durations[file_index]
    # totalShift = velocity * duration; per-frame shift = totalShift /
    # frameCount accumulated frame_index times (RendererMesh.cu:381-387),
    # rounded as the JAX package's float32 cast rounds it
    shift_scale = np.float32(duration * frame_index / max(frame_count, 1))
    world_v, normals, mat = _frame_world(
        data.vertices[file_index], data.normals[file_index],
        data.tri_particle[file_index], data.tri_valid[file_index],
        data.velocities[file_index], data.particle_mat[file_index],
        shift_scale, ld.particle_shift, ld.particle_scale)
    tris = Triangles(world_v, normals, mat)
    if data.extra_triangles.count:
        # static extras after the particle block keep their indices
        tris = tris.concat(data.extra_triangles)
    spheres = data.extra_spheres
    if data.update_fn is not None:
        out = data.update_fn(spheres, frame_index)
        if out is not None:
            spheres = out
    return Scene(spheres=spheres, triangles=tris)


def render_frames(data: MeshRendererData, width: int | None = None,
                  height: int | None = None, spp: int | None = None,
                  max_frames: int | None = None,
                  loop: bool = False, fetch_guides: bool = False,
                  quantize: bool = False) -> Iterator[tuple[int, int, Film]]:
    """The render loop (the reference's ``startRender``, headless):
    yields (file_index, frame_index, Film), or U8Frame with ``quantize``
    (sRGB uint8 quantized on the device).  Frames per file = duration *
    fps * renderSpeedRatio; ``loop`` repeats the series.

    The default fused loop (``models/fused.py``) yields Films whose guide
    channels are zero unless ``fetch_guides``; the per-frame loop (an
    ``update_fn`` installed, or debug mode) always carries real guides."""
    cfg = data.config
    ld = cfg.loop_data
    width = width or ld.window_width
    height = height or ld.window_height
    spp = spp or cfg.spp

    if (data.update_fn is None and not debug.DEBUG_MODE and data.file_count
            and not cfg.integrator.startswith("restir")):
        from optix_ray_tracer_tpu_torch.models import fused
        yield from fused.render_frames_fused(
            data, "mesh", fused.mesh_file_data, width, height, spp,
            max_frames, loop, fetch_guides=fetch_guides, quantize=quantize)
        return
    yield from per_frame_loop(data, frame_scene, width, height, spp,
                              max_frames, loop, quantize)


def per_frame_loop(data, frame_scene_fn, width: int, height: int, spp: int,
                   max_frames: int | None, loop: bool, quantize: bool):
    """The frontends' per-frame loop: on each file's first frame a
    rebuild (a host build on the first file), then a refit per frame,
    then ``render_frame``; Films carry real guides."""
    cfg = data.config
    ld = cfg.loop_data
    dev = data.camera.center.device
    produced = 0
    lights = None
    intersector = None
    while True:
        for fi in range(data.file_count):
            n_frames = common.frame_count_for_file(
                data.durations[fi], ld.fps, ld.render_speed_ratio)
            for k in range(n_frames):
                scene = frame_scene_fn(data, fi, k, n_frames)
                if produced == 0:
                    lights = common.collect_lights(cfg, scene,
                                                   data.materials)
                intersector = (common.rebuild_or_choose(intersector, scene)
                               if k == 0
                               else common.refit_or_choose(intersector,
                                                           scene))
                img, alb, nrm = common.render_frame(
                    cfg, scene, data.materials, data.camera, width, height,
                    spp=spp, seed=cfg.seed + produced,
                    intersector=intersector, env=data.env,
                    textures=data.textures, lights=lights)
                film = Film.create(width, height, dev).add(img, alb, nrm,
                                                           spp)
                if quantize:
                    film = U8Frame(film.to_uint8(), spp)
                yield fi, k, film
                produced += 1
                if max_frames is not None and produced >= max_frames:
                    return
        if not loop:
            return
