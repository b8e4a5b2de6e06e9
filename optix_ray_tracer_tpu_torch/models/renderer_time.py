"""Time-mode frontend (port of
``optix_ray_tracer_tpu/models/renderer_time.py``; the reference's
``RendererTime``, ``src/Global/RendererTime.cu``).

A Time scene is a DEM particle series: per file, particle poses
(position, quaternion, velocity, shape id) over a shared library of STL
shapes loaded once (lexicographic file order = shape id).  Per frame,
positions integrate along velocity and orientations slerp between
consecutive files (``RendererTime.cu:436-472``).  Two routes render a
frame:

* flatten: :func:`_frame_triangles` bakes the packed instances into world
  triangles (sized by the sum of the instanced shapes' triangle counts),
  which the flat cluster build and ``MarchIntersector`` then trace: a
  host build on the first file, a device rebuild per file, a device refit
  per frame (the fused loop of ``models/fused.py`` by default);
* TLAS: :func:`tlas_frame_intersector` refits the two-level structure
  (``ops/instanced.py``) to the frame's poses and wraps it in a
  ``TLASSceneIntersector``; no flattened geometry exists
  (:func:`_render_frames_tlas`, chosen by :func:`_tlas_route`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.io.native_io import read_time_file
from optix_ray_tracer_tpu_torch.io.series import (
    load_stl_directory, read_series,
)
from optix_ray_tracer_tpu_torch.models import common
from optix_ray_tracer_tpu_torch.ops.instanced import (
    InstancedLibrary, InstancedMarchIntersector, build_instanced_library,
    make_pairs, refit_instanced, scene_bounds,
)
from optix_ray_tracer_tpu_torch.ops.raster import (
    camera_tile_layout, round_pc_max, to_tiles,
)
from optix_ray_tracer_tpu_torch.ops.raster_instanced import (
    measure_instanced_pair_count,
)
from optix_ray_tracer_tpu_torch.ops.tlas import TLASSceneIntersector
from optix_ray_tracer_tpu_torch.render.film import Film, U8Frame
from optix_ray_tracer_tpu_torch.render.wavefront import (
    _default_samples_per_wave,
)
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, ShapeLibrary, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.utils import debug
from optix_ray_tracer_tpu_torch.utils.logging import LOG
from optix_ray_tracer_tpu_torch.utils.tensors import (
    device_constant, resolve_device,
)
from optix_ray_tracer_tpu_torch.utils.transforms import (
    quat_slerp, quat_to_euler_degrees, quat_to_rotation_matrix,
    rotation_matrix_euler_xyz_degrees,
)


def packing_tables(library: ShapeLibrary, shape_ids, valid):
    """The packed instancing tables of ``commit``: per file, one row per
    instanced triangle, valid instances in particle order.

    shape_ids, valid: (F, Pmax) host arrays.  Returns (tri_lib_idx,
    tri_inst, tri_ok), each (F, T_pack) numpy (int32, int32, bool), with
    T_pack the largest file's triangle sum (at least 1)."""
    sid = np.asarray(shape_ids, np.int64)
    valid = np.asarray(valid, bool)
    F, pmax = sid.shape
    if library.num_shapes:
        offs = np.asarray(library.offsets, np.int64)
        cnts = np.asarray(library.counts, np.int64)
    else:
        offs = cnts = np.zeros(1, np.int64)
    sizes = np.where(valid, cnts[sid], 0)
    t_pack = max(int(sizes.sum(1).max(initial=0)), 1)
    lib_idx = np.zeros((F, t_pack), np.int32)
    inst_idx = np.zeros((F, t_pack), np.int32)
    tri_ok = np.zeros((F, t_pack), bool)
    for i in range(F):
        inst = np.repeat(np.arange(pmax), sizes[i])
        k = inst.shape[0]
        within = np.arange(k) - np.repeat(np.cumsum(sizes[i]) - sizes[i],
                                          sizes[i])
        lib_idx[i, :k] = offs[sid[i, inst]] + within
        inst_idx[i, :k] = inst
        tri_ok[i, :k] = True
    return lib_idx, inst_idx, tri_ok


def _instance_poses(pos_cur, quat_cur, quat_next, vel, duration, frame_idx,
                    inv_frames_minus1, inv_frame_count, particle_shift,
                    euler_path: bool):
    """Per-particle rigid pose at (possibly fractional) frame index:
    rot (P, 3, 3) + shift (P, 3), the render loop's motion model.  The
    scalars are float32, as the JAX package casts them; their products
    are formed on the host, where float32 rounds as on the device, and
    reach it as operands and fills, never as copies (a copy of host
    memory waits for the work queued before it)."""
    dev = pos_cur.device
    duration, frame_idx, inv_frames_minus1, inv_frame_count = (
        np.float32(x) for x in (duration, frame_idx, inv_frames_minus1,
                                inv_frame_count))
    factor = np.clip(frame_idx * inv_frames_minus1, np.float32(0.0),
                     np.float32(1.0))
    q = quat_slerp(quat_cur, quat_next, torch.full(
        quat_cur.shape[:-1], float(factor), dtype=torch.float32, device=dev))
    if euler_path:
        rot = rotation_matrix_euler_xyz_degrees(quat_to_euler_degrees(q))
    else:
        rot = quat_to_rotation_matrix(q)
    shift = (pos_cur + vel * float(duration * frame_idx * inv_frame_count)
             + device_constant(particle_shift, dev)[None, :])
    return rot, shift


def _rotate(rot, x):
    """(T, 3, 3) rotations applied to (T, K, 3) rows: out[t, k, i] =
    sum_j rot[t, i, j] x[t, k, j], summed left to right."""
    r = rot[:, None]
    return torch.stack([(r[..., i, 0] * x[..., 0] + r[..., i, 1] * x[..., 1])
                        + r[..., i, 2] * x[..., 2] for i in range(3)], -1)


def _frame_triangles(lib_vertices, lib_normals, tri_lib_idx, tri_inst,
                     tri_ok, pos_cur, quat_cur, quat_next, vel, pmat,
                     duration, frame_idx, inv_frames_minus1, inv_frame_count,
                     particle_shift, particle_scale, euler_path: bool):
    """Per-frame PACKED instancing (the flatten route): world vertices
    R (v * scale) + position and rotated normals for every packed slot,
    gathered through (library triangle, particle).  Returns (vertices
    (T, 3, 3), normals (T, 3, 3), material (T,) int32); slots past the
    file's triangles are zero."""
    dev = lib_vertices.device
    rot, shift = _instance_poses(
        pos_cur, quat_cur, quat_next, vel, duration, frame_idx,
        inv_frames_minus1, inv_frame_count, particle_shift, euler_path)
    lib = torch.as_tensor(tri_lib_idx, device=dev).long()
    inst = torch.as_tensor(tri_inst, device=dev).long()
    ok = torch.as_tensor(tri_ok, device=dev)
    rot_t = rot[inst]
    v = lib_vertices[lib] * device_constant(particle_scale, dev)
    v = _rotate(rot_t, v) + shift[inst][:, None, :]
    n = _rotate(rot_t, lib_normals[lib])
    v = torch.where(ok[:, None, None], v, torch.zeros_like(v))
    return v, n, pmat[inst].to(torch.int32)


def tlas_frame_intersector(library: InstancedLibrary, shapes: ShapeLibrary,
                           shape_ids, valid, tri_lib, tri_inst,
                           particle_mat, positions, quats, quats_next,
                           velocities, duration: float, frame_idx: float,
                           n_frames: int, particle_shift=(0.0, 0.0, 0.0),
                           particle_scale: float = 1.0,
                           euler_path: bool = False,
                           pc_max: int | None = None
                           ) -> TLASSceneIntersector:
    """One frame of the TLAS route (the per-frame body of the JAX
    package's ``_render_frames_tlas``): pairs, the virtual flatten layout
    (``inst_base``, ``inst_tri_off``), the frame's poses, the refit, the
    scene bounds and the two intersector layers.

    ``library`` (built once by ``build_instanced_library``), ``shapes``
    (its normals) and every tensor argument on the render device;
    shape_ids, valid: (P,) host arrays of the file; tri_lib, tri_inst:
    the file's rows of :func:`packing_tables`; particle_mat: (P,) int32;
    positions, quats (this file), quats_next (the next file), velocities:
    (P, ...) tensors; ``frame_idx`` of ``n_frames`` in the file.
    ``pc_max``: the camera and point-light waves' schedule capacity (see
    ``TLASSceneIntersector``)."""
    dev = library.woop_t.device
    sid = np.asarray(shape_ids, np.int64).reshape(-1)
    valid = np.asarray(valid, bool).reshape(-1)
    pair_shape, pair_inst = make_pairs(library, sid)
    sizes = np.where(valid, np.asarray(shapes.counts, np.int64)[sid], 0)
    inst_base = torch.as_tensor(np.cumsum(sizes) - sizes, dtype=torch.int32,
                                device=dev)
    inst_tri_off = torch.as_tensor(np.asarray(shapes.offsets)[sid],
                                   dtype=torch.int32, device=dev)
    rot, shift = _instance_poses(
        positions, quats, quats_next, velocities, duration, frame_idx,
        1.0 / max(n_frames - 1, 1), 1.0 / max(n_frames, 1), particle_shift,
        euler_path)
    pmin, pmax, smin, smax, inst_rows = refit_instanced(
        library, pair_shape, pair_inst, rot, shift, particle_scale,
        torch.as_tensor(valid, device=dev))
    lo, hi = scene_bounds(pmin, pmax)
    tlas = InstancedMarchIntersector(
        library=library, pair_shape=pair_shape, pair_inst=pair_inst,
        pair_min=pmin, pair_max=pmax, sub_min=smin, sub_max=smax,
        inst_rows=inst_rows, scene_lo=lo, scene_hi=hi)
    return TLASSceneIntersector(
        tlas=tlas, tri_lib=torch.as_tensor(tri_lib, device=dev),
        tri_inst=torch.as_tensor(tri_inst, device=dev), inst_base=inst_base,
        inst_tri_off=inst_tri_off, lib_normals=shapes.normals, rot=rot,
        pmat=particle_mat, pc_max=pc_max)


@dataclasses.dataclass
class TimeRendererData:
    """Committed scene state: tensors on the render device plus host
    metadata."""
    config: object
    materials: object
    material_offset: int
    extra_spheres: Spheres
    extra_triangles: Triangles
    env: object | None
    textures: object | None
    durations: list[float]
    library: ShapeLibrary
    # per-file particle state, padded to the max particle count
    positions: torch.Tensor       # (F, Pmax, 3)
    quats: torch.Tensor           # (F, Pmax, 4) w-x-y-z
    velocities: torch.Tensor      # (F, Pmax, 3)
    shape_ids: torch.Tensor       # (F, Pmax) int32
    particle_mat: torch.Tensor    # (F, Pmax) int32
    particle_valid: torch.Tensor  # (F, Pmax) bool
    # packed instancing tables (:func:`packing_tables`)
    tri_lib_idx: torch.Tensor     # (F, T_pack) int32
    tri_inst: torch.Tensor        # (F, T_pack) int32
    tri_ok: torch.Tensor          # (F, T_pack) bool
    file_count: int
    camera: object
    reference_euler_path: bool = False
    update_fn: Callable | None = None


def commit(config, reference_euler_path: bool = False,
           device=None) -> TimeRendererData:
    """Load the STL library and the pose series and move them to
    ``device`` (None: the card) (``RendererTime::commitRendererData``)."""
    dev = resolve_device(device)
    library = ShapeLibrary.from_meshes(
        load_stl_directory(config.resolve(config.stl_path)), dev)
    LOG.info("time mode: %d STL shapes, %d packed triangles",
             library.num_shapes, int(library.vertices.shape[0]))
    series = read_series(config.resolve(config.series_path),
                         config.series_name)
    frames = [read_time_file(p) for p in series.paths]
    LOG.info("time mode: %d pose files", len(frames))

    max_points = max((len(f.ids) for f in frames), default=0)
    materials, bases = common.build_materials(config, max_points, dev)
    extra_spheres = common.build_extra_spheres(config, bases, dev)
    extra_triangles = common.build_extra_triangles(config, bases, dev)
    env = common.build_envmap(config, dev)
    textures = common.build_textures(config, bases, materials.count, dev)

    pmax = max(max_points, 1)
    F = len(frames)
    pos = np.zeros((F, pmax, 3), np.float32)
    quat = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (F, pmax, 1))
    vel = np.zeros((F, pmax, 3), np.float32)
    sid = np.zeros((F, pmax), np.int32)
    pmat = np.zeros((F, pmax), np.int32)
    valid = np.zeros((F, pmax), bool)
    for i, f in enumerate(frames):
        p = len(f.ids)
        pos[i, :p] = f.positions
        quat[i, :p] = f.quats
        vel[i, :p] = f.velocities
        sid[i, :p] = np.clip(f.shape_ids, 0, max(library.num_shapes - 1, 0))
        pmat[i, :p] = f.ids.astype(np.int32) + bases.material_offset
        valid[i, :p] = True
    lib_idx, inst_idx, tri_ok = packing_tables(library, sid, valid)
    LOG.info("time mode: packed instancing %d triangles/frame",
             lib_idx.shape[1])

    def t(a):
        return torch.as_tensor(a, device=dev)

    return TimeRendererData(
        config=config, materials=materials,
        material_offset=bases.material_offset,
        extra_spheres=extra_spheres, extra_triangles=extra_triangles,
        env=env, textures=textures, durations=series.durations,
        library=library, positions=t(pos), quats=t(quat),
        velocities=t(vel), shape_ids=t(sid), particle_mat=t(pmat),
        particle_valid=t(valid), tri_lib_idx=t(lib_idx),
        tri_inst=t(inst_idx), tri_ok=t(tri_ok), file_count=F,
        camera=common.camera_from_config(config, dev),
        reference_euler_path=reference_euler_path)


def set_update_fn(data: TimeRendererData, fn: Callable) -> None:
    """Per-frame hook, as ``renderer_mesh.set_update_fn``."""
    data.update_fn = fn


def _apply_rows(rot, x):
    """rot (..., 3, 3) applied to x (..., 3), summed left to right."""
    return torch.stack([(rot[..., i, 0] * x[..., 0] + rot[..., i, 1]
                         * x[..., 1]) + rot[..., i, 2] * x[..., 2]
                        for i in range(3)], -1)


def prev_world_points(fd, k, x, prim, euler_path: bool = False):
    """Previous-frame world positions of this frame's hit points: a point
    on packed triangle ``prim`` belongs to particle ``tri_inst[prim]``,
    whose rigid pose at any frame index is known in closed form, so it
    goes to object space with frame k's pose and back with frame k-1's.
    Static extras (prim >= packed count), spheres and misses (prim < 0)
    map to themselves.

    fd: the fused loop's file-data dict (``models/fused.time_file_data``);
    x (..., 3); prim (...) int32."""
    args = (fd["positions"], fd["quats"], fd["quats_next"],
            fd["velocities"], fd["duration"])
    tail = (fd["inv_frames_minus1"], fd["inv_frame_count"],
            fd["particle_shift"], euler_path)
    rot_k, shift_k = _instance_poses(*args, np.float32(k), *tail)
    rot_p, shift_p = _instance_poses(*args, np.float32(max(k - 1.0, 0.0)),
                                     *tail)
    t_pack = fd["tri_inst"].shape[0]
    dynamic = (prim >= 0) & (prim < t_pack)
    inst = fd["tri_inst"][torch.clamp(prim, 0, max(t_pack - 1, 0)).long()
                          ].long()
    x_obj = _apply_rows(rot_k[inst].transpose(-1, -2), x - shift_k[inst])
    x_prev = _apply_rows(rot_p[inst], x_obj) + shift_p[inst]
    return torch.where(dynamic[..., None], x_prev, x)


def frame_scene(data: TimeRendererData, file_index: int, frame_index: int,
                frame_count: int) -> Scene:
    """The flattened world-space Scene of one animation frame."""
    ld = data.config.loop_data
    next_index = min(file_index + 1, data.file_count - 1)
    if data.library.num_shapes == 0:
        tris = Triangles.empty(data.camera.center.device)
    else:
        v, n, mat = _frame_triangles(
            data.library.vertices, data.library.normals,
            data.tri_lib_idx[file_index], data.tri_inst[file_index],
            data.tri_ok[file_index], data.positions[file_index],
            data.quats[file_index], data.quats[next_index],
            data.velocities[file_index], data.particle_mat[file_index],
            data.durations[file_index], frame_index,
            1.0 / max(frame_count - 1, 1), 1.0 / max(frame_count, 1),
            ld.particle_shift, ld.particle_scale,
            data.reference_euler_path)
        tris = Triangles(v, n, mat)
    if data.extra_triangles.count:
        # static extras after the particle block keep their indices
        tris = tris.concat(data.extra_triangles)
    spheres = data.extra_spheres
    if data.update_fn is not None:
        out = data.update_fn(spheres, frame_index)
        if out is not None:
            spheres = out
    return Scene(spheres=spheres, triangles=tris)


#: the flatten route's device bytes per packed triangle as the JAX
#: package estimates them: world vertices (36 B) + normals (36 B) +
#: material (4 B) + cluster tables (Woop 48 B + transposed Woop 64 B +
#: prim index 4 B + boxes); the TLAS route keeps 8 B per triangle
_FLATTEN_BYTES_PER_TRI = 200


def _tlas_route(data: TimeRendererData) -> bool:
    """Route this Time scene through the TLAS engine instead of per-frame
    flattening: when the flatten route's estimated device bytes
    (``_FLATTEN_BYTES_PER_TRI`` per packed triangle) exceed
    ``ORT_TLAS_HBM_MB`` (default 8192); ``ORT_TIME_TLAS=1`` / ``0``
    forces either way.  The TLAS pose model needs a uniform particle
    scale and a non-empty shape library.  The JAX package's policy and
    constants, unchanged."""
    if data.library.num_shapes == 0:
        return False
    sc = tuple(float(s) for s in data.config.loop_data.particle_scale)
    uniform = max(sc) - min(sc) <= 1e-12
    force = os.environ.get("ORT_TIME_TLAS")
    if force is not None:
        want = force not in ("0", "false", "")
        if want and not uniform:
            LOG.warning("ORT_TIME_TLAS=1 ignored: particle-scale %s is "
                        "not uniform (the TLAS pose model is rigid + "
                        "uniform scale)", sc)
            return False
        return want
    if not uniform:
        return False
    budget_mb = float(os.environ.get("ORT_TLAS_HBM_MB", "8192"))
    t_pack = int(data.tri_lib_idx.shape[1])
    return t_pack * _FLATTEN_BYTES_PER_TRI > budget_mb * 1e6


def camera_pc_max(intersector: TLASSceneIntersector, camera, width: int,
                  height: int, spp: int) -> int | None:
    """The schedule capacity of a frame's camera waves (kernel D), from
    the pair count of its pixel-center wave: that count times the
    samples a wave merges, plus 15% (as phase 7 of chip_smoke.py and
    bench.py calibrate it).  The JAX package's heuristic (12 pairs per
    block + 2 per TLAS pair) is smaller than a 1200x800 frame of a
    4,096-particle pile needs, and an overflow sends the whole camera
    wave to the instanced marcher (exact, at the marcher's cost).  None
    when the wave does not tile."""
    S = _default_samples_per_wave(spp)
    layout = camera_tile_layout(intersector, camera, S, height, width)
    if layout is None:
        return None
    th, tw = layout[3:]
    o, d = (to_tiles(x.reshape(-1, 3), 1, height, width, th, tw)
            for x in camera.generate_rays(width, height))
    n = o.shape[0]
    count = measure_instanced_pair_count(
        intersector.tlas, o, d, torch.full((n,), 1e-3, device=o.device),
        torch.full((n,), 1e16, device=o.device), "origin", camera.center,
        block_rays=th * tw)
    return round_pc_max(S * count)


def _render_frames_tlas(data: TimeRendererData, width: int, height: int,
                        spp: int, max_frames: int | None, loop: bool,
                        quantize: bool) -> Iterator[tuple[int, int, object]]:
    """The Time loop through the TLAS engine: the library clustered once
    in object space, a pose refit per frame (:func:`tlas_frame_intersector`)
    and ``render_frame`` per frame; the camera waves' capacity measured on
    each file's first frame (:func:`camera_pc_max`).  Films carry real
    guides."""
    cfg = data.config
    ld = cfg.loop_data
    dev = data.camera.center.device
    library = build_instanced_library(
        data.library.vertices.cpu().numpy(), data.library.offsets,
        data.library.counts, dev)
    scene_static = Scene(spheres=data.extra_spheres,
                         triangles=data.extra_triangles)
    lights = common.collect_lights(cfg, scene_static, data.materials)
    LOG.info("time mode: TLAS route, library %d clusters / %d shapes, no "
             "flattened geometry", int(library.woop_t.shape[0]),
             data.library.num_shapes)
    produced = 0
    while True:
        for fi in range(data.file_count):
            sid = data.shape_ids[fi].cpu().numpy()
            valid = data.particle_valid[fi].cpu().numpy()
            nxt = min(fi + 1, data.file_count - 1)
            n_frames = common.frame_count_for_file(
                data.durations[fi], ld.fps, ld.render_speed_ratio)
            pc_max = None
            for k in range(n_frames):
                intersector = tlas_frame_intersector(
                    library, data.library, sid, valid, data.tri_lib_idx[fi],
                    data.tri_inst[fi], data.particle_mat[fi],
                    data.positions[fi], data.quats[fi], data.quats[nxt],
                    data.velocities[fi], data.durations[fi], float(k),
                    n_frames, ld.particle_shift,
                    float(ld.particle_scale[0]), data.reference_euler_path,
                    pc_max=pc_max)
                if k == 0:
                    pc_max = camera_pc_max(intersector, data.camera, width,
                                           height, spp)
                    intersector = dataclasses.replace(intersector,
                                                      pc_max=pc_max)
                scene = scene_static
                if data.update_fn is not None:
                    out = data.update_fn(scene.spheres, k)
                    if out is not None:
                        scene = dataclasses.replace(scene, spheres=out)
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


def render_frames(data: TimeRendererData, width: int | None = None,
                  height: int | None = None, spp: int | None = None,
                  max_frames: int | None = None,
                  loop: bool = False, fetch_guides: bool = False,
                  quantize: bool = False) -> Iterator[tuple[int, int, Film]]:
    """The render loop (headless ``startRender``): yields (file_index,
    frame_index, Film), or U8Frame with ``quantize``.  The TLAS route
    when :func:`_tlas_route` selects it; else the fused loop
    (``models/fused.py``), whose Films carry zero guides unless
    ``fetch_guides``; else (an ``update_fn``, debug mode, an empty
    library) the per-frame loop."""
    from optix_ray_tracer_tpu_torch.models.renderer_mesh import (
        per_frame_loop,
    )

    cfg = data.config
    ld = cfg.loop_data
    width = width or ld.window_width
    height = height or ld.window_height
    spp = spp or cfg.spp
    if data.file_count and not debug.DEBUG_MODE and _tlas_route(data):
        yield from _render_frames_tlas(data, width, height, spp,
                                       max_frames, loop, quantize)
        return
    if (data.update_fn is None and not debug.DEBUG_MODE and data.file_count
            and data.library.num_shapes > 0
            and not cfg.integrator.startswith("restir")):
        from optix_ray_tracer_tpu_torch.models import fused
        yield from fused.render_frames_fused(
            data, "time", fused.time_file_data, width, height, spp,
            max_frames, loop, fetch_guides=fetch_guides, quantize=quantize)
        return
    yield from per_frame_loop(data, frame_scene, width, height, spp,
                              max_frames, loop, quantize)
