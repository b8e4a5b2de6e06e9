"""Time-mode frontend, device side (port of the per-frame parts of
``optix_ray_tracer_tpu/models/renderer_time.py``).

A Time scene is a DEM particle series: per file, particle poses
(position, quaternion, velocity, shape id) over a shared library of STL
shapes.  Per frame, positions integrate along velocity and orientations
slerp between consecutive files (``RendererTime.cu:436-472``).  Two
routes render a frame:

* flatten: :func:`_frame_triangles` bakes the packed instances into world
  triangles (sized by the sum of the instanced shapes' triangle counts),
  which the flat cluster build and ``MarchIntersector`` then trace;
* TLAS: :func:`tlas_frame_intersector` refits the two-level structure
  (``ops/instanced.py``) to the frame's poses and wraps it in a
  ``TLASSceneIntersector``; no flattened geometry exists.

Here: the pose model, the packing tables that end ``commit`` (as a host
function over in-memory shape ids and a valid mask), both frame builders.
File reading (``commit``), the route policy (``_tlas_route``) and the
frame loops (``render_frames``) wait for the frontends slice.
"""

from __future__ import annotations

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.ops.instanced import (
    InstancedLibrary, InstancedMarchIntersector, make_pairs, refit_instanced,
    scene_bounds,
)
from optix_ray_tracer_tpu_torch.ops.tlas import TLASSceneIntersector
from optix_ray_tracer_tpu_torch.scene.geometry import ShapeLibrary
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


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _instance_poses(pos_cur, quat_cur, quat_next, vel, duration, frame_idx,
                    inv_frames_minus1, inv_frame_count, particle_shift,
                    euler_path: bool):
    """Per-particle rigid pose at (possibly fractional) frame index:
    rot (P, 3, 3) + shift (P, 3), the render loop's motion model.  The
    scalars are float32, as the JAX package casts them."""
    dev = pos_cur.device
    duration, frame_idx, inv_frames_minus1, inv_frame_count = (
        _f32(x, dev) for x in (duration, frame_idx, inv_frames_minus1,
                               inv_frame_count))
    factor = torch.clamp(frame_idx * inv_frames_minus1, 0.0, 1.0)
    q = quat_slerp(quat_cur, quat_next, factor.expand(quat_cur.shape[:-1]))
    if euler_path:
        rot = rotation_matrix_euler_xyz_degrees(quat_to_euler_degrees(q))
    else:
        rot = quat_to_rotation_matrix(q)
    shift = (pos_cur + vel * (duration * frame_idx * inv_frame_count)
             + _f32(particle_shift, dev)[None, :])
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
    v = lib_vertices[lib] * _f32(particle_scale, dev)
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
