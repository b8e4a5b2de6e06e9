"""Host constants on the frame loop's path reach the device as op
operands, fills or kept tables (``utils/tensors.CONSTANTS``), never as
copies of host memory: each site against the upload it replaced
(``torch.as_tensor(x, dtype=float32, device=...)``, ``torch.tensor(c)``,
indexing with a Python list), on the CPU.

Tolerance: none.  Every value keeps its bits (compared as int32 words,
NaN payloads included), and the cache's counters show a table built once
and reused after."""

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.models import renderer_time as trt
from optix_ray_tracer_tpu_torch.ops import sweep
from optix_ray_tracer_tpu_torch.ops.intersect import ray_bound
from optix_ray_tracer_tpu_torch.utils.tensors import (
    CONSTANTS, device_constant,
)
from optix_ray_tracer_tpu_torch.utils.transforms import (
    quat_slerp, quat_to_euler_degrees, quat_to_rotation_matrix,
    rotation_matrix_euler_xyz_degrees,
)
from optix_ray_tracer_tpu_torch.utils.vecmath import INF

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _assert_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _upload(x):
    return torch.as_tensor(x, dtype=torch.float32, device=CPU)


def _uploaded_poses(pos_cur, quat_cur, quat_next, vel, duration, frame_idx,
                    inv_frames_minus1, inv_frame_count, particle_shift,
                    euler_path):
    """The pose model with every host scalar uploaded as a 0-d float32
    tensor and the products formed on the device, as it was written
    before its constants became operands and fills."""
    duration, frame_idx, inv_frames_minus1, inv_frame_count = (
        _upload(x) for x in (duration, frame_idx, inv_frames_minus1,
                             inv_frame_count))
    factor = torch.clamp(frame_idx * inv_frames_minus1, 0.0, 1.0)
    q = quat_slerp(quat_cur, quat_next, factor.expand(quat_cur.shape[:-1]))
    if euler_path:
        rot = rotation_matrix_euler_xyz_degrees(quat_to_euler_degrees(q))
    else:
        rot = quat_to_rotation_matrix(q)
    shift = (pos_cur + vel * (duration * frame_idx * inv_frame_count)
             + _upload(particle_shift)[None, :])
    return rot, shift


def _particles(n: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return [torch.as_tensor(a) for a in (
        rng.uniform(-10.0, 10.0, (n, 3)).astype(np.float32), q[0], q[1],
        rng.normal(0.0, 0.5, (n, 3)).astype(np.float32))]


# integer and fractional frame indices, the first and last of a file, a
# frame count of 1 (1/(n-1) clamped to 1) and the Python-double forms the
# TLAS route passes
@pytest.mark.parametrize("euler_path", [False, True])
@pytest.mark.parametrize("scalars", [
    (np.float32(0.25), np.float32(0), np.float32(1 / 3), np.float32(1 / 4)),
    (np.float32(0.25), np.float32(3), np.float32(1 / 3), np.float32(1 / 4)),
    (0.8, 2.5, 1.0 / 6, 1.0 / 7),
    (1.7, 0.37, 1.0, 1.0),
    (0.3, 11.75, 1.0 / 11, 1.0 / 12),
])
def test_instance_poses_bit_equal_to_uploads(euler_path, scalars):
    pos, quat, quat_next, vel = _particles(257, 3)
    shift = (0.5, -1.0, 0.1)
    got = trt._instance_poses(pos, quat, quat_next, vel, *scalars, shift,
                              euler_path)
    want = _uploaded_poses(pos, quat, quat_next, vel, *scalars, shift,
                           euler_path)
    for g, w in zip(got, want, strict=True):
        _assert_bits(g, w)


def test_frame_triangles_scale_bit_equal_to_upload():
    v, n = sphere_with_n_triangles(200)
    lib_v = torch.as_tensor(v)
    pos, quat, quat_next, vel = _particles(4, 5)
    t = v.shape[0]
    lib_idx = torch.arange(t, dtype=torch.int32).repeat(4)
    inst = torch.arange(4, dtype=torch.int32).repeat_interleave(t)
    ok = torch.ones(4 * t, dtype=torch.bool)
    scale = np.asarray((1.5, 0.7, 2.1), np.float32)
    got, _, _ = trt._frame_triangles(
        lib_v, torch.as_tensor(n), lib_idx, inst, ok, pos, quat, quat_next,
        vel, torch.zeros(4, dtype=torch.int32), 0.25, np.float32(1),
        np.float32(1 / 3), np.float32(1 / 4), (0.0, 0.0, 0.0), scale, False)
    rot, shift = _uploaded_poses(pos, quat, quat_next, vel, 0.25,
                                 np.float32(1), np.float32(1 / 3),
                                 np.float32(1 / 4), (0.0, 0.0, 0.0), False)
    want = trt._rotate(rot[inst.long()], lib_v[lib_idx.long()]
                       * _upload(scale)) + shift[inst.long()][:, None, :]
    _assert_bits(got, want)


def _clusters(n: int, seed: int):
    rng = np.random.default_rng(seed)
    tv = rng.uniform(-1.0, 1.0, (n, 3, 3)).astype(np.float32)
    moved = (tv + rng.normal(0.0, 0.05, tv.shape)).astype(np.float32)
    return sweep.build_clusters(tv, device="cpu"), torch.as_tensor(moved)


def _uploaded_boxes(clusters, tri_vertices):
    """``refit_clusters``' cluster and sub boxes with INF and NaN uploaded
    as 0-d tensors, as they were."""
    n = tri_vertices.shape[0]
    n_pad = clusters.woop.shape[0]
    sorted_tris = tri_vertices[clusters.prim_index.long()]
    valid = torch.arange(n_pad) < n
    inf = torch.tensor(INF)
    tmin = torch.where(valid[:, None], sorted_tris.amin(1), inf)
    tmax = torch.where(valid[:, None], sorted_tris.amax(1), -inf)
    out = []
    for groups in (n_pad // sweep.CHUNK,
                   n_pad // sweep.CHUNK * sweep.SUBS_PER_CLUSTER):
        glo = tmin.reshape(groups, -1, 3).amin(1)
        ghi = tmax.reshape(groups, -1, 3).amax(1)
        empty = (glo[:, 0] > ghi[:, 0])[:, None]
        nan = torch.tensor(float("nan"))
        out += [torch.where(empty, nan, glo), torch.where(empty, nan, ghi)]
    return out


# 700: the last cluster's three last sub boxes are pure padding (NaN) and
# its pad slots bound with INF; 1024: no padding at all
@pytest.mark.parametrize("n", [700, 1024])
def test_refit_boxes_bit_equal_to_uploads(n):
    clusters, moved = _clusters(n, n)
    r = sweep.refit_clusters(clusters, moved)
    want = _uploaded_boxes(clusters, moved)
    got = [r.cluster_min, r.cluster_max, r.sub_min, r.sub_max]
    for g, w in zip(got, want, strict=True):
        _assert_bits(g, w)
    assert bool(torch.isnan(r.sub_min).any()) == bool(n % sweep.SUB_TRIS)


def test_transpose_woop_kept_index_bit_equal_to_list():
    clusters, _ = _clusters(700, 2)
    woop = clusters.woop
    CONSTANTS.tables.pop(("woop_t_perm", woop.device), None)
    CONSTANTS.reset()
    got = [sweep._transpose_woop(woop) for _ in range(2)]
    assert (CONSTANTS.built, CONSTANTS.reused) == (1, 1)
    want = torch.as_tensor(sweep._transpose_woop(woop.numpy()))
    for g in got:
        _assert_bits(g, want)
    _assert_bits(clusters.woop_t, want)


def _uploaded_median_order(cents):
    """The median-split order with each level's segment ids uploaded per
    call, as it was."""
    n = cents.shape[0]
    perm = torch.arange(n, dtype=torch.int32)
    cur = cents
    for seg_np in sweep._median_levels(n):
        num_seg = int(seg_np[-1]) + 1
        seg = torch.as_tensor(seg_np).long()
        idx = seg[:, None].expand(n, 3)
        lo = torch.full((num_seg, 3), float("inf")).scatter_reduce(
            0, idx, cur, "amin", include_self=False)
        hi = torch.full((num_seg, 3), float("-inf")).scatter_reduce(
            0, idx, cur, "amax", include_self=False)
        axis = torch.argmax(hi - lo, dim=1)
        key = torch.gather(cur, 1, axis[seg][:, None])[:, 0]
        by_key = torch.argsort(key, stable=True)
        order = by_key[torch.argsort(seg[by_key], stable=True)]
        perm = perm[order]
        cur = cur[order]
    return perm


@pytest.mark.parametrize("n", [333, 2900, 17001])
def test_median_order_segments_kept_per_n(n):
    rng = np.random.default_rng(n)
    cents = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32))
    # exact ties among the centroids
    cents[: n // 4] = torch.round(cents[: n // 4] * 2.0) / 2.0
    CONSTANTS.tables.pop(("median_segments", n, CPU), None)
    CONSTANTS.reset()
    first = sweep._median_order_device(cents)
    assert (CONSTANTS.built, CONSTANTS.reused) == (1, 0)
    moved = cents.flip(0).contiguous()
    second = sweep._median_order_device(cents)
    other = sweep._median_order_device(moved)
    assert (CONSTANTS.built, CONSTANTS.reused) == (1, 2)
    want = _uploaded_median_order(cents)
    assert first.dtype == torch.int32
    assert torch.equal(first, want) and torch.equal(second, want)
    assert torch.equal(other, _uploaded_median_order(moved))
    tables = CONSTANTS.tables[("median_segments", n, CPU)]
    assert len(tables) == len(sweep._median_levels(n))
    for (seg, num_seg), seg_np in zip(tables, sweep._median_levels(n),
                                      strict=True):
        assert seg.dtype == torch.int64 and num_seg == int(seg_np[-1]) + 1
        np.testing.assert_array_equal(seg.numpy(), seg_np)


# a Python double that float32 rounds, INF, an integer, a numpy float32,
# and 0-d and (n,) tensors
@pytest.mark.parametrize("t", [1e-3, INF, 0, np.float32(0.1),
                               torch.tensor(2.5), torch.linspace(0, 1, 37)])
def test_ray_bound_bit_equal_to_upload(t):
    got = ray_bound(t, 37, CPU)
    want = _upload(t)
    want = want.reshape(-1).expand(37) if want.dim() else want.expand(37)
    _assert_bits(got, want)
    assert got.stride() == want.stride()


def test_device_constant_kept_by_value():
    values = (0.7, 0.8, 0.9000001)
    key = ("float32", (3,), np.asarray(values, np.float32).tobytes(), CPU)
    CONSTANTS.tables.pop(key, None)
    CONSTANTS.reset()
    a = device_constant(values, CPU)
    b = device_constant(list(values), "cpu")
    c = device_constant(np.asarray(values, np.float32), CPU)
    assert a is b is c
    assert (CONSTANTS.built, CONSTANTS.reused) == (1, 2)
    _assert_bits(a, _upload(values))
    # another value is another table; a tensor is not kept
    assert device_constant((0.7, 0.8, 0.95), CPU) is not a
    t = torch.tensor([1.0, 2.0, 3.0])
    assert device_constant(t, CPU) is t
    assert CONSTANTS.built == 2
