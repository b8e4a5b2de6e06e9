"""The Time frontend's math in the port against the JAX package: every
function of ``utils/transforms.py``, the pose model ``_instance_poses``
(both ``euler_path`` values), the flatten route's ``_frame_triangles``, the
packing tables of ``commit`` and ``ShapeLibrary``.

Tolerance: 1e-6 relative to each quantity's scale (absolute 1e-6 for
unit quantities, 1e-5 for world coordinates up to ~10, 1e-4 for angles
in degrees up to 180): both sides evaluate the same float32 formulas,
XLA's and PyTorch's libm (cos, sin, arccos, atan2) and matmul summation
orders differ by an ulp or so."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu.models import renderer_time as jrt
from optix_ray_tracer_tpu.scene.geometry import ShapeLibrary as JShapeLibrary
from optix_ray_tracer_tpu.utils import transforms as jtf
from optix_ray_tracer_tpu_torch.models import renderer_time as trt
from optix_ray_tracer_tpu_torch.scene.geometry import ShapeLibrary
from optix_ray_tracer_tpu_torch.utils import transforms as ttf

torch.set_num_threads(1)

RTOL = ATOL = 1e-6


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    q1, q2 = _quats(rng, 64), _quats(rng, 64)
    q2[:8] = q1[:8] * 0.99999 + 1e-5    # nearly parallel: the nlerp branch
    q2[8:16] = -q1[8:16]                # opposite signs: the flip
    return dict(
        deg=rng.uniform(-180, 180, (64, 3)).astype(np.float32),
        shift=rng.uniform(-5, 5, (64, 3)).astype(np.float32),
        scale=rng.uniform(0.5, 2.0, (64, 3)).astype(np.float32),
        pts=rng.normal(size=(64, 3)).astype(np.float32),
        q1=q1, q2=q2, t=rng.uniform(0, 1, 64).astype(np.float32))


def test_euler_and_srt(data):
    _close(ttf.rotation_matrix_euler_xyz_degrees(torch.as_tensor(data["deg"])),
           jtf.rotation_matrix_euler_xyz_degrees(data["deg"]))
    args = (data["shift"], data["deg"], data["scale"])
    tj = jtf.srt_transform(*args)
    tt = ttf.srt_transform(*(torch.as_tensor(a) for a in args))
    _close(tt, tj, atol=1e-5)
    _close(ttf.identity_transform((2,)), jtf.identity_transform((2,)))
    p = data["pts"]
    _close(ttf.apply_transform_point(tt, torch.as_tensor(p)),
           jtf.apply_transform_point(tj, p), atol=1e-5)
    _close(ttf.apply_transform_vector(tt, torch.as_tensor(p)),
           jtf.apply_transform_vector(tj, p), atol=1e-5)
    inv_t, inv_j = ttf.invert_transform(tt), jtf.invert_transform(tj)
    _close(inv_t, inv_j, rtol=1e-5, atol=1e-5)
    _close(ttf.compose_transforms(tt, inv_t), jtf.compose_transforms(tj, inv_j),
           rtol=1e-5, atol=1e-5)
    # a transform composed with its inverse is the identity
    _close(ttf.compose_transforms(tt, inv_t),
           np.broadcast_to(np.asarray(jtf.identity_transform()), (64, 3, 4)),
           atol=1e-5)


def test_quaternions(data):
    q1, q2, t = data["q1"], data["q2"], data["t"]
    got = ttf.quat_slerp(*(torch.as_tensor(x) for x in (q1, q2, t)))
    _close(got, jtf.quat_slerp(q1, q2, t))
    _close(ttf.quat_to_rotation_matrix(torch.as_tensor(q1)),
           jtf.quat_to_rotation_matrix(jnp.asarray(q1)))
    # degrees: 1e-6 relative of angles up to 180
    _close(ttf.quat_to_euler_degrees(torch.as_tensor(q1)),
           jtf.quat_to_euler_degrees(jnp.asarray(q1)), atol=1e-4)


def _library():
    meshes = [sphere_with_n_triangles(s) for s in (80, 200, 450)]
    return (ShapeLibrary.from_meshes(meshes, device="cpu"),
            JShapeLibrary.from_meshes(meshes))


def _file(rng, P, n_shapes):
    return dict(pos=rng.uniform(-3, 3, (P, 3)).astype(np.float32),
                quat=_quats(rng, P), quat_next=_quats(rng, P),
                vel=rng.normal(size=(P, 3)).astype(np.float32),
                sid=rng.integers(0, n_shapes, P).astype(np.int32),
                pmat=rng.integers(0, 4, P).astype(np.int32))


def test_shape_library():
    tl, jl = _library()
    assert tl.num_shapes == jl.num_shapes == 3
    np.testing.assert_array_equal(tl.offsets, jl.offsets)
    np.testing.assert_array_equal(tl.counts, jl.counts)
    np.testing.assert_array_equal(tl.vertices.numpy(), np.asarray(jl.vertices))
    np.testing.assert_array_equal(tl.shape(2).normals.numpy(),
                                  np.asarray(jl.shape(2).normals))


def test_packing_tables():
    """commit()'s per-file loop, on shape ids and a valid mask with gaps."""
    tl, jl = _library()
    rng = np.random.default_rng(2)
    sid = rng.integers(0, 3, (3, 9))
    valid = rng.uniform(size=(3, 9)) < 0.7
    valid[2] = False                      # an empty file
    lib_idx, inst, ok = trt.packing_tables(tl, sid, valid)
    offs, cnts = jl.offsets, jl.counts
    t_pack = max(int(cnts[sid[i][valid[i]]].sum()) for i in range(3))
    assert lib_idx.shape == (3, t_pack)
    for i in range(3):
        w = 0
        for p in range(9):
            if valid[i, p]:
                c = int(cnts[sid[i, p]])
                np.testing.assert_array_equal(
                    lib_idx[i, w:w + c], offs[sid[i, p]] + np.arange(c))
                assert (inst[i, w:w + c] == p).all() and ok[i, w:w + c].all()
                w += c
        assert not ok[i, w:].any() and (lib_idx[i, w:] == 0).all()


@pytest.mark.parametrize("euler_path", [False, True])
def test_instance_poses_and_frame_triangles(euler_path):
    tl, jl = _library()
    f = _file(np.random.default_rng(9), 12, 3)
    valid = np.ones((1, 12), bool)
    valid[0, 4] = False
    lib_idx, inst, ok = trt.packing_tables(tl, f["sid"][None], valid)
    scalars = (0.8, 2.0, 1.0 / 3, 1.0 / 4)     # duration, k, 1/(n-1), 1/n
    shift = (0.5, -1.0, 0.25)
    rot_j, sh_j = jrt._instance_poses(
        jnp.asarray(f["pos"]), jnp.asarray(f["quat"]),
        jnp.asarray(f["quat_next"]), jnp.asarray(f["vel"]),
        *(jnp.float32(s) for s in scalars), jnp.asarray(shift, jnp.float32),
        euler_path)
    t = {k: torch.as_tensor(v) for k, v in f.items()}
    rot_t, sh_t = trt._instance_poses(t["pos"], t["quat"], t["quat_next"],
                                      t["vel"], *scalars, shift, euler_path)
    _close(rot_t, rot_j, atol=2e-6)
    _close(sh_t, sh_j)

    scale = (1.5, 1.5, 1.5)
    vj, nj, mj = jrt._frame_triangles(
        jl.vertices, jl.normals, jnp.asarray(lib_idx[0]),
        jnp.asarray(inst[0]), jnp.asarray(ok[0]), jnp.asarray(f["pos"]),
        jnp.asarray(f["quat"]), jnp.asarray(f["quat_next"]),
        jnp.asarray(f["vel"]), jnp.asarray(f["pmat"]),
        *(jnp.float32(s) for s in scalars), jnp.asarray(shift, jnp.float32),
        jnp.asarray(scale, jnp.float32), euler_path=euler_path)
    vt, nt, mt = trt._frame_triangles(
        tl.vertices, tl.normals, lib_idx[0], inst[0], ok[0], t["pos"],
        t["quat"], t["quat_next"], t["vel"], t["pmat"], *scalars, shift,
        scale, euler_path)
    _close(vt, vj, atol=1e-5)          # world coordinates up to ~10
    _close(nt, nj, atol=2e-6)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
