"""Kernels B and C (block march, cluster probe): the port's plain PyTorch
versions against the JAX functions (Pallas interpret mode on the CPU) over
the very same ClusterSet, and against the port's brute-force oracle.

Hit rule (bench.py): prim ids equal, or |dt| <= 1e-5 |t| + 1e-6 at an
fp-equal t.  Probe ids are equal.  u and v agree to 1e-5 where the prims
agree, on top of what the hit rule's allowance on t moves them: both
sides compute them as (r . o - c) + t (r . d), affine in t, so where t is
bit-equal u and v are too (measured difference 0), and where the two
sides' t differ by dt (XLA and PyTorch round the Woop dots their own
way) u and v may differ by |dt| |r . d|, which reaches 2.1e-5 on these
scenes (|r . d| ~ 10 for their small triangles)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu.ops import sweep as jsweep
from optix_ray_tracer_tpu.ops.pallas import block_march as jbm
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops.intersect import (
    hit_mismatches, intersect_scene_bruteforce,
)
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as tbm
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)

torch.set_num_threads(2)

UV_ATOL = 1e-5


def assert_uv_close(woop, slot, d, dt, same, got_uv, ref_uv):
    """u, v within UV_ATOL + |dt| |r . d| on rays whose prims agree
    (``woop`` rows of the winning ``slot``, ray directions ``d``)."""
    rows = np.asarray(woop)[np.maximum(np.asarray(slot), 0)]
    for r, got, ref in zip((rows[:, 0:3], rows[:, 3:6]), got_uv, ref_uv):
        slack = UV_ATOL + np.abs(dt) * np.abs((r * d).sum(-1))
        err = np.abs(np.asarray(got) - np.asarray(ref))
        assert (err <= slack)[same].all(), (err - slack)[same].max()


@pytest.fixture(scope="module")
def setup():
    v, n = sphere_with_n_triangles(2500)
    jc = jsweep.build_clusters(v)
    tc = convert.clusters(convert.state_arrays(jc), device="cpu")
    scene = Scene(Spheres.empty(device="cpu"),
                  Triangles.from_arrays(v, n, device="cpu"))
    rng = np.random.default_rng(21)
    oi = rng.uniform(-1.2, 1.2, (1024, 3)).astype(np.float32)
    di = rng.normal(size=(1024, 3)).astype(np.float32)
    di /= np.linalg.norm(di, axis=-1, keepdims=True)
    cam = JCamera.look_at((3.0, 0.0, 0.3), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    oc, dc = cam.generate_rays(32, 32)
    waves = {"incoherent": (oi, di),
             "coherent": (np.asarray(oc).reshape(-1, 3),
                          np.asarray(dc).reshape(-1, 3))}
    return jc, tc, scene, waves


def _prims(prim_index, slot):
    slot = np.asarray(slot)
    return np.where(slot < 0, -1, np.asarray(prim_index)[np.maximum(slot, 0)])


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("wave", ["coherent", "incoherent"])
def test_block_march_matches_jax(setup, wave, any_hit):
    jc, tc, _, waves = setup
    o, d = waves[wave]
    n = o.shape[0]
    tmin = np.full(n, 1e-3, np.float32)
    # occlusion waves get finite segments so both outcomes occur
    coherent = wave == "coherent"
    seg = 2.3 if coherent else 0.7
    tmax = np.full(n, seg if any_hit else 1e16, np.float32)
    jt, js, ju, jv = jbm.block_march(jc, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(tmin), jnp.asarray(tmax),
                                     any_hit=any_hit, coherent=coherent)
    tt, ts, tu, tv = tbm.block_march(tc, _t(o), _t(d), _t(tmin), _t(tmax),
                                     any_hit=any_hit, coherent=coherent)
    if any_hit:
        np.testing.assert_array_equal(ts.numpy() >= 0, np.asarray(js) >= 0)
        assert 0 < int((ts >= 0).sum()) < n
        return
    pj = _prims(jc.prim_index, js)
    pt = _prims(jc.prim_index, ts.numpy())
    assert hit_mismatches(_t(pt), tt, _t(pj), _t(jt)) == 0
    assert_uv_close(jc.woop, ts.numpy(), d, tt.numpy() - np.asarray(jt),
                    pj == pt, (tu, tv), (ju, jv))
    assert (pt >= 0).sum() > n // 4


@pytest.mark.parametrize("wave", ["coherent", "incoherent"])
def test_probe_matches_jax(setup, wave):
    jc, tc, _, waves = setup
    o, d = waves[wave]
    n = o.shape[0]
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    tmax[::5] = 0.0                                 # dead rays probe C_pad
    ref = np.asarray(jbm.probe_first_cluster(
        jc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax)))
    got = tbm.probe_first_cluster(tc, _t(o), _t(d), _t(tmin), _t(tmax))
    np.testing.assert_array_equal(got.numpy(), ref)
    c_pad = ((tc.num_clusters + 7) // 8) * 8
    assert (got.numpy()[::5] == c_pad).all()


@pytest.mark.parametrize("coherent", [True, False])
def test_block_march_matches_oracle(setup, coherent):
    _, tc, scene, waves = setup
    o, d = (_t(x) for x in waves["incoherent"])
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3)
    tmax = torch.full((n,), 1e16)
    t, slot, u, v = tbm.block_march(tc, o, d, tmin, tmax, coherent=coherent)
    prim = torch.where(slot < 0, -1, tc.prim_index[slot.clamp(min=0).long()])
    h = intersect_scene_bruteforce(scene, o, d)
    ref = torch.where(h.is_hit, h.prim_id, -1)
    assert hit_mismatches(prim, t, ref, h.t) == 0
    hit = slot >= 0
    torch.testing.assert_close(u[hit], h.u[hit], rtol=0, atol=1e-4)
    torch.testing.assert_close(v[hit], h.v[hit], rtol=0, atol=1e-4)


def test_cpu_wrappers_launch_nothing(setup):
    """On CPU tensors the wrappers take the plain versions."""
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    _, tc, _, waves = setup
    o, d = (_t(x[:128]) for x in waves["coherent"])
    before = (_lib.BLOCK_MARCH.launches, _lib.PROBE.launches)
    tbm.block_march(tc, o, d, torch.full((128,), 1e-3),
                    torch.full((128,), 1e16))
    tbm.probe_first_cluster(tc, o, d, torch.full((128,), 1e-3),
                            torch.full((128,), 1e16))
    assert (_lib.BLOCK_MARCH.launches, _lib.PROBE.launches) == before
    assert _lib._lib is None
