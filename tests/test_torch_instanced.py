"""The two-level (TLAS) engine: the port's instanced state, kernel E
(``block_march_instanced``) and kernel D (``instanced_raster_query``) in
their plain PyTorch versions against the JAX package (Pallas interpret
mode on the CPU) over the very same library and refit state (handed over
by convert.py), and against the port's brute-force oracle on the
flattened scene.  The setups are tests/test_instanced.py's: a library of
three spheres (80, 200 and 450 triangles), 10-40 posed instances.

Hit rule (bench.py): the hit identities (instance, library triangle)
equal, or |dt| <= 1e-5 |t| + 1e-6 at an fp-equal t.  u and v agree to
1e-5 plus |dt| |r . d'|, the shift the hit rule's allowance on t makes in
the object-space recompute (see test_torch_block_march.py), plus two ulps
of the object-space origin magnified by the Woop row (``_assert_uv``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.ops import instanced as jinst
from optix_ray_tracer_tpu.ops import raster_instanced as jri
from optix_ray_tracer_tpu.ops.pallas import block_march as jbm
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops import instanced as tinst
from optix_ray_tracer_tpu_torch.ops import raster_instanced as tri
from optix_ray_tracer_tpu_torch.ops.intersect import (
    hit_mismatches, intersect_scene_bruteforce,
)
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as tbm
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)
from test_instanced import _flatten, _library, _random_poses

torch.set_num_threads(1)

UV_ATOL = 1e-5
ULPS = 2.0 ** -22     # two float32 ulps, relative
CAMERA = (16.0, 2.0, 3.0)
LIGHT = (4.0, 9.0, 6.0)


def _t(x):
    return torch.as_tensor(np.array(x))


def _setup(P, scale, seed, invalid=()):
    lib, offsets, counts = _library()
    rng = np.random.default_rng(seed)
    sid = rng.integers(0, len(counts), P)
    rot, shift = _random_poses(P, seed=P)
    valid = np.ones(P, bool)
    valid[list(invalid)] = False
    jlib = jinst.build_instanced_library(lib, offsets, counts)
    jinter = jinst.make_instanced_intersector(jlib, sid, rot, shift, scale,
                                              jnp.asarray(valid))
    tinter = convert.instanced_intersector(convert.state_arrays(jinter),
                                           device="cpu")
    return dict(lib=lib, offsets=offsets, counts=counts, sid=sid, rot=rot,
                shift=shift, scale=scale, valid=valid, jlib=jlib,
                jinter=jinter, tinter=tinter, rng=rng)


@pytest.fixture(scope="module")
def small():
    return _setup(12, 1.0, 3, invalid=(5,))


@pytest.fixture(scope="module", params=[(12, 1.0), (40, 0.7)],
                ids=["P12-s1", "P40-s0.7"])
def scenes(request):
    return _setup(*request.param, seed=3)


def _waves(s, n_cam=(24, 16), n_inc=256):
    cam = JCamera.look_at(CAMERA, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    oc, dc = cam.generate_rays(*n_cam)
    oi = s["rng"].uniform(-5, 5, (n_inc, 3)).astype(np.float32)
    di = s["rng"].normal(size=(n_inc, 3)).astype(np.float32)
    di /= np.linalg.norm(di, axis=-1, keepdims=True)
    return (np.concatenate([np.asarray(oc).reshape(-1, 3), oi]),
            np.concatenate([np.asarray(dc).reshape(-1, 3), di]))


def _keys(inter, slot):
    """Hit identity instance * 2**16 + library triangle (-1 miss)."""
    slot = np.asarray(slot)
    pos = np.maximum(slot, 0)
    pair, row = pos // 256, pos % 256
    lib_slot = np.asarray(inter.pair_shape)[pair] * 256 + row
    key = (np.asarray(inter.pair_inst)[pair].astype(np.int64) << 16) \
        + np.asarray(inter.library.prim_index)[lib_slot]
    return np.where(slot < 0, -1, key)


def _assert_uv(inter, slot, o, d, dt, same, got, ref):
    """u, v within UV_ATOL + |dt| |r . d'| + ULPS |r| |o'| where the
    identities agree (o', d' the ray in the winner's object space).  The
    last term is new with instancing: each side rounds its own o' = A (o -
    b) (XLA may fuse the multiply-adds), and the Woop row r (|r| ~ 1 /
    triangle edge) magnifies that rounding into u and v."""
    slot = np.asarray(slot)
    pos = np.maximum(slot, 0)
    pair = pos // 256
    rows = np.asarray(inter.library.woop)[
        np.asarray(inter.pair_shape)[pair] * 256 + pos % 256]
    m = np.asarray(inter.inst_rows)[np.asarray(inter.pair_inst)[pair], :12]
    A = m[:, :9].reshape(-1, 3, 3)
    o_obj = np.einsum("rij,rj->ri", A, o - m[:, 9:12])
    d_obj = np.einsum("rij,rj->ri", A, d)
    for r, g, e in zip((rows[:, 0:3], rows[:, 3:6]), got, ref):
        slack = (UV_ATOL + np.abs(dt) * np.abs((r * d_obj).sum(-1))
                 + ULPS * np.abs(r).sum(-1) * np.abs(o_obj).max(-1))
        err = np.abs(np.asarray(g) - np.asarray(e))
        assert (err <= slack)[same].all(), (err - slack)[same].max()


def test_library_matches_jax():
    """The port's own host build gives the JAX arrays, NaNs included."""
    lib, offsets, counts = _library()
    jl = jinst.build_instanced_library(lib, offsets, counts)
    tl = tinst.build_instanced_library(lib, offsets, counts, device="cpu")
    assert tl.shape_cluster_offset == jl.shape_cluster_offset
    for f in dataclasses.fields(tl):
        if f.name != "shape_cluster_offset":
            np.testing.assert_array_equal(getattr(tl, f.name).numpy(),
                                          np.asarray(getattr(jl, f.name)))


def test_pairs_and_refit_match_jax(small):
    """make_pairs and refit_instanced (an invalid instance included) give
    the JAX arrays: pairs exactly, boxes and affine rows to 1e-6 with the
    NaNs in the same places."""
    s = small
    tl = convert.instanced_library(convert.state_arrays(s["jlib"]),
                                   device="cpu")
    ps, pi = tinst.make_pairs(tl, s["sid"])
    jps, jpi = jinst.make_pairs(s["jlib"], s["sid"])
    np.testing.assert_array_equal(ps.numpy(), np.asarray(jps))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
    got = tinst.refit_instanced(tl, ps, pi, _t(s["rot"]), _t(s["shift"]),
                                s["scale"], _t(s["valid"]))
    ref = jinst.refit_instanced(
        s["jlib"], jps, jpi, jnp.asarray(s["rot"]), jnp.asarray(s["shift"]),
        jnp.float32(s["scale"]), jnp.asarray(s["valid"]))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(r))
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=1e-6)
    assert np.isnan(got[0].numpy()).any()           # the invalid instance
    # the frame intersector built on the port side matches too
    inter = tinst.make_instanced_intersector(
        tl, s["sid"], _t(s["rot"]), _t(s["shift"]), s["scale"],
        _t(s["valid"]))
    np.testing.assert_allclose(inter.scene_lo.numpy(),
                               np.asarray(s["jinter"].scene_lo), rtol=1e-6)
    np.testing.assert_allclose(inter.scene_hi.numpy(),
                               np.asarray(s["jinter"].scene_hi), rtol=1e-6)


def test_convert_carries_state(small):
    """convert.py hands the JAX intersector over array for array."""
    j, t = small["jinter"], small["tinter"]
    for f in dataclasses.fields(t):
        if f.name != "library":
            np.testing.assert_array_equal(getattr(t, f.name).numpy(),
                                          np.asarray(getattr(j, f.name)))
    assert t.pair_shape.dtype == torch.int32
    assert t.library.shape_cluster_offset == j.library.shape_cluster_offset


def _march_args(inter, o, d, tmin, tmax):
    return (inter.pair_min, inter.pair_max, inter.sub_min, inter.sub_max,
            inter.pair_shape, inter.pair_inst, inter.inst_rows,
            inter.library.woop_t, inter.library.woop, o, d, tmin, tmax)


@pytest.mark.parametrize("any_hit", [False, True])
def test_block_march_instanced_matches_jax(scenes, any_hit):
    """Kernel E's plain version against the JAX kernel on the same pair
    state: camera and incoherent rays, nearest and occlusion."""
    s = scenes
    o, d = _waves(s)
    n = o.shape[0]
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 6.0 if any_hit else 1e16, np.float32)
    jt, js, ju, jv = jbm.block_march_instanced(
        *_march_args(s["jinter"], *(jnp.asarray(x) for x in (o, d, tmin,
                                                              tmax))),
        any_hit=any_hit)
    tt, ts, tu, tv = tbm.block_march_instanced(
        *_march_args(s["tinter"], *(_t(x) for x in (o, d, tmin, tmax))),
        any_hit=any_hit)
    if any_hit:
        np.testing.assert_array_equal(ts.numpy() >= 0, np.asarray(js) >= 0)
        assert 0 < int((ts >= 0).sum()) < n
        return
    kj, kt = _keys(s["jinter"], js), _keys(s["jinter"], ts.numpy())
    assert hit_mismatches(_t(kt), tt, _t(kj), _t(jt)) == 0
    assert (kt >= 0).sum() > n // 8
    _assert_uv(s["jinter"], ts.numpy(), o, d, tt.numpy() - np.asarray(jt),
               kj == kt, (tu, tv), (ju, jv))


def _flat_scene(s):
    flat, base = _flatten(s["lib"], s["offsets"], s["counts"], s["sid"],
                          s["rot"], s["shift"], s["scale"])
    return Scene(Spheres.empty(device="cpu"),
                 Triangles.from_arrays(flat, device="cpu")), base


def test_intersector_matches_oracle(scenes):
    """The sorted TLAS marcher (plain E) against brute force on the
    flattened scene: hit masks, t and flat ids under the hit rule."""
    s = scenes
    scene, base = _flat_scene(s)
    o, d = (_t(x) for x in _waves(s))
    hit, inst = s["tinter"].intersect(o, d)
    ref = intersect_scene_bruteforce(scene, o, d)
    inst_c = torch.clamp(inst, min=0).long()
    flat = (torch.as_tensor(base)[inst_c] + hit.prim_id
            - torch.as_tensor(s["offsets"][s["sid"]])[inst_c])
    got = torch.where(hit.is_hit, flat, -1)
    want = torch.where(ref.is_hit, ref.prim_id, -1)
    assert hit_mismatches(got, hit.t, want, ref.t) == 0
    assert int(ref.is_hit.sum()) > o.shape[0] // 8
    # occlusion on segments ending just past the nearest hit
    cap = torch.where(ref.is_hit, ref.t + 0.1, torch.full_like(ref.t, 2.0))
    occ = s["tinter"].any_hit(o, d, t_max=cap)
    assert torch.equal(occ, ref.t <= cap)


@pytest.fixture(scope="module")
def raster_setup():
    s = _setup(10, 1.0, 11)
    cam = JCamera.look_at((9.0, 0.5, 1.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    o, d = cam.generate_rays(32, 32)
    return s, np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)


def test_raster_origin_matches_jax(raster_setup):
    """Kernel D's plain version in origin mode (nearest) against the JAX
    query: identities under the hit rule, u and v."""
    s, o, d = raster_setup
    n = o.shape[0]
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    tmax[::13] = 0.0                                   # dead rays
    kw = dict(mode="origin", block_rays=256)
    jt, js, ju, jv, jok = jri.instanced_raster_query(
        s["jinter"], *(jnp.asarray(x) for x in (o, d, tmin, tmax)),
        point=jnp.asarray(o[0]), **kw)
    tt, ts, tu, tv, tok = tri.instanced_raster_query(
        s["tinter"], *(_t(x) for x in (o, d, tmin, tmax)), point=_t(o[0]),
        **kw)
    assert bool(jok) and tok
    kj, kt = _keys(s["jinter"], js), _keys(s["jinter"], ts.numpy())
    assert hit_mismatches(_t(kt), tt, _t(kj), _t(jt)) == 0
    assert (kt[::13] == -1).all() and (kt >= 0).sum() > n // 10
    _assert_uv(s["jinter"], ts.numpy(), o, d, tt.numpy() - np.asarray(jt),
               kj == kt, (tu, tv), (ju, jv))
    # the pair count the binning enumerates is JAX's
    assert tri.measure_instanced_pair_count(
        s["tinter"], *(_t(x) for x in (o, d, tmin, tmax)), "origin",
        _t(o[0]), block_rays=256) > 0


def test_raster_flipped_occlusion_matches_jax(raster_setup):
    """A point-light shadow wave in target mode, any-hit: re-traced from
    the light (kernel D, origin mode, any-hit); only is_hit counts."""
    s, o, d = raster_setup
    hit, _ = s["tinter"].intersect(_t(o), _t(d))
    p = torch.where(hit.is_hit[:, None], _t(o) + hit.t[:, None] * _t(d),
                    _t(o))
    to_l = torch.tensor(LIGHT) - p
    dist = torch.linalg.norm(to_l, dim=-1)
    wl = to_l / dist[:, None]
    so, tmax = (p + wl * 1e-3).numpy(), (dist - 1e-3).numpy()
    light = np.asarray(LIGHT, np.float32)
    ref = np.asarray(s["jinter"].any_hit_from(
        jnp.asarray(so), jnp.asarray(wl.numpy()), mode="target",
        point=jnp.asarray(light), t_max=jnp.asarray(tmax), block_rays=256))
    got = s["tinter"].any_hit_from(_t(so), wl, mode="target",
                                   point=_t(light), t_max=_t(tmax),
                                   block_rays=256)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < int(got.sum()) < got.numel()
    # and the marcher agrees on the unflipped wave
    assert torch.equal(got, s["tinter"].any_hit(_t(so), wl, t_max=_t(tmax)))


def test_raster_overflow_falls_back(raster_setup):
    """A tiny pc_max overflows on both sides, and intersect_from then
    returns the sorted marcher's result."""
    s, o, d = raster_setup
    n = o.shape[0]
    tmin, tmax = np.full(n, 1e-3, np.float32), np.full(n, 1e16, np.float32)
    kw = dict(mode="origin", block_rays=256, pc_max=2)
    *_, jok = jri.instanced_raster_query(
        s["jinter"], *(jnp.asarray(x) for x in (o, d, tmin, tmax)),
        point=jnp.asarray(o[0]), **kw)
    *_, tok = tri.instanced_raster_query(
        s["tinter"], *(_t(x) for x in (o, d, tmin, tmax)), point=_t(o[0]),
        **kw)
    assert not bool(jok) and not tok
    h_f, i_f = s["tinter"].intersect_from(_t(o), _t(d), point=_t(o[0]), **kw)
    h_m, i_m = s["tinter"].intersect(_t(o), _t(d))
    for a, b in ((h_f.prim_id, h_m.prim_id), (h_f.t, h_m.t), (i_f, i_m)):
        assert torch.equal(a, b)
    h_r, i_r = s["tinter"].intersect_from(_t(o), _t(d), point=_t(o[0]),
                                          mode="origin", block_rays=256)
    assert hit_mismatches(i_r * 4096 + h_r.prim_id, h_r.t,
                          i_m * 4096 + h_m.prim_id, h_m.t) == 0
