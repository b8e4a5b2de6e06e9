"""ReSTIR DI and GI of the port (render/restir.py, the ``restir_direct``
partition of render/pathtracer.py and render_frame's ReSTIR branches)
against the JAX package on the same numpy inputs, brute force on the
Cornell box and on a floor under many small lights.

Tolerances, each with its reason:
- the candidates' winners (li, u2, u3) and the confidence m: equal.  The
  port rounds the target's luminance as a chain of fused multiply-adds,
  as XLA's CPU dot does (``utils/color.luminance_fma``), so the weights
  that pick winners agree to an ulp; a 1-ulp weight can still flip a
  pick, so the share of pixels whose winner differs is printed and held
  at <= 1%;
- the primary hits: pixel-center rays meet the box's corners, where the
  two packages' t differ by an ulp and the nearest triangle may differ
  (the hit rule's fp-equal exception).  Such pixels (normal or t apart)
  are counted, held at <= 1%, and left out of the per-pixel checks;
- the weights W, the image and the guides on the other pixels: relative
  2e-5 (float32 rounding of the target's dot products and light points,
  which XLA's CPU backend may fuse into multiply-adds: measured <= 2.5e-6)
  or absolute 1e-6;
- with Russian roulette off and the GI continuation: the path tracer's
  tolerance (tests/test_torch_pathtracer.py), per-pixel as above;
- image means over every pixel: 1%."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.config import parse_config_dict as jparse
from optix_ray_tracer_tpu.io.meshgen import quad
from optix_ray_tracer_tpu.models import common as jcommon
from optix_ray_tracer_tpu.render import restir as jr
from optix_ray_tracer_tpu.scene import lights as jlights
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.cornell import build_cornell_box as jcornell
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.io.config import parse_config_dict
from optix_ray_tracer_tpu_torch.models import common as tcommon
from optix_ray_tracer_tpu_torch.render import restir as tr

torch.set_num_threads(2)

CPU = "cpu"
W = H = 16


def _port(js, jm, jc, jl):
    return (convert.scene(convert.state_arrays(js), CPU),
            convert.materials(convert.state_arrays(jm), CPU),
            convert.camera(convert.state_arrays(jc), CPU),
            convert.area_lights(convert.state_arrays(jl), CPU))


@pytest.fixture(scope="module")
def cornell():
    js, jm, jc = jcornell()
    jl = jlights.collect_area_lights(js, jm)
    return (js, jm, jc, jl), _port(js, jm, jc, jl)


def _many_lights(n: int, seed: int = 0):
    """A ROUGH floor under ``n`` small emissive triangles of three
    radiances (power-weighted CDF), a pinhole camera above."""
    mb = MaterialBuilder()
    floor = mb.add_rough((0.8, 0.7, 0.6))
    lamps = [mb.add_emissive(e) for e in ((4.0, 4.0, 4.0), (9.0, 2.0, 1.0),
                                          (0.5, 1.0, 6.0))]
    r = np.random.default_rng(seed)
    fv, fn = quad([-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0])
    c = r.uniform([-3, -3, 1.0], [3, 3, 2.5], (n, 3)).astype(np.float32)
    lv = (c[:, None, :] + r.uniform(-0.15, 0.15, (n, 3, 3))).astype(
        np.float32)
    ln = np.cross(lv[:, 1] - lv[:, 0], lv[:, 2] - lv[:, 0])
    ln = np.repeat(ln[:, None], 3, 1).astype(np.float32)
    mats = np.concatenate([np.full(len(fv), floor),
                           np.asarray(lamps)[r.integers(0, 3, n)]])
    tris = JTriangles.from_arrays(np.concatenate([fv, lv]),
                                  np.concatenate([fn, ln]),
                                  mats.astype(np.int32))
    js = JScene(spheres=JSpheres.from_list([]), triangles=tris)
    jm = mb.build()
    jc = JCamera.look_at((0.5, -6.0, 5.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    jl = jlights.collect_area_lights(js, jm)
    assert jl.count == n
    return (js, jm, jc, jl), _port(js, jm, jc, jl)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(got, ref, label: str, rtol: float = 2e-5):
    """(img, albedo_g, normal_g, state) of both packages, as the module
    docstring says."""
    gs, rs = got[3], ref[3]
    gn, rn = _np(gs["normal"]), _np(rs["normal"])
    gt, rt = _np(gs["t"]), _np(rs["t"])
    same_hit = ((np.abs(gn - rn).max(-1) <= 1e-4)
                & (np.abs(gt - rt) <= 1e-5 * np.abs(rt) + 1e-6))
    assert same_hit.mean() >= 0.99, (label, same_hit.mean())
    same_win = same_hit.copy()
    for k in ("li", "u2", "u3"):
        same_win &= _np(gs[k]) == _np(rs[k])
    differ = 1.0 - same_win[same_hit].mean()
    print(f"{label}: {differ:.4%} of pixels hold another winner; "
          f"{1.0 - same_hit.mean():.4%} another primary hit")
    assert differ <= 0.01, (label, differ)
    np.testing.assert_array_equal(_np(gs["m"])[same_hit],
                                  _np(rs["m"])[same_hit])
    np.testing.assert_allclose(_np(gs["W"])[same_win], _np(rs["W"])[same_win],
                               rtol=rtol, atol=1e-6)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(_np(g)[same_win], _np(r)[same_win],
                                   rtol=rtol, atol=1e-6)
    gm, rm = float(_np(got[0]).mean()), float(_np(ref[0]).mean())
    assert abs(gm - rm) <= 0.01 * abs(rm), (gm, rm)
    return same_win


def _state(arrays):
    return convert.reservoir_state({k: np.asarray(v)
                                    for k, v in arrays.items()}, CPU)


def test_empty_state_and_pack(cornell):
    (js, jm, jc, jl), (ts, tm, tc, tl) = cornell
    ref = jr.empty_reservoir_state(W, H)
    got = tr.empty_reservoir_state(W, H, CPU)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        assert got[k].dtype == (torch.int32 if k == "li" else torch.float32)
    np.testing.assert_array_equal(tr._pack_lights(tl).numpy(),
                                  np.asarray(jr._pack_lights(jl)))


@pytest.mark.parametrize("n_lights", [16, 200])
@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_initial_candidates(n_lights, sampler):
    """On both sides of the JAX package's dense-lookup limit (128): its
    one-hot matmul and dense CDF compare against the port's row gather and
    searchsorted."""
    assert (n_lights <= jr.DENSE_LOOKUP_MAX) == (n_lights == 16)
    (_, _, _, jl), (_, _, _, tl) = _many_lights(n_lights)
    r = np.random.default_rng(n_lights)
    R = 4096
    point = np.c_[r.uniform(-4, 4, (R, 2)), np.zeros(R)].astype(np.float32)
    n = np.tile(np.float32([0, 0, 1]), (R, 1))
    alb = r.uniform(0.1, 0.9, (R, 3)).astype(np.float32)
    active = r.random(R) < 0.9
    pid = np.arange(R, dtype=np.int32)
    jin = [jnp.asarray(x) for x in (point, n, alb, active, pid)]
    run = jax.jit(lambda *a: jr._initial_candidates(
        jl, jr._pack_lights(jl), *a, jnp.int32(3), jnp.int32(7), 8, sampler))
    ref = run(*jin)
    got = tr._initial_candidates(
        tl, tr._pack_lights(tl), torch.as_tensor(point), torch.as_tensor(n),
        torch.as_tensor(alb), torch.as_tensor(active),
        torch.as_tensor(pid).long(), 3, 7, 8, sampler)
    same = np.ones(R, bool)
    for g, rr in zip(got[:3], ref[:3]):
        same &= g.numpy() == np.asarray(rr)
    print(f"{n_lights} lights, {sampler}: {1 - same.mean():.4%} of winners "
          "differ")
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=2e-5,
                               atol=1e-6)
    assert (got[3].numpy()[~active] == 0).all()


def test_render_restir_no_state(cornell):
    (js, jm, jc, jl), (ts, tm, tc, tl) = cornell
    kw = dict(seed=3, frame=1)
    ref = jr.render_restir(js, jm, jl, jc, W, H, **kw)
    got = tr.render_restir(ts, tm, tl, tc, W, H, **kw)
    _compare(got, ref, "render_restir, no state")
    assert float(got[0].mean()) > 0.05


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_render_restir_temporal_and_spatial(cornell, sampler):
    """Frame 1 reuses frame 0's reservoirs through a moved previous camera
    (temporal reprojection) and 3 spatial taps."""
    (js, jm, jc, jl), (ts, tm, tc, tl) = cornell
    kw = dict(seed=5, spatial_taps=3, spatial_radius=4, sampler=sampler)
    jprev = JCamera.look_at(np.asarray(jc.center) + np.float32([3, 2, 0]),
                            np.asarray(jc.target), np.asarray(jc.up))
    tprev = convert.camera(convert.state_arrays(jprev), CPU)
    ref0 = jr.render_restir(js, jm, jl, jprev, W, H, frame=0, **kw)
    st = _state(ref0[3])
    ref = jr.render_restir(js, jm, jl, jc, W, H, frame=1, state=ref0[3],
                           prev_camera=jprev, **kw)
    got = tr.render_restir(ts, tm, tl, tc, W, H, frame=1, state=st,
                           prev_camera=tprev, **kw)
    _compare(got, ref, f"render_restir temporal + spatial, {sampler}")
    # the history was used: the confidence exceeds one frame's M
    assert (got[3]["m"].numpy() > 16).any()


@pytest.mark.parametrize("n_lights", [16, 200])
def test_render_restir_many_lights(n_lights):
    (js, jm, jc, jl), (ts, tm, tc, tl) = _many_lights(n_lights, 1)
    kw = dict(seed=2, frame=0, spatial_radius=3)
    ref = jr.render_restir(js, jm, jl, jc, W, H, **kw)
    got = tr.render_restir(ts, tm, tl, tc, W, H, **kw)
    _compare(got, ref, f"render_restir, {n_lights} lights")


def test_render_restir_gi(cornell):
    """The GI continuation (restir_direct partition, Russian roulette off at
    depth 3) over a temporal state."""
    (js, jm, jc, jl), (ts, tm, tc, tl) = cornell
    kw = dict(seed=4, max_depth=3)
    ref0 = jr.render_restir_gi(js, jm, jl, jc, W, H, frame=0, **kw)
    ref = jr.render_restir_gi(js, jm, jl, jc, W, H, frame=1, state=ref0[3],
                              **kw)
    got = tr.render_restir_gi(ts, tm, tl, tc, W, H, frame=1,
                              state=_state(ref0[3]), **kw)
    _compare(got, ref, "render_restir_gi")


def test_progressive(cornell):
    (js, jm, jc, jl), (ts, tm, tc, tl) = cornell
    ref = jr.render_restir_progressive(js, jm, jl, jc, W, H, spp=3, seed=9)
    got = tr.render_restir_progressive(ts, tm, tl, tc, W, H, spp=3, seed=9)
    _progressive_close(got, ref)
    ref = jr.render_restir_gi_progressive(js, jm, jl, jc, W, H, spp=2,
                                          seed=9, max_depth=3)
    got = tr.render_restir_gi_progressive(ts, tm, tl, tc, W, H, spp=2,
                                          seed=9, max_depth=3)
    _progressive_close(got, ref)


def _progressive_close(got, ref):
    """Averages over several reservoir generations: a pixel whose winner
    or primary hit differs in one generation differs by that sample's
    share; >= 97% of pixels agree per pixel, the means to 1%."""
    diff = np.abs(got[0].numpy() - np.asarray(ref[0])).max(-1)
    tol = 2e-5 * np.abs(np.asarray(ref[0])).max(-1) + 1e-6
    assert (diff <= tol).mean() >= 0.97, (diff <= tol).mean()
    gm, rm = float(got[0].mean()), float(np.asarray(ref[0]).mean())
    assert abs(gm - rm) <= 0.01 * rm
    for g, r in zip(got[1:], ref[1:]):
        assert (np.abs(g.numpy() - np.asarray(r)).max(-1) <= 1e-5).mean() \
            >= 0.99


@pytest.mark.parametrize("seed,offset", [(0, 0), (7, 1), (3, 16),
                                         (2 ** 31 - 1, 48)])
def test_restir_seed_wraps_to_int32(seed, offset):
    want = np.int64(seed ^ (offset * 0x9E3779B9)).astype(
        np.uint32).view(np.int32)
    got = tcommon.restir_seed(seed, offset)
    assert got == int(want) and -2 ** 31 <= got < 2 ** 31


def test_reference_seed_overflow(cornell):
    """The reference's fault the port repairs: the JAX render_frame passes
    seed ^ (sample_offset * 0x9E3779B9) unwrapped to a jitted int32 seed,
    which overflows from the second progressive batch on."""
    (js, jm, jc, jl), _ = cornell
    cfg = jparse({"integrator": "restir", "denoise": False})
    with pytest.raises(OverflowError):
        jcommon.render_frame(cfg, js, jm, jc, 8, 8, 1, 0, None, lights=jl,
                             sample_offset=16)


@pytest.mark.parametrize("integrator", ["restir", "restir-gi"])
@pytest.mark.parametrize("offset", [0, 16])
def test_render_frame_restir(cornell, integrator, offset):
    """render_frame with either ReSTIR integrator, against the JAX
    progressive function it calls, given the wrapped seed (the JAX
    render_frame itself overflows for offset > 0)."""
    (js, jm, jc, jl), (ts, tm, tc, tl) = cornell
    d = {"integrator": integrator, "denoise": False, "max-depth": 3,
         "background": [0.1, 0.1, 0.2]}
    tc_cfg = parse_config_dict(d)
    seed = tcommon.restir_seed(11, offset)
    kw = dict(spp=2, seed=seed, background=(0.1, 0.1, 0.2))
    if integrator == "restir":
        ref = jr.render_restir_progressive(js, jm, jl, jc, W, H, **kw)
    else:
        ref = jr.render_restir_gi_progressive(js, jm, jl, jc, W, H,
                                              max_depth=3, **kw)
    got = tcommon.render_frame(tc_cfg, ts, tm, tc, W, H, 2, 11, None,
                               lights=tl, sample_offset=offset)
    _progressive_close(got, ref)
    if offset == 0:
        jref = jcommon.render_frame(jparse(d), js, jm, jc, W, H, 2, 11, None,
                                    lights=jl)
        np.testing.assert_array_equal(np.asarray(jref[0]),
                                      np.asarray(ref[0]))


def test_render_frame_restir_needs_lights(cornell):
    _, (ts, tm, tc, tl) = cornell
    cfg = parse_config_dict({"integrator": "restir-gi"})
    with pytest.raises(ValueError, match="emissive"):
        tcommon.render_frame(cfg, ts, tm, tc, 8, 8, 1, 0, None, lights=None)
    empty = dataclasses.replace(tl, v0=tl.v0[:0])
    with pytest.raises(ValueError, match="non-empty light table"):
        tr.render_restir(ts, tm, empty, tc, 8, 8, seed=0)
