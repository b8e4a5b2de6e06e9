"""The path tracer's next-event estimation and MIS (the plain twins of
kernels L, M and N: ``pathtracer.nee_sample_plain``, ``nee_add_plain``
and ``hit_radiance_plain``) on the CPU, against the same arithmetic built
from the JAX package's own functions (``render/pathtracer.py:201-322``:
its ``scene/lights.sample_lights`` and ``light_pdf_solid_angle``, its
``render/envmap.EnvMap.sample_direction`` / ``sample`` /
``pdf_solid_angle`` and ``utils/rng.uniform4``) on seeded numpy waves:
both samplers; area lights only, the environment only and both; the
firefly clamp off and on; ``restir_direct`` at bounces 0, 1 and 2; dead,
EMISSIVE and non-ROUGH lanes; shading points in the plane of a light
(edge-on: pdf 0); light and block CDFs holding a drawn uniform exactly;
a map of 12 x 20 texels (neither a power of two; its second CDF block
half padding) whose table sends draws into the zero-weight padded
texels.  The kernels run on the card only (tests/test_torch_cuda.py).

Tolerances, each with its reason:
- the light pick, the texel pick, the validity masks (and t_max 0 or
  not) and the emitter / miss masks: equal (bit-equal uniforms, the same
  searches, comparisons of equal or 1-ulp-apart values away from 0);
- origins, light directions, distances and pdfs: 1e-6 absolute or 1e-5
  relative (XLA's CPU backend may fuse the light point's multiply-adds
  and the offset origin's);
- environment directions: 1e-6 absolute (XLA's float32 sin / cos against
  torch's, 2 ulp of 1.0 at most), their pdfs 1e-5 relative;
- contributions and radiance: 1e-5 relative and 1e-7 absolute where
  only float arithmetic separates them; 1e-4 relative (and 1e-6
  absolute) where a bilinear lookup enters, as tests/test_torch_
  pathtracer.py holds ``EnvMap.sample`` (atan2 / acos ulps move the
  bilinear weights), on >= 99.9% of lanes: the miss pdf's texel lookup
  may sit on the other side of a texel edge, the same rule as there, and
  the environment sample aims at the sun, whose disk edge is ~80x the sky
  around it, so the weights' shift moves a sample's radiance up to 1e-3
  relative; every lane of both, samples and missed lanes, within 1e-3
  relative (the missed lanes' worst on these waves: 2.4e-5);
- ``nee_add_plain``: bit for bit, signed zeros included (both sides add
  the same float32 values in the same order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.render import envmap as jenv
from optix_ray_tracer_tpu.render import pathtracer as jpt
from optix_ray_tracer_tpu.scene import lights as jlights
from optix_ray_tracer_tpu.utils import rng as jrng
from optix_ray_tracer_tpu.utils import vecmath as jvm
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.ops.intersect import Hit
from optix_ray_tracer_tpu_torch.render import pathtracer as tpt
from optix_ray_tracer_tpu_torch.scene.materials import EMISSIVE, ROUGH
from test_torch_pathtracer import _two_light_scene, _write_hdr

torch.set_num_threads(2)

CPU = "cpu"
N = 4096
SEED = 0x9E3779B9
CLAMP = 0.5
PRIM_TRIANGLE, PRIM_SPHERE = 2, 1


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, ref, rtol=1e-5, atol=1e-7, err=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=err)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """(JAX, port) pairs: the two-light scene's light table, a sky with a
    sun (64 x 128, tables), a 12 x 20 .hdr map (tables; its second CDF
    block 112 texels and 16 zero-weight padding) and a constant map (no
    tables); the scene's triangle count."""
    js, jm = _two_light_scene()
    jl = jlights.collect_area_lights(js, jm)
    rng = np.random.default_rng(8)
    hdr = tmp_path_factory.mktemp("nee") / "odd.hdr"
    _write_hdr(hdr, rng.uniform(0.05, 4.0, (12, 20, 3)).astype(np.float32))
    maps = {"sky": jenv.gradient_sky(sun_dir=(0.4, 0.25, 0.88),
                                     sun_cos=0.995),
            "hdr": jenv.read_hdr(str(hdr)),
            "constant": jenv.constant_env((0.7, 0.8, 0.9))}
    port = {k: convert.envmap(convert.state_arrays(v), CPU)
            for k, v in maps.items()}
    return dict(lights=(jl, convert.area_lights(convert.state_arrays(jl),
                                                CPU)),
                maps={k: (maps[k], port[k]) for k in maps},
                n_tris=int(js.triangles.vertices.shape[0]))


def _wave(seed: int):
    """N shading points over the two-light scene's floor and in the
    lights' plane (z = 2: edge-on), unit normals mostly up, every material
    type, dead lanes, throughputs above 1."""
    r = np.random.default_rng(seed)
    pts = np.concatenate([r.uniform(-3, 3, (N, 2)),
                          r.uniform(0, 1.9, (N, 1))], -1).astype(np.float32)
    pts[:256, 2] = 2.0
    nrm = r.normal(size=(N, 3)).astype(np.float32) + [0, 0, 1.5]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return dict(
        point=pts, n_unit=nrm.astype(np.float32),
        shading_alive=r.random(N) < 0.85,
        mtype=r.choice([ROUGH, ROUGH, ROUGH, 1, 2, EMISSIVE], N).astype(
            np.int32),
        throughput=r.uniform(0, 2.5, (N, 3)).astype(np.float32),
        albedo=r.uniform(0, 1, (N, 3)).astype(np.float32),
        pixel_id=r.integers(0, 1 << 22, N).astype(np.int64),
        sample=r.integers(0, 64, N).astype(np.int64))


ARGS = ("point", "n_unit", "shading_alive", "mtype", "throughput", "albedo",
        "pixel_id", "sample")


def _draws(w, b, salt, sampler):
    return [np.asarray(u) for u in jrng.uniform4(
        jnp.asarray(w["pixel_id"]), jnp.asarray(w["sample"]), b,
        SEED ^ salt, sampler)]


def _tie(cdf, u):
    """``cdf`` with the entry that the left search picks for one of the
    draws ``u`` (not the last entry) set to that draw: an exact tie, the
    entries still sorted."""
    cdf = cdf.copy()
    k = np.searchsorted(cdf, u)
    lane = np.flatnonzero(k < len(cdf) - 1)[0]
    cdf[k[lane]] = u[lane]
    assert (np.searchsorted(cdf, u)[lane] == k[lane]
            and cdf[k[lane]] == u[lane])
    return cdf


def _light_table_hit(jl, w, b, sampler):
    """The light table with a CDF entry equal to a lane's CDF draw."""
    u = _draws(w, b, jpt._DIM_LIGHT, sampler)
    cdf = _tie(np.asarray(jl.cdf), u[2] if sampler == "sobol" else u[0])
    return dataclasses.replace(jl, cdf=jnp.asarray(cdf))


def _map_table_hit(je, w, b, sampler):
    """The map with a block-CDF entry equal to a lane's block draw and, in
    a padded last block, the CDF row flat from its 100th entry at 0.9, so
    that texel draws above 0.9 land in the zero-weight padding (and clamp
    to the last texel)."""
    ub, ut = _draws(w, b, jpt._DIM_ENV, sampler)[:2]
    block = _tie(np.asarray(je.block_cdf), ub)
    cond = np.asarray(je.cond_cdf).copy()
    h, wd = je.image.shape[:2]
    if (h * wd) % jenv.EnvMap.BLOCK:
        cond[-1, 100:-1] = 0.9
        padded = (np.searchsorted(block, ub) == len(block) - 1) & (ut > 0.9)
        assert padded.any()
    return dataclasses.replace(je, block_cdf=jnp.asarray(block),
                               cond_cdf=jnp.asarray(cond))


def _jax_nee(w, b, sampler, jl, je, clamp):
    """pathtracer.py:274-322 of the JAX package up to the shadow queries,
    with its own functions: (origin, [wl, t_max, contrib, valid], [we,
    t_max, contrib, valid]); a contribution is where(valid, cap(contrib), 0), which
    equals the cap of where(visible, contrib, 0) on the lanes that the
    queries leave visible."""
    j = {k: jnp.asarray(w[k]) for k in ARGS}
    n = j["n_unit"]
    alive_rough = j["shading_alive"] & (j["mtype"] == ROUGH)

    def cap(c):
        return jnp.minimum(c, clamp) if b >= 1 and clamp > 0 else c

    out = [j["point"] + n * 1e-3]
    f = j["albedo"] / jvm.PI
    if jl is not None:
        wl, dist, pdf_l, emitted, _ = jlights.sample_lights(
            jl, j["point"], j["pixel_id"], j["sample"], b,
            SEED ^ jpt._DIM_LIGHT, mode=sampler)
        cos_s = jvm.dot(wl, n)
        valid = alive_rough & (cos_s > 0.0) & (pdf_l > 0.0)
        w_nee = pdf_l / jnp.maximum(pdf_l + jnp.maximum(cos_s, 0.0) / jvm.PI,
                                    1e-12)
        c = (j["throughput"] * f * emitted
             * (jnp.maximum(cos_s, 0.0) / jnp.maximum(pdf_l, 1e-12)
                * w_nee)[..., None])
        out += [wl, jnp.where(valid, dist - 2e-3, 0.0),
                jnp.where(valid[..., None], cap(c), 0.0), valid]
    if je is not None:
        ub, ut, uj, vj = jrng.uniform4(j["pixel_id"], j["sample"], b,
                                       SEED ^ jpt._DIM_ENV, sampler)
        we, pdf_e = je.sample_direction(ub, ut, uj, vj)
        cos_e = jvm.dot(we, n)
        valid_e = alive_rough & (cos_e > 0.0) & (pdf_e > 0.0)
        w_env = pdf_e / jnp.maximum(pdf_e + jnp.maximum(cos_e, 0.0) / jvm.PI,
                                    1e-12)
        c = (j["throughput"] * f * je.sample(we)
             * (jnp.maximum(cos_e, 0.0) / jnp.maximum(pdf_e, 1e-12)
                * w_env)[..., None])
        out += [we, jnp.where(valid_e, jvm.INF, 0.0),
                jnp.where(valid_e[..., None], cap(c), 0.0), valid_e]
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("clamp", [0.0, CLAMP])
@pytest.mark.parametrize("parts", ["area", "sky", "both"])
@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_nee_sample_plain_matches_jax(tables, sampler, parts, clamp):
    """The twin of L against the JAX package's NEE sampling on a wave with
    dead, EMISSIVE, METAL and DIELECTRIC lanes and edge-on points; "sky"
    takes the 12 x 20 map (padded block, flattened row), "both" the
    sky."""
    b = 2
    w = _wave(len(sampler) + len(parts))
    jl = tl = je = te = None
    if parts in ("area", "both"):
        jl = _light_table_hit(tables["lights"][0], w, b, sampler)
        tl = convert.area_lights(convert.state_arrays(jl), CPU)
    if parts in ("sky", "both"):
        je = _map_table_hit(tables["maps"]["hdr" if parts == "sky"
                                           else "sky"][0], w, b, sampler)
        te = convert.envmap(convert.state_arrays(je), CPU)
    origin, area, sky = tpt.nee_sample_plain(
        *(_t(w[k]) for k in ARGS), b, SEED, sampler, tl, te, clamp)
    ref = _jax_nee(w, b, sampler, jl, je, clamp)
    _close(origin, ref[0], atol=1e-6, err="origin")
    ref = ref[1:]
    for part, name in ((area, "area"), (sky, "sky")):
        if part is None:
            continue
        rd, rt, rc, rv = ref[:4]
        ref = ref[4:]
        d, t, c, v = (x.numpy() for x in part)
        np.testing.assert_array_equal(v, rv, err_msg=name)
        np.testing.assert_array_equal(t != 0, rt != 0, err_msg=name)
        assert v.any() and not v.all(), name
        _close(d, rd, atol=1e-6, err=f"{name} direction")
        _close(t, rt, err=f"{name} t_max")
        if name == "sky":
            near = np.isclose(c, rc, rtol=1e-4, atol=1e-6).all(-1)
            assert near.mean() >= 0.999, near.mean()
            _close(c, rc, rtol=1e-3, atol=1e-6, err="sky contribution")
        else:
            _close(c, rc, err="area contribution")
        if clamp:
            assert c.max() <= clamp
    if area is not None:
        # the edge-on lanes: pdf 0, never valid
        assert not (area[1].numpy()[:256] != 0).any()


@pytest.mark.parametrize("parts", ["area", "sky", "both"])
def test_nee_add_plain_matches_jax(parts):
    """The twin of M against the JAX package's additions, bit for bit:
    radiance (with -0.0 lanes) plus each contribution where its sample is
    valid and its segment not occluded, area first."""
    r = np.random.default_rng(len(parts))
    rad = r.uniform(0, 3, (N, 3)).astype(np.float32)
    rad[:64] = -0.0
    jr = jnp.asarray(rad)
    got = _t(rad)
    args = []
    for part in ("area", "sky"):
        on = parts in (part, "both")
        contrib = r.uniform(0, 2, (N, 3)).astype(np.float32)
        valid = r.random(N) < 0.6
        occ = r.random(N) < 0.3
        args += [_t(np.where(valid[:, None], contrib, 0.0).astype(
            np.float32)), _t(valid), _t(occ)] if on else [None] * 3
        if on:
            jr = jr + jnp.where((valid & ~occ)[:, None], contrib, 0.0)
    got = tpt.nee_add_plain(got, *args)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(jr).view(np.int32))


def _hits(seed: int, n_tris: int, light_tris):
    """N ray ends: missed and hit lanes (disjoint; some dead), directions,
    prev_pdf 0 (camera ray or delta lobe) or > 0, EMISSIVE hits on light
    triangles, other triangles and spheres, hit distances."""
    r = np.random.default_rng(seed)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    state = r.integers(0, 3, N)        # 0 dead, 1 missed, 2 hit
    ptype = np.where(r.random(N) < 0.8, PRIM_TRIANGLE, PRIM_SPHERE)
    pid = np.where(r.random(N) < 0.6, r.choice(light_tris, N),
                   r.integers(0, n_tris, N))
    return dict(
        radiance=r.uniform(0, 1, (N, 3)).astype(np.float32), d=d,
        prev_pdf=np.where(r.random(N) < 0.3, 0.0,
                          r.uniform(0.01, 3, N)).astype(np.float32),
        throughput=r.uniform(0, 2.5, (N, 3)).astype(np.float32),
        missed=state == 1, hit_alive=state == 2,
        mtype=r.choice([ROUGH, 1, EMISSIVE, EMISSIVE], N).astype(np.int32),
        emission=r.uniform(0, 20, (N, 3)).astype(np.float32),
        t=np.where(state == 2, r.uniform(0.1, 5, N),
                   jvm.INF).astype(np.float32),
        prim_id=pid.astype(np.int32), prim_type=ptype.astype(np.int32),
        prim_diff=r.random(N) < 0.5)


def _jax_hit_radiance(h, b, jl, je, bg, clamp, restir):
    """pathtracer.py:201-247 of the JAX package: the miss term, then the
    emitted term, with its own functions."""
    j = {k: jnp.asarray(v) for k, v in h.items()}

    def cap(c):
        return jnp.minimum(c, clamp) if b >= 1 and clamp > 0 else c

    missed = j["missed"] & (b >= 1) if restir else j["missed"]
    miss = je.sample(j["d"]) if je is not None else jnp.asarray(bg)
    w_miss = 1.0
    if je is not None and je.block_cdf is not None:
        w_miss = jnp.where(
            j["prev_pdf"] > 0.0,
            j["prev_pdf"] / jnp.maximum(
                j["prev_pdf"] + je.pdf_solid_angle(j["d"]), 1e-12),
            1.0)[..., None]
    rad = j["radiance"] + cap(jnp.where(
        missed[..., None], j["throughput"] * miss * w_miss, 0.0))
    is_emitter = j["hit_alive"] & (j["mtype"] == EMISSIVE)
    w_bsdf = jnp.ones((N,), jnp.float32)
    if jl is not None:
        pdf = jlights.light_pdf_solid_angle(
            jl, j["prim_id"], j["prim_type"] == PRIM_TRIANGLE, j["d"],
            j["t"])
        w_bsdf = jnp.where(
            j["prev_pdf"] > 0.0,
            j["prev_pdf"] / jnp.maximum(j["prev_pdf"] + pdf, 1e-12), 1.0)
    vis = is_emitter
    if restir:
        vis = is_emitter & (b >= 1) & ~(j["prim_diff"] & (b == 1))
    return np.asarray(rad + cap(jnp.where(
        vis[..., None], j["throughput"] * j["emission"] * w_bsdf[..., None],
        0.0))), np.asarray(missed), np.asarray(vis)


@pytest.mark.parametrize("clamp", [0.0, CLAMP])
@pytest.mark.parametrize("bounce,restir", [(1, False), (0, True), (1, True),
                                           (2, True)])
@pytest.mark.parametrize("env,lights", [(None, True), ("constant", False),
                                        ("sky", True), ("hdr", False)])
def test_hit_radiance_plain_matches_jax(tables, env, lights, bounce, restir,
                                        clamp):
    """The twin of N against the JAX package's miss and emitter terms: the
    background, a map without tables (no miss MIS) or with them, the
    light table's MIS or none; ReSTIR's bounce-0 and bounce-1 rules."""
    jl, tl = tables["lights"] if lights else (None, None)
    je, te = tables["maps"][env] if env else (None, None)
    light_tris = np.asarray(tables["lights"][0].tri_id)
    h = _hits(bounce + 2 * restir + 4 * lights, tables["n_tris"],
              light_tris)
    bg = (0.2, 0.3, 0.4)
    ref, missed, vis = _jax_hit_radiance(h, bounce, jl, je, bg, clamp,
                                         restir)
    if restir and bounce == 0:
        h["missed"] = np.zeros(N, bool)     # trace_path's rule
    hit = Hit(t=_t(h["t"]), prim_type=_t(h["prim_type"]),
              prim_id=_t(h["prim_id"]), u=torch.zeros(N), v=torch.zeros(N))
    got = tpt.hit_radiance_plain(
        _t(h["radiance"]), _t(h["d"]), _t(h["prev_pdf"]),
        _t(h["throughput"]), _t(h["missed"]), _t(h["hit_alive"]), hit,
        _t(h["mtype"]), _t(h["emission"]), _t(h["prim_diff"]), bounce,
        torch.tensor(bg), tl, te, CLAMP if clamp and bounce >= 1 else 0.0,
        restir).numpy()
    assert vis.any() == (not (restir and bounce == 0))
    changed = missed | vis
    np.testing.assert_array_equal(got[~changed], h["radiance"][~changed])
    if env is None or env == "constant":
        _close(got, ref, err="radiance")
        return
    # the bilinear lookup on missed lanes; the miss pdf's texel may sit on
    # the other side of a texel edge on a few of them
    _close(got[~missed], ref[~missed], err="radiance, hits")
    near = np.isclose(got[missed], ref[missed], rtol=1e-4, atol=1e-6)
    assert near.all(-1).sum() >= 0.999 * missed.sum()
    _close(got[missed], ref[missed], rtol=1e-3, atol=1e-6,
           err="radiance, missed")


def test_dispatch_on_cpu_takes_the_twins(tables, monkeypatch):
    """nee_sample, nee_add and hit_radiance on CPU tensors call their
    twins and return their results."""
    w = _wave(3)
    calls = []
    for name in ("nee_sample_plain", "nee_add_plain", "hit_radiance_plain"):
        real = getattr(tpt, name)
        monkeypatch.setattr(tpt, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    tl, te = tables["lights"][1], tables["maps"]["sky"][1]
    args = [_t(w[k]) for k in ARGS]
    origin, area, sky = tpt.nee_sample(*args, 1, SEED, "pcg", tl, te, 0.0)
    rad = tpt.nee_add(torch.zeros(N, 3), area[2], area[3],
                      torch.zeros(N, dtype=bool), sky[2], sky[3],
                      torch.ones(N, dtype=bool))
    assert torch.equal(rad, area[2] + 0.0)
    h = _hits(1, tables["n_tris"], np.asarray(tables["lights"][0].tri_id))
    hit = Hit(t=_t(h["t"]), prim_type=_t(h["prim_type"]),
              prim_id=_t(h["prim_id"]), u=torch.zeros(N), v=torch.zeros(N))
    tpt.hit_radiance(_t(h["radiance"]), _t(h["d"]), _t(h["prev_pdf"]),
                     _t(h["throughput"]), _t(h["missed"]),
                     _t(h["hit_alive"]), hit, _t(h["mtype"]),
                     _t(h["emission"]), _t(h["prim_diff"]), 1,
                     torch.zeros(3), tl, te)
    assert calls == ["nee_sample_plain", "nee_add_plain",
                     "hit_radiance_plain"]
