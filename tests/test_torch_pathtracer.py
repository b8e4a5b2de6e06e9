"""The path tracer and its modules against the JAX package on the same
numpy inputs: the cosine sampler, uv interpolation, area lights,
environment maps, textures, the Cornell box, ``trace_path`` /
``render_path`` (brute force on the Cornell box; the raster camera wave,
bundle NEE and environment NEE through a MarchIntersector on a textured,
sky-lit scene), ``render_frame`` with ``"integrator": "path"``, the fused
loop against the per-frame loop, and the benchmark configs.

Tolerances, each with its reason:
- integer streams and tables built on the host: equal;
- cosine directions: z to 1 ulp (XLA's CPU sqrt), x and y to 2.4e-7 (2
  ulp of cos/sin, as tests/test_torch_rng.py);
- elementwise float32 arithmetic that XLA's CPU backend may fuse into
  multiply-adds (light points, uv interpolation, bilinear lookups): 1e-6
  absolute or 1e-5 relative;
- atan2/acos ulps move a lookup along a texel, and the bilinear weights
  with it: environment radiance to 1e-4 relative (the weights' shift times
  the contrast of neighbouring texels), pdf lookups equal but on texel
  edges (>= 99.9% of rays);
- images with Russian roulette off: mean |diff| <= 1e-5 and >= 99% of
  pixels within 1e-4 (fp order only; a 1-ulp shift may flip a shadow
  ray's tie or an environment texel on a few pixels of 1,024);
- Russian roulette on: a 1-ulp throughput change may end a path on one
  side only, so the image means over all pixels agree to 2%."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import quad, sphere_with_n_triangles
from optix_ray_tracer_tpu.models import benchmarks as jbench
from optix_ray_tracer_tpu.models import common as jcommon
from optix_ray_tracer_tpu.ops import intersect as jisect
from optix_ray_tracer_tpu.ops.march import make_march_intersector
from optix_ray_tracer_tpu.render import envmap as jenv
from optix_ray_tracer_tpu.render import pathtracer as jpt
from optix_ray_tracer_tpu.scene import lights as jlights
from optix_ray_tracer_tpu.scene import textures as jtex
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.cornell import build_cornell_box as jcornell
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu.utils import rng as jrng
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.io.config import parse_config_dict
from optix_ray_tracer_tpu_torch.models import benchmarks as tbench
from optix_ray_tracer_tpu_torch.models import common as tcommon
from optix_ray_tracer_tpu_torch.ops import intersect as tisect
from optix_ray_tracer_tpu_torch.ops import raster as traster
from optix_ray_tracer_tpu_torch.render import envmap as tenv
from optix_ray_tracer_tpu_torch.render import pathtracer as tpt
from optix_ray_tracer_tpu_torch.scene import lights as tlights
from optix_ray_tracer_tpu_torch.scene import textures as ttex
from optix_ray_tracer_tpu_torch.scene.cornell import (
    build_cornell_box as tcornell,
)
from optix_ray_tracer_tpu_torch.scene.materials import EMISSIVE
from optix_ray_tracer_tpu_torch.utils import rng as trng
from test_torch_bundle import log_bundle_waves

torch.set_num_threads(2)

CPU = "cpu"


def _t(x):
    return torch.as_tensor(np.array(x))


def _arrays_equal(got, ref):
    """Every array of a dataclass (nested ones included) equal to its JAX
    counterpart's."""
    _equal_fields(got, convert.state_arrays(ref))


def _equal_fields(got, arrays: dict):
    for k, v in arrays.items():
        if isinstance(v, dict):
            _equal_fields(getattr(got, k), v)
        elif v is None:
            assert getattr(got, k) is None, k
        else:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, k).cpu()), v, err_msg=k)


def _image_close(got, ref, within_share=0.99):
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-5, diff.mean()
    within = (diff.reshape(-1, 3).max(-1) <= 1e-4).mean()
    assert within >= within_share, within


# ---- samplers and tables ------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11, 0x3C6EF372 ^ 5, 2 ** 31 - 1])
def test_random_cosine_direction(seed):
    r = np.random.default_rng(seed)
    pix = r.integers(0, 1 << 22, 4096).astype(np.int32)
    sample = r.integers(0, 64, 4096).astype(np.int32)
    got = trng.random_cosine_direction(_t(pix), _t(sample), 3, seed).numpy()
    ref = np.asarray(jrng.random_cosine_direction(
        jnp.asarray(pix), jnp.asarray(sample), jnp.int32(3), jnp.int32(seed)))
    # z = sqrt(1 - u2): XLA's CPU float32 sqrt is off by an ulp on ~0.5% of
    # inputs (PyTorch's is correctly rounded), so 1 ulp of 1.0 there
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=0, atol=6e-8)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.4e-7)
    assert (got[:, 2] >= 0).all()


def test_interpolate_uv():
    rng = np.random.default_rng(2)
    n = 40
    uvs = rng.uniform(0, 1, (n, 3, 2)).astype(np.float32)
    v = rng.normal(size=(n, 3, 3)).astype(np.float32)
    js = JScene(spheres=JSpheres.empty(),
                triangles=JTriangles.from_arrays(v, material_id=0, uvs=uvs))
    ts = convert.scene(convert.state_arrays(js), device=CPU)
    r = 500
    hit = dict(t=rng.uniform(0, 5, r).astype(np.float32),
               prim_type=rng.integers(0, 3, r).astype(np.int32),
               prim_id=rng.integers(0, n, r).astype(np.int32),
               u=rng.uniform(0, 0.5, r).astype(np.float32),
               v=rng.uniform(0, 0.5, r).astype(np.float32))
    ref = np.asarray(jisect.interpolate_uv(js, jisect.Hit(
        **{k: jnp.asarray(x) for k, x in hit.items()})))
    got = tisect.interpolate_uv(ts, convert.hit(hit, device=CPU)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert (got[hit["prim_type"] != tisect.PRIM_TRIANGLE] == 0).all()
    # a scene without uvs interpolates zeros
    flat = convert.scene(convert.state_arrays(JScene(
        spheres=JSpheres.empty(), triangles=JTriangles.from_arrays(v))),
        device=CPU)
    assert not tisect.interpolate_uv(flat, convert.hit(hit, device=CPU)).any()


def _two_light_scene():
    """A floor under a small bright and a large dim emitter
    (tests/test_pathtracer.py's power-weighting scene)."""
    mb = MaterialBuilder()
    floor_m = mb.add_rough((0.7, 0.7, 0.7))
    bright = mb.add_emissive((80.0, 80.0, 80.0))
    dim = mb.add_emissive((0.4, 0.4, 0.4))
    parts = [quad([-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0]),
             quad([-1.1, 0.1, 2], [-0.9, 0.1, 2], [-0.9, -0.1, 2],
                  [-1.1, -0.1, 2]),
             quad([0, 1, 2], [2, 1, 2], [2, -1, 2], [0, -1, 2])]
    mats = [floor_m, bright, dim]
    return JScene(spheres=JSpheres.empty(), triangles=JTriangles.from_arrays(
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        np.repeat(np.int32(mats), 2))), mb.build()


@pytest.mark.parametrize("scene,power", [("cornell", True),
                                         ("two", True), ("two", False)])
def test_collect_area_lights_tables(scene, power):
    js, jm = (jcornell()[:2] if scene == "cornell" else _two_light_scene())
    ref = jlights.collect_area_lights(js, jm, power_weighted=power)
    got = tlights.collect_area_lights(
        convert.scene(convert.state_arrays(js), device=CPU),
        convert.materials(convert.state_arrays(jm), device=CPU),
        power_weighted=power)
    _arrays_equal(got, ref)
    assert got.count == ref.count


def test_no_lights_is_none():
    js = JScene(spheres=JSpheres.empty(),
                triangles=JTriangles.from_arrays(np.eye(3, dtype=np.float32
                                                        )[None]))
    jm = MaterialBuilder().build()
    assert jlights.collect_area_lights(js, jm) is None
    assert tlights.collect_area_lights(
        convert.scene(convert.state_arrays(js), device=CPU),
        convert.materials(convert.state_arrays(jm), device=CPU)) is None


def test_sample_lights_and_pdf():
    """Light samples from random shading points, and the MIS counterpart
    on the sampled directions: equal light picks, geometry to 1e-5."""
    js, jm = _two_light_scene()
    jl = jlights.collect_area_lights(js, jm)
    tl = convert.area_lights(convert.state_arrays(jl), device=CPU)
    rng = np.random.default_rng(4)
    r = 2048
    pts = np.concatenate([rng.uniform(-3, 3, (r, 2)),
                          rng.uniform(0, 1.9, (r, 1))], -1).astype(np.float32)
    pix = rng.integers(0, 1 << 20, r).astype(np.int32)
    ref = [np.asarray(x) for x in jlights.sample_lights(
        jl, jnp.asarray(pts), jnp.asarray(pix), jnp.int32(1), jnp.int32(2),
        jnp.int32(9))]
    got = [x.numpy() for x in tlights.sample_lights(
        tl, _t(pts), _t(pix), 1, 2, 9)]
    for g, e in zip(got, ref):
        np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-6)
    emitters = np.asarray(jl.tri_id)
    tri = rng.choice(emitters, r).astype(np.int32)
    is_tri = rng.uniform(size=r) < 0.8
    t = rng.uniform(0.5, 3.0, r).astype(np.float32)
    jp = np.asarray(jlights.light_pdf_solid_angle(
        jl, jnp.asarray(tri), jnp.asarray(is_tri), jnp.asarray(ref[0]),
        jnp.asarray(t)))
    tp = tlights.light_pdf_solid_angle(tl, _t(tri), _t(is_tri), _t(ref[0]),
                                       _t(t)).numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=0)
    assert (tp[~is_tri] == 0).all() and (tp[is_tri] > 0).any()


def _write_hdr(path, img):
    """A flat-scanline Radiance file of an (H, W, 3) image."""
    h, w = img.shape[:2]
    m = img.max(-1)
    e = np.ceil(np.log2(np.maximum(m, 1e-30))).astype(np.int32)
    scale = np.ldexp(1.0, 8 - e)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-30, e + 128, 0).astype(np.uint8)
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                     + f"-Y {h} +X {w}\n".encode() + rgbe.tobytes())


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """Both packages' maps: a sky with a sun (tables), a constant map (no
    tables), and an .hdr file (tables)."""
    rng = np.random.default_rng(8)
    hdr = tmp_path_factory.mktemp("hdr") / "sky.hdr"
    _write_hdr(hdr, rng.uniform(0.05, 4.0, (8, 20, 3)).astype(np.float32))
    return {
        "sky": (jenv.gradient_sky(sun_dir=(0.4, 0.25, 0.88), sun_cos=0.995,
                                  height=32, width=64),
                tenv.gradient_sky(sun_dir=(0.4, 0.25, 0.88), sun_cos=0.995,
                                  height=32, width=64, device=CPU)),
        "constant": (jenv.constant_env((0.7, 0.8, 0.9)),
                     tenv.constant_env((0.7, 0.8, 0.9), device=CPU)),
        "hdr": (jenv.read_hdr(str(hdr)), tenv.read_hdr(str(hdr), CPU)),
    }


@pytest.mark.parametrize("name", ["sky", "constant", "hdr"])
def test_envmap_tables(envs, name):
    ref, got = envs[name]
    _arrays_equal(got, ref)
    assert got.can_sample == ref.can_sample == (name != "constant")


@pytest.mark.parametrize("name", ["sky", "hdr"])
def test_envmap_lookups(envs, name):
    """sample, pdf_solid_angle and sample_direction against JAX."""
    ref, got = envs[name]
    rng = np.random.default_rng(6)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(got.sample(_t(d)).numpy(),
                               np.asarray(ref.sample(jnp.asarray(d))),
                               rtol=1e-4, atol=1e-6)
    tp = got.pdf_solid_angle(_t(d)).numpy()
    jp = np.asarray(ref.pdf_solid_angle(jnp.asarray(d)))
    close = np.isclose(tp, jp, rtol=1e-5, atol=0)
    assert close.mean() >= 0.999, close.mean()
    u = rng.uniform(0, 1, (4, 4096)).astype(np.float32)
    gd, gp = got.sample_direction(*(_t(x) for x in u))
    rd, rp = ref.sample_direction(*(jnp.asarray(x) for x in u))
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(rp), rtol=1e-5)


def test_textures(tmp_path):
    """The checker, a PPM file, the packed atlas and bilinear samples."""
    np.testing.assert_array_equal(ttex.checker_texture(64, 4),
                                  jtex.checker_texture(64, 4))
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (12, 10, 3)).astype(np.uint8)
    ppm = tmp_path / "t.ppm"
    ppm.write_bytes(b"P6\n# a comment\n10 12\n255\n" + raw.tobytes())
    np.testing.assert_allclose(ttex.load_texture(str(ppm)),
                               jtex.load_texture(str(ppm)), rtol=1e-6,
                               atol=1e-7)
    imgs = [jtex.checker_texture(64, 4), None, jtex.load_texture(str(ppm))]
    ref = jtex.build_texture_set(imgs, [0, -1, 2, 1, None], resolution=32)
    got = ttex.build_texture_set(imgs, [0, -1, 2, 1, None], resolution=32,
                                 device=CPU)
    _arrays_equal(got, ref)
    mid = rng.integers(0, 5, 4096).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (4096, 2)).astype(np.float32)
    np.testing.assert_allclose(
        got.sample(_t(mid), _t(uv)).numpy(),
        np.asarray(ref.sample(jnp.asarray(mid), jnp.asarray(uv))),
        rtol=1e-5, atol=1e-6)


def test_cornell_box():
    js, jm, jc = jcornell()
    ts, tm, tc = tcornell(device=CPU)
    _arrays_equal(ts, js)
    _arrays_equal(tm, jm)
    for k in ("center", "u", "v", "w"):
        np.testing.assert_allclose(getattr(tc, k).numpy(),
                                   np.asarray(getattr(jc, k)), atol=1e-6)
    assert ts.triangle_count == 36


def test_benchmark_configs_match_jax():
    """Configs 4 and 5 build the JAX package's scenes, lights, textures and
    sky; the port's run() of config 4 at 16x16 on the CPU gives finite
    values of the expected shape."""
    j4, t4 = jbench.config4_cornell(), tbench.config4_cornell(device=CPU)
    _arrays_equal(t4["lights"], j4["lights"])
    j5, t5 = jbench.config5_sponza_class(), tbench.config5_sponza_class(
        device=CPU)
    _arrays_equal(t5["scene"], j5["scene"])
    _arrays_equal(t5["textures"], j5["textures"])
    _arrays_equal(t5["env"], j5["env"])
    assert t5["scene"].triangle_count == j5["scene"].triangle_count > 100_000
    for k in ("width", "height", "spp", "max_depth", "integrator"):
        assert t4[k] == j4[k] and t5[k] == j5[k]
    (img, alb, nrm), stats = tbench.run(t4, spp=1, width=16, height=16)
    assert img.shape == (16, 16, 3) and torch.isfinite(img).all()
    assert stats["spp_per_sec"] > 0 and stats["triangles"] == 36


# ---- the integrator -----------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    js, jm, jc = jcornell()
    jl = jlights.collect_area_lights(js, jm)
    return (js, jm, jc, jl, convert.scene(convert.state_arrays(js), CPU),
            convert.materials(convert.state_arrays(jm), CPU),
            convert.camera(convert.state_arrays(jc), CPU),
            convert.area_lights(convert.state_arrays(jl), CPU))


def test_cornell_rr_off_matches_jax(cornell):
    """Brute force, NEE+MIS, Russian roulette off, clamp on, aux taps."""
    js, jm, jc, jl, ts, tm, tc, tl = cornell
    kw = dict(spp=2, seed=3, max_depth=4, rr_start=8, clamp=4.0,
              want_aux=True)
    ref = jpt.render_path(js, jm, jl, jc, 16, 16, **kw)
    got = tpt.render_path(ts, tm, tl, tc, 16, 16, **kw)
    for g, r in zip(got[:3], ref[:3]):
        _image_close(g.numpy(), r, within_share=0.999)
    np.testing.assert_array_equal(got[3][1].numpy(), np.asarray(ref[3][1]))
    np.testing.assert_allclose(got[3][0].numpy(), np.asarray(ref[3][0]),
                               rtol=1e-6)
    assert float(got[0].mean()) > 0.05


def test_cornell_rr_on_matches_jax_in_the_mean(cornell):
    js, jm, jc, jl, ts, tm, tc, tl = cornell
    kw = dict(spp=4, seed=5, max_depth=6, rr_start=1)
    ref = float(np.asarray(jpt.render_path(js, jm, jl, jc, 16, 16,
                                           **kw)[0]).mean())
    got = float(tpt.render_path(ts, tm, tl, tc, 16, 16, **kw)[0].mean())
    assert abs(got - ref) <= 0.02 * ref, (got, ref)


def test_trace_path_refuses_restir_and_sobol(cornell):
    """trace_path's ReSTIR partition (restir_direct) and the Sobol sampler,
    once refused, against the JAX package; Russian roulette off.  Every
    call takes the camera wave's hits precomputed by the JAX package, as
    render_restir_gi hands them over (with a scalar sample): pixel-center
    rays meet the box's corners, where the packages' nearest triangle may
    differ at fp-equal t.  The partition drops exactly the bounce-0 miss
    and emitter radiance and NEE, and the bounce-1 emitter hits of diffuse
    primaries."""
    js, jm, jc, jl, ts, tm, tc, tl = cornell
    jo, jd = jc.generate_rays(16, 16)
    jo, jd = jo.reshape(-1, 3), jd.reshape(-1, 3)
    to, td = tc.generate_rays(16, 16)
    to, td = to.reshape(-1, 3), td.reshape(-1, 3)
    jpid = jnp.arange(256, dtype=jnp.int32)
    tpid = torch.arange(256)
    jhit = jisect.intersect_scene_bruteforce(js, jo, jd)
    thit = convert.hit(convert.state_arrays(jhit), CPU)
    for kw in ({"restir_direct": True}, {"sampler": "sobol"},
               {"restir_direct": True, "sampler": "sobol"}):
        kw = dict(kw, max_depth=4, rr_start=8)
        ref = jpt.trace_path(js, jm, jl, jo, jd, jpid, jnp.int32(2),
                             jnp.int32(5), jnp.zeros(3), first_hit=jhit,
                             **kw)
        got = tpt.trace_path(ts, tm, tl, to, td, tpid, 2, 5, (0, 0, 0),
                             first_hit=thit, **kw)
        for g, r in zip(got, ref):
            _image_close(g.numpy().reshape(16, 16, 3),
                         np.asarray(r).reshape(16, 16, 3),
                         within_share=0.99)
    # the partition: the full trace minus the restir_direct one is the
    # direct part only (bounce-0 emission and NEE, bounce-1 emitter hits
    # of diffuse primaries): no radiance where the camera sees the light
    full = tpt.trace_path(ts, tm, tl, to, td, tpid, 2, 5, (0, 0, 0),
                          max_depth=4, rr_start=8, first_hit=thit)[0]
    part = tpt.trace_path(ts, tm, tl, to, td, tpid, 2, 5, (0, 0, 0),
                          max_depth=4, rr_start=8, restir_direct=True,
                          first_hit=thit)[0]
    mat = ts.triangles.material_id[thit.prim_id.long().clamp(min=0)]
    sees_light = thit.is_hit & (tm.gather(mat)[0] == EMISSIVE)
    assert sees_light.any() and (part[sees_light] == 0).all()
    assert (full[sees_light] > 0).all()
    assert float(part.mean()) < float(full.mean())


@pytest.fixture(scope="module")
def textured():
    """A 4,000-triangle sphere on a checker-textured floor under an area
    light, a metal sphere, sky with a sun: 16 clusters, so the camera wave
    takes the raster engine and the NEE segments the bundle engine, and
    environment NEE runs beside them."""
    mb = MaterialBuilder()
    floor = mb.add_rough((0.9, 0.9, 0.9))
    body = mb.add_rough((0.7, 0.5, 0.3))
    lamp = mb.add_emissive((8.0, 8.0, 7.0))
    metal = mb.add_metal((0.8, 0.8, 0.8), 0.1)
    v, n = sphere_with_n_triangles(4000, (0, 0, 0.5), 0.5)
    fv, fn = quad([-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0])
    fuv = ((fv[..., :2] + 3) / 6).astype(np.float32)
    lv, ln = quad([-0.5, 1.0, 2.0], [-0.5, 1.5, 2.0], [0.5, 1.5, 2.0],
                  [0.5, 1.0, 2.0])
    mats = np.concatenate([np.full(2, floor), np.full(len(v), body),
                           np.full(2, lamp)]).astype(np.int32)
    tris = JTriangles.from_arrays(
        np.concatenate([fv, v, lv]), np.concatenate([fn, n, ln]), mats,
        np.concatenate([fuv, np.zeros((len(v) + 2, 3, 2), np.float32)]))
    js = JScene(spheres=JSpheres.from_list([((1.0, -1.0, 0.3), 0.3,
                                             metal)]), triangles=tris)
    jm = mb.build()
    mt = [-1] * len(mb)
    mt[floor] = 0
    jt = jtex.build_texture_set([jtex.checker_texture(64, tiles=8)], mt,
                                resolution=64)
    je = jenv.gradient_sky(sun_dir=(0.4, 0.25, 0.88), sun_cos=0.995,
                           height=16, width=32)
    jc = JCamera.look_at((3.0, 0.5, 1.5), (0.0, 0.0, 0.4), (0.0, 0.0, 1.0))
    jl = jlights.collect_area_lights(js, jm)
    ji = make_march_intersector(js, raster=True)
    ts = convert.scene(convert.state_arrays(js), CPU)
    t = dict(scene=ts, materials=convert.materials(convert.state_arrays(jm),
                                                   CPU),
             lights=convert.area_lights(convert.state_arrays(jl), CPU),
             camera=convert.camera(convert.state_arrays(jc), CPU),
             intersector=convert.march_intersector(
                 convert.state_arrays(ji.clusters), ts, raster=True,
                 device=CPU),
             env=convert.envmap(convert.state_arrays(je), CPU),
             textures=convert.texture_set(convert.state_arrays(jt), CPU))
    j = dict(scene=js, materials=jm, lights=jl, camera=jc, intersector=ji,
             env=je, textures=jt)
    return j, t


def _render(pkg, p, **kw):
    return pkg.render_path(p["scene"], p["materials"], p["lights"],
                           p["camera"], 32, 32, intersector=p["intersector"],
                           env=p["env"], textures=p["textures"], **kw)


def test_textured_sky_rr_off_matches_jax(textured, monkeypatch):
    """The camera wave on the raster engine, the NEE segments on the
    bundle engine (one wave per bounce, none overflowing), the
    environment NEE and escapes on the marcher."""
    j, t = textured
    assert t["intersector"].clusters.num_clusters >= tpt.BUNDLE_MIN_CLUSTERS
    kw = dict(spp=1, seed=3, max_depth=3, rr_start=8)
    ref = _render(jpt, j, **kw)
    log = log_bundle_waves(monkeypatch)
    got = _render(tpt, t, **kw)
    assert len(log) == 3 and all(0 < pc <= cap for pc, cap in log)
    for g, r in zip(got, ref):
        _image_close(g.numpy(), r)


def test_bundle_nee_off_is_the_same_image(textured, monkeypatch):
    """ORT_BUNDLE_NEE=0 sends the NEE segments to the marcher: the same
    image to fp noise (the two routes are exact)."""
    _, t = textured
    kw = dict(spp=1, seed=4, max_depth=2, rr_start=8)
    on = _render(tpt, t, **kw)[0]
    monkeypatch.setenv("ORT_BUNDLE_NEE", "0")
    log = log_bundle_waves(monkeypatch)
    off = _render(tpt, t, **kw)[0]
    assert log == []
    _image_close(on.numpy(), off.numpy())


def test_textured_sky_rr_on_matches_jax_in_the_mean(textured):
    j, t = textured
    kw = dict(spp=2, seed=6, max_depth=4, rr_start=1)
    ref = float(np.asarray(_render(jpt, j, **kw)[0]).mean())
    got = float(_render(tpt, t, **kw)[0].mean())
    assert abs(got - ref) <= 0.02 * ref, (got, ref)


def test_render_frame_path_matches_jax(textured):
    """render_frame with "integrator": "path" (a-trous on) against the
    JAX package's render_frame on the same config."""
    from optix_ray_tracer_tpu.io.config import (
        parse_config_dict as jparse,
    )
    j, t = textured
    d = {"integrator": "path", "max-depth": 3, "background": [0, 0, 0]}
    jc, tc = jparse(d), parse_config_dict(d)
    assert tcommon.collect_lights(tc, t["scene"], t["materials"]).count == 2
    ref = jcommon.render_frame(jc, j["scene"], j["materials"], j["camera"],
                               32, 32, 1, 7, j["intersector"], env=j["env"],
                               textures=j["textures"], lights=j["lights"])
    got = tcommon.render_frame(tc, t["scene"], t["materials"], t["camera"],
                               32, 32, 1, 7, t["intersector"], env=t["env"],
                               textures=t["textures"], lights=t["lights"])
    for g, r in zip(got, ref):
        _image_close(g.numpy(), r)
    # "restir-gi" (once refused) on the same scene: the raster and march
    # intersector, the environment and textures, against the JAX package
    # (tests/test_torch_restir.py's per-pixel rule and means)
    gi = dict(d, integrator="restir-gi")
    ref = jcommon.render_frame(jparse(gi), j["scene"], j["materials"],
                               j["camera"], 32, 32, 1, 7, j["intersector"],
                               env=j["env"], textures=j["textures"],
                               lights=j["lights"])
    got = tcommon.render_frame(parse_config_dict(gi), t["scene"],
                               t["materials"], t["camera"], 32, 32, 1, 7,
                               t["intersector"], env=t["env"],
                               textures=t["textures"], lights=t["lights"])
    for g, r in zip(got, ref):
        diff = np.abs(g.numpy() - np.asarray(r)).max(-1)
        assert (diff <= 2e-5 * np.abs(np.asarray(r)).max(-1) + 1e-5).mean() \
            >= 0.97
        assert abs(float(g.mean()) - float(np.asarray(r).mean())) <= \
            0.01 * abs(float(np.asarray(r).mean())) + 1e-6


def test_config_builds_env_and_textures(tmp_path):
    """build_envmap / build_textures from config entries equal the JAX
    package's."""
    from optix_ray_tracer_tpu.io.config import (
        parse_config_dict as jparse,
    )
    raw = np.random.default_rng(1).integers(0, 256, (8, 8, 3)).astype(
        np.uint8)
    (tmp_path / "t.ppm").write_bytes(b"P6\n8 8\n255\n" + raw.tobytes())
    d = {"integrator": "path", "roughs": [{"albedo": [0.8, 0.8, 0.8]},
                                          {"albedo": [0.5, 0.5, 0.5]}],
         "envmap": {"type": "gradient-sky", "sun-direction": [0.3, 0.2, 0.9],
                    "sun-cos": 0.99},
         "textures": [{"checker": True, "tiles": 4, "size": 32,
                       "mat-index": 1},
                      {"file": "t.ppm", "mat-index": 0}]}
    jc, tc = jparse(d, base_dir=str(tmp_path)), parse_config_dict(
        d, base_dir=str(tmp_path))
    jm, jb = jcommon.build_materials(jc, 0)
    tm, tb = tcommon.build_materials(tc, 0, CPU)
    _arrays_equal(tcommon.build_envmap(tc, CPU), jcommon.build_envmap(jc))
    got = tcommon.build_textures(tc, tb, tm.count, CPU)
    ref = jcommon.build_textures(jc, jb, jm.count)
    np.testing.assert_array_equal(got.material_texture.numpy(),
                                  np.asarray(ref.material_texture))
    np.testing.assert_allclose(got.atlas.numpy(), np.asarray(ref.atlas),
                               rtol=1e-6, atol=1e-7)
    const = parse_config_dict({"envmap": {"type": "constant"}})
    assert not tcommon.build_envmap(const, CPU).can_sample


# ---- the frontends --------------------------------------------------------

def _path_series(root, n, library, scale):
    """tests/test_torch_frontends.py's Time series with the path
    integrator, an emissive panel above the pile and a sky."""
    import chip_smoke as cs
    from test_torch_frontends import _time_config
    cfg = _time_config(root, n, library, scale)
    light = cs.write_light_obj(root / "light.obj", 30.0, 15.0)
    cfg["meshes"].append({"obj": str(light), "mat-type": "EMISSIVE",
                          "mat-index": 0, "scale": [0.1, 0.1, 0.1]})
    cfg.update({"integrator": "path", "emissives": [{"emission":
                                                     [6.0, 6.0, 6.0]}],
                "envmap": {"type": "gradient-sky"}})
    return cfg


def test_fused_path_matches_per_frame(tmp_path):
    """A Time series over 1024 triangles (the marcher, the raster camera
    wave) with "integrator": "path", area-light NEE and a sky: with
    ``temporal`` off the fused loop equals the per-frame loop across a file
    boundary, to the tolerance of the Whitted version of this test
    (tests/test_torch_frontends.py, rtol 1e-5, atol 1e-6)."""
    import chip_smoke as cs
    from optix_ray_tracer_tpu_torch.models import renderer_time as ttime
    from test_torch_frontends import _configs, _films
    cfg = _path_series(tmp_path, 8, cs.TIME_LIBRARY, 0.15)
    _, tc = _configs(cfg, tmp_path, temporal=False)
    data = ttime.commit(tc, device=CPU)
    assert data.env is not None
    scene = ttime.frame_scene(data, 0, 0, 2)
    assert scene.triangle_count >= 1024
    lights = tcommon.collect_lights(tc, scene, data.materials)
    assert lights.count == 2
    n = 3
    fused_frames = _films(ttime, data, n)
    ttime.set_update_fn(data, lambda s, k: None)
    plain = _films(ttime, data, n)
    assert [f[:2] for f in fused_frames] == [f[:2] for f in plain] == [
        (0, 0), (0, 1), (1, 0)]
    for a, b in zip(fused_frames, plain):
        np.testing.assert_allclose(a[2], b[2], rtol=1e-5, atol=1e-6)
        assert np.isfinite(a[2]).all() and a[2].max() > 0


def test_render_frames_path_matches_jax(tmp_path):
    """The fused loop (temporal on, guides fetched) with the path
    integrator against the JAX package's, on a pile under 1024 triangles
    (brute force on both sides), at the frontends' tolerance."""
    from optix_ray_tracer_tpu.models import renderer_time as jtime
    from optix_ray_tracer_tpu_torch.models import renderer_time as ttime
    from test_torch_frontends import (
        SMALL_LIBRARY, _close_to_jax, _configs, _films,
    )
    cfg = _path_series(tmp_path, 6, SMALL_LIBRARY, 0.12)
    jc, tc = _configs(cfg, tmp_path)
    j, t = jtime.commit(jc), ttime.commit(tc, device=CPU)
    ref = _films(jtime, j, 2, fetch_guides=True)
    got = _films(ttime, t, 2, fetch_guides=True)
    assert [r[:2] for r in got] == [r[:2] for r in ref]
    for g, r in zip(got, ref):
        _close_to_jax(g[2], r[2])
        _close_to_jax(g[3], r[3])


def test_cli_renders_path_sky_textures(tmp_path):
    """``python -m optix_ray_tracer_tpu_torch``'s main on a series with
    "integrator": "path", an area light, an "envmap" and "textures": one
    finite PNG per frame, lit by both the panel and the sky."""
    import chip_smoke as cs
    from optix_ray_tracer_tpu_torch import __main__ as tmain
    from test_torch_frontends import SMALL_LIBRARY
    cfg = _path_series(tmp_path, 6, SMALL_LIBRARY, 0.12)
    cfg["envmap"] = {"type": "gradient-sky", "sun-direction": [0.3, 0.2,
                                                               0.9]}
    cfg["textures"] = [{"checker": True, "tiles": 4, "size": 32,
                        "mat-type": "ROUGH", "mat-index": 0}]
    path = tmp_path / "path.json"
    path.write_text(json.dumps(cfg))
    assert tmain.main(["--cpu", "--config", str(path), "--output",
                       str(tmp_path / "out"), "--frames", "2"]) == 0
    pngs = sorted((tmp_path / "out").glob("frame_*.png"))
    assert len(pngs) == 2
    img = cs.read_png(pngs[0])
    assert img.shape == (24, 32, 4) and img[..., :3].max() > 0
