"""The path tracer's BSDF step (kernel K's plain twin,
``pathtracer.bsdf_step_plain``) and the per-byte Sobol tables of kernel I
on the CPU: the plain step against the same arithmetic built from the
JAX package's own functions (``render/pathtracer.py:326-384``: its
``_cosine_sample``, ``rng.random_unit_vector`` and ``uniform4``,
``vecmath.reflect`` / ``refract`` / ``schlick_fresnel``) on seeded numpy
inputs, every material type, both samplers, Russian roulette on and off;
``trace_path`` against JAX on a scene with METAL and DIELECTRIC objects
under the Sobol sampler; the tables against ``qmc._sobol``.  The kernels
run on the card only (tests/test_torch_cuda.py).

Tolerances, each with its reason:
- the lobe (by material), the reflect-or-refract choice, the roulette's
  survivors, throughput and the ROUGH rows' pdf up to its square root:
  equal (the same float32 products, quotients and comparisons, and
  bit-equal uniforms);
- prev_pdf: 2 ulp (XLA's CPU sqrt in the cosine lobe's z is an ulp off
  on some inputs, tests/test_torch_pathtracer.py, and the division by PI
  rounds that once more);
- directions: 2 ulp of 1.0 (2.4e-7) per component, whatever the lobe:
  XLA contracts multiply-adds in the basis and the normalisations, and
  its float32 cos / sin are 2 ulp from the port's double ones at most
  (tests/test_torch_rng.py), scaled by a radius <= 1;
- origins: point + n * 1e-3 may be one fused multiply-add in XLA: 1 ulp
  of the point's largest component;
- images: the rule of tests/test_torch_pathtracer.py (mean |diff| <=
  1e-5, >= 99% of pixels within 1e-4 with roulette off; the means within
  2% with it on)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import quad
from optix_ray_tracer_tpu.render import pathtracer as jpt
from optix_ray_tracer_tpu.scene import lights as jlights
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu.utils import rng as jrng
from optix_ray_tracer_tpu.utils import vecmath as jvm
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.render import pathtracer as tpt
from optix_ray_tracer_tpu_torch.scene.materials import (
    DIELECTRIC, EMISSIVE, METAL, ROUGH,
)
from optix_ray_tracer_tpu_torch.utils import qmc
from test_torch_pathtracer import _image_close

torch.set_num_threads(2)

ULP1 = 1.1920929e-7     # float32 ulp of 1.0


def _wave(seed: int, n: int = 4096):
    """A wave of hits over every material type: unit normals facing the
    ray (and the poles of Frisvad's basis), random front flags (back faces
    and grazing rays give total internal reflection), metal fuzz 0 and
    > 0, ior 1.5, 1.33 and 0 (the 1.5 default), throughputs above 1 (the
    roulette's clamp), dead lanes."""
    r = np.random.default_rng(seed)
    mtype = r.integers(0, 4, n).astype(np.int32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = r.normal(size=(n, 3)).astype(np.float32)
    nrm[:8] = [0, 0, 1]
    nrm[8:16] = [0, 0, -1]
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    flip = (d * nrm).sum(-1) > 0
    nrm[flip] = -nrm[flip]
    param = np.where(mtype == METAL, r.choice([0.0, 0.05, 0.3], n),
                     r.choice([1.5, 1.33, 0.0], n)).astype(np.float32)
    return dict(
        d=d, n_unit=nrm,
        point=r.uniform(-5, 5, (n, 3)).astype(np.float32),
        front_face=r.random(n) < 0.5, mtype=mtype,
        albedo=r.uniform(0, 1, (n, 3)).astype(np.float32), param=param,
        throughput=r.uniform(0, 2.5, (n, 3)).astype(np.float32),
        shading_alive=r.random(n) < 0.85,
        o=r.uniform(-5, 5, (n, 3)).astype(np.float32),
        pixel_id=r.integers(0, 1 << 22, n).astype(np.int64),
        sample=r.integers(0, 64, n).astype(np.int64))


def _jax_step(w, b, seed, sampler, rr_start, max_depth):
    """pathtracer.py:326-384 of the JAX package, written with its own
    functions."""
    d, n, param, mtype = w["d"], w["n_unit"], w["param"], w["mtype"]
    pix, samp = w["pixel_id"], w["sample"]
    d_diff, pdf_diff = jpt._cosine_sample(n, pix, samp, b,
                                          seed ^ jpt._DIM_BSDF, sampler)
    fuzz = jrng.random_unit_vector(pix, samp, b, seed ^ jpt._DIM_LOBE,
                                   sampler)
    d_metal = jvm.normalize(jvm.normalize(jvm.reflect(d, n))
                            + param[..., None] * fuzz)
    ior = jnp.where(param > 0.0, param, 1.5)
    eta = jnp.where(w["front_face"], 1.0 / ior, ior)
    cos_theta = jnp.minimum(-jvm.dot(d, n), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta ** 2))
    u_fr = jrng.uniform4(pix, samp, b, seed ^ jpt._DIM_LOBE, sampler)[1]
    do_reflect = (eta * sin_theta > 1.0) | (
        jvm.schlick_fresnel(cos_theta, ior) > u_fr)
    d_diel = jnp.where(do_reflect[..., None],
                       jvm.normalize(jvm.reflect(d, n)),
                       jvm.refract(d, n, eta[..., None]))
    is_metal = (mtype == METAL)[..., None]
    is_diel = (mtype == DIELECTRIC)[..., None]
    new_dir = jvm.normalize(jnp.where(is_diel, d_diel,
                                      jnp.where(is_metal, d_metal, d_diff)))
    alive = w["shading_alive"]
    thr = jnp.where(alive[..., None],
                    w["throughput"] * jnp.where(is_diel, 1.0, w["albedo"]),
                    w["throughput"])
    if rr_start < max_depth:
        u_rr = jrng.uniform4(pix, samp, b, seed ^ jpt._DIM_RR, sampler)[0]
        p_cont = jnp.clip(jnp.max(thr, axis=-1), 0.05, 1.0)
        do_rr = alive & (b >= rr_start)
        thr = jnp.where(do_rr[..., None], thr / p_cont[..., None], thr)
        alive = alive & (~do_rr | (u_rr < p_cont))
    off = jnp.where(is_diel[..., 0] & ~do_reflect, -1e-3, 1e-3)
    o = jnp.where(alive[..., None], w["point"] + n * off[..., None], w["o"])
    d = jnp.where(alive[..., None], new_dir, d)
    pdf = jnp.where(mtype == ROUGH, pdf_diff, 0.0)
    return tuple(np.asarray(x) for x in (o, d, thr, pdf, alive,
                                         do_reflect))


ARGS = ("d", "n_unit", "point", "front_face", "mtype", "albedo", "param",
        "throughput", "shading_alive", "o", "pixel_id", "sample")


@pytest.mark.parametrize("rr", ["off", "on"])
@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_bsdf_step_plain_matches_jax(sampler, rr):
    seed, b, max_depth = 0x2545F491 ^ 77, 2, 8
    rr_start = 1 if rr == "on" else max_depth
    w = _wave(len(sampler) + len(rr))
    got = tpt.bsdf_step_plain(*(torch.as_tensor(w[k]) for k in ARGS), b,
                              seed, sampler, rr_start)
    o, d, thr, pdf, alive = (x.numpy() for x in got)
    r_o, r_d, r_thr, r_pdf, r_alive, r_refl = _jax_step(
        w, b, seed, sampler, rr_start, max_depth)
    np.testing.assert_array_equal(alive, r_alive)
    np.testing.assert_array_equal(thr, r_thr)
    np.testing.assert_array_max_ulp(pdf, r_pdf, maxulp=2)
    # the origins: the same side of the surface, to 1 ulp of the point
    scale = np.abs(w["point"]).max(-1, keepdims=True)
    assert (np.abs(o - r_o) <= scale * ULP1).all()
    assert (np.abs(d - r_d) <= 2 * ULP1).all(), np.abs(d - r_d).max()
    # every branch was taken: both lobes' choices, survivors and deaths
    m = w["mtype"]
    diel = (m == DIELECTRIC) & alive
    refl = np.asarray(r_refl)
    assert (diel & refl).sum() > 50 and (diel & ~refl).sum() > 50
    assert ((m == EMISSIVE) & alive).sum() > 50 and (m == ROUGH).sum() > 50
    if rr == "on":
        died = w["shading_alive"] & ~alive
        assert died.sum() > 50
    else:
        np.testing.assert_array_equal(alive, w["shading_alive"])


def _metal_glass_scene():
    """A ROUGH floor and back wall under an emissive panel, a METAL sphere
    (fuzz 0.1) and a DIELECTRIC one, and a camera on them."""
    mb = MaterialBuilder()
    floor = mb.add_rough((0.8, 0.8, 0.8))
    wall = mb.add_rough((0.6, 0.3, 0.2))
    lamp = mb.add_emissive((6.0, 6.0, 6.0))
    metal = mb.add_metal((0.9, 0.85, 0.8), 0.1)
    glass = mb.add_dielectric(1.5)
    fv, fn = quad((-4, -4, 0), (4, -4, 0), (4, 4, 0), (-4, 4, 0))
    wv, wn = quad((-4, 4, 0), (4, 4, 0), (4, 4, 5), (-4, 4, 5))
    lv, ln = quad((-1, -1, 4.5), (-1, 1, 4.5), (1, 1, 4.5), (1, -1, 4.5))
    tris = JTriangles.from_arrays(fv, fn, floor).concat(
        JTriangles.from_arrays(wv, wn, wall)).concat(
        JTriangles.from_arrays(lv, ln, lamp))
    scene = JScene(JSpheres.from_list([((-1.2, 0.5, 1.0), 1.0, metal),
                                       ((1.3, -0.2, 0.9), 0.9, glass)]),
                   tris)
    mats = mb.build()
    cam = JCamera.look_at((0.0, -7.0, 2.5), (0.0, 0.0, 1.0), (0, 0, 1))
    return scene, mats, jlights.collect_area_lights(scene, mats), cam


@pytest.fixture(scope="module")
def metal_glass():
    js, jm, jl, jc = _metal_glass_scene()
    return (js, jm, jl, jc, convert.scene(convert.state_arrays(js), "cpu"),
            convert.materials(convert.state_arrays(jm), "cpu"),
            convert.area_lights(convert.state_arrays(jl), "cpu"),
            convert.camera(convert.state_arrays(jc), "cpu"))


@pytest.mark.parametrize("rr", ["off", "on"])
def test_trace_path_metal_glass_sobol_matches_jax(metal_glass, rr):
    """render_path (brute force, NEE+MIS, the Sobol sampler) through the
    plain BSDF step on the metal and glass scene: with roulette off equal
    to the JAX render by the image rule, with it on in the mean."""
    js, jm, jl, jc, ts, tm, tl, tc = metal_glass
    kw = dict(spp=2, seed=9, max_depth=5, sampler="sobol",
              rr_start=8 if rr == "off" else 1)
    ref = jpt.render_path(js, jm, jl, jc, 16, 16, **kw)
    got = tpt.render_path(ts, tm, tl, tc, 16, 16, **kw)
    if rr == "off":
        for g, r in zip(got, ref):
            _image_close(g.numpy(), r, within_share=0.99)
    else:
        a, b = float(got[0].mean()), float(np.asarray(ref[0]).mean())
        assert abs(a - b) <= 0.02 * b, (a, b)
    assert float(got[0].mean()) > 0.05


@pytest.mark.parametrize("case", ["random", "edges"])
def test_sobol_byte_tables_give_the_sobol_bits(case):
    """Kernel I's per-byte tables: the XOR of the rows an index's four
    bytes select is ``qmc._sobol``'s raw point, in each of the four
    dimensions, for random indices and for 0, 2^32 - 1 and every
    single-bit index."""
    if case == "random":
        idx = np.random.default_rng(5).integers(0, 1 << 32, 8192,
                                                dtype=np.uint64)
    else:
        idx = np.array([0, (1 << 32) - 1] + [1 << j for j in range(32)],
                       np.uint64)
    tables = qmc.sobol_byte_tables()
    assert tables.shape == (1024, 4) and tables.dtype == np.uint32
    got = np.zeros((idx.size, 4), np.uint32)
    for k in range(4):
        got ^= tables[256 * k + ((idx >> np.uint64(8 * k)) & 255)
                      .astype(np.int64)]
    want = qmc._sobol(torch.as_tensor(idx.astype(np.int64)), (0, 1, 2, 3))
    np.testing.assert_array_equal(got, want.numpy().astype(np.uint32))
