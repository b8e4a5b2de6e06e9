"""The bounce loop's kernels H (PCG4D), I (Sobol-Owen), J (the Whitted
scatter) and K (the path tracer's BSDF step) on the CPU: the argument
normalisation their wrappers apply (``ops/kernels/bounce.lane_args``)
against the broadcast of the plain versions, the plain scatter
(``wavefront.scatter_plain``, J's twin) against the JAX
``wavefront.scatter`` under both samplers, and the
dispatch: CPU tensors reach the plain versions (K's,
``pathtracer.bsdf_step_plain``, is held to JAX in
tests/test_torch_path_scatter.py) and never the library, and the
kernels' wrappers refuse CPU tensors.  The kernels themselves
run on the card only (tests/test_torch_cuda.py).

Tolerances, each with its reason:
- lanes, integer streams, uniforms, attenuation, emission and the
  terminate flags: equal;
- scattered directions: the plain scatter is the port's arithmetic
  unchanged, and its float32 steps differ from XLA's CPU code by an ulp
  on ~1% of rows whatever the branch (XLA contracts multiply-adds, and
  PyTorch's vectorised CPU sqrt is an ulp off on 0.6-0.7% of inputs:
  ROADMAP's hazards), so 4 ulp of 1.0 (4.8e-7) where the direction takes
  no cos/sin (METAL with fuzz 0, DIELECTRIC, the degenerate ROUGH row);
- where it does (ROUGH, METAL with fuzz, EMISSIVE: the unit-sphere
  draw), the RNG contract of tests/test_torch_rng.py on top: 2 ulp of
  1.0 (2.4e-7) in the unit vector's cos/sin components, divided by |n +
  u| (each row's own) by the normalize;
- a reflect / refract or TIR decision that differed would move a
  direction by far more than these bounds.
On the card, the kernel J equals this plain version bit for bit
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.render import wavefront as jwf
from optix_ray_tracer_tpu.scene.materials import (
    MaterialBuilder as JMaterialBuilder,
)
from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.kernels import bounce
from optix_ray_tracer_tpu_torch.render import pathtracer as tpt
from optix_ray_tracer_tpu_torch.render import wavefront as twf
from optix_ray_tracer_tpu_torch.scene.materials import (
    DIELECTRIC, EMISSIVE, METAL, ROUGH, MaterialBuilder,
)
from optix_ray_tracer_tpu_torch.utils import qmc, rng
from optix_ray_tracer_tpu_torch.utils.vecmath import normalize

torch.set_num_threads(2)

MASK = 0xFFFFFFFF
SEEDS = (0, 2 ** 31 - 1, 0xFFFFFFFF, -5, 2 ** 31 + 12345)


def _ids(seed, shape, lo=0, hi=1 << 22, dtype=np.int64):
    r = np.random.default_rng(seed & MASK)
    return torch.as_tensor(r.integers(lo, hi, shape).astype(dtype))


def _lane_u32(lane, shape) -> np.ndarray:
    """What a kernel reads from a lane: the low 32 bits of each element,
    or the value."""
    if lane.tensor is None:
        return np.full(shape, lane.value, np.uint32)
    return lane.tensor.numpy().astype(np.uint32).reshape(shape)


def _plain_u32(arg, shape) -> np.ndarray:
    """The lane the plain versions compute: ``rng._u32`` broadcast."""
    return rng._u32(arg, "cpu").expand(shape).numpy().astype(np.uint32)


# every argument pattern the call sites pass: pixel and sample ids of a
# wave with bounce and seed scalars (the bounce loops, the jitter at
# bounce -1, the lens at -2), a scalar sample (ReSTIR's frame), 2-D pixel
# ids (ReSTIR's reuse taps), int32 samples, a row against a column
PATTERNS = {
    "wave": lambda s: (_ids(s, 4096), _ids(s + 1, 4096, 0, 64), 3, s),
    "jitter": lambda s: (_ids(s, 4096), _ids(s + 1, 4096, 0, 64), -1, s),
    "lens": lambda s: (_ids(s, 4096), _ids(s + 1, 4096, 0, 64), -2,
                       s ^ 0x68E31DA4),
    "scalar_sample": lambda s: (_ids(s, 4096), 17, 5, s),
    "restir_2d": lambda s: (_ids(s, (48, 64)), 3, 64 + 1, s ^ 0x2545F491),
    "int32_sample": lambda s: (_ids(s, 4096, -(1 << 20), 1 << 22, np.int32),
                               _ids(s + 1, 4096, 0, 1 << 20, np.int32), 0,
                               s),
    "row_by_column": lambda s: (_ids(s, (32, 1)), _ids(s + 1, (1, 16), 0, 64),
                                1, s),
    "tensor_bounce_seed": lambda s: (
        _ids(s, 512), _ids(s + 1, 512, 0, 64), _ids(s + 2, 512, -2, 8),
        _ids(s + 3, 512, -(1 << 40), 1 << 40)),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_lane_args_match_plain_broadcast(pattern, seed):
    """lane_args gives the broadcast shape of the plain versions and, lane
    by lane, the uint32 words the plain ``_u32`` broadcast computes;
    int32 and int64 tensors pass through uncopied when they already have
    the shape, scalars go by value."""
    args = PATTERNS[pattern](seed)
    shape, lanes = bounce.lane_args(*args)
    ref = rng.pcg4d_plain(*args)
    assert shape == ref[0].shape
    for arg, lane in zip(args, lanes):
        if isinstance(arg, torch.Tensor):
            assert lane.tensor.dtype == arg.dtype
            assert lane.tensor.shape == (shape.numel(),)
            assert lane.tensor.is_contiguous()
            if arg.shape == shape:
                assert lane.tensor.data_ptr() == arg.data_ptr()
        else:
            assert lane.tensor is None and lane.value == arg & MASK
        np.testing.assert_array_equal(_lane_u32(lane, shape),
                                      _plain_u32(arg, shape))
    # the plain hash of the lanes as a kernel reads them: the same words
    words = [torch.as_tensor(_lane_u32(ln, shape).astype(np.int64))
             for ln in lanes]
    for got, want in zip(rng.pcg4d_plain(*words), ref):
        assert torch.equal(got, want)


def test_lane_args_shape_and_dtypes():
    """J's fixed shape (R,) with scalar bounce and seed; bool and int16
    tensors become int64; a lane that cannot take the shape raises."""
    pix = _ids(1, 300)
    shape, lanes = bounce.lane_args(pix, pix.to(torch.int16) % 7, 2, -1,
                                    shape=(300,))
    assert shape == (300,)
    assert lanes[1].tensor.dtype == torch.int64
    assert (lanes[2].tensor, lanes[2].value) == (None, 2)
    assert lanes[3].value == MASK
    _, lanes = bounce.lane_args(pix > 5, 0, 0, 0)
    assert lanes[0].tensor.dtype == torch.int64
    with pytest.raises(RuntimeError):
        bounce.lane_args(_ids(1, 7), 0, 0, 0, shape=(8,))


def test_sobol_directions_table():
    """The kernels' Sobol table: ``qmc.sobol_byte_tables`` bit for bit,
    whose four rows per index (one per byte) XOR to the Sobol points of
    ``qmc._DIRECTIONS``' first four dimensions (single-bit indices: the
    direction rows themselves)."""
    table = bounce.sobol_tables(torch.device("cpu"))
    assert table.shape == (1024, 4) and table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy().view(np.uint32),
                                  qmc.sobol_byte_tables())
    rows = table.numpy().view(np.uint32).reshape(4, 256, 4)
    for j in range(32):
        np.testing.assert_array_equal(rows[j // 8, 1 << (j % 8)],
                                      qmc._DIRECTIONS[j, :4])


# ---- the plain scatter against the JAX scatter ---------------------------

def _materials():
    """Rows: ROUGH, METAL fuzz 0.3, METAL fuzz 0, DIELECTRIC 1.5,
    DIELECTRIC with param 0 (the 1.5 default), EMISSIVE."""
    rows = [(ROUGH, (0.7, 0.6, 0.5), 0.0, (0, 0, 0)),
            (METAL, (0.8, 0.85, 0.88), 0.3, (0, 0, 0)),
            (METAL, (0.9, 0.9, 0.9), 0.0, (0, 0, 0)),
            (DIELECTRIC, (1.0, 1.0, 1.0), 1.5, (0, 0, 0)),
            (DIELECTRIC, (1.0, 1.0, 1.0), 0.0, (0, 0, 0)),
            (EMISSIVE, (0.0, 0.0, 0.0), 0.0, (4.0, 3.0, 2.0))]
    jb, tb = JMaterialBuilder(), MaterialBuilder()
    for r in rows:
        jb.add(*r)
        tb.add(*r)
    return jb.build(), tb.build(device="cpu")


def _hits(seed: int, n: int, sampler: str, bounce_idx: int, rng_seed: int):
    """A wave of hits over every material (ids -1 and 6 clamp to the
    ends), unnormalised normals facing the ray, random front flags (back
    faces and grazing rays give total internal reflection), and one
    degenerate ROUGH row whose normal cancels its own draw."""
    r = np.random.default_rng(seed)
    mid = r.integers(-1, 7, n).astype(np.int32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm = r.normal(size=(n, 3)).astype(np.float32) * \
        r.uniform(0.5, 3.0, (n, 1)).astype(np.float32)
    flip = (d * nrm).sum(-1) > 0
    nrm[flip] = -nrm[flip]
    front = r.random(n) < 0.5
    pix = r.integers(0, 1 << 20, n).astype(np.int64)
    samp = r.integers(0, 64, n).astype(np.int64)
    # row 0: ROUGH with normal = -(its own unit-sphere draw)
    u = rng.uniform4_plain(torch.as_tensor(pix[:1]), torch.as_tensor(
        samp[:1]), bounce_idx, rng_seed ^ twf._DIM_SCATTER, sampler)
    mid[0] = 0
    nrm[0] = -rng.unit_vector_from(u[0], u[1]).numpy()[0]
    return mid, d, nrm, front, pix, samp


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
@pytest.mark.parametrize("rng_seed", [7, 0xFFFFFFF0])
def test_scatter_plain_matches_jax(sampler, rng_seed):
    jmats, tmats = _materials()
    bounce_idx = 2
    mid, d, nrm, front, pix, samp = _hits(rng_seed & 0xFF, 4096, sampler,
                                          bounce_idx, rng_seed)
    got = twf.scatter_plain(
        tmats, torch.as_tensor(mid), torch.as_tensor(d),
        torch.as_tensor(nrm), torch.as_tensor(front), torch.as_tensor(pix),
        torch.as_tensor(samp), bounce_idx, rng_seed, sampler)
    ref = jwf.scatter(jmats, jnp.asarray(mid), jnp.asarray(d),
                      jnp.asarray(nrm), jnp.asarray(front), jnp.asarray(pix),
                      jnp.asarray(samp), bounce_idx, rng_seed, sampler)
    new_dir, att, emis, term = (x.numpy() for x in got)
    r_dir, r_att, r_emis, r_term = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(att, r_att)
    np.testing.assert_array_equal(emis, r_emis)
    np.testing.assert_array_equal(term, r_term)
    m = np.clip(mid, 0, 5)
    no_trig = np.isin(m, [2, 3, 4])        # no cos/sin in the direction
    no_trig[0] = True                      # the degenerate row: n itself
    n_unit = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    u = rng.uniform4_plain(torch.as_tensor(pix), torch.as_tensor(samp),
                           bounce_idx, rng_seed ^ twf._DIM_SCATTER, sampler)
    unit = rng.unit_vector_from(u[0], u[1]).numpy()
    spread = np.where(~no_trig & (m != 1),
                      np.linalg.norm(n_unit + unit, axis=-1), 1.0)
    tol = np.where(no_trig, 4.8e-7, 2.4e-7 / spread + 4.8e-7)
    assert (np.abs(new_dir - r_dir).max(-1) <= tol).all()
    # every branch was taken: both faces, TIR and Fresnel reflections,
    # refractions, and the degenerate ROUGH row
    diel = np.isin(m, [3, 4])
    eta = np.where(front, 1 / 1.5, 1.5)
    cos_t = np.minimum(-(d * n_unit).sum(-1), 1.0)
    tir = diel & (eta * np.sqrt(np.maximum(0, 1 - cos_t ** 2)) > 1.0)
    refl = diel & ((new_dir * n_unit).sum(-1) > 0)
    assert tir.sum() > 10 and (refl & ~tir).sum() > 10
    assert (diel & ~refl).sum() > 10
    n0 = normalize(normalize(torch.as_tensor(nrm[:1])))
    np.testing.assert_array_equal(new_dir[:1], n0.numpy())
    assert np.linalg.norm(n_unit[0] + unit[0]) ** 2 < 1e-6


# ---- dispatch ----------------------------------------------------------

def _bsdf_args(n: int) -> tuple:
    """The hit arguments of ``pathtracer.bsdf_step`` for n rays over every
    material type, before the RNG's."""
    r = np.random.default_rng(n)
    d = normalize(torch.as_tensor(r.normal(size=(n, 3)),
                                  dtype=torch.float32))
    return (d, -d, torch.as_tensor(r.normal(size=(n, 3)),
                                   dtype=torch.float32),
            torch.as_tensor(r.random(n) < 0.5),
            torch.as_tensor(r.integers(0, 4, n), dtype=torch.int32),
            torch.full((n, 3), 0.5), torch.full((n,), 1.5), torch.ones(n, 3),
            torch.as_tensor(r.random(n) < 0.9), torch.zeros(n, 3))


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(name)
        return real(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_cpu_calls_reach_the_plain_versions(monkeypatch):
    """uniform4 (both samplers), pcg4d, sobol_owen4, scatter and
    bsdf_step on CPU tensors run their plain versions and return their
    results; no kernel launches and the library is never loaded."""
    before = [k.launches for k in _lib.KERNELS]
    pix, samp = _ids(3, 256), _ids(4, 256, 0, 64)
    calls = {n: _spy(monkeypatch, m, n) for m, n in (
        (rng, "uniform4_plain"), (rng, "pcg4d_plain"),
        (qmc, "sobol_owen4_plain"), (twf, "scatter_plain"))}
    want = rng.uniform4_plain(pix, samp, 1, 9)
    calls["uniform4_plain"].clear()
    calls["pcg4d_plain"].clear()
    got = rng.uniform4(pix, samp, 1, 9)
    assert calls["uniform4_plain"] and all(
        torch.equal(a, b) for a, b in zip(got, want))
    assert rng.pcg4d(pix, samp, 1, 9) and calls["pcg4d_plain"]
    got = rng.uniform4(pix, samp, 1, 9, "sobol")
    assert len(calls["sobol_owen4_plain"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(
        got, qmc.sobol_owen4_plain(pix, samp, 1, 9)))
    qmc.sobol_owen4(pix, samp, 1, 9)
    assert len(calls["sobol_owen4_plain"]) == 3
    _, tmats = _materials()
    mid, d, nrm, front, _, _ = _hits(5, 256, "pcg", 1, 9)
    args = (tmats, torch.as_tensor(mid), torch.as_tensor(d),
            torch.as_tensor(nrm), torch.as_tensor(front), pix, samp, 1, 9)
    got = twf.scatter(*args)
    assert calls["scatter_plain"] == ["scatter_plain"]
    assert all(torch.equal(a, b) for a, b in zip(got,
                                                   twf.scatter_plain(*args)))
    bsdf = _spy(monkeypatch, tpt, "bsdf_step_plain")
    step = _bsdf_args(256) + (pix, samp, 3, 9, "sobol", 2)
    got = tpt.bsdf_step(*step)
    assert bsdf == ["bsdf_step_plain"]
    assert all(torch.equal(a, b) for a, b in zip(
        got, tpt.bsdf_step_plain(*step)))
    assert [k.launches for k in _lib.KERNELS] == before
    assert _lib._lib is None


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers of H, I, J and K never run a plain version: CPU
    tensors raise before any build or launch."""
    pix = _ids(1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        bounce.pcg4d_call(pix, pix, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        bounce.sobol_owen4_call(pix, 3, 0, 0)
    _, tmats = _materials()
    mid, d, nrm, front, _, _ = _hits(2, 64, "pcg", 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        bounce.scatter_call(tmats, torch.as_tensor(mid), torch.as_tensor(d),
                            torch.as_tensor(nrm), torch.as_tensor(front),
                            pix, pix, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        bounce.bsdf_step_call(*_bsdf_args(64), pix, pix, 0, 0)
    assert _lib._lib is None
