"""The port's denoisers and frame step against the JAX package on the CPU:
the a-trous ``denoise`` and ``filter_irradiance`` (scalar and per-pixel
sigma), ``denoise_neural`` with the committed weights and with
``init_params(0)``, and ``models/common.render_frame`` with
``apply_denoiser`` under a JAX ``RendererConfig``; plus the committed
weights copy (byte-equal) and the weights' round trip.

Tolerances, relative (|diff| <= rtol |want|).  One per denoiser serves
both of its comparisons, XLA against PyTorch on the CPU here and the card
against the CPU (tests/test_torch_cuda.py, chip_smoke.py phase 9); each
is about 3x the worst case measured in either:
- a-trous: 8e-6.  Measured 1.07e-6 here (32x24), 2.5e-6 card vs CPU
  (128x96 random inputs; 6.5e-7 on chip_smoke's 1024x1024 frame).
  ``dn ** 32`` and ``exp`` round their own way in each library (a few ulp
  of each weight), and four passes carry the ulps;
- KPCN: 2.4e-5.  Measured 2.06e-6 here (committed weights; 6.5e-7 with
  init_params(0)), 7.7e-6 card vs CPU (256x256 random inputs; 3.4e-6 on
  the 1024x1024 frame).  The dilated convolutions sum in another order in
  XLA, oneDNN and cuDNN, and the softmax passes the logits' error on;
- render_frame: the raw Whitted image and the albedo guide are bit-equal;
  the normal guide to 2e-6 absolute (measured 6.3e-7: the sweep's u/v
  differ from XLA's by ulps, tests/test_torch_sweep.py, and the shading
  normal interpolates them); the denoised image to the denoiser's."""

import dataclasses
import filecmp
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.config import parse_config_dict
from optix_ray_tracer_tpu.io.meshgen import quad, sphere_with_n_triangles
from optix_ray_tracer_tpu.models import common as jcommon
from optix_ray_tracer_tpu.ops import sweep as jsweep
from optix_ray_tracer_tpu.render import denoise as jden
from optix_ray_tracer_tpu.render import neural_denoise as jneural
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.models import common as tcommon
from optix_ray_tracer_tpu_torch.render import denoise as tden
from optix_ray_tracer_tpu_torch.render import neural_denoise as tneural

torch.set_num_threads(1)

W, H = 32, 24
ATROUS_RTOL = 8e-6
KPCN_RTOL = 2.4e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _inputs(seed=0):
    """Noisy radiance over smooth gradients, guides with a sky band (zero
    albedo and normal) across the top rows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.stack([0.3 + 0.4 * (xx / W), 0.2 + 0.5 * (yy / H),
                     0.4 + 0.1 * np.sin(xx / 3.0)], -1)
    color = (base * rng.gamma(4.0, 0.25, (H, W, 3))).astype(np.float32)
    alb = rng.uniform(0.05, 0.9, (H, W, 3)).astype(np.float32)
    nrm = rng.normal(size=(H, W, 3))
    nrm[..., 2] += 2.0
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
           ).astype(np.float32)
    sky = yy < 4
    alb[sky] = 0.0
    nrm[sky] = 0.0
    color[sky] = (0.7, 0.8, 0.9)
    return color, alb, nrm


def _close(got, want, rtol):
    want = np.asarray(want)
    diff = np.abs(np.asarray(got) - want)
    assert (diff <= rtol * np.abs(want)).all(), diff.max()


def test_atrous_matches_jax():
    c, a, n = _inputs()
    want = jden.denoise(jnp.asarray(c), jnp.asarray(a), jnp.asarray(n))
    got = tden.denoise(_t(c), _t(a), _t(n))
    _close(got, want, ATROUS_RTOL)
    assert torch.equal(tden.skip_denoise(_t(c), _t(a), _t(n)), _t(c))


def test_filter_irradiance_sigma_map_matches_jax():
    """The temporal path's per-pixel sigma map (H, W, 1)."""
    c, _, n = _inputs(1)
    sig = np.random.default_rng(2).uniform(0.3, 1.0, (H, W, 1)
                                           ).astype(np.float32)
    want = jden.filter_irradiance(jnp.asarray(c), jnp.asarray(n), 4,
                                  jnp.asarray(sig))
    got = tden.filter_irradiance(_t(c), _t(n), 4, _t(sig))
    _close(got, want, ATROUS_RTOL)


@pytest.mark.parametrize("weights", ["committed", "init0"])
def test_kpcn_matches_jax(weights):
    c, a, n = _inputs(3)
    if weights == "committed":
        jp, tp = jneural.default_params(), tneural.default_params("cpu")
    else:
        p = tneural.init_params(0)
        ref = jneural.init_params(0)
        for k in ref:
            np.testing.assert_array_equal(p[k], ref[k])
        jp = {k: jnp.asarray(v) for k, v in ref.items()}
        tp = convert.kpcn(ref, device="cpu")
    want = jneural.denoise_neural(jnp.asarray(c), jnp.asarray(a),
                                  jnp.asarray(n), jp)
    got = tneural.denoise_neural(_t(c), _t(a), _t(n), tp)
    _close(got, want, KPCN_RTOL)
    # batched apply == per-image apply
    irr = _t(c) / tneural.demod_albedo(_t(a))
    with torch.no_grad():
        one = tneural.apply(tp, irr, _t(a), _t(n))
        two = tneural.apply(tp, torch.stack([irr, irr]),
                            torch.stack([_t(a)] * 2),
                            torch.stack([_t(n)] * 2))
    assert torch.allclose(two[1], one, atol=1e-6, rtol=0)


def test_weights_copy_and_round_trip(tmp_path):
    """The port ships the JAX package's weights byte for byte; save_params
    writes the same HWIO arrays back."""
    jfile = jneural._WEIGHTS_FILE
    assert filecmp.cmp(tneural.WEIGHTS_FILE, jfile, shallow=False)
    model = tneural.load_params(tneural.WEIGHTS_FILE, device="cpu")
    path = str(tmp_path / "w.npz")
    tneural.save_params(model, path)
    with np.load(path) as got, np.load(jfile) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def frame_scene():
    mb = MaterialBuilder()
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.70, 0.60, 0.50))
    v, n = sphere_with_n_triangles(700)
    qv, qn = quad((-4, -4, -1), (4, -4, -1), (4, 4, -1), (-4, 4, -1))
    js = JScene(spheres=JSpheres.empty(),
                triangles=JTriangles.from_arrays(v, n, metal).concat(
                    JTriangles.from_arrays(qv, qn, ground)))
    jm = mb.build()
    jcam = JCamera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    jsi = jsweep.make_sweep_intersector(js)
    port = (convert.scene(convert.state_arrays(js), device="cpu"),
            convert.materials(convert.state_arrays(jm), device="cpu"),
            convert.camera(convert.state_arrays(jcam), device="cpu"),
            convert.sweep_intersector(convert.state_arrays(jsi),
                                      device="cpu"))
    return (js, jm, jcam, jsi), port


@pytest.mark.parametrize("denoiser", ["off", "atrous", "neural"])
def test_render_frame_matches_jax(frame_scene, denoiser):
    """render_frame (Whitted, 32x24, spp 2, depth 3, through the sweep)
    with each denoiser against the JAX render_frame under the same JAX
    RendererConfig: albedo and the raw image bit-equal, normal to 2e-6,
    the denoised image to the denoiser's tolerance; apply_denoiser's
    overrides follow the JAX ones."""
    cfg = dataclasses.replace(parse_config_dict({}), max_depth=3,
                              denoise=denoiser != "off",
                              denoiser="atrous" if denoiser == "off"
                              else denoiser)
    jargs, targs = frame_scene
    want = jcommon.render_frame(cfg, *jargs[:3], W, H, 2, 9, jargs[3])
    got = tcommon.render_frame(cfg, *targs[:3], W, H, 2, 9, targs[3])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.abs(got[2].numpy() - np.asarray(want[2])).max() <= 2e-6
    rtol = {"off": 0.0, "atrous": ATROUS_RTOL,
            "neural": KPCN_RTOL}[denoiser]
    _close(got[0], want[0], rtol)
    assert tcommon.resolve_denoiser(cfg) == jcommon.resolve_denoiser(cfg)
    # the Tab-bypass analog and the denoiser override
    raw = tcommon.render_frame(cfg, *targs[:3], W, H, 2, 9, targs[3],
                               denoise_override=False)[0]
    over = tcommon.apply_denoiser(raw, got[1], got[2], cfg,
                                  denoise_override=True,
                                  denoiser_override="atrous")
    ref = jcommon.apply_denoiser(jnp.asarray(raw.numpy()),
                                 *(jnp.asarray(x.numpy()) for x in got[1:]),
                                 cfg, denoise_override=True,
                                 denoiser_override="atrous")
    _close(over, ref, ATROUS_RTOL)


def test_resolve_denoiser(monkeypatch):
    """"neural" with the committed weights; "atrous" (one warning) when
    they are missing; the ReSTIR integrators raise the JAX package's
    ValueError without an area light (none, or an empty table)."""
    cfg = dataclasses.replace(parse_config_dict({}), denoiser="neural")
    assert tcommon.resolve_denoiser(cfg) == "neural"
    monkeypatch.setattr(tneural, "WEIGHTS_FILE", "/nonexistent/w.npz")
    assert tcommon.resolve_denoiser(cfg) == "atrous"
    assert tneural.default_params("cpu") is None
    for integ in ("restir", "restir-gi"):
        for lights in (None, SimpleNamespace(count=0)):
            with pytest.raises(ValueError, match="needs emissive"):
                tcommon.render_frame(
                    dataclasses.replace(cfg, integrator=integ), None, None,
                    None, 8, 8, 1, 0, None, lights=lights)
