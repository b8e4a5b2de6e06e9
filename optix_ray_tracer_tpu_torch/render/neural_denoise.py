"""Learned denoiser, inference (port of
``optix_ray_tracer_tpu/render/neural_denoise.py``): the AI-denoiser
counterpart of the reference (``optixDenoiserInvoke`` with albedo and
normal guides, ``src/Global/RendererImpl.cu:584-669``).

A small kernel-predicting CNN (KPCN, Bako et al. 2017): features are
log-compressed demodulated irradiance, albedo and normal (9 channels);
four dilated 3x3 convolutions (dilations 1, 2, 4, 8; 48 channels) and a
3x3 head predict per-pixel weights over 75 taps (three 5x5 kernels at
dilations 1, 3, 9) under one softmax.  The output is a convex combination
of in-bounds irradiance taps, remodulated by albedo.

The weights are the JAX package's: ``denoiser_data/weights.npz`` here is
a byte-identical copy of its committed file, HWIO arrays that
:meth:`KPCN.from_arrays` turns into the module's OIHW state.  Public
functions keep the JAX package's NHWC ``(H, W, 3)`` layout and permute
inside.  The convolutions are cuDNN's on the card (TF32 off, see the
package ``__init__``), oneDNN's on the CPU.  Training
(``render/train_denoiser.py``) waits for a later slice.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from optix_ray_tracer_tpu_torch.utils.tensors import resolve_device

_HIDDEN = 48
_DILATIONS = (1, 2, 4, 8)          # feature body
_TAP_DILATIONS = (1, 3, 9)         # predicted-kernel scales
_TAPS_PER_SCALE = 25               # 5x5
_N_TAPS = _TAPS_PER_SCALE * len(_TAP_DILATIONS)
WEIGHTS_FILE = os.path.join(os.path.dirname(__file__), "denoiser_data",
                            "weights.npz")


def init_params(seed: int = 0) -> dict:
    """He-initialised parameters as HWIO numpy arrays, the JAX package's
    ``init_params`` bit for bit."""
    rng = np.random.default_rng(seed)
    sizes = [9] + [_HIDDEN] * len(_DILATIONS)
    params = {}
    for i, (cin, cout) in enumerate(zip(sizes[:-1], sizes[1:])):
        std = float(np.sqrt(2.0 / (9 * cin)))
        params[f"w{i}"] = rng.normal(0, std, (3, 3, cin, cout)) \
            .astype(np.float32)
        params[f"b{i}"] = np.zeros(cout, np.float32)
    std = float(np.sqrt(2.0 / (9 * _HIDDEN)))
    params["w_out"] = rng.normal(0, std, (3, 3, _HIDDEN, _N_TAPS)) \
        .astype(np.float32)
    # bias so the initial kernel starts near the identity tap
    b = np.zeros(_N_TAPS, np.float32)
    b[12] = 2.0
    params["b_out"] = b
    return params


class KPCN(nn.Module):
    """The feature body and the 75-tap head; ``forward`` maps (N, 9, H, W)
    features to (N, 75, H, W) tap logits.  ``padding = dilation`` is
    XLA's "SAME" for a 3x3 kernel."""

    def __init__(self, device=None):
        super().__init__()
        device = resolve_device(device)
        sizes = [9] + [_HIDDEN] * len(_DILATIONS)
        self.body = nn.ModuleList(
            nn.utils.skip_init(nn.Conv2d, cin, cout, 3, padding=d,
                               dilation=d, device=device)
            for cin, cout, d in zip(sizes[:-1], sizes[1:], _DILATIONS))
        self.head = nn.utils.skip_init(nn.Conv2d, _HIDDEN, _N_TAPS, 3,
                                       padding=1, device=device)

    def forward(self, x):
        for conv in self.body:
            x = torch.relu(conv(x))
        return self.head(x)

    def _convs(self):
        return [(f"w{i}", f"b{i}", c) for i, c in enumerate(self.body)] + [
            ("w_out", "b_out", self.head)]

    @staticmethod
    def from_arrays(params: dict, device=None) -> "KPCN":
        """The module from HWIO weight arrays (``init_params``, the npz
        file, or the JAX package's parameters as numpy)."""
        dev = resolve_device(device)
        model = KPCN(device=dev)
        with torch.no_grad():
            for wk, bk, conv in model._convs():
                w = torch.as_tensor(np.asarray(params[wk], np.float32))
                conv.weight.copy_(w.permute(3, 2, 0, 1))
                conv.bias.copy_(torch.as_tensor(
                    np.asarray(params[bk], np.float32)))
        return model.eval()

    def arrays(self) -> dict:
        """The HWIO numpy arrays of the JAX package's format."""
        out = {}
        for wk, bk, conv in self._convs():
            out[wk] = conv.weight.detach().permute(2, 3, 1, 0).cpu().numpy()
            out[bk] = conv.bias.detach().cpu().numpy()
        return out


def _tap_offsets():
    """The 75 (dy, dx) a-trous-footprint offsets, scale-major."""
    offs = []
    for d in _TAP_DILATIONS:
        for dy in (-2 * d, -d, 0, d, 2 * d):
            for dx in (-2 * d, -d, 0, d, 2 * d):
                offs.append((dy, dx))
    return offs


def apply(model: KPCN, irradiance, albedo, normal):
    """Filter demodulated irradiance.  All inputs (N, H, W, 3) or
    (H, W, 3); returns the same rank."""
    single = irradiance.dim() == 3
    if single:
        irradiance, albedo, normal = (x[None] for x in (irradiance, albedo,
                                                         normal))
    x = torch.cat([torch.log1p(torch.clamp(irradiance, min=0.0)), albedo,
                   normal], dim=-1)
    logits = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    w = torch.softmax(logits, dim=-1)
    # tap by tap: 75 roll-multiply-adds, never an (N, H, W, 75, 3) stack.
    # Taps that would wrap around the image (roll is cyclic) are masked
    # out and the kernel renormalised over the surviving taps
    H, W = irradiance.shape[1:3]
    dev = irradiance.device
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    out = torch.zeros_like(irradiance)
    wsum = torch.zeros(irradiance.shape[:3] + (1,), dtype=irradiance.dtype,
                       device=dev)
    for i, (dy, dx) in enumerate(_tap_offsets()):
        valid = ((yy + dy >= 0) & (yy + dy < H)
                 & (xx + dx >= 0) & (xx + dx < W))
        wv = w[..., i:i + 1] * valid[None, ..., None]
        out = out + torch.roll(irradiance, (-dy, -dx), dims=(1, 2)) * wv
        wsum = wsum + wv
    out = out / torch.clamp(wsum, min=1e-12)   # the center tap is valid
    return out[0] if single else out


def save_params(params, path: str) -> None:
    """Write a KPCN (or HWIO arrays) in the JAX package's npz format."""
    arrays = params.arrays() if isinstance(params, KPCN) else params
    np.savez_compressed(path, **{k: np.asarray(v)
                                 for k, v in arrays.items()})


def load_params(path: str, device=None) -> KPCN:
    with np.load(path) as z:
        return KPCN.from_arrays({k: z[k] for k in z.files}, device)


_DEFAULT: dict = {}


def default_params(device=None) -> KPCN | None:
    """The committed pretrained weights on ``device``, or None when the
    file is missing; cached per (path, mtime, device)."""
    if not os.path.exists(WEIGHTS_FILE):
        return None
    dev = resolve_device(device)
    key = (WEIGHTS_FILE, os.path.getmtime(WEIGHTS_FILE), str(dev))
    if key not in _DEFAULT:
        _DEFAULT[key] = load_params(WEIGHTS_FILE, dev)
    return _DEFAULT[key]


def demod_albedo(albedo):
    """Albedo used for irradiance demodulation: near-black albedo (miss
    and sky pixels) counts as 1, elsewhere at least 1e-3."""
    black = torch.all(albedo < 1e-3, dim=-1, keepdim=True)
    return torch.where(black, torch.ones_like(albedo),
                       torch.clamp(albedo, min=1e-3))


def denoise_neural(color, albedo, normal, params=None):
    """Counterpart of ``render/denoise.denoise`` with the learned filter:
    color, albedo, normal (H, W, 3) linear; returns the filtered linear
    radiance.  ``params``: a KPCN, HWIO arrays, or None for the committed
    weights on the inputs' device."""
    if params is None:
        params = default_params(color.device)
        if params is None:
            raise FileNotFoundError(
                f"no pretrained denoiser weights at {WEIGHTS_FILE}")
    elif not isinstance(params, KPCN):
        params = KPCN.from_arrays(params, color.device)
    safe_albedo = demod_albedo(albedo)
    with torch.no_grad():
        out = apply(params, color / safe_albedo, albedo, normal)
    return out * safe_albedo
