"""Adaptive (variance-guided) progressive sampling (port of
``optix_ray_tracer_tpu/render/adaptive.py``).

Each progressive batch goes to the pixels with the highest estimated
error instead of to every pixel:

* per-pixel running moments (radiance sum, luminance sum of squares,
  sample count) give the variance of each pixel's mean;
* a batch ranks pixels by ``sigma_p / n_p`` (3x3-smoothed, since a
  few-sample variance is itself noisy) and traces the top K only;
* per-PIXEL sample counters key the counter-based RNG streams, so a pixel
  draws exactly the (pixel, sample) stream prefix it would draw under
  uniform rendering, and Sobol sequences stay low-discrepancy per pixel.

The per-pixel mean over any fixed count is unbiased; the stopping bias of
value-dependent counts is bounded by the uniform warm-up and the
anti-starvation floor (every pixel keeps at least half the average
count).  The selection is a stable argsort, as ``jnp.argsort``: after the
warm-up most keys tie (+inf, 1e32), and the tie order picks the pixels.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.render import pathtracer, wavefront
from optix_ray_tracer_tpu_torch.utils import rng
from optix_ray_tracer_tpu_torch.utils.color import (
    color_to_uint8, luminance_fma, write_png, write_ppm,
)
from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)

_DIM_LENS = 0x68E31DA4  # the lens-sample salt of render/pathtracer.py


@dataclasses.dataclass(frozen=True)
class AdaptiveFilm(TensorDataclass):
    """Per-pixel running moments, flat (npix, ...) with pixel id ``iy *
    width + ix`` (row 0 at the top).  ``count`` is per pixel, unlike
    ``film.Film``'s global spp: adaptive batches leave pixels at
    different sample depths."""
    accum: torch.Tensor          # (npix, 3) float32 radiance sum
    sumsq: torch.Tensor          # (npix,) float32 luminance^2 sum
    count: torch.Tensor          # (npix,) int32 samples per pixel
    albedo_accum: torch.Tensor   # (npix, 3)
    normal_accum: torch.Tensor   # (npix, 3)
    width: int = 0
    height: int = 0

    @staticmethod
    def create(width: int, height: int, device=None) -> "AdaptiveFilm":
        dev = resolve_device(device)
        npix = width * height
        z3 = torch.zeros((npix, 3), device=dev)
        return AdaptiveFilm(
            accum=z3, sumsq=torch.zeros(npix, device=dev),
            count=torch.zeros(npix, dtype=torch.int32, device=dev),
            albedo_accum=z3, normal_accum=z3, width=width, height=height)

    @property
    def total_samples(self) -> int:
        return int(self.count.to(torch.int64).sum())

    def _inv(self):
        return 1.0 / torch.clamp(self.count.to(torch.float32), min=1.0)

    def mean(self):
        return (self.accum * self._inv()[:, None]).reshape(
            self.height, self.width, 3)

    def guide_means(self):
        inv = self._inv()[:, None]
        shp = (self.height, self.width, 3)
        return ((self.albedo_accum * inv).reshape(shp),
                (self.normal_accum * inv).reshape(shp))

    def to_uint8(self) -> np.ndarray:
        return color_to_uint8(self.mean()).cpu().numpy()

    def save(self, path: str) -> None:
        img = self.to_uint8()
        if path.endswith(".ppm"):
            write_ppm(path, img)
        else:
            write_png(path, img)

    # ---- checkpoint / resume: the JAX package's npz keys --------------

    def checkpoint(self, path: str, meta: dict | None = None) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path, accum=self.accum.cpu().numpy(),
                 sumsq=self.sumsq.cpu().numpy(),
                 count=self.count.cpu().numpy(),
                 albedo=self.albedo_accum.cpu().numpy(),
                 normal=self.normal_accum.cpu().numpy(),
                 width=self.width, height=self.height)
        if meta is not None:
            with open(path + ".json", "w") as f:
                json.dump(dict(meta, adaptive=True), f)

    @staticmethod
    def restore(path: str, device=None) -> "AdaptiveFilm":
        dev = resolve_device(device)
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            def t(k):
                return torch.as_tensor(z[k], device=dev)
            return AdaptiveFilm(
                accum=t("accum"), sumsq=t("sumsq"),
                count=t("count").to(torch.int32),
                albedo_accum=t("albedo"), normal_accum=t("normal"),
                width=int(z["width"]), height=int(z["height"]))


def error_map(film: AdaptiveFilm, relative: bool = False):
    """Per-pixel priority, smoothed 3x3; unsampled pixels rank first
    (+inf), pixels under half the mean count next (1e32).

    The default ranks by ``sigma_p / n_p``: a sample at pixel p shrinks its
    mean's variance by about sigma_p^2 / n_p^2, so this greedy order buys
    the most RMSE per ray.  ``relative=True`` divides by the mean
    luminance (perceptual weighting, favouring dark regions)."""
    n = torch.clamp(film.count.to(torch.float32), min=1.0)
    lum_mean = luminance_fma(film.accum) / n
    # the unbiased variance (n - 1): the /n estimator is 0 at n = 1 and
    # froze lucky-first-sample pixels at a wrong mean.  sumsq - (n * mean)
    # * mean is rounded once, as XLA's CPU backend fuses it, so that the
    # keys are the JAX package's bit for bit
    sq = (film.sumsq.double()
          - (n * lum_mean).double() * lum_mean.double()).float()
    var = torch.clamp(sq, min=0.0) / torch.clamp(n - 1.0, min=1.0)
    # a correctly rounded sqrt (PyTorch's vectorised float32 sqrt on the
    # CPU is an ulp off on ~0.7% of inputs; numpy's and XLA's are not)
    sigma = torch.sqrt(var.double()).float()
    if relative:
        # (a / b) / c as XLA rewrites it, a / (b * c)
        err = sigma / (n * (torch.abs(lum_mean) + 0.05))
    else:
        err = sigma / n
    err = torch.nan_to_num(err, nan=0.0, posinf=1e30)
    # 3x3 box smooth with edge padding, the nine planes summed in the JAX
    # package's order (so that the keys are bit-equal)
    h, w = film.height, film.width
    p = torch.nn.functional.pad(err.reshape(1, 1, h, w), (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    e = sum(p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
    err = (e * (1.0 / 9.0)).reshape(-1)
    # anti-starvation floor: a pixel whose sigma is underestimated must
    # still be revisited
    count_f = film.count.to(torch.float32)
    err = torch.where(count_f < 0.5 * count_f.mean(),
                      torch.tensor(1e32, device=err.device), err)
    return torch.where(film.count == 0,
                       torch.tensor(float("inf"), device=err.device), err)


def select_pixels(film: AdaptiveFilm, k: int, relative: bool = False):
    """The ``k`` pixel ids of highest error, ties in id order (int64)."""
    return torch.argsort(-error_map(film, relative), stable=True)[:k]


def adaptive_batch(scene, materials, lights, camera, film: AdaptiveFilm,
                   k: int, seed: int = 0, background=(0.0, 0.0, 0.0),
                   max_depth: int = 8, intersector=None, env=None,
                   textures=None, jitter: bool = True, sampler: str = "pcg",
                   integrator: str = "path",
                   relative: bool = False) -> AdaptiveFilm:
    """Trace one sample for each of the ``k`` highest-error pixels and
    accumulate it; ``k = npix`` is a uniform 1-spp pass (the warm-up).
    ``integrator``: "path" (NEE + MIS, needs ``lights``) or "whitted"."""
    npix = film.width * film.height
    if not 0 < k <= npix:
        raise ValueError(f"k={k} out of range (npix={npix})")
    ids = select_pixels(film, k, relative)
    samp = film.count[ids].to(torch.int64)   # per-pixel sample -> stream
    jit_uv = lens = None
    if jitter:
        u1, u2 = rng.stratified_jitter(ids, samp, seed, sampler)
        jit_uv = torch.stack([u1, u2], -1)
    if camera.aperture > 0.0:
        lens = rng.random_in_unit_disk(ids, samp, -2, seed ^ _DIM_LENS,
                                       sampler)
    o, d = camera.generate_rays_for_pixels(ids, film.width, film.height,
                                           jit_uv, lens)
    if integrator == "path":
        radiance, alb, nrm = pathtracer.trace_path(
            scene, materials, lights, o, d, ids, samp, seed, background,
            max_depth, intersector, env, textures, sampler=sampler)[:3]
    else:
        radiance, alb, nrm = wavefront.trace(
            scene, materials, o, d, ids, samp, seed, background, max_depth,
            intersector, env, sampler=sampler)[:3]
    lum = luminance_fma(radiance)
    # ids are unique: the scatter-add is deterministic
    return AdaptiveFilm(
        accum=film.accum.index_add(0, ids, radiance),
        sumsq=film.sumsq.index_add(0, ids, lum * lum),
        count=film.count.index_add(0, ids,
                                   torch.ones_like(ids, dtype=torch.int32)),
        albedo_accum=film.albedo_accum.index_add(0, ids, alb),
        normal_accum=film.normal_accum.index_add(0, ids, nrm),
        width=film.width, height=film.height)


def render_adaptive(scene, materials, lights, camera, width: int,
                    height: int, total_spp: int, seed: int = 0,
                    background=(0.0, 0.0, 0.0), max_depth: int = 8,
                    intersector=None, env=None, textures=None,
                    warmup_spp: int = 4, batch_fraction: float = 0.25,
                    jitter: bool = True, sampler: str = "pcg",
                    integrator: str = "path", relative: bool = False,
                    film: AdaptiveFilm | None = None) -> AdaptiveFilm:
    """Render with ``total_spp * npix`` samples in all: ``warmup_spp``
    uniform passes seed the variance map, the rest goes to the
    highest-error pixels in batches of ``batch_fraction * npix`` rays (the
    last batch shrinks to the budget).  Returns the film, on the camera's
    device."""
    npix = width * height
    if film is None:
        film = AdaptiveFilm.create(width, height, camera.center.device)
    budget = total_spp * npix
    k_batch = max(1, int(npix * batch_fraction))
    kw = dict(seed=seed, background=background, max_depth=max_depth,
              intersector=intersector, env=env, textures=textures,
              jitter=jitter, sampler=sampler, integrator=integrator,
              relative=relative)
    while film.total_samples < budget:
        done = film.total_samples
        k = npix if done < warmup_spp * npix else min(k_batch,
                                                        budget - done)
        film = adaptive_batch(scene, materials, lights, camera, film, k=k,
                              **kw)
    return film
