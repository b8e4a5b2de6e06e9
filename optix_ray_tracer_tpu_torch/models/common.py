"""The frame step of the frontends (port of the denoiser tail of
``optix_ray_tracer_tpu/models/common.py``): one frame through the
configured integrator, then the configured denoiser.

The config is read by attribute (``integrator``, ``background``,
``max_depth``, ``sampler``, ``denoise``, ``denoiser``), so any object
with those fields serves, the JAX package's ``RendererConfig`` included.
Only the Whitted wavefront integrator is ported: the path tracer and the
ReSTIR integrators wait for ROADMAP queue 1 items 10-11, and
``choose_intersector`` with the refit/rebuild loop for item 9.
"""

from __future__ import annotations

import logging
import os
import types

from optix_ray_tracer_tpu_torch.render import neural_denoise, wavefront
from optix_ray_tracer_tpu_torch.render.denoise import denoise


def render_frame(config, scene, materials, camera, width: int, height: int,
                 spp: int, seed: int, intersector, env=None, textures=None,
                 lights=None, denoise_override: bool | None = None,
                 denoiser_override: str | None = None,
                 sample_offset: int = 0):
    """One frame through the configured integrator and denoiser.  Returns
    (img, albedo, normal), ``img`` denoised when enabled
    (``denoise_override`` None follows the config)."""
    if config.integrator in ("path", "restir", "restir-gi"):
        raise NotImplementedError(
            f"integrator {config.integrator!r} is not ported yet (ROADMAP "
            "queue 1 items 10-11)")
    sampler = getattr(config, "sampler", "pcg")
    if (env is not None or textures is not None or sampler != "pcg"
            or sample_offset):
        raise NotImplementedError(
            "environment maps, textures, the Sobol sampler and "
            "sample_offset are not ported yet (ROADMAP queue 1 items 10-11)")
    img, alb, nrm = wavefront.render(
        scene, materials, camera, width, height, spp=spp, seed=seed,
        background=config.background, max_depth=config.max_depth,
        intersector=intersector)
    img = apply_denoiser(img, alb, nrm, config, denoise_override,
                         denoiser_override)
    return img, alb, nrm


def apply_denoiser(img, alb, nrm, config, denoise_override=None,
                   denoiser_override=None):
    """The denoiser tail of :func:`render_frame`."""
    do_denoise = (config.denoise if denoise_override is None
                  else denoise_override)
    if denoiser_override is not None:
        denoiser = resolve_denoiser(
            types.SimpleNamespace(denoiser=denoiser_override))
    else:
        denoiser = resolve_denoiser(config)
    if do_denoise and denoiser == "neural":
        img = neural_denoise.denoise_neural(img, alb, nrm)
    elif do_denoise:
        img = denoise(img, alb, nrm)
    return img


_warned_no_weights = False


def resolve_denoiser(config) -> str:
    """``config.denoiser``, degraded to "atrous" (with one warning per
    process) when the pretrained neural weights are absent."""
    if getattr(config, "denoiser", "atrous") != "neural":
        return "atrous"
    if not os.path.exists(neural_denoise.WEIGHTS_FILE):
        global _warned_no_weights
        if not _warned_no_weights:
            logging.getLogger("optix_ray_tracer_tpu_torch").warning(
                "denoise='neural' requested but no pretrained weights at"
                " %s; falling back to the a-trous filter",
                neural_denoise.WEIGHTS_FILE)
            _warned_no_weights = True
        return "atrous"
    return "neural"
