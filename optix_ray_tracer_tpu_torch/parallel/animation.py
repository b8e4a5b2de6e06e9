"""The sharded animation loop behind the CLI's ``--shard`` (port of
``optix_ray_tracer_tpu/parallel/animation.py``).

Every frame's rows are split over a mesh (``parallel/sharding.py``),
the guides with them, so the denoiser runs on the merged frame.  The
default route is the fused loop with a mesh (``models/fused.py``); the
per-frame loop below is the fallback for a host-side per-frame hook
(``update_fn``), debug mode and an ``spp`` that the sample axis does
not divide: the JAX package's eligibility rule.
"""

from __future__ import annotations

from typing import Iterator

from optix_ray_tracer_tpu_torch.models import common
from optix_ray_tracer_tpu_torch.utils import debug
from optix_ray_tracer_tpu_torch.utils.logging import LOG


def render_frames_sharded(data, mode: str, width: int, height: int,
                          spp: int, mesh, max_frames=None,
                          loop: bool = False, quantize: bool = False,
                          fetch_guides: bool = False) -> Iterator[tuple]:
    """Yield (file_index, frame_index, Film or U8Frame), every frame's
    rows sharded over ``mesh``.  ``height`` pads up to a multiple of the
    tile count for the render and crops on output.

    As in the JAX package, the integrator is not part of the route's
    rule: a ReSTIR config reaches the fused loop, which refuses it
    (ValueError), or, on the per-frame fallback, renders Whitted frames;
    this loop says so in the log."""
    from optix_ray_tracer_tpu_torch.models import (
        fused, renderer_mesh, renderer_time,
    )
    from optix_ray_tracer_tpu_torch.parallel.sharding import (
        render_path_sharded, render_sharded,
    )
    from optix_ray_tracer_tpu_torch.render.denoise import denoise
    from optix_ray_tracer_tpu_torch.render.film import Film, U8Frame
    from optix_ray_tracer_tpu_torch.render.neural_denoise import (
        denoise_neural,
    )

    frontend = renderer_mesh if mode == "mesh" else renderer_time
    fused_ok = (data.update_fn is None and not debug.DEBUG_MODE
                and data.file_count
                and (mode == "mesh" or data.library.num_shapes > 0)
                and spp % mesh.shape["sample"] == 0)
    if fused_ok:
        fdfn = (fused.mesh_file_data if mode == "mesh"
                else fused.time_file_data)
        yield from fused.render_frames_fused(
            data, mode, fdfn, width, height, spp, max_frames, loop,
            fetch_guides=fetch_guides, quantize=quantize, mesh=mesh)
        return
    cfg = data.config
    ld = cfg.loop_data
    if cfg.integrator not in ("whitted", "path"):
        LOG.warning("the sharded per-frame loop renders integrator %r as "
                    "whitted (the JAX package's rule)", cfg.integrator)
    n_tile = mesh.shape["tile"]
    hp = -(-height // n_tile) * n_tile        # the padded render height
    dev = data.camera.center.device
    sampler = getattr(cfg, "sampler", "pcg")

    produced = 0
    lights = None
    intersector = None
    while True:
        for fi in range(data.file_count):
            n_frames = common.frame_count_for_file(
                data.durations[fi], ld.fps, ld.render_speed_ratio)
            for k in range(n_frames):
                scene = frontend.frame_scene(data, fi, k, n_frames)
                if produced == 0:
                    lights = common.collect_lights(cfg, scene,
                                                   data.materials)
                intersector = (common.rebuild_or_choose(intersector, scene)
                               if k == 0
                               else common.refit_or_choose(intersector,
                                                           scene))
                seed = cfg.seed + produced
                if cfg.integrator == "path":
                    img, alb, nrm = render_path_sharded(
                        scene, data.materials, lights, data.camera, width,
                        hp, spp, mesh, seed=seed, background=cfg.background,
                        max_depth=cfg.max_depth, intersector=intersector,
                        env=data.env, textures=data.textures,
                        want_guides=True, sampler=sampler)
                else:
                    img, alb, nrm = render_sharded(
                        scene, data.materials, data.camera, width, hp, spp,
                        mesh, seed=seed, background=cfg.background,
                        max_depth=cfg.max_depth, intersector=intersector,
                        env=data.env, want_guides=True, sampler=sampler)
                img, alb, nrm = img[:height], alb[:height], nrm[:height]
                if cfg.denoise and common.resolve_denoiser(cfg) == "neural":
                    img = denoise_neural(img, alb, nrm)
                elif cfg.denoise:
                    img = denoise(img, alb, nrm)
                film = Film.create(width, height, dev).add(img, alb, nrm,
                                                           spp)
                if quantize:
                    film = U8Frame(film.to_uint8(), spp)
                yield fi, k, film
                produced += 1
                if max_frames is not None and produced >= max_frames:
                    return
        if not loop:
            return
