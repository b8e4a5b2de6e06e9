"""Command-line entry point (port of the headless path of
``optix_ray_tracer_tpu/__main__.py``; the reference's ``main()``,
``src/Global/Main.cu``).

Usage:
    python -m optix_ray_tracer_tpu_torch --config path/to/config.json \
        [--frames N] [--output DIR] [--spp N] [--width W --height H] \
        [--loop] [--aov] [--no-denoise] [--verbose] [--cpu] [--shard] \
        [--viewer [--port P]] [--progressive SPP [--checkpoint PATH]
        [--adaptive]]

Parse the config; ``"cache": true`` in Mesh mode bakes the mesh cache and
exits; otherwise commit the Mesh or Time scene to the card (``--cpu``:
the CPU) and either run the render loop, writing one PNG per frame;
serve the interactive viewer (``--viewer``, an MJPEG stream on
``--port``); or accumulate SPP samples on frame 0 with checkpoint and
resume (``--progressive``, variance-guided with ``--adaptive``).
``--shard`` splits every frame's rows over all visible CUDA devices
(``parallel/animation.py``; with ``--cpu``, one CPU shard); ``--aov`` is
ignored with it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="optix_ray_tracer_tpu_torch")
    ap.add_argument("--config", required=True,
                    help="config.json (reference-compatible schema)")
    ap.add_argument("--frames", type=int, default=None,
                    help="max frames to render (default: one series pass)")
    ap.add_argument("--output", default=None, help="output directory")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--loop", action="store_true",
                    help="cycle the animation like the interactive renderer")
    ap.add_argument("--viewer", action="store_true",
                    help="serve an interactive MJPEG viewer (SDL-window "
                         "analog)")
    ap.add_argument("--port", type=int, default=8425, help="viewer port")
    ap.add_argument("--progressive", type=int, default=None, metavar="SPP",
                    help="progressively accumulate SPP on frame 0 with "
                         "checkpoint/resume")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint path for --progressive (resumes if it "
                         "exists)")
    ap.add_argument("--adaptive", action="store_true",
                    help="with --progressive: variance-guided sample "
                         "allocation (each batch traces only the "
                         "highest-error quarter of the pixels after a "
                         "uniform warmup)")
    ap.add_argument("--shard", action="store_true",
                    help="split every animation frame's rows over all "
                         "visible CUDA devices (the multi-device render "
                         "loop)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the CUDA device)")
    ap.add_argument("--aov", action="store_true",
                    help="also write albedo/normal guide AOV images next "
                         "to each output frame (<name>_albedo.png / "
                         "<name>_normal.png)")
    ap.add_argument("--no-denoise", action="store_true",
                    help="bypass the per-frame denoiser")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from optix_ray_tracer_tpu_torch.io.config import ConfigError, load_config
    from optix_ray_tracer_tpu_torch.utils.logging import LOG, configure

    configure(verbose=args.verbose)
    try:
        config = load_config(args.config)
    except ConfigError as e:
        LOG.error("config error: %s", e)
        return 2
    if args.no_denoise:
        config.denoise = False
    if config.debug_mode:
        from optix_ray_tracer_tpu_torch.utils.debug import enable_debug_mode
        enable_debug_mode()

    if config.mesh and config.cache:
        # "cache": true bakes and exits (Main.cu:23-25)
        from optix_ray_tracer_tpu_torch.models import renderer_mesh
        meta = renderer_mesh.write_cache_files(config)
        LOG.info("cache bake complete: %s", meta)
        return 0

    out_dir = args.output or config.resolve(config.output_dir)
    os.makedirs(out_dir, exist_ok=True)
    if config.mesh:
        from optix_ray_tracer_tpu_torch.models import renderer_mesh as frontend
    else:
        from optix_ray_tracer_tpu_torch.models import renderer_time as frontend

    import torch
    if not args.cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to render on the "
                               "CPU")
    t0 = time.perf_counter()
    data = frontend.commit(config, device="cpu" if args.cpu else None)
    LOG.info("scene committed in %.2fs", time.perf_counter() - t0)

    if args.viewer:
        return _run_viewer(frontend, data, config, args)
    if args.progressive:
        return _run_progressive(frontend, data, config, args, out_dir)

    # quantize: frames leave the device as sRGB uint8 (4 B/pixel, the
    # reference's float4 -> uchar4 conversion, RendererImpl.cu:672-678);
    # --aov needs the guide channels on the host, so it takes float
    # Films with the guides fetched instead
    aov = args.aov
    if args.shard and aov:
        LOG.warning("--aov is not supported with --shard; ignoring")
        aov = False
    if args.shard:
        from optix_ray_tracer_tpu_torch.parallel.animation import (
            render_frames_sharded,
        )
        from optix_ray_tracer_tpu_torch.parallel.sharding import make_mesh

        mesh = make_mesh(tile=1, devices=[data.camera.center.device]) \
            if args.cpu else make_mesh(tile=torch.cuda.device_count())
        LOG.info("sharding frames over %d device(s)", mesh.shape["tile"])
        ld = config.loop_data
        frames = render_frames_sharded(
            data, "mesh" if config.mesh else "time",
            args.width or ld.window_width, args.height or ld.window_height,
            args.spp or config.spp, mesh, max_frames=args.frames,
            loop=args.loop, quantize=True)
    else:
        frames = frontend.render_frames(
            data, width=args.width, height=args.height, spp=args.spp,
            max_frames=args.frames, loop=args.loop, quantize=not aov,
            fetch_guides=aov)
    n = 0
    for fi, k, film in frames:
        stem = f"frame_{n:06d}"
        path = os.path.join(out_dir, stem + ".png")
        film.save(path)
        if aov:
            film.save_aovs(os.path.join(out_dir, stem))
        LOG.info("file %d frame %d -> %s (spp=%d)", fi, k, path,
                 int(film.spp))
        n += 1
    LOG.info("render finished: %d frames in %.2fs", n,
             time.perf_counter() - t0)
    return 0


def _run_viewer(frontend, data, config, args) -> int:
    """Interactive mode: the fly camera, animation stepping and the
    denoiser toggle (the SDL window loop, ``SDL_GraphicsWindow.cu:79-214``)
    behind ``render/viewer.ViewerServer``.

    Whitted and path frames go through the fused chunk: refit, render,
    denoise and sRGB quantisation of K look-ahead frames per call while
    the camera is idle, one under input, and with a still camera a
    progressive mean of raw samples.  ReSTIR keeps its reservoirs across
    viewer frames (temporal reuse through the previous camera), so it
    renders per frame."""
    import numpy as np
    import torch

    from optix_ray_tracer_tpu_torch.models import common, fused
    from optix_ray_tracer_tpu_torch.ops.march import MarchIntersector
    from optix_ray_tracer_tpu_torch.render import restir as restir_mod
    from optix_ray_tracer_tpu_torch.render import temporal as tmod
    from optix_ray_tracer_tpu_torch.render.viewer import (
        ViewerServer, encoder,
    )
    from optix_ray_tracer_tpu_torch.utils import debug
    from optix_ray_tracer_tpu_torch.utils.color import color_to_uint8
    from optix_ray_tracer_tpu_torch.utils.logging import LOG

    ld = config.loop_data
    width = args.width or min(ld.window_width, 400)
    height = args.height or min(ld.window_height, 300)
    dev = data.camera.center.device
    restir_on = config.integrator.startswith("restir")

    # animation schedule: (file, frame, frame count) per viewer frame
    schedule = []
    for fi in range(data.file_count):
        n_frames = common.frame_count_for_file(
            data.durations[fi], ld.fps, ld.render_speed_ratio)
        schedule.extend((fi, k, n_frames) for k in range(n_frames))
    state = {"step": 0, "intersector": None, "key": None, "lights": None,
             "fd": None, "rstate": None, "prev_camera": None, "vframe": 0,
             "tstate": None}
    restir_render = (restir_mod.render_restir_gi
                     if config.integrator == "restir-gi"
                     else restir_mod.render_restir)
    gi_kw = ({"max_depth": config.max_depth}
             if config.integrator == "restir-gi" else {})

    def render_fn(camera, denoise_on=True, animate=False,
                  filter_name=None):
        fi, k, n_frames = schedule[state["step"] % len(schedule)]
        if animate:
            state["step"] += 1
        scene = frontend.frame_scene(data, fi, k, n_frames)
        if state["key"] != fi:
            state["intersector"] = common.choose_intersector(scene)
            state["key"] = fi
        else:
            state["intersector"] = common.refit_or_choose(
                state["intersector"], scene)
        if state["lights"] is None:
            state["lights"] = common.collect_lights(config, scene,
                                                    data.materials)
        if restir_on:
            if state["rstate"] is None:
                state["rstate"] = restir_mod.empty_reservoir_state(
                    width, height, dev)
            img, alb, nrm, state["rstate"] = restir_render(
                scene, data.materials, state["lights"], camera, width,
                height, seed=config.seed, frame=state["vframe"],
                state=state["rstate"],
                prev_camera=state["prev_camera"] or camera,
                intersector=state["intersector"],
                background=config.background, env=data.env,
                textures=data.textures,
                sampler=getattr(config, "sampler", "pcg"), **gi_kw)
            state["prev_camera"] = camera
            state["vframe"] += 1
            img = common.apply_denoiser(
                img, alb, nrm, config,
                denoise_override=denoise_on and config.denoise,
                denoiser_override=filter_name)
        else:
            img, _, _ = common.render_frame(
                config, scene, data.materials, camera, width, height,
                spp=args.spp or 1, seed=config.seed,
                intersector=state["intersector"], env=data.env,
                textures=data.textures, lights=state["lights"],
                denoise_override=denoise_on and config.denoise,
                denoiser_override=filter_name)
        return color_to_uint8(img)

    render_chunk_fn = None
    if (data.file_count and not debug.DEBUG_MODE and data.update_fn is None
            and schedule and not restir_on):
        mode = "mesh" if config.mesh else "time"
        file_data_fn = (fused.mesh_file_data if config.mesh
                        else fused.time_file_data)

        def resolve_filter(name):
            """The viewer's /filter choice; None: the config's."""
            if name is None:
                return common.resolve_denoiser(config)
            import types
            return common.resolve_denoiser(
                types.SimpleNamespace(denoiser=name))

        def chunk_call(camera, ks, seeds, denoise_on, quantize,
                       temporal=False, filter_name=None):
            out = fused.fused_chunk(
                state["fd"], ks, seeds, state["intersector"],
                data.materials, camera, data.extra_spheres,
                data.extra_triangles, data.env, data.textures,
                state["lights"], config.background,
                state["tstate"] if temporal else None, mode=mode,
                width=width, height=height, spp=args.spp or 1,
                integrator=config.integrator,
                do_denoise=bool(denoise_on and config.denoise),
                denoiser=resolve_filter(filter_name),
                sampler=getattr(config, "sampler", "pcg"),
                max_depth=config.max_depth,
                use_march=isinstance(state["intersector"],
                                     MarchIntersector),
                has_extras=bool(data.extra_triangles.count),
                euler_path=getattr(data, "reference_euler_path", False),
                quantize=quantize, want_guides=False, temporal=temporal)
            if temporal:
                out, state["tstate"] = out
            return out[0]

        still = {"cam": None, "acc": None, "spp": 0}

        def render_chunk_fn(camera, chunk, denoise_on, animate,
                            filter_name=None):
            fi, k, n_frames = schedule[state["step"] % len(schedule)]
            if state["key"] != fi or state["fd"] is None:
                scene0 = frontend.frame_scene(data, fi, 0, n_frames)
                state["intersector"] = common.rebuild_or_choose(
                    state["intersector"], scene0)
                state["key"] = fi
                state["fd"] = file_data_fn(data, fi, n_frames)
                if state["lights"] is None:
                    state["lights"] = common.collect_lights(
                        config, scene0, data.materials)
            cam_key = tuple(camera.center.tolist() + camera.w.tolist())
            if not animate and still["cam"] == cam_key:
                # idle and still: each call adds `chunk` raw samples to a
                # running mean (the stream shows it converge, undenoised)
                seeds = config.seed + still["spp"] + np.arange(chunk)
                imgs = chunk_call(camera, [k] * chunk, seeds.tolist(),
                                  False, quantize=False)
                total = imgs.sum(0)
                still["acc"] = (total if still["acc"] is None
                                else still["acc"] + total)
                still["spp"] += chunk
                return color_to_uint8(still["acc"] / still["spp"])[None]
            moved = still["cam"] != cam_key
            still.update(cam=cam_key, acc=None, spp=0)
            # temporal reprojection holds only while the camera is still
            # (history is projected through the current camera)
            use_temporal = (bool(getattr(config, "temporal", True))
                            and config.integrator != "path"
                            and not moved)
            if moved or state["tstate"] is None:
                state["tstate"] = tmod.empty_state(width, height, dev)
            if animate:
                # look-ahead stays inside this file; the next call moves on
                ks = [(k + j) % n_frames for j in range(chunk)]
                state["step"] += chunk
                seeds = [config.seed + kk for kk in ks]
            else:
                ks = [k] * chunk
                seeds = [config.seed + j for j in range(chunk)]
            return chunk_call(camera, ks, seeds, denoise_on, quantize=True,
                              temporal=use_temporal,
                              filter_name=filter_name)

    LOG.info("interactive viewer: %dx%d%s, %s stream parts", width,
             height, " (chunked dispatch)" if render_chunk_fn else "",
             encoder())
    viewer = ViewerServer(
        data.camera, render_fn, port=args.port,
        move_speed=(ld.camera_speed_stride * ld.camera_initial_speed_ratio
                    * 25),
        mouse_sensitivity=ld.mouse_sensitivity,
        pitch_limit_degree=ld.camera_pitch_limit_degree,
        render_chunk_fn=render_chunk_fn)
    viewer.serve(blocking=True)
    if viewer.error is not None:
        LOG.error("viewer stopped on an error: %r", viewer.error)
        return 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    LOG.info("viewer stopped after %d frames; kernel launches: %s",
             viewer.frames_published,
             " ".join(f"{k.name}={k.launches}" for k in _lib.KERNELS))
    return 0


def _run_progressive(frontend, data, config, args, out_dir) -> int:
    """Progressive accumulation on frame 0 with checkpoint and resume:
    batches of at most 16 samples, each continuing the global sample
    counter (``sample_offset``), so a resumed run is bit-equal to a
    straight one."""
    from optix_ray_tracer_tpu_torch.models import common
    from optix_ray_tracer_tpu_torch.render.denoise import denoise
    from optix_ray_tracer_tpu_torch.render.film import Film
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )
    from optix_ray_tracer_tpu_torch.utils.logging import LOG

    ld = config.loop_data
    width = args.width or ld.window_width
    height = args.height or ld.window_height
    target_spp = args.progressive
    ckpt = args.checkpoint or os.path.join(out_dir, "progressive.npz")
    dev = data.camera.center.device

    scene = frontend.frame_scene(data, 0, 0, 1)
    intersector = common.choose_intersector(scene)
    lights = common.collect_lights(config, scene, data.materials)
    if args.adaptive:
        return _run_progressive_adaptive(
            config, scene, data, intersector, lights, width, height,
            target_spp, ckpt, out_dir, aov=args.aov)

    if os.path.exists(ckpt):
        film = Film.restore(ckpt, dev)
        LOG.info("resumed checkpoint %s at %d spp", ckpt, film.spp)
    else:
        film = Film.create(width, height, dev)
    while film.spp < target_spp:
        # raw radiance per batch; the (non-linear) denoiser runs once at
        # the end
        done = film.spp
        batch = max(1, min(16, target_spp - done))
        img, alb, nrm = common.render_frame(
            config, scene, data.materials, data.camera, width, height,
            spp=batch, seed=config.seed, intersector=intersector,
            env=data.env, textures=data.textures, lights=lights,
            denoise_override=False, sample_offset=done)
        film = film.add(img, alb, nrm, batch)
        film.checkpoint(ckpt, meta={"seed": config.seed,
                                    "target": target_spp})
        LOG.info("progressive: %d/%d spp", film.spp, target_spp)

    out = os.path.join(out_dir, "progressive.png")
    if config.denoise:
        inv = 1.0 / max(film.spp, 1)
        img = denoise(film.mean(), film.albedo_accum * inv,
                      film.normal_accum * inv)
        write_png(out, color_to_uint8(img))
    else:
        film.save(out)
    if args.aov:
        film.save_aovs(os.path.join(out_dir, "progressive"))
    LOG.info("progressive render done -> %s", out)
    return 0


def _run_progressive_adaptive(config, scene, data, intersector, lights,
                              width: int, height: int, target_spp: int,
                              ckpt: str, out_dir: str,
                              aov: bool = False) -> int:
    """``--progressive N --adaptive``: the uniform loop's budget (N * npix
    samples) allocated by per-pixel variance (``render/adaptive.py``)."""
    from optix_ray_tracer_tpu_torch.render.adaptive import (
        AdaptiveFilm, adaptive_batch,
    )
    from optix_ray_tracer_tpu_torch.render.denoise import denoise
    from optix_ray_tracer_tpu_torch.render.film import save_aov_images
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )
    from optix_ray_tracer_tpu_torch.utils.logging import LOG

    npix = width * height
    if config.integrator.startswith("restir"):
        # adaptive traces pixel subsets; ReSTIR's spatial reuse needs
        # whole frames
        raise SystemExit(
            "--adaptive supports integrator 'whitted' or 'path'; "
            f"'{config.integrator}' renders full frames (drop --adaptive)")
    dev = data.camera.center.device
    kw = dict(seed=config.seed, background=config.background,
              max_depth=config.max_depth, intersector=intersector,
              env=data.env, textures=data.textures,
              sampler=getattr(config, "sampler", "pcg"),
              integrator="path" if config.integrator == "path"
              else "whitted")

    if os.path.exists(ckpt):
        try:
            film = AdaptiveFilm.restore(ckpt, dev)
        except KeyError:
            LOG.error("checkpoint %s is a uniform-progressive film; "
                      "--adaptive cannot resume it (delete it or drop "
                      "--adaptive)", ckpt)
            return 2
        if (film.width, film.height) != (width, height):
            LOG.error("checkpoint %s is %dx%d, requested %dx%d", ckpt,
                      film.width, film.height, width, height)
            return 2
        LOG.info("resumed adaptive checkpoint %s at %d total samples",
                 ckpt, film.total_samples)
    else:
        film = AdaptiveFilm.create(width, height, dev)

    budget = target_spp * npix
    warmup = min(4, target_spp) * npix
    k_batch = max(1, npix // 4)
    while film.total_samples < budget:
        done = film.total_samples
        k = npix if done < warmup else min(k_batch, budget - done)
        film = adaptive_batch(scene, data.materials, lights, data.camera,
                              film, k=k, **kw)
        film.checkpoint(ckpt, meta={"seed": config.seed,
                                    "target": target_spp})
        LOG.info("adaptive progressive: %d/%d samples (%.1f avg spp)",
                 film.total_samples, budget, film.total_samples / npix)

    out = os.path.join(out_dir, "progressive.png")
    if config.denoise:
        alb, nrm = film.guide_means()
        write_png(out, color_to_uint8(denoise(film.mean(), alb, nrm)))
    else:
        film.save(out)
    if aov:
        save_aov_images(os.path.join(out_dir, "progressive"),
                        *film.guide_means())
    LOG.info("adaptive progressive render done -> %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
