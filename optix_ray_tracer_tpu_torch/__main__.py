"""Command-line entry point (port of the headless path of
``optix_ray_tracer_tpu/__main__.py``; the reference's ``main()``,
``src/Global/Main.cu``).

Usage:
    python -m optix_ray_tracer_tpu_torch --config path/to/config.json \
        [--frames N] [--output DIR] [--spp N] [--width W --height H] \
        [--loop] [--aov] [--no-denoise] [--verbose] [--cpu]

Parse the config; ``"cache": true`` in Mesh mode bakes the mesh cache and
exits; otherwise commit the Mesh or Time scene to the card (``--cpu``:
the CPU), run the render loop and write one PNG per frame.  The JAX
package's ``--viewer``, ``--progressive``, ``--adaptive`` and ``--shard``
are not ported yet: they exit with code 2 and name the ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

#: flags of the JAX package's CLI that wait for a later slice, with the
#: ROADMAP item that will port each
_NOT_PORTED = {
    "viewer": "queue 1 item 5 (render/viewer.py)",
    "progressive": "queue 1 item 5 (progressive accumulation)",
    "adaptive": "queue 1 item 5 (render/adaptive.py)",
    "shard": "queue 1 item 6 (parallel/animation.py)",
}


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
    ap.add_argument("--viewer", action="store_true", help="not ported yet")
    ap.add_argument("--progressive", type=int, default=None, metavar="SPP",
                    help="not ported yet")
    ap.add_argument("--adaptive", action="store_true", help="not ported yet")
    ap.add_argument("--shard", action="store_true", help="not ported yet")
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
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            LOG.error("--%s is not ported yet (ROADMAP %s)", flag, item)
            return 2
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

    if not args.cpu:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --cpu to render on the "
                               "CPU")
    t0 = time.perf_counter()
    data = frontend.commit(config, device="cpu" if args.cpu else None)
    LOG.info("scene committed in %.2fs", time.perf_counter() - t0)

    # quantize: frames leave the device as sRGB uint8 (4 B/pixel, the
    # reference's float4 -> uchar4 conversion, RendererImpl.cu:672-678);
    # --aov needs the guide channels on the host, so it takes float
    # Films with the guides fetched instead
    frames = frontend.render_frames(
        data, width=args.width, height=args.height, spp=args.spp,
        max_frames=args.frames, loop=args.loop, quantize=not args.aov,
        fetch_guides=args.aov)
    n = 0
    for fi, k, film in frames:
        stem = f"frame_{n:06d}"
        path = os.path.join(out_dir, stem + ".png")
        film.save(path)
        if args.aov:
            film.save_aovs(os.path.join(out_dir, stem))
        LOG.info("file %d frame %d -> %s (spp=%d)", fi, k, path,
                 int(film.spp))
        n += 1
    LOG.info("render finished: %d frames in %.2fs", n,
             time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
