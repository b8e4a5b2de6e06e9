"""Kernel C (cluster probe) on the waves where it costs the most, timed by
CUDA events on one NVIDIA GPU: the bench scene's 1M-ray incoherent wave
(388 clusters) and the flatten frame's own first bounce wave (4M rays,
3,368 clusters; captured from a depth-2 render of flatten frame 0, as
chip_smoke.py captures it), both set up exactly as chip_smoke.py sets
them up.

Usage, from the repository root (needs CUDA):

    python3 tools/probe_bench.py [--tree DIR]

``--tree`` runs the kernels and chip_smoke.py of another checkout (for
instance an unpacked parent commit), so that two versions are timed in
one call on one card; the waves are the same.  Prints, per wave, its
rays, clusters and live share (t_max > t_min), the mean ms of ``REPS``
launches after a warm-up, twice, and the box tests the kernel ran where
its wrapper reports them.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPS = 10


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    tree = str(Path(ap.parse_args().tree).resolve())
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_bench: no CUDA device")
    import chip_smoke as cs
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.render import wavefront

    card = cs.card_line()
    print(f"{card}; tree {tree}")
    device = torch.device("cuda", 0)
    cs.build_kernels()
    b = cs.bench_setup(device)
    t = cs.time_setup(device)
    seen = []
    real = bm.probe_call

    def record(**kw):
        seen.append(kw)
        return real(**kw)

    bm.probe_call = record
    try:
        wavefront.render(t.flat, t.mats, t.cam, cs.WIDTH, cs.HEIGHT,
                         spp=cs.SPP, seed=1, max_depth=2,
                         intersector=t.finter)
    finally:
        bm.probe_call = real
    waves = {"incoherent 1M (bench scene)": bm.probe_inputs(
        b.cs, b.oi, b.di, b.tmin0, b.tmax_inf),
        "flatten frame bounce 1": seen[-1]}
    for label, pin in waves.items():
        rays = pin["rays"]
        R = rays.shape[1]
        live = int((rays[7] > rays[6]).sum())
        out = bm.probe_call(**pin)
        tests = f"; box tests run {int(out[1])}" if isinstance(out, tuple) \
            else ""
        ms = [cs.time_ms(lambda: bm.probe_call(**pin), REPS)
              for _ in range(2)]
        print(f"[probe] {label}: {R} rays, live share {live / R:.4f}, "
              f"{pin['n_clusters']} clusters: C {ms[0]:.3f} ms, "
              f"{ms[1]:.3f} ms{tests} [{card}]")


if __name__ == "__main__":
    main()
