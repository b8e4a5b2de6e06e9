"""The granular chute's frame stream: ``time_stream``'s stream, window and
check over the chute's bed (``gen/chute.py``): 32,000 particles on a
ground quad, seen from the chute's camera.  Only the inputs, the plain
reference's scene and the camera differ from ``time_stream``, and while a
profiler traces the window it records each wave of the deep marcher
kernels for ``roofline.py``; the reference imports nothing of the program.
"""

from __future__ import annotations

import inspect
from pathlib import Path

import numpy as np
import torch

from portbench.drivers import time_stream
from portbench.gen import chute as gen
from portbench.reference.pile import Pile


class Run(time_stream.Run):
    def inputs(self):
        """The bed of ``gen.POSE_SEED`` (every seed renders the same
        scene), its particles listed in an order drawn from the seed."""
        c = self.cfg
        base = gen.bed_poses(c["particles"], gen.ANIM_TIMES)
        perm = np.random.default_rng(self.seed).permutation(c["particles"])
        self.poses = [{k: v[perm] for k, v in p.items()} for p in base]
        self.shapes = gen.library_shapes()
        self.panel = None

    def window(self, seconds: float, max_units: int | None = None) -> dict:
        """``time_stream``'s window.  While a profiler traces it, each call
        of the program's deep march (F2) and of its probe past
        ``MAX_CLUSTERS`` (C2) is recorded as (rays, live rays, clusters)
        under ``stats["deep_waves"]``, by kernel name; a program without
        the deep kernels records nothing."""
        from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
        if not (torch._C._autograd._profiler_enabled()
                and hasattr(bm, "march_deep_call")):
            return super().window(seconds, max_units)
        waves = {"deep_warp_march_kernel": [], "deep_probe_kernel": []}
        real = {"march_deep_call": bm.march_deep_call,
                "probe_call": bm.probe_call}

        def recorded(fn_name, kernel):
            fn = real[fn_name]
            sig = inspect.signature(fn)

            def call(*args, **kw):
                a = sig.bind(*args, **kw).arguments
                if a["n_clusters"] > bm.MAX_CLUSTERS:
                    r = a["rays"]
                    with torch.profiler.record_function("portbench.live"):
                        live = ((r[6] < r[7])
                                & r[0:6].sum(0).isfinite()).sum()
                    waves[kernel].append((r.shape[1], live, a["n_clusters"]))
                return fn(*args, **kw)
            return call

        bm.march_deep_call = recorded("march_deep_call",
                                      "deep_warp_march_kernel")
        bm.probe_call = recorded("probe_call", "deep_probe_kernel")
        try:
            stats = super().window(seconds, max_units)
        finally:
            bm.march_deep_call = real["march_deep_call"]
            bm.probe_call = real["probe_call"]
        stats["deep_waves"] = {k: [(n, int(live), c) for n, live, c in v]
                               for k, v in waves.items()}
        return stats

    def write_series(self, root: Path) -> Path:
        c = self.cfg
        series, stl_dir = gen.write_time_series(root / "time", self.shapes,
                                                self.poses, gen.ANIM_TIMES)
        return gen.write_chute_config(
            root / "anim.json", series, stl_dir, root / "cache", c["width"],
            c["height"], gen.ANIM_FPS, c["max_depth"],
            integrator=self.mix["integrator"], seed=self.render_seed,
            spp=c["spp"], denoise=c["denoise"], temporal=c["temporal"],
            background=c["background"], sampler=c["sampler"])

    def reference(self):
        return Pile(self.poses, [v for v, _ in self.shapes], gen.ANIM_TIMES,
                    gen.ANIM_FPS, gen.GROUND, gen.GROUND_ALBEDO, None,
                    self.device)

    def compare(self, dtype, against=None) -> dict:
        """``time_stream``'s compare from the chute's camera (it reads the
        camera from its generator module's TIME_EYE and camera_target)."""
        pile_gen = time_stream.gen
        time_stream.gen = gen
        try:
            return super().compare(dtype, against)
        finally:
            time_stream.gen = pile_gen
