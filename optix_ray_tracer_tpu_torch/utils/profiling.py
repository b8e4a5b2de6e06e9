"""Per-stage timing and throughput metrics (port of
``optix_ray_tracer_tpu/utils/profiling.py``): stage timers, a JSONL
metrics sink, rays/s, and a ``torch.profiler`` trace of a region.

The reference has no profiling beyond its frame pacer
(``SDL_GraphicsWindow.cu:265-274``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulating wall-clock timers per named stage.  With ``block``
    (the default) the clock stops after ``torch.cuda.synchronize()`` where
    there is a CUDA device; otherwise queued kernels make stages look
    free."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_s": self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


class MetricsLogger:
    """JSONL metrics sink: one JSON object per line (rays/s, build times,
    frame times, ...); without a path it drops everything."""

    def __init__(self, path: str | None = None) -> None:
        self.path = path
        self._f = open(path, "a") if path else None

    def log(self, **fields) -> None:
        fields.setdefault("ts", time.time())
        if self._f:
            self._f.write(json.dumps(fields) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def rays_per_second(width: int, height: int, spp: int, depth: int,
                    seconds: float) -> float:
    """Upper-bound ray rate (every path reaching full depth)."""
    return width * height * spp * depth / max(seconds, 1e-12)


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """Trace the region with ``torch.profiler`` (CPU and, where present,
    CUDA activity) and write a Chrome trace under ``logdir``; a no-op
    without a logdir."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
