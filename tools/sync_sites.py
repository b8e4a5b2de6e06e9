"""Every host read of a device value on a pile cell's frame loop, and
whether a ``sync.*`` span holds it.

Usage: python3 tools/sync_sites.py [--cells CELL ...] [--frames N]
       [--seed N] [--out PATH]   (from the repository root; needs CUDA)

Sets each benchmark cell up as ``portbench/run.py`` does (its driver's
``setup``: the inputs, the commit and one warm loop over the files), then
makes two passes of ``--frames`` frames.  The first runs under
``torch.cuda.set_sync_debug_mode("warn")`` (the synchronising calls
torch reports), wrapped ``Event.synchronize`` and ``Stream.synchronize``
(waits the debug mode does not report) and a ``torch.profiler`` trace:
each reported call is put down to its site, the innermost frame of the
port on the stack, and to the ``sync.*`` span open around it; a site of
the port under none is an escape.  The second takes a window as the
benchmark does (``Run.window``) under the profiler alone, with each
``next`` on the stream inside a ``program.next`` range and each
collection of Python's garbage collector inside a ``gc`` range, so that
a gap under no range at all is the caller's.  Prints per cell the sites
and their counts per frame beside the ``sync.*`` spans per frame of the
first pass (``syncs_per_frame.pile``), and from the second every
per-layer metric that reads the spans, the idle ms a frame by the name
``harness.Trace.idle_gaps`` gives a gap and the ten longest gaps with
the host events before and after them, and the device constants
(``utils/tensors.CONSTANTS``) built and reused in the set-up and in the
first pass; writes the same as JSON to ``--out``.  Exits 1 if a call of
the port escaped its span.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import sys
import tempfile
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from optix_ray_tracer_tpu_torch.utils import profiling  # noqa: E402
from optix_ray_tracer_tpu_torch.utils.tensors import CONSTANTS  # noqa: E402
from portbench import harness, spans  # noqa: E402

PACKAGE = str(ROOT / "optix_ray_tracer_tpu_torch")
SPAN_METRICS = ("file_idle_ms.pile", "queue_idle_ms.pile",
                "deliver_idle_ms.pile", "sync_wait_ms.pile",
                "syncs_per_frame.pile", "overflow_share.pile")


def _site(stack) -> str:
    """The innermost frame of the port (else of this repository) on
    ``stack``, as path:line function."""
    for fs in reversed(stack):
        f = os.path.abspath(fs.filename)
        if f.startswith(PACKAGE) and not f.endswith("profiling.py"):
            return f"{os.path.relpath(f, ROOT)}:{fs.lineno} {fs.name}"
    for fs in reversed(stack):
        f = os.path.abspath(fs.filename)
        if f.startswith(str(ROOT)) and f != os.path.abspath(__file__):
            return f"{os.path.relpath(f, ROOT)}:{fs.lineno} {fs.name}"
    return "outside the repository"


class Observer:
    """Records each reported synchronisation: who reported it (the debug
    mode, or a wrapped ``Event.synchronize`` / ``Stream.synchronize``,
    which the debug mode does not see), its site and the innermost
    ``sync.*`` span open (``profiling.span`` wrapped while the observer
    is on)."""

    def __init__(self):
        self.calls = []           # (reporter, site, open sync span)
        self.open = []
        self.on = False

    def record(self, who: str) -> None:
        if self.on:
            inner = next((n for n in reversed(self.open)
                          if n.startswith("sync.")), None)
            self.calls.append((who, _site(traceback.extract_stack()[:-2]),
                               inner))

    @contextlib.contextmanager
    def installed(self):
        real = profiling.span
        waits = {cls: cls.synchronize
                 for cls in (torch.cuda.Event, torch.cuda.Stream)}

        @contextlib.contextmanager
        def tracked(name):
            self.open.append(name)
            try:
                with real(name):
                    yield
            finally:
                self.open.pop()

        def wrap(cls, fn):
            def synchronize(obj):
                self.record(f"{cls.__name__}.synchronize")
                return fn(obj)
            return synchronize

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                self.record("debug_mode")

        profiling.span = tracked
        for cls, fn in waits.items():
            cls.synchronize = wrap(cls, fn)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                self.on = True
                yield
        finally:
            self.on = False
            torch.cuda.set_sync_debug_mode("default")
            for cls, fn in waits.items():
                cls.synchronize = fn
            profiling.span = real


def _program(gen):
    """``gen`` with each ``next`` inside a ``program.next`` range: a gap
    that lies under no range at all is the caller's."""
    while True:
        with torch.profiler.record_function("program.next"):
            try:
                item = next(gen)
            except StopIteration:
                return
        yield item


@contextlib.contextmanager
def _gc_ranges():
    """Each collection of Python's garbage collector inside a ``gc``
    range, so that a gap it causes is named."""
    open_rf = []

    def on_gc(phase, info):
        if phase == "start":
            rf = torch.profiler.record_function("gc")
            rf.__enter__()
            open_rf.append(rf)
        elif open_rf:
            open_rf.pop().__exit__(None, None, None)

    gc.callbacks.append(on_gc)
    try:
        yield
    finally:
        gc.callbacks.remove(on_gc)


def _labeller(trace):
    """``harness.Trace.idle_gaps``'s name of a gap from its middle: the
    innermost host event open there (the latest to start), else
    "host"."""
    cpu = sorted(trace.cpu, key=lambda c: c[1])
    starts = [c[1] for c in cpu]

    def label(mid: float) -> str:
        for c in reversed(cpu[:bisect.bisect_right(starts, mid)]):
            if mid <= c[1] + c[2]:
                return c[0]
        return "host"
    return label


def _traced(fn):
    """``fn()``, which returns the frames it took, under
    ``torch.profiler``: the reduced trace."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        frames = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return harness.Trace.load(path, 0.0, frames)
    finally:
        os.unlink(path)


def cell_sites(cell: str, frames: int, seed: int) -> dict:
    """Two passes over ``frames`` frames each, after the cell's set-up:
    the sites under the debug mode, then a window taken as
    ``portbench/run.py`` takes it (``Run.window``) with only the
    ``program.next`` and ``gc`` ranges added, for the idle time by name
    and the span metrics."""
    w = harness.workload(cell)
    mix = harness.traffic(w["traffic"])
    run = harness.driver(mix["driver"]).Run(
        harness.config(w["config"]), mix, seed=seed,
        device=torch.device("cuda", 0))
    CONSTANTS.reset()
    run.setup()
    torch.cuda.synchronize()
    constants = {"setup": dict(built=CONSTANTS.built,
                               reused=CONSTANTS.reused)}
    CONSTANTS.reset()
    run.gen = _program(run.gen)
    obs = Observer()

    def sites():
        with obs.installed():
            for _ in range(frames):
                run._take()
        return frames

    found = _traced(sites)
    torch.cuda.synchronize()
    constants["frames"] = dict(built=CONSTANTS.built,
                               reused=CONSTANTS.reused)

    def window():
        with _gc_ranges():
            return run.window(float("inf"), max_units=frames)["units"]

    trace = _traced(window)
    window_frames = trace.units
    run.release()
    table = Counter(obs.calls)
    names = Counter(n for n, _, _ in found.cpu if n.startswith("sync."))
    metrics = {m: harness.metric_reader(m)(dict(stats={}, trace=trace))
               for m in SPAN_METRICS}
    idle = Counter()
    gaps = []
    name = _labeller(trace)
    ends = sorted((ts + dur, n) for n, ts, dur in trace.cpu)
    starts = sorted((ts, n) for n, ts, dur in trace.cpu)
    for s, e in spans.idle_intervals(trace):
        label = name(0.5 * (s + e))
        idle[label] += (e - s) / 1e3 / window_frames
        # the host events that ended last before the gap's middle and
        # started first after it
        i = bisect.bisect_left(ends, (0.5 * (s + e),))
        j = bisect.bisect_left(starts, (0.5 * (s + e),))
        gaps.append((e - s, label, ends[i - 1][1] if i else None,
                     starts[j][1] if j < len(starts) else None))
    reported = Counter()
    for (who, _, _), c in table.items():
        reported[who] += c / frames
    escapes = [list(k) + [c] for k, c in table.items()
               if k[2] is None and k[1].startswith("optix_ray_tracer_tpu")]
    return dict(cell=cell, frames=frames, seed=seed,
                sites=[list(k) + [c / frames] for k, c in
                       sorted(table.items(), key=lambda kv: -kv[1])],
                reported_per_frame=dict(reported),
                sync_spans_per_frame={k: v / frames for k, v in
                                      names.items()},
                sync_spans_total_per_frame=spans.count(found, "sync.")
                / frames,
                metrics=metrics,
                idle_ms_per_frame_by_label=dict(idle.most_common()),
                longest_gaps_ms=[[label, g / 1e3, before, after]
                                 for g, label, before, after in
                                 sorted(gaps, reverse=True)[:10]],
                constants=constants, escapes=escapes,
                device=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", nargs="+",
                   default=["pile_whitted_anim", "pile_path_anim"])
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--seed", type=int, default=3_000_000_019)
    p.add_argument("--out", default="chiprun_out/sync_sites.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the synchronisations are the card's",
              file=sys.stderr)
        return 2
    out, bad = [], 0
    for cell in args.cells:
        r = cell_sites(cell, args.frames, args.seed)
        out.append(r)
        print(f"== {cell}: {r['frames']} frames on {r['device']}")
        print(f"reported per frame: {r['reported_per_frame']}; sync spans "
              f"per frame {r['sync_spans_total_per_frame']:.4g} "
              f"{r['sync_spans_per_frame']}")
        for who, site, inner, n in r["sites"]:
            print(f"  {n:8.4g}/frame  {who:22s} {inner or 'NO SPAN':24s} "
                  f"{site}")
        print(f"constant cache (tables built, reused): set-up "
              f"{r['constants']['setup']}, {r['frames']} frames "
              f"{r['constants']['frames']}")
        print(f"metrics: {r['metrics']}")
        print(f"idle ms a frame by name: {r['idle_ms_per_frame_by_label']}")
        print(f"longest gaps (ms): {r['longest_gaps_ms']}")
        bad += len(r["escapes"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
