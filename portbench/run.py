#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

From the root of a checkout that holds ``optix_ray_tracer_tpu_torch``.
Set-up makes the cell's inputs from ``--seed``, builds and warms every
shape the window uses; the window renders back to back for ``--seconds``;
then the outputs that the window delivered are held to the plain
reference (``reference/``), and the last line of standard output is one
JSON object: correct, attempted, failed, metrics, device (and, with
``--trace 1``, breakdown), the compared numbers last, under ``checks``.
``--trace 1`` reports the cell's per-layer metrics from a
``torch.profiler`` trace of the window; ``--trace 0`` its end-to-end
metrics.  ``--control`` puts the reference, computed in bfloat16, in the
program's place: the result line judges the numbers it reads (the upper
readings of the limits), and standard error gives the program's beside
them.  Exits non-zero, with no result line, without a CUDA device or with
fewer than the cell's chips.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"[portbench {time.perf_counter() - T_START:8.3f}] {msg}",
          file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    cell = harness.workload(args.workload)
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{cell['chips']}", file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    run = harness.driver(mix["driver"]).Run(
        cfg, mix, seed=args.seed, device=torch.device("cuda", 0))
    run.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s")

    trace = None
    if args.trace:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            stats = run.window(args.seconds, max_units=mix["trace_units"])
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = harness.Trace.load(path, stats["window_s"],
                                       stats["units"])
        finally:
            os.unlink(path)
    else:
        stats = run.window(args.seconds)
    stats["setup_s"] = setup_s
    log(f"window {stats['window_s']:.3f} s, {stats['units']} units")
    found = harness.forbidden_modules()
    if found:
        print(f"modules that may not load here: {found}", file=sys.stderr)
        return 4
    device = harness.device_block(cell["chips"])
    run.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    if args.control:
        readings = run.control()
        for name, value in readings.items():
            print(f"control {name}: {value!r}", file=sys.stderr)
        numbers = {k.split(".", 1)[1]: v for k, v in readings.items()
                   if k.startswith("control.")}
    else:
        numbers = run.check()
    log(f"check {time.perf_counter() - t0:.3f} s")
    failed = stats["failed"]
    correct, checks = harness.judge(args.workload, numbers,
                                    stats["attempted"], failed)

    kind = "per_layer" if args.trace else "end_to_end"
    ctx = dict(stats=stats, trace=trace)
    metrics = {}
    for m in harness.cell_metrics(args.workload, kind):
        value = harness.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": stats["attempted"],
              "failed": failed, "metrics": metrics, "device": device}
    if trace is not None:
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(),
                               "idle_gaps": trace.idle_gaps()}
    found = harness.forbidden_modules()
    if found:
        print(f"modules that may not load here: {found}", file=sys.stderr)
        return 4
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
