"""What every cell shares: the manifest, the device's look, the result
line and the judgement of its compared numbers, the trace's reduction and
the per-metric readers.

Nothing here knows a cell.  ``BENCHMARK.json`` names each cell's
configuration and traffic; ``configs/<config>.json`` holds the
configuration, ``traffic/<traffic>.json`` the mix and the name of the
driver (``drivers/<driver>.py``) that serves it, ``limits/<cell>.json``
the limit of each number the cell's check compares, and
``metrics/<metric>.py`` (or, for ``<quantity>.<part>``, the quantity's
``metrics/<quantity>.py``) the reader of each metric.  A later change
adds a cell, a mix or a metric by adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded in the process that
#: prints a result (compared whole: the port's name begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "optix_ray_tracer_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    for w in manifest()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    for c in manifest()["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_module(name: str):
    """``metrics/<name>.py``, or where there is none, the file of the
    part of the name before its first dot: ``marcher_ms.pile`` and a later
    ``marcher_ms.<cells>`` share ``metrics/marcher_ms.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` of the metric's file (``metric_module``)."""
    return metric_module(name).read


def cell_metrics(cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in manifest()[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


# ---- the device trace ---------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """A ``torch.profiler`` trace of the window, reduced: the device's
    operations (name, start us, duration us) and the host's CPU ops."""

    def __init__(self, events: list, window_s: float, units: int):
        self.device = sorted(
            ((e["name"], float(e["ts"]), float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
            key=lambda x: x[1])
        self.cpu = [(e["name"], float(e["ts"]), float(e["dur"]))
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in ("cpu_op", "user_annotation",
                                         "python_function", "cuda_runtime",
                                         "cuda_driver")]
        self.window_s = window_s
        self.units = units

    @staticmethod
    def load(path, window_s: float, units: int) -> "Trace":
        return Trace(json.loads(Path(path).read_text())["traceEvents"],
                     window_s, units)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (intervals merged)."""
        total, end = 0.0, float("-inf")
        for _, ts, dur in self.device:
            s, e = max(ts, end), ts + dur
            if e > s:
                total += e - s
            end = max(end, e)
        return total / 1e6

    def ms_per_unit(self, match) -> float | None:
        """Device ms of the operations whose name ``match`` accepts, per
        frame or batch of the traced window; None when none ran."""
        hits = [dur for name, _, dur in self.device if match(name)]
        if not hits:
            return None
        return sum(hits) / 1e3 / max(self.units, 1)

    def top_ops(self, n: int = 10) -> list:
        acc: dict = {}
        for name, _, dur in self.device:
            acc[name] = acc.get(name, 0.0) + dur / 1e6
        return [[k[:160], v] for k, v in
                sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps between device operations, each named by the
        innermost host op running at its middle."""
        gaps, end = [], None
        for _, ts, dur in self.device:
            if end is not None and ts > end:
                gaps.append((ts - end, end, ts))
            end = ts + dur if end is None else max(end, ts + dur)
        out = []
        for g, s, e in sorted(gaps, reverse=True)[:n]:
            mid = 0.5 * (s + e)
            inner = [c for c in self.cpu if c[1] <= mid <= c[1] + c[2]]
            label = max(inner, key=lambda c: c[1])[0] if inner else "host"
            out.append([label[:160], g / 1e6])
        return out


# ---- the result line ----------------------------------------------------

def device_block(count: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(count))}


def limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def judge(cell: str, numbers: dict, attempted: int, failed: int):
    """Each compared number beside its limit, and ``correct``: something
    was attempted, nothing failed, the check read every number that the
    cell's limits name, and each is within its limit."""
    lim = limits(cell)
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in lim.items()}
    correct = (attempted > 0 and failed == 0 and set(numbers) == set(lim)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return correct, checks


def emit(result: dict, checks: dict) -> None:
    """Print the compared numbers beside their limits as the last lines of
    standard error, then the result line, with the checks as its last key,
    as the last line of standard output."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
