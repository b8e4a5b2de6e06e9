"""The program's spans in a traced window, reduced for the per-layer
metrics that read them.

The port enters its spans through ``utils/profiling.span``: while the
profiler records they are ``record_function`` ranges, host events of the
trace (``harness.Trace.cpu``) on the clock of its device events.  Names:
``fused.file``, ``fused.chunk`` and ``fused.deliver``, the fused frame
loop's three host phases, which never overlap; ``sync.<site>``, a host
read of a device value; ``route.raster``, a raster or bundle schedule
wave; ``route.overflow``, the marcher's re-trace of a wave whose schedule
overflowed.  A program without a span reads None for every metric of it,
never 0.
"""

from __future__ import annotations


def _matches(name: str, want: str) -> bool:
    """``want`` ending in "." names a family (``sync.``), else one span."""
    return name.startswith(want) if want.endswith(".") else name == want


def intervals(trace, want: str) -> list:
    """(start us, end us) of each host span that ``want`` names."""
    return sorted((ts, ts + dur) for name, ts, dur in trace.cpu
                  if _matches(name, want))


def idle_intervals(trace) -> list:
    """The gaps between merged device-busy intervals, in order: the
    intervals ``harness.Trace.idle_gaps`` ranks."""
    out, end = [], None
    for _, ts, dur in trace.device:
        if end is not None and ts > end:
            out.append((end, ts))
        end = ts + dur if end is None else max(end, ts + dur)
    return out


def _merged(iv: list) -> list:
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap_us(a: list, b: list) -> float:
    """Microseconds in both of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_unit(trace, want: str):
    """Device idle ms per traced frame or batch that the spans ``want``
    names overlap; None without a trace or without such a span."""
    if trace is None:
        return None
    iv = intervals(trace, want)
    if not iv:
        return None
    return (_overlap_us(idle_intervals(trace), _merged(iv)) / 1e3
            / max(trace.units, 1))


def count(trace, want: str) -> int:
    return len(intervals(trace, want))


def per_unit(trace, want: str, ms: bool = False):
    """The count (or with ``ms`` the total ms) of the spans ``want``
    names, per traced frame or batch; None without any."""
    if trace is None:
        return None
    iv = intervals(trace, want)
    if not iv:
        return None
    value = sum(e - s for s, e in iv) / 1e3 if ms else len(iv)
    return value / max(trace.units, 1)
