"""The 95th percentile, over every frame of the window, of the time from
the frame before it reaching the host to it reaching the host (host clock,
linear interpolation between order statistics).  Frames of one fused chunk
arrive together."""


def read(ctx):
    gaps = ctx["stats"].get("gaps_s")
    if not gaps:
        return None
    v = sorted(gaps)
    pos = (len(v) - 1) * 0.95
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return 1e3 * (v[lo] + (v[hi] - v[lo]) * (pos - lo))
