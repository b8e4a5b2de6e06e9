"""Device idle ms, per traced frame, under the fused loop's
``fused.deliver`` spans: the host waiting for a chunk's fetch and
building its frames, the gaps between device operations it overlaps.
None where the program has no such span."""

from portbench import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx["trace"], "fused.deliver")
