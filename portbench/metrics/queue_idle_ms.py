"""Device idle ms, per traced frame, under the fused loop's
``fused.chunk`` spans: the host queueing a chunk of frames and its fetch,
with the host reads inside (``sync.*``), the gaps between device
operations it overlaps.  None where the program has no such span."""

from portbench import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx["trace"], "fused.chunk")
