"""Device idle ms, per traced frame, under the fused loop's ``fused.file``
spans: a file's set-up on the host (its frame-0 scene, the rebuild, its
tensors), the gaps between device operations it overlaps.  None where
the program has no such span."""

from portbench import spans


def read(ctx):
    return spans.idle_ms_per_unit(ctx["trace"], "fused.file")
