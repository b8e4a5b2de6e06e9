"""Host ms, per traced frame, inside the program's ``sync.*`` spans: the
time the host spent blocked on a read of a device value (a pair count,
a chunk's fetch).  None where the program has no such span."""

from portbench import spans


def read(ctx):
    return spans.per_unit(ctx["trace"], "sync.", ms=True)
