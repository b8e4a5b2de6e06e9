"""The program's ``sync.*`` spans, per traced frame: its host reads of a
device value, each of which waits for the device to drain the work
queued before it.  None where the program has no such span."""

from portbench import spans


def read(ctx):
    return spans.per_unit(ctx["trace"], "sync.")
