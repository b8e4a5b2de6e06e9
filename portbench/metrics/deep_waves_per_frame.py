"""The program's ``march.deep`` spans per traced frame: its marcher waves
past 8,192 clusters (the deep kernels' route: probe, sort and march on
C2 and F2).  Every marcher wave of a frame past the cap opens one, so on a
Whitted frame of depth 5 it reads 5.  None where the program has no such
span."""

from portbench import spans


def read(ctx):
    return spans.per_unit(ctx["trace"], "march.deep")
