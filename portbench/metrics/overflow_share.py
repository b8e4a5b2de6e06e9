"""The share, in %, of the traced window's raster and bundle schedule
waves (``route.raster`` spans) whose schedule overflowed and that the
marcher traced again (``route.overflow`` spans): binning paid for and
thrown away.  None where the program has no ``route.raster`` span."""

from portbench import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    waves = spans.count(tr, "route.raster")
    if not waves:
        return None
    return 100.0 * spans.count(tr, "route.overflow") / waves
