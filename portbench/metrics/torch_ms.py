"""Device ms, per frame or batch of the traced window, of every device
operation that is not a kernel of the port's library: the frame step,
film and denoisers, rebuild and refit, the integrators' glue (torch
elementwise, gathers, sorts, copies, memsets).  None when none ran.  The
library is the kernels of the other layers' readers and G, which no
layer's metric reads yet."""

from portbench import harness

UNGROUPED = ("leaf_sweep_kernel",)
LIBRARY = UNGROUPED + tuple(
    k for layer in ("marcher_ms", "raster_ms", "bounce_ms")
    for k in harness.metric_module(layer).KERNELS)


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return tr.ms_per_unit(lambda n: not any(k in n for k in LIBRARY))
