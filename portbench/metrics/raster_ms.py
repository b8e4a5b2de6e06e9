"""Device ms, per frame of the traced window, of the binning and tile
raster kernels (``ops/raster``, ``ops/kernels/binning``,
``ops/kernels/tile_raster``): S, T, U (binning) and A (tile raster, camera
and bundle modes).  None when none ran."""

KERNELS = ("bin_rects_kernel", "bin_count_kernel", "bin_emit_kernel",
           "warp_raster_kernel", "bundle_raster_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return tr.ms_per_unit(lambda n: any(k in n for k in KERNELS))
