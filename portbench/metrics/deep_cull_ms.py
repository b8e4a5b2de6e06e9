"""Device ms, per frame of the traced window, of the deep marcher kernels
past 8,192 clusters (``csrc/block_march.cu``): F2, the deep march, and
C2, the deep probe.  None when neither ran."""

KERNELS = ("deep_warp_march_kernel", "deep_probe_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return tr.ms_per_unit(lambda n: any(k in n for k in KERNELS))
