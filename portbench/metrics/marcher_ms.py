"""Device ms, per frame or batch of the traced window, of the query
routing and marcher kernels (``ops/march``, ``ops/kernels/block_march``,
``ops/kernels/march_glue``): B, E, F (warp marchers), C (probe), O (sort
keys), P (ray pack), Q (hit record).  None when none of them ran."""

KERNELS = ("warp_march_kernel", "probe_kernel", "march_keys_kernel",
           "gather_rays_kernel", "finish_hits_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return tr.ms_per_unit(lambda n: any(k in n for k in KERNELS))
