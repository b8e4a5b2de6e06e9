"""Device ms, per frame or batch of the traced window, of the bounce
loop's kernels (``ops/kernels/bounce``, ``csrc/{rng,scatter,path_scatter,
path_nee,shading_frame}.cu``): H, I (RNG), J (Whitted scatter), K (BSDF
step), L, M, N (NEE and MIS), R (shading frame).  None when none ran."""

KERNELS = ("pcg4d_kernel", "sobol_owen4_kernel", "whitted_scatter_kernel",
           "path_bsdf_kernel", "path_nee_sample_kernel",
           "path_nee_add_kernel", "path_hit_radiance_kernel",
           "shading_frame_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return tr.ms_per_unit(lambda n: any(k in n for k in KERNELS))
