"""Hand-written CUDA kernels of the hit path and their plain PyTorch
versions (the counterparts of ``optix_ray_tracer_tpu/ops/pallas/``)."""
