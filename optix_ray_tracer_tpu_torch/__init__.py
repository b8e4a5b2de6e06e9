"""optix_ray_tracer_tpu_torch — the PyTorch + CUDA port of
``optix_ray_tracer_tpu``.

The JAX package beside this one is the reference; this package mirrors
its module paths (``scene/camera.py``, ``ops/march.py``,
``render/wavefront.py``, ...) and holds each of its results to the JAX
ones in ``tests/test_torch_*.py``.  Every Pallas kernel on the ported path
is a CUDA kernel written for Hopper (``csrc/``, loaded by
``ops/kernels/_lib.py``), with a plain PyTorch version beside it that
serves CPU tensors.

Entry points that build tensors from host data (scene constructors, the
cluster builds, ``convert.*``, ``Film.create``, the denoiser weights)
take ``device=None``, which means the card: without CUDA they raise
unless the caller passes ``device="cpu"``.  Functions that take tensors
run on their inputs' device.  This package imports neither ``jax`` nor
``optix_ray_tracer_tpu``.
"""

__version__ = "0.1.0"

import torch as _torch

# Ray tracing needs true fp32 arithmetic (the analog of the JAX package's
# global "highest" matmul precision): TF32 loses hits in Woop tests.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
