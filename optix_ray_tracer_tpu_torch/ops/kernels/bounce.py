"""The bounce loop's counter RNG and Whitted scatter on the card.

Kernel H (:func:`pcg4d_call`) is PCG4D, kernel I
(:func:`sobol_owen4_call`) the Owen-scrambled Sobol pads, kernel J
(:func:`scatter_call`) the Whitted scatter of one bounce wave.  They are
CUDA (``csrc/rng.cu``, ``csrc/scatter.cu``, sharing the device RNG of
``csrc/rng.cuh``; design notes there) and have no Pallas counterpart:
the JAX package leaves this work to XLA, which fuses it into the bounce
step.  ``utils/rng.pcg4d`` and ``uniform4``, ``utils/qmc.sobol_owen4``
and ``render/wavefront.scatter`` send CUDA tensors here and CPU tensors
to their plain versions (``pcg4d_plain``, ``uniform4_plain``,
``sobol_owen4_plain``, ``scatter_plain``), which compute the same bits.
The wrappers here take CUDA tensors only: anything else raises, and so
does a library that fails to build.

The four RNG arguments (pixel_id, sample, bounce, seed) are int tensors
or Python ints, broadcast together; :func:`lane_args` normalises them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.ops.kernels import _lib

MASK = 0xFFFFFFFF
# OrtLane kinds (csrc/rng.cuh)
LANE_VALUE, LANE_I32, LANE_I64 = 0, 1, 2
SAMPLERS = {"pcg": 0, "sobol": 1}


@dataclasses.dataclass(frozen=True)
class Lane:
    """One RNG argument as a kernel reads it: a flat contiguous int32 or
    int64 tensor with one element per output element, or (``tensor`` None)
    a uint32 ``value`` passed by value."""
    tensor: torch.Tensor | None
    value: int = 0


def lane_args(*args, shape=None):
    """(shape, lanes) of RNG arguments: ``shape`` is the broadcast shape
    of the tensor arguments (or the one given); each tensor becomes a flat
    contiguous int32 or int64 tensor of that shape (other dtypes are
    converted to int64, other shapes expanded), each Python int its value
    mod 2^32, as ``utils/rng._u32`` wraps it."""
    if shape is None:
        shape = torch.broadcast_shapes(*(a.shape for a in args
                                         if isinstance(a, torch.Tensor)))
    shape = torch.Size(shape)
    lanes = []
    for a in args:
        if isinstance(a, torch.Tensor):
            t = a if a.dtype in (torch.int32, torch.int64) else \
                a.to(torch.int64)
            lanes.append(Lane(t.expand(shape).contiguous().reshape(-1)))
        else:
            lanes.append(Lane(None, int(a) & MASK))
    return shape, tuple(lanes)


def _lane_device(lanes) -> torch.device:
    devs = {ln.tensor.device for ln in lanes if ln.tensor is not None}
    if len(devs) != 1:
        raise ValueError(f"RNG arguments on devices {sorted(map(str, devs))}"
                         f": expected tensors on one CUDA device")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"RNG arguments are on {dev}: the kernels take "
                         f"CUDA tensors (CPU tensors take the plain "
                         f"versions)")
    return dev


def _c_lanes(lanes) -> list:
    """The C arguments (pointer, kind, value) of each lane, flattened."""
    out = []
    for ln in lanes:
        if ln.tensor is None:
            out += [None, LANE_VALUE, ln.value]
        else:
            out += [ln.tensor.data_ptr(), LANE_I32 if ln.tensor.dtype
                    == torch.int32 else LANE_I64, 0]
    return out


_DIRS: dict = {}


def sobol_directions(device) -> torch.Tensor:
    """The (32, 4) Sobol direction table of ``utils/qmc._DIRECTIONS``'s
    first four dimensions on ``device`` (uint32 bits in int32), cached."""
    key = str(device)
    if key not in _DIRS:
        from optix_ray_tracer_tpu_torch.utils.qmc import _DIRECTIONS
        table = np.ascontiguousarray(_DIRECTIONS[:, :4]).view(np.int32)
        _DIRS[key] = torch.as_tensor(table, device=device)
    return _DIRS[key]


def pcg4d_call(a, b, c, d, as_int: bool = False):
    """Kernel H: PCG4D of the four arguments.  Returns four tensors of the
    broadcast shape: the uint32 lanes as int64 with ``as_int``
    (``utils/rng.pcg4d``), else their uniforms, ``(u >> 8) * 2^-24`` in
    float32 (``utils/rng.uniform4``)."""
    shape, lanes = lane_args(a, b, c, d)
    dev = _lane_device(lanes)
    n = shape.numel()
    out = torch.empty((4, n), dtype=torch.int64 if as_int else torch.float32,
                      device=dev)
    if n:
        _lib.PCG4D(dev, *_c_lanes(lanes), n, int(as_int), out.data_ptr())
    return tuple(out[k].reshape(shape) for k in range(4))


def sobol_owen4_call(pixel_id, sample, bounce, seed):
    """Kernel I: ``utils/qmc.sobol_owen4``'s four float32 uniforms."""
    shape, lanes = lane_args(pixel_id, sample, bounce, seed)
    dev = _lane_device(lanes)
    n = shape.numel()
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    if n:
        _lib.SOBOL_OWEN4(dev, *_c_lanes(lanes), n,
                         sobol_directions(dev).data_ptr(), out.data_ptr())
    return tuple(out[k].reshape(shape) for k in range(4))


def _float_rows(x, name: str, dev, n: int) -> torch.Tensor:
    if x.dtype != torch.float32 or x.device != dev:
        raise ValueError(f"{name} is {x.dtype} on {x.device}, expected "
                         f"float32 on {dev}")
    if x.numel() != 3 * n:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"({n}, 3)")
    return x.contiguous()


def scatter_call(materials, material_id, d_in, normal, front_face,
                 pixel_id, sample, bounce, seed, sampler: str = "pcg"):
    """Kernel J: ``render/wavefront.scatter`` for a batch of hits.
    ``material_id`` int32 or int64 of shape S, ``d_in`` and ``normal``
    float32 (S, 3), ``front_face`` bool S; the RNG arguments broadcast to
    S.  Returns (new_dir, attenuation, emission (S, 3), terminate S)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    dev = d_in.device
    if dev.type != "cuda":
        raise ValueError(f"d_in is on {dev}: kernel J takes CUDA tensors")
    shape = material_id.shape
    n = material_id.numel()
    if material_id.dtype not in (torch.int32, torch.int64) or \
            material_id.device != dev:
        raise ValueError(f"material_id is {material_id.dtype} on "
                         f"{material_id.device}, expected int32 or int64 "
                         f"on {dev}")
    mid = material_id.contiguous()
    d_in = _float_rows(d_in, "d_in", dev, n)
    normal = _float_rows(normal, "normal", dev, n)
    front = front_face.to(dev, torch.bool).expand(shape).contiguous()
    _, lanes = lane_args(pixel_id, sample, bounce, seed, shape=shape)
    if any(ln.tensor is not None and ln.tensor.device != dev
           for ln in lanes):
        raise ValueError(f"RNG arguments must lie on {dev}")
    m = materials.count
    mtype = materials.mtype.to(dev, torch.int32).contiguous()
    albedo = materials.albedo.to(dev, torch.float32).contiguous()
    param = materials.param.to(dev, torch.float32).contiguous()
    emis = materials.emission.to(dev, torch.float32).contiguous()
    new_dir = torch.empty(shape + (3,), device=dev)
    att = torch.empty(shape + (3,), device=dev)
    emission = torch.empty(shape + (3,), device=dev)
    terminate = torch.empty(shape, dtype=torch.bool, device=dev)
    if n:
        _lib.WHITTED_SCATTER(
            dev, mid.data_ptr(),
            LANE_I32 if mid.dtype == torch.int32 else LANE_I64,
            d_in.data_ptr(), normal.data_ptr(), front.data_ptr(),
            *_c_lanes(lanes), n, SAMPLERS[sampler],
            sobol_directions(dev).data_ptr(), mtype.data_ptr(),
            albedo.data_ptr(), param.data_ptr(), emis.data_ptr(), m,
            new_dir.data_ptr(), att.data_ptr(), emission.data_ptr(),
            terminate.data_ptr())
    return new_dir, att, emission, terminate
