"""The bounce loop's counter RNG, Whitted scatter and path-tracer
shading on the card.

Kernel H (:func:`pcg4d_call`) is PCG4D, kernel I
(:func:`sobol_owen4_call`) the Owen-scrambled Sobol pads, kernel J
(:func:`scatter_call`) the Whitted scatter of one bounce wave, kernel K
(:func:`bsdf_step_call`) the path tracer's BSDF step (lobe, throughput,
Russian roulette, next ray) of one bounce wave, kernels L
(:func:`nee_sample_call`: the light and environment samples), M
(:func:`nee_add_call`: their shadowed contributions) and N
(:func:`hit_radiance_call`: the miss and emitter terms) its next-event
estimation and MIS.  They are CUDA (``csrc/rng.cu``, ``csrc/scatter.cu``,
``csrc/path_scatter.cu``, ``csrc/path_nee.cu``, sharing the device RNG of
``csrc/rng.cuh``; design notes there) and have no Pallas counterpart:
the JAX package leaves this work to XLA, which fuses it into the bounce
step.  ``utils/rng.pcg4d`` and ``uniform4``, ``utils/qmc.sobol_owen4``,
``render/wavefront.scatter`` and ``render/pathtracer.bsdf_step``,
``nee_sample``, ``nee_add`` and ``hit_radiance`` send CUDA tensors here
and CPU tensors to their plain versions (``pcg4d_plain``,
``uniform4_plain``, ``sobol_owen4_plain``, ``scatter_plain``, and the
``*_plain`` of the path tracer's steps), which compute the same bits.
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


_TABLES: dict = {}


def sobol_tables(device) -> torch.Tensor:
    """The (1024, 4) per-byte Sobol tables of ``utils/qmc.
    sobol_byte_tables`` (uint32 bits in int32) on ``device``, cached: the
    rows that I, J and K stage in shared memory for the Sobol sampler."""
    key = str(device)
    if key not in _TABLES:
        from optix_ray_tracer_tpu_torch.utils.qmc import sobol_byte_tables
        _TABLES[key] = torch.as_tensor(sobol_byte_tables().view(np.int32),
                                       device=device)
    return _TABLES[key]


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
                         sobol_tables(dev).data_ptr(), out.data_ptr())
    return tuple(out[k].reshape(shape) for k in range(4))


def _rows(x, name: str, dtype, dev, n: int, width: int = 1) -> torch.Tensor:
    """``x`` contiguous, after checking that it holds n rows of ``width``
    elements of ``dtype`` on ``dev``."""
    if x.dtype != dtype or x.device != dev or x.numel() != width * n:
        want = f"({n},)" if width == 1 else f"({n}, {width})"
        raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, expected {dtype} {want} on {dev}")
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
    d_in = _rows(d_in, "d_in", torch.float32, dev, n, 3)
    normal = _rows(normal, "normal", torch.float32, dev, n, 3)
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
            sobol_tables(dev).data_ptr(), mtype.data_ptr(),
            albedo.data_ptr(), param.data_ptr(), emis.data_ptr(), m,
            new_dir.data_ptr(), att.data_ptr(), emission.data_ptr(),
            terminate.data_ptr())
    return new_dir, att, emission, terminate


def bsdf_step_call(d, n_unit, point, front_face, mtype, albedo, param,
                   throughput, shading_alive, o, pixel_id, sample,
                   bounce: int, seed: int, sampler: str = "pcg",
                   rr_start: int = 3):
    """Kernel K: ``render/pathtracer.bsdf_step`` for a wave of R hits.
    ``d``, ``n_unit``, ``point``, ``albedo``, ``throughput``, ``o``
    float32 (R, 3); ``front_face``, ``shading_alive`` bool (R,);
    ``mtype`` int32 (R,); ``param`` float32 (R,); ``pixel_id`` and
    ``sample`` broadcast to (R,), ``bounce`` and ``seed`` ints.  Returns
    (o, d, throughput (R, 3), prev_pdf (R,), alive (R,))."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    dev = d.device
    if dev.type != "cuda":
        raise ValueError(f"d is on {dev}: kernel K takes CUDA tensors")
    n = mtype.numel()
    shape = mtype.shape
    mtype = _rows(mtype, "mtype", torch.int32, dev, n)
    param = _rows(param, "param", torch.float32, dev, n)
    front = _rows(front_face, "front_face", torch.bool, dev, n)
    alive = _rows(shading_alive, "shading_alive", torch.bool, dev, n)
    vecs = [_rows(x, name, torch.float32, dev, n, 3) for x, name in (
        (d, "d"), (n_unit, "n_unit"), (point, "point"), (albedo, "albedo"),
        (throughput, "throughput"), (o, "o"))]
    _, lanes = lane_args(pixel_id, sample, bounce, seed, shape=shape)
    if any(ln.tensor is not None and ln.tensor.device != dev
           for ln in lanes):
        raise ValueError(f"RNG arguments must lie on {dev}")
    o_out, d_out, thr_out = (torch.empty(shape + (3,), device=dev)
                             for _ in range(3))
    prev_pdf = torch.empty(shape, device=dev)
    alive_out = torch.empty(shape, dtype=torch.bool, device=dev)
    if n:
        d, n_unit, point, albedo, thr, o = (x.data_ptr() for x in vecs)
        _lib.PATH_BSDF(
            dev, d, n_unit, point, front.data_ptr(), mtype.data_ptr(),
            albedo, param.data_ptr(), thr, alive.data_ptr(), o,
            *_c_lanes(lanes), n, SAMPLERS[sampler], int(bounce >= rr_start),
            sobol_tables(dev).data_ptr(), o_out.data_ptr(),
            d_out.data_ptr(), thr_out.data_ptr(), prev_pdf.data_ptr(),
            alive_out.data_ptr())
    return o_out, d_out, thr_out, prev_pdf, alive_out



def _ptr(x):
    """A C argument: a tensor's pointer, None (NULL) or a number."""
    return x.data_ptr() if isinstance(x, torch.Tensor) else x


def nee_sample_call(point, n_unit, shading_alive, mtype, throughput, albedo,
                    pixel_id, sample, bounce: int, seed: int,
                    sampler: str = "pcg", lights=None, env=None,
                    cap: float = 0.0):
    """Kernel L: ``render/pathtracer.nee_sample`` for a wave of R hits:
    the area-light sample of ``lights`` (an ``AreaLights``; None: off) and
    the environment sample of ``env`` (an ``EnvMap`` with sampling
    tables; None: off).  ``point``, ``n_unit``, ``throughput``,
    ``albedo`` float32 (R, 3); ``shading_alive`` bool (R,); ``mtype``
    int32 (R,); ``pixel_id`` and ``sample`` broadcast to (R,), ``bounce``
    and ``seed`` ints; ``cap`` the firefly clamp (0: off).  Returns
    (origin (R, 3), area, sky), each part (direction (R, 3), t_max (R,),
    contribution (R, 3), valid (R,) bool) or None."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r}")
    if lights is None and env is None:
        raise ValueError("kernel L needs the light table, the map or both")
    dev = point.device
    if dev.type != "cuda":
        raise ValueError(f"point is on {dev}: kernel L takes CUDA tensors")
    n = mtype.numel()
    shape = mtype.shape
    f32 = torch.float32
    args = [_rows(point, "point", f32, dev, n, 3),
            _rows(n_unit, "n_unit", f32, dev, n, 3),
            _rows(shading_alive, "shading_alive", torch.bool, dev, n),
            _rows(mtype, "mtype", torch.int32, dev, n),
            _rows(throughput, "throughput", f32, dev, n, 3),
            _rows(albedo, "albedo", f32, dev, n, 3)]
    _, lanes = lane_args(pixel_id, sample, bounce, seed, shape=shape)
    if any(ln.tensor is not None and ln.tensor.device != dev
           for ln in lanes):
        raise ValueError(f"RNG arguments must lie on {dev}")
    tables = [None] * 7 + [0]
    if lights is not None:
        m = lights.count
        tables = [_rows(getattr(lights, k), k, f32, dev, m, 3) for k in
                  ("v0", "e1", "e2", "normal", "emission")] + [
            _rows(lights.cdf, "cdf", f32, dev, m),
            _rows(lights.pdf_scale, "pdf_scale", f32, dev, m), m]
    if env is not None:
        h, w = env.image.shape[:2]
        nb = env.block_cdf.shape[0]
        tables += [_rows(env.image, "image", f32, dev, h * w, 3),
                   _rows(env.block_cdf, "block_cdf", f32, dev, nb),
                   _rows(env.cond_cdf, "cond_cdf", f32, dev, nb, env.BLOCK),
                   _rows(env.pdf_tex, "pdf_tex", f32, dev, h * w), h, w, nb]
    else:
        tables += [None] * 4 + [0, 0, 0]
    origin = torch.empty(shape + (3,), device=dev)
    parts = [(torch.empty(shape + (3,), device=dev),
              torch.empty(shape, device=dev),
              torch.empty(shape + (3,), device=dev),
              torch.empty(shape, dtype=torch.bool, device=dev)) if on
             else None for on in (lights is not None, env is not None)]
    # the C order of a part: direction, t_max, validity, contribution
    outs = [origin] + [x for part in parts
                       for x in ((part[0], part[1], part[3], part[2])
                                 if part else (None,) * 4)]
    if n:
        _lib.PATH_NEE_SAMPLE(
            dev, *map(_ptr, args), *_c_lanes(lanes), n, SAMPLERS[sampler],
            int(lights is not None) | int(env is not None) << 1, float(cap),
            sobol_tables(dev).data_ptr(), *map(_ptr, tables),
            *map(_ptr, outs))
    return origin, parts[0], parts[1]


def nee_add_call(radiance, c_l, valid_l, occ_l, c_e, valid_e, occ_e):
    """Kernel M: ``render/pathtracer.nee_add``: ``radiance`` (R, 3)
    float32 plus each part's contribution (R, 3) float32 where its
    validity mask (R,) bool is True and its occlusion mask (R,) bool
    False, area first; a part whose contribution is None is off.  Returns
    the new radiance."""
    dev = radiance.device
    if dev.type != "cuda":
        raise ValueError(f"radiance is on {dev}: kernel M takes CUDA "
                         f"tensors")
    n = radiance.shape[0]
    args = [_rows(radiance, "radiance", torch.float32, dev, n, 3)]
    for c, valid, occ, name in ((c_l, valid_l, occ_l, "area"),
                                (c_e, valid_e, occ_e, "sky")):
        args += [None] * 3 if c is None else [
            _rows(c, f"{name} contribution", torch.float32, dev, n, 3),
            _rows(valid, f"{name} validity", torch.bool, dev, n),
            _rows(occ, f"{name} occlusion", torch.bool, dev, n)]
    out = torch.empty_like(args[0])
    if n:
        _lib.PATH_NEE_ADD(dev, *map(_ptr, args), n, out.data_ptr())
    return out


def hit_radiance_call(radiance, d, prev_pdf, throughput, missed, hit_alive,
                      hit, mtype, emission, prim_diff, bounce: int,
                      background, lights=None, env=None, cap: float = 0.0,
                      restir_direct: bool = False):
    """Kernel N: ``render/pathtracer.hit_radiance`` for a wave of R rays.
    ``radiance``, ``d``, ``throughput``, ``emission`` float32 (R, 3);
    ``prev_pdf`` float32 (R,); ``missed``, ``hit_alive``, ``prim_diff``
    bool (R,); ``mtype`` int32 (R,); ``hit`` the wave's Hit (t float32,
    prim_id and prim_type int32); ``background`` (3,) float32 on the
    card, read where ``env`` is None; ``lights`` an ``AreaLights`` or
    None; ``cap`` the firefly clamp (0: off).  Returns the new
    radiance."""
    dev = radiance.device
    if dev.type != "cuda":
        raise ValueError(f"radiance is on {dev}: kernel N takes CUDA "
                         f"tensors")
    n = radiance.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    args = [_rows(radiance, "radiance", f32, dev, n, 3),
            _rows(d, "d", f32, dev, n, 3),
            _rows(prev_pdf, "prev_pdf", f32, dev, n),
            _rows(throughput, "throughput", f32, dev, n, 3),
            _rows(missed, "missed", b8, dev, n),
            _rows(hit_alive, "hit_alive", b8, dev, n),
            _rows(mtype, "mtype", i32, dev, n),
            _rows(emission, "emission", f32, dev, n, 3),
            _rows(hit.t, "hit.t", f32, dev, n),
            _rows(hit.prim_id, "hit.prim_id", i32, dev, n),
            _rows(hit.prim_type, "hit.prim_type", i32, dev, n),
            _rows(prim_diff, "prim_diff", b8, dev, n), n]
    if env is None:
        args += [0, _rows(background, "background", f32, dev, 3),
                 None, None, 0, 0]
    else:
        h, w = env.image.shape[:2]
        args += [2 if env.can_sample else 1, None,
                 _rows(env.image, "image", f32, dev, h * w, 3),
                 _rows(env.pdf_tex, "pdf_tex", f32, dev, h * w)
                 if env.can_sample else None, h, w]
    if lights is None:
        args += [None, 0, None, None]
    else:
        t = lights.tri_light_idx.shape[0]
        args += [_rows(lights.tri_light_idx, "tri_light_idx", i32, dev, t),
                 t, _rows(lights.normal, "normal", f32, dev, lights.count, 3),
                 _rows(lights.pdf_scale, "pdf_scale", f32, dev,
                       lights.count)]
    # which emitter hits count: all; none (ReSTIR's bounce 0); those of a
    # non-diffuse primary vertex (ReSTIR's bounce 1)
    emit = (1 if bounce == 0 else 2 if bounce == 1 else 0) \
        if restir_direct else 0
    out = torch.empty_like(args[0])
    if n:
        _lib.PATH_HIT_RADIANCE(dev, *map(_ptr, args), emit, float(cap),
                               out.data_ptr())
    return out
