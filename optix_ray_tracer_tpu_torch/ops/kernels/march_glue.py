"""The marcher's wave glue and the hit shading frame on the card.

Kernel O (:func:`march_keys_call`) writes a wave's coherence-sort keys,
P (:func:`gather_rays_call`) the (8, R_pad) ray rows kernels B, C and F
read, in sorted order and padded to whole blocks, and the inverse of the
sort's permutation, Q (:func:`finish_hits_call`) the Hit fields of a
march in the caller's order (read through that inverse), with u and v
recomputed from the winners' Woop rows, and R
(:func:`shading_frame_call`) each hit's point, shading normal, front
flag and material id.  They are CUDA (``csrc/march_glue.cu``,
``csrc/shading_frame.cu``; design notes there) and have no Pallas
counterpart: the JAX package's ``MarchIntersector.intersect`` and
``shading_frame`` are plain jnp, which XLA fuses around the pallas_call.

``ops/march.MarchIntersector`` calls the dispatchers :func:`march_keys`,
:func:`gather_rays` and :func:`finish_hits`, and
``ops/intersect.shading_frame`` dispatches the same way: CUDA tensors go
to the kernels, CPU tensors to the plain versions (``*_plain`` here and
``intersect.shading_frame_plain``: the code the port ran before), which
compute the same bits.  The ``*_call`` wrappers take CUDA tensors only:
anything else raises, and so does a library that fails to build.
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.ops.intersect import PRIM_NONE, PRIM_TRIANGLE
from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
from optix_ray_tracer_tpu_torch.ops.raysort import (
    probe_sort_keys, ray_sort_keys,
)
from optix_ray_tracer_tpu_torch.utils.vecmath import INF

#: O's modes (csrc/march_glue.cu)
KEY_MORTON, KEY_PROBE = 0, 1
#: Q's modes: u and v recomputed, zero (occlusion waves) or given
UV_RECOMPUTE, UV_ZERO, UV_GIVEN = 0, 1, 2
#: O's int32 key is the uint32 key less 2^31 (its sign bit flipped)
SIGN = 1 << 31


def march_keys(d, o=None, lo=None, hi=None, cid=None):
    """Kernel O on CUDA tensors, :func:`march_keys_plain` on others."""
    if d.is_cuda:
        return march_keys_call(d, o, lo, hi, cid)
    return march_keys_plain(d, o, lo, hi, cid)


def march_keys_plain(d, o=None, lo=None, hi=None, cid=None):
    """Plain version of kernel O: (R,) int32 coherence keys that sort as
    the JAX package's uint32 keys sort.  Morton keys of origins ``o`` in
    the scene box [``lo``, ``hi``] and directions ``d``
    (``raysort.ray_sort_keys``), or with kernel C's cluster ids ``cid``
    the probe keys (``raysort.probe_sort_keys``); either less 2^31."""
    key = (ray_sort_keys(o, d, lo, hi) if cid is None
           else probe_sort_keys(cid, d))
    return (key - SIGN).to(torch.int32)


def gather_rays(o, d, t_min, t_max, perm=None, w: int = 1):
    """Kernel P on CUDA tensors, :func:`gather_rays_plain` on others."""
    if o.is_cuda:
        return gather_rays_call(o, d, t_min, t_max, perm, w)
    return gather_rays_plain(o, d, t_min, t_max, perm, w)


def gather_rays_plain(o, d, t_min, t_max, perm=None, w: int = 1):
    """Plain version of kernel P: (rays, inv).  rays: the (8, R_pad) rows
    [o, d, t_min, min(t_max, INF)] of the rays in ``perm``'s order (one
    (R, 8) gather), padded to a multiple of ``w`` with dead rays
    (``block_march.pad_rays``, ``pack_rays``); inv: with ``perm``, its
    inverse (each ray's sorted position, int32), else None."""
    inv = None
    if perm is not None:
        n = perm.shape[0]
        inv = torch.empty(n, dtype=torch.int32, device=perm.device)
        inv[perm] = torch.arange(n, dtype=torch.int32, device=perm.device)
        packed = torch.cat([o, d, t_min[:, None], t_max[:, None]], 1)[perm]
        o, d, t_min, t_max = (packed[:, 0:3], packed[:, 3:6], packed[:, 6],
                              packed[:, 7])
    return bm.pack_rays(*bm.pad_rays(o, d, t_min, t_max, w)), inv


def finish_hits(t, slot, prim_index, n: int, o=None, d=None, woop=None,
                u=None, v=None, inv=None, any_hit: bool = False):
    """Kernel Q on CUDA tensors, :func:`finish_hits_plain` on others."""
    if slot.is_cuda:
        return finish_hits_call(t, slot, prim_index, n, o, d, woop, u, v,
                                inv, any_hit)
    return finish_hits_plain(t, slot, prim_index, n, o, d, woop, u, v, inv,
                             any_hit)


def finish_hits_plain(t, slot, prim_index, n: int, o=None, d=None,
                      woop=None, u=None, v=None, inv=None,
                      any_hit: bool = False):
    """Plain version of kernel Q: the Hit fields (t, prim_type, prim_id,
    u, v) in the caller's order of the n rays of a march's (t, slot), ray
    i at position ``inv[i]`` of them (or i).  Without ``u`` (given beside
    t and slot), u and v are recomputed from the winners' ``woop`` rows
    and the rays ``o``, ``d`` in the caller's order
    (``block_march._finish``; zero with ``any_hit``).  Misses: t INF,
    PRIM_NONE, id 0, u = v = 0."""
    t, slot = t[:n], slot[:n]
    if u is not None:
        u, v = u[:n], v[:n]
    if inv is not None:
        t, slot = t[inv], slot[inv]
        if u is not None:
            u, v = u[inv], v[inv]
    if u is None:
        t, slot, u, v = bm._finish(t, slot, any_hit, lambda: (
            woop[torch.clamp(slot, min=0).long()], o, d))
    missed = slot < 0
    prim_id = prim_index[torch.clamp(slot, min=0).long()]
    zero = torch.zeros_like(u)
    return (torch.where(missed, torch.full_like(t, INF), t),
            torch.where(missed, PRIM_NONE, PRIM_TRIANGLE).to(torch.int32),
            torch.where(missed, torch.zeros_like(prim_id), prim_id
                        ).to(torch.int32),
            torch.where(missed, zero, u), torch.where(missed, zero, v))


def _device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"tensors are on {t.device}: the kernels take CUDA "
                         f"tensors (CPU tensors take the plain versions)")
    return t.device


def _flat(t, name: str, dtype, dev, n: int, width: int = 1):
    """``t`` as a contiguous tensor of n x width elements (a copy only
    where it is not one already); raises unless it is a ``dtype`` tensor
    on ``dev``.  The kernels load 4- and 8-byte elements, so a view at any
    element offset will do."""
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name} is a {t.dtype} tensor on {t.device}, "
                         f"expected {dtype} on {dev}")
    if t.numel() != n * width:
        raise ValueError(f"{name} has {t.numel()} elements, expected "
                         f"{n * width}")
    return t.contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bound(t, name: str, dev, n: int):
    """(tensor, step) of a per-ray bound: element i at t[i * step], step 0
    for one bound broadcast over the wave (``ray_bound``'s expand)."""
    if t.dim() == 1 and t.shape[0] == n and t.stride(0) == 0:
        return _flat(t[:1], name, torch.float32, dev, 1), 0
    return _flat(t, name, torch.float32, dev, n), 1


def march_keys_call(d, o=None, lo=None, hi=None, cid=None):
    """Kernel O: :func:`march_keys_plain`'s keys on the card, Morton keys
    without ``cid``, probe keys with it."""
    dev = _device(d)
    n = d.shape[0]
    d = _flat(d, "d", torch.float32, dev, n, 3)
    if cid is None:
        mode = KEY_MORTON
        o = _flat(o, "o", torch.float32, dev, n, 3)
        lo = _flat(lo, "lo", torch.float32, dev, 1, 3)
        hi = _flat(hi, "hi", torch.float32, dev, 1, 3)
    else:
        mode = KEY_PROBE
        cid = _flat(cid, "cid", torch.int32, dev, n)
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _lib.MARCH_KEYS(dev, mode, _ptr(o), d.data_ptr(), _ptr(lo),
                        _ptr(hi), _ptr(cid), n, keys.data_ptr())
    return keys


def gather_rays_call(o, d, t_min, t_max, perm=None, w: int = 1):
    """Kernel P: :func:`gather_rays_plain`'s (rays, inv) on the card.
    ``t_min``, ``t_max``: (R,) tensors, contiguous or one value
    expanded."""
    dev = _device(o)
    n = o.shape[0]
    o = _flat(o, "o", torch.float32, dev, n, 3)
    d = _flat(d, "d", torch.float32, dev, n, 3)
    tmin, tmin_step = _bound(t_min, "t_min", dev, n)
    tmax, tmax_step = _bound(t_max, "t_max", dev, n)
    inv = None
    if perm is not None:
        perm = _flat(perm, "perm", torch.int64, dev, n)
        inv = torch.empty(n, dtype=torch.int32, device=dev)
    n_pad = n + (-n) % w
    rays = torch.empty((8, n_pad), dtype=torch.float32, device=dev)
    if n_pad:
        _lib.GATHER_RAYS(dev, o.data_ptr(), d.data_ptr(), tmin.data_ptr(),
                         tmin_step, tmax.data_ptr(), tmax_step, _ptr(perm),
                         n, n_pad, rays.data_ptr(), _ptr(inv))
    return rays, inv


def finish_hits_call(t, slot, prim_index, n: int, o=None, d=None,
                     woop=None, u=None, v=None, inv=None,
                     any_hit: bool = False):
    """Kernel Q: :func:`finish_hits_plain`'s Hit fields on the card."""
    dev = _device(slot)
    if t.shape[0] < n or slot.shape[0] < n:
        raise ValueError(f"t and slot must cover {n} rays")
    t = _flat(t, "t", torch.float32, dev, t.shape[0])
    slot = _flat(slot, "slot", torch.int32, dev, slot.shape[0])
    prim_index = _flat(prim_index, "prim_index", torch.int32, dev,
                       prim_index.numel())
    if u is not None:
        mode = UV_GIVEN
        u = _flat(u, "u", torch.float32, dev, u.shape[0])
        v = _flat(v, "v", torch.float32, dev, v.shape[0])
        if min(u.shape[0], v.shape[0]) < n:
            raise ValueError(f"u and v must cover {n} rays")
    elif any_hit:
        mode = UV_ZERO
    else:
        mode = UV_RECOMPUTE
        o = _flat(o, "o", torch.float32, dev, n, 3)
        d = _flat(d, "d", torch.float32, dev, n, 3)
        if woop.shape[-1] != 12:
            raise ValueError("woop rows must hold 12 values")
        woop = _flat(woop, "woop", torch.float32, dev, woop.numel())
    if inv is not None:
        inv = _flat(inv, "inv", torch.int32, dev, n)
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    ptype = torch.empty(n, dtype=torch.int32, device=dev)
    pid = torch.empty(n, dtype=torch.int32, device=dev)
    out_u = torch.empty(n, dtype=torch.float32, device=dev)
    out_v = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        recompute = mode == UV_RECOMPUTE
        _lib.FINISH_HITS(dev, mode, t.data_ptr(), slot.data_ptr(),
                         _ptr(o) if recompute else None,
                         _ptr(d) if recompute else None,
                         _ptr(woop) if recompute else None,
                         prim_index.data_ptr(), _ptr(u), _ptr(v), _ptr(inv),
                         n, out_t.data_ptr(), ptype.data_ptr(),
                         pid.data_ptr(), out_u.data_ptr(), out_v.data_ptr())
    return out_t, ptype, pid, out_u, out_v


def shading_frame_call(scene, o, d, hit):
    """Kernel R: ``intersect.shading_frame_plain``'s (point, normal,
    front_face, material_id) on the card."""
    dev = _device(o)
    shape = o.shape[:-1]
    n = shape.numel()
    o = _flat(o, "o", torch.float32, dev, n, 3)
    d = _flat(d, "d", torch.float32, dev, n, 3)
    fields = [_flat(x, name, dtype, dev, n) for x, name, dtype in (
        (hit.t, "t", torch.float32), (hit.prim_type, "prim_type", torch.int32),
        (hit.prim_id, "prim_id", torch.int32), (hit.u, "u", torch.float32),
        (hit.v, "v", torch.float32))]
    S, T = scene.sphere_count, scene.triangle_count
    sph, tri = scene.spheres, scene.triangles
    tables = [None] * 3
    if S:
        tables = [_flat(sph.centers, "centers", torch.float32, dev, S, 3),
                  _flat(sph.radii, "radii", torch.float32, dev, S),
                  _flat(sph.material_id, "sphere material_id", torch.int32,
                        dev, S)]
    normals = tri_mat = None
    if T:
        normals = _flat(tri.normals, "normals", torch.float32, dev, T, 9)
        tri_mat = _flat(tri.material_id, "triangle material_id",
                        torch.int32, dev, T)
    point = torch.empty((n, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    front = torch.empty(n, dtype=torch.bool, device=dev)
    mat = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _lib.SHADING_FRAME(dev, o.data_ptr(), d.data_ptr(),
                           *(x.data_ptr() for x in fields),
                           *(_ptr(x) for x in tables), S, _ptr(normals),
                           _ptr(tri_mat), T, n, point.data_ptr(),
                           normal.data_ptr(), front.data_ptr(),
                           mat.data_ptr())
    return (point.reshape(shape + (3,)), normal.reshape(shape + (3,)),
            front.reshape(shape), mat.reshape(shape))
