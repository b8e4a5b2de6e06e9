"""Leaf sweep (port of ``optix_ray_tracer_tpu/ops/pallas/leaf_sweep.py``).

Kernel G (``window_sweep_call``) tests every ray of a 128-ray block
against one window of ``WINDOW_TRIS`` consecutive rows of the sorted Woop
table, densely, and keeps each ray's nearest hit: the inner stage of the
cluster sweep (``ops/sweep.py``).  It is CUDA (``csrc/leaf_sweep.cu``,
design notes there).  The wrapper launches it for CUDA tensors, or raises;
for CPU tensors it runs :func:`window_sweep_plain`, the same function in
plain PyTorch (the JAX package's ``_window_sweep_xla``).

Contract (both): ``woop`` (n_pad, 12) rows [M row-major, c]; ``starts``
(NB,) int32 window start rows; ``o``, ``d`` (NB, 128, 3); ``t_min``
(NB, 128); ``best`` = (t, slot, u, v), each (NB, 128).  Returns the new
(t, slot, u, v): where the window holds an accepted row nearer than the
incoming t (the first such row on equal t), its t, ``start + row`` and
its u, v; elsewhere the incoming values.  A start is clamped into
[0, n_pad - WINDOW_TRIS], as ``dynamic_slice`` clamps it.
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.sweep import WINDOW_TRIS
from optix_ray_tracer_tpu_torch.utils.vecmath import INF

BLOCK_RAYS = 128
#: blocks per chunk of the plain version: its (chunk, 128, 256)
#: temporaries stay near 1 GB
_PLAIN_CHUNK = 512


def _clamped_starts(starts, n_pad: int):
    return torch.clamp(starts.long(), 0, n_pad - WINDOW_TRIS)


def window_sweep_plain(woop, starts, o, d, t_min, best):
    """Plain version of kernel G (same arguments and results as
    :func:`window_sweep_call`).  Each Woop row product is summed left to
    right (j = 0, 1, 2), as the kernel sums it; the nearest row is the
    first minimum (``argmin``)."""
    bt_in, slot_in, u_in, v_in = best
    n_pad = woop.shape[0]
    start = _clamped_starts(starts, n_pad)
    rows = torch.arange(WINDOW_TRIS, device=woop.device)
    outs = []
    for b0 in range(0, start.shape[0], _PLAIN_CHUNK):
        sl = slice(b0, b0 + _PLAIN_CHUNK)
        w = woop[start[sl, None] + rows]                # (nb, W, 12)

        def m(k):
            return w[:, None, :, k]                     # (nb, 1, W)

        def c(x, k):
            return x[sl][:, :, k, None]                 # (nb, B, 1)

        ox, oy, oz = c(o, 0), c(o, 1), c(o, 2)
        dx, dy, dz = c(d, 0), c(d, 1), c(d, 2)
        opx = ((m(0) * ox + m(1) * oy) + m(2) * oz) - m(9)
        opy = ((m(3) * ox + m(4) * oy) + m(5) * oz) - m(10)
        opz = ((m(6) * ox + m(7) * oy) + m(8) * oz) - m(11)
        dpx = (m(0) * dx + m(1) * dy) + m(2) * dz
        dpy = (m(3) * dx + m(4) * dy) + m(5) * dz
        dpz = (m(6) * dx + m(7) * dy) + m(8) * dz
        dz_ok = torch.abs(dpz) > 1e-12
        t = (-opz) / torch.where(dz_ok, dpz, torch.full_like(dpz, 1e-12))
        uu = opx + t * dpx
        vv = opy + t * dpy
        bt = bt_in[sl, :, None]
        ok = (dz_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
              & (t > t_min[sl, :, None]) & (t < bt))
        t = torch.where(ok, t, torch.full_like(t, INF))
        li = torch.argmin(t, dim=-1, keepdim=True)      # first minimum
        lt = torch.gather(t, -1, li)[..., 0]
        closer = lt < bt[..., 0]
        slot = (start[sl, None] + li[..., 0]).to(torch.int32)
        outs.append((
            torch.where(closer, lt, bt_in[sl]),
            torch.where(closer, slot, slot_in[sl]),
            torch.where(closer, torch.gather(uu, -1, li)[..., 0], u_in[sl]),
            torch.where(closer, torch.gather(vv, -1, li)[..., 0], v_in[sl])))
    if not outs:
        return bt_in, slot_in, u_in, v_in
    return tuple(torch.cat(x, 0) for x in zip(*outs))


def window_sweep_call(woop, starts, o, d, t_min, best):
    """Kernel G.  Arguments and results as the module docstring says;
    CPU tensors take :func:`window_sweep_plain`."""
    if not o.is_cuda:
        return window_sweep_plain(woop, starts, o, d, t_min, best)
    dev = o.device
    nb = starts.shape[0]
    n_pad = woop.shape[0]
    if n_pad < WINDOW_TRIS or n_pad % WINDOW_TRIS:
        raise ValueError(f"woop has {n_pad} rows, not a positive multiple "
                         f"of {WINDOW_TRIS}")
    bt_in, slot_in, u_in, v_in = best
    _lib.check(woop, "woop", torch.float32, dev, (n_pad, 12))
    _lib.check(starts, "starts", torch.int32, dev, (nb,))
    for name, x in (("o", o), ("d", d)):
        _lib.check(x, name, torch.float32, dev, (nb, BLOCK_RAYS, 3))
    for name, x in (("t_min", t_min), ("best t", bt_in), ("best u", u_in),
                    ("best v", v_in)):
        _lib.check(x, name, torch.float32, dev, (nb, BLOCK_RAYS))
    _lib.check(slot_in, "best slot", torch.int32, dev, (nb, BLOCK_RAYS))
    t = torch.empty_like(bt_in)
    slot = torch.empty_like(slot_in)
    u = torch.empty_like(u_in)
    v = torch.empty_like(v_in)
    if nb:
        _lib.LEAF_SWEEP(dev, woop.data_ptr(), n_pad, starts.data_ptr(), nb,
                        o.data_ptr(), d.data_ptr(), t_min.data_ptr(),
                        bt_in.data_ptr(), slot_in.data_ptr(),
                        u_in.data_ptr(), v_in.data_ptr(), t.data_ptr(),
                        slot.data_ptr(), u.data_ptr(), v.data_ptr())
    return t, slot, u, v
