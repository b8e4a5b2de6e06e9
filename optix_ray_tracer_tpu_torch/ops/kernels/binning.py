"""The raster binning on the card: the (ray block, window) schedules that
kernels A and D run.

Kernel S (:func:`bin_rects_call`) writes the wave's projection basis
(the axis from the geometry's centroid seen from the shared point, or the
shared direction) and each window's margined rect on the projection
plane with its depth range and full-plane flag (from a window's
triangles, or a TLAS pair's world box), or a bundle window's margined
box; T (:func:`bin_count_call`) packs the wave into the
transposed, padded ray rows A and D read, reduces each W-ray block's
bounds, tests every window against them, writes each block's hit mask
(one bit a window) and counts each block's pairs (and scans the counts
into row offsets); U (:func:`bin_emit_call`) reads each block's kept
windows from the mask and writes the schedule, each block's windows
sorted near to far, capped at ``pc_max``.  They are CUDA
(``csrc/binning.cu``; design notes there) and have no Pallas
counterpart: the JAX package bins in plain jnp, which XLA fuses around
the pallas_call.

``ops/raster`` and ``ops/raster_instanced`` call the dispatchers
:func:`bin_rects`, :func:`bin_count` and :func:`bin_emit`: CUDA tensors
go to the kernels, CPU tensors to the plain versions (``*_plain``: the
code the port ran before; :func:`bin_basis_plain` spells out the basis
that ran as eager torch before), which compute the same schedule.  The
``*_call`` wrappers take CUDA tensors only: anything else raises, and so
does a library that fails to build.
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.kernels.tile_raster import GROUP_TRIS
from optix_ray_tracer_tpu_torch.ops.sweep import CHUNK, SUBS_PER_CLUSTER
from optix_ray_tracer_tpu_torch.utils.tensors import nanmax, nanmin
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, dot

GROUPS_PER_CLUSTER = CHUNK // GROUP_TRIS

#: S's window sources: a ClusterSet's triangle windows, TLAS pairs' world
#: boxes, bundle windows' sub boxes
RECTS_CLUSTER, RECTS_PAIR, RECTS_BOX = 0, 1, 2
#: T's and U's modes: the projective modes of ``ops/raster.MODES``, then
#: the bundle binning
MODE_IDS = {"origin": 0, "target": 1, "ortho": 2, "bundle": 3}
#: floats of a block's bounds: projective (bx0, bx1, by0, by1, bz0, bz1,
#: live, 0); bundle, per direction octant (olo, ohi, dlo, dhi, t_lo, t_hi)
RECT_VALS, BOX_VALS = 8, 14
#: U sorts a row of up to this many pairs in shared memory, a longer one
#: in place in its output segment
SHARED_ROW = 8192
#: bits of a hit-mask word
MASK_BITS = 32
#: S's work buffer in floats: the basis, then the centroid's partials and
#: counts (csrc/binning.cu: kWorkHead + 97 kBasisCtas)
BASIS_WORK = 16 + 97 * 128
#: the launch variants S counts, by source
SOURCE_NAMES = {RECTS_CLUSTER: "cluster", RECTS_PAIR: "pair",
                RECTS_BOX: "box"}
#: each dispatcher's plain version with the dispatcher's arguments
TWINS = {"bin_rects": "bin_basis_rects_plain", "bin_count": "bin_count_plain",
         "bin_emit": "bin_emit_plain"}


def _proj(q, basis, persp: bool = True):
    """Projection of rows of q: (x, y, w, good).  NaN rows stay NaN and
    read good=False.  Perspective: rows on or behind the plane (w <= 0)
    read good=False with finite garbage coordinates; orthographic
    (``persp`` False): the raw coordinates, w the depth."""
    u, v, w = basis
    qu, qv, qw = dot(q, u), dot(q, v), dot(q, w)
    if not persp:
        return qu, qv, qw, ~torch.isnan(qu)
    good = qw > 0.0
    den = torch.where(good, qw, torch.ones_like(qw))
    return qu / den, qv / den, qw, good


# ---- S: the projection basis and the window rects --------------------------

def bin_rects(source: int, a, b=None, point=None, granularity: int = 1,
              d=None):
    """Kernel S on CUDA tensors, :func:`bin_basis_plain` then
    :func:`bin_rects_plain` on others: (rects, cfull, basis), cfull and
    basis None for bundle boxes.  ``point``: the shared point (a tuple or
    a tensor) of a perspective wave, None for an orthographic one, whose
    axis is the first row of its directions ``d``."""
    if a.is_cuda:
        return bin_rects_call(source, a, b, point, granularity, d)
    return bin_basis_rects_plain(source, a, b, point, granularity, d)


def bin_basis_rects_plain(source: int, a, b=None, point=None,
                          granularity: int = 1, d=None):
    """Plain version of the whole of kernel S, :func:`bin_rects`'s
    arguments and outputs: :func:`bin_basis_plain`, then
    :func:`bin_rects_plain` on that basis."""
    basis = bin_basis_plain(source, a, b, point, d)
    if point is not None:
        point = torch.as_tensor(point, dtype=torch.float32, device=a.device)
    return (*bin_rects_plain(source, a, b, basis, point, granularity),
            basis)


def _norm(v):
    """|v| of a 3-vector as the kernel rounds it: sqrt((x x + y y) + z z)."""
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _cross(a, b):
    """a x b, each component two products and a subtraction."""
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _frame(wvec):
    """Right-handed orthonormal basis with w along ``wvec``: a (3, 3)
    tensor, rows u, v, w (the JAX package's ``_basis_from``); the clamps
    pass NaN, as torch's do."""
    w = wvec / torch.clamp(_norm(wvec), min=1e-12)
    side = torch.abs(w[0]) < 0.9
    a = torch.stack([torch.where(side, 1.0, 0.0), torch.where(side, 0.0, 1.0),
                     torch.zeros_like(w[0])])
    u = _cross(w, a)
    u = u / torch.clamp(_norm(u), min=1e-12)
    return torch.stack([u, _cross(w, u), w])


def _halving_sum(x):
    """The sum of the rows of x (n, 3) in a fixed tree: the rows padded
    with -0.0 (which adds nothing, bit for bit) to a power of two, then
    ``x[:h] + x[h:]`` until one row is left."""
    n = x.shape[0]
    pad = (1 << max(n - 1, 0).bit_length()) - n
    x = torch.cat([x, torch.full((pad, 3), -0.0, device=x.device)])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def bin_basis_plain(source: int, a, b=None, point=None, d=None):
    """Plain version of kernel S's projection basis, a (3, 3) tensor of
    rows u, v, w (None for RECTS_BOX).  Perspective (``point`` given): w
    along the centroid of the geometry seen from the point: of the vertices
    ``a`` (RECTS_CLUSTER) or the pair centers (a + b) 0.5 (RECTS_PAIR),
    less the point, rows whose x is NaN left out; the sum in the fixed
    tree of :func:`_halving_sum`, over the count of rows kept (at least
    1); (0, 0, 1) where that centroid's norm is at most 1e-12 (the point at
    the centroid).  Orthographic: w along ``d[0]``, the wave's shared
    direction.  The geometry, not the wave, decides it, so any band of a
    wave bins with the whole wave's basis, and the tree's order makes it
    the same bits at every call."""
    if source == RECTS_BOX:
        return None
    if point is None:
        return _frame(d[0])
    p = torch.as_tensor(point, dtype=torch.float32, device=a.device)
    q = ((a + b) * 0.5 if source == RECTS_PAIR else a.reshape(-1, 3)) - p
    keep = ~torch.isnan(q[:, 0])
    total = _halving_sum(torch.where(keep[:, None], q,
                                     torch.full_like(q, -0.0)))
    wvec = total / torch.clamp(keep.sum(), min=1).to(torch.float32)
    up = torch.zeros_like(wvec)
    up[2] = 1.0
    return _frame(torch.where(_norm(wvec) > 1e-12, wvec, up))


def bin_rects_plain(source: int, a, b=None, basis=None, point=None,
                    granularity: int = 1):
    """Plain version of kernel S: (rects (6, C) float32, cfull (C,) bool,
    None for boxes).  Rows of rects: (x0, x1, y0, y1, z0, z1), each
    margined by 1e-5 (|lo| + |hi|) + 1e-6; NaN for a window with no
    point.

    ``source`` RECTS_CLUSTER: ``a`` the (n_pad, 3, 3) sorted vertices
    (``RasterSet.verts``), C = clusters x ``granularity`` windows of
    CHUNK / g triangles, each the union of its 8-triangle groups' rects,
    each group margined on its own; RECTS_PAIR: ``a``, ``b`` the TLAS
    pairs' world boxes (C, 3), each projected through its 8 corners and
    margined once.  Both project onto ``basis`` (a (3, 3) or three rows u,
    v, w) as seen from ``point`` (orthographically where it is None): x,
    y of points in front of the plane, the depth of every point; cfull
    where a point lies on or behind the plane.  RECTS_BOX: ``a``, ``b``
    the sub boxes (C x SUBS_PER_CLUSTER / g, 3): each window's margined
    box, rows (lo x, hi x, lo y, hi y, lo z, hi z)."""
    if source == RECTS_BOX:
        n_subs = SUBS_PER_CLUSTER // granularity
        C = a.shape[0] // n_subs
        clo = nanmin(a.reshape(C, n_subs, 3), 1)
        chi = nanmax(b.reshape(C, n_subs, 3), 1)
        m = 1e-5 * (torch.abs(clo) + torch.abs(chi)) + 1e-6
        clo = clo - m
        chi = chi + m
        return torch.stack([clo[:, 0], chi[:, 0], clo[:, 1], chi[:, 1],
                            clo[:, 2], chi[:, 2]]), None
    persp = point is not None
    if source == RECTS_PAIR:
        rows, per = a.shape[0], 8
        sel = torch.tensor([[(k >> ax) & 1 for ax in range(3)]
                            for k in range(8)], dtype=torch.float32,
                           device=a.device)[None]                # (1, 8, 3)
        q = (a[:, None, :] * (1.0 - sel) + b[:, None, :] * sel
             ).reshape(-1, 3)
    else:
        q = a.reshape(-1, 3)
        per = 3 * GROUP_TRIS
        rows = q.shape[0] // per
    if persp:
        q = q - point
    vx, vy, vw, vgood = _proj(q, basis, persp)
    behind = ~vgood & ~torch.isnan(vx)
    nan = torch.full_like(vx, float("nan"))
    vxm = torch.where(vgood, vx, nan).reshape(rows, per)
    vym = torch.where(vgood, vy, nan).reshape(rows, per)
    vzm = vw.reshape(rows, per)          # depth keeps behind-plane points
    gx0, gx1 = nanmin(vxm, 1), nanmax(vxm, 1)
    gy0, gy1 = nanmin(vym, 1), nanmax(vym, 1)
    gz0, gz1 = nanmin(vzm, 1), nanmax(vzm, 1)
    gfull = behind.reshape(rows, per).any(1)
    # conservative margin: dominates fp projection error (rel ~1e-7)
    mx = 1e-5 * (torch.abs(gx0) + torch.abs(gx1)) + 1e-6
    my = 1e-5 * (torch.abs(gy0) + torch.abs(gy1)) + 1e-6
    mz = 1e-5 * (torch.abs(gz0) + torch.abs(gz1)) + 1e-6
    lo_hi = (gx0 - mx, gx1 + mx, gy0 - my, gy1 + my, gz0 - mz, gz1 + mz)
    if source == RECTS_PAIR:
        return torch.stack(lo_hi), gfull
    G = GROUPS_PER_CLUSTER // granularity
    C = rows // G
    return (torch.stack([(nanmin if k % 2 == 0 else nanmax)(
        x.reshape(C, G), 1) for k, x in enumerate(lo_hi)]),
        gfull.reshape(C, G).any(1))


# ---- T: block bounds and pair counts ---------------------------------------

def bin_count(o, d, t_min, t_max, W: int, mode: str, rects, cfull=None,
              basis=None, point=None, dir_octants: bool = True):
    """Kernel T on CUDA tensors, :func:`bin_count_plain` on others."""
    if o.is_cuda:
        return bin_count_call(o, d, t_min, t_max, W, mode, rects, cfull,
                              basis, point, dir_octants)
    return bin_count_plain(o, d, t_min, t_max, W, mode, rects, cfull, basis,
                           point, dir_octants)


def _pad_wave(o, d, t_min, t_max, n: int, nb: int, W: int):
    """Pad a wave to nb*W rays plus one trailing dead block; padded lanes
    are dead (t_max <= t_min)."""
    dev = o.device
    t_min_a = torch.as_tensor(t_min, dtype=torch.float32, device=dev
                              ).expand(n)
    t_max_a = torch.clamp(torch.as_tensor(t_max, dtype=torch.float32,
                                          device=dev).expand(n), max=INF)
    pad = nb * W - n + W
    dead_d = torch.zeros((pad, 3), device=dev)
    dead_d[:, 2] = 1.0
    return (torch.cat([o, torch.zeros((pad, 3), device=dev)]),
            torch.cat([d, dead_d]),
            torch.cat([t_min_a, torch.ones(pad, device=dev)]),
            torch.cat([t_max_a, torch.zeros(pad, device=dev)]))


def _block_rects(o_p, d_p, tmin_p, tmax_p, nb: int, W: int, basis,
                 mode: str, point):
    """Per-block ray rects and depth ranges on the projection plane:
    (nb, RECT_VALS) rows (bx0, bx1, by0, by1, bz0, bz1, live_any, 0)."""
    if mode == "origin":
        q_rays = d_p[:nb * W]
    elif mode == "ortho":
        q_rays = o_p[:nb * W]
    else:
        q_rays = (o_p - point)[:nb * W]
    rx, ry, rqw, rgood = _proj(q_rays, basis, mode != "ortho")
    tmin_r = tmin_p[:nb * W]
    tmax_r = tmax_p[:nb * W]
    live = tmax_r > tmin_r
    pv = rgood & live
    nan = torch.full_like(rx, float("nan"))
    pxm = torch.where(pv, rx, nan).reshape(nb, W)
    pym = torch.where(pv, ry, nan).reshape(nb, W)
    live_any = live.reshape(nb, W).any(1)
    # depth along a ray is w0 + t * (d . w_basis) for every ray (no
    # division): segments only need geometry inside their depth interval
    if mode == "origin":
        wd = rqw
        w0 = torch.zeros_like(wd)
    else:
        wd = dot(d_p[:nb * W], basis[2])
        w0 = rqw
    dlo = w0 + torch.minimum(tmin_r * wd, tmax_r * wd)
    dhi = w0 + torch.maximum(tmin_r * wd, tmax_r * wd)
    bz0 = torch.where(live, dlo, torch.full_like(dlo, INF)
                      ).reshape(nb, W).amin(1)
    bz1 = torch.where(live, dhi, torch.full_like(dhi, -INF)
                      ).reshape(nb, W).amax(1)
    return torch.stack([nanmin(pxm, 1), nanmax(pxm, 1), nanmin(pym, 1),
                        nanmax(pym, 1), bz0, bz1, live_any.to(torch.float32),
                        torch.zeros_like(bz0)], 1)


def _lane_bounds(ob, db, tmin_b, tmax_b, live):
    """(nb, BOX_VALS) componentwise origin and direction intervals and the
    t range of the lanes ``live`` of each block; +-INF where none is."""
    lv = live[..., None]
    olo = torch.where(lv, ob, INF).amin(1)                # (nb, 3)
    ohi = torch.where(lv, ob, -INF).amax(1)
    dlo = torch.where(lv, db, INF).amin(1)
    dhi = torch.where(lv, db, -INF).amax(1)
    t_lo_b = torch.where(live, tmin_b, INF).amin(1)
    t_hi_b = torch.where(live, tmax_b, -INF).amax(1)
    return torch.cat([olo, ohi, dlo, dhi, t_lo_b[:, None], t_hi_b[:, None]],
                     1)


def _bundle_bounds(o_p, d_p, tmin_p, tmax_p, nb: int, W: int,
                   dir_octants: bool):
    """(nb, Q, BOX_VALS) bounds of each block's live lanes, per direction
    octant (Q = 8, octant (dx > 0) + 2 (dy > 0) + 4 (dz > 0)) or over them
    all (Q = 1)."""
    live_all = (tmax_p > tmin_p)[:nb * W].reshape(nb, W)
    ob = o_p[:nb * W].reshape(nb, W, 3)
    db = d_p[:nb * W].reshape(nb, W, 3)
    tmin_b = tmin_p[:nb * W].reshape(nb, W)
    tmax_b = tmax_p[:nb * W].reshape(nb, W)
    if not dir_octants:
        return _lane_bounds(ob, db, tmin_b, tmax_b, live_all)[:, None]
    oct_id = ((db[..., 0] > 0).to(torch.int64)
              + 2 * (db[..., 1] > 0).to(torch.int64)
              + 4 * (db[..., 2] > 0).to(torch.int64))
    return torch.stack([_lane_bounds(ob, db, tmin_b, tmax_b,
                                     live_all & (oct_id == q))
                        for q in range(8)], 1)


def _box_test(bnd, clo, chi):
    """(ov (nb, C) bool, entry t (nb, C)) of the windows' margined boxes
    (clo, chi (C, 3)) against one octant's block bounds ``bnd`` (nb,
    BOX_VALS): interval arithmetic admits some t >= 0 with [olo + t dlo,
    ohi + t dhi] overlapping the box on every axis, inside the block's
    [t_lo, t_hi]."""
    nb, C = bnd.shape[0], clo.shape[0]
    olo, ohi, dlo, dhi = bnd[:, 0:3], bnd[:, 3:6], bnd[:, 6:9], bnd[:, 9:12]
    t_lo_b, t_hi_b = bnd[:, 12], bnd[:, 13]
    eps = 1e-12
    lo_t = torch.zeros((nb, C), device=bnd.device)
    hi_t = torch.full((nb, C), INF, device=bnd.device)
    for ax in range(3):
        u = chi[None, :, ax] - olo[:, None, ax]   # want t dlo <= u
        v = clo[None, :, ax] - ohi[:, None, ax]   # want t dhi >= v
        dl = dlo[:, None, ax]
        dh = dhi[:, None, ax]
        hi1 = torch.where(dl > eps, u / torch.where(dl > eps, dl, 1.0), INF)
        lo1 = torch.where(dl < -eps, u / torch.where(dl < -eps, dl, 1.0),
                          0.0)
        hi2 = torch.where(dh < -eps, v / torch.where(dh < -eps, dh, 1.0),
                          INF)
        lo2 = torch.where(dh > eps, v / torch.where(dh > eps, dh, 1.0), 0.0)
        lo_t = torch.maximum(lo_t, torch.maximum(lo1, lo2))
        hi_t = torch.minimum(hi_t, torch.minimum(hi1, hi2))
    # relative margins swallow the divisions' rounding
    lo_t = lo_t - (torch.abs(lo_t) * 1e-6 + 1e-8)
    hi_t = hi_t + (torch.abs(hi_t) * 1e-6 + 1e-8)
    lo_eff = torch.maximum(lo_t, t_lo_b[:, None])
    hi_eff = torch.minimum(hi_t, t_hi_b[:, None])
    # NaN anywhere (padded windows) compares False
    return lo_eff <= hi_eff, lo_eff


def _overlap(mode: str, rects, cfull, bounds):
    """(ov (nb, C) bool, the depth-sort key: (C,) projective, (nb, C)
    bundle) of every (block, window) pair: the projective rect, depth and
    full-plane test, or the bundle interval test OR'd over the octants,
    keyed by the smallest admitted entry t.  A block with no live lane
    admits nothing (its bounds are NaN / +-INF)."""
    if mode != "bundle":
        bx0, bx1, by0, by1, bz0, bz1, live = bounds.T[:7]
        cx0, cx1, cy0, cy1, cz0, cz1 = rects
        ov = ((bx0[:, None] <= cx1[None, :]) & (bx1[:, None] >= cx0[None, :])
              & (by0[:, None] <= cy1[None, :])
              & (by1[:, None] >= cy0[None, :]))
        ovz = (bz0[:, None] <= cz1[None, :]) & (bz1[:, None] >= cz0[None, :])
        return (ov | cfull[None, :]) & ovz & (live != 0)[:, None], cz0
    clo, chi = rects[0::2].T, rects[1::2].T
    if bounds.shape[1] == 1:
        return _box_test(bounds[:, 0], clo, chi)
    nb, C = bounds.shape[0], clo.shape[0]
    ov = torch.zeros((nb, C), dtype=torch.bool, device=bounds.device)
    lo_key = torch.full((nb, C), INF, device=bounds.device)
    for q in range(bounds.shape[1]):
        ov_q, lo_q = _box_test(bounds[:, q], clo, chi)
        ov = ov | ov_q
        lo_key = torch.minimum(lo_key, torch.where(ov_q, lo_q, INF))
    return ov, lo_key


def bin_count_plain(o, d, t_min, t_max, W: int, mode: str, rects,
                    cfull=None, basis=None, point=None,
                    dir_octants: bool = True):
    """Plain version of kernel T: (rays, cnt_b, offs, bounds, mask) of a wave
    (o, d (n, 3), t_min, t_max: (n,) tensors or one value) in W-ray
    blocks, nb = ceil(n / W) of them.  rays: the (8, (nb + 1) W) rows [o,
    d, t_min, min(t_max, INF)] padded with dead rays (o 0, d (0, 0, 1),
    t_min 1, t_max 0) through one trailing dead block; bounds: each
    block's live lanes' (nb, RECT_VALS) projective rect on ``basis`` seen
    from ``point`` (:func:`_block_rects`; ``mode`` "origin", "target" or
    "ortho") or (nb, Q, BOX_VALS) bundle intervals (``mode`` "bundle",
    Q = 8 octants with ``dir_octants``, else 1); cnt_b (nb,) int32: the
    windows (``rects``, ``cfull`` of S) that pass :func:`_overlap`; offs
    (nb + 1,) int32: its exclusive cumsum, offs[nb] the pair total; mask:
    those windows as bits (:func:`pack_mask`)."""
    n = o.shape[0]
    nb = -(-n // W)
    o_p, d_p, tmin_p, tmax_p = _pad_wave(o, d, t_min, t_max, n, nb, W)
    rays = torch.cat([o_p.T, d_p.T, tmin_p[None, :], tmax_p[None, :]],
                     0).contiguous()
    if mode == "bundle":
        bounds = _bundle_bounds(o_p, d_p, tmin_p, tmax_p, nb, W, dir_octants)
    else:
        bounds = _block_rects(o_p, d_p, tmin_p, tmax_p, nb, W, basis, mode,
                              point)
    ov = _overlap(mode, rects, cfull, bounds)[0]
    cnt_b = ov.to(torch.int64).sum(1)
    offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=o.device),
                      torch.cumsum(cnt_b, 0)])
    return (rays, cnt_b.to(torch.int32), offs.to(torch.int32), bounds,
            pack_mask(ov))


def pack_mask(ov):
    """The (nb, ceil(C / 32)) int32 hit mask of an (nb, C) overlap matrix:
    bit c % 32 of word c // 32 set where window c passes."""
    nb, C = ov.shape
    words = -(-C // MASK_BITS)
    bits = torch.zeros((nb, words * MASK_BITS), dtype=torch.int64,
                       device=ov.device)
    bits[:, :C] = ov.to(torch.int64)
    w = (bits.reshape(nb, words, MASK_BITS)
         << torch.arange(MASK_BITS, device=ov.device)).sum(2)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_mask(mask, C: int):
    """The (nb, C) bool overlap matrix of a hit mask (:func:`pack_mask`)."""
    w = mask.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> torch.arange(MASK_BITS, device=mask.device)) & 1
    return bits.reshape(mask.shape[0], -1)[:, :C].bool()


# ---- U: the sorted pair schedule -------------------------------------------

def bin_emit(rects, bounds, cnt_b, offs, mask, pc_max: int, mode: str,
             lib_of=None, inst_of=None) -> dict:
    """Kernel U on CUDA tensors, :func:`bin_emit_plain` on others."""
    if bounds.is_cuda:
        return bin_emit_call(rects, bounds, cnt_b, offs, mask, pc_max, mode,
                             lib_of, inst_of)
    return bin_emit_plain(rects, bounds, cnt_b, offs, mask, pc_max, mode,
                          lib_of, inst_of)


def _rank_lookup(cum_rows, flat_dim: int, row_idx, rank):
    """Smallest column c with cum_rows[row, c] >= rank + 1, by bisection
    over the flattened inclusive row-cumsum matrix."""
    flat = cum_rows.reshape(-1)
    lo = torch.zeros_like(row_idx)
    hi = torch.full_like(row_idx, flat_dim - 1)
    for _ in range(max(1, (flat_dim - 1).bit_length())):
        mid = (lo + hi) // 2
        ge = flat[row_idx * flat_dim + mid] >= rank + 1
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    return hi


def _enumerate_sorted_pairs(ov, entry_depth, nb: int, C: int, pc_max: int):
    """Enumerate the True cells of the (nb, C) overlap matrix into flat
    (block, window) lists capped at ``pc_max`` (fixed shapes, no host
    read), stable-sorted by (block, entry depth) so each tile sees its
    windows near to far.  ``entry_depth`` is per window (C,) or per
    (block, window) (nb, C).  Returns (b_i, c_i, validc); b_i, c_i
    int32."""
    dev = ov.device
    ovi = ov.to(torch.int64)
    cnt_b = ovi.sum(1)
    cum_b = torch.cumsum(cnt_b, 0)
    pc_total = cum_b[-1]
    i = torch.arange(pc_max, device=dev)
    b_i = torch.clamp(torch.searchsorted(cum_b, i, right=True), max=nb - 1)
    validc = i < pc_total
    j = i - (cum_b[b_i] - cnt_b[b_i])
    c_i = _rank_lookup(torch.cumsum(ovi, 1), C, b_i, j)
    key_tile = torch.where(validc, b_i, torch.full_like(b_i, nb))
    ent = (entry_depth.reshape(-1)[b_i * C + c_i] if entry_depth.dim() == 2
           else entry_depth[c_i])
    key_depth = torch.where(validc, ent, torch.full_like(ent, INF))
    # lexicographic stable sort: by depth, then (stably) by tile
    o1 = torch.argsort(key_depth, stable=True)
    perm = o1[torch.argsort(key_tile[o1], stable=True)]
    return (b_i[perm].to(torch.int32), c_i[perm].to(torch.int32),
            validc[perm])


def bin_emit_plain(rects, bounds, cnt_b, offs, mask, pc_max: int,
                   mode: str, lib_of=None, inst_of=None) -> dict:
    """Plain version of kernel U: the schedule of T's hit ``mask``, capped
    at ``pc_max`` (the first pc_max pairs in (block, window) order, then
    each block's sorted by key, equal keys in window order; the mask
    already holds the windows' full-plane flags).  The key is a window's
    near depth (rects[4]), or for bundles the smallest entry t that
    :func:`_overlap` admits from T's ``bounds``.  A dict of
    (pc_max,) tensors: b_i, c_i (int32), validc (bool); slots past the
    pair total hold (nb - 1, C - 1, False); pair_tiles, pair_clusters
    (int32): b_i, c_i where valid, else nb and 0 (kernel A's and D's pair
    arrays); with the TLAS pairs' tables ``lib_of``, ``inst_of`` (C,)
    int32, pair_libs and pair_insts: each slot's pair_clusters entry
    looked up.  (``cnt_b`` and ``offs``, T's counts, are the kernel's
    inputs; the plain version counts again.)"""
    key = (_overlap(mode, rects, None, bounds)[1] if mode == "bundle"
           else rects[4])
    ov = unpack_mask(mask, rects.shape[1])
    nb, C = ov.shape
    b_i, c_i, validc = _enumerate_sorted_pairs(ov, key, nb, C, pc_max)
    out = dict(b_i=b_i, c_i=c_i, validc=validc,
               pair_tiles=torch.where(validc, b_i, torch.full_like(b_i, nb)),
               pair_clusters=torch.where(validc, c_i, torch.zeros_like(c_i)))
    if lib_of is not None:
        ids = out["pair_clusters"].long()
        out["pair_libs"] = lib_of[ids].to(torch.int32)
        out["pair_insts"] = inst_of[ids].to(torch.int32)
    return out


# ---- the kernels' wrappers -------------------------------------------------

def _device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"tensors are on {t.device}: the kernels take CUDA "
                         f"tensors (CPU tensors take the plain versions)")
    return t.device


def _flat(t, name: str, dtype, dev, n: int):
    """``t`` as a contiguous tensor of n elements (a copy only where it is
    not one already); raises unless it is a ``dtype`` tensor on ``dev``."""
    if t.device != dev or t.dtype != dtype:
        raise ValueError(f"{name} is a {t.dtype} tensor on {t.device}, "
                         f"expected {dtype} on {dev}")
    if t.numel() != n:
        raise ValueError(f"{name} has {t.numel()} elements, expected {n}")
    return t.contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rows3(t, name: str, dev, n: int):
    """(tensor, step) of an (n, 3) float32 tensor: row i at t[3 i], or
    step 0 for one row expanded over the wave."""
    if t.dim() == 2 and t.shape == (n, 3) and t.stride() == (0, 1):
        return _flat(t[0], name, torch.float32, dev, 3), 0
    return _flat(t, name, torch.float32, dev, 3 * n), 3


def _bound(t, name: str, dev, n: int):
    """(tensor, step) of a per-ray bound (a tensor or a number), as
    ``_pad_wave`` casts it: element i at t[i * step], step 0 for one value
    broadcast over the wave."""
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    if t.dim() == 0 or (t.dim() == 1 and t.shape[0] == n and t.stride(0) == 0
                        and n):
        return _flat(t.reshape(-1)[:1], name, torch.float32, dev, 1), 0
    return _flat(t, name, torch.float32, dev, n), 1


def _basis(basis, dev):
    """The basis as a contiguous (3, 3) float32 tensor (rows u, v, w)."""
    b = basis if isinstance(basis, torch.Tensor) else torch.stack(basis)
    return _flat(b, "basis", torch.float32, dev, 9)


def bin_rects_call(source: int, a, b=None, point=None,
                   granularity: int = 1, d=None):
    """Kernel S: :func:`bin_rects`'s (rects, cfull, basis) on the card,
    the basis :func:`bin_basis_plain`'s.  A point in device memory is
    read there; any other (a tuple, a CPU tensor) goes by value, and no
    device value is read on the host.  ``basis`` is a view of S's work
    buffer."""
    dev = _device(a)
    cfull = basis = work = p_dev = wdir = None
    pv = (0.0, 0.0, 0.0)
    if source == RECTS_BOX:
        per = SUBS_PER_CLUSTER // granularity
        rows = a.shape[0]
        n_items = C = rows // per
        a = _flat(a, "sub_min", torch.float32, dev, 3 * rows)
        b = _flat(b, "sub_max", torch.float32, dev, 3 * rows)
    else:
        if source == RECTS_PAIR:
            per = 1
            n_items = C = a.shape[0]
            a = _flat(a, "pair_min", torch.float32, dev, 3 * C)
            b = _flat(b, "pair_max", torch.float32, dev, 3 * C)
        else:
            per = GROUPS_PER_CLUSTER // granularity
            n_items = a.numel() // (9 * GROUP_TRIS)
            C = n_items // per
            a = _flat(a, "verts", torch.float32, dev, a.numel())
            b = None
        if point is None:
            wdir = _flat(d[0], "d", torch.float32, dev, 3)
        elif isinstance(point, torch.Tensor) and point.is_cuda:
            p_dev = _flat(point, "point", torch.float32, dev, 3)
        else:
            pv = torch.as_tensor(point, dtype=torch.float32).reshape(3
                                                                     ).tolist()
        work = torch.empty(BASIS_WORK, dtype=torch.float32, device=dev)
        basis = work[:9].view(3, 3)
        cfull = torch.empty(C, dtype=torch.bool, device=dev)
    rects = torch.empty((6, C), dtype=torch.float32, device=dev)
    _lib.BIN_RECTS(dev, source, a.data_ptr(), _ptr(b), _ptr(p_dev), *pv,
                   int(point is not None), _ptr(wdir), per, n_items, C,
                   rects.data_ptr(), _ptr(cfull), _ptr(work),
                   variant=SOURCE_NAMES[source])
    return rects, cfull, basis


def bin_count_call(o, d, t_min, t_max, W: int, mode: str, rects, cfull=None,
                   basis=None, point=None, dir_octants: bool = True):
    """Kernel T: :func:`bin_count_plain`'s (rays, cnt_b, offs, bounds,
    mask) on the card.  ``o``, ``d``: (n, 3), contiguous or one row
    expanded.  The outputs are views of two allocations, one float32
    (rays, bounds), one int32 (cnt_b, offs, mask)."""
    dev = _device(o)
    n = o.shape[0]
    if n == 0:
        raise ValueError("the binning takes a wave of at least one ray")
    nb = -(-n // W)
    C = rects.shape[1]
    mode_id = MODE_IDS[mode]
    o, o_step = _rows3(o, "o", dev, n)
    d, d_step = _rows3(d, "d", dev, n)
    tmin, tmin_step = _bound(t_min, "t_min", dev, n)
    tmax, tmax_step = _bound(t_max, "t_max", dev, n)
    rects = _flat(rects, "rects", torch.float32, dev, 6 * C)
    if mode == "bundle":
        n_oct = 8 if dir_octants else 1
        shape = (nb, n_oct, BOX_VALS)
        basis = point = None
    else:
        n_oct = 1
        cfull = _flat(cfull, "cfull", torch.bool, dev, C)
        basis = _basis(basis, dev)
        point = (_flat(point, "point", torch.float32, dev, 3)
                 if mode == "target" else None)
        shape = (nb, RECT_VALS)
    n_rays = 8 * (nb + 1) * W
    words = -(-C // MASK_BITS)
    floats = torch.empty(n_rays + nb * n_oct * shape[-1], device=dev)
    ints = torch.empty(2 * nb + 2 + nb * words, dtype=torch.int32,
                       device=dev)
    rays = floats[:n_rays].view(8, (nb + 1) * W)
    bounds = floats[n_rays:].view(shape)
    cnt_b, offs = ints[:nb], ints[nb:2 * nb + 2]
    mask = ints[2 * nb + 2:].view(nb, words)
    _lib.BIN_COUNT(dev, mode_id, n_oct, o.data_ptr(), o_step, d.data_ptr(),
                   d_step, tmin.data_ptr(), tmin_step, tmax.data_ptr(),
                   tmax_step, n, W, nb, _ptr(basis), _ptr(point),
                   rects.data_ptr(), _ptr(cfull), C, rays.data_ptr(),
                   bounds.data_ptr(), cnt_b.data_ptr(), offs.data_ptr(),
                   mask.data_ptr(), variant=mode)
    return rays, cnt_b, offs[:nb + 1], bounds, mask


def shared_row(C: int) -> int:
    """U's shared-memory row: the power of two >= C, at most
    SHARED_ROW."""
    return min(1 << max(C - 1, 0).bit_length(), SHARED_ROW)


def bin_emit_call(rects, bounds, cnt_b, offs, mask, pc_max: int,
                  mode: str, lib_of=None, inst_of=None) -> dict:
    """Kernel U: :func:`bin_emit_plain`'s schedule on the card, from T's
    ``mask``."""
    dev = _device(bounds)
    nb = cnt_b.shape[0]
    C = rects.shape[1]
    mode_id = MODE_IDS[mode]
    rects = _flat(rects, "rects", torch.float32, dev, 6 * C)
    if mode == "bundle":
        n_oct = bounds.shape[1]
        bounds = _flat(bounds, "bounds", torch.float32, dev,
                       nb * n_oct * BOX_VALS)
    else:
        n_oct = 1
        bounds = _flat(bounds, "bounds", torch.float32, dev, nb * RECT_VALS)
    cnt_b = _flat(cnt_b, "cnt_b", torch.int32, dev, nb)
    offs = _flat(offs, "offs", torch.int32, dev, nb + 1)
    mask = _flat(mask, "mask", torch.int32, dev, nb * -(-C // MASK_BITS))
    if lib_of is not None:
        lib_of = _flat(lib_of, "lib_of", torch.int32, dev, C)
        inst_of = _flat(inst_of, "inst_of", torch.int32, dev, C)
    out = dict(b_i=torch.empty(pc_max, dtype=torch.int32, device=dev),
               c_i=torch.empty(pc_max, dtype=torch.int32, device=dev),
               validc=torch.empty(pc_max, dtype=torch.bool, device=dev),
               pair_tiles=torch.empty(pc_max, dtype=torch.int32, device=dev),
               pair_clusters=torch.empty(pc_max, dtype=torch.int32,
                                         device=dev))
    if lib_of is not None:
        out["pair_libs"] = torch.empty(pc_max, dtype=torch.int32, device=dev)
        out["pair_insts"] = torch.empty(pc_max, dtype=torch.int32,
                                        device=dev)
    _lib.BIN_EMIT(dev, mode_id, n_oct, nb, C, pc_max, shared_row(C),
                  rects.data_ptr(), bounds.data_ptr(),
                  cnt_b.data_ptr(), offs.data_ptr(), mask.data_ptr(),
                  _ptr(lib_of), _ptr(inst_of), *(out[k].data_ptr() for k in (
                      "b_i", "c_i", "validc", "pair_tiles", "pair_clusters")),
                  _ptr(out.get("pair_libs")), _ptr(out.get("pair_insts")),
                  variant=mode)
    return out
