"""The plain reference's shared parts: vector helpers, the counter RNG the
renderer's contract fixes (PCG4D, Jarzynski and Olano, JCGT 2020, keyed by
pixel, sample, bounce and seed), the pinhole camera, and a ray caster
over triangle groups.

Plain PyTorch.  Imports nothing of the program and nothing of JAX.  The
caster bounds each group of triangles (a particle, a quad, 64 triangles of
a mesh) by a sphere and 64 groups in Morton order by a sphere of their
own; a ray visits the groups whose spheres it enters, nearest entry first,
and stops once its nearest hit lies before the next group's entry.  Its
triangle test is Moller-Trumbore, in the precision ``dtype`` asks for
(float32, or bfloat16 for the control).
"""

from __future__ import annotations

import dataclasses

import torch

INF = 1e16          # the renderer's miss distance
PI = 3.1415926      # the renderer's truncated constant
EPS = 1e-6
T_MIN = 1e-3        # the renderer's default ray start
MASK = 0xFFFFFFFF


def dot(a, b, keepdims: bool = False):
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r.unsqueeze(-1) if keepdims else r


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    """Zero vectors stay zero."""
    n2 = dot(v, v, True)
    inv = torch.where(n2 > 0.0, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-30)),
                      torch.zeros_like(n2))
    return v * inv


def reflect(v, n):
    return v - 2.0 * dot(v, n, True) * n


# ---- the counter RNG --------------------------------------------------------

def _mul32(a, b):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _lane(v, device):
    if isinstance(v, int):
        return torch.tensor(v & MASK, dtype=torch.int64, device=device)
    return v.to(torch.int64) & MASK


def pcg4d(a, b, c, d):
    """PCG4D of four broadcastable int tensors or ints: four int64 tensors
    holding uint32 values."""
    dev = next(v.device for v in (a, b, c, d) if isinstance(v, torch.Tensor))
    x, y, z, w = torch.broadcast_tensors(*(_lane(v, dev) for v in (a, b, c, d)))
    x, y, z, w = ((_mul32(v, 1664525) + 1013904223) & MASK
                  for v in (x, y, z, w))
    for _ in range(2):
        x = (x + _mul32(y, w)) & MASK
        y = (y + _mul32(z, x)) & MASK
        z = (z + _mul32(x, y)) & MASK
        w = (w + _mul32(y, z)) & MASK
        if _ == 0:
            x, y, z, w = (v ^ (v >> 16) for v in (x, y, z, w))
    return x, y, z, w


def uniform4(pixel, sample, bounce, seed):
    """Four U[0, 1) float32 draws from the top 24 bits of PCG4D."""
    return tuple((v >> 8).to(torch.float32) * float(1.0 / (1 << 24))
                 for v in pcg4d(pixel, sample, bounce, seed))


def cos_sin(phi):
    """cos and sin of float32 angles through float64, rounded."""
    p = phi.to(torch.float64)
    return torch.cos(p).to(torch.float32), torch.sin(p).to(torch.float32)


def unit_vector(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    c, s = cos_sin((2.0 * PI) * u2)
    return torch.stack([r * c, r * s, z], -1)


def jitter(pixel, sample, seed):
    """Sub-pixel offsets: a 4x4 grid cell by sample, a PCG draw inside."""
    u1, u2, _, _ = uniform4(pixel, sample, -1, seed)
    cell = sample % 16
    return ((cell % 4).to(torch.float32) + u1) * 0.25, \
        ((cell // 4).to(torch.float32) + u2) * 0.25


# ---- the camera -------------------------------------------------------------

@dataclasses.dataclass
class Camera:
    """Pinhole camera: |w| = |target - center| sets the field of view."""
    center: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor

    @staticmethod
    def look_at(center, target, up, device) -> "Camera":
        f = dict(dtype=torch.float32, device=device)
        center = torch.as_tensor(center, **f)
        target = torch.as_tensor(target, **f)
        up = normalize(torch.as_tensor(up, **f))
        w = target - center
        u = normalize(cross(w, up))
        return Camera(center, u, normalize(cross(u, w)), w)

    def rays(self, width: int, height: int, ox=0.5, oy=0.5):
        """Rays through pixel (ix, iy) + (ox, oy), row 0 at the top; ox, oy
        scalars or (H, W) maps.  Returns (origins, dirs), (H * W, 3)."""
        dev = self.center.device
        iy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
        ix = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
        nx = ((ix + ox) / width) * 2.0 - 1.0
        ny = 1.0 - ((iy + oy) / height) * 2.0
        nx, ny = torch.broadcast_tensors(nx, ny)
        d = (nx[..., None] * (width / height) * self.u
             + ny[..., None] * self.v + self.w)
        d = normalize(d).reshape(-1, 3)
        return self.center.expand(d.shape), d


# ---- the ray caster ---------------------------------------------------------

SUPER = 64          # groups under one bounding sphere of the upper level


def _spread(x):
    """The 10 low bits of x spread to every third bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


@dataclasses.dataclass
class Groups:
    """Triangles in G groups of at most K, each group bounded by a sphere,
    and the groups in Morton order of their centres, SUPER at a time,
    under spheres of their own.

    v0, e1, e2: (G, K, 3); ok: (G, K) bool (padding False); prim: (G, K)
    int64 scene triangle id; center (G, 3), radius (G,); members (S,
    SUPER) group ids, -1 padding; s_center (S, 3), s_radius (S,)."""
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    ok: torch.Tensor
    prim: torch.Tensor
    center: torch.Tensor
    radius: torch.Tensor
    members: torch.Tensor
    s_center: torch.Tensor
    s_radius: torch.Tensor

    @staticmethod
    def build(tris, group_of, n_groups: int) -> "Groups":
        """tris (T, 3, 3) float32; group_of (T,) int64 group id of each
        triangle (any order)."""
        dev = tris.device
        order = torch.argsort(group_of, stable=True)
        g_sorted = group_of[order]
        counts = torch.bincount(g_sorted, minlength=n_groups)
        K = max(int(counts.max()), 1)
        start = torch.cumsum(counts, 0) - counts
        slot = torch.arange(len(order), device=dev) - start[g_sorted]
        P = torch.zeros((n_groups, K, 3, 3), device=dev)
        P[g_sorted, slot] = tris[order]
        ok = torch.zeros((n_groups, K), dtype=torch.bool, device=dev)
        ok[g_sorted, slot] = True
        prim = torch.full((n_groups, K), -1, dtype=torch.int64, device=dev)
        prim[g_sorted, slot] = order
        v0 = P[:, :, 0]
        e1 = P[:, :, 1] - v0
        e2 = P[:, :, 2] - v0
        inf = torch.tensor(float("inf"), device=dev)
        m = ok[..., None, None]
        lo = torch.where(m, P, inf).amin((1, 2))
        hi = torch.where(m, P, -inf).amax((1, 2))
        center = 0.5 * (lo + hi)
        r = torch.where(ok[..., None], (P - center[:, None, None]).norm(dim=-1),
                        torch.zeros((), device=dev))
        # room for rounding in the culling tests below
        radius = r.amax((1, 2)) * 1.001 + 1e-3 + 1e-6 * center.norm(dim=-1)
        # the upper level
        c0 = center.amin(0)
        span = torch.clamp(center.amax(0) - c0, min=1e-9)
        q = torch.clamp(((center - c0) / span * 1023).long(), 0, 1023)
        code = (_spread(q[:, 0]) << 2) | (_spread(q[:, 1]) << 1) | _spread(q[:, 2])
        S = -(-n_groups // SUPER)
        members = torch.full((S * SUPER,), -1, dtype=torch.int64, device=dev)
        members[:n_groups] = torch.argsort(code)
        members = members.reshape(S, SUPER)
        valid = members >= 0
        mc = center[members.clamp(min=0)]
        mr = radius[members.clamp(min=0)][..., None]
        lo = torch.where(valid[..., None], mc - mr, inf).amin(1)
        hi = torch.where(valid[..., None], mc + mr, -inf).amax(1)
        s_center = 0.5 * (lo + hi)
        s_r = torch.where(valid, (mc - s_center[:, None]).norm(dim=-1)
                          + mr[..., 0], torch.zeros((), device=dev)).amax(1)
        s_radius = s_r * 1.001 + 1e-3 + 1e-6 * s_center.norm(dim=-1)
        return Groups(v0, e1, e2, ok, prim, center, radius, members,
                      s_center, s_radius)


def _enter(c, r, o, d, t0, t1):
    """Entry distance of rays into spheres (broadcast), INF where the
    segment [t0, t1] misses the sphere."""
    a = dot(d, d)
    oc = c - o
    b = dot(d, oc) / a
    dist2 = dot(oc, oc) - b * b * a
    half = torch.sqrt(torch.clamp((r * r - dist2) / a, min=0.0))
    ent, ext = b - half, b + half
    hit = (dist2 <= r * r) & (ext >= t0) & (ent <= t1)
    return torch.where(hit, torch.maximum(ent, t0), torch.full_like(ent, INF))


def _candidates(G: Groups, o, d, t0, t1):
    """Each ray's groups whose sphere its segment enters: (ray, group,
    entry) sorted by ray, then entry."""
    ray, sup = torch.nonzero(_enter(G.s_center[None], G.s_radius[None],
                                    o[:, None], d[:, None], t0[:, None],
                                    t1[:, None]) < INF, as_tuple=True)
    g = G.members[sup]
    ray = ray[:, None].expand_as(g)
    keep = g >= 0
    ray, g = ray[keep], g[keep]
    e = _enter(G.center[g], G.radius[g], o[ray], d[ray], t0[ray], t1[ray])
    keep = e < INF
    ray, g, e = ray[keep], g[keep], e[keep]
    order = torch.argsort(e)
    order = order[torch.argsort(ray[order], stable=True)]
    return ray[order], g[order], e[order]


def _test(G: Groups, g, o, d, t0, best, dtype):
    """Moller-Trumbore of rays (n,) against all triangles of their group g:
    (t, k, u, v) of each ray's nearest hit in (t0, best), t INF where
    none."""
    v0, e1, e2 = (x[g].to(dtype) for x in (G.v0, G.e1, G.e2))
    o = o.to(dtype)[:, None]
    d = d.to(dtype)[:, None].expand_as(e2)
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok_det = torch.abs(det) > 1e-9
    inv = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv
    t = (dot(e2, qvec) * inv).float()
    hit = (ok_det & G.ok[g] & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t0[:, None]) & (t < best[:, None]))
    t = torch.where(hit, t, torch.full_like(t, INF))
    tk, k = t.min(1)
    return tk, k, u.float().gather(1, k[:, None])[:, 0], \
        v.float().gather(1, k[:, None])[:, 0]


def cast(G: Groups, o, d, t_min, t_max, any_hit: bool = False,
         dtype=torch.float32, chunk: int = 1 << 16):
    """Nearest hit (t, prim, u, v) of each ray in (t_min, t_max), t INF and
    prim -1 where none; with ``any_hit`` only whether one exists (bool).
    A ray visits its groups in order of entry and stops once its nearest
    hit lies before the next group's entry (or, with ``any_hit``, at its
    first hit)."""
    R = o.shape[0]
    dev = o.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(R)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(R)
    out_t = torch.full((R,), INF, device=dev)
    out_p = torch.full((R,), -1, dtype=torch.int64, device=dev)
    out_u = torch.zeros(R, device=dev)
    out_v = torch.zeros(R, device=dev)
    live = torch.nonzero(t_max > t_min)[:, 0]
    for s in range(0, live.numel(), chunk):
        idx = live[s:s + chunk]
        o_c, d_c, t0 = o[idx], d[idx], t_min[idx]
        best = t_max[idx].clone()
        bp = torch.full_like(idx, -1)
        bu = torch.zeros_like(best)
        bv = torch.zeros_like(best)
        ray, grp, ent = _candidates(G, o_c, d_c, t0, best)
        count = torch.bincount(ray, minlength=idx.numel())
        offs = torch.cumsum(count, 0) - count
        rows = torch.nonzero(count > 0)[:, 0]
        r = 0
        while rows.numel():
            rows = rows[count[rows] > r]
            pair = offs[rows] + r
            rows = rows[ent[pair] < best[rows]]
            if not rows.numel():
                break
            g = grp[offs[rows] + r]
            tk, k, uk, vk = _test(G, g, o_c[rows], d_c[rows], t0[rows],
                                  best[rows], dtype)
            better = tk < best[rows]
            h = rows[better]
            best[h] = tk[better]
            bp[h] = G.prim[g[better], k[better]]
            bu[h] = uk[better]
            bv[h] = vk[better]
            if any_hit:
                rows = rows[~better]
            r += 1
        hit = bp >= 0
        out_t[idx] = torch.where(hit, best, torch.full_like(best, INF))
        out_p[idx] = bp
        out_u[idx] = bu
        out_v[idx] = bv
    if any_hit:
        return out_p >= 0
    return out_t, out_p, out_u, out_v
