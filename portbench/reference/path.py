"""The plain reference's path tracer, as the renderer's contract states it:
per bounce the nearest hit from t = 1e-3; the background on a miss and the
emitted radiance of emitter hits, weighted by the balance heuristic against
the area-light sample; at each diffuse vertex one area-light sample (a
triangle picked by area x luminance, a uniform point on it) with its
shadow ray from 1e-4 off the surface;
a cosine-weighted bounce; Russian roulette from bounce 3 on the largest
throughput channel, floored at 0.05.  The draws are keyed by pixel,
sample, bounce and seed.  Diffuse and emissive materials only: the
configurations held to it have no others.

Plain PyTorch; imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import INF, PI, T_MIN, cast, cos_sin, dot, normalize, uniform4
from .render import (
    DIM_BSDF, DIM_LIGHT, DIM_RR, EMISSIVE, ROUGH,
)

LUMA = np.asarray([0.2126, 0.7152, 0.0722])


@dataclasses.dataclass
class AreaLights:
    """The emissive triangles: v0, e1, e2, unit normal, emission (L, 3);
    cdf, pdf_scale (L,); light row of each scene triangle (T,), -1 for
    the others."""
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor
    emission: torch.Tensor
    cdf: torch.Tensor
    pdf_scale: torch.Tensor
    row: torch.Tensor

    @staticmethod
    def build(tris, ids, n_tris: int, emission) -> "AreaLights":
        """tris (L, 3, 3) the emissive triangles, ids their scene triangle
        ids, n_tris the scene's triangle count; emission (L, 3) or (3,)."""
        dev = tris.device
        v = tris.cpu().numpy().astype(np.float64)
        em = np.asarray(emission.cpu(), np.float64).reshape(-1, 3)
        em = np.broadcast_to(em, (len(ids), 3))
        e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        n = np.cross(e1, e2)
        a2 = np.linalg.norm(n, axis=-1)
        area = 0.5 * a2
        weight = area * (em @ LUMA)
        if weight.max() <= 0.0:
            weight = area
        row = torch.full((n_tris,), -1, dtype=torch.int64, device=dev)
        row[torch.as_tensor(ids, device=dev)] = torch.arange(len(ids),
                                                             device=dev)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return AreaLights(f(v[:, 0]), f(e1), f(e2),
                          f(n / np.maximum(a2, 1e-30)[:, None]), f(em),
                          f(np.cumsum(weight) / weight.sum()),
                          f(weight / (weight.sum() * area)), row)

    def sample(self, p, pix, samp, b, seed):
        """(direction, distance, solid-angle pdf, emission) of one point
        on the lights seen from points p."""
        u1, u2, u3, _ = uniform4(pix, samp, b, seed)
        li = torch.clamp(torch.searchsorted(self.cdf, u1), 0,
                         self.cdf.shape[0] - 1)
        su = torch.sqrt(torch.clamp(u2, min=1e-12))[..., None]
        q = self.v0[li] + (1.0 - su) * self.e1[li] + (u3[..., None] * su) * self.e2[li]
        to = q - p
        d2 = dot(to, to)
        dist = torch.sqrt(torch.clamp(d2, min=1e-20))
        w = to / dist[..., None]
        cl = torch.abs(dot(w, self.normal[li]))
        pdf = d2 * self.pdf_scale[li] / torch.clamp(cl, min=1e-12)
        return w, dist, torch.where(cl > 1e-6, pdf, 0.0), self.emission[li]

    def pdf(self, prim, d, t):
        """The solid-angle pdf of reaching scene triangle ``prim`` at
        distance t along d by :meth:`sample` (0 off the lights)."""
        li = self.row[torch.clamp(prim, min=0)]
        on = (prim >= 0) & (li >= 0)
        lc = torch.clamp(li, min=0)
        scale = torch.where(on, self.pdf_scale[lc], 0.0)
        cl = torch.abs(dot(d, self.normal[lc]))
        pdf = t * t * scale / torch.clamp(cl, min=1e-12)
        return torch.where(cl > 1e-6, pdf, 0.0)


def cosine_sample(n, u1, u2):
    """A cosine-weighted direction about the unit normal n and its pdf
    (the branchless orthonormal basis of Duff et al.)."""
    c, s = cos_sin((2.0 * PI) * u1)
    sq = torch.sqrt(u2)
    lx, ly, lz = c * sq, s * sq, torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    sg = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sg + n[..., 2])
    bb = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sg * n[..., 0] * n[..., 0] * a, sg * bb,
                     -sg * n[..., 0]], -1)
    bt = torch.stack([bb, sg + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    d = lx[..., None] * t + ly[..., None] * bt + lz[..., None] * n
    return normalize(d), torch.clamp(lz, min=1e-6) / PI


def path(groups, sh, lights, o, d, pix, samp, seed: int, background,
         depth: int, rr_start: int = 3, dtype=torch.float32):
    """Radiance, albedo and normal guides, and the primary hit's (t, prim),
    of one wave.  ``sh``: render.Shading; ``lights``: AreaLights or None."""
    dev = o.device
    R = o.shape[0]
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    thr = torch.ones((R, 3), device=dev)
    rad = torch.zeros((R, 3), device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(R, device=dev)
    alb_g = torch.zeros((R, 3), device=dev)
    nrm_g = torch.zeros((R, 3), device=dev)
    t_g = torch.full((R,), INF, device=dev)
    prim_g = torch.full((R,), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros(R, device=dev)
    for b in range(depth):
        t, prim, u, v = cast(groups, o, d, T_MIN,
                             torch.where(alive, INF, zero), dtype=dtype)
        hit = alive & (prim >= 0)
        missed = alive & ~hit
        point = (o.to(dtype) + t.to(dtype)[..., None] * d.to(dtype)).float()
        n, _, mat = sh.at(prim, d, u, v)
        n = normalize(n)
        mt = sh.mtype[mat]
        if (hit & (mt != ROUGH) & (mt != EMISSIVE)).any():
            raise ValueError("the reference path tracer shades diffuse and "
                             "emissive materials only")
        albedo = sh.albedo[mat]
        emission = sh.emission[mat]
        # the miss, then emitter hits, MIS-weighted
        rad = rad + torch.where(missed[..., None], thr * bg, 0.0)
        emitter = hit & (mt == EMISSIVE)
        w_bsdf = torch.ones_like(prev_pdf)
        if lights is not None:
            w_bsdf = torch.where(prev_pdf > 0.0, prev_pdf / torch.clamp(
                prev_pdf + lights.pdf(prim, d, t), min=1e-12), 1.0)
        rad = rad + torch.where(emitter[..., None],
                                thr * emission * w_bsdf[..., None], 0.0)
        if b == 0:
            alb_g = torch.where(hit[..., None], torch.where(
                (mt == EMISSIVE)[..., None], emission, albedo), alb_g)
            nrm_g = torch.where(hit[..., None], n, nrm_g)
            t_g = torch.where(hit, t, t_g)
            prim_g = torch.where(hit, prim, prim_g)
        shading = hit & ~emitter
        diffuse = shading & (mt == ROUGH)
        origin = point + n * 1e-3
        if lights is not None:
            wl, dist, pdf_l, em = lights.sample(point, pix, samp, b,
                                                seed ^ DIM_LIGHT)
            cs = dot(wl, n)
            ok = diffuse & (cs > 0.0) & (pdf_l > 0.0)
            cc = torch.clamp(cs, min=0.0)
            w = pdf_l / torch.clamp(pdf_l + cc / PI, min=1e-12)
            c = thr * (albedo / PI) * em * (cc / torch.clamp(pdf_l, min=1e-12)
                                             * w)[..., None]
            occ = cast(groups, origin, wl, 1e-4,
                       torch.where(ok, dist - 2e-3, zero), any_hit=True,
                       dtype=dtype)
            rad = rad + torch.where((ok & ~occ)[..., None], c, 0.0)
        # the cosine bounce and Russian roulette
        u1, u2, _, _ = uniform4(pix, samp, b, seed ^ DIM_BSDF)
        new, pdf_d = cosine_sample(n, u1, u2)
        new = normalize(new)
        prev_pdf = torch.where(mt == ROUGH, pdf_d, 0.0)
        thr = torch.where(shading[..., None], thr * albedo, thr)
        if b >= rr_start:
            u_rr = uniform4(pix, samp, b, seed ^ DIM_RR)[0]
            p = torch.clamp(thr.amax(-1), 0.05, 1.0)
            thr = torch.where(shading[..., None], thr / p[..., None], thr)
            shading = shading & (u_rr < p)
        o = torch.where(shading[..., None], origin, o)
        d = torch.where(shading[..., None], new, d)
        alive = shading
    return rad, alb_g, nrm_g, t_g, prim_g
