"""The plain reference's integrators and frame tail.

``whitted``: the renderer's Whitted wavefront as its contract states it:
per bounce the nearest hit from t = 1e-3, the background on a miss, a
Lambertian bounce about the shading normal (normal plus a uniform unit
vector, both draws keyed by pixel, sample, bounce and seed) with the
albedo as attenuation, first-hit albedo and normal guides.
``path``: the path tracer: cosine bounces, one area-light sample per
diffuse vertex with the balance heuristic,
Russian roulette from bounce 3.
``tail``: the fused frame loop's temporal blend (SVGF-style validity,
exponential history capped at 32 frames), the history-adaptive a-trous
filter and the sRGB quantisation.
Plain PyTorch; imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import torch

from .core import (
    EPS, INF, T_MIN, cast, dot, jitter, normalize, reflect, uniform4,
    unit_vector,
)

ROUGH, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3
# the salts folded into the seed per random purpose
DIM_SCATTER = 0x1E3779B9
DIM_FUZZ = 0x05EBCA6B
DIM_BSDF = 0x3C6EF372
DIM_LIGHT = 0x27220A95
DIM_RR = 0x2545F491


class Shading:
    """What a hit needs to shade: per scene triangle its unit-length
    normal (T, 3) and material row (T,); per material row its type,
    albedo, fuzz and emission."""

    def __init__(self, normals, material, mtype, albedo, param, emission):
        self.normals, self.material = normals, material
        self.mtype, self.albedo = mtype, albedo
        self.param, self.emission = param, emission

    def at(self, prim, d, u=None, v=None):
        """(normal facing the ray, front face, material row) at hits; with
        per-corner normals (T, 3, 3) the barycentric blend at (u, v)."""
        p = torch.clamp(prim, min=0)
        n = self.normals[p]
        if n.dim() == 3:
            n = ((1.0 - u - v)[..., None] * n[:, 0] + u[..., None] * n[:, 1]
                 + v[..., None] * n[:, 2])
        front = dot(d, n) < 0.0
        n = torch.where(front[..., None], n, -n)
        return n, front, self.material[p]


def camera_wave(cam, width, height, seed, sample: int = 0):
    """The jittered camera rays of one sample: (pixel ids, sample ids, o,
    d), row-major pixels."""
    dev = cam.center.device
    pix = torch.arange(width * height, dtype=torch.int64, device=dev)
    samp = torch.full_like(pix, sample)
    u1, u2 = jitter(pix, samp, seed)
    o, d = cam.rays(width, height, u1.reshape(height, width),
                    u2.reshape(height, width))
    return pix, samp, o, d


def whitted(groups, sh: Shading, o, d, pix, samp, seed: int, background,
            depth: int, dtype=torch.float32):
    """Radiance, albedo and normal guides, and the primary hit's (t, prim),
    of one wave of rays."""
    dev = o.device
    R = o.shape[0]
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
    thr = torch.ones((R, 3), device=dev)
    rad = torch.zeros((R, 3), device=dev)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    alb_g = torch.zeros((R, 3), device=dev)
    nrm_g = torch.zeros((R, 3), device=dev)
    t_g = torch.full((R,), INF, device=dev)
    prim_g = torch.full((R,), -1, dtype=torch.int64, device=dev)
    for b in range(depth):
        t_max = torch.where(alive, torch.full((R,), INF, device=dev),
                            torch.zeros(R, device=dev))
        t, prim, _, _ = cast(groups, o, d, T_MIN, t_max, dtype=dtype)
        hit = alive & (prim >= 0)
        rad = rad + torch.where((alive & ~hit)[..., None], thr * bg, 0.0)
        point = (o.to(dtype) + t.to(dtype)[..., None] * d.to(dtype)).float()
        n, _, mat = sh.at(prim, d)
        mt = sh.mtype[mat]
        albedo = sh.albedo[mat]
        n = normalize(n)
        u1, u2, _, _ = uniform4(pix, samp, b, seed ^ DIM_SCATTER)
        d_rough = n + unit_vector(u1, u2)
        d_rough = torch.where((dot(d_rough, d_rough) < EPS)[..., None], n,
                              d_rough)
        u1, u2, _, _ = uniform4(pix, samp, b, seed ^ DIM_FUZZ)
        d_metal = (normalize(reflect(d, n))
                   + sh.param[mat][..., None] * unit_vector(u1, u2))
        new = torch.where((mt == METAL)[..., None], d_metal, d_rough)

        def bad(x):
            return (~torch.isfinite(x).all(-1)) | (dot(x, x) <= EPS)
        new = torch.where(bad(new)[..., None], n, new)
        up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(new.shape)
        new = normalize(torch.where(bad(new)[..., None], up, new))
        emissive = mt == EMISSIVE
        rad = rad + torch.where((hit & emissive)[..., None],
                                thr * sh.emission[mat], 0.0)
        if b == 0:
            alb_g = torch.where(hit[..., None], albedo, alb_g)
            nrm_g = torch.where(hit[..., None], n, nrm_g)
            t_g = torch.where(hit, t, t_g)
            prim_g = torch.where(hit, prim, prim_g)
        go = hit & ~emissive
        thr = torch.where(go[..., None], thr * albedo, thr)
        o = torch.where(go[..., None], point, o)
        d = torch.where(go[..., None], new, d)
        alive = go
    return rad, alb_g, nrm_g, t_g, prim_g


# ---- the frame tail ---------------------------------------------------------

HISTORY_CAP = 32.0
ALPHA = 0.2


def empty_history(width, height, device):
    return dict(irr=torch.zeros((height, width, 3), device=device),
                hist=torch.zeros((height, width, 1), device=device),
                t=torch.full((height, width), INF, device=device),
                normal=torch.zeros((height, width, 3), device=device))


def project(cam, x, width, height):
    """Continuous pixel coordinates of world points, and whether each lies
    in front of the camera."""
    d = x - cam.center
    a = dot(d, cam.u)
    b = dot(d, cam.v)
    c = dot(d, cam.w) / torch.clamp(dot(cam.w, cam.w), min=1e-12)
    front = c > 1e-6
    c = torch.where(front, c, torch.ones_like(c))
    px = (a / (c * (width / height)) + 1.0) * 0.5 * width - 0.5
    py = (1.0 - b / c) * 0.5 * height - 0.5
    return px, py, front


def _tap(img, iy, ix):
    H, W = img.shape[:2]
    flat = img.reshape(H * W, -1)
    idx = (torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)).long()
    return flat[idx.reshape(-1)].reshape(idx.shape + (flat.shape[-1],))


def blend(state, irr, t, normal, px, py, prev_t, front):
    """The temporal blend: (blended irradiance, new state)."""
    H, W = t.shape
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    fx = px - x0.float()
    fy = py - y0.float()
    acc = torch.zeros_like(irr)
    acc_h = torch.zeros((H, W, 1), device=irr.device)
    wsum = torch.zeros((H, W, 1), device=irr.device)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            iy, ix = y0 + dy, x0 + dx
            inb = ((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W))[..., None]
            tt = _tap(state["t"][..., None], iy, ix)[..., 0]
            d_ok = ((tt - prev_t).abs()
                    <= 0.05 * torch.clamp(prev_t, min=1e-3))[..., None]
            n_ok = dot(_tap(state["normal"], iy, ix), normal, True) > 0.8
            h = _tap(state["hist"], iy, ix)
            w = (wy * wx)[..., None] * inb * d_ok * n_ok * (h > 0.0)
            acc = acc + _tap(state["irr"], iy, ix) * w
            acc_h = acc_h + h * w
            wsum = wsum + w
    have = ((wsum[..., 0] > 1e-3) & front & (t < INF))[..., None]
    inv = 1.0 / torch.clamp(wsum, min=1e-6)
    prev_irr = acc * inv
    hist = torch.where(have, torch.clamp(acc_h * inv, max=HISTORY_CAP - 1.0)
                       + 1.0, torch.ones_like(acc_h))
    a = torch.clamp(1.0 / hist, min=ALPHA)
    out = torch.where(have, prev_irr + a * (irr - prev_irr), irr)
    miss = (t >= INF)[..., None]
    out = torch.where(miss, irr, out)
    return out, dict(irr=out, hist=torch.where(miss, torch.zeros_like(hist),
                                               hist), t=t, normal=normal)


KERNEL = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def atrous(img, normal, sigma, iterations: int = 4, sigma_n: float = 32.0):
    """The edge-avoiding a-trous cascade (cyclic borders); ``sigma`` a
    scalar or a per-pixel (H, W, 1) map."""
    for i in range(iterations):
        step = 1 << i
        s_c = sigma / (1.3 ** i)
        offs = [-2 * step, -step, 0, step, 2 * step]
        acc = torch.zeros_like(img)
        wsum = torch.zeros(img.shape[:2] + (1,), device=img.device)
        for iy, dy in enumerate(offs):
            for ix, dx in enumerate(offs):
                k = float(KERNEL[iy] * KERNEL[ix])
                s = torch.roll(img, (-dy, -dx), dims=(0, 1))
                sn = torch.roll(normal, (-dy, -dx), dims=(0, 1))
                w_c = torch.exp(-((s - img) ** 2).sum(-1, keepdim=True)
                                / (s_c ** 2 + 1e-8))
                w_n = torch.clamp((sn * normal).sum(-1, keepdim=True),
                                  min=0.0) ** sigma_n
                w = k * w_c * w_n
                acc = acc + s * w
                wsum = wsum + w
        img = torch.where(wsum > 1e-8, acc / torch.clamp(wsum, min=1e-8), img)
    return img


def srgb8(rgb):
    """Linear radiance -> sRGB bytes, ``min(int(srgb * 256), 255)``."""
    c = torch.clamp(rgb, 0.0, 1.0)
    hi = 1.055 * torch.pow(torch.clamp(c, min=1e-30), 1.0 / 2.4) - 0.055
    s = torch.clamp(torch.where(c < 0.0031308, 12.92 * c, hi), 0.0, 1.0)
    return torch.clamp((s * 256.0).to(torch.int64), max=255).to(torch.uint8)


def tail(state, img, alb, nrm, t_g, x_prev, cam, width, height):
    """One frame's temporal blend, a-trous and quantisation: (sRGB bytes
    (H, W, 3), new history).  ``x_prev``: (H, W, 3) where each pixel's
    surface point was in the previous frame."""
    px, py, front = project(cam, x_prev, width, height)
    rel = x_prev - cam.center
    prev_t = torch.sqrt((rel * rel).sum(-1))
    safe = torch.clamp(alb, min=1e-3)
    out, state = blend(state, img / safe, t_g, normalize(nrm), px, py,
                       prev_t, front)
    sig = 1.0 / torch.sqrt(torch.clamp(state["hist"], min=1.0))
    return srgb8(atrous(out, nrm, sig) * safe), state
