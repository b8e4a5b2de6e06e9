"""Temporal reprojection and accumulation, the SVGF temporal term (port
of ``optix_ray_tracer_tpu/render/temporal.py``).

Demodulated irradiance is accumulated across the frames of an animation
by reprojecting each pixel to where its surface point was in the
previous frame.  The renderer knows every instance's rigid motion
exactly (Time poses, Mesh velocities), so the previous world point and
its pixel are computed in closed form (``prev_world_points`` of the
frontends).  History is re-verified per tap (depth and normal tests):
wrong history is dropped.  The state is a dict of (H, W, .) tensors
that the fused frame loop (``models/fused.py``) carries across frames,
chunks and files.
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.utils.vecmath import INF, dot

# exponential blend floor: alpha_eff = max(ALPHA, 1/history_length)
DEFAULT_ALPHA = 0.2
# history length cap == 1/ALPHA keeps alpha_eff consistent at steady state
HISTORY_CAP = 32.0


def empty_state(width: int, height: int, device) -> dict:
    """Initial temporal state (no history) on ``device``."""
    return dict(
        irr=torch.zeros((height, width, 3), device=device),
        hist=torch.zeros((height, width, 1), device=device),
        t=torch.full((height, width), INF, device=device),
        normal=torch.zeros((height, width, 3), device=device),
    )


def project_to_pixels(camera, x, width: int, height: int):
    """Continuous pixel coordinates of world points ``x`` (..., 3):
    (px, py, in_front), integer coordinates at pixel centers.  Inverts
    the camera's orthogonal u, v, w ray model: d = x - C = a u + b v + c w,
    ndc_x * aspect = a / c, ndc_y = b / c."""
    d = x - camera.center
    a = dot(d, camera.u)
    b = dot(d, camera.v)
    c = dot(d, camera.w) / torch.clamp(dot(camera.w, camera.w), min=1e-12)
    in_front = c > 1e-6
    safe_c = torch.where(in_front, c, torch.ones_like(c))
    aspect = width / height
    ndc_x = a / (safe_c * aspect)
    ndc_y = b / safe_c
    px = (ndc_x + 1.0) * 0.5 * width - 0.5
    py = (1.0 - ndc_y) * 0.5 * height - 0.5
    return px, py, in_front


def _gather(img, iy, ix):
    """img (H, W, C) gathered at integer index maps iy, ix (H, W)."""
    H, W = img.shape[:2]
    flat = img.reshape(H * W, -1)
    idx = (torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)).long()
    return flat[idx.reshape(-1)].reshape(idx.shape + (flat.shape[-1],))


def temporal_blend(state: dict, irr, t, normal, prev_px, prev_py,
                   prev_t_expected, in_front,
                   alpha: float = DEFAULT_ALPHA,
                   depth_tol: float = 0.05,
                   normal_min: float = 0.8):
    """Blend current demodulated irradiance with reprojected history.

    irr (H, W, 3); t (H, W) primary-hit depth (INF: miss); normal
    (H, W, 3); prev_px, prev_py (H, W) the pixel of this pixel's surface
    point in the previous frame; prev_t_expected (H, W) its distance from
    the camera then; in_front (H, W) bool.  Returns (blended (H, W, 3),
    new_state); miss pixels pass through with their history reset."""
    H, W = t.shape
    x0 = torch.floor(prev_px).to(torch.int32)
    y0 = torch.floor(prev_py).to(torch.int32)
    fx = prev_px - x0.float()
    fy = prev_py - y0.float()

    acc_irr = torch.zeros_like(irr)
    acc_hist = torch.zeros((H, W, 1), device=irr.device)
    wsum = torch.zeros((H, W, 1), device=irr.device)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            iy = y0 + dy
            ix = x0 + dx
            bw = (wy * wx)[..., None]
            inb = ((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W))[..., None]
            tap_t = _gather(state["t"][..., None], iy, ix)
            tap_n = _gather(state["normal"], iy, ix)
            tap_irr = _gather(state["irr"], iy, ix)
            tap_h = _gather(state["hist"], iy, ix)
            # SVGF-style validity: same surface (relative depth), similar
            # orientation, real history
            d_ok = ((tap_t[..., 0] - prev_t_expected).abs()
                    <= depth_tol * torch.clamp(prev_t_expected, min=1e-3)
                    )[..., None]
            n_ok = dot(tap_n, normal, keepdims=True) > normal_min
            h_ok = tap_h > 0.0
            wgt = bw * inb * d_ok * n_ok * h_ok
            acc_irr = acc_irr + tap_irr * wgt
            acc_hist = acc_hist + tap_h * wgt
            wsum = wsum + wgt

    have_hist = ((wsum[..., 0] > 1e-3) & in_front & (t < INF))[..., None]
    inv_w = 1.0 / torch.clamp(wsum, min=1e-6)
    prev_irr = acc_irr * inv_w
    prev_hist = acc_hist * inv_w

    hist_new = torch.where(have_hist,
                           torch.clamp(prev_hist, max=HISTORY_CAP - 1.0)
                           + 1.0, torch.ones_like(prev_hist))
    alpha_eff = torch.clamp(1.0 / hist_new, min=alpha)
    blended = torch.where(have_hist, prev_irr + alpha_eff * (irr - prev_irr),
                          irr)
    # sky stays exact and carries no history
    miss = (t >= INF)[..., None]
    blended = torch.where(miss, irr, blended)
    new_state = dict(irr=blended,
                     hist=torch.where(miss, torch.zeros_like(hist_new),
                                      hist_new),
                     t=t, normal=normal)
    return blended, new_state
