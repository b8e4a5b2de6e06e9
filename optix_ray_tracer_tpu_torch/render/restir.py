"""ReSTIR DI: reservoir-based spatiotemporal importance resampling of
direct lighting (port of ``optix_ray_tracer_tpu/render/restir.py``;
weighted reservoir RIS, Bitterli et al. 2020).

One primary ray and one shadow ray per pixel per sample; the effective
light-sample count is M candidates x temporal history x spatial taps,
all of it elementwise arithmetic on (H*W,) lanes and row gathers from the
(L, 16) packed light table:

* candidates: a loop over M CDF-drawn light samples, streaming weighted
  reservoir sampling;
* reservoirs: image tensors (li, u2, u3, W, m) carried across samples
  or frames, with the G-buffer taps (t, normal) that validate reuse;
* temporal reuse reprojects hit points through the previous camera
  (``render/temporal.project_to_pixels``); spatial reuse gathers a few
  neighbours; both reject dissimilar history by depth and normal;
* every random draw is counter-RNG keyed by (pixel, frame, candidate).

Candidate RIS with the final visibility ray is unbiased (the target
excludes visibility); the reuse is the standard "biased ReSTIR", its
error bounded by the rejection tolerances.  The JAX package's one-hot
matmul lookup and dense CDF compare for small light tables are TPU
shapes: here every light count takes a row gather and ``searchsorted``,
which give the same values.
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.ops import intersect as isect
from optix_ray_tracer_tpu_torch.render.temporal import project_to_pixels
from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.scene.lights import AreaLights
from optix_ray_tracer_tpu_torch.scene.materials import (
    EMISSIVE, ROUGH, MaterialTable,
)
from optix_ray_tracer_tpu_torch.utils import rng
from optix_ray_tracer_tpu_torch.utils.color import luminance_fma
from optix_ray_tracer_tpu_torch.utils.tensors import resolve_device
from optix_ray_tracer_tpu_torch.utils.vecmath import (
    INF, PI, dot, length_squared, normalize,
)

_DIM_CAND = 0x5851F42D
_DIM_PICK = 0x14057B7E
_DIM_REUSE = 0x61C88647
# seed salt of the GI continuation trace
_DIM_GI = 0x2545F491

# temporal history cap, in multiples of M candidates
M_CAP = 20.0
# reuse similarity tolerances (SVGF-style)
DEPTH_TOL = 0.05
NORMAL_MIN = 0.9


def empty_reservoir_state(width: int, height: int, device=None) -> dict:
    """The no-history reservoir state on ``device`` (None: the card): one
    reservoir per pixel and the G-buffer taps (t, normal) that validate
    reuse."""
    dev = resolve_device(device)
    z = torch.zeros((height, width), device=dev)
    return dict(
        li=torch.zeros((height, width), dtype=torch.int32, device=dev),
        u2=z, u3=z, W=z, m=z,
        t=torch.full((height, width), INF, device=dev),
        normal=torch.zeros((height, width, 3), device=dev),
    )


def _pack_lights(lights: AreaLights):
    """(L, 16) packed light rows: v0 | e1 | e2 | normal | emission |
    pdf_scale, one gather per candidate instead of six."""
    return torch.cat([lights.v0, lights.e1, lights.e2, lights.normal,
                      lights.emission, lights.pdf_scale[:, None]], dim=1)


def _lookup(packed, li):
    """Row(s) ``li`` of the packed table."""
    return packed[li.long()]


def _sample_point_row(row, u2, u3):
    """The stored light sample from its packed row: (point, emitted,
    normal).  (li, u2, u3) re-evaluates at any pixel."""
    su = torch.sqrt(torch.clamp(u2, min=1e-12))[..., None]
    b1 = 1.0 - su
    b2 = u3[..., None] * su
    y = row[..., 0:3] + b1 * row[..., 3:6] + b2 * row[..., 6:9]
    return y, row[..., 12:15], row[..., 9:12]


def _phat_row(row, u2, u3, point, n_unit, albedo):
    """Target function of a stored sample at a shading point, in area
    measure: phat = luminance(f * Le * cos_s * |cos_l| / d^2).  Returns
    (phat, rgb integrand, direction, distance)."""
    y, le, ln = _sample_point_row(row, u2, u3)
    to = y - point
    d2 = length_squared(to)
    dist = torch.sqrt(torch.clamp(d2, min=1e-20))
    w = to / dist[..., None]
    cos_s = torch.clamp(dot(w, n_unit), min=0.0)
    cos_l = torch.abs(dot(w, ln))
    g = cos_s * cos_l / torch.clamp(d2, min=1e-12)
    rgb = (albedo / PI) * le * g[..., None]
    return luminance_fma(rgb), rgb, w, dist


def _initial_candidates(lights: AreaLights, packed, point, n_unit, albedo,
                        active, pixel_id, frame, seed, m_candidates: int,
                        sampler: str = "pcg"):
    """Streaming weighted-reservoir sampling over M CDF-drawn candidates.
    Candidate pdfs are in area measure (packed column 15), as
    ``_phat_row``'s target, so w_i = phat_i / p_i.  Returns (li, u2, u3,
    wsum) of the winner."""
    nl = lights.count
    dev = point.device
    y_li = torch.zeros(point.shape[:-1], dtype=torch.int32, device=dev)
    y_u2 = torch.zeros(point.shape[:-1], device=dev)
    y_u3 = torch.zeros_like(y_u2)
    wsum = torch.zeros_like(y_u2)
    for ci in range(m_candidates):
        u1, u2, u3, u4 = rng.uniform4(pixel_id, frame, ci, seed ^ _DIM_CAND,
                                      sampler)
        li = torch.clamp(torch.searchsorted(lights.cdf, u1), 0,
                         nl - 1).to(torch.int32)
        row = _lookup(packed, li)
        phat = _phat_row(row, u2, u3, point, n_unit, albedo)[0]
        p = row[..., 15]
        w = torch.where(active & (p > 0.0),
                        phat / torch.clamp(p, min=1e-30), 0.0)
        wsum = wsum + w
        take = u4 * torch.clamp(wsum, min=1e-30) < w
        y_li = torch.where(take, li, y_li)
        y_u2 = torch.where(take, u2, y_u2)
        y_u3 = torch.where(take, u3, y_u3)
    return y_li, y_u2, y_u3, wsum


def _finalize_w(packed, li, u2, u3, wsum, m, point, n_unit, albedo):
    """Contribution weight W = wsum / (m * phat(y)), the RIS estimator's
    1/pdf of the winner."""
    phat = _phat_row(_lookup(packed, li), u2, u3, point, n_unit, albedo)[0]
    ok = (phat > 0.0) & (m > 0.0)
    return torch.where(ok, wsum / torch.clamp(m * phat, min=1e-30), 0.0)


def _combine(packed, dst, srcs, point, n_unit, albedo, pixel_id, frame,
             seed, sampler: str = "pcg"):
    """Merge reservoirs at the destination pixel (Bitterli Alg. 4): each
    source sample is re-weighted by the destination's target.  ``dst``
    and each of ``srcs``: (li, u2, u3, W, m, valid)."""
    d_li, d_u2, d_u3, d_W, d_m, d_valid = dst
    phat_d = _phat_row(_lookup(packed, d_li), d_u2, d_u3, point, n_unit,
                       albedo)[0]
    wsum = torch.where(d_valid, phat_d * d_W * d_m, 0.0)
    m_tot = torch.where(d_valid, d_m, 0.0)
    y_li, y_u2, y_u3 = d_li, d_u2, d_u3
    for tap, (s_li, s_u2, s_u3, s_W, s_m, s_valid) in enumerate(srcs):
        phat_s = _phat_row(_lookup(packed, s_li), s_u2, s_u3, point,
                           n_unit, albedo)[0]
        w = torch.where(s_valid, phat_s * s_W * s_m, 0.0)
        wsum = wsum + w
        u = rng.uniform4(pixel_id, frame, tap, seed ^ _DIM_PICK, sampler)[0]
        take = u * torch.clamp(wsum, min=1e-30) < w
        y_li = torch.where(take, s_li, y_li)
        y_u2 = torch.where(take, s_u2, y_u2)
        y_u3 = torch.where(take, s_u3, y_u3)
        m_tot = m_tot + torch.where(s_valid, s_m, 0.0)
    W = _finalize_w(packed, y_li, y_u2, y_u3, wsum, m_tot, point, n_unit,
                    albedo)
    return y_li, y_u2, y_u3, W, m_tot


def _gather2(img, iy, ix):
    """img (H, W) or (H, W, C) at integer index maps iy, ix (clamped)."""
    h, w = img.shape[:2]
    flat = img.reshape(h * w, -1)
    idx = (torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)).long()
    out = flat[idx.reshape(-1)].reshape(idx.shape + (flat.shape[-1],))
    return out[..., 0] if img.dim() == 2 else out


def _primary(intersector, scene, camera, width: int, height: int):
    """Pixel-center camera rays (R, 3) and their nearest hits."""
    o, d = camera.generate_rays(width, height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    t_max = torch.full((width * height,), INF, device=o.device)
    return o, d, intersector.intersect(scene, o, d, t_max=t_max)


def _check_lights(lights):
    if lights is None or lights.count == 0:
        raise ValueError("render_restir needs a non-empty light table")


def render_restir(scene: Scene, materials: MaterialTable,
                  lights: AreaLights, camera, width: int, height: int,
                  seed: int, frame: int = 0, state: dict | None = None,
                  prev_camera=None, m_candidates: int = 16,
                  spatial_taps: int = 2, spatial_radius: int = 16,
                  intersector=None, background=(0.0, 0.0, 0.0), env=None,
                  textures=None, sampler: str = "pcg"):
    """One ReSTIR DI frame on the device of the camera's tensors: direct
    lighting at diffuse primary hits, plus camera-visible emitters and
    the background or environment on a miss.

    ``state``: the previous frame's reservoirs (``empty_reservoir_state``
    or this function's last return) for temporal reuse; None disables
    it.  ``prev_camera``: the previous frame's camera (default: this
    one); moving geometry is rejected by the depth and normal tests.
    Returns (img (H, W, 3), albedo_g, normal_g, new_state)."""
    _check_lights(lights)
    if intersector is None:
        intersector = isect.BruteForceIntersector()
    incoh = getattr(intersector, "for_incoherent", lambda: intersector)()
    o, d, hit = _primary(intersector, scene, camera, width, height)
    g = _gbuffer(scene, materials, o, d, hit, textures, env, background,
                 intersector)
    return _shade(scene, lights, incoh, g, hit, width, height, frame, seed,
                  state, camera, prev_camera, m_candidates, spatial_taps,
                  spatial_radius, sampler)


def _shade(scene, lights, incoh, g, hit, width, height, frame, seed, state,
           camera, prev_camera, m_candidates, spatial_taps, spatial_radius,
           sampler):
    """Resample, trace the winner's shadow ray, compose: the part of a
    ReSTIR frame after the G-buffer."""
    point, n_unit, albedo, active, base, albedo_g, normal_g = g
    packed = _pack_lights(lights)
    li2, u22, u32, W2, m2, act2, t2, n2 = _resample(
        lights, packed, point, n_unit, albedo, active, hit.t, width,
        height, frame, seed, state, camera, prev_camera, m_candidates,
        spatial_taps, spatial_radius, sampler)
    # ---- shade the winner: one shadow ray per pixel -------------------
    rgb, wdir, dist, live, Wf = _shade_terms(packed, li2, u22, u32, W2,
                                             point, n_unit, albedo, active)
    occluded = incoh.any_hit(
        scene, point + n_unit * 1e-3, wdir, t_min=1e-4,
        t_max=torch.where(live, dist - 2e-3, torch.zeros_like(dist)))
    return _compose(base, rgb, Wf, live, occluded, li2, u22, u32, m2, act2,
                    t2, n2, albedo_g, normal_g, width, height)


def _gbuffer(scene, materials, o, d, hit, textures, env, background,
             intersector=None):
    """Shading inputs at the primary hits, no rays: (point, unit normal,
    albedo, active = diffuse hit, base = miss or emitter radiance,
    albedo guide, normal guide)."""
    point, normal, _, material_id = isect.shading_frame_fn(intersector)(
        scene, o, d, hit)
    n_unit = normalize(normal)
    mtype, albedo, _, emission = materials.gather(material_id)
    if textures is not None:
        albedo = albedo * textures.sample(material_id,
                                          isect.interpolate_uv(scene, hit))
    background = torch.as_tensor(background, dtype=torch.float32,
                                 device=o.device)
    miss_rgb = env.sample(d) if env is not None else background
    is_emitter = hit.is_hit & (mtype == EMISSIVE)
    base = torch.where(~hit.is_hit[..., None], miss_rgb,
                       torch.where(is_emitter[..., None], emission, 0.0))
    active = hit.is_hit & (mtype == ROUGH)
    albedo_g = torch.where(hit.is_hit[..., None],
                           torch.where(is_emitter[..., None], emission,
                                       albedo), 0.0)
    normal_g = torch.where(hit.is_hit[..., None], n_unit, 0.0)
    return point, n_unit, albedo, active, base, albedo_g, normal_g


def _resample(lights, packed, point, n_unit, albedo, active, t, width,
              height, frame, seed, state, camera, prev_camera,
              m_candidates, spatial_taps, spatial_radius, sampler):
    """Initial candidates, temporal and spatial reuse, combine: the
    winner grids (li2, u22, u32, W2, m2) and the taps (act2, t2, n2) the
    new state keeps."""
    dev = point.device
    pixel_id = torch.arange(width * height, dtype=torch.int64, device=dev)
    li, u2, u3, wsum = _initial_candidates(
        lights, packed, point, n_unit, albedo, active, pixel_id, frame,
        seed, m_candidates, sampler)
    m = torch.where(active, float(m_candidates), 0.0)
    W = _finalize_w(packed, li, u2, u3, wsum, m, point, n_unit, albedo)

    def im(x):
        return x.reshape((height, width) + x.shape[1:])

    li2, u22, u32, W2, m2 = im(li), im(u2), im(u3), im(W), im(m)
    point2, n2, alb2 = im(point), im(n_unit), im(albedo)
    t2, act2 = im(t), im(active)
    pid2 = im(pixel_id)

    srcs = []
    # ---- temporal reuse ----------------------------------------------
    if state is not None:
        pc = camera if prev_camera is None else prev_camera
        px, py, in_front = project_to_pixels(pc, point2, width, height)
        ix = torch.clamp(torch.round(px).to(torch.int64), 0, width - 1)
        iy = torch.clamp(torch.round(py).to(torch.int64), 0, height - 1)
        inb = ((px > -0.5) & (px < width - 0.5) & (py > -0.5)
               & (py < height - 0.5))
        p_li = _gather2(state["li"], iy, ix)
        p_u2 = _gather2(state["u2"], iy, ix)
        p_u3 = _gather2(state["u3"], iy, ix)
        p_W = _gather2(state["W"], iy, ix)
        p_m = torch.clamp(_gather2(state["m"], iy, ix),
                          max=M_CAP * m_candidates)
        p_t = _gather2(state["t"], iy, ix)
        p_n = _gather2(state["normal"], iy, ix)
        rel = point2 - pc.center
        prev_dist = torch.sqrt(dot(rel, rel))
        same = ((torch.abs(p_t - prev_dist)
                 <= DEPTH_TOL * torch.clamp(prev_dist, min=1e-3))
                & (dot(p_n, n2) > NORMAL_MIN))
        valid = act2 & in_front & inb & same & (p_m > 0.0)
        srcs.append((p_li, p_u2, p_u3, p_W, p_m, valid))

    # ---- spatial reuse -----------------------------------------------
    rows = torch.arange(height, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    for tap in range(spatial_taps):
        ua, ub = rng.uniform4(pid2, frame, 64 + tap, seed ^ _DIM_REUSE,
                              sampler)[:2]
        dx = torch.round((ua * 2.0 - 1.0) * spatial_radius).to(torch.int64)
        dy = torch.round((ub * 2.0 - 1.0) * spatial_radius).to(torch.int64)
        yy, xx = rows + dy, cols + dx
        inb = (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
        s_li = _gather2(li2, yy, xx)
        s_u2 = _gather2(u22, yy, xx)
        s_u3 = _gather2(u32, yy, xx)
        s_W = _gather2(W2, yy, xx)
        s_m = _gather2(m2, yy, xx)
        s_t = _gather2(t2, yy, xx)
        s_n = _gather2(n2, yy, xx)
        s_act = _gather2(act2.float(), yy, xx) > 0.5
        same = ((torch.abs(s_t - t2) <= DEPTH_TOL * torch.clamp(t2, min=1e-3))
                & (dot(s_n, n2) > NORMAL_MIN))
        valid = act2 & s_act & inb & same & (s_m > 0.0)
        srcs.append((s_li, s_u2, s_u3, s_W, s_m, valid))

    if srcs:
        li2, u22, u32, W2, m2 = _combine(
            packed, (li2, u22, u32, W2, m2, act2), srcs, point2, n2, alb2,
            pid2, frame, seed, sampler)
    return li2, u22, u32, W2, m2, act2, t2, n2


def _shade_terms(packed, li2, u22, u32, W2, point, n_unit, albedo, active):
    """The winner at the shading point: (rgb integrand, shadow direction,
    distance, live mask, W), flat."""
    lif, u2f, u3f = li2.reshape(-1), u22.reshape(-1), u32.reshape(-1)
    Wf = W2.reshape(-1)
    phat_y, rgb, wdir, dist = _phat_row(_lookup(packed, lif), u2f, u3f,
                                        point, n_unit, albedo)
    live = active & (Wf > 0.0) & (phat_y > 0.0)
    return rgb, wdir, dist, live, Wf


def _compose(base, rgb, Wf, live, occluded, li2, u22, u32, m2, act2, t2,
             n2, albedo_g, normal_g, width, height):
    """The image and the new reservoir state from the shadow-ray verdict.
    A winner proven occluded is stored with W = 0, so history and
    neighbours never adopt a sample this pixel knows is shadowed."""
    direct = torch.where((live & ~occluded)[..., None], rgb * Wf[..., None],
                         0.0)
    img = (base + direct).reshape(height, width, 3)
    W_store = torch.where(occluded, 0.0, Wf).reshape(height, width)
    new_state = dict(li=li2, u2=u22, u3=u32, W=W_store,
                     m=torch.where(act2, m2, 0.0),
                     t=torch.where(act2, t2, INF), normal=n2)
    return (img, albedo_g.reshape(height, width, 3),
            normal_g.reshape(height, width, 3), new_state)


def _progressive(render_fn, camera, width: int, height: int, spp: int):
    """``spp`` frames of ``render_fn(frame, state)`` with the reservoirs
    carried across them; (mean image, albedo_g, normal_g) of the last."""
    state = empty_reservoir_state(width, height, camera.center.device)
    acc = torch.zeros((height, width, 3), device=camera.center.device)
    alb = nrm = acc
    for f in range(spp):
        img, alb, nrm, state = render_fn(f, state)
        acc = acc + img
    return acc / spp, alb, nrm


def render_restir_progressive(scene: Scene, materials: MaterialTable,
                              lights: AreaLights, camera, width: int,
                              height: int, spp: int = 1, seed: int = 0,
                              m_candidates: int = 16,
                              spatial_taps: int = 2,
                              spatial_radius: int = 16, intersector=None,
                              background=(0.0, 0.0, 0.0), env=None,
                              textures=None, sampler: str = "pcg"):
    """``spp`` samples of :func:`render_restir` with the reservoir state
    carried across them (sample s resamples against samples < s): the
    entry of ``"integrator": "restir"``.  Returns (img, albedo_g,
    normal_g), img averaged over spp."""
    def one(f, st):
        return render_restir(
            scene, materials, lights, camera, width, height, seed=seed,
            frame=f, state=st, m_candidates=m_candidates,
            spatial_taps=spatial_taps, spatial_radius=spatial_radius,
            intersector=intersector, background=background, env=env,
            textures=textures, sampler=sampler)
    return _progressive(one, camera, width, height, spp)


def render_restir_gi(scene: Scene, materials: MaterialTable,
                     lights: AreaLights, camera, width: int, height: int,
                     seed: int, frame: int = 0, state: dict | None = None,
                     prev_camera=None, m_candidates: int = 16,
                     spatial_taps: int = 2, spatial_radius: int = 16,
                     max_depth: int = 8, intersector=None,
                     background=(0.0, 0.0, 0.0), env=None, textures=None,
                     clamp: float = 0.0, sampler: str = "pcg"):
    """Full light transport with ReSTIR direct: the reservoir pass owns
    the primary vertex's area-light direct lighting and a
    ``trace_path(restir_direct=True)`` continuation everything else
    (indirect bounces, delta primaries, environment NEE).  The partition
    is exact, so the sum is unbiased.  The primary wave is traced once
    and shared.  Returns (img, albedo_g, normal_g, new_state)."""
    from optix_ray_tracer_tpu_torch.render.pathtracer import trace_path

    _check_lights(lights)
    if intersector is None:
        intersector = isect.BruteForceIntersector()
    incoh = getattr(intersector, "for_incoherent", lambda: intersector)()
    o, d, hit = _primary(intersector, scene, camera, width, height)
    g = _gbuffer(scene, materials, o, d, hit, textures, env, background,
                 intersector)
    img, alb_img, nrm_img, new_state = _shade(
        scene, lights, incoh, g, hit, width, height, frame, seed, state,
        camera, prev_camera, m_candidates, spatial_taps, spatial_radius,
        sampler)
    pixel_id = torch.arange(width * height, dtype=torch.int64,
                            device=o.device)
    indirect = trace_path(
        scene, materials, lights, o, d, pixel_id, frame, seed ^ _DIM_GI,
        background, max_depth=max_depth, intersector=intersector, env=env,
        textures=textures, clamp=clamp, sampler=sampler,
        restir_direct=True, first_hit=hit)[0]
    return (img + indirect.reshape(height, width, 3), alb_img, nrm_img,
            new_state)


def render_restir_gi_progressive(scene: Scene, materials: MaterialTable,
                                 lights: AreaLights, camera, width: int,
                                 height: int, spp: int = 1, seed: int = 0,
                                 m_candidates: int = 16,
                                 spatial_taps: int = 2,
                                 spatial_radius: int = 16,
                                 max_depth: int = 8, intersector=None,
                                 background=(0.0, 0.0, 0.0), env=None,
                                 textures=None, clamp: float = 0.0,
                                 sampler: str = "pcg"):
    """``spp`` samples of :func:`render_restir_gi` with the reservoirs
    carried across them: the entry of ``"integrator": "restir-gi"``.
    Returns (img, albedo_g, normal_g), img averaged over spp."""
    def one(f, st):
        return render_restir_gi(
            scene, materials, lights, camera, width, height, seed=seed,
            frame=f, state=st, m_candidates=m_candidates,
            spatial_taps=spatial_taps, spatial_radius=spatial_radius,
            max_depth=max_depth, intersector=intersector,
            background=background, env=env, textures=textures,
            clamp=clamp, sampler=sampler)
    return _progressive(one, camera, width, height, spp)
