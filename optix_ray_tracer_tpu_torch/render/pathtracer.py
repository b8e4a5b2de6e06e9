"""Path tracer with next-event estimation and multiple importance
sampling (port of ``optix_ray_tracer_tpu/render/pathtracer.py``; the
integrator of BASELINE configs 4 and 5).

The wavefront of ``render/wavefront.py`` (a Python loop over bounces, SoA
state, masked shading), with per bounce:

* emitted radiance at BSDF hits, weighted by the balance heuristic
  w_bsdf = p_bsdf / (p_bsdf + p_nee) (full weight on camera rays and after
  delta lobes);
* NEE: one area-light sample per diffuse vertex, w_nee = p_nee / (p_nee +
  p_bsdf), its shadow segment through the bundle engine (kernel A on a 3-D
  bundle schedule) when the intersector can, else the incoherent marcher;
* environment NEE when the map carries sampling tables, MIS'd against the
  cosine lobe, with the matching weight on escaping BSDF rays;
* cosine-sampled diffuse bounces, METAL and DIELECTRIC delta lobes (no
  NEE, no MIS at their vertices), Russian roulette from ``rr_start`` and
  an optional clamp on indirect contributions.

Camera waves go through the raster engine (kernel A, "origin") when the
intersector carries raster tables; bounce and environment-occlusion waves
through the intersector's incoherent variant (kernels C then B).  For
CUDA tensors the BSDF step of each bounce (:func:`bsdf_step`: lobe,
throughput, roulette, next ray) runs on kernel K, its NEE samples
(:func:`nee_sample`) on L, their shadowed contributions
(:func:`nee_add`) on M, and the miss and emitter terms
(:func:`hit_radiance`) on N.  Each section of a bounce is a span
(``utils/profiling.span``, ``path.*``), which ``tools/prof_port.py``
reads.
``sampler`` selects PCG4D or Owen-scrambled Sobol; ``restir_direct``
hands the primary vertex's area-light direct lighting to ReSTIR
(``render/restir.render_restir_gi``).
"""

from __future__ import annotations

import os

import torch

from optix_ray_tracer_tpu_torch.ops import intersect as isect
from optix_ray_tracer_tpu_torch.ops.kernels import bounce as bounce_kernels
from optix_ray_tracer_tpu_torch.ops.raster import (
    camera_tile_layout, make_camera_intersect, make_tiled_bundle_intersect,
)
from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.scene.lights import (
    AreaLights, light_pdf_solid_angle, sample_lights,
)
from optix_ray_tracer_tpu_torch.scene.materials import (
    DIELECTRIC, EMISSIVE, METAL, ROUGH, MaterialTable,
)
from optix_ray_tracer_tpu_torch.utils import profiling, rng
from optix_ray_tracer_tpu_torch.utils.tensors import device_constant
from optix_ray_tracer_tpu_torch.utils.vecmath import (
    INF, PI, dot, normalize, reflect, refract, schlick_fresnel,
)

# decorrelation constants folded into the RNG seed per random purpose
_DIM_BSDF = 0x3C6EF372
_DIM_LIGHT = 0x27220A95
_DIM_LOBE = 0x165667B1
_DIM_RR = 0x2545F491
_DIM_LENS = 0x68E31DA4
_DIM_ENV = 0x4F6CDD1D

#: the bundle engine takes area-light shadow segments from this many
#: clusters on (below it the marcher is already cheap)
BUNDLE_MIN_CLUSTERS = 16


def _onb(n):
    """Orthonormal basis (t, b) about the unit normal n (branchless
    Frisvad / Duff et al.)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                     -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def _cosine_sample(n, u1, u2):
    """A cosine-weighted direction about the unit normal n from two
    uniforms, and its pdf."""
    local = rng.cosine_direction_from(u1, u2)
    t, bt = _onb(n)
    d = local[..., 0:1] * t + local[..., 1:2] * bt + local[..., 2:3] * n
    pdf = torch.clamp(local[..., 2], min=1e-6) / PI
    return normalize(d), pdf


def bsdf_step(d, n_unit, point, front_face, mtype, albedo, param,
              throughput, shading_alive, o, pixel_id, sample, b: int,
              seed: int, sampler: str = "pcg", rr_start: int = 3):
    """The BSDF step of one bounce of :func:`trace_path` for a wave of R
    hits: the next direction by material (the cosine lobe about
    ``n_unit`` for ROUGH and EMISSIVE rows, mirror plus fuzz for METAL,
    reflection or refraction by Schlick's term for DIELECTRIC), the
    throughput of the ``shading_alive`` lanes times their attenuation,
    Russian roulette from bounce ``rr_start`` on, and the origins and
    directions of the lanes that go on.  ``d``, ``n_unit`` (unit),
    ``point``, ``albedo`` (textured), ``throughput``, ``o``: (R, 3)
    float32; ``front_face``, ``shading_alive`` (R,) bool; ``mtype`` (R,)
    int32; ``param`` (R,) float32.  Returns (o, d, throughput, prev_pdf
    (the cosine pdf on ROUGH rows, else 0), alive).  CUDA tensors launch
    kernel K (``ops/kernels/bounce.bsdf_step_call``); others take
    :func:`bsdf_step_plain`, which computes the same bits."""
    if d.is_cuda:
        return bounce_kernels.bsdf_step_call(
            d, n_unit, point, front_face, mtype, albedo, param, throughput,
            shading_alive, o, pixel_id, sample, b, seed, sampler, rr_start)
    return bsdf_step_plain(d, n_unit, point, front_face, mtype, albedo,
                           param, throughput, shading_alive, o, pixel_id,
                           sample, b, seed, sampler, rr_start)


def bsdf_step_plain(d, n_unit, point, front_face, mtype, albedo, param,
                    throughput, shading_alive, o, pixel_id, sample, b: int,
                    seed: int, sampler: str = "pcg", rr_start: int = 3):
    """Plain version of :func:`bsdf_step` on any device (kernel K's twin):
    every lobe is evaluated for every ray and blended by masks, its draws
    from ``rng.uniform4_plain``."""
    def draw(salt):
        return rng.uniform4_plain(pixel_id, sample, b, seed ^ salt, sampler)

    u1, u2, _, _ = draw(_DIM_BSDF)
    d_diff, pdf_diff = _cosine_sample(n_unit, u1, u2)
    # the metal fuzz and the dielectric's Fresnel choice share one draw
    u1, u_fr, _, _ = draw(_DIM_LOBE)
    fuzz_vec = rng.unit_vector_from(u1, u_fr)
    d_metal = normalize(normalize(reflect(d, n_unit))
                        + param[..., None] * fuzz_vec)
    ior = torch.where(param > 0.0, param, 1.5)
    eta = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(-dot(d, n_unit), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta,
                                       min=0.0))
    cannot = eta * sin_theta > 1.0
    do_reflect = cannot | (schlick_fresnel(cos_theta, ior) > u_fr)
    d_diel = torch.where(do_reflect[..., None],
                         normalize(reflect(d, n_unit)),
                         refract(d, n_unit, eta[..., None]))
    is_metal = (mtype == METAL)[..., None]
    is_diel = (mtype == DIELECTRIC)[..., None]
    new_dir = normalize(torch.where(
        is_diel, d_diel, torch.where(is_metal, d_metal, d_diff)))

    # diffuse: albedo * cos / pdf = albedo; metal: albedo; glass: 1
    atten = torch.where(is_diel, 1.0, albedo)
    prev_pdf = torch.where(mtype == ROUGH, pdf_diff, 0.0)
    throughput = torch.where(shading_alive[..., None],
                             throughput * atten, throughput)

    # Russian roulette: continue with the largest channel, floored
    if b >= rr_start:
        u_rr = draw(_DIM_RR)[0]
        p_cont = torch.clamp(throughput.amax(-1), 0.05, 1.0)
        throughput = torch.where(shading_alive[..., None],
                                 throughput / p_cont[..., None], throughput)
        shading_alive = shading_alive & (u_rr < p_cont)

    offset = torch.where(is_diel[..., 0] & ~do_reflect, -1e-3, 1e-3)
    o = torch.where(shading_alive[..., None],
                    point + n_unit * offset[..., None], o)
    d = torch.where(shading_alive[..., None], new_dir, d)
    return o, d, throughput, prev_pdf, shading_alive


def _capped(contrib, cap: float):
    """The firefly clamp: ``contrib`` capped per channel at ``cap`` (0:
    off)."""
    return torch.clamp(contrib, max=cap) if cap > 0.0 else contrib


def nee_sample(point, n_unit, shading_alive, mtype, throughput, albedo,
               pixel_id, sample, b: int, seed: int, sampler: str = "pcg",
               lights: AreaLights | None = None, env=None, cap: float = 0.0):
    """The pre-query half of :func:`trace_path`'s next-event estimation at
    bounce ``b`` for a wave of R hits: one area-light sample (``lights``;
    None: off) and one environment sample (``env``, a map with sampling
    tables; None: off) at the ROUGH ``shading_alive`` vertices, each with
    its shadow segment and its balance-heuristic contribution.  ``point``,
    ``n_unit`` (unit), ``throughput``, ``albedo`` (textured): (R, 3)
    float32; ``shading_alive`` (R,) bool; ``mtype`` (R,) int32; ``cap``
    the firefly clamp (0: off).

    Returns (origin, area, sky): the segments' shared origin ``point +
    n_unit * 1e-3`` (R, 3); for each part that is on, (direction (R, 3),
    t_max (R,), contribution (R, 3), valid (R,) bool), else None.  A
    sample is not valid at a lane that is not a live ROUGH vertex, below
    the surface or where its pdf is 0; there t_max and the contribution
    are 0, and the contribution is capped where it is valid; every output
    is defined on every lane.  CUDA tensors launch kernel L
    (``ops/kernels/bounce.nee_sample_call``); others take
    :func:`nee_sample_plain`, which computes the same bits."""
    if point.is_cuda:
        return bounce_kernels.nee_sample_call(
            point, n_unit, shading_alive, mtype, throughput, albedo,
            pixel_id, sample, b, seed, sampler, lights, env, cap)
    return nee_sample_plain(point, n_unit, shading_alive, mtype, throughput,
                            albedo, pixel_id, sample, b, seed, sampler,
                            lights, env, cap)


def nee_sample_plain(point, n_unit, shading_alive, mtype, throughput, albedo,
                     pixel_id, sample, b: int, seed: int,
                     sampler: str = "pcg", lights: AreaLights | None = None,
                     env=None, cap: float = 0.0):
    """Plain version of :func:`nee_sample` on any device (kernel L's
    twin): ``sample_lights`` and ``EnvMap.sample_direction`` / ``sample``
    on every lane, the weights masked after."""
    is_diffuse = mtype == ROUGH
    origin = point + n_unit * 1e-3
    area = sky = None
    if lights is not None:
        wl, dist, pdf_l, emitted, _ = sample_lights(
            lights, point, pixel_id, sample, b, seed ^ _DIM_LIGHT, sampler)
        cos_s = dot(wl, n_unit)
        valid = (shading_alive & is_diffuse & (cos_s > 0.0)
                 & (pdf_l > 0.0))
        cos_c = torch.clamp(cos_s, min=0.0)
        w_nee = pdf_l / torch.clamp(pdf_l + cos_c / PI, min=1e-12)
        contrib = (throughput * (albedo / PI) * emitted
                   * (cos_c / torch.clamp(pdf_l, min=1e-12)
                      * w_nee)[..., None])
        # ending before the light
        area = (wl, torch.where(valid, dist - 2e-3, 0.0),
                torch.where(valid[..., None], _capped(contrib, cap), 0.0),
                valid)
    if env is not None:
        # dims 0/1 pick the texel, dims 2/3 jitter inside it
        ub, ut, uj, vj = rng.uniform4(pixel_id, sample, b, seed ^ _DIM_ENV,
                                      sampler)
        we, pdf_e = env.sample_direction(ub, ut, uj, vj)
        cos_e = dot(we, n_unit)
        valid_e = (shading_alive & is_diffuse & (cos_e > 0.0)
                   & (pdf_e > 0.0))
        le = env.sample(we)
        cos_ec = torch.clamp(cos_e, min=0.0)
        w_env = pdf_e / torch.clamp(pdf_e + cos_ec / PI, min=1e-12)
        contrib_e = (throughput * (albedo / PI) * le
                     * (cos_ec / torch.clamp(pdf_e, min=1e-12)
                        * w_env)[..., None])
        sky = (we, torch.where(valid_e, INF, 0.0),
               torch.where(valid_e[..., None], _capped(contrib_e, cap), 0.0),
               valid_e)
    return origin, area, sky


def nee_add(radiance, c_l, valid_l, occ_l, c_e, valid_e, occ_e):
    """The post-query half of :func:`trace_path`'s next-event estimation:
    ``radiance`` (R, 3) plus the area contribution ``c_l`` where its
    sample is valid (``valid_l`` (R,) bool) and its segment not occluded
    (``occ_l`` (R,) bool), then plus the environment's (``c_e``,
    ``valid_e``, ``occ_e``); a part whose contribution is None is off.
    CUDA tensors launch kernel M (``ops/kernels/bounce.nee_add_call``),
    which reads a contribution only where it is added; others take
    :func:`nee_add_plain`, which computes the same bits."""
    if radiance.is_cuda:
        return bounce_kernels.nee_add_call(radiance, c_l, valid_l, occ_l,
                                           c_e, valid_e, occ_e)
    return nee_add_plain(radiance, c_l, valid_l, occ_l, c_e, valid_e, occ_e)


def nee_add_plain(radiance, c_l, valid_l, occ_l, c_e, valid_e, occ_e):
    """Plain version of :func:`nee_add` (kernel M's twin)."""
    for contrib, valid, occluded in ((c_l, valid_l, occ_l),
                                     (c_e, valid_e, occ_e)):
        if contrib is not None:
            radiance = radiance + torch.where(
                (valid & ~occluded)[..., None], contrib, 0.0)
    return radiance


def hit_radiance(radiance, d, prev_pdf, throughput, missed, hit_alive, hit,
                 mtype, emission, prim_diff, b: int, background,
                 lights: AreaLights | None = None, env=None, cap: float = 0.0,
                 restir_direct: bool = False):
    """The radiance :func:`trace_path` adds where bounce ``b``'s rays end:
    the ``missed`` lanes' miss radiance (``env``'s bilinear lookup, else
    ``background`` (3,)), MIS-weighted against the environment sample when
    ``env`` has sampling tables, then the emitted radiance of EMISSIVE
    ``hit_alive`` lanes, MIS-weighted against the area-light sample when
    ``lights`` (None: none) holds the hit triangle; each capped at ``cap``
    (0: off).  With ``restir_direct`` bounce 0 adds no emitted radiance
    and bounce 1 none where ``prim_diff`` (the primary vertex was
    diffuse).  ``d``, ``throughput``, ``emission``, ``radiance``: (R, 3)
    float32; ``prev_pdf`` (R,) float32; ``missed``, ``hit_alive``,
    ``prim_diff`` (R,) bool; ``mtype`` (R,) int32; ``hit`` the wave's
    Hit.  Returns the new radiance.  CUDA tensors launch kernel N
    (``ops/kernels/bounce.hit_radiance_call``); others take
    :func:`hit_radiance_plain`, which computes the same bits."""
    if radiance.is_cuda:
        return bounce_kernels.hit_radiance_call(
            radiance, d, prev_pdf, throughput, missed, hit_alive, hit, mtype,
            emission, prim_diff, b, background, lights, env, cap,
            restir_direct)
    return hit_radiance_plain(radiance, d, prev_pdf, throughput, missed,
                              hit_alive, hit, mtype, emission, prim_diff, b,
                              background, lights, env, cap, restir_direct)


def hit_radiance_plain(radiance, d, prev_pdf, throughput, missed, hit_alive,
                       hit, mtype, emission, prim_diff, b: int, background,
                       lights: AreaLights | None = None, env=None,
                       cap: float = 0.0, restir_direct: bool = False):
    """Plain version of :func:`hit_radiance` (kernel N's twin): the lookup
    and both pdfs on every lane, masked after."""
    miss_radiance = env.sample(d) if env is not None else background
    if env is not None and env.can_sample:
        # the MIS counterpart of the environment NEE
        env_pdf_here = env.pdf_solid_angle(d)
        w_miss = torch.where(
            prev_pdf > 0.0,
            prev_pdf / torch.clamp(prev_pdf + env_pdf_here, min=1e-12),
            1.0)[..., None]
    else:
        w_miss = 1.0
    radiance = radiance + _capped(torch.where(
        missed[..., None], throughput * miss_radiance * w_miss, 0.0), cap)

    is_emitter = hit_alive & (mtype == EMISSIVE)
    if lights is not None:
        nee_pdf_here = light_pdf_solid_angle(
            lights, hit.prim_id, hit.prim_type == isect.PRIM_TRIANGLE, d,
            hit.t)
        w_bsdf = torch.where(
            prev_pdf > 0.0,
            prev_pdf / torch.clamp(prev_pdf + nee_pdf_here, min=1e-12), 1.0)
    else:
        w_bsdf = torch.ones_like(prev_pdf)
    emit_vis = is_emitter
    if restir_direct and b == 0:
        emit_vis = torch.zeros_like(is_emitter)
    elif restir_direct and b == 1:
        emit_vis = is_emitter & ~prim_diff
    return radiance + _capped(torch.where(
        emit_vis[..., None], throughput * emission * w_bsdf[..., None], 0.0),
        cap)


def _nee_shadow_fn(intersector, incoh, cam_point, cam_tiles):
    """The any-hit query of area-light shadow segments: the bundle engine
    when the caller has a camera tile layout, the intersector has
    ``intersect_bundled``, the scene has at least BUNDLE_MIN_CLUSTERS
    clusters and ``ORT_BUNDLE_NEE`` is not "0"; else the incoherent
    marcher.  Bounce extension rays and environment occlusion never take
    bundles: their t_max is unbounded and their directions hemispherical,
    so the binning pairs a block with most of the scene."""
    if (cam_point is None or cam_tiles is None
            or not hasattr(intersector, "intersect_bundled")):
        return incoh.any_hit
    clusters = getattr(intersector, "clusters", None)
    enough = getattr(clusters, "num_clusters", 0) >= BUNDLE_MIN_CLUSTERS
    if os.environ.get("ORT_BUNDLE_NEE", "1") != "0" and enough:
        return make_tiled_bundle_intersect(intersector, *cam_tiles).any_hit
    return incoh.any_hit


def trace_path(scene: Scene, materials: MaterialTable,
               lights: AreaLights | None, origins, directions, pixel_id,
               sample, seed: int, background, max_depth: int = 8,
               intersector=None, env=None, textures=None, rr_start: int = 3,
               clamp: float = 0.0, want_aux: bool = False,
               sampler: str = "pcg", restir_direct: bool = False,
               first_hit=None, cam_point=None, cam_tiles=None):
    """Trace a wave with NEE + MIS.  Returns (radiance, albedo_g,
    normal_g), each (R, 3); with ``want_aux`` also (t (R,), prim_id (R,))
    of the primary hit (INF / -1 on a miss or a sphere hit).

    ``lights`` may be None (BSDF sampling only).  ``rr_start``: the bounce
    where Russian roulette begins (>= max_depth: off).  ``clamp`` > 0 caps
    each indirect (bounce >= 1) contribution per channel.  ``cam_point``
    / ``cam_tiles`` ((S, H, W, th, tw)): the camera wave's shared origin
    and tile layout, which route bounce 0 through the raster engine and
    the area-light shadow segments through the bundle engine.

    ``restir_direct``: a ReSTIR reservoir pass estimates the primary
    vertex's area-light direct lighting (``render/restir.
    render_restir_gi``), so this trace adds only the rest: it drops the
    bounce-0 miss and emitter radiance (ReSTIR's base image), the bounce-0
    area-light NEE, and the bounce-1 emitter hits of paths whose primary
    vertex is diffuse (those BSDF samples estimate the same direct
    integral).  Delta primaries keep their bounce-1 emitter hits and the
    bounce-0 environment NEE stays, so ReSTIR direct plus this trace is
    unbiased.  ``first_hit``: the bounce-0 Hit, already traced by the
    caller."""
    if intersector is None:
        intersector = isect.BruteForceIntersector()
    incoh = getattr(intersector, "for_incoherent", lambda: intersector)()
    shadow_any_hit = _nee_shadow_fn(intersector, incoh, cam_point, cam_tiles)
    first_fn = intersector.intersect
    if cam_point is not None and cam_tiles is not None:
        first_fn = make_camera_intersect(intersector, cam_point, *cam_tiles)
    shade_fn = isect.shading_frame_fn(intersector)
    dev = origins.device
    nrays = origins.shape[0]
    background = device_constant(background, dev)
    have_lights = lights is not None and lights.count > 0
    have_env_nee = env is not None and env.can_sample

    o, d = origins, directions
    throughput = torch.ones((nrays, 3), device=dev)
    radiance = torch.zeros((nrays, 3), device=dev)
    alive = torch.ones(nrays, dtype=torch.bool, device=dev)
    # pdf of the BSDF sample that made the current ray (<= 0: a delta lobe
    # or the camera ray, whose emitter hits take full weight)
    prev_pdf = torch.zeros(nrays, device=dev)
    albedo_g = torch.zeros((nrays, 3), device=dev)
    normal_g = torch.zeros((nrays, 3), device=dev)
    t_g = torch.full((nrays,), INF, device=dev)
    prim_g = torch.full((nrays,), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros(nrays, device=dev)
    inf = torch.full((nrays,), INF, device=dev)
    # restir_direct: was this lane's primary vertex diffuse?
    prim_diff = torch.zeros(nrays, dtype=torch.bool, device=dev)

    for b in range(max_depth):
        # the firefly clamp, on indirect bounces only (0: off)
        cap = clamp if b >= 1 and clamp > 0.0 else 0.0

        with profiling.span("path.intersect"):
            # dead lanes trace with t_max=0: free in the marchers and absent
            # from the bundle engine's block bounds
            if b == 0 and first_hit is not None:
                hit = first_hit
            else:
                fn = first_fn if b == 0 else incoh.intersect
                hit = fn(scene, o, d, t_max=torch.where(alive, inf, zero))
            missed = alive & ~hit.is_hit
            if restir_direct and b == 0:
                missed = torch.zeros_like(missed)   # in ReSTIR's base image
            hit_alive = alive & hit.is_hit

        with profiling.span("path.shade"):
            point, normal, front_face, material_id = shade_fn(scene, o, d, hit)
            n_unit = normalize(normal)
            mtype, albedo, param, emission = materials.gather(material_id)
            if textures is not None:
                albedo = albedo * textures.sample(
                    material_id, isect.interpolate_uv(scene, hit))

        with profiling.span("path.hit_radiance"):
            # the miss term, then emitted light at BSDF hits, MIS-weighted
            radiance = hit_radiance(
                radiance, d, prev_pdf, throughput, missed, hit_alive, hit,
                mtype, emission, prim_diff, b, background,
                lights if have_lights else None, env, cap, restir_direct)

        with profiling.span("path.shade"):
            is_emitter = hit_alive & (mtype == EMISSIVE)
            # guide buffers
            if b == 0:
                albedo_g = torch.where(
                    hit_alive[..., None],
                    torch.where((mtype == EMISSIVE)[..., None], emission,
                                albedo),
                    albedo_g)
                normal_g = torch.where(hit_alive[..., None], n_unit, normal_g)
                if want_aux:
                    t_g = torch.where(hit_alive, hit.t, t_g)
                    prim_g = torch.where(
                        hit_alive & (hit.prim_type == isect.PRIM_TRIANGLE),
                        hit.prim_id, prim_g)

            shading_alive = hit_alive & ~is_emitter
            if b == 0:
                prim_diff = hit_alive & (mtype == ROUGH)

        # ---- NEE at diffuse vertices: one area-light sample (with
        # restir_direct the reservoir pass owns bounce 0's) and one
        # environment sample, their shadow segments, their contributions
        area_on = have_lights and not (restir_direct and b == 0)
        if area_on or have_env_nee:
            with profiling.span("path.nee_sample"):
                origin, area, sky = nee_sample(
                    point, n_unit, shading_alive, mtype, throughput, albedo,
                    pixel_id, sample, b, seed, sampler,
                    lights if area_on else None,
                    env if have_env_nee else None, cap)
            occ_l = occ_e = None
            if area is not None:
                with profiling.span("path.area_nee.query"):
                    occ_l = shadow_any_hit(scene, origin, area[0],
                                           t_min=1e-4, t_max=area[1])
            if sky is not None:
                # occlusion to infinity: the marcher, not bundles
                with profiling.span("path.env_nee.query"):
                    occ_e = incoh.any_hit(scene, origin, sky[0], t_min=1e-4,
                                          t_max=sky[1])
            c_l, valid_l = area[2:] if area else (None, None)
            c_e, valid_e = sky[2:] if sky else (None, None)
            with profiling.span("path.nee_add"):
                radiance = nee_add(radiance, c_l, valid_l, occ_l, c_e,
                                   valid_e, occ_e)

        with profiling.span("path.bsdf"):
            o, d, throughput, prev_pdf, alive = bsdf_step(
                d, n_unit, point, front_face, mtype, albedo, param,
                throughput, shading_alive, o, pixel_id, sample, b, seed,
                sampler, rr_start)

    if want_aux:
        return radiance, albedo_g, normal_g, (t_g, prim_g)
    return radiance, albedo_g, normal_g


def render_path(scene: Scene, materials: MaterialTable, lights, camera,
                width: int, height: int, spp: int = 16, seed: int = 0,
                background=(0.0, 0.0, 0.0), max_depth: int = 8,
                intersector=None, env=None, textures=None,
                jitter: bool = True, rr_start: int = 3, clamp: float = 0.0,
                samples_per_wave: int | None = None, want_aux: bool = False,
                sampler: str = "pcg", sample_offset: int = 0):
    """A path-traced frame on the device of the camera's tensors, with
    ``wavefront.render``'s conventions: (image, albedo, normal), each (H,
    W, 3), and with ``want_aux`` the (t, prim) primary-hit buffers of the
    first sample.  ``samples_per_wave`` (default 1) merges samples of a
    pixel into one wave; the RNG streams are keyed by (pixel, sample,
    bounce), so merging changes no result.  ``sample_offset`` continues
    the global sample counter (progressive batches); the aux taps are
    those of global sample 0."""
    dev = camera.center.device
    npix = width * height
    S = samples_per_wave or 1
    if spp % S:
        raise ValueError(f"samples_per_wave={S} must divide spp={spp}")
    pix_rep = torch.arange(npix, dtype=torch.int64, device=dev).repeat(S)
    cam_tiles = camera_tile_layout(intersector, camera, S, height, width)

    rad = torch.zeros((npix, 3), device=dev)
    alb = torch.zeros((npix, 3), device=dev)
    nrm = torch.zeros((npix, 3), device=dev)
    t_aux = torch.full((npix,), INF, device=dev)
    prim_aux = torch.full((npix,), -1, dtype=torch.int32, device=dev)
    for s0 in range(0, spp, S):
        first = sample_offset + s0
        samp = torch.arange(first, first + S, dtype=torch.int64,
                            device=dev).repeat_interleave(npix)
        if jitter:
            u1, u2 = rng.stratified_jitter(pix_rep, samp, seed, sampler)
            jit_uv = torch.stack([u1, u2], -1).reshape(S, height, width, 2)
        else:
            jit_uv = torch.full((S, height, width, 2), 0.5, device=dev)
        lens = None
        if camera.aperture > 0.0:
            lens = rng.random_in_unit_disk(
                pix_rep, samp, -2, seed ^ _DIM_LENS, sampler
            ).reshape(S, height, width, 2)
        o, d = camera.generate_rays(width, height, jit_uv, lens_uv=lens)
        out = trace_path(
            scene, materials, lights, o.reshape(-1, 3), d.reshape(-1, 3),
            pix_rep, samp, seed, background, max_depth, intersector, env,
            textures, rr_start, clamp, want_aux=want_aux, sampler=sampler,
            cam_point=camera.center if cam_tiles else None,
            cam_tiles=cam_tiles)
        rad = rad + out[0].reshape(S, npix, 3).sum(0)
        alb = alb + out[1].reshape(S, npix, 3).sum(0)
        nrm = nrm + out[2].reshape(S, npix, 3).sum(0)
        if want_aux and first == 0:
            t_aux, prim_aux = out[3][0][:npix], out[3][1][:npix]
    inv = 1.0 / spp
    outs = (rad.reshape(height, width, 3) * inv,
            alb.reshape(height, width, 3) * inv,
            nrm.reshape(height, width, 3) * inv)
    if want_aux:
        return outs + ((t_aux.reshape(height, width),
                        prim_aux.reshape(height, width)),)
    return outs
