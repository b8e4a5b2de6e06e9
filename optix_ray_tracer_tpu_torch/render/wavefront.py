"""Whitted wavefront integrator (port of
``optix_ray_tracer_tpu/render/wavefront.py``).

The reference shades by recursion (closest-hit re-invokes ``optixTrace``
up to depth 5 and multiplies by the albedo on unwind); here a Python loop
over bounce depth carries SoA ray state for the whole wave, and the
unwind multiply becomes a running throughput product.  Bounce index b in
[0, max_depth) is the reference's payload depth b + 1; a hit on the last
bounce contributes nothing.  Extensions kept from the JAX package:
DIELECTRIC and EMISSIVE materials, first-bounce albedo/normal guides and
an environment map in place of the background on a miss.  ``sampler``
selects the PCG4D stream or Owen-scrambled Sobol (``utils/qmc.py``).
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.ops import intersect as isect
from optix_ray_tracer_tpu_torch.ops.kernels import bounce as bounce_kernels
from optix_ray_tracer_tpu_torch.ops.raster import (
    camera_tile_layout, make_camera_intersect,
)
from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.scene.materials import (
    DIELECTRIC, EMISSIVE, METAL, MaterialTable,
)
from optix_ray_tracer_tpu_torch.utils import rng
from optix_ray_tracer_tpu_torch.utils.tensors import device_constant
from optix_ray_tracer_tpu_torch.utils.vecmath import (
    EPS, INF, dot, length_squared, normalize, reflect, refract,
    schlick_fresnel,
)

# decorrelation constants folded into the RNG seed per random purpose
_DIM_SCATTER = 0x1E3779B9
_DIM_FUZZ = 0x05EBCA6B
_DIM_FRESNEL = 0x42B2AE35
_DIM_LENS = 0x68E31DA4

DEFAULT_MAX_DEPTH = 5
DEFAULT_BACKGROUND = (0.7, 0.8, 0.9)


def scatter(materials: MaterialTable, material_id, d_in, normal, front_face,
            pixel_id, sample, bounce: int, seed: int, sampler: str = "pcg"):
    """Scattered direction and attenuation for a batch of hits.

    Returns (new_dir (R, 3) unit, attenuation (R, 3), emitted (R, 3),
    terminate (R,): True for EMISSIVE hits, which end the path).  CUDA
    tensors launch kernel J (``ops/kernels/bounce.scatter_call``); others
    take :func:`scatter_plain`, which computes the same bits."""
    if d_in.is_cuda:
        return bounce_kernels.scatter_call(
            materials, material_id, d_in, normal, front_face, pixel_id,
            sample, bounce, seed, sampler)
    return scatter_plain(materials, material_id, d_in, normal, front_face,
                         pixel_id, sample, bounce, seed, sampler)


def scatter_plain(materials: MaterialTable, material_id, d_in, normal,
                  front_face, pixel_id, sample, bounce: int, seed: int,
                  sampler: str = "pcg"):
    """Plain version of :func:`scatter` on any device (kernel J's twin):
    every BSDF branch is evaluated and blended by masks, its draws from
    ``rng.uniform4_plain``."""
    mtype, albedo, param, emission = materials.gather(material_id)
    n = normalize(normal)

    def draw(salt):
        return rng.uniform4_plain(pixel_id, sample, bounce, seed ^ salt,
                                  sampler)

    # ROUGH: normal + unit-sphere sample, guarded against cancellation
    rand_unit = rng.unit_vector_from(*draw(_DIM_SCATTER)[:2])
    d_rough = n + rand_unit
    degenerate = length_squared(d_rough) < EPS
    d_rough = torch.where(degenerate[..., None], n, d_rough)

    # METAL: mirror + fuzz * unit-sphere sample
    d_metal = normalize(reflect(d_in, n))
    fuzz_vec = rng.unit_vector_from(*draw(_DIM_FUZZ)[:2])
    d_metal = d_metal + param[..., None] * fuzz_vec

    # DIELECTRIC: refract unless total internal reflection / Schlick
    ior = torch.where(param > 0.0, param, torch.full_like(param, 1.5))
    eta = torch.where(front_face, 1.0 / ior, ior)
    cos_theta = torch.clamp(-dot(d_in, n), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = eta * sin_theta > 1.0
    u_fresnel = draw(_DIM_FRESNEL)[0]
    do_reflect = cannot_refract | (schlick_fresnel(cos_theta, ior)
                                   > u_fresnel)
    d_refr = refract(d_in, n, eta[..., None])
    d_diel = torch.where(do_reflect[..., None], normalize(reflect(d_in, n)),
                         d_refr)

    is_metal = (mtype == METAL)[..., None]
    is_diel = (mtype == DIELECTRIC)[..., None]
    new_dir = torch.where(is_diel, d_diel,
                          torch.where(is_metal, d_metal, d_rough))

    # numeric fallback: non-finite or near-zero -> normal -> +z
    def bad(x):
        return (~torch.isfinite(x).all(-1)) | (length_squared(x) <= EPS)

    new_dir = torch.where(bad(new_dir)[..., None], n, new_dir)
    fallback = torch.tensor([0.0, 0.0, 1.0], device=new_dir.device
                            ).expand(new_dir.shape)
    new_dir = normalize(torch.where(bad(new_dir)[..., None], fallback,
                                    new_dir))
    attenuation = torch.where(is_diel, torch.ones_like(albedo), albedo)
    return new_dir, attenuation, emission, mtype == EMISSIVE


def trace(scene: Scene, materials: MaterialTable, origins, directions,
          pixel_id, sample, seed: int, background,
          max_depth: int = DEFAULT_MAX_DEPTH, intersector=None, env=None,
          want_aux: bool = False, sampler: str = "pcg", cam_point=None,
          cam_tiles=None):
    """Trace a wave of rays to completion.

    origins/directions (R, 3); pixel_id, sample (R,) int; background (3,),
    or ``env`` (``render/envmap.EnvMap``) looked up on a miss.
    With ``cam_point``/``cam_tiles`` ((S, H, W, th, tw)) and an intersector
    carrying raster tables, bounce 0 runs through the tile-raster engine;
    bounces >= 1 take the intersector's incoherent (probe-sorted) variant.

    Returns (radiance, albedo_guide, normal_guide), each (R, 3); with
    ``want_aux`` also (t, prim_id) of the primary hit (INF / -1 on miss).
    """
    if intersector is None:
        intersector = isect.BruteForceIntersector()
    incoh = getattr(intersector, "for_incoherent", lambda: intersector)()
    first_fn = intersector.intersect
    if cam_point is not None and cam_tiles is not None:
        # bounce extension rays stay on the marcher: infinite t_max and
        # hemispherical directions pair with most of the scene
        first_fn = make_camera_intersect(intersector, cam_point, *cam_tiles)
    shade_fn = isect.shading_frame_fn(intersector)
    dev = origins.device
    nrays = origins.shape[0]
    background = device_constant(background, dev)

    o, d = origins, directions
    throughput = torch.ones((nrays, 3), device=dev)
    radiance = torch.zeros((nrays, 3), device=dev)
    alive = torch.ones(nrays, dtype=torch.bool, device=dev)
    albedo_g = torch.zeros((nrays, 3), device=dev)
    normal_g = torch.zeros((nrays, 3), device=dev)
    t_g = torch.full((nrays,), INF, device=dev)
    prim_g = torch.full((nrays,), -1, dtype=torch.int32, device=dev)

    for b in range(max_depth):
        fn = first_fn if b == 0 else incoh.intersect
        # dead lanes trace with t_max=0: they request no clusters
        hit = fn(scene, o, d, t_max=torch.where(
            alive, torch.full((nrays,), INF, device=dev),
            torch.zeros(nrays, device=dev)))
        missed = alive & ~hit.is_hit
        hit_alive = alive & hit.is_hit
        miss_radiance = env.sample(d) if env is not None else background
        radiance = radiance + torch.where(missed[..., None],
                                          throughput * miss_radiance, 0.0)

        point, normal, front_face, material_id = shade_fn(scene, o, d, hit)
        new_dir, attenuation, emission, emissive_hit = scatter(
            materials, material_id, d, normal, front_face, pixel_id, sample,
            b, seed, sampler)
        radiance = radiance + torch.where(
            (hit_alive & emissive_hit)[..., None], throughput * emission,
            0.0)
        if b == 0:
            albedo_g = torch.where(hit_alive[..., None], attenuation,
                                   albedo_g)
            normal_g = torch.where(hit_alive[..., None], normalize(normal),
                                   normal_g)
            if want_aux:
                t_g = torch.where(hit_alive, hit.t, t_g)
                prim_g = torch.where(
                    hit_alive & (hit.prim_type == isect.PRIM_TRIANGLE),
                    hit.prim_id, prim_g)
        scattered = hit_alive & ~emissive_hit
        throughput = torch.where(scattered[..., None],
                                 throughput * attenuation, throughput)
        o = torch.where(scattered[..., None], point, o)
        d = torch.where(scattered[..., None], new_dir, d)
        alive = scattered
    if want_aux:
        return radiance, albedo_g, normal_g, (t_g, prim_g)
    return radiance, albedo_g, normal_g


def _default_samples_per_wave(spp: int) -> int:
    """Largest of 4/2/1 dividing spp: merged samples of a pixel share
    clusters."""
    for s in (4, 2, 1):
        if spp % s == 0:
            return s
    return 1


def render(scene: Scene, materials: MaterialTable, camera, width: int,
           height: int, spp: int = 1, seed: int = 0,
           background=DEFAULT_BACKGROUND, max_depth: int = DEFAULT_MAX_DEPTH,
           intersector=None, env=None, jitter: bool = True,
           samples_per_wave: int | None = None, want_aux: bool = False,
           sampler: str = "pcg", sample_offset: int = 0):
    """Render a frame: spp jittered samples per pixel, accumulated in
    linear space, on the device of the camera's tensors.

    ``samples_per_wave`` merges S samples of every pixel into one wave
    (must divide spp).  ``sample_offset`` continues the global sample
    counter (progressive batches: jitter strata and Sobol sequences go on
    as one stream).  Returns (image, albedo, normal), each (H, W, 3); with
    ``want_aux`` also (t, prim_id) of the primary hits of global sample 0
    (INF / -1 when this call does not draw it)."""
    if intersector is None:
        intersector = isect.BruteForceIntersector()
    dev = camera.center.device
    npix = width * height
    S = samples_per_wave or _default_samples_per_wave(spp)
    if spp % S:
        raise ValueError(f"samples_per_wave={S} must divide spp={spp}")
    pix_rep = torch.arange(npix, dtype=torch.int64, device=dev).repeat(S)
    cam_tiles = camera_tile_layout(intersector, camera, S, height, width)

    rad = torch.zeros((npix, 3), device=dev)
    alb = torch.zeros((npix, 3), device=dev)
    nrm = torch.zeros((npix, 3), device=dev)
    t_aux = torch.full((npix,), INF, device=dev)
    prim_aux = torch.full((npix,), -1, dtype=torch.int32, device=dev)
    for s0 in range(sample_offset, sample_offset + spp, S):
        samp = torch.arange(s0, s0 + S, dtype=torch.int64,
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
        out = trace(scene, materials, o.reshape(-1, 3), d.reshape(-1, 3),
                    pix_rep, samp, seed, background, max_depth, intersector,
                    env=env, want_aux=want_aux, sampler=sampler,
                    cam_point=camera.center if cam_tiles else None,
                    cam_tiles=cam_tiles)
        rad = rad + out[0].reshape(S, npix, 3).sum(0)
        alb = alb + out[1].reshape(S, npix, 3).sum(0)
        nrm = nrm + out[2].reshape(S, npix, 3).sum(0)
        if want_aux and s0 == 0:
            t_aux, prim_aux = out[3][0][:npix], out[3][1][:npix]
    inv = 1.0 / spp
    outs = (rad.reshape(height, width, 3) * inv,
            alb.reshape(height, width, 3) * inv,
            nrm.reshape(height, width, 3) * inv)
    if want_aux:
        return outs + ((t_aux.reshape(height, width),
                        prim_aux.reshape(height, width)),)
    return outs
