"""Rendering over a (tile, sample) grid of devices (port of
``optix_ray_tracer_tpu/parallel/sharding.py``).

Two axes, composable:

* ``tile``: the pixel grid splits into row bands, one per row of the
  mesh; each band traces only its rows.  Scene, intersector and
  materials are replicated (:func:`broadcast_scene`).
* ``sample``: the samples per pixel split over the mesh's columns; the
  partial sums of a band are added in sample-shard order on the mesh's
  first device.

The JAX package runs one ``shard_map`` program over its devices; here one
process walks the grid: each shard traces on its own device, and the
bands gather on the first device.  A device may repeat, so one card (or
the CPU, as the tests use it) can hold a mesh of several shards.  The
counter-based RNG keys off global (pixel, sample) ids, so the image does
not depend on the mesh beyond the rounding of the partial sums.
"""

from __future__ import annotations

import dataclasses

import torch

from optix_ray_tracer_tpu_torch.ops.raster import camera_tile_layout
from optix_ray_tracer_tpu_torch.render import pathtracer, wavefront
from optix_ray_tracer_tpu_torch.render import restir as R
from optix_ray_tracer_tpu_torch.utils import rng
from optix_ray_tracer_tpu_torch.utils.tensors import tree_map
from optix_ray_tracer_tpu_torch.utils.vecmath import INF


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tile, sample) grid of torch devices, walked by one process.
    ``shape`` is ``{"tile": T, "sample": S}`` as on a JAX mesh."""
    devices: tuple

    @property
    def shape(self) -> dict:
        return {"tile": len(self.devices), "sample": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]

    def distinct(self) -> list:
        """The mesh's devices, each once, in grid order."""
        out = []
        for row in self.devices:
            for dev in row:
                if dev not in out:
                    out.append(dev)
        return out


def _canonical(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(tile: int = 1, sample: int = 1, devices=None) -> Mesh:
    """A (tile, sample) mesh of the first tile * sample of ``devices``
    (None: every visible CUDA device; without CUDA it raises, naming the
    CPU form).  A device may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=[torch.device(\"cpu\")] * n "
                "to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    need = tile * sample
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    devs = [_canonical(d) for d in devices[:need]]
    return Mesh(tuple(tuple(devs[t * sample:(t + 1) * sample])
                      for t in range(tile)))


def _on(obj, dev):
    """``obj`` on ``dev``: tensors and tensor dataclasses move (a no-op
    when already there); tuples and dicts map; anything else is shared."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        return tuple(_on(x, dev) for x in obj)
    if isinstance(obj, dict):
        return {k: _on(v, dev) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return tree_map(lambda t: t.to(dev), obj)
    return obj


def broadcast_scene(scene_host, mesh: Mesh) -> dict:
    """``scene_host`` (a scene, any tensor dataclass, or a tuple of them)
    copied once to every distinct device of ``mesh``: {device: copy}."""
    return {dev: _on(scene_host, dev) for dev in mesh.distinct()}


def _check_mesh(mesh: Mesh, height: int, spp: int):
    n_tile, n_sample = mesh.shape["tile"], mesh.shape["sample"]
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile={n_tile}")
    if spp % n_sample != 0:
        raise ValueError(f"spp {spp} not divisible by sample={n_sample}")
    return height // n_tile, spp // n_sample


def _tile_rays(camera, width: int, height: int, rows_per_shard: int,
               tile_idx: int, spp_offset: int, sample_in_shard: int,
               pixel_id, seed: int, jitter: bool, sampler: str = "pcg"):
    """Primary rays (R, 3) of one row band with global pixel ids, jitter
    and lens streams: for every pixel the rays of ``wavefront.render``."""
    samp = torch.full_like(pixel_id, spp_offset + sample_in_shard)
    jit = None
    if jitter:
        u1, u2 = rng.stratified_jitter(pixel_id, samp, seed, sampler)
        jit = torch.stack([u1, u2], -1)
    lens = None
    if camera.aperture > 0.0:
        lens = rng.random_in_unit_disk(pixel_id, samp, -2,
                                       seed ^ wavefront._DIM_LENS, sampler)
    return camera.generate_rays_for_pixels(pixel_id, width, height, jit,
                                           lens_uv=lens)


def render_bands(mesh: Mesh, width: int, height: int, spp: int,
                 trace_sample, want_aux: bool = False):
    """The banded frame loop shared by the sharded integrators.

    ``trace_sample(dev, tile_idx, pixel_id, sample) -> (radiance, albedo,
    normal[, (t, prim)])`` traces one sample of a band's pixels (global
    ids, int64 on ``dev``) on ``dev``.  Each shard sums its samples in
    order; a band's shard sums are added in sample-shard order on the
    first device, divided by ``spp``, and the bands concatenated.  Returns
    (image, albedo, normal), each (H, W, 3) on the first device; with
    ``want_aux`` also (t, prim) (H, W) of global sample 0."""
    rows_per, spp_per = _check_mesh(mesh, height, spp)
    npix = rows_per * width
    first = mesh.first
    bands, taps = [], []
    for tile_idx, row in enumerate(mesh.devices):
        total = None
        for sample_idx, dev in enumerate(row):
            pixel_id = (tile_idx * npix
                        + torch.arange(npix, dtype=torch.int64, device=dev))
            acc = [torch.zeros((npix, 3), device=dev) for _ in range(3)]
            for s_local in range(spp_per):
                sample = sample_idx * spp_per + s_local
                out = trace_sample(dev, tile_idx, pixel_id, sample)
                acc = [a + x for a, x in zip(acc, out[:3])]
                if want_aux and sample == 0:
                    taps.append(tuple(x.to(first) for x in out[3]))
            acc = [a.to(first) for a in acc]
            total = acc if total is None else [
                t + a for t, a in zip(total, acc)]
        bands.append([(t * (1.0 / spp)).reshape(rows_per, width, 3)
                      for t in total])
    outs = tuple(torch.cat([b[i] for b in bands]) for i in range(3))
    if want_aux:
        outs += ((torch.cat([t for t, _ in taps]).reshape(height, width),
                  torch.cat([p for _, p in taps]).reshape(height, width)),)
    return outs


def _band_route(intersector, camera, rows_per: int, width: int):
    """(cam_point, cam_tiles) of a band's camera wave: the raster engine
    when the band tiles cleanly, else (None, None), the marcher."""
    tiles = camera_tile_layout(intersector, camera, 1, rows_per, width)
    return (camera.center if tiles is not None else None), tiles


def render_sharded(scene, materials, camera, width: int, height: int,
                   spp: int, mesh: Mesh, seed: int = 0,
                   background=wavefront.DEFAULT_BACKGROUND,
                   max_depth: int = wavefront.DEFAULT_MAX_DEPTH,
                   intersector=None, jitter: bool = True, env=None,
                   want_guides: bool = False, sampler: str = "pcg",
                   want_aux: bool = False):
    """A Whitted frame with the pixel rows sharded over ``tile`` and the
    samples over ``sample``.  Returns the (H, W, 3) linear image on the
    mesh's first device; with ``want_guides`` (image, albedo, normal);
    with ``want_aux`` also ``wavefront.render``'s (t, prim) taps of global
    sample 0, for the fused loop's temporal blend."""
    rows_per, _ = _check_mesh(mesh, height, spp)
    if intersector is None:
        from optix_ray_tracer_tpu_torch.ops.traverse import (
            BruteForceIntersector,
        )
        intersector = BruteForceIntersector()
    reps = broadcast_scene((scene, materials, camera, intersector, env),
                           mesh)

    def trace_sample(dev, tile_idx, pixel_id, sample):
        sc, mats, cam, inter, en = reps[dev]
        o, d = _tile_rays(cam, width, height, rows_per, tile_idx, sample,
                          0, pixel_id, seed, jitter, sampler)
        point, tiles = _band_route(inter, cam, rows_per, width)
        return wavefront.trace(sc, mats, o, d, pixel_id,
                               torch.full_like(pixel_id, sample), seed,
                               background, max_depth, inter, env=en,
                               want_aux=want_aux, sampler=sampler,
                               cam_point=point, cam_tiles=tiles)

    outs = render_bands(mesh, width, height, spp, trace_sample, want_aux)
    return outs if want_guides or want_aux else outs[0]


def render_path_sharded(scene, materials, lights, camera, width: int,
                        height: int, spp: int, mesh: Mesh, seed: int = 0,
                        background=(0.0, 0.0, 0.0), max_depth: int = 8,
                        intersector=None, env=None, textures=None,
                        jitter: bool = True, want_guides: bool = False,
                        sampler: str = "pcg", want_aux: bool = False):
    """NEE+MIS path tracing over the mesh, with :func:`render_sharded`'s
    contract."""
    rows_per, _ = _check_mesh(mesh, height, spp)
    reps = broadcast_scene((scene, materials, lights, camera, intersector,
                            env, textures), mesh)

    def trace_sample(dev, tile_idx, pixel_id, sample):
        sc, mats, lts, cam, inter, en, tex = reps[dev]
        o, d = _tile_rays(cam, width, height, rows_per, tile_idx, sample,
                          0, pixel_id, seed, jitter, sampler)
        point, tiles = _band_route(inter, cam, rows_per, width)
        return pathtracer.trace_path(
            sc, mats, lts, o, d, pixel_id, torch.full_like(pixel_id, sample),
            seed, background, max_depth, inter, en, tex, want_aux=want_aux,
            sampler=sampler, cam_point=point, cam_tiles=tiles)

    outs = render_bands(mesh, width, height, spp, trace_sample, want_aux)
    return outs if want_guides or want_aux else outs[0]


def _cat_hits(hits, dev):
    return type(hits[0])(*(torch.cat([getattr(h, f.name).to(dev)
                                      for h in hits])
                           for f in dataclasses.fields(hits[0])))


def render_restir_sharded(scene, materials, lights, camera, width: int,
                          height: int, mesh: Mesh, seed: int = 0,
                          frame: int = 0, state=None, prev_camera=None,
                          m_candidates: int = 16, spatial_taps: int = 2,
                          spatial_radius: int = 16, intersector=None,
                          background=(0.0, 0.0, 0.0), env=None,
                          textures=None, sampler: str = "pcg"):
    """ReSTIR DI (``render/restir.render_restir``) over the mesh's
    ``tile`` axis: the primary rays and the winners' shadow rays trace per
    band on the band's device; the G-buffer, the resampling with its
    temporal and cross-band spatial reuse, and the composition run once,
    whole-frame, on the first device.  Returns (image, albedo, normal,
    new_state) equal to ``render_restir``'s."""
    n_tile = mesh.shape["tile"]
    if mesh.shape["sample"] != 1:
        raise ValueError("restir renders 1 sample/pixel/frame: use a "
                         "tile-only mesh (sample axis must be 1)")
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile={n_tile}")
    R._check_lights(lights)
    if intersector is None:
        from optix_ray_tracer_tpu_torch.ops.traverse import (
            BruteForceIntersector,
        )
        intersector = BruteForceIntersector()
    band = (height // n_tile) * width
    first = mesh.first
    reps = broadcast_scene((scene, camera, intersector), mesh)

    rays, hits = [], []
    for tile_idx, (dev,) in enumerate(mesh.devices):
        sc, cam, inter = reps[dev]
        pid = tile_idx * band + torch.arange(band, dtype=torch.int64,
                                             device=dev)
        o, d = cam.generate_rays_for_pixels(pid, width, height)
        hits.append(inter.intersect(sc, o, d,
                                    t_max=torch.full((band,), INF,
                                                     device=dev)))
        rays.append((o.to(first), d.to(first)))
    o = torch.cat([r[0] for r in rays])
    d = torch.cat([r[1] for r in rays])
    hit = _cat_hits(hits, first)

    scene, camera, intersector = reps[first]
    materials, lights, env, textures, state, prev_camera = _on(
        (materials, lights, env, textures, state, prev_camera), first)
    point, n_unit, albedo, active, base, albedo_g, normal_g = R._gbuffer(
        scene, materials, o, d, hit, textures, env, background, intersector)
    packed = R._pack_lights(lights)
    li2, u22, u32, W2, m2, act2, t2, n2 = R._resample(
        lights, packed, point, n_unit, albedo, active, hit.t, width, height,
        frame, seed, state, camera, prev_camera, m_candidates, spatial_taps,
        spatial_radius, sampler)
    rgb, wdir, dist, live, Wf = R._shade_terms(packed, li2, u22, u32, W2,
                                               point, n_unit, albedo, active)
    s_o = point + n_unit * 1e-3
    s_tmax = torch.where(live, dist - 2e-3, torch.zeros_like(dist))
    occluded = []
    for tile_idx, (dev,) in enumerate(mesh.devices):
        sc, _, inter = reps[dev]
        incoh = getattr(inter, "for_incoherent", lambda: inter)()
        rows = slice(tile_idx * band, (tile_idx + 1) * band)
        occluded.append(incoh.any_hit(
            sc, s_o[rows].to(dev), wdir[rows].to(dev), t_min=1e-4,
            t_max=s_tmax[rows].to(dev)).to(first))
    return R._compose(base, rgb, Wf, live, torch.cat(occluded), li2, u22,
                      u32, m2, act2, t2, n2, albedo_g, normal_g, width,
                      height)
