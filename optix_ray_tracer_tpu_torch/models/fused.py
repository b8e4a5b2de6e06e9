"""The fused frame loop of both frontends (port of
``optix_ray_tracer_tpu/models/fused.py``): instance transforms, the
cluster refit, the integrator, the temporal blend, the denoiser and the
sRGB quantisation of a chunk of frames, all on the device, with one
host fetch per chunk.

The JAX package traces a chunk into one program (a ``lax.scan`` over
frames); here the scan is a Python loop over the chunk's frames that
adds no synchronisation of its own (the query routing still reads a
few counts on the host within each frame, as in a single render), and
the temporal state rides across frames, chunks and files.  The chunking
(the largest divisor of the file's frame count under a memory cap) and
the per-frame seeds (``cfg.seed + frames planned``) are the JAX
package's, so every frame draws the same RNG streams.  Chunks are
pipelined: a chunk's outputs go to pinned host buffers by a
``non_blocking`` copy queued right behind it, and the next chunk is
queued before the host waits for that copy.

Spans (``utils/profiling.span``): ``fused.file`` around a file's set-up
(``fused.rebuild`` inside), ``fused.chunk`` around the queueing of a
chunk and its fetch, ``fused.deliver`` around the wait for the fetch
(``sync.fetch``) and the building of the chunk's frames; inside a chunk,
``fused.frame`` holds ``fused.refit``, ``fused.trace`` and
``fused.tail``.  None is open across a ``yield``: the consumer's time
between frames lies under none of them.

With a ``mesh`` (``parallel/sharding.make_mesh``) each frame traces in
row bands, one per shard, each on its device (the JAX package's
``shard_map`` around the scan); the bands gather into full frames on the
mesh's first device, where the refit before and the temporal, denoise
and quantise tail after run once per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.models import common
from optix_ray_tracer_tpu_torch.ops.march import (
    MarchIntersector, refit_march_intersector,
)
from optix_ray_tracer_tpu_torch.parallel import sharding
from optix_ray_tracer_tpu_torch.render import (
    neural_denoise, pathtracer, wavefront,
)
from optix_ray_tracer_tpu_torch.render import temporal as tmod
from optix_ray_tracer_tpu_torch.render.denoise import (
    denoise, filter_irradiance,
)
from optix_ray_tracer_tpu_torch.render.film import Film, U8Frame
from optix_ray_tracer_tpu_torch.scene.geometry import Scene, Triangles
from optix_ray_tracer_tpu_torch.utils import profiling
from optix_ray_tracer_tpu_torch.utils.color import color_to_uint8
from optix_ray_tracer_tpu_torch.utils.vecmath import INF, normalize

# target device bytes for one chunk's stacked output buffers
_CHUNK_BYTES = 192 * 1024 * 1024


def chunk_size(width: int, height: int, n_frames: int,
               bytes_per_pixel: int = 36) -> int:
    """Frames per chunk: the largest divisor of ``n_frames`` within the
    memory cap (``bytes_per_pixel`` of stacked output per frame: 36 = 3
    float32 RGB buffers, 4 = one uint8 RGBA) and at most 16.  Divisors
    keep every chunk of a file the same length."""
    per_frame = width * height * bytes_per_pixel
    cap = max(1, min(16, _CHUNK_BYTES // max(per_frame, 1)))
    best = 1
    for c in range(1, cap + 1):
        if n_frames % c == 0:
            best = c
    return best


def _mesh_scene(fd, k, extra_spheres, extra_triangles, has_extras: bool):
    from optix_ray_tracer_tpu_torch.models.renderer_mesh import _frame_world

    # float32 products in the JAX scan's order
    shift_scale = fd["duration"] * np.float32(k) * fd["inv_frame_count"]
    world_v, normals, mat = _frame_world(
        fd["vertices"], fd["normals"], fd["tri_particle"], fd["tri_valid"],
        fd["velocities"], fd["particle_mat"], shift_scale,
        fd["particle_shift"], fd["particle_scale"])
    tris = Triangles(world_v, normals, mat)
    if has_extras:
        tris = tris.concat(extra_triangles)
    return Scene(spheres=extra_spheres, triangles=tris)


def _time_scene(fd, k, extra_spheres, extra_triangles, has_extras: bool,
                euler_path: bool):
    from optix_ray_tracer_tpu_torch.models.renderer_time import (
        _frame_triangles,
    )

    v, n, mat = _frame_triangles(
        fd["lib_vertices"], fd["lib_normals"],
        fd["tri_lib_idx"], fd["tri_inst"], fd["tri_ok"],
        fd["positions"], fd["quats"], fd["quats_next"],
        fd["velocities"], fd["particle_mat"],
        fd["duration"], np.float32(k), fd["inv_frames_minus1"],
        fd["inv_frame_count"], fd["particle_shift"], fd["particle_scale"],
        euler_path)
    tris = Triangles(v, n, mat)
    if has_extras:
        tris = tris.concat(extra_triangles)
    return Scene(spheres=extra_spheres, triangles=tris)


def fused_chunk(fd, ks, seeds, base_inter, materials, camera,
                extra_spheres, extra_triangles, env, textures, lights,
                background, tstate=None, *, mode: str, width: int,
                height: int, spp: int, integrator: str, do_denoise: bool,
                denoiser: str = "atrous", sampler: str = "pcg",
                max_depth: int, use_march: bool, has_extras: bool,
                euler_path: bool = False, quantize: bool = False,
                want_guides: bool = True, temporal: bool = False,
                mesh=None):
    """Render frames ``ks`` (frame indices) of one file with ``seeds``,
    each frame's scene refit from ``base_inter`` (the file's rebuild).

    Returns the stacked device outputs: the images, (len(ks), H, W, 3)
    float32 linear or with ``quantize`` (len(ks), H, W, 4) sRGB uint8,
    followed when ``want_guides`` by the albedo and normal stacks.  With
    ``temporal`` (the camera constant over the chunk) the return is
    ``(outs, final_tstate)``: ``tstate`` (``render/temporal.empty_state``)
    carries the history in and out.  ``mesh``: trace every frame in row
    bands over the mesh's shards (``parallel/sharding.render_sharded`` or
    ``render_path_sharded``); ``height`` must divide by its tile count and
    ``spp`` by its sample count."""
    if integrator not in ("whitted", "path"):
        # ReSTIR renders per frame (the frontends route it there)
        raise ValueError("fused_chunk supports integrator 'whitted' or "
                         f"'path', got integrator={integrator!r}")
    carry = tstate
    if temporal and carry is None:
        carry = tmod.empty_state(width, height, camera.center.device)
    imgs, albs, nrms = [], [], []
    for k, seed in zip(ks, seeds):
        with profiling.span("fused.frame"):
            with profiling.span("fused.refit"):
                if mode == "mesh":
                    scene = _mesh_scene(fd, k, extra_spheres,
                                        extra_triangles, has_extras)
                else:
                    scene = _time_scene(fd, k, extra_spheres,
                                        extra_triangles, has_extras,
                                        euler_path)
                # the per-frame refit, always from the file's rebuild
                inter = (refit_march_intersector(base_inter, scene)
                         if use_march else None)
            with profiling.span("fused.trace"):
                if mesh is not None:
                    # each band's camera wave on the raster engine when
                    # the band tiles cleanly (sharding._band_route), else
                    # on the marcher
                    kw = dict(seed=int(seed), background=background,
                              max_depth=max_depth, intersector=inter,
                              env=env, want_guides=True, want_aux=temporal,
                              sampler=sampler)
                    out = (sharding.render_path_sharded(
                               scene, materials, lights, camera, width,
                               height, spp, mesh, textures=textures, **kw)
                           if integrator == "path"
                           else sharding.render_sharded(
                               scene, materials, camera, width, height, spp,
                               mesh, **kw))
                elif integrator == "path":
                    out = pathtracer.render_path(
                        scene, materials, lights, camera, width, height,
                        spp=spp, seed=int(seed), background=background,
                        max_depth=max_depth, intersector=inter, env=env,
                        textures=textures, want_aux=temporal,
                        sampler=sampler)
                else:
                    out = wavefront.render(
                        scene, materials, camera, width, height, spp=spp,
                        seed=int(seed), background=background,
                        max_depth=max_depth, intersector=inter, env=env,
                        want_aux=temporal, sampler=sampler)
            img, alb, nrm = out[:3]
            with profiling.span("fused.tail"):
                if temporal:
                    img, carry = _temporal_tail(
                        fd, k, out[3], img, alb, nrm, carry, camera, width,
                        height, mode, euler_path, do_denoise, denoiser)
                elif do_denoise and denoiser == "neural":
                    img = neural_denoise.denoise_neural(img, alb, nrm)
                elif do_denoise:
                    img = denoise(img, alb, nrm)
                imgs.append(color_to_uint8(img) if quantize else img)
        if want_guides:
            albs.append(alb)
            nrms.append(nrm)
    outs = (torch.stack(imgs),)
    if want_guides:
        outs += (torch.stack(albs), torch.stack(nrms))
    return (outs, carry) if temporal else outs


def _temporal_tail(fd, k, aux, img, alb, nrm, carry, camera, width: int,
                   height: int, mode: str, euler_path: bool,
                   do_denoise: bool, denoiser: str):
    """Reproject, blend, then denoise one frame: (image, new state)."""
    t_g, prim_g = aux
    # hit world points along pixel-center rays (the sub-pixel jitter is
    # far inside the validity tolerances)
    o_c, d_c = camera.generate_rays(width, height)
    hit_ok = (t_g < INF)[..., None]
    x = torch.where(hit_ok, o_c + t_g[..., None] * d_c, o_c + d_c)
    if mode == "mesh":
        from optix_ray_tracer_tpu_torch.models.renderer_mesh import (
            prev_world_points,
        )
        x_prev = prev_world_points(fd, k, x, prim_g)
    else:
        from optix_ray_tracer_tpu_torch.models.renderer_time import (
            prev_world_points,
        )
        x_prev = prev_world_points(fd, k, x, prim_g, euler_path=euler_path)
    px, py, in_front = tmod.project_to_pixels(camera, x_prev, width, height)
    rel = x_prev - camera.center
    prev_t = torch.sqrt((rel * rel).sum(-1))
    safe_alb = torch.clamp(alb, min=1e-3)
    blended, carry = tmod.temporal_blend(carry, img / safe_alb, t_g,
                                         normalize(nrm), px, py, prev_t,
                                         in_front)
    if do_denoise and denoiser == "neural":
        # the learned filter fades out as history converges; miss pixels
        # filter raw radiance (neural_denoise.demod_albedo)
        alb_n = neural_denoise.demod_albedo(alb)
        irr_n = blended * (safe_alb / alb_n)
        params = neural_denoise.default_params(alb.device)
        filt = neural_denoise.apply(params, irr_n, alb, normalize(nrm))
        w = 1.0 / torch.sqrt(torch.clamp(carry["hist"], min=1.0))
        img = (w * filt + (1.0 - w) * irr_n) * alb_n
    elif do_denoise:
        # history-adaptive edge stopping: converged pixels filter tighter
        sig = 1.0 / torch.sqrt(torch.clamp(carry["hist"], min=1.0))
        img = filter_irradiance(blended, nrm, sigma_color=sig) * safe_alb
    else:
        img = blended * safe_alb
    return img, carry


def _to_host(x: torch.Tensor):
    """(host tensor, event): a non_blocking copy into pinned memory queued
    on the current stream, or the tensor itself on the CPU."""
    if not x.is_cuda:
        return x, None
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return buf, ev


def render_frames_fused(data, mode: str, file_data_fn, width: int,
                        height: int, spp: int, max_frames, loop: bool,
                        fetch_guides: bool = False,
                        quantize: bool = False, mesh=None):
    """The fused loop of both frontends: yields (file_index, frame_index,
    Film), or U8Frame with ``quantize``.  ``file_data_fn(data, fi,
    n_frames)`` supplies a file's tensors.  Per file: the frame-0 scene,
    the intersector (a host build on the first file, then a device
    rebuild per file), then chunks of :func:`fused_chunk`.  Without
    ``fetch_guides`` the Films carry zero guide channels.  ``mesh``: every
    chunk traces in row bands over it; the render height pads up to a
    multiple of its tile count and the frames crop on output."""
    from optix_ray_tracer_tpu_torch.models import (
        renderer_mesh, renderer_time,
    )

    if quantize and fetch_guides:
        raise ValueError("quantize yields U8Frames, which carry no guide "
                         "channels: use fetch_guides with quantize=False")
    cfg = data.config
    ld = cfg.loop_data
    dev = data.camera.center.device
    frontend = renderer_mesh if mode == "mesh" else renderer_time
    n_tile = mesh.shape["tile"] if mesh is not None else 1
    hp = -(-height // n_tile) * n_tile          # the padded render height
    use_temporal = bool(getattr(cfg, "temporal", True))
    state = {"lights": None, "base": None,
             "tstate": (tmod.empty_state(width, hp, dev)
                        if use_temporal else None)}

    def dispatch_chunks():
        """Queue the chunks; yields (fi, k0, chunk, host outputs) with
        no span open (``fused.file`` per file, ``fused.chunk`` per
        chunk)."""
        planned = 0
        while True:
            for fi in range(data.file_count):
                with profiling.span("fused.file"):
                    n_frames = common.frame_count_for_file(
                        data.durations[fi], ld.fps, ld.render_speed_ratio)
                    scene0 = frontend.frame_scene(data, fi, 0, n_frames)
                    if state["lights"] is None:
                        state["lights"] = common.collect_lights(
                            cfg, scene0, data.materials)
                    with profiling.span("fused.rebuild"):
                        state["base"] = common.rebuild_or_choose(
                            state["base"], scene0)
                    use_march = isinstance(state["base"], MarchIntersector)
                    fd = file_data_fn(data, fi, n_frames)
                    bpp = ((4 if quantize else 12)
                           + (24 if fetch_guides else 0))
                    chunk = chunk_size(width, hp, n_frames, bpp)
                for k0 in range(0, n_frames, chunk):
                    with profiling.span("fused.chunk"):
                        out = fused_chunk(
                            fd, range(k0, k0 + chunk),
                            range(cfg.seed + planned,
                                  cfg.seed + planned + chunk),
                            state["base"], data.materials, data.camera,
                            data.extra_spheres, data.extra_triangles,
                            data.env, data.textures, state["lights"],
                            cfg.background, state["tstate"], mode=mode,
                            width=width, height=hp, spp=spp,
                            integrator=cfg.integrator,
                            do_denoise=cfg.denoise,
                            denoiser=common.resolve_denoiser(cfg),
                            sampler=getattr(cfg, "sampler", "pcg"),
                            max_depth=cfg.max_depth, use_march=use_march,
                            has_extras=bool(data.extra_triangles.count),
                            euler_path=getattr(data, "reference_euler_path",
                                               False),
                            quantize=quantize, want_guides=fetch_guides,
                            temporal=use_temporal, mesh=mesh)
                        if use_temporal:
                            out, state["tstate"] = out
                        host = [_to_host(x) for x in out]
                    yield fi, k0, chunk, host
                    planned += chunk
                    if max_frames is not None and planned >= max_frames:
                        return
            if not loop:
                return

    produced = 0

    def emit(item):
        """The chunk's frames, built after its fetch (span
        ``fused.deliver``, closed before the first of them is yielded)."""
        nonlocal produced
        fi, k0, chunk, host = item
        n = chunk if max_frames is None else min(chunk,
                                                 max_frames - produced)
        with profiling.span("fused.deliver"):
            ev = host[-1][1]    # the last copy's: the stream runs in order
            if ev is not None:
                with profiling.span("sync.fetch"):
                    ev.synchronize()
            imgs = host[0][0]
            albs = host[1][0] if fetch_guides else None
            nrms = host[2][0] if fetch_guides else None
            frames = []
            for j in range(n):
                if quantize:
                    frames.append(U8Frame(imgs[j][:height].numpy(), spp))
                else:
                    z = torch.zeros((height, width, 3))
                    frames.append(Film.create(width, height, "cpu").add(
                        imgs[j][:height],
                        albs[j][:height] if albs is not None else z,
                        nrms[j][:height] if nrms is not None else z, spp))
        for j, frame in enumerate(frames):
            yield fi, k0 + j, frame
            produced += 1

    prev = None
    for item in dispatch_chunks():
        if prev is not None:
            yield from emit(prev)
            if max_frames is not None and produced >= max_frames:
                return
        prev = item
    if prev is not None:
        yield from emit(prev)


def mesh_file_data(data, fi: int, n_frames: int) -> dict:
    """One Mesh file's tensors and float32 scalars for the fused loop."""
    ld = data.config.loop_data
    return dict(
        vertices=data.vertices[fi], normals=data.normals[fi],
        tri_particle=data.tri_particle[fi], tri_valid=data.tri_valid[fi],
        velocities=data.velocities[fi], particle_mat=data.particle_mat[fi],
        duration=np.float32(data.durations[fi]),
        inv_frame_count=np.float32(1.0 / max(n_frames, 1)),
        particle_shift=np.asarray(ld.particle_shift, np.float32),
        particle_scale=np.asarray(ld.particle_scale, np.float32))


def time_file_data(data, fi: int, n_frames: int) -> dict:
    """One Time file's tensors and float32 scalars for the fused loop."""
    ld = data.config.loop_data
    nxt = min(fi + 1, data.file_count - 1)
    return dict(
        lib_vertices=data.library.vertices, lib_normals=data.library.normals,
        tri_lib_idx=data.tri_lib_idx[fi], tri_inst=data.tri_inst[fi],
        tri_ok=data.tri_ok[fi],
        positions=data.positions[fi], quats=data.quats[fi],
        quats_next=data.quats[nxt], velocities=data.velocities[fi],
        particle_mat=data.particle_mat[fi],
        duration=np.float32(data.durations[fi]),
        inv_frames_minus1=np.float32(1.0 / max(n_frames - 1, 1)),
        inv_frame_count=np.float32(1.0 / max(n_frames, 1)),
        particle_shift=np.asarray(ld.particle_shift, np.float32),
        particle_scale=np.asarray(ld.particle_scale, np.float32))
