"""Shared frontend plumbing (port of
``optix_ray_tracer_tpu/models/common.py``): config -> materials, extra
geometry and camera; the per-frame intersector choice with its device
refit and rebuild; and the frame step (integrator, then denoiser).

The config is read by attribute, so any object with the
``RendererConfig`` fields serves, the JAX package's included.  Every
integrator of the JAX package (Whitted, path, ReSTIR DI and ReSTIR GI)
renders, with environment maps, textures, area lights, either sampler
and ``sample_offset`` (progressive batches).  Builders that make tensors
take ``device`` (None: the card).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import types

import numpy as np

from optix_ray_tracer_tpu_torch.io.config import ConfigError
from optix_ray_tracer_tpu_torch.ops.march import (
    MarchIntersector, make_march_intersector, rebuild_march_intersector,
    refit_march_intersector,
)
from optix_ray_tracer_tpu_torch.render import (
    neural_denoise, pathtracer, restir, wavefront,
)
from optix_ray_tracer_tpu_torch.render.denoise import denoise
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import Spheres, Triangles
from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu_torch.utils import debug
from optix_ray_tracer_tpu_torch.utils.colorramp import bake_color_ramp


@dataclasses.dataclass(frozen=True)
class MaterialBases:
    """Row bases of each config material list in the packed table."""
    rough: int
    metal: int
    dielectric: int
    emissive: int
    material_offset: int      # base of the baked particle ramp

    def resolve(self, mat_type: str, mat_index: int) -> int:
        base = {"ROUGH": self.rough, "METAL": self.metal,
                "DIELECTRIC": self.dielectric,
                "EMISSIVE": self.emissive}[mat_type]
        return base + mat_index


def build_materials(config, particle_count: int, device=None):
    """Materials = config roughs ++ metals ++ dielectrics ++ emissives ++
    the baked particle ramp (the reference's global material array,
    ``RendererMesh.cu:223-233``).  Returns (MaterialTable, MaterialBases)."""
    mb = MaterialBuilder()
    for albedo in config.roughs:
        mb.add_rough(albedo)
    metal_base = len(config.roughs)
    for albedo, fuzz in config.metals:
        mb.add_metal(albedo, fuzz)
    dielectric_base = len(mb)
    for ior in config.dielectrics:
        mb.add_dielectric(ior)
    emissive_base = len(mb)
    for emission in config.emissives:
        mb.add_emissive(emission)
    material_offset = len(mb)
    if particle_count > 0:
        mb.add_ramp(bake_color_ramp(config.particle_material_preset,
                                    particle_count))
    return mb.build(device), MaterialBases(
        rough=0, metal=metal_base, dielectric=dielectric_base,
        emissive=emissive_base, material_offset=material_offset)


def build_extra_spheres(config, bases: MaterialBases,
                        device=None) -> Spheres:
    """Config ``spheres`` with their static SRT transforms applied."""
    rows = []
    for s in config.spheres:
        center, radius = s.world_center_radius()
        rows.append((center, radius, bases.resolve(s.mat_type, s.mat_index)))
    return Spheres.from_list(rows, device)


def build_extra_triangles(config, bases: MaterialBases,
                          device=None) -> Triangles:
    """Static extra meshes from config ``meshes`` (OBJ files with an
    optional SRT and material override)."""
    from optix_ray_tracer_tpu_torch.io.obj import read_obj
    from optix_ray_tracer_tpu_torch.utils.transforms import srt_transform

    if not config.meshes:
        return Triangles.empty(device)
    vs, ns, ms = [], [], []
    for m in config.meshes:
        mesh = read_obj(config.resolve(str(m["obj"])))
        v = np.asarray(mesh.vertices, np.float32)      # (T, 3, 3)
        n = np.asarray(mesh.normals, np.float32)
        t = srt_transform(tuple(m.get("shift", (0, 0, 0))),
                          tuple(m.get("rotate", (0, 0, 0))),
                          tuple(m.get("scale", (1, 1, 1)))).cpu().numpy()
        v = v @ t[:, :3].T + t[:, 3]
        rot = t[:, :3]
        # normals: inverse-transpose rotation (uniform scale: rot works)
        n = n @ np.linalg.inv(rot).astype(np.float32)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.maximum(norm, 1e-12)
        mat_type = str(m.get("mat-type", "ROUGH"))
        if mat_type not in ("ROUGH", "METAL", "DIELECTRIC", "EMISSIVE"):
            raise ConfigError(f"mesh mat-type '{mat_type}' unknown")
        mat = bases.resolve(mat_type, int(m.get("mat-index", 0)))
        vs.append(v)
        ns.append(n)
        ms.append(np.full(len(v), mat, np.int32))
    return Triangles.from_arrays(np.concatenate(vs), np.concatenate(ns),
                                 np.concatenate(ms), device=device)


def build_envmap(config, device=None):
    """Config ``envmap`` -> EnvMap on ``device`` (None: the card), or None:
    a Radiance .hdr ``file``, a ``constant`` color, or the procedural sky
    (``sun-direction``, ``sun-cos``, ``zenith``, ``horizon``)."""
    if config.envmap is None:
        return None
    from optix_ray_tracer_tpu_torch.render import envmap as env_mod

    spec = config.envmap
    if "file" in spec:
        return env_mod.read_hdr(config.resolve(str(spec["file"])), device)
    if spec.get("type") == "constant":
        return env_mod.constant_env(
            tuple(spec.get("color", (0.7, 0.8, 0.9))), device)
    kwargs = {}
    if "sun-direction" in spec:
        kwargs["sun_dir"] = tuple(spec["sun-direction"])
    if "sun-cos" in spec:
        kwargs["sun_cos"] = float(spec["sun-cos"])
    if "zenith" in spec:
        kwargs["zenith"] = tuple(spec["zenith"])
    if "horizon" in spec:
        kwargs["horizon"] = tuple(spec["horizon"])
    return env_mod.gradient_sky(device=device, **kwargs)


def build_textures(config, bases: MaterialBases, num_materials: int,
                   device=None):
    """Config ``textures`` -> TextureSet on ``device`` (None: the card), or
    None: each entry binds an image file or a procedural checker to one
    material row."""
    if not config.textures_cfg:
        return None
    from optix_ray_tracer_tpu_torch.scene.textures import (
        build_texture_set, checker_texture, load_texture,
    )

    images = []
    mat_tex = [-1] * num_materials
    for i, t in enumerate(config.textures_cfg):
        if t.get("checker"):
            images.append(checker_texture(int(t.get("size", 256)),
                                          tiles=int(t.get("tiles", 8))))
        else:
            images.append(load_texture(config.resolve(str(t["file"]))))
        mat = bases.resolve(str(t.get("mat-type", "ROUGH")),
                            int(t.get("mat-index", 0)))
        mat_tex[mat] = i
    return build_texture_set(images, mat_tex, device=device)


def camera_from_config(config, device=None) -> Camera:
    ld = config.loop_data
    return Camera.look_at(ld.camera_center, ld.camera_target,
                          ld.up_direction, aperture=ld.aperture,
                          focus_dist=ld.focus_distance, device=device)


def frame_count_for_file(duration: float, fps: int,
                         render_speed_ratio: int) -> int:
    """Frames per animation segment = duration * fps * renderSpeedRatio
    (``RendererMesh.cu:370-371``)."""
    return max(1, int(duration * float(fps * render_speed_ratio)))


def pad_stack(arrays: list[np.ndarray], pad_value=0.0) -> np.ndarray:
    """Stack variable-length leading-dim arrays padded to the max length
    (one frame shape for every file of a series)."""
    if not arrays:
        return np.zeros((0, 0), np.float32)
    max_len = max(a.shape[0] for a in arrays)
    out = np.full((len(arrays), max_len) + arrays[0].shape[1:], pad_value,
                  arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return out


def choose_intersector(scene):
    """The per-frame intersector of the render loops: a raster-enabled
    ``MarchIntersector`` built on the host, or None (brute force) for
    scenes under 1024 triangles on the CPU (the JAX package's rule on
    its CPU backend) and for scenes without triangles on the card.
    Debug mode keeps the plain marcher, as in the JAX package."""
    tv = scene.triangles.vertices
    threshold = 1024 if tv.device.type == "cpu" else 1
    if scene.triangle_count < threshold:
        return None
    intersector = make_march_intersector(
        scene, method=first_build_method(scene),
        raster=not debug.DEBUG_MODE)
    debug.maybe_validate_accel(intersector, scene)
    return intersector


#: triangles past which a scene's first build on the card is the device
#: median build that every later file's rebuild uses: the host SAH build
#: costs 15-26 us a triangle on the card's host (102-172 s at 6.69M
#: triangles), so past here it would hold the set-up for over 30 s, while
#: the device build takes a tenth of a second
HOST_BUILD_MAX_TRIS = 2_000_000


def first_build_method(scene) -> str:
    """The first build of a scene: the host SAH build, or on the card past
    HOST_BUILD_MAX_TRIS triangles the device median build."""
    if (scene.triangles.vertices.is_cuda
            and scene.triangle_count > HOST_BUILD_MAX_TRIS):
        return "median"
    return "sah"


def refit_or_choose(prev, scene):
    """Per-frame intersector: the device refit of ``prev`` when it is a
    ``MarchIntersector`` of the same triangle count, else a fresh
    :func:`choose_intersector` (the reference's accel policy: build per
    file, refit per frame, ``RendererImpl.cu:210-242``)."""
    if (isinstance(prev, MarchIntersector)
            and scene.triangle_count == prev.num_tris):
        intersector = refit_march_intersector(prev, scene)
        debug.maybe_validate_accel(intersector, scene)
        return intersector
    return choose_intersector(scene)


def rebuild_or_choose(prev, scene):
    """Per-file intersector: the device rebuild of ``prev`` (a fresh
    median-split slot order, no host round trip) when shapes allow, else
    a fresh :func:`choose_intersector`."""
    if (isinstance(prev, MarchIntersector)
            and scene.triangle_count == prev.num_tris):
        intersector = rebuild_march_intersector(prev, scene)
        debug.maybe_validate_accel(intersector, scene)
        return intersector
    return choose_intersector(scene)


def collect_lights(config, scene, materials):
    """Area lights of the path and ReSTIR integrators, collected from the
    scene's EMISSIVE triangles (None for ``whitted``, which uses none)."""
    if config.integrator not in ("path", "restir", "restir-gi"):
        return None
    from optix_ray_tracer_tpu_torch.scene.lights import collect_area_lights
    return collect_area_lights(scene, materials)


def restir_seed(seed: int, sample_offset: int) -> int:
    """The ReSTIR seed of a progressive batch: ``seed ^ (sample_offset *
    0x9E3779B9)`` wrapped to its low 32 bits as a two's-complement int32,
    so that each batch draws fresh candidate streams.  (The JAX package
    passes the unwrapped Python int, which overflows its int32 seed from
    the second batch on; the wrapped value is the one it means.)"""
    s = (int(seed) ^ (int(sample_offset) * 0x9E3779B9)) & 0xFFFFFFFF
    return s - (1 << 32) if s >= 1 << 31 else s


def render_frame(config, scene, materials, camera, width: int, height: int,
                 spp: int, seed: int, intersector, env=None, textures=None,
                 lights=None, denoise_override: bool | None = None,
                 denoiser_override: str | None = None,
                 sample_offset: int = 0):
    """One frame through the configured integrator and denoiser.  Returns
    (img, albedo, normal), ``img`` denoised when enabled
    (``denoise_override`` None follows the config).  ``sample_offset``
    continues the global sample counter (progressive batches); ReSTIR
    folds it into its seed (:func:`restir_seed`)."""
    sampler = getattr(config, "sampler", "pcg")
    if config.integrator == "path":
        img, alb, nrm = pathtracer.render_path(
            scene, materials, lights, camera, width, height, spp=spp,
            seed=seed, background=config.background,
            max_depth=config.max_depth, intersector=intersector, env=env,
            textures=textures, sampler=sampler, sample_offset=sample_offset)
    elif config.integrator in ("restir", "restir-gi"):
        # one shadow ray per pixel per sample, the reservoirs carried
        # across the spp samples; "restir-gi" adds the path-traced rest
        if lights is None or lights.count == 0:
            raise ValueError(
                f"integrator '{config.integrator}' needs emissive "
                "materials in the scene (it resamples area-light "
                "candidates)")
        kw = dict(spp=spp, seed=restir_seed(seed, sample_offset),
                  background=config.background, intersector=intersector,
                  env=env, textures=textures, sampler=sampler)
        if config.integrator == "restir-gi":
            img, alb, nrm = restir.render_restir_gi_progressive(
                scene, materials, lights, camera, width, height,
                max_depth=config.max_depth, **kw)
        else:
            img, alb, nrm = restir.render_restir_progressive(
                scene, materials, lights, camera, width, height, **kw)
    else:
        img, alb, nrm = wavefront.render(
            scene, materials, camera, width, height, spp=spp, seed=seed,
            background=config.background, max_depth=config.max_depth,
            intersector=intersector, env=env, sampler=sampler,
            sample_offset=sample_offset)
    img = apply_denoiser(img, alb, nrm, config, denoise_override,
                         denoiser_override)
    return img, alb, nrm


def apply_denoiser(img, alb, nrm, config, denoise_override=None,
                   denoiser_override=None):
    """The denoiser tail of :func:`render_frame`, for callers that drive
    an integrator directly (the viewer's ReSTIR path)."""
    do_denoise = (config.denoise if denoise_override is None
                  else denoise_override)
    if denoiser_override is not None:
        denoiser = resolve_denoiser(
            types.SimpleNamespace(denoiser=denoiser_override))
    else:
        denoiser = resolve_denoiser(config)
    if do_denoise and denoiser == "neural":
        img = neural_denoise.denoise_neural(img, alb, nrm)
    elif do_denoise:
        img = denoise(img, alb, nrm)
    return img


_warned_no_weights = False


def resolve_denoiser(config) -> str:
    """``config.denoiser``, degraded to "atrous" (with one warning per
    process) when the pretrained neural weights are absent."""
    if getattr(config, "denoiser", "atrous") != "neural":
        return "atrous"
    if not os.path.exists(neural_denoise.WEIGHTS_FILE):
        global _warned_no_weights
        if not _warned_no_weights:
            logging.getLogger("optix_ray_tracer_tpu_torch").warning(
                "denoise='neural' requested but no pretrained weights at"
                " %s; falling back to the a-trous filter",
                neural_denoise.WEIGHTS_FILE)
            _warned_no_weights = True
        return "atrous"
    return "neural"
