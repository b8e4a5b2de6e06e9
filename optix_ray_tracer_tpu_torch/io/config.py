"""JSON config system — schema-compatible with the reference's
``files/config.json`` (full schema in reference ``docs/configuration.md``;
parser semantics from ``src/Util/ProgramArgumentParser.cu:47-160``).

A reference user's config file works unchanged: same keys, same semantics
(mesh/time mode switch, roughs/metals material lists, spheres with
per-sphere SRT transforms, loop-data camera + animation parameters).
Renderer-specific extensions live under optional keys with defaults
(``spp``, ``max-depth``, ``background`` …) so reference configs need no
edits.

Unlike the reference (hardcoded ``../files/config.json`` path and
``exit(-2)`` on errors, ProgramArgumentParser.cuh:9,41), the path is an
argument and errors raise :class:`ConfigError`.

A copy of ``optix_ray_tracer_tpu/io/config.py``
(host numpy; this package does not import the JAX one).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

import numpy as np


class ConfigError(ValueError):
    """Analog of COMMAND_PARSER_ERROR_EXIT_CODE=-2 fail-fast."""


VALID_APIS = ("OGL", "VK", "D3D11", "D3D12", "HEADLESS")


@dataclasses.dataclass
class SphereConfig:
    center: tuple[float, float, float]
    radius: float
    mat_type: str            # "ROUGH" | "METAL" (reference set) + extensions
    mat_index: int
    shift: tuple[float, float, float]
    rotate: tuple[float, float, float]
    scale: tuple[float, float, float]

    def transform(self) -> np.ndarray:
        """Precomputed 3x4 SRT like parseSphereData
        (ProgramArgumentParser.cu:4-39)."""
        from optix_ray_tracer_tpu_torch.utils.transforms import srt_transform
        return np.asarray(srt_transform(self.shift, self.rotate, self.scale))

    def world_center_radius(self):
        """The reference applies the per-sphere transform to geometry via a
        user callback on instance 0 (Main.cu:5-9); for static SRT this is
        shift+scale on the center/radius (uniform scale assumed, as the
        shipped config uses)."""
        t = self.transform()
        c = t[:, :3] @ np.asarray(self.center, np.float32) + t[:, 3]
        s = float(np.cbrt(abs(np.linalg.det(t[:, :3])))) or 1.0
        return tuple(float(x) for x in c), self.radius * s


@dataclasses.dataclass
class LoopDataConfig:
    api: str = "HEADLESS"
    window_width: int = 1200
    window_height: int = 800
    fps: int = 60
    camera_center: tuple = (5.0, 0.0, 0.0)
    camera_target: tuple = (0.0, 0.0, 0.0)
    up_direction: tuple = (0.0, 0.0, 1.0)
    camera_pitch_limit_degree: float = 85.0
    camera_speed_stride: float = 0.002
    camera_initial_speed_ratio: int = 10
    mouse_sensitivity: float = 0.002
    render_speed_ratio: int = 1
    particle_shift: tuple = (0.0, 0.0, 0.0)
    particle_scale: tuple = (1.0, 1.0, 1.0)
    # thin-lens extensions (reference camera is pinhole-only):
    # aperture = lens radius in world units (0 = pinhole), focus-distance
    # <= 0 = auto (the camera-target distance)
    aperture: float = 0.0
    focus_distance: float = -1.0


@dataclasses.dataclass
class RendererConfig:
    mesh: bool
    series_path: str
    series_name: str
    cache_path: str
    stl_path: str
    cache: bool
    debug_mode: bool
    cache_process_thread_count: int
    particle_material_preset: str
    roughs: list[tuple[float, float, float]]
    metals: list[tuple[tuple[float, float, float], float]]
    spheres: list[SphereConfig]
    triangles: list[Any]
    loop_data: LoopDataConfig
    # --- renderer extensions (absent from reference configs => defaults)
    spp: int = 1
    max_depth: int = 5
    background: tuple = (0.7, 0.8, 0.9)
    seed: int = 0
    output_dir: str = "./out"
    # integrator: "whitted" (reference parity, background-lit), "path"
    # (NEE+MIS path tracer with area lights auto-collected from EMISSIVE
    # materials), "restir" (ReSTIR DI — reservoir-resampled DIRECT
    # lighting, one shadow ray/pixel/sample; needs emissive materials),
    # or "restir-gi" (ReSTIR direct + path-traced indirect: full
    # transport, direct term converges like ReSTIR)
    integrator: str = "whitted"
    # denoise every frame like the reference hot loop (RendererImpl.cu:
    # 680-734); the CLI --no-denoise flag is the Tab-bypass analog
    denoise: bool = True
    # which filter: "atrous" (render/denoise.py) or "neural" (the learned
    # KPCN in render/neural_denoise.py — the AI-denoiser parity analog of
    # the reference's optixDenoiserInvoke, RendererImpl.cu:584-669)
    denoiser: str = "atrous"
    # sample stream: "pcg" (PCG4D counter hash, reference-parity default)
    # or "sobol" (Owen-scrambled Sobol, utils/qmc.py — measured 1.4-4.4x
    # lower RMSE at 4-64 spp on the Cornell config, PERF.md)
    sampler: str = "pcg"
    # temporal reprojection (SVGF temporal term) in the fused animation
    # path: history accumulated across frames using the exactly-known
    # per-instance rigid motion; falls back to spatial-only when off
    temporal: bool = True
    # extension material lists (reference has only roughs/metals)
    dielectrics: list = dataclasses.field(default_factory=list)   # iors
    emissives: list = dataclasses.field(default_factory=list)     # emission
    # environment map: {"type": "gradient-sky"|"constant", ...} or
    # {"file": "x.hdr"} (equirectangular Radiance RGBE)
    envmap: dict | None = None
    # textures: [{"file": png|"checker": true, "mat-type": t, "mat-index": i}]
    textures_cfg: list = dataclasses.field(default_factory=list)
    # static extra meshes: [{"obj": path, "mat-type": t, "mat-index": i,
    #   "shift": v3, "rotate": v3, "scale": v3}]
    meshes: list = dataclasses.field(default_factory=list)

    base_dir: str = "."

    def resolve(self, path: str) -> str:
        """Resolve a config-relative path (the reference resolves relative to
        the binary's CWD; we resolve relative to the config file)."""
        if os.path.isabs(path):
            return path
        return os.path.normpath(os.path.join(self.base_dir, path))


def _vec3(v, key) -> tuple[float, float, float]:
    if not isinstance(v, (list, tuple)) or len(v) != 3:
        raise ConfigError(f"'{key}' must be a 3-element array")
    return tuple(float(x) for x in v)


def _parse_denoise(v) -> tuple[bool, str]:
    """``denoise`` accepts true/false (reference-compatible) or a filter
    name: "atrous" | "neural" | "off"."""
    if isinstance(v, str):
        name = v.strip().lower()
        if name in ("off", "false", "none"):
            return False, "atrous"
        if name in ("on", "true"):
            return True, "atrous"
        if name not in ("atrous", "neural"):
            raise ConfigError(
                f"'denoise' must be true/false/'atrous'/'neural', got {v!r}")
        return True, name
    return bool(v), "atrous"


def parse_config_dict(data: dict, base_dir: str = ".") -> RendererConfig:
    try:
        roughs = [_vec3(r["albedo"], "roughs.albedo")
                  for r in data.get("roughs", [])]
        metals = [(_vec3(m["albedo"], "metals.albedo"), float(m["fuzz"]))
                  for m in data.get("metals", [])]

        spheres = []
        for s in data.get("spheres", []):
            mat_type = str(s["mat-type"])
            # reference treats anything != "ROUGH" as METAL
            # (ProgramArgumentParser.cu:16-17); we keep explicit names and
            # allow extensions but validate against known types.
            if mat_type not in ("ROUGH", "METAL", "DIELECTRIC", "EMISSIVE"):
                raise ConfigError(f"unknown mat-type '{mat_type}'")
            spheres.append(SphereConfig(
                center=_vec3(s["center"], "sphere.center"),
                radius=float(s["radius"]),
                mat_type=mat_type,
                mat_index=int(s["mat-index"]),
                shift=_vec3(s.get("shift", (0, 0, 0)), "sphere.shift"),
                rotate=_vec3(s.get("rotate", (0, 0, 0)), "sphere.rotate"),
                scale=_vec3(s.get("scale", (1, 1, 1)), "sphere.scale")))

        denoise_on, denoiser_name = _parse_denoise(
            data.get("denoise", True))

        sampler = str(data.get("sampler", "pcg"))
        if sampler not in ("pcg", "sobol"):
            raise ConfigError(
                f"'sampler' must be 'pcg' or 'sobol', got '{sampler}'")

        integrator = str(data.get("integrator", "whitted"))
        if integrator not in ("whitted", "path", "restir", "restir-gi"):
            raise ConfigError(f"unknown integrator '{integrator}' "
                              "(whitted|path|restir|restir-gi)")

        dielectrics = [float(d_.get("ior", 1.5))
                       for d_ in data.get("dielectrics", [])]
        emissives = [_vec3(e["emission"], "emissives.emission")
                     for e in data.get("emissives", [])]

        envmap = data.get("envmap")
        if envmap is not None:
            if not isinstance(envmap, dict):
                raise ConfigError("'envmap' must be an object")
            if "file" not in envmap and envmap.get("type") not in (
                    "gradient-sky", "constant"):
                raise ConfigError(
                    "envmap needs 'file' or type gradient-sky|constant")

        meshes = []
        for m in data.get("meshes", []):
            if "obj" not in m:
                raise ConfigError("each meshes[] entry needs an 'obj' path")
            meshes.append(dict(m))

        textures_cfg = []
        for t in data.get("textures", []):
            if "file" not in t and not t.get("checker"):
                raise ConfigError(
                    "each textures[] entry needs 'file' or 'checker'")
            textures_cfg.append(dict(t))

        ld = data.get("loop-data", {})
        api = str(ld.get("api", "HEADLESS"))
        if api not in VALID_APIS:
            raise ConfigError(
                f'Invalid api type, must be one of {VALID_APIS}')
        loop = LoopDataConfig(
            api=api,
            window_width=int(ld.get("window-width", 1200)),
            window_height=int(ld.get("window-height", 800)),
            fps=int(ld.get("fps", 60)),
            camera_center=_vec3(ld.get("camera-center", (5, 0, 0)), "camera-center"),
            camera_target=_vec3(ld.get("camera-target", (0, 0, 0)), "camera-target"),
            up_direction=_vec3(ld.get("up-direction", (0, 0, 1)), "up-direction"),
            camera_pitch_limit_degree=float(ld.get("camera-pitch-limit-degree", 85.0)),
            camera_speed_stride=float(ld.get("camera-speed-stride", 0.002)),
            camera_initial_speed_ratio=int(ld.get("camera-initial-speed-ratio", 10)),
            mouse_sensitivity=float(ld.get("mouse-sensitivity", 0.002)),
            render_speed_ratio=int(ld.get("render-speed-ratio", 1)),
            particle_shift=_vec3(ld.get("particle-shift", (0, 0, 0)), "particle-shift"),
            particle_scale=_vec3(ld.get("particle-scale", (1, 1, 1)), "particle-scale"),
            aperture=float(ld.get("aperture", 0.0)),
            focus_distance=float(ld.get("focus-distance", -1.0)))

        cfg = RendererConfig(
            mesh=bool(data.get("mesh", False)),
            series_path=str(data.get("series-path", "./")),
            series_name=str(data.get("series-name", "")),
            cache_path=str(data.get("cache-path", "./cache/")),
            stl_path=str(data.get("stl-path", "./")),
            cache=bool(data.get("cache", False)),
            debug_mode=bool(data.get("debug-mode", False)),
            cache_process_thread_count=max(1, int(
                data.get("cache-process-thread-count", 8))),
            particle_material_preset=str(
                data.get("particle-material-preset", "viridis")),
            roughs=roughs, metals=metals, spheres=spheres,
            triangles=list(data.get("triangles", [])),
            loop_data=loop,
            spp=int(data.get("spp", 1)),
            max_depth=int(data.get("max-depth", 5)),
            background=_vec3(data.get("background", (0.7, 0.8, 0.9)),
                             "background"),
            seed=int(data.get("seed", 0)),
            output_dir=str(data.get("output-dir", "./out")),
            integrator=integrator,
            sampler=sampler,
            denoise=denoise_on,
            denoiser=denoiser_name,
            temporal=bool(data.get("temporal", True)),
            dielectrics=dielectrics, emissives=emissives,
            envmap=envmap, textures_cfg=textures_cfg, meshes=meshes,
            base_dir=base_dir)

        counts = {"ROUGH": len(cfg.roughs), "METAL": len(cfg.metals),
                  "DIELECTRIC": len(cfg.dielectrics),
                  "EMISSIVE": len(cfg.emissives)}
        for s in cfg.spheres:
            n_of_type = counts[s.mat_type]
            if s.mat_index >= n_of_type:
                raise ConfigError(
                    f"sphere mat-index {s.mat_index} out of range for "
                    f"{s.mat_type} (have {n_of_type})")
        if not math.isfinite(sum(sum(r) for r in roughs) if roughs else 0.0):
            raise ConfigError("non-finite albedo in roughs")
        return cfg
    except KeyError as e:
        raise ConfigError(f"missing config key: {e}") from e


def load_config(path: str) -> RendererConfig:
    """Load and validate a config.json (the reference's single config entry
    point, hardcoded at ../files/config.json — here a parameter)."""
    try:
        with open(path, "r") as f:
            data = json.load(f)
    except OSError as e:
        raise ConfigError(f"Failed to open config: {path}: {e}") from e
    except json.JSONDecodeError as e:
        raise ConfigError(f"JSON parsing error in {path}: {e}") from e
    return parse_config_dict(data, base_dir=os.path.dirname(os.path.abspath(path)))
