"""The DEM pile's inputs: particle poses drawn from a seed, the shape
library, and the series files a user of the Time frontend hands it.

Frozen copies of the pile generators of ``chip_smoke.py`` (``pile_poses``,
``write_stl``, ``write_manifest``, ``write_time_series``,
``write_anim_config``, ``write_light_obj`` and their constants) and of the
UV sphere of the port's ``io/meshgen.py``, so that a later change to either
file cannot move this benchmark's scenes.  numpy only.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

N_PARTICLES = 4096
POSE_SEED = 7                      # the pile chip_smoke.py measured
TIME_LIBRARY = (80, 200, 450)      # sphere shapes of 60, 168, 396 triangles
TIME_EYE = (45.0, 3.0, 5.0)
TIME_FOCAL = 2.25                  # view axis length: a 48-degree view
ANIM_TIMES = (0.0, 0.25, 0.5)      # three pose files
ANIM_FPS = 16                      # 0.25 s x 16 fps x ratio 1 = 4 frames
GROUND = ((-40.0, -40.0, -16.0), (40.0, -40.0, -16.0), (40.0, 40.0, -16.0),
          (-40.0, 40.0, -16.0))
GROUND_ALBEDO = (0.70, 0.60, 0.50)


def uv_sphere(n_lat: int, n_lon: int, center=(0, 0, 0), radius=1.0):
    """Tessellated UV sphere, pole slivers dropped: (vertices (T, 3, 3),
    smooth normals (T, 3, 3)), float32."""
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    pts = np.stack([np.sin(theta) * np.cos(phi),
                    np.sin(theta) * np.sin(phi), np.cos(theta)], axis=-1)
    a, b, c, d = pts[:-1, :-1], pts[1:, :-1], pts[1:, 1:], pts[:-1, 1:]
    t1 = np.stack([a, b, c], axis=-2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=-2).reshape(-1, 3, 3)
    tris = np.concatenate([t1, t2], 0)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    tris = tris[np.linalg.norm(np.cross(e1, e2), axis=-1) > 1e-12]
    verts = (tris * radius + np.asarray(center, np.float32)).astype(np.float32)
    return verts, tris.astype(np.float32)


def sphere_with_n_triangles(n_target: int, center=(0, 0, 0), radius=1.0):
    """UV sphere with about ``n_target`` triangles."""
    n_lat = max(2, int(np.sqrt(n_target / 4)))
    n_lon = max(3, n_target // (2 * n_lat))
    return uv_sphere(n_lat, n_lon, center, radius)


def library_shapes() -> list:
    """The pile's shape library: (vertices, normals) per shape id."""
    return [sphere_with_n_triangles(s) for s in TIME_LIBRARY]


def pile_poses(n: int, times, seed: int = 7) -> list:
    """Shape ids, quaternions and positions drawn from ``seed``; in file f
    the positions have moved by velocity x times[f] and the quaternions
    have turned from the first set toward the second by f / (files - 1)."""
    gen = np.random.default_rng(seed)
    sid = gen.integers(0, len(TIME_LIBRARY), n)
    q = gen.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos = gen.uniform(-15.0, 15.0, (n, 3))
    q_next = gen.normal(size=(n, 4))
    q_next /= np.linalg.norm(q_next, axis=1, keepdims=True)
    vel = gen.normal(size=(n, 3)) * 0.5
    out = []
    for f, t in enumerate(times):
        a = f / max(len(times) - 1, 1)
        qf = q * (1.0 - a) + q_next * np.where(
            (q * q_next).sum(1, keepdims=True) < 0, -a, a)
        qf /= np.linalg.norm(qf, axis=1, keepdims=True)
        out.append(dict(pos=pos + vel * t, quat=qf, vel=vel, sid=sid,
                        ids=np.arange(n)))
    return out


def write_stl(path, vertices) -> None:
    """A binary STL of (T, 3, 3) triangles, facet normals left zero."""
    rec = np.zeros(len(vertices), dtype=[("n", "<f4", (3,)),
                                         ("v", "<f4", (3, 3)),
                                         ("attr", "<u2")])
    rec["v"] = vertices
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + np.uint32(len(vertices)).tobytes()
                + rec.tobytes())


def write_manifest(path, names, times) -> None:
    Path(path).write_text(json.dumps({"file-series-version": "1.0", "files": [
        {"name": n, "time": t} for n, t in zip(names, times)]}))


def write_pose_vtk(path, pose: dict) -> None:
    """One pose file as legacy binary VTK POLYDATA: the points and the
    point arrays id, quat, vel, shape_id (big-endian payloads)."""
    out = bytearray()

    def text(s: str) -> None:
        out.extend(s.encode("ascii") + b"\n")

    def payload(arr, dtype) -> None:
        out.extend(np.ascontiguousarray(
            arr, np.dtype(dtype).newbyteorder(">")).tobytes() + b"\n")

    pos = np.asarray(pose["pos"], np.float64)
    text("# vtk DataFile Version 2.0")
    text("optix_ray_tracer_tpu export")
    text("BINARY")
    text("DATASET POLYDATA")
    text(f"POINTS {len(pos)} double")
    payload(pos, np.float64)
    text(f"POINT_DATA {len(pos)}")
    text("SCALARS id int")
    text("LOOKUP_TABLE default")
    payload(np.asarray(pose["ids"], np.int32), np.int32)
    text("SCALARS quat double 4")
    text("LOOKUP_TABLE default")
    payload(np.asarray(pose["quat"], np.float64), np.float64)
    text("VECTORS vel double")
    payload(np.asarray(pose["vel"], np.float64), np.float64)
    text("SCALARS shape_id int")
    text("LOOKUP_TABLE default")
    payload(np.asarray(pose["sid"], np.int32), np.int32)
    Path(path).write_bytes(bytes(out))


def write_time_series(root, shapes, poses, times):
    """A Time series under ``root``: shapes/shapeNN.stl per library shape
    (lexicographic order = shape id), one pose VTK per file and
    pile.vtk.series.  Returns (series path, STL directory)."""
    root = Path(root)
    (root / "shapes").mkdir(parents=True, exist_ok=True)
    for i, (v, _) in enumerate(shapes):
        write_stl(root / "shapes" / f"shape{i:02d}.stl", v)
    names = []
    for f, p in enumerate(poses):
        names.append(f"pose{f}.vtk")
        write_pose_vtk(root / names[-1], p)
    write_manifest(root / "pile.vtk.series", names, times)
    return root / "pile.vtk.series", root / "shapes"


def camera_target():
    """The view point of the pile's camera, TIME_FOCAL toward the origin."""
    eye = np.asarray(TIME_EYE, np.float64)
    return eye - TIME_FOCAL * eye / np.linalg.norm(eye)


def write_anim_config(path, series, stl_dir, cache_dir, width: int,
                      height: int, fps: int, depth: int, **extra) -> Path:
    """A Time config at the reference's defaults (whitted, spp 1, a-trous,
    temporal on) over the ground quad (an OBJ beside it) and the pile's
    camera; ``extra`` overrides keys."""
    path = Path(path)
    obj = path.with_suffix(".ground.obj")
    obj.write_text("".join(f"v {x:g} {y:g} {z:g}\n" for x, y, z in GROUND)
                   + "f 1 2 3\nf 1 3 4\n")
    cfg = {"mesh": False, "series-path": str(Path(series).parent),
           "series-name": Path(series).name, "stl-path": str(stl_dir),
           "cache-path": str(cache_dir), "cache": False,
           "particle-material-preset": "viridis",
           "roughs": [{"albedo": list(GROUND_ALBEDO)}], "metals": [],
           "spheres": [], "meshes": [{"obj": obj.name, "mat-type": "ROUGH",
                                      "mat-index": 0}],
           "integrator": "whitted", "spp": 1, "max-depth": depth,
           "denoise": "atrous", "temporal": True, "seed": 0,
           "loop-data": {"api": "HEADLESS", "window-width": width,
                         "window-height": height, "fps": fps,
                         "render-speed-ratio": 1,
                         "camera-center": list(TIME_EYE),
                         "camera-target": camera_target().tolist(),
                         "up-direction": [0.0, 0.0, 1.0]}}
    cfg.update(extra)
    path.write_text(json.dumps(cfg))
    return path


def light_corners(z: float, half: float):
    """The emissive panel's corners: a 2 half x 2 half square at height z,
    facing down."""
    return ((-half, -half, z), (-half, half, z), (half, half, z),
            (half, -half, z))


def write_light_obj(path, z: float, half: float) -> Path:
    """The emissive panel as an OBJ (an EMISSIVE mesh extra)."""
    path = Path(path)
    path.write_text("".join(f"v {x:g} {y:g} {w:g}\n"
                            for x, y, w in light_corners(z, half))
                    + "f 1 2 3\nf 1 3 4\n")
    return path
