"""Binary scene-cache subsystem.

Replaces the reference's ``particleN.cache`` files
(``src/Util/VTKMeshReader.cu:147-263``; format spec ``VTKMeshReader.cuh:10-24``:
``[count][per-particle: id, vel, nVerts, verts, normals]``) with npz
archives — same role (skip expensive VTK parsing on every startup), same
lifecycle (bake once via the ``"cache": true`` config flag, then load), plus
integrity that the reference lacks (version stamp + source-file fingerprint
instead of manual invalidation, reference docs/usage.md:77-85).

A fast C++ codec for the packed-triangle payload lives in ``native/`` and is
used transparently when built (see io/native_cache.py).

A copy of ``optix_ray_tracer_tpu/io/cache.py``
(host numpy; this package does not import the JAX one).
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from optix_ray_tracer_tpu_torch.utils.logging import LOG

CACHE_VERSION = 2


@dataclasses.dataclass
class MeshFileCache:
    """Device-upload-ready mesh-mode frame: particles packed into one
    triangle buffer (replaces per-particle device arrays of the reference)."""
    ids: np.ndarray          # (P,)   int64
    velocities: np.ndarray   # (P, 3) float32
    vertices: np.ndarray     # (T, 3, 3) float32 packed across particles
    normals: np.ndarray      # (T, 3, 3) float32
    tri_offsets: np.ndarray  # (P,)  int64 first triangle of each particle
    tri_counts: np.ndarray   # (P,)  int64


def _fingerprint(path: str) -> dict:
    st = os.stat(path)
    return {"size": st.st_size, "mtime": int(st.st_mtime)}


def _cache_path(cache_dir: str, index: int) -> str:
    # reference writes particle{N}.cache (VTKMeshReader.cu:154-158)
    return os.path.join(cache_dir, f"particle{index}.npz")


def write_mesh_cache(cache_dir: str, vtk_paths: list[str],
                     thread_count: int = 8) -> dict:
    """Bake every VTK mesh file into an npz cache (parallel across files,
    like the reference's bounded thread pool, VTKMeshReader.cu:176-194).

    Returns the metadata dict (also written to ``metadata.json`` — the
    reference's ``metadata.cache`` holding the max cell count,
    VTKMeshReader.cu:196-207)."""
    from optix_ray_tracer_tpu_torch.io.native_io import read_mesh_file

    os.makedirs(cache_dir, exist_ok=True)
    # delete stale caches (VTKMeshReader.cu:160-170)
    for name in os.listdir(cache_dir):
        if name.startswith("particle") and name.endswith(".npz"):
            os.remove(os.path.join(cache_dir, name))

    max_cells = 0
    fingerprints = []

    def bake(i_path):
        i, path = i_path
        frame = read_mesh_file(path)
        counts = np.asarray([len(v) for v in frame.vertices], np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        verts = (np.concatenate(frame.vertices, 0) if len(frame.vertices)
                 else np.zeros((0, 3, 3), np.float32))
        normals = (np.concatenate(frame.normals, 0) if len(frame.normals)
                   else np.zeros((0, 3, 3), np.float32))
        np.savez(_cache_path(cache_dir, i),
                 ids=frame.ids, velocities=frame.velocities,
                 vertices=verts, normals=normals,
                 tri_offsets=offsets, tri_counts=counts)
        LOG.info("[%d/%d] baked cache for %s", i + 1, len(vtk_paths), path)
        return len(frame.ids), _fingerprint(path)

    with ThreadPoolExecutor(max_workers=max(1, thread_count)) as pool:
        for n_cells, fp in pool.map(bake, enumerate(vtk_paths)):
            max_cells = max(max_cells, n_cells)
            fingerprints.append(fp)

    meta = {"version": CACHE_VERSION, "file_count": len(vtk_paths),
            "max_cell_count": max_cells, "sources": fingerprints}
    with open(os.path.join(cache_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return meta


def cache_is_valid(cache_dir: str, vtk_paths: list[str]) -> bool:
    meta_path = os.path.join(cache_dir, "metadata.json")
    if not os.path.exists(meta_path):
        return False
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    if meta.get("version") != CACHE_VERSION:
        return False
    if meta.get("file_count") != len(vtk_paths):
        return False
    sources = meta.get("sources", [])
    if len(sources) != len(vtk_paths):
        return False
    for path, fp in zip(vtk_paths, sources):
        if not os.path.exists(path) or _fingerprint(path) != fp:
            return False
    return all(os.path.exists(_cache_path(cache_dir, i))
               for i in range(len(vtk_paths)))


def read_mesh_cache(cache_dir: str, index: int) -> MeshFileCache:
    with np.load(_cache_path(cache_dir, index)) as z:
        return MeshFileCache(
            ids=z["ids"], velocities=z["velocities"],
            vertices=z["vertices"], normals=z["normals"],
            tri_offsets=z["tri_offsets"], tri_counts=z["tri_counts"])


def load_or_bake(cache_dir: str, vtk_paths: list[str],
                 use_cache: bool = True, thread_count: int = 8
                 ) -> list[MeshFileCache]:
    """Load every frame, baking the cache first if missing/stale."""
    from optix_ray_tracer_tpu_torch.io.native_io import read_mesh_file

    if use_cache:
        if not cache_is_valid(cache_dir, vtk_paths):
            LOG.info("mesh cache missing/stale -> baking %d files",
                     len(vtk_paths))
            write_mesh_cache(cache_dir, vtk_paths, thread_count)
        with ThreadPoolExecutor(max_workers=max(1, thread_count)) as pool:
            return list(pool.map(lambda i: read_mesh_cache(cache_dir, i),
                                 range(len(vtk_paths))))

    def parse(path):
        frame = read_mesh_file(path)
        counts = np.asarray([len(v) for v in frame.vertices], np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]) if len(counts) \
            else np.zeros(0, np.int64)
        verts = (np.concatenate(frame.vertices, 0) if len(frame.vertices)
                 else np.zeros((0, 3, 3), np.float32))
        normals = (np.concatenate(frame.normals, 0) if len(frame.normals)
                   else np.zeros((0, 3, 3), np.float32))
        return MeshFileCache(frame.ids, frame.velocities, verts, normals,
                             offsets, counts)

    with ThreadPoolExecutor(max_workers=max(1, thread_count)) as pool:
        return list(pool.map(parse, vtk_paths))
