"""STL reader (ASCII and binary) with recomputed face normals.

Replaces ``vtk_reader::readSTLFile`` (``src/Util/VTKReaderImpl.cpp:254-321``),
which reads via vtkSTLReader and then *recomputes* cell (face) normals with
vtkPolyDataNormals — i.e. file-stored facet normals are ignored in favor of
geometric ones.  We do the same: normals come from the cross product of the
triangle edges, oriented consistently outward (majority vote against the
centroid direction, the auto-orient approximation).

A copy of ``optix_ray_tracer_tpu/io/stl.py``
(host numpy; this package does not import the JAX one).
"""

from __future__ import annotations

import struct

import numpy as np


def _is_ascii_stl(head: bytes) -> bool:
    if not head.lstrip().lower().startswith(b"solid"):
        return False
    # binary files sometimes start with "solid" too; ASCII must contain
    # "facet" in the first chunk
    return b"facet" in head


def read_stl(path) -> tuple[np.ndarray, np.ndarray]:
    """Returns (vertices (T, 3, 3) float32, normals (T, 3, 3) float32 —
    per-face geometric normals replicated to the 3 corners)."""
    with open(path, "rb") as f:
        data = f.read()

    if _is_ascii_stl(data[:4096]):
        tris = _parse_ascii(data.decode(errors="replace"))
    else:
        tris = _parse_binary(data)

    return tris.astype(np.float32), _face_normals(tris)


def _parse_ascii(text: str) -> np.ndarray:
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if parts and parts[0] == "vertex":
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    arr = np.asarray(verts, np.float64)
    if arr.size == 0:
        return np.zeros((0, 3, 3), np.float64)
    if len(arr) % 3 != 0:
        raise ValueError("ASCII STL vertex count not divisible by 3")
    return arr.reshape(-1, 3, 3)


def _parse_binary(data: bytes) -> np.ndarray:
    if len(data) < 84:
        raise ValueError("binary STL too short")
    (n,) = struct.unpack_from("<I", data, 80)
    expected = 84 + n * 50
    if len(data) < expected:
        raise ValueError("binary STL truncated")
    rec = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84)
    rec = rec.reshape(n, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n, 12)
    return floats[:, 3:12].astype(np.float64).reshape(n, 3, 3)


def _face_normals(tris: np.ndarray) -> np.ndarray:
    """Geometric face normals, consistently oriented, replicated per-corner."""
    if len(tris) == 0:
        return np.zeros((0, 3, 3), np.float32)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = np.cross(e1, e2)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.divide(n, lens, out=np.zeros_like(n), where=lens > 1e-30)
    centroid = tris.mean(axis=(0, 1))
    outward = tris.mean(axis=1) - centroid
    flips = (n * outward).sum(-1) < 0
    if flips.mean() > 0.5:
        n = -n
    return np.repeat(n[:, None, :], 3, axis=1).astype(np.float32)
