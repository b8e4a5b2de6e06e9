"""Procedural mesh generation for benchmarks and tests (a numpy copy of
the functions of ``optix_ray_tracer_tpu/io/meshgen.py`` the ported path
uses; this package may not import the JAX one).

The reference ships VTK particle data as its de-facto fixtures; for
benchmark configs that need large watertight meshes (100k+ triangles,
BASELINE.md config 3/5) we synthesize them deterministically instead of
shipping binary assets.
"""

from __future__ import annotations

import numpy as np


def uv_sphere(n_lat: int, n_lon: int, center=(0, 0, 0), radius=1.0):
    """Tessellated UV sphere: 2*n_lat*n_lon triangles.

    Returns (vertices (T,3,3) float32, normals (T,3,3) float32 — smooth
    per-vertex sphere normals).
    """
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    theta, phi = np.meshgrid(lat, lon, indexing="ij")
    pts = np.stack([np.sin(theta) * np.cos(phi),
                    np.sin(theta) * np.sin(phi),
                    np.cos(theta)], axis=-1)  # (n_lat+1, n_lon+1, 3)

    a = pts[:-1, :-1]
    b = pts[1:, :-1]
    c = pts[1:, 1:]
    d = pts[:-1, 1:]
    t1 = np.stack([a, b, c], axis=-2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=-2).reshape(-1, 3, 3)
    tris_unit = np.concatenate([t1, t2], 0)

    # drop degenerate pole slivers (zero area)
    e1 = tris_unit[:, 1] - tris_unit[:, 0]
    e2 = tris_unit[:, 2] - tris_unit[:, 0]
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    tris_unit = tris_unit[area2 > 1e-12]

    normals = tris_unit.copy()  # unit-sphere position == smooth normal
    verts = (tris_unit * radius + np.asarray(center, np.float32)).astype(np.float32)
    return verts, normals.astype(np.float32)


def sphere_with_n_triangles(n_target: int, center=(0, 0, 0), radius=1.0):
    """UV sphere with approximately n_target triangles."""
    n_lat = max(2, int(np.sqrt(n_target / 4)))
    n_lon = max(3, n_target // (2 * n_lat))
    return uv_sphere(n_lat, n_lon, center, radius)


def quad(p0, p1, p2, p3):
    """Two triangles for the quad p0-p1-p2-p3 (counter-clockwise).

    Returns (vertices (2,3,3) float32, normals (2,3,3) float32).
    Used to assemble Cornell-Box walls and area lights.
    """
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    v = np.stack([np.stack([p0, p1, p2]), np.stack([p0, p2, p3])], 0)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    normals = np.repeat(n[:, None, :], 3, axis=1)
    return v, normals.astype(np.float32)

