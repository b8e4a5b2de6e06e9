"""Native-accelerated IO front doors.

Drop-in variants of ``io.vtk.read_mesh_file`` / ``read_time_file`` /
``io.stl.read_stl`` that use the C++ parser (``native/vtkcache.cc``) when it
builds, and fall back to the pure-Python spec implementations otherwise
(``native.build.load`` logs which).  The cache subsystem and frontends
route through these.

A copy of ``optix_ray_tracer_tpu/io/native_io.py`` (host numpy; this
package does not import the JAX one).
"""

from __future__ import annotations

import ctypes

import numpy as np

from optix_ray_tracer_tpu_torch.io import stl as stl_py
from optix_ray_tracer_tpu_torch.io import vtk as vtk_py
from optix_ray_tracer_tpu_torch.native.build import load


def native_available() -> bool:
    return load() is not None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def read_mesh_file(path) -> vtk_py.MeshFrame:
    lib = load()
    if lib is None:
        return vtk_py.read_mesh_file(path)
    with open(path, "rb") as f:
        data = f.read()
    h = lib.orttpu_vtk_mesh_parse(data, len(data))
    if not h:
        raise vtk_py.VTKParseError(
            f"{path}: {lib.orttpu_last_error().decode()}")
    try:
        n_cells = lib.orttpu_mesh_num_cells(h)
        n_tris = lib.orttpu_mesh_num_tris(h)
        ids = np.zeros(n_cells, np.int64)
        vel = np.zeros((n_cells, 3), np.float32)
        verts = np.zeros((n_tris, 3, 3), np.float32)
        normals = np.zeros((n_tris, 3, 3), np.float32)
        offsets = np.zeros(n_cells, np.int64)
        counts = np.zeros(n_cells, np.int64)
        lib.orttpu_mesh_fill(h, _ptr(ids), _ptr(vel), _ptr(verts),
                             _ptr(normals), _ptr(offsets), _ptr(counts))
    finally:
        lib.orttpu_mesh_free(h)
    verts_list = [verts[offsets[i]:offsets[i] + counts[i]]
                  for i in range(n_cells)]
    normals_list = [normals[offsets[i]:offsets[i] + counts[i]]
                    for i in range(n_cells)]
    return vtk_py.MeshFrame(ids=ids, velocities=vel, vertices=verts_list,
                            normals=normals_list)


def read_time_file(path) -> vtk_py.TimeFrame:
    lib = load()
    if lib is None:
        return vtk_py.read_time_file(path)
    with open(path, "rb") as f:
        data = f.read()
    h = lib.orttpu_vtk_time_parse(data, len(data))
    if not h:
        raise vtk_py.VTKParseError(
            f"{path}: {lib.orttpu_last_error().decode()}")
    try:
        n = lib.orttpu_time_num_points(h)
        pos = np.zeros((n, 3), np.float64)
        ids = np.zeros(n, np.int64)
        quat = np.zeros((n, 4), np.float32)
        vel = np.zeros((n, 3), np.float32)
        shape = np.zeros(n, np.int64)
        lib.orttpu_time_fill(h, _ptr(pos), _ptr(ids), _ptr(quat), _ptr(vel),
                             _ptr(shape))
    finally:
        lib.orttpu_time_free(h)
    return vtk_py.TimeFrame(positions=pos.astype(np.float32), ids=ids,
                            quats=quat, velocities=vel, shape_ids=shape)


def read_stl(path):
    lib = load()
    if lib is None:
        return stl_py.read_stl(path)
    with open(path, "rb") as f:
        data = f.read()
    h = lib.orttpu_stl_parse(data, len(data))
    if not h:
        raise ValueError(f"{path}: {lib.orttpu_last_error().decode()}")
    try:
        n = lib.orttpu_stl_num_tris(h)
        verts = np.zeros((n, 3, 3), np.float32)
        normals = np.zeros((n, 3, 3), np.float32)
        lib.orttpu_stl_fill(h, _ptr(verts), _ptr(normals))
    finally:
        lib.orttpu_stl_free(h)
    return verts, normals
