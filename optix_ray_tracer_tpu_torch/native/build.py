"""Build + load the native IO library (lazy, cached, graceful fallback).

A copy of ``optix_ray_tracer_tpu/native/build.py`` with one change: the
library lands in ``build/native/`` beside the package (as the CUDA
kernels land in ``build/kernels/``), never next to the source.
``g++ -O3 -shared -fPIC`` on first use; all callers handle
``load() is None`` and fall back to the pure-Python parsers (the spec
implementations).  The first ``load`` logs which readers run.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

from optix_ray_tracer_tpu_torch.utils.logging import LOG

_SRC = Path(__file__).resolve().parent / "vtkcache.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB = BUILD_DIR / "libvtkcache.so"

_lib: ctypes.CDLL | None = None
_tried = False


def build(force: bool = False) -> str | None:
    """Compile the shared library if missing/stale; returns its path."""
    if (not force and _LIB.exists()
            and _LIB.stat().st_mtime >= _SRC.stat().st_mtime):
        return str(_LIB)
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", str(_SRC),
             "-o", str(tmp)],
            check=True, capture_output=True, timeout=240)
        os.replace(tmp, _LIB)
        return str(_LIB)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        return None


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None on any failure."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    path = build()
    if path is None:
        LOG.info("native IO library unavailable (g++ build failed): the "
                 "Python VTK/STL readers run")
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        LOG.info("native IO library %s did not load: the Python VTK/STL "
                 "readers run", path)
        return None

    c_char_p = ctypes.c_char_p
    c_long = ctypes.c_long
    c_void_p = ctypes.c_void_p

    lib.orttpu_last_error.restype = c_char_p
    lib.orttpu_vtk_mesh_parse.restype = c_void_p
    lib.orttpu_vtk_mesh_parse.argtypes = [c_char_p, c_long]
    lib.orttpu_mesh_num_cells.restype = c_long
    lib.orttpu_mesh_num_cells.argtypes = [c_void_p]
    lib.orttpu_mesh_num_tris.restype = c_long
    lib.orttpu_mesh_num_tris.argtypes = [c_void_p]
    lib.orttpu_mesh_fill.argtypes = [c_void_p] + [c_void_p] * 6
    lib.orttpu_mesh_free.argtypes = [c_void_p]

    lib.orttpu_vtk_time_parse.restype = c_void_p
    lib.orttpu_vtk_time_parse.argtypes = [c_char_p, c_long]
    lib.orttpu_time_num_points.restype = c_long
    lib.orttpu_time_num_points.argtypes = [c_void_p]
    lib.orttpu_time_fill.argtypes = [c_void_p] + [c_void_p] * 5
    lib.orttpu_time_free.argtypes = [c_void_p]

    lib.orttpu_stl_parse.restype = c_void_p
    lib.orttpu_stl_parse.argtypes = [c_char_p, c_long]
    lib.orttpu_stl_num_tris.restype = c_long
    lib.orttpu_stl_num_tris.argtypes = [c_void_p]
    lib.orttpu_stl_fill.argtypes = [c_void_p, c_void_p, c_void_p]
    lib.orttpu_stl_free.argtypes = [c_void_p]

    LOG.info("native IO library %s: the C++ VTK/STL readers run", path)
    _lib = lib
    return _lib
