"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

All kernels compile into one shared library with a plain C interface,
built on first use into ``build/kernels/`` beside the package and loaded
with ``ctypes``: one ``nvcc -c`` per source (``-gencode
arch=compute_90a,code=sm_90a -O3``), all started together, then one
``nvcc -shared`` link.  Pointers come from ``Tensor.data_ptr()`` and the
stream from ``torch.cuda.current_stream().cuda_stream``.  ``-fmad=false``
keeps every multiply and add rounded on its own, as PyTorch's elementwise
kernels round them, so each kernel agrees bit for bit with its plain
version: a choice made for the checks, which the hit rule does not
require.

Nothing here runs at import: the CPU tests import every module, and a
machine without ``nvcc`` never reaches :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_lib: ctypes.CDLL | None = None
#: the last build's compiler output (``-Xptxas -v`` register and shared
#: memory report) and wall seconds; None when the library was cached
build_log: str | None = None
build_seconds: float | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                    "bin", "nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _build(srcs: list[Path], so: Path) -> str:
    """Compile every source in its own nvcc process, all at once, then
    link them into ``so``; returns the compilers' output."""
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)]
    logs, failed = [], []
    for src, proc in zip(srcs, procs):
        logs.append(proc.communicate()[0])
        if proc.returncode:
            failed.append(f"{src.name} ({proc.returncode})")
    if not failed:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode:
            failed.append(f"link ({link.returncode})")
        else:
            os.replace(tmp, so)
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    return log


def load() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    srcs = _sources()
    digest = hashlib.sha1()
    for p in sorted(CSRC.iterdir()):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libort_kernels_{digest.hexdigest()[:12]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        build_log = _build(srcs, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for kernel in KERNELS:
        fn = getattr(lib, kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(t: torch.Tensor, name: str, dtype: torch.dtype, device,
          shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (with ``shape`` where given; -1 matches any extent)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and (len(shape) != t.dim() or any(
            s not in (-1, ts) for s, ts in zip(shape, t.shape))):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")


class Kernel:
    """One C entry point of the library, with the count of its launches.

    ``launches`` goes up by one each time the wrapper launches the kernel
    on the card, and nowhere else: a run that resets it and reads it
    afterwards sees whether its path went through the kernel."""

    def __init__(self, name: str, symbol: str, argtypes: list,
                 source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; ``args`` are the C
        function's arguments before the stream."""
        fn = getattr(load(), self.symbol)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error "
                               f"{err}")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int

#: kernel A (tile raster)
TILE_RASTER = Kernel(
    "tile_raster", "ort_tile_raster",
    [_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
     _P],
    source="optix_ray_tracer_tpu_torch/csrc/tile_raster.cu",
    replaces="optix_ray_tracer_tpu/ops/pallas/tile_raster.py:70")
#: kernel B (flat block march)
BLOCK_MARCH = Kernel(
    "block_march", "ort_block_march",
    [_P, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P],
    source="optix_ray_tracer_tpu_torch/csrc/block_march.cu",
    replaces="optix_ray_tracer_tpu/ops/pallas/block_march.py:173")
#: kernel C (cluster probe)
PROBE = Kernel(
    "probe_first_cluster", "ort_probe_first_cluster",
    [_P, _I, _P, _I, _I, _P, _P, _P],
    source="optix_ray_tracer_tpu_torch/csrc/block_march.cu",
    replaces="optix_ray_tracer_tpu/ops/pallas/block_march.py:694")

#: kernel D (instanced tile raster)
TILE_RASTER_INSTANCED = Kernel(
    "tile_raster_instanced", "ort_tile_raster_instanced",
    [_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P,
     _P, _P, _P],
    source="optix_ray_tracer_tpu_torch/csrc/tile_raster.cu",
    replaces="optix_ray_tracer_tpu/ops/pallas/tile_raster.py:376")
#: kernel E (instanced block march)
BLOCK_MARCH_INSTANCED = Kernel(
    "block_march_instanced", "ort_block_march_instanced",
    [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    source="optix_ray_tracer_tpu_torch/csrc/block_march.cu",
    replaces="optix_ray_tracer_tpu/ops/pallas/block_march.py:916")
#: kernel F (hierarchical block march)
BLOCK_MARCH_HIER = Kernel(
    "block_march_hier", "ort_block_march_hier",
    [_P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P, _P],
    source="optix_ray_tracer_tpu_torch/csrc/block_march.cu",
    replaces="optix_ray_tracer_tpu/ops/pallas/block_march.py:463")

#: kernel G (leaf sweep)
LEAF_SWEEP = Kernel(
    "leaf_sweep", "ort_leaf_sweep",
    [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    source="optix_ray_tracer_tpu_torch/csrc/leaf_sweep.cu",
    replaces="optix_ray_tracer_tpu/ops/pallas/leaf_sweep.py:30")

KERNELS = (TILE_RASTER, BLOCK_MARCH, PROBE, TILE_RASTER_INSTANCED,
           BLOCK_MARCH_INSTANCED, BLOCK_MARCH_HIER, LEAF_SWEEP)
