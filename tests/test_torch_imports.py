"""Import hygiene of the port: optix_ray_tracer_tpu_torch and every module
of the ported slice import neither jax nor the JAX package; on CPU tensors
no kernel launches; chip_smoke.py refuses to run without CUDA."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "optix_ray_tracer_tpu_torch",
    "optix_ray_tracer_tpu_torch.convert",
    "optix_ray_tracer_tpu_torch.io.meshgen",
    "optix_ray_tracer_tpu_torch.ops.bvh",
    "optix_ray_tracer_tpu_torch.ops.intersect",
    "optix_ray_tracer_tpu_torch.ops.kernels._lib",
    "optix_ray_tracer_tpu_torch.ops.kernels.block_march",
    "optix_ray_tracer_tpu_torch.ops.kernels.tile_raster",
    "optix_ray_tracer_tpu_torch.ops.march",
    "optix_ray_tracer_tpu_torch.ops.raster",
    "optix_ray_tracer_tpu_torch.ops.raysort",
    "optix_ray_tracer_tpu_torch.ops.sweep",
    "optix_ray_tracer_tpu_torch.render.wavefront",
    "optix_ray_tracer_tpu_torch.scene.camera",
    "optix_ray_tracer_tpu_torch.scene.geometry",
    "optix_ray_tracer_tpu_torch.scene.materials",
    "optix_ray_tracer_tpu_torch.utils.color",
    "optix_ray_tracer_tpu_torch.utils.rng",
    "optix_ray_tracer_tpu_torch.utils.tensors",
    "optix_ray_tracer_tpu_torch.utils.vecmath",
]

_CHECK = """
import importlib, sys
for m in {modules!r}:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m in ("jax", "optix_ray_tracer_tpu")
             or m.startswith(("jax.", "jaxlib", "optix_ray_tracer_tpu.")))
print("BAD", bad)
import torch
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
"""

_LAUNCHES = """
import numpy as np, torch
torch.set_num_threads(1)
from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
from optix_ray_tracer_tpu_torch.render import wavefront
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import Scene, Spheres, Triangles
from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder
v, n = sphere_with_n_triangles(2500)
mb = MaterialBuilder(); mb.add_metal((0.8, 0.8, 0.8), 0.1)
scene = Scene(Spheres.empty(), Triangles.from_arrays(v, n))
inter = make_march_intersector(scene, raster=True)
cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
img, _, _ = wavefront.render(scene, mb.build(), cam, 32, 32, spp=1,
                             intersector=inter, max_depth=2)
assert torch.isfinite(img).all()
print("LAUNCHES", [k.launches for k in _lib.KERNELS], _lib._lib is None)
"""


def _run(code, cwd=ROOT, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    proc = _run(_CHECK.format(modules=MODULES))
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_cpu_path_launches_no_kernel():
    """A whole raster + march render on CPU tensors takes the plain
    versions: every launch count stays 0 and the library is never built."""
    proc = _run(_LAUNCHES)
    assert proc.returncode == 0, proc.stderr
    assert "LAUNCHES [0, 0, 0] True" in proc.stdout, proc.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_cuda(tmp_path, where):
    """No CUDA here: chip_smoke.py exits non-zero and prints no ok line,
    in the repository and in a directory holding only the script."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
