"""Import hygiene of the port: optix_ray_tracer_tpu_torch and every module
of the ported slices import neither jax nor the JAX package; on CPU
tensors no kernel (A-G) launches; chip_smoke.py refuses to run without
CUDA."""

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
    "optix_ray_tracer_tpu_torch.models.common",
    "optix_ray_tracer_tpu_torch.models.renderer_time",
    "optix_ray_tracer_tpu_torch.ops.bvh",
    "optix_ray_tracer_tpu_torch.ops.instanced",
    "optix_ray_tracer_tpu_torch.ops.intersect",
    "optix_ray_tracer_tpu_torch.ops.kernels._lib",
    "optix_ray_tracer_tpu_torch.ops.kernels.block_march",
    "optix_ray_tracer_tpu_torch.ops.kernels.leaf_sweep",
    "optix_ray_tracer_tpu_torch.ops.kernels.tile_raster",
    "optix_ray_tracer_tpu_torch.ops.march",
    "optix_ray_tracer_tpu_torch.ops.raster",
    "optix_ray_tracer_tpu_torch.ops.raster_instanced",
    "optix_ray_tracer_tpu_torch.ops.raysort",
    "optix_ray_tracer_tpu_torch.ops.sweep",
    "optix_ray_tracer_tpu_torch.ops.tlas",
    "optix_ray_tracer_tpu_torch.render.denoise",
    "optix_ray_tracer_tpu_torch.render.film",
    "optix_ray_tracer_tpu_torch.render.neural_denoise",
    "optix_ray_tracer_tpu_torch.render.wavefront",
    "optix_ray_tracer_tpu_torch.scene.camera",
    "optix_ray_tracer_tpu_torch.scene.geometry",
    "optix_ray_tracer_tpu_torch.scene.materials",
    "optix_ray_tracer_tpu_torch.utils.color",
    "optix_ray_tracer_tpu_torch.utils.rng",
    "optix_ray_tracer_tpu_torch.utils.tensors",
    "optix_ray_tracer_tpu_torch.utils.transforms",
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
from types import SimpleNamespace
import numpy as np, torch
torch.set_num_threads(1)
from optix_ray_tracer_tpu_torch.models.common import render_frame
from optix_ray_tracer_tpu_torch.ops.sweep import make_sweep_intersector
from optix_ray_tracer_tpu_torch.render.film import Film
from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.models.renderer_time import (
    packing_tables, tlas_frame_intersector)
from optix_ray_tracer_tpu_torch.ops.instanced import build_instanced_library
from optix_ray_tracer_tpu_torch.ops.kernels import _lib
from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
from optix_ray_tracer_tpu_torch.render import wavefront
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, ShapeLibrary, Spheres, Triangles)
from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder
v, n = sphere_with_n_triangles(2500)
mb = MaterialBuilder(); metal = mb.add_metal((0.8, 0.8, 0.8), 0.1)
cpu = dict(device="cpu")
scene = Scene(Spheres.empty(**cpu), Triangles.from_arrays(v, n, **cpu))
inter = make_march_intersector(scene, raster=True)
cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                     **cpu)
img, _, _ = wavefront.render(scene, mb.build(**cpu), cam, 32, 32, spp=1,
                             intersector=inter, max_depth=2)
assert torch.isfinite(img).all()
# a coherent query routed to the hierarchical marcher (F)
bm.HIER_MIN_CLUSTERS = 8
o, d = cam.generate_rays(16, 16)
assert inter.intersect(scene, o.reshape(-1, 3), d.reshape(-1, 3)).is_hit.any()
# a TLAS frame: camera wave through D, bounce waves through E
shapes = ShapeLibrary.from_meshes([sphere_with_n_triangles(80),
                                   sphere_with_n_triangles(200)], **cpu)
lib = build_instanced_library(shapes.vertices.numpy(), shapes.offsets,
                              shapes.counts, **cpu)
r = np.random.default_rng(1)
sid, valid = r.integers(0, 2, 6), np.ones(6, bool)
tl, ti, _ = packing_tables(shapes, sid[None], valid[None])
q = torch.as_tensor(r.normal(size=(6, 4)).astype(np.float32))
tlas = tlas_frame_intersector(
    lib, shapes, sid, valid, torch.as_tensor(tl[0]), torch.as_tensor(ti[0]),
    torch.full((6,), metal, dtype=torch.int32),
    torch.as_tensor(r.uniform(-2, 2, (6, 3)).astype(np.float32)), q, q,
    torch.zeros((6, 3)), 1.0, 0.0, 1)
cam2 = Camera.look_at((9.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                      **cpu)
img, _, _ = wavefront.render(
    Scene(Spheres.empty(**cpu), Triangles.empty(**cpu)), mb.build(**cpu),
    cam2, 32, 32, spp=1, intersector=tlas, max_depth=2)
assert torch.isfinite(img).all()
# a sweep frame (G) through render_frame with both denoisers, into a Film
cfg = SimpleNamespace(integrator="whitted", background=(0.7, 0.8, 0.9),
                      max_depth=2, sampler="pcg", denoise=True,
                      denoiser="neural")
sweep = make_sweep_intersector(scene)
film = Film.create(32, 32, **cpu)
for name in ("neural", "atrous"):
    out = render_frame(SimpleNamespace(**dict(vars(cfg), denoiser=name)),
                       scene, mb.build(**cpu), cam, 32, 32, 1, 0, sweep)
    film = film.add(*out)
assert np.isfinite(film.mean().numpy()).all() and film.spp == 2
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
    """Renders on CPU tensors (a raster + march frame, a TLAS frame, a
    sweep frame through render_frame with both denoisers, into a Film)
    and a query routed to the hierarchical marcher take the plain
    versions: every launch count (A-G) stays 0 and the library is never
    built."""
    proc = _run(_LAUNCHES)
    assert proc.returncode == 0, proc.stderr
    assert "LAUNCHES [0, 0, 0, 0, 0, 0, 0] True" in proc.stdout, \
        proc.stdout


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
