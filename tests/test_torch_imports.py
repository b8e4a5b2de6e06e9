"""Import hygiene of the port: optix_ray_tracer_tpu_torch and every module
of the ported slices import neither jax nor the JAX package; on CPU
tensors no kernel (A-U) launches, and the wrappers of L, M, N, S, T and U
refuse them; chip_smoke.py refuses to run without CUDA."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "optix_ray_tracer_tpu_torch",
    "optix_ray_tracer_tpu_torch.__main__",
    "optix_ray_tracer_tpu_torch.convert",
    "optix_ray_tracer_tpu_torch.graft",
    "optix_ray_tracer_tpu_torch.io.cache",
    "optix_ray_tracer_tpu_torch.io.config",
    "optix_ray_tracer_tpu_torch.io.meshgen",
    "optix_ray_tracer_tpu_torch.io.native_io",
    "optix_ray_tracer_tpu_torch.io.obj",
    "optix_ray_tracer_tpu_torch.io.series",
    "optix_ray_tracer_tpu_torch.io.stl",
    "optix_ray_tracer_tpu_torch.io.vtk",
    "optix_ray_tracer_tpu_torch.models.benchmarks",
    "optix_ray_tracer_tpu_torch.models.common",
    "optix_ray_tracer_tpu_torch.models.fused",
    "optix_ray_tracer_tpu_torch.models.renderer_mesh",
    "optix_ray_tracer_tpu_torch.models.renderer_time",
    "optix_ray_tracer_tpu_torch.native.build",
    "optix_ray_tracer_tpu_torch.ops.bvh",
    "optix_ray_tracer_tpu_torch.ops.instanced",
    "optix_ray_tracer_tpu_torch.ops.intersect",
    "optix_ray_tracer_tpu_torch.ops.kernels._lib",
    "optix_ray_tracer_tpu_torch.ops.kernels.binning",
    "optix_ray_tracer_tpu_torch.ops.kernels.bounce",
    "optix_ray_tracer_tpu_torch.ops.kernels.block_march",
    "optix_ray_tracer_tpu_torch.ops.kernels.leaf_sweep",
    "optix_ray_tracer_tpu_torch.ops.kernels.march_glue",
    "optix_ray_tracer_tpu_torch.ops.kernels.tile_raster",
    "optix_ray_tracer_tpu_torch.ops.march",
    "optix_ray_tracer_tpu_torch.ops.raster",
    "optix_ray_tracer_tpu_torch.ops.raster_instanced",
    "optix_ray_tracer_tpu_torch.ops.raysort",
    "optix_ray_tracer_tpu_torch.ops.sweep",
    "optix_ray_tracer_tpu_torch.ops.tlas",
    "optix_ray_tracer_tpu_torch.ops.traverse",
    "optix_ray_tracer_tpu_torch.parallel.animation",
    "optix_ray_tracer_tpu_torch.parallel.sharding",
    "optix_ray_tracer_tpu_torch.render.adaptive",
    "optix_ray_tracer_tpu_torch.render.denoise",
    "optix_ray_tracer_tpu_torch.render.envmap",
    "optix_ray_tracer_tpu_torch.render.film",
    "optix_ray_tracer_tpu_torch.render.neural_denoise",
    "optix_ray_tracer_tpu_torch.render.pathtracer",
    "optix_ray_tracer_tpu_torch.render.restir",
    "optix_ray_tracer_tpu_torch.render.temporal",
    "optix_ray_tracer_tpu_torch.render.train_denoiser",
    "optix_ray_tracer_tpu_torch.render.viewer",
    "optix_ray_tracer_tpu_torch.render.wavefront",
    "optix_ray_tracer_tpu_torch.scene.camera",
    "optix_ray_tracer_tpu_torch.scene.cornell",
    "optix_ray_tracer_tpu_torch.scene.geometry",
    "optix_ray_tracer_tpu_torch.scene.lights",
    "optix_ray_tracer_tpu_torch.scene.materials",
    "optix_ray_tracer_tpu_torch.scene.textures",
    "optix_ray_tracer_tpu_torch.utils.color",
    "optix_ray_tracer_tpu_torch.utils.colorramp",
    "optix_ray_tracer_tpu_torch.utils.debug",
    "optix_ray_tracer_tpu_torch.utils.logging",
    "optix_ray_tracer_tpu_torch.utils.profiling",
    "optix_ray_tracer_tpu_torch.utils.qmc",
    "optix_ray_tracer_tpu_torch.utils.rng",
    "optix_ray_tracer_tpu_torch.utils.tensors",
    "optix_ray_tracer_tpu_torch.utils.transforms",
    "optix_ray_tracer_tpu_torch.utils.vecmath",
]

#: every source file of the port, and the scripts that drive it on the
#: card: none may name jax or the JAX package in an import statement
SOURCES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "optix_ray_tracer_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "tools/a_phases.py", "tools/kernel_bench.py",
    "tools/path_ab.py", "tools/prof_port.py", "tools/ptxas_report.py",
    "tools/s_phases.py", "tools/sync_sites.py"]

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
# a path-traced frame: camera wave on A, NEE segments on the bundle engine
# (A), bounces and sky NEE on C then B; then an ortho wave (A, "dir")
from optix_ray_tracer_tpu_torch.io.meshgen import quad
from optix_ray_tracer_tpu_torch.render.envmap import gradient_sky
from optix_ray_tracer_tpu_torch.scene.lights import collect_area_lights
lamp = mb.add_emissive((5.0, 5.0, 5.0))
v4, n4 = sphere_with_n_triangles(4000)
lv, ln = quad([-1, -1, 2], [-1, 1, 2], [1, 1, 2], [1, -1, 2])
pscene = Scene(Spheres.empty(**cpu), Triangles.from_arrays(
    np.concatenate([v4, lv]), np.concatenate([n4, ln]),
    np.r_[np.full(len(v4), metal), [lamp, lamp]].astype(np.int32), **cpu))
pinter = make_march_intersector(pscene, raster=True)
assert pinter.clusters.num_clusters >= 16
pcfg = SimpleNamespace(integrator="path", background=(0.0, 0.0, 0.0),
                       max_depth=2, sampler="pcg", denoise=False)
pm = mb.build(**cpu)
img, _, _ = render_frame(pcfg, pscene, pm, cam, 32, 32, 1, 0, pinter,
                         env=gradient_sky(sun_dir=(0.3, 0.2, 0.9), **cpu),
                         lights=collect_area_lights(pscene, pm))
assert torch.isfinite(img).all()
sun = torch.tensor([[0.3, 0.2, 0.9]]).expand(256, 3)
assert pinter.any_hit_from(pscene, o.reshape(-1, 3) * 0 + sun * -3, sun,
                           mode="ortho", block_rays=128).any()
# the product extras: ReSTIR DI and GI frames with Sobol, an adaptive
# batch, on the same march intersector
from optix_ray_tracer_tpu_torch.render.adaptive import (
    AdaptiveFilm, adaptive_batch)
pl = collect_area_lights(pscene, pm)
for integ in ("restir", "restir-gi"):
    img, _, _ = render_frame(
        SimpleNamespace(**dict(vars(pcfg), integrator=integ,
                               sampler="sobol")),
        pscene, pm, cam, 32, 32, 1, 0, pinter, lights=pl, sample_offset=3)
    assert torch.isfinite(img).all()
af = adaptive_batch(pscene, pm, pl, cam, AdaptiveFilm.create(32, 32, **cpu),
                    k=1024, intersector=pinter, max_depth=2)
assert af.total_samples == 1024
# a sharded frame (4 bands of repeated CPU devices) and an LBVH frame
from optix_ray_tracer_tpu_torch.ops.traverse import make_intersector
from optix_ray_tracer_tpu_torch.parallel.sharding import (
    make_mesh, render_sharded)
img = render_sharded(scene, mb.build(**cpu), cam, 32, 32, 2,
                     make_mesh(4, 2, [torch.device("cpu")] * 8),
                     intersector=inter, max_depth=2)
img, _, _ = wavefront.render(scene, mb.build(**cpu), cam, 16, 16, spp=1,
                             intersector=make_intersector(scene),
                             max_depth=2)
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


def test_modules_cover_the_package():
    """MODULES lists every module of the port (and the package)."""
    found = {"optix_ray_tracer_tpu_torch." + ".".join(
        Path(p).with_suffix("").parts[1:]) for p in SOURCES
        if p.startswith("optix_ray_tracer_tpu_torch/")
        and not p.endswith("__init__.py")}
    assert found | {"optix_ray_tracer_tpu_torch"} == set(MODULES)


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_import_statement(path):
    """No import statement anywhere in the file (lazy ones inside
    functions included) names jax or optix_ray_tracer_tpu."""
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                   "optix_ray_tracer_tpu")]
    assert not bad, bad


def test_cpu_path_launches_no_kernel():
    """Renders on CPU tensors (a raster + march frame, a TLAS frame, a
    sweep frame through render_frame with both denoisers, into a Film, a
    path-traced frame with bundle NEE and a sky, an ortho wave, ReSTIR DI
    and GI frames with Sobol, an adaptive batch, a sharded frame, an LBVH
    frame) and a query routed to the hierarchical marcher take the plain
    versions: every launch count (A-G with the deep marchers F2 and C2,
    the bounce loop's H-N, the marcher's glue O-R and the binning's S-U)
    stays 0 and the library is never built."""
    proc = _run(_LAUNCHES)
    assert proc.returncode == 0, proc.stderr
    assert f"LAUNCHES {[0] * 23} True" in proc.stdout, proc.stdout


_REFUSE = """
import torch
from optix_ray_tracer_tpu_torch.ops.intersect import Hit
from optix_ray_tracer_tpu_torch.ops.kernels import _lib, binning, bounce
from optix_ray_tracer_tpu_torch.render.envmap import gradient_sky
n = 64
v3, f, i, b = (torch.zeros(n, 3), torch.zeros(n),
               torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=bool))
hit = Hit(t=f, prim_type=i, prim_id=i, u=f, v=f)
env = gradient_sky(sun_dir=(0.3, 0.2, 0.9), device="cpu")
calls = {
    "L": lambda: bounce.nee_sample_call(v3, v3, b, i, v3, v3, i.long(),
                                        i.long(), 1, 7, "pcg", None, env),
    "M": lambda: bounce.nee_add_call(v3, v3, b, b, None, None, None),
    "N": lambda: bounce.hit_radiance_call(v3, v3, f, v3, b, b, hit, i, v3,
                                          b, 1, torch.zeros(3)),
    "S": lambda: binning.bin_rects_call(binning.RECTS_PAIR, v3, v3,
                                        (0.0, 0.0, 0.0)),
    "T": lambda: binning.bin_count_call(v3, v3, f, f, 32, "bundle",
                                        torch.zeros(6, 4)),
    "U": lambda: binning.bin_emit_call(torch.zeros(6, 4),
                                       torch.zeros(2, 1, 14), i[:2], i[:3],
                                       i[:2, None], 64, "bundle"),
}
for name, call in calls.items():
    try:
        call()
    except ValueError as e:
        assert "CUDA" in str(e), e
        print("REFUSED", name)
print("LAUNCHES", [k.launches for k in _lib.KERNELS], _lib._lib is None)
"""


def test_nee_wrappers_refuse_cpu_tensors():
    """The wrappers of L, M, N, S, T and U never run a plain version: CPU
    tensors raise before any build or launch."""
    proc = _run(_REFUSE)
    assert proc.returncode == 0, proc.stderr
    for name in "LMNSTU":
        assert f"REFUSED {name}" in proc.stdout, proc.stdout
    assert f"LAUNCHES {[0] * 23} True" in proc.stdout, proc.stdout


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


def test_kernel_bench_binning_entries():
    """tools/kernel_bench.py: ``--waves "T, U"`` keeps the ``BINNING``
    stages of T and U and ``--waves "S:"`` those of S (each staged by each
    tree itself), neither a saved wave, and the tool refuses to run
    without CUDA."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kernel_bench", ROOT / "tools" / "kernel_bench.py")
    kb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kb)
    assert kb.BINNING and all(("T, U" in name) != ("S:" in name)
                              for name in kb.BINNING)
    assert {letters for _, letters in kb.BINNING.values()} == {"TU", "S"}
    assert not any("T, U" in name or "S:" in name for name in kb.WAVES)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "kernel_bench.py"), "--waves",
         "T, U"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr
