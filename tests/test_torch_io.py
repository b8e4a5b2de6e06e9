"""The port's copies of the JAX package's host IO (``io/config``,
``io/vtk``, ``io/stl``, ``io/obj``, ``io/series``, ``io/cache``,
``io/native_io`` with ``native/build``, ``utils/colorramp``) against the
JAX modules, on files the tests write.

Tolerance: the Python readers and the C++ readers each give the same
arrays in both packages, bit for bit (the same code); the C++ readers
against the Python ones to 1e-6 on vertices and 1e-5 on normals (as
tests/test_native.py holds them); the sphere transforms of a config to
1e-6 (the port computes the SRT matrix with torch, the JAX package with
jnp)."""

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

from optix_ray_tracer_tpu.io import cache as jcache
from optix_ray_tracer_tpu.io import config as jconfig
from optix_ray_tracer_tpu.io import native_io as jnative
from optix_ray_tracer_tpu.io import obj as jobj
from optix_ray_tracer_tpu.io import series as jseries
from optix_ray_tracer_tpu.io import stl as jstl
from optix_ray_tracer_tpu.io import vtk as jvtk
from optix_ray_tracer_tpu.utils import colorramp as jramp
from optix_ray_tracer_tpu_torch.io import cache as tcache
from optix_ray_tracer_tpu_torch.io import config as tconfig
from optix_ray_tracer_tpu_torch.io import native_io as tnative
from optix_ray_tracer_tpu_torch.io import obj as tobj
from optix_ray_tracer_tpu_torch.io import series as tseries
from optix_ray_tracer_tpu_torch.io import stl as tstl
from optix_ray_tracer_tpu_torch.io import vtk as tvtk
from optix_ray_tracer_tpu_torch.native import build as tbuild
from optix_ray_tracer_tpu_torch.utils import colorramp as tramp

ROOT = Path(__file__).resolve().parents[1]

CONFIG = {
    "mesh": False, "series-path": "data", "series-name": "s.vtk.series",
    "stl-path": "shapes", "cache-path": "cache", "debug-mode": True,
    "particle-material-preset": "Plasma",
    "roughs": [{"albedo": [0.7, 0.6, 0.5]}, {"albedo": [0.1, 0.2, 0.3]}],
    "metals": [{"albedo": [0.8, 0.8, 0.9], "fuzz": 0.05}],
    "spheres": [{"center": [1, 2, 3], "radius": 0.5, "mat-type": "METAL",
                 "mat-index": 0, "shift": [0.5, 0, -1],
                 "rotate": [30, 45, 60], "scale": [2, 2, 2]}],
    "dielectrics": [{"ior": 1.33}], "emissives": [{"emission": [4, 4, 4]}],
    "meshes": [{"obj": "ground.obj", "mat-type": "ROUGH", "mat-index": 1}],
    "spp": 4, "max-depth": 3, "background": [0.1, 0.2, 0.3], "seed": 5,
    "denoise": "neural", "temporal": False, "integrator": "whitted",
    "loop-data": {"window-width": 64, "window-height": 48, "fps": 30,
                  "camera-center": [6, 0, 1], "camera-target": [0, 0, 0],
                  "up-direction": [0, 0, 1], "render-speed-ratio": 2,
                  "particle-shift": [1, 2, 3], "particle-scale": [2, 2, 2],
                  "aperture": 0.1, "focus-distance": 5.0},
}

BAD_CONFIGS = {
    "mat-type": {"spheres": [{"center": [0, 0, 0], "radius": 1,
                              "mat-type": "GLASS", "mat-index": 0}]},
    "mat-index": {"roughs": [], "spheres": [{
        "center": [0, 0, 0], "radius": 1, "mat-type": "ROUGH",
        "mat-index": 0}]},
    "vec3": {"roughs": [{"albedo": [1, 2]}]},
    "api": {"loop-data": {"api": "METAL"}},
    "integrator": {"integrator": "bidir"},
    "sampler": {"sampler": "halton"},
    "denoise": {"denoise": "oidn"},
    "missing-key": {"metals": [{"albedo": [1, 1, 1]}]},
    "envmap": {"envmap": {"type": "dome"}},
    "meshes": {"meshes": [{"mat-type": "ROUGH"}]},
    "textures": {"textures": [{"mat-index": 0}]},
}


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("spheres")
    return d


def test_parse_config_dict():
    j = jconfig.parse_config_dict(CONFIG, base_dir="/x")
    t = tconfig.parse_config_dict(CONFIG, base_dir="/x")
    assert _fields(t) == _fields(j)
    assert t.resolve("a/b") == j.resolve("a/b") == "/x/a/b"
    for js, ts in zip(j.spheres, t.spheres, strict=True):
        jc, jr = js.world_center_radius()
        tc, tr = ts.world_center_radius()
        np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tr, jr, rtol=1e-6)


@pytest.mark.parametrize("name", list(BAD_CONFIGS))
def test_config_errors(name):
    bad = BAD_CONFIGS[name]
    with pytest.raises(jconfig.ConfigError) as je:
        jconfig.parse_config_dict(bad)
    with pytest.raises(tconfig.ConfigError) as te:
        tconfig.parse_config_dict(bad)
    assert str(te.value) == str(je.value)


def test_load_config(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(json.dumps(CONFIG))
    assert (_fields(tconfig.load_config(str(p)))
            == _fields(jconfig.load_config(str(p))))
    (tmp_path / "bad.json").write_text("{nope")
    for path in (tmp_path / "bad.json", tmp_path / "none.json"):
        with pytest.raises(tconfig.ConfigError):
            tconfig.load_config(str(path))
        with pytest.raises(jconfig.ConfigError):
            jconfig.load_config(str(path))


@pytest.mark.parametrize("preset", ["viridis", "PLASMA", "terrain", "nope"])
@pytest.mark.parametrize("count", [1, 7, 300])
def test_color_ramp(preset, count):
    np.testing.assert_array_equal(tramp.bake_color_ramp(preset, count),
                                  jramp.bake_color_ramp(preset, count))


def _strips_polydata(seed: int):
    """Two particles of random strips (one strip cell each) with id and
    vel cell data."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(40, 3))
    strips = [np.arange(0, 18), np.arange(20, 40)[::-1].copy()]
    return jvtk.PolyData(
        points=pts, vertices=[], lines=[], polygons=[],
        triangle_strips=strips, point_data={},
        cell_data={"id": np.asarray([3, 7], np.int32),
                   "vel": rng.normal(size=(2, 3))})


def _poses_polydata(seed: int):
    rng = np.random.default_rng(seed)
    n = 25
    q = rng.normal(size=(n, 4))
    return jvtk.PolyData(
        points=rng.normal(size=(n, 3)), vertices=[], lines=[], polygons=[],
        triangle_strips=[], cell_data={}, point_data={
            "id": np.arange(n, dtype=np.int32),
            "quat": q / np.linalg.norm(q, axis=1, keepdims=True),
            "vel": rng.normal(size=(n, 3)),
            "shape_id": rng.integers(0, 3, n).astype(np.int32)})


def _equal_frames(a, b, exact: bool = True):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, list):
            assert len(x) == len(y)
            pairs = zip(x, y)
        else:
            pairs = [(x, y)]
        for xa, ya in pairs:
            if exact:
                np.testing.assert_array_equal(xa, ya, err_msg=f.name)
            else:
                np.testing.assert_allclose(
                    xa, ya, atol=1e-5 if f.name == "normals" else 1e-6,
                    err_msg=f.name)


@pytest.fixture(scope="module")
def native():
    if tbuild.load() is None or jnative.native_available() is False:
        pytest.skip("the native IO library does not build here")
    return tbuild.load()


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
@pytest.mark.parametrize("kind", ["mesh", "time"])
def test_vtk_readers(tmp_path, kind, binary):
    """write_polydata writes the same bytes; both packages' Python and
    C++ readers agree."""
    pd = _strips_polydata(1) if kind == "mesh" else _poses_polydata(2)
    jp, tp = tmp_path / "j.vtk", tmp_path / "t.vtk"
    jvtk.write_polydata(jp, pd, binary=binary)
    tvtk.write_polydata(tp, tvtk.PolyData(**dataclasses.asdict(pd)),
                        binary=binary)
    assert jp.read_bytes() == tp.read_bytes()
    read = "read_mesh_file" if kind == "mesh" else "read_time_file"
    ref = getattr(jvtk, read)(str(jp))
    _equal_frames(getattr(tvtk, read)(str(tp)), ref)
    if tbuild.load() is not None:
        nat = getattr(tnative, read)(str(tp))
        _equal_frames(nat, getattr(jnative, read)(str(jp)))
        _equal_frames(nat, ref, exact=False)


def test_vtk_parse_errors(tmp_path):
    p = tmp_path / "bad.vtk"
    p.write_text("not a vtk file")
    with pytest.raises(tvtk.VTKParseError):
        tvtk.read_mesh_file(str(p))
    pd = _strips_polydata(3)
    pd.cell_data.pop("vel")
    tvtk.write_polydata(p, tvtk.PolyData(**dataclasses.asdict(pd)))
    with pytest.raises(tvtk.VTKParseError, match="id/vel"):
        tvtk.read_mesh_file(str(p))


def test_series(tmp_path):
    (tmp_path / "s.vtk.series").write_text(json.dumps({"files": [
        {"name": f"f{i}.vtk", "time": t}
        for i, t in enumerate((0.0, 0.5, 1.25))]}))
    for args in ((str(tmp_path), "s.vtk.series"),
                 (str(tmp_path / "s.vtk.series"), None)):
        assert (dataclasses.asdict(tseries.read_series(*args))
                == dataclasses.asdict(jseries.read_series(*args)))
    (tmp_path / "one.vtk.series").write_text(
        json.dumps({"files": [{"name": "a.vtk", "time": 3.0}]}))
    assert tseries.read_series(str(tmp_path / "one.vtk.series")
                               ).durations == [1.0]
    (tmp_path / "bad.vtk.series").write_text("{}")
    with pytest.raises(ValueError, match="files"):
        tseries.read_series(str(tmp_path / "bad.vtk.series"))


def _stl_tris(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(30, 3, 3)).astype(np.float32)


def _write_stl(path, tris, binary: bool):
    if binary:
        rec = np.zeros(len(tris), dtype=[("n", "<f4", (3,)),
                                         ("v", "<f4", (3, 3)),
                                         ("a", "<u2")])
        rec["v"] = tris
        path.write_bytes(b"solid but binary".ljust(80, b" ")
                         + np.uint32(len(tris)).tobytes() + rec.tobytes())
    else:
        lines = ["solid s"]
        for t in tris:
            lines += ["facet normal 0 0 0", "outer loop"]
            lines += [f"vertex {x!r} {y!r} {z!r}" for x, y, z in t.tolist()]
            lines += ["endloop", "endfacet"]
        path.write_text("\n".join(lines + ["endsolid s"]))


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_stl(tmp_path, binary):
    p = tmp_path / "s.stl"
    tris = _stl_tris(4)
    _write_stl(p, tris, binary)
    ref = jstl.read_stl(str(p))
    got = tstl.read_stl(str(p))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], tris)
    if tbuild.load() is not None:
        for a, b in zip(tnative.read_stl(str(p)), jnative.read_stl(str(p))):
            np.testing.assert_array_equal(a, b)
    for k in range(3):
        (tmp_path / f"s{k}.stl").write_bytes(p.read_bytes())
    lib_t = tseries.load_stl_directory(str(tmp_path))
    lib_j = jseries.load_stl_directory(str(tmp_path))
    assert len(lib_t) == len(lib_j) == 4
    for (va, na), (vb, nb) in zip(lib_t, lib_j):
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(na, nb)


OBJ = """# quad and a triangle
mtllib m.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
usemtl shiny
f 1/1/1 2/2/1 3/3/1 4/1/1
usemtl light
f 1 2 5
"""

MTL = """newmtl shiny
Kd 0.2 0.3 0.4
Ks 0.9 0.9 0.9
Ns 800
newmtl light
Kd 0 0 0
Ke 5 5 4
"""


def test_obj(tmp_path):
    (tmp_path / "m.obj").write_text(OBJ)
    (tmp_path / "m.mtl").write_text(MTL)
    path = str(tmp_path / "m.obj")
    ref, got = jobj.read_obj(path), tobj.read_obj(path)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert (sorted(tobj.read_mtl(str(tmp_path / "m.mtl")))
            == sorted(jobj.read_mtl(str(tmp_path / "m.mtl"))))
    jt, jm, _ = jobj.obj_to_scene(path)
    tt, tm, _ = tobj.obj_to_scene(path, device="cpu")
    for a, b in ((tt.vertices, jt.vertices), (tt.normals, jt.normals),
                 (tt.material_id, jt.material_id), (tm.mtype, jm.mtype),
                 (tm.albedo, jm.albedo), (tm.param, jm.param),
                 (tm.emission, jm.emission)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _mesh_files(tmp_path, n: int) -> list[str]:
    paths = []
    for i in range(n):
        p = tmp_path / f"m{i}.vtk"
        jvtk.write_polydata(p, _strips_polydata(10 + i))
        paths.append(str(p))
    return paths


def test_cache_bake_load_invalidate(tmp_path):
    paths = _mesh_files(tmp_path, 3)
    tdir, jdir = str(tmp_path / "tc"), str(tmp_path / "jc")
    tmeta = tcache.write_mesh_cache(tdir, paths, thread_count=2)
    jmeta = jcache.write_mesh_cache(jdir, paths, thread_count=2)
    assert tmeta == jmeta
    assert tcache.cache_is_valid(tdir, paths)
    got = tcache.load_or_bake(tdir, paths, thread_count=2)
    ref = jcache.load_or_bake(jdir, paths, thread_count=2)
    for a, b in zip(got, ref, strict=True):
        _equal_frames(a, b)
    uncached = tcache.load_or_bake(tdir, paths, use_cache=False)
    for a, b in zip(uncached, got):
        _equal_frames(a, b, exact=False)
    # a changed source file invalidates the cache, and loading re-bakes
    jvtk.write_polydata(paths[1], _strips_polydata(99), binary=False)
    assert not tcache.cache_is_valid(tdir, paths)
    again = tcache.load_or_bake(tdir, paths, thread_count=2)
    assert tcache.cache_is_valid(tdir, paths)
    np.testing.assert_array_equal(again[1].velocities,
                                  _strips_polydata(99).cell_data["vel"]
                                  .astype(np.float32))
    meta = json.loads((tmp_path / "tc" / "metadata.json").read_text())
    meta["version"] = -1
    (tmp_path / "tc" / "metadata.json").write_text(json.dumps(meta))
    assert not tcache.cache_is_valid(tdir, paths)


def test_native_build_location(native):
    """The C++ readers build under build/native/ beside the package and
    leave no shared library in it."""
    assert tbuild.BUILD_DIR == ROOT / "build" / "native"
    assert (tbuild.BUILD_DIR / "libvtkcache.so").exists()
    assert tnative.native_available()
    pkg = ROOT / "optix_ray_tracer_tpu_torch"
    assert not [p for p in pkg.rglob("*.so")]
    assert not any(name.endswith(".so") for name in os.listdir(
        pkg / "native"))
