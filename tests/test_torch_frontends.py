"""The Mesh and Time frontends, the fused frame loop, the temporal
reprojection and the command line of the port against the JAX package,
on series the tests write (chip_smoke.py's writers at a small size).

The frontends' scenes stay under 1024 triangles, so both packages trace
them by brute force on the CPU (``choose_intersector``'s CPU rule); the
device refit and rebuild are held to the JAX package in
tests/test_torch_refit.py, and the port's fused loop is held to its own
per-frame loop through them here.

Tolerance of a frame against the JAX package's: that of
tests/test_torch_wavefront.py, mean |diff| <= 1e-5 and >= 99.9% of the
pixels within 1e-4 (fp rounding order only).  Committed arrays and
Mesh-mode frame vertices: equal; Time-mode frame vertices: 1e-5 (torch
and jnp round the pose's trigonometry their own ways).  The temporal
functions: 1e-6.  The port's fused loop against its per-frame loop with
``temporal`` off: rtol 1e-5, atol 1e-6 (the JAX package's own test of
the same equivalence)."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from optix_ray_tracer_tpu.io import config as jconfig
from optix_ray_tracer_tpu.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu.models import renderer_mesh as jmesh
from optix_ray_tracer_tpu.models import renderer_time as jtime
from optix_ray_tracer_tpu.render import temporal as jtemporal
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu_torch import __main__ as tmain
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.io import config as tconfig
from optix_ray_tracer_tpu_torch.models import fused as tfused
from optix_ray_tracer_tpu_torch.models import renderer_mesh as tmesh
from optix_ray_tracer_tpu_torch.models import renderer_time as ttime
from optix_ray_tracer_tpu_torch.render import temporal as ttemporal
from optix_ray_tracer_tpu_torch.render.film import U8Frame

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
MESH_VTK = (ROOT / "tests" / "test_io.py").read_text().split(
    'MESH_VTK = """')[1].split('"""')[0]
SMALL_LIBRARY = (40, 80, 120)      # sphere shapes of 24, 60, 99 triangles


def _mesh_config(root: Path) -> dict:
    """tests/test_frontends.py's Mesh fixture: 2 files of the 2-particle
    strip VTK, 32x24, 2 frames per file."""
    data = root / "mesh"
    data.mkdir(parents=True, exist_ok=True)
    for i in range(2):
        (data / f"m{i}.vtk").write_text(MESH_VTK)
    cs.write_manifest(data / "test.vtk.series", ["m0.vtk", "m1.vtk"],
                      [0.0, 0.5])
    return {"mesh": True, "series-path": str(data),
            "series-name": "test.vtk.series",
            "cache-path": str(root / "cache"), "stl-path": str(data),
            "particle-material-preset": "viridis",
            "roughs": [{"albedo": [0.7, 0.6, 0.5]}], "metals": [],
            "spheres": [{"center": [0, 0, 0], "radius": 100.0,
                         "mat-type": "ROUGH", "mat-index": 0,
                         "shift": [0, 0, -100.5]}],
            "loop-data": {"window-width": 32, "window-height": 24, "fps": 4,
                          "camera-center": [6, 0, 1],
                          "camera-target": [0.5, 0.5, 0.25],
                          "up-direction": [0, 0, 1]}}


def _time_config(root: Path, n: int, library, scale: float) -> dict:
    """A Time series of n particles of ``library`` (3 shapes), the pile
    of chip_smoke.py shrunk by ``scale``: 3 files, 2 frames per file,
    32x24."""
    poses = cs.pile_poses(n, cs.ANIM_TIMES)
    for p in poses:
        p["pos"] = p["pos"] * scale
        p["vel"] = p["vel"] * scale
    series, stl = cs.write_time_series(
        root / "time", [sphere_with_n_triangles(s) for s in library], poses,
        cs.ANIM_TIMES)
    cfg = json.loads(cs.write_anim_config(
        root / "time.json", series, stl, root / "cache", 32, 24, 8
    ).read_text())
    cfg["loop-data"].update({"camera-center": [6.0, 1.0, 2.0],
                             "camera-target": [0.0, 0.0, -0.5]})
    cfg["meshes"] = [{"obj": str(root / "time.ground.obj"),
                      "mat-type": "ROUGH", "mat-index": 0, "scale":
                      [0.1, 0.1, 0.1]}]
    return cfg


def _lit(cfg: dict, root: Path) -> dict:
    """``cfg`` with a 1 x 1 emissive panel 1.5 above the small pile (an
    EMISSIVE OBJ extra, radiance 10): a scene the ReSTIR integrators can
    light."""
    light = cs.write_light_obj(root / "panel.obj", 1.5, 0.5)
    return {**cfg, "emissives": [{"emission": [10.0, 10.0, 10.0]}],
            "meshes": cfg["meshes"] + [{"obj": str(light),
                                        "mat-type": "EMISSIVE",
                                        "mat-index": 0}]}


def _configs(cfg: dict, base: Path, **extra):
    d = {**cfg, **extra}
    return (jconfig.parse_config_dict(d, base_dir=str(base)),
            tconfig.parse_config_dict(d, base_dir=str(base)))


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    root = tmp_path_factory.mktemp("series")
    return root, {"mesh": _mesh_config(root),
                  "time": _time_config(root, 6, SMALL_LIBRARY, 0.12)}


@pytest.fixture(scope="module")
def committed(series):
    root, cfgs = series
    out = {}
    for mode, (jmod, tmod) in {"mesh": (jmesh, tmesh),
                               "time": (jtime, ttime)}.items():
        jc, tc = _configs(cfgs[mode], root)
        out[mode] = (jmod.commit(jc), tmod.commit(tc, device="cpu"))
    return out


_MESH_ARRAYS = ("vertices", "normals", "tri_particle", "tri_valid",
                "velocities", "particle_mat")
_TIME_ARRAYS = ("positions", "quats", "velocities", "shape_ids",
                "particle_mat", "particle_valid", "tri_lib_idx", "tri_inst",
                "tri_ok")


@pytest.mark.parametrize("mode", ["mesh", "time"])
def test_commit_matches_jax(committed, mode):
    j, t = committed[mode]
    names = _MESH_ARRAYS if mode == "mesh" else _TIME_ARRAYS
    for name in names:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert t.durations == j.durations and t.file_count == j.file_count
    assert t.material_offset == j.material_offset
    for name in ("mtype", "albedo", "param", "emission"):
        np.testing.assert_array_equal(getattr(t.materials, name).numpy(),
                                      np.asarray(getattr(j.materials, name)))
    for name in ("center", "u", "v", "w"):
        np.testing.assert_allclose(getattr(t.camera, name).numpy(),
                                   np.asarray(getattr(j.camera, name)),
                                   atol=1e-6)
    for a, b in ((t.extra_spheres, j.extra_spheres),
                 (t.extra_triangles, j.extra_triangles)):
        for k, v in convert.state_arrays(b).items():
            if v is not None:
                np.testing.assert_allclose(getattr(a, k).numpy(), v,
                                           atol=1e-6)
    if mode == "time":
        assert t.library.num_shapes == j.library.num_shapes == 3
        for k in ("vertices", "normals"):
            np.testing.assert_array_equal(getattr(t.library, k).numpy(),
                                          np.asarray(getattr(j.library, k)))


@pytest.mark.parametrize("mode", ["mesh", "time"])
@pytest.mark.parametrize("fi,k", [(0, 0), (0, 1), (1, 1)])
def test_frame_scene_matches_jax(committed, mode, fi, k):
    j, t = committed[mode]
    jmod, tmod = (jmesh, tmesh) if mode == "mesh" else (jtime, ttime)
    js = jmod.frame_scene(j, fi, k, 2)
    ts = tmod.frame_scene(t, fi, k, 2)
    atol = 0.0 if mode == "mesh" else 1e-5
    for name in ("vertices", "normals"):
        np.testing.assert_allclose(
            getattr(ts.triangles, name).numpy(),
            np.asarray(getattr(js.triangles, name)), atol=atol, rtol=0)
    np.testing.assert_array_equal(ts.triangles.material_id.numpy(),
                                  np.asarray(js.triangles.material_id))
    assert ts.sphere_count == js.sphere_count


def _close_to_jax(got, ref):
    diff = np.abs(got - ref)
    assert np.isfinite(got).all()
    assert diff.mean() <= 1e-5, diff.mean()
    within = (diff.max(-1) <= 1e-4).mean()
    assert within >= 0.999, within


def _films(mod, data, n, **kw):
    return [(fi, k, np.asarray(film.mean()), np.asarray(film.albedo_accum))
            for fi, k, film in mod.render_frames(data, max_frames=n, **kw)]


@pytest.mark.parametrize("route", ["fused", "per-frame"])
@pytest.mark.parametrize("mode", ["mesh", "time"])
def test_render_frames_matches_jax(committed, mode, route):
    """Three frames across a file boundary: the fused loop with the
    temporal blend and its guides fetched, or the per-frame loop (a no-op
    update hook), against the JAX package's same route."""
    j, t = committed[mode]
    jmod, tmod = (jmesh, tmesh) if mode == "mesh" else (jtime, ttime)
    kw = {"fetch_guides": True} if route == "fused" else {}
    try:
        if route == "per-frame":
            jmod.set_update_fn(j, lambda s, k: None)
            tmod.set_update_fn(t, lambda s, k: None)
        ref = _films(jmod, j, 3, **kw)
        got = _films(tmod, t, 3, **kw)
    finally:
        j.update_fn = t.update_fn = None
    assert [r[:2] for r in got] == [r[:2] for r in ref] == [
        (0, 0), (0, 1), (1, 0)]
    for g, r in zip(got, ref):
        _close_to_jax(g[2], r[2])
        _close_to_jax(g[3], r[3])


def test_tlas_route_matches_jax(committed, monkeypatch):
    """ORT_TIME_TLAS=1 sends both packages' Time loop through the TLAS
    engine (``_render_frames_tlas``)."""
    j, t = committed["time"]
    monkeypatch.setenv("ORT_TIME_TLAS", "1")
    assert ttime._tlas_route(t) and jtime._tlas_route(j)
    ref = _films(jtime, j, 2)
    got = _films(ttime, t, 2)
    for g, r in zip(got, ref, strict=True):
        _close_to_jax(g[2], r[2])


@pytest.mark.parametrize("env,expect", [
    ({}, False), ({"ORT_TIME_TLAS": "0"}, False),
    ({"ORT_TLAS_HBM_MB": "0.1"}, True), ({"ORT_TIME_TLAS": "1"}, True)])
def test_tlas_route_policy(committed, monkeypatch, env, expect):
    j, t = committed["time"]
    for k in ("ORT_TIME_TLAS", "ORT_TLAS_HBM_MB"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert ttime._tlas_route(t) == jtime._tlas_route(j) == expect


@pytest.mark.parametrize("mode", ["mesh", "time"])
def test_quantized_frames(committed, mode):
    """quantize=True: sRGB uint8 RGBA quantized on the device."""
    _, t = committed[mode]
    tmod = tmesh if mode == "mesh" else ttime
    frames = list(tmod.render_frames(t, max_frames=2, quantize=True))
    assert all(isinstance(f, U8Frame) for _, _, f in frames)
    img = frames[0][2].to_uint8()
    assert img.shape == (24, 32, 4) and img.dtype == np.uint8
    assert (img[..., :3] == cs.SKY).all(-1).any()
    with pytest.raises(ValueError, match="guide"):
        list(tmod.render_frames(t, max_frames=1, quantize=True,
                                fetch_guides=True))


def test_fused_matches_per_frame_with_refit(tmp_path):
    """A Time series over 1024 triangles takes the marcher on the CPU: a
    host build on file 0, a device rebuild per file, a refit per frame.
    With ``temporal`` off the port's fused loop (refit from the file's
    rebuild, chunks of the file's frames) equals its per-frame loop
    (refit from the previous frame), across a file boundary."""
    cfg = _time_config(tmp_path, 8, cs.TIME_LIBRARY, 0.15)
    _, tc = _configs(cfg, tmp_path, temporal=False)
    data = ttime.commit(tc, device="cpu")
    scene = ttime.frame_scene(data, 0, 0, 2)
    assert scene.triangle_count >= 1024
    n = 4
    fused_frames = _films(ttime, data, n)
    ttime.set_update_fn(data, lambda s, k: None)
    plain = _films(ttime, data, n)
    assert [f[:2] for f in fused_frames] == [f[:2] for f in plain]
    for a, b in zip(fused_frames, plain):
        np.testing.assert_allclose(a[2], b[2], rtol=1e-5, atol=1e-6)


def test_chunk_size_matches_jax():
    from optix_ray_tracer_tpu.models import fused as jfused
    for args in ((1200, 800, 4, 4), (1200, 800, 18, 36), (64, 48, 7, 12),
                 (4096, 4096, 12, 36), (32, 24, 16, 4)):
        assert tfused.chunk_size(*args) == jfused.chunk_size(*args)


def test_temporal_functions_match_jax():
    rng = np.random.default_rng(5)
    H, W = 12, 16
    jcam = JCamera.look_at((4.0, 1.0, 1.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    tcam = convert.camera(convert.state_arrays(jcam), device="cpu")
    x = rng.normal(size=(H, W, 3)).astype(np.float32) * 2.0
    jp = jtemporal.project_to_pixels(jcam, jnp.asarray(x), W, H)
    tp = ttemporal.project_to_pixels(tcam, torch.as_tensor(x), W, H)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    js = jtemporal.empty_state(W, H)
    ts = ttemporal.empty_state(W, H, "cpu")
    state = {k: rng.uniform(0.0, 2.0, np.asarray(v).shape).astype(np.float32)
             for k, v in js.items()}
    state["hist"] = np.round(state["hist"] * 10.0)
    state["normal"] /= np.linalg.norm(state["normal"], axis=-1,
                                      keepdims=True)
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    iy = rng.integers(-2, H + 2, (H, W)).astype(np.int32)
    ix = rng.integers(-2, W + 2, (H, W)).astype(np.int32)
    np.testing.assert_array_equal(
        ttemporal._gather(torch.as_tensor(state["irr"]), torch.as_tensor(iy),
                          torch.as_tensor(ix)).numpy(),
        np.asarray(jtemporal._gather(jnp.asarray(state["irr"]),
                                     jnp.asarray(iy), jnp.asarray(ix))))
    t = state["t"].copy()
    t[0] = 1e16                      # sky rows
    irr = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    normal = state["normal"] + rng.normal(0.0, 0.1, (H, W, 3)).astype(
        np.float32)
    px = (np.arange(W)[None, :] + rng.normal(0.0, 0.7, (H, W))).astype(
        np.float32)
    py = (np.arange(H)[:, None] + rng.normal(0.0, 0.7, (H, W))).astype(
        np.float32)
    prev_t = state["t"] * rng.uniform(0.97, 1.03, (H, W)).astype(np.float32)
    front = rng.uniform(size=(H, W)) > 0.1
    args = (irr, t, normal, px, py, prev_t, front)
    jb, jst = jtemporal.temporal_blend(
        {k: jnp.asarray(v) for k, v in state.items()},
        *(jnp.asarray(a) for a in args))
    tb, tst = ttemporal.temporal_blend(
        {k: torch.as_tensor(v) for k, v in state.items()},
        *(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
    for k in jst:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-6)
    assert (tst["hist"].numpy() > 1).any()      # some history was kept


def _write_cfg(root: Path, cfg: dict, name: str, **extra) -> Path:
    p = root / name
    p.write_text(json.dumps({**cfg, **extra}))
    return p


@pytest.mark.parametrize("mode", ["mesh", "time"])
def test_cli_writes_pngs(series, tmp_path, mode):
    """``main(["--cpu", ...])``: one PNG per frame, the sky the background;
    --aov adds the guide images; "cache": true in Mesh mode bakes and
    exits."""
    root, cfgs = series
    cfg = _write_cfg(tmp_path, cfgs[mode], "c.json")
    assert tmain.main(["--cpu", "--config", str(cfg), "--output",
                       str(tmp_path / "out"), "--frames", "3"]) == 0
    pngs = sorted((tmp_path / "out").glob("frame_*.png"))
    assert len(pngs) == 3
    img = cs.read_png(pngs[0])
    assert img.shape == (24, 32, 4)
    assert (img[..., :3] == cs.SKY).all(-1).any()
    assert tmain.main(["--cpu", "--config", str(cfg), "--output",
                       str(tmp_path / "aov"), "--frames", "1", "--aov",
                       "--no-denoise", "--spp", "2", "--width", "16",
                       "--height", "8"]) == 0
    names = sorted(p.name for p in (tmp_path / "aov").iterdir())
    assert names == ["frame_000000.png", "frame_000000_albedo.png",
                     "frame_000000_normal.png"]
    assert cs.read_png(tmp_path / "aov" / names[0]).shape == (8, 16, 4)
    if mode == "mesh":
        bake = _write_cfg(tmp_path, cfgs[mode], "bake.json", cache=True,
                          **{"cache-path": str(tmp_path / "baked")})
        assert tmain.main(["--cpu", "--config", str(bake)]) == 0
        meta = json.loads((tmp_path / "baked" / "metadata.json").read_text())
        assert meta["file_count"] == 2 and meta["max_cell_count"] == 2


def test_python_m_entry_point(series, tmp_path):
    """``python -m optix_ray_tracer_tpu_torch --cpu --config ...`` in a
    process of its own writes the PNGs."""
    root, cfgs = series
    cfg = _write_cfg(tmp_path, cfgs["mesh"], "c.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "optix_ray_tracer_tpu_torch", "--cpu",
         "--config", str(cfg), "--frames", "2", "--output",
         str(tmp_path / "out")], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "render finished: 2 frames" in proc.stderr
    assert len(list((tmp_path / "out").glob("frame_*.png"))) == 2


@pytest.mark.parametrize("flag", [["--shard"]])
def test_cli_refuses_unported_flags(series, tmp_path, flag, caplog):
    """Every flag of the JAX package's CLI is ported: ``--shard`` renders
    (the sharded loop over one CPU shard with ``--cpu``) where it used to
    exit with code 2, and nothing says "not ported"."""
    root, cfgs = series
    cfg = _write_cfg(tmp_path, cfgs["time"], "c.json")
    assert tmain.main(["--cpu", "--config", str(cfg), "--frames", "1",
                       "--output", str(tmp_path / "out"), *flag]) == 0
    assert "not ported" not in caplog.text
    assert "sharding frames over 1 device(s)" in caplog.text
    assert len(list((tmp_path / "out").glob("frame_*.png"))) == 1
    assert not hasattr(tmain, "_NOT_PORTED")


def test_cli_config_error(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"integrator": "bidir"}))
    assert tmain.main(["--cpu", "--config", str(bad)]) == 2


def test_card_is_the_default(series, tmp_path, monkeypatch):
    """Without CUDA and without --cpu / device="cpu", the CLI and both
    frontends raise, naming the CPU option."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, cfgs = series
    cfg = _write_cfg(tmp_path, cfgs["time"], "c.json")
    with pytest.raises(RuntimeError, match="--cpu"):
        tmain.main(["--config", str(cfg), "--output", str(tmp_path / "o")])
    for mode, mod in (("mesh", tmesh), ("time", ttime)):
        _, tc = _configs(cfgs[mode], root)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mod.commit(tc)


def test_unported_config_features(series):
    """The ReSTIR integrators and the Sobol sampler render through both
    frontends and match the JAX package's frames (the per-frame loop;
    ReSTIR with the Time scene's area light, the Mesh scene, which has
    none, raising the JAX package's ValueError); environment maps,
    textures and the path integrator render too."""
    root, cfgs = series
    lit = _lit(cfgs["time"], root)
    for extra in ({"integrator": "restir"}, {"integrator": "restir-gi"},
                  {"sampler": "sobol"},
                  {"integrator": "path", "sampler": "sobol"}):
        jc, tc = _configs(lit, root, **extra, temporal=False)
        ref = _films(jtime, jtime.commit(jc), 2)
        got = _films(ttime, ttime.commit(tc, device="cpu"), 2)
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            _close_to_jax(g[2], r[2])
    _, tc = _configs(cfgs["mesh"], root, integrator="restir")
    data = tmesh.commit(tc, device="cpu")
    with pytest.raises(ValueError, match="emissive"):
        list(tmesh.render_frames(data, max_frames=1))
    _, tc = _configs(cfgs["time"], root, integrator="path",
                     envmap={"type": "constant"},
                     textures=[{"checker": True}])
    data = ttime.commit(tc, device="cpu")
    assert data.env is not None and data.textures is not None
    frames = list(ttime.render_frames(data, max_frames=1))
    assert np.isfinite(np.asarray(frames[0][2].mean())).all()


def _png_and_ckpt(out: Path):
    with np.load(out / "ckpt.npz") as z:
        arrays = {k: z[k] for k in z.files}
    return (out / "progressive.png").read_bytes(), arrays


@pytest.mark.parametrize("integrator", ["whitted", "path", "restir"])
def test_cli_progressive_resume(series, tmp_path, integrator):
    """--progressive 18 straight (batches of 16 and 2) against 16, then
    resumed from its checkpoint to 18: the same PNG and checkpoint bit
    for bit (one global sample counter; ReSTIR's second batch folds
    sample_offset 16 into its seed, wrapped to int32)."""
    root, cfgs = series
    cfg = _write_cfg(tmp_path, _lit(cfgs["time"], root), "c.json",
                     integrator=integrator)
    common = ["--cpu", "--config", str(cfg), "--width", "16", "--height",
              "12"]
    outs = {}
    for name, steps in (("straight", [18]), ("resumed", [16, 18])):
        out = tmp_path / name
        for spp in steps:
            assert tmain.main([*common, "--output", str(out),
                               "--progressive", str(spp), "--checkpoint",
                               str(out / "ckpt.npz")]) == 0
        outs[name] = _png_and_ckpt(out)
    (pa, ca), (pb, cb) = outs["straight"], outs["resumed"]
    assert pa == pb
    assert ca.keys() == cb.keys() == {"accum", "albedo", "normal", "spp"}
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    assert int(ca["spp"]) == 18
    assert np.isfinite(ca["accum"]).all() and ca["accum"].mean() > 0


def test_cli_adaptive_resume(series, tmp_path, caplog):
    """--progressive 6 --adaptive straight against 3 then resumed to 6
    (the warm-up and every batch alike): bit-equal; a uniform checkpoint
    cannot be resumed adaptively (exit 2)."""
    root, cfgs = series
    cfg = _write_cfg(tmp_path, _lit(cfgs["time"], root), "c.json",
                     integrator="path", sampler="sobol")
    common = ["--cpu", "--config", str(cfg), "--width", "16", "--height",
              "12", "--adaptive"]
    outs = {}
    for name, steps in (("straight", [6]), ("resumed", [3, 6])):
        out = tmp_path / name
        for spp in steps:
            assert tmain.main([*common, "--output", str(out),
                               "--progressive", str(spp), "--checkpoint",
                               str(out / "ckpt.npz")]) == 0
        outs[name] = _png_and_ckpt(out)
    (pa, ca), (pb, cb) = outs["straight"], outs["resumed"]
    assert pa == pb
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    assert int(ca["count"].sum()) == 6 * 16 * 12
    assert ca["count"].min() >= 4 and ca["count"].max() > 6   # adaptive
    meta = json.loads((tmp_path / "straight" / "ckpt.npz.json").read_text())
    assert meta["adaptive"] is True
    # a uniform film's checkpoint
    uni = tmp_path / "uniform"
    assert tmain.main([*common[:-1], "--output", str(uni), "--progressive",
                       "2", "--checkpoint", str(uni / "ckpt.npz")]) == 0
    assert tmain.main([*common, "--output", str(uni), "--progressive", "4",
                       "--checkpoint", str(uni / "ckpt.npz")]) == 2
    assert "uniform-progressive film" in caplog.text


def test_cli_adaptive_refuses_restir(series, tmp_path):
    root, cfgs = series
    cfg = _write_cfg(tmp_path, _lit(cfgs["time"], root), "c.json",
                     integrator="restir")
    with pytest.raises(SystemExit, match="--adaptive supports integrator"):
        tmain.main(["--cpu", "--config", str(cfg), "--output",
                    str(tmp_path / "o"), "--progressive", "4", "--adaptive"])


@pytest.mark.parametrize("integrator", ["whitted", "restir"])
def test_cli_viewer_subprocess(series, tmp_path, integrator):
    """``python -m optix_ray_tracer_tpu_torch --cpu --viewer --port 0`` in a
    process of its own: it serves the page and a stream of frames, takes
    /key and /look, and exits 0 after /quit, within 60 s.  Whitted takes
    the fused chunk path, ReSTIR the per-frame path with persistent
    reservoirs."""
    import re
    import threading
    import urllib.request

    root, cfgs = series
    cfg = _write_cfg(tmp_path, _lit(cfgs["time"], root), "c.json",
                     integrator=integrator)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "optix_ray_tracer_tpu_torch", "--cpu",
         "--config", str(cfg), "--viewer", "--port", "0", "--width", "16",
         "--height", "12"], cwd=ROOT, env=env, stderr=subprocess.PIPE,
        text=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stderr),
                              daemon=True)
    reader.start()

    def get(path):
        with urllib.request.urlopen(base + path, timeout=5.0) as r:
            return r.read()

    base = None
    try:
        t0 = time.time()
        while base is None and time.time() - t0 < 50:
            m = re.search(r"viewer at (http://[\d.]+:\d+)/", "".join(lines))
            base = m.group(1) if m else None
            time.sleep(0.05)
        assert base, "".join(lines)
        assert b"/stream" in get("/")
        buf = b""
        while buf.count(b"--frame") < 2 and time.time() - t0 < 50:
            # each request times out after 5 s: reconnect until the first
            # frames are out (the first chunk renders after the commit)
            try:
                with urllib.request.urlopen(base + "/stream",
                                            timeout=5.0) as r:
                    while buf.count(b"--frame") < 2:
                        buf += r.read1(4096)
                        if buf.count(b"--frame") == 1:
                            get("/key?k=w")
                            get("/look?dx=4&dy=1")
            except TimeoutError:
                pass
        assert b"Content-Type: image/" in buf
    finally:
        if base:
            try:
                get("/quit")
            except OSError:
                pass
        try:
            rc = proc.wait(timeout=60)
        finally:
            proc.kill()
        reader.join(timeout=5)
    assert rc == 0, "".join(lines)
    assert "viewer stopped after" in "".join(lines)
