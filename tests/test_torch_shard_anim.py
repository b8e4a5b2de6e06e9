"""The sharded animation paths of the port: ``fused_chunk(mesh=...)``,
``parallel/animation.render_frames_sharded`` and the CLI's ``--shard``,
on meshes of repeated ``cpu`` devices, held to the port's unsharded
loops; the marcher under a mesh; and the JAX package's handling of a
ReSTIR config under ``--shard``, which the port keeps.

Tolerance: atol 1e-6 for images (the RNG keys off global pixel and
sample ids; the bands trace the same rays), PNGs equal."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from optix_ray_tracer_tpu.io import config as jconfig
from optix_ray_tracer_tpu.models import renderer_time as jtime
from optix_ray_tracer_tpu.parallel import animation as janim
from optix_ray_tracer_tpu.parallel import sharding as jsh
from optix_ray_tracer_tpu_torch import __main__ as tmain
from optix_ray_tracer_tpu_torch.io import config as tconfig
from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.models import fused
from optix_ray_tracer_tpu_torch.models import renderer_time as ttime
from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
from optix_ray_tracer_tpu_torch.parallel import animation as tanim
from optix_ray_tracer_tpu_torch.parallel import sharding as tsh
from optix_ray_tracer_tpu_torch.render import temporal as tmod
from optix_ray_tracer_tpu_torch.render import wavefront
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder
from test_torch_frontends import SMALL_LIBRARY, _lit, _time_config

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _tmesh(tile, sample=1):
    return tsh.make_mesh(tile, sample, [CPU] * 8)


def _chunk_inputs():
    """graft.dryrun_multichip's Mesh-mode chunk: 8 moving triangles over a
    ground sphere and a metal sphere, 16x24."""
    mb = MaterialBuilder()
    ground = mb.add_rough((0.70, 0.60, 0.50))
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.1)
    mb.add_rough((0.65, 0.05, 0.05))
    t8 = np.zeros((8, 3, 3), np.float32)
    t8[:, 1, 0] = 0.4
    t8[:, 2, 1] = 0.4
    t8 += np.linspace(-1.0, 1.0, 8, dtype=np.float32)[:, None, None]
    fd = dict(
        vertices=torch.as_tensor(t8),
        normals=torch.as_tensor(np.tile(np.float32([0, 0, 1]), (8, 3, 1))),
        tri_particle=torch.zeros(8, dtype=torch.int32),
        tri_valid=torch.ones(8, dtype=torch.bool),
        velocities=torch.tensor([[0.1, 0.0, 0.0]]),
        particle_mat=torch.full((1,), 2, dtype=torch.int32),
        duration=np.float32(1.0), inv_frame_count=np.float32(0.5),
        particle_shift=np.zeros(3, np.float32),
        particle_scale=np.float32(1.0))
    spheres = Spheres.from_list([((0.0, 0.0, -100.5), 100.0, ground),
                                 ((0.0, 1.2, 0.3), 0.5, metal)], CPU)
    cam = Camera.look_at((4.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=CPU)
    return fd, mb.build(CPU), cam, spheres


@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("tile,sample", [(4, 2), (8, 1), (1, 2)])
def test_fused_chunk_mesh_matches(temporal, tile, sample):
    """Two frames of ``fused_chunk`` over a mesh against the same chunk
    without one: images, guides and the temporal state."""
    fd, mats, cam, spheres = _chunk_inputs()
    W, H = 16, 24
    outs = []
    for mesh in (None, _tmesh(tile, sample)):
        out = fused.fused_chunk(
            fd, [0, 1], [3, 4], None, mats, cam, spheres,
            Triangles.empty(CPU), None, None, None, (0.7, 0.8, 0.9),
            tmod.empty_state(W, H, CPU) if temporal else None, mode="mesh",
            width=W, height=H, spp=2, integrator="whitted", do_denoise=True,
            max_depth=3, use_march=False, has_extras=False,
            want_guides=True, temporal=temporal, mesh=mesh)
        outs.append(out)
    if temporal:
        (ref, ref_state), (got, got_state) = outs
        for k in ref_state:
            np.testing.assert_allclose(got_state[k].float().numpy(),
                                       ref_state[k].float().numpy(),
                                       atol=1e-6, err_msg=k)
    else:
        ref, got = outs
    assert got[0].shape == (2, H, W, 3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6)


def test_fused_chunk_mesh_height_must_divide():
    fd, mats, cam, spheres = _chunk_inputs()
    with pytest.raises(ValueError, match="not divisible by tile=5"):
        fused.fused_chunk(
            fd, [0], [0], None, mats, cam, spheres, Triangles.empty(CPU),
            None, None, None, (0.7, 0.8, 0.9), mode="mesh", width=16,
            height=24, spp=1, integrator="whitted", do_denoise=False,
            max_depth=2, use_march=False, has_extras=False,
            mesh=_tmesh(5))


@pytest.mark.parametrize("tile,sample", [(3, 1), (8, 1), (4, 2)])
def test_march_sharded_matches_single_device(tile, sample):
    """The raster-enabled marcher under a mesh: 8-row bands (tile 3) tile
    cleanly and take the raster engine as the full frame does; 3-row
    bands (tile 8) fall back to the marcher.  Both give the same hits on
    this scene, so the images agree to atol 1e-6."""
    mb = MaterialBuilder()
    ground = mb.add_rough((0.70, 0.60, 0.50))
    body = mb.add_rough((0.65, 0.05, 0.05))
    v, n = sphere_with_n_triangles(2048, center=(0, 0, 0), radius=0.5)
    scene = Scene(Spheres.from_list([((0, 0, -100.5), 100.0, ground)], CPU),
                  Triangles.from_arrays(v, n, body, device=CPU))
    cam = Camera.look_at((4.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=CPU)
    inter = make_march_intersector(scene, raster=True)
    mats = mb.build(CPU)
    ref = wavefront.render(scene, mats, cam, 32, 24, spp=8, seed=11,
                           intersector=inter)[0]
    img = tsh.render_sharded(scene, mats, cam, 32, 24, 8,
                             _tmesh(tile, sample), seed=11,
                             intersector=inter)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_series")
    return root, _time_config(root, 6, SMALL_LIBRARY, 0.12)


def _configs(cfg: dict, base: Path, **extra):
    d = {**cfg, **extra}
    return (jconfig.parse_config_dict(d, base_dir=str(base)),
            tconfig.parse_config_dict(d, base_dir=str(base)))


def _means(frames):
    return [np.asarray(f.mean()) for _, _, f in frames]


@pytest.mark.parametrize("route", ["fused", "per_frame"])
def test_render_frames_sharded_matches(series, route):
    """Three frames through ``render_frames_sharded`` on a 4x2 mesh, by
    the fused route (temporal on) and by the per-frame fallback (forced by
    an ``update_fn``), against the unsharded loops; a height of 22 renders
    padded to 24 rows and crops."""
    root, cfg = series
    _, tc = _configs(cfg, root, temporal=route == "fused")
    data = ttime.commit(tc, device="cpu")
    if route == "per_frame":
        ttime.set_update_fn(data, lambda s, k: None)
    ref = list(ttime.render_frames(data, height=24, spp=2, max_frames=3))
    got = list(tanim.render_frames_sharded(data, "time", 32, 24, 2,
                                           _tmesh(4, 2), max_frames=3))
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in ref]
    for g, r in zip(_means(got), _means(ref)):
        np.testing.assert_allclose(g, r, atol=1e-6)
    for g in _means(tanim.render_frames_sharded(
            data, "time", 32, 22, 2, _tmesh(4, 2), max_frames=1)):
        assert g.shape == (22, 32, 3) and np.isfinite(g).all()


def test_cli_shard_matches_unsharded(series, tmp_path, caplog):
    """``--shard --cpu`` exits 0 and writes the PNGs of the run without
    it; ``--aov`` is ignored with a warning."""
    root, cfg = series
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    base = ["--cpu", "--config", str(path), "--frames", "3", "--output"]
    assert tmain.main(base + [str(tmp_path / "plain")]) == 0
    assert tmain.main(base + [str(tmp_path / "shard"), "--shard",
                              "--aov"]) == 0
    assert "--aov is not supported with --shard" in caplog.text
    pngs = sorted((tmp_path / "shard").iterdir())
    assert [p.name for p in pngs] == [f"frame_{i:06d}.png" for i in range(3)]
    for p in pngs:
        np.testing.assert_array_equal(cs.read_png(p),
                                      cs.read_png(tmp_path / "plain" /
                                                  p.name))


@pytest.mark.parametrize("integrator", ["restir", "restir-gi"])
def test_restir_under_shard_as_in_jax(series, integrator, caplog):
    """A fault of the reference, kept by the port: the sharded loop's rule
    ignores the integrator.  The fused route refuses a ReSTIR config
    (ValueError), and the per-frame fallback (here forced by an
    ``update_fn``; debug mode does the same from the CLI) renders Whitted
    frames: equal to the same series with ``"integrator": "whitted"``.
    The port logs a warning where the JAX package says nothing."""
    root, cfg = series
    lit = _lit(cfg, root)
    jc, tc = _configs(lit, root, integrator=integrator, temporal=False)
    jw, tw = _configs(lit, root, integrator="whitted", temporal=False)
    jdata, tdata = jtime.commit(jc), ttime.commit(tc, device="cpu")
    with pytest.raises(ValueError, match="whitted"):
        list(janim.render_frames_sharded(jdata, "time", 32, 24, 1,
                                         jsh.make_mesh(4), max_frames=1))
    with pytest.raises(ValueError, match="whitted"):
        list(tanim.render_frames_sharded(tdata, "time", 32, 24, 1,
                                         _tmesh(4), max_frames=1))
    for data, wcfg, mod, anim, mesh in (
            (jdata, jw, jtime, janim, jsh.make_mesh(4)),
            (tdata, tw, ttime, tanim, _tmesh(4))):
        mod.set_update_fn(data, lambda s, k: None)
        got = _means(anim.render_frames_sharded(data, "time", 32, 24, 1,
                                                mesh, max_frames=2))
        wdata = (mod.commit(wcfg) if mod is jtime
                 else mod.commit(wcfg, device="cpu"))
        mod.set_update_fn(wdata, lambda s, k: None)
        want = _means(anim.render_frames_sharded(wdata, "time", 32, 24, 1,
                                                 mesh, max_frames=2))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert f"renders integrator '{integrator}' as whitted" in caplog.text


def test_fused_chunk_mesh_keeps_the_sampler():
    """A second fault of the reference, which the port does not keep: the
    JAX package's sharded chunk draws its camera jitter from PCG whatever
    the sampler (``render_band`` calls ``_tile_rays`` without it), so
    with ``sampler="sobol"`` its sharded frames differ from its unsharded
    ones; the port's equal them (atol 1e-6)."""
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_scene
    from optix_ray_tracer_tpu.models.fused import fused_chunk as jchunk
    from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles

    fd, mats, cam, spheres = _chunk_inputs()
    js, jm, jc = _flagship_scene(n_tris=64)
    jfd = {k: jnp.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in fd.items()}
    jfd["particle_mat"] = jnp.zeros(1, jnp.int32)
    kw = dict(mode="mesh", width=16, height=16, spp=2, integrator="whitted",
              do_denoise=False, sampler="sobol", max_depth=3,
              use_march=False, has_extras=False, want_guides=False,
              temporal=False)
    jout = [np.asarray(jchunk(
        jfd, jnp.arange(2, dtype=jnp.float32), jnp.arange(2, dtype=jnp.int32),
        None, jm, jc, js.spheres, JTriangles.empty(), None, None, None,
        jnp.asarray([0.7, 0.8, 0.9], jnp.float32), None, mesh=mesh, **kw)[0])
        for mesh in (None, jsh.make_mesh(tile=4))]
    assert np.abs(jout[0] - jout[1]).max() > 0.1
    tout = [fused.fused_chunk(
        fd, [0, 1], [0, 1], None, mats, cam, spheres, Triangles.empty(CPU),
        None, None, None, (0.7, 0.8, 0.9), mesh=mesh, **kw)[0]
        for mesh in (None, _tmesh(4))]
    np.testing.assert_allclose(tout[1].numpy(), tout[0].numpy(), atol=1e-6)
