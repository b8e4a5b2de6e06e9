"""The port's parallel layer (parallel/sharding.py) on meshes of repeated
``cpu`` devices, against the port's single-device renders and against the
JAX package's sharded renders on its 8 virtual CPU devices, with the
scene and sizes of tests/test_sharding.py.

Tolerances:
- the port's sharded renders against its single-device ones, every image
  and reservoir state: atol 1e-6 (the contract of tests/test_sharding.py:
  the RNG keys off global pixel and sample ids, so a mesh changes only
  the rounding order of the partial sums);
- Whitted against the JAX package's sharded render: atol 1e-6;
- the path tracer against the JAX package's sharded render: the
  cross-package image rule of tests/test_torch_pathtracer.py (mean |diff|
  <= 1e-5, >= 99% of pixels within 1e-4), since the two path tracers
  differ by float ulps before any sharding (atan2 and acos texel lookups
  of the environment, XLA's fused multiply-adds)."""

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.parallel import sharding as jsh
from optix_ray_tracer_tpu.render.envmap import gradient_sky as jsky
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu.scene.lights import collect_area_lights as jlights
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.parallel import sharding as tsh
from optix_ray_tracer_tpu_torch.render import pathtracer, restir, wavefront

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H, SPP, SEED = 32, 24, 8, 7
MESHES = [(1, 1), (8, 1), (1, 8), (4, 2), (2, 4)]


def _tmesh(tile, sample=1):
    return tsh.make_mesh(tile, sample, [CPU] * 8)


def _port(*objs):
    out = []
    for o, kind in objs:
        out.append(None if o is None else
                   getattr(convert, kind)(convert.state_arrays(o), CPU))
    return out


@pytest.fixture(scope="module")
def spheres():
    """tests/test_sharding.py's scene, in both packages."""
    mb = MaterialBuilder()
    ground = mb.add_rough((0.70, 0.60, 0.50))
    red = mb.add_rough((0.65, 0.05, 0.05))
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.1)
    jm = mb.build()
    js = JScene(spheres=JSpheres.from_list([
        ((0.0, 0.0, -100.5), 100.0, ground), ((0.0, 0.0, 0.0), 0.5, red),
        ((0.0, 1.2, 0.3), 0.5, metal)]), triangles=JTriangles.empty())
    jc = JCamera.look_at((5.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    ts, tm, tc = _port((js, "scene"), (jm, "materials"), (jc, "camera"))
    ref = wavefront.render(ts, tm, tc, W, H, spp=SPP, seed=SEED)
    return (js, jm, jc), (ts, tm, tc), ref


@pytest.mark.parametrize("tile,sample", MESHES)
def test_whitted_matches_single_device_and_jax(spheres, tile, sample):
    (js, jm, jc), (ts, tm, tc), ref = spheres
    img, alb, nrm = tsh.render_sharded(ts, tm, tc, W, H, SPP,
                                       _tmesh(tile, sample), seed=SEED,
                                       want_guides=True)
    assert img.shape == (H, W, 3)
    for got, want in zip((img, alb, nrm), ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    jimg = jsh.render_sharded(js, jm, jc, W, H, SPP,
                              jsh.make_mesh(tile, sample), seed=SEED)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-6,
                               err_msg=f"mesh ({tile},{sample})")


@pytest.mark.parametrize("sampler", ["pcg", "sobol"])
def test_thin_lens_and_sampler_match_single_device(spheres, sampler):
    """A thin-lens camera (the lens stream of ``_tile_rays``) and both
    samplers on a 4x2 mesh."""
    _, (ts, tm, tc), _ = spheres
    from optix_ray_tracer_tpu_torch.scene.camera import Camera

    lens = Camera.look_at((5.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                          aperture=0.2, focus_dist=5.0, device=CPU)
    for cam in (tc, lens):
        ref = wavefront.render(ts, tm, cam, W, H, spp=SPP, seed=SEED,
                               sampler=sampler)[0]
        img = tsh.render_sharded(ts, tm, cam, W, H, SPP, _tmesh(4, 2),
                                 seed=SEED, sampler=sampler)
        np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-6)


def test_invalid_divisibility(spheres):
    _, (ts, tm, tc), _ = spheres
    with pytest.raises(ValueError, match="height 30"):
        tsh.render_sharded(ts, tm, tc, W, 30, SPP, _tmesh(8))
    with pytest.raises(ValueError, match="spp 3"):
        tsh.render_sharded(ts, tm, tc, W, H, 3, _tmesh(4, 2))
    with pytest.raises(ValueError, match="need 16 devices"):
        tsh.make_mesh(4, 4, [CPU] * 8)


def test_mesh_form(monkeypatch):
    """A (tile, sample) grid with JAX's ``shape`` keys, repeated devices
    allowed, one copy per distinct device; without CUDA the default
    raises, naming the CPU form."""
    mesh = _tmesh(4, 2)
    assert mesh.shape == {"tile": 4, "sample": 2}
    assert mesh.first == CPU and mesh.distinct() == [CPU]
    reps = tsh.broadcast_scene((torch.ones(3), None, "x"), mesh)
    assert list(reps) == [CPU] and reps[CPU][1:] == (None, "x")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r'torch.device\("cpu"\)'):
        tsh.make_mesh(1)


@pytest.mark.parametrize("tile,sample", [(1, 1), (4, 2), (1, 4)])
def test_path_env_nee_matches_single_device_and_jax(tile, sample):
    """tests/test_sharding.py's environment-NEE case: the env sampling
    tables and the env occlusion wave over the mesh."""
    mb = MaterialBuilder()
    g = mb.add_rough((0.7, 0.7, 0.7))
    js = JScene(spheres=JSpheres.from_list([((0, 0, -100.5), 100.0, g)]),
                triangles=JTriangles.empty())
    jc = JCamera.look_at((3.5, 0, 0.6), (0, 0, 0), (0, 0, 1))
    jenv = jsky(sun_dir=(0.4, 0.25, 0.88), sun_cos=0.9995)
    jm = mb.build()
    ts, tm, tc, tenv = _port((js, "scene"), (jm, "materials"),
                             (jc, "camera"), (jenv, "envmap"))
    ref = pathtracer.render_path(ts, tm, None, tc, 16, 16, spp=4, seed=5,
                                 env=tenv, max_depth=3)[0]
    img = tsh.render_path_sharded(ts, tm, None, tc, 16, 16, 4,
                                  _tmesh(tile, sample), seed=5, env=tenv,
                                  max_depth=3)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-6)
    jimg = jsh.render_path_sharded(js, jm, None, jc, 16, 16, 4,
                                   jsh.make_mesh(tile, sample), seed=5,
                                   env=jenv, max_depth=3)
    diff = np.abs(img.numpy() - np.asarray(jimg)).max(-1)
    assert diff.mean() <= 1e-5 and (diff <= 1e-4).mean() >= 0.99, \
        (diff.mean(), (diff <= 1e-4).mean())


def _light_scene():
    """tests/test_sharding.py's ReSTIR scene: a floor under two emissive
    quads, in both packages."""
    mb = MaterialBuilder()
    floor_m = mb.add_rough((0.7, 0.7, 0.7))
    em = mb.add_emissive((25.0, 22.0, 18.0))
    em2 = mb.add_emissive((2.0, 6.0, 9.0))

    def quad(cx, cy, z, half):
        a = [cx - half, cy - half, z]
        b = [cx + half, cy - half, z]
        c = [cx + half, cy + half, z]
        d = [cx - half, cy + half, z]
        return [[a, b, c], [a, c, d]]

    verts = quad(0.0, 0.0, 0.0, 4.0) + quad(-1.0, 0.5, 2.0, 0.25) \
        + quad(1.2, -0.8, 2.0, 0.3)
    mats = [floor_m] * 2 + [em] * 2 + [em2] * 2
    v = np.asarray(verts, np.float32)
    n = np.zeros_like(v)
    n[:, :, 2] = 1.0
    js = JScene(spheres=JSpheres.empty(), triangles=JTriangles.from_arrays(
        v, n, np.asarray(mats, np.int32)))
    jm = mb.build()
    jl = jlights(js, jm)
    jc = JCamera.look_at((0.0, 0.0, 7.0), (0.0, 0.0, 6.0), (0.0, 1.0, 0.0))
    return _port((js, "scene"), (jm, "materials"), (jl, "area_lights"),
                 (jc, "camera"))


@pytest.mark.parametrize("tile", [4, 8])
def test_restir_matches_single_device(tile):
    """Two frames: frame 1 runs the temporal reuse and spatial taps of
    radius 16 across the 6-row (tile 4) and 3-row (tile 8) bands; the
    image and every reservoir array equal ``render_restir``'s."""
    ts, tm, tl, tc = _light_scene()
    kw = dict(seed=3, m_candidates=8, spatial_taps=2, spatial_radius=16)
    ref_st = restir.empty_reservoir_state(W, H, CPU)
    st = restir.empty_reservoir_state(W, H, CPU)
    mesh = _tmesh(tile)
    for f in range(2):
        ref, ralb, rnrm, ref_st = restir.render_restir(
            ts, tm, tl, tc, W, H, frame=f, state=ref_st, **kw)
        img, alb, nrm, st = tsh.render_restir_sharded(
            ts, tm, tl, tc, W, H, mesh, frame=f, state=st, **kw)
        for got, want in ((img, ref), (alb, ralb), (nrm, rnrm)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                       err_msg=f"tile={tile} frame={f}")
    assert set(st) == set(ref_st)
    for k in ref_st:
        np.testing.assert_allclose(st[k].float().numpy(),
                                   ref_st[k].float().numpy(), atol=1e-6,
                                   err_msg=f"state[{k}] tile={tile}")


def test_restir_rejects_sample_axis_and_no_lights():
    ts, tm, tl, tc = _light_scene()
    with pytest.raises(ValueError, match="sample"):
        tsh.render_restir_sharded(ts, tm, tl, tc, W, H, _tmesh(2, 2))
    with pytest.raises(ValueError, match="light table"):
        tsh.render_restir_sharded(ts, tm, None, tc, W, H, _tmesh(2))


def test_dryrun_multichip_on_cpu(capsys):
    """The port's analog of ``__graft_entry__.dryrun_multichip``: an
    8-shard mesh of repeated CPU devices runs the sharded Whitted, path,
    fused and ReSTIR steps."""
    from optix_ray_tracer_tpu_torch.graft import dryrun_multichip

    dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip ok: mesh=(tile=4, sample=2)" in \
        capsys.readouterr().out
