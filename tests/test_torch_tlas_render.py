"""The slice end to end: one posed Time frame rendered through the TLAS
route, by the port's ``wavefront.render`` with the port's
``TLASSceneIntersector`` against the JAX ``wavefront.render`` with the JAX
one (the same frame handed over by convert.py); the port's frame builder
``tlas_frame_intersector`` against the JAX package's per-frame body; and,
in the port alone, the TLAS route against the flatten route
(``_frame_triangles`` -> ``make_march_intersector(raster=True)``) on the
same frame.

The frame: 10 instances of a two-sphere library (tests/test_tlas_product
.py's), ROUGH and METAL by particle, slerped and moved halfway between
two pose sets, over a static ROUGH ground quad; 64x64, spp 4, depth 5,
jitter on.  Camera waves take kernel D, bounce waves kernel E.

Bounds: port vs JAX as tests/test_torch_wavefront.py (mean |diff| <=
1e-5 and >= 99.9% of pixels within 1e-4, guides included); TLAS vs
flatten as tests/test_tlas_product.py:226-232 (sRGB max diff <= 6 LSB,
> 2 LSB on < 1% of pixels: world-baked and object-space triangles round
differently, which moves u/v by ~1e-6 and flips a few grazing hits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.io.meshgen import quad
from optix_ray_tracer_tpu.models import renderer_time as jrt
from optix_ray_tracer_tpu.ops import instanced as jinst
from optix_ray_tracer_tpu.ops.tlas import TLASSceneIntersector as JTLAS
from optix_ray_tracer_tpu.render import wavefront as jwave
from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.geometry import Scene as JScene
from optix_ray_tracer_tpu.scene.geometry import Spheres as JSpheres
from optix_ray_tracer_tpu.scene.geometry import Triangles as JTriangles
from optix_ray_tracer_tpu.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.models import renderer_time as trt
from optix_ray_tracer_tpu_torch.ops import instanced as tinst
from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
from optix_ray_tracer_tpu_torch.render import wavefront as twave
from optix_ray_tracer_tpu_torch.scene.geometry import (
    Scene, ShapeLibrary, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.utils.color import color_to_uint8
from test_tlas_product import _library

torch.set_num_threads(1)

W = H = 64
SPP = 4
SEED = 5
P = 10
POSE = dict(duration=1.0, frame_idx=1.0, n_frames=3,
            particle_shift=(0.0, 0.0, 0.5))


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def frame():
    lv, ln, offsets, counts = _library()
    shapes = ShapeLibrary(torch.as_tensor(lv), torch.as_tensor(ln), offsets,
                          counts)
    rng = np.random.default_rng(3)
    sid = rng.integers(0, len(counts), P)
    pos = rng.uniform(-4, 4, (P, 3)).astype(np.float32)
    quat, quat_next = _quats(rng, P), _quats(rng, P)
    vel = rng.normal(size=(P, 3)).astype(np.float32)
    valid = np.ones(P, bool)
    mb = MaterialBuilder()
    rough = mb.add_rough((0.65, 0.25, 0.2))
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.7, 0.6, 0.5))
    pmat = np.where(np.arange(P) % 2 == 0, rough, metal).astype(np.int32)
    tri_lib, tri_inst, tri_ok = trt.packing_tables(shapes, sid[None],
                                                   valid[None])

    # the JAX package's per-frame body (models/renderer_time.py:362-400)
    jlib = jinst.build_instanced_library(lv, offsets, counts)
    pair_shape, pair_inst = jinst.make_pairs(jlib, sid)
    sizes = counts[sid]
    k, n = POSE["frame_idx"], POSE["n_frames"]
    rot, shift = jrt._instance_poses(
        jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(quat_next),
        jnp.asarray(vel), jnp.float32(POSE["duration"]), jnp.float32(k),
        jnp.float32(1.0 / (n - 1)), jnp.float32(1.0 / n),
        jnp.asarray(POSE["particle_shift"], jnp.float32), False)
    pmin, pmax, smin, smax, rows = jinst.refit_instanced(
        jlib, pair_shape, pair_inst, rot, shift, jnp.float32(1.0),
        jnp.asarray(valid))
    lo = jnp.nan_to_num(pmin, nan=jnp.inf).min(axis=0)
    hi = jnp.nan_to_num(pmax, nan=-jnp.inf).max(axis=0)
    jtlas = JTLAS(
        tlas=jinst.InstancedMarchIntersector(
            library=jlib, pair_shape=pair_shape, pair_inst=pair_inst,
            pair_min=pmin, pair_max=pmax, sub_min=smin, sub_max=smax,
            inst_rows=rows, scene_lo=lo, scene_hi=hi),
        tri_lib=jnp.asarray(tri_lib[0]), tri_inst=jnp.asarray(tri_inst[0]),
        inst_base=jnp.asarray(np.cumsum(sizes) - sizes, jnp.int32),
        inst_tri_off=jnp.asarray(offsets[sid], jnp.int32),
        lib_normals=jnp.asarray(ln), rot=rot, pmat=jnp.asarray(pmat))

    qv, qn = quad((-12, -12, -5), (12, -12, -5), (12, 12, -5), (-12, 12, -5))
    jstatic = JScene(spheres=JSpheres.empty(),
                     triangles=JTriangles.from_arrays(qv, qn, ground))
    jmats = mb.build()
    # look_at's field of view spans +-1 at the target: a target 1.6 units
    # along the axis toward (0, 0, -1) frames the whole cloud (64 degrees)
    eye = np.asarray([13.0, 3.0, 4.0], np.float32)
    axis = -np.asarray([13.0, 3.0, 5.0], np.float32) / np.sqrt(203.0)
    jcam = JCamera.look_at(tuple(eye), tuple(eye + 1.6 * axis),
                           (0.0, 0.0, 1.0))
    args = dict(shapes=shapes, sid=sid, valid=valid, pmat=pmat,
                tri=(tri_lib[0], tri_inst[0], tri_ok[0]),
                poses=dict(positions=pos, quats=quat, quats_next=quat_next,
                           velocities=vel))
    return (jtlas, jstatic, jmats, jcam, convert.tlas_intersector(
        convert.state_arrays(jtlas), device="cpu"), args)


def _port(frame):
    _, jstatic, jmats, jcam, ttlas, _ = frame
    return (ttlas, convert.scene(convert.state_arrays(jstatic), device="cpu"),
            convert.materials(convert.state_arrays(jmats), device="cpu"),
            convert.camera(convert.state_arrays(jcam), device="cpu"))


def test_frame_builder_matches_jax(frame):
    """tlas_frame_intersector (the port's per-frame body) reproduces the
    JAX frame: the same tables, boxes and affine rows to 1e-6."""
    jtlas, *_, ttlas, a = frame
    tl = tinst.build_instanced_library(np.asarray(a["shapes"].vertices),
                                       a["shapes"].offsets,
                                       a["shapes"].counts, device="cpu")
    got = trt.tlas_frame_intersector(
        tl, a["shapes"], a["sid"], a["valid"], torch.as_tensor(a["tri"][0]),
        torch.as_tensor(a["tri"][1]), torch.as_tensor(a["pmat"]),
        **{k: torch.as_tensor(v) for k, v in a["poses"].items()}, **POSE)
    for name in ("tri_lib", "tri_inst", "inst_base", "inst_tri_off", "pmat"):
        assert torch.equal(getattr(got, name), getattr(ttlas, name)), name
    np.testing.assert_allclose(got.rot.numpy(), ttlas.rot.numpy(), atol=1e-6)
    for name in ("pair_min", "pair_max", "sub_min", "sub_max", "inst_rows",
                 "scene_lo", "scene_hi"):
        np.testing.assert_allclose(getattr(got.tlas, name).numpy(),
                                   getattr(ttlas.tlas, name).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def renders(frame):
    jtlas, jstatic, jmats, jcam, _, _ = frame
    ref = jwave.render(jstatic, jmats, jcam, W, H, spp=SPP, seed=SEED,
                       intersector=jtlas)
    ttlas, tstatic, tmats, tcam = _port(frame)
    got = twave.render(tstatic, tmats, tcam, W, H, spp=SPP, seed=SEED,
                       intersector=ttlas)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("buffer", [0, 1, 2], ids=["image", "albedo",
                                                   "normal"])
def test_tlas_render_matches_jax(renders, buffer):
    ref, got = renders
    diff = np.abs(got[buffer] - ref[buffer])
    assert np.isfinite(got[buffer]).all()
    assert diff.mean() <= 1e-5, diff.mean()
    assert (diff.max(-1) <= 1e-4).mean() >= 0.999


def test_tlas_route_matches_flatten(frame, renders):
    """In the port: the same frame through the flatten route (world-baked
    triangles, kernels A/B/C) and the TLAS route (kernels D/E)."""
    _, got = renders
    ttlas, tstatic, tmats, tcam = _port(frame)
    a = frame[5]
    k, n = POSE["frame_idx"], POSE["n_frames"]
    v, nrm, mat = trt._frame_triangles(
        a["shapes"].vertices, a["shapes"].normals, *a["tri"],
        *(torch.as_tensor(a["poses"][x]) for x in ("positions", "quats",
                                                   "quats_next")),
        torch.as_tensor(a["poses"]["velocities"]), torch.as_tensor(a["pmat"]),
        POSE["duration"], k, 1.0 / (n - 1), 1.0 / n, POSE["particle_shift"],
        1.0, False)
    flat = Scene(Spheres.empty(device="cpu"), Triangles(v, nrm, mat).concat(
        tstatic.triangles))
    img = twave.render(flat, tmats, tcam, W, H, spp=SPP, seed=SEED,
                       intersector=make_march_intersector(flat,
                                                          raster=True))[0]
    a8 = color_to_uint8(torch.as_tensor(got[0])).numpy().astype(np.int32)
    b8 = color_to_uint8(img).numpy().astype(np.int32)
    diff = np.abs(a8 - b8)
    assert diff.max() <= 6, diff.max()
    assert (diff > 2).mean() < 0.01
    sky = (b8[..., :3] == (218, 232, 244)).all(-1)
    assert 0 < sky.sum() < sky.size       # sky and geometry both in view
