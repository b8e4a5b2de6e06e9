"""The device rule of the port's entry points: a constructor that builds
tensors from host data runs on the card unless the caller asks for the
CPU.  With ``torch.cuda.is_available`` patched to False, each raises a
RuntimeError naming ``device="cpu"`` when no device is given (never a
quiet CPU fallback), and builds CPU tensors with ``device="cpu"``; with
it patched to True, the default resolves to the card."""

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu_torch import convert
from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
from optix_ray_tracer_tpu_torch.ops.instanced import build_instanced_library
from optix_ray_tracer_tpu_torch.ops.sweep import build_clusters
from optix_ray_tracer_tpu_torch.render import neural_denoise
from optix_ray_tracer_tpu_torch.render.film import Film
from optix_ray_tracer_tpu_torch.scene.camera import Camera
from optix_ray_tracer_tpu_torch.scene.geometry import (
    ShapeLibrary, Spheres, Triangles,
)
from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder
from optix_ray_tracer_tpu_torch.utils.tensors import resolve_device

torch.set_num_threads(1)

_V, _N = sphere_with_n_triangles(80)


def _materials(device=None):
    mb = MaterialBuilder()
    mb.add_rough((0.5, 0.5, 0.5))
    return mb.build(device=device)


CONSTRUCTORS = {
    "Camera.look_at": lambda **kw: Camera.look_at(
        (3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), **kw).center,
    "Spheres.empty": lambda **kw: Spheres.empty(**kw).centers,
    "Spheres.from_list": lambda **kw: Spheres.from_list(
        [((0.0, 0.0, 0.0), 1.0, 0)], **kw).radii,
    "Triangles.empty": lambda **kw: Triangles.empty(**kw).vertices,
    "Triangles.from_arrays": lambda **kw: Triangles.from_arrays(
        _V, _N, **kw).normals,
    "ShapeLibrary.from_meshes": lambda **kw: ShapeLibrary.from_meshes(
        [(_V, _N)], **kw).vertices,
    "MaterialBuilder.build": lambda **kw: _materials(**kw).albedo,
    "build_clusters": lambda **kw: build_clusters(_V, **kw).woop,
    "build_instanced_library": lambda **kw: build_instanced_library(
        _V, [0], [_V.shape[0]], **kw).woop_t,
    "Film.create": lambda **kw: Film.create(4, 2, **kw).accum,
    "load_params": lambda **kw: neural_denoise.load_params(
        neural_denoise.WEIGHTS_FILE, **kw).head.weight,
    "default_params": lambda **kw: neural_denoise.default_params(
        **kw).head.bias,
    "convert.camera": lambda **kw: convert.camera(dict(
        center=np.zeros(3), u=np.ones(3), v=np.ones(3), w=np.ones(3),
        up=np.ones(3), target=np.ones(3)), **kw).w,
    "convert.kpcn": lambda **kw: convert.kpcn(
        neural_denoise.init_params(0), **kw).head.weight,
}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_entry_point_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CONSTRUCTORS[name]()


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_entry_point_on_cpu_when_asked(no_cuda, name):
    assert CONSTRUCTORS[name](device="cpu").device == torch.device("cpu")


def test_camera_look_at(no_cuda):
    """The issue's case, on its own: Camera.look_at raises without CUDA and
    builds every tensor on the CPU when asked."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0))
    cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device="cpu")
    for k in ("center", "u", "v", "w", "up", "target"):
        assert getattr(cam, k).device == torch.device("cpu")


def test_default_is_the_card(monkeypatch):
    """With CUDA available and no device given, the card; decided at call
    time, not at import."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()


def test_tensor_inputs_keep_their_device(no_cuda):
    """Functions that take tensors run on their inputs' device: a vertex
    tensor given to Triangles.from_arrays keeps its own."""
    tri = Triangles.from_arrays(torch.as_tensor(_V))
    assert tri.vertices.device == torch.device("cpu")
