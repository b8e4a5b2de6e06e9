"""The viewer of the port (render/viewer.py) and its fly camera
(scene/camera.FlyCameraController).

The controller is held to the JAX package's over an input sequence that
moves, looks, clamps the pitch and scrolls the speed: equal camera
vectors (the same float32 operations; cos, sin and asin of host floats
taken in float32 on both sides).  The server runs on a stub render
function: every request has a timeout of at most 5 s, the server binds
port 0 and is always stopped in a ``finally``; no frame rate is
asserted."""

import time
import urllib.request

import numpy as np
import pytest
import torch

from optix_ray_tracer_tpu.scene.camera import Camera as JCamera
from optix_ray_tracer_tpu.scene.camera import FlyCameraController as JFly
from optix_ray_tracer_tpu_torch.render import viewer as tviewer
from optix_ray_tracer_tpu_torch.scene.camera import Camera as TCamera
from optix_ray_tracer_tpu_torch.scene.camera import (
    FlyCameraController as TFly,
)
from optix_ray_tracer_tpu_torch.utils.color import png_bytes

EVENTS = [
    dict(mouse_dx=12, mouse_dy=-7),
    dict(forward=True),
    dict(mouse_dy=-2000),                 # past the pitch limit (up)
    dict(left=True, up=True),
    dict(mouse_dx=-30, mouse_dy=4000),    # past the limit (down)
    dict(back=True, right=True, down=True),
    dict(forward=True, back=True),        # cancelling keys: no move
    dict(),
]


@pytest.mark.parametrize("pose", [
    ((5.0, 1.0, 2.0), (0.0, 0.0, 0.5), (0.0, 0.0, 1.0)),
    ((0.0, -4.0, 1.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.3)),
])
def test_fly_camera_matches_jax(pose):
    j = JFly(JCamera.look_at(*pose), move_speed=0.05, pitch_limit_degree=80)
    t = TFly(TCamera.look_at(*pose, device="cpu"), move_speed=0.05,
             pitch_limit_degree=80)
    for i, ev in enumerate(EVENTS):
        if i == 3:
            for w in (1, 1, -1):
                j.scroll(w)
                t.scroll(w)
        a, b = j.update(**ev), t.update(**ev)
        for k in ("center", "target", "u", "v", "w", "up"):
            np.testing.assert_array_equal(getattr(b, k).numpy(),
                                          np.asarray(getattr(a, k)),
                                          err_msg=f"event {i} {k}")
        assert j.move_speed == t.move_speed
    # the pitch clamp held: the view is at most 80 degrees off horizontal
    w = t.camera.w / torch.linalg.norm(t.camera.w)
    assert abs(float(torch.asin(torch.dot(w, t.camera.up)))) <= np.radians(
        80) + 1e-5


def test_scroll_floors_at_zero():
    t = TFly(TCamera.look_at((1.0, 0, 0), (0, 0, 0), (0, 0, 1),
                             device="cpu"), move_speed=0.003)
    t.scroll(-1)
    assert t.move_speed == pytest.approx(0.001)
    t.scroll(-1)
    assert t.move_speed == 0.0
    cam = t.camera
    assert t.update(forward=True) is t.camera
    assert torch.equal(t.camera.center, cam.center)    # speed 0: no move


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


@pytest.fixture()
def server():
    calls = []

    def render_fn(camera, denoise_on=True, animate=False, filter_name=None):
        calls.append((camera, denoise_on, animate, filter_name))
        img = np.zeros((8, 12, 4), np.uint8)
        img[..., 0] = len(calls) % 256
        img[..., 3] = 255
        return torch.as_tensor(img)

    cam = TCamera.look_at((3.0, 0.0, 1.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                          device="cpu")
    v = tviewer.ViewerServer(cam, render_fn, port=0, fps_limit=100.0)
    v.serve(blocking=False)
    base = f"http://127.0.0.1:{v.port}"
    try:
        yield v, base, calls
    finally:
        v.stop()
        try:
            _get(base + "/quit", timeout=2.0)
        except OSError:
            pass


def _wait(pred, timeout=5.0):
    t0 = time.time()
    while not pred():
        if time.time() - t0 > timeout:
            raise AssertionError("timed out")
        time.sleep(0.01)


def test_viewer_endpoints(server):
    v, base, calls = server
    assert v.port != 0
    status, page = _get(base + "/")
    assert status == 200 and b"/stream" in page
    _wait(lambda: v.latest_frame() is not None)
    data, ctype = v.latest_frame()
    assert ctype in (b"image/jpeg", b"image/png")
    assert ctype == (b"image/png" if tviewer.encoder() == "png"
                     else b"image/jpeg")
    # input moves the camera seen by the next render
    n0 = len(calls)
    center0 = calls[-1][0].center.clone()
    for path in ("/key?k=w", "/look?dx=15&dy=-3", "/wheel?d=1",
                 "/look?dx=bad"):
        assert _get(base + path)[0] == 204
    _wait(lambda: len(calls) > n0 + 1)
    assert not torch.equal(calls[-1][0].center, center0)
    assert _get(base + "/denoise") == (200, b"denoise off")
    assert _get(base + "/anim") == (200, b"animation on")
    assert _get(base + "/filter") == (200, b"atrous")
    assert _get(base + "/filter?f=neural") == (200, b"neural")
    n1 = len(calls)
    _wait(lambda: len(calls) > n1)
    assert calls[-1][1:] == (False, True, "neural")
    with pytest.raises(urllib.error.HTTPError):
        _get(base + "/nothing")
    # the stream: multipart parts of the newest frame
    with urllib.request.urlopen(base + "/stream", timeout=5.0) as r:
        assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
        buf = b""
        while buf.count(b"--frame") < 3:
            buf += r.read1(4096)
    assert b"Content-Type: image/" in buf
    assert _get(base + "/quit")[0] == 200
    _wait(lambda: v._stop.is_set())
    assert v.error is None and v.frames_published >= 2


def test_viewer_chunk_path_and_errors():
    """render_chunk_fn serves K frames per call (K = 1 under input); an
    exception in the render loop stops the server and stays in error."""
    cam = TCamera.look_at((3.0, 0.0, 1.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                          device="cpu")
    chunks = []

    def chunk_fn(camera, k, denoise_on, animate):
        chunks.append(k)
        if len(chunks) == 4:
            raise RuntimeError("boom")
        return np.zeros((k, 4, 4, 4), np.uint8)

    v = tviewer.ViewerServer(cam, render_chunk_fn=chunk_fn, port=0,
                             fps_limit=200.0, chunk=3)
    try:
        v.serve(blocking=False)
        _wait(lambda: v._stop.is_set())
        assert chunks[0] == 3 and isinstance(v.error, RuntimeError)
        assert v.frames_published == 9
    finally:
        v.stop()
    with pytest.raises(ValueError):
        tviewer.ViewerServer(cam)


def test_encode_frame_png_branch(monkeypatch):
    """Without Pillow the parts are the port's PNG bytes."""
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *a, **kw)

    img = np.random.default_rng(0).integers(0, 255, (5, 7, 4)).astype(
        np.uint8)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert tviewer.encoder() == "png"
    assert tviewer._encode_frame(img) == (png_bytes(img), b"image/png")

