"""Interactive preview over HTTP (port of
``optix_ray_tracer_tpu/render/viewer.py``): the headless analog of the
reference's SDL window.

The reference presents through GL/VK/D3D swapchains with WASD and mouse
input (``src/GraphicsAPI/*``).  A GPU server has no display, so the
viewer serves an MJPEG stream over HTTP (any browser shows it) and takes
input from HTTP endpoints, with the reference's camera semantics
(``scene/camera.FlyCameraController``).

Endpoints:
  GET /            a minimal HTML page with the stream and key bindings
  GET /stream      multipart/x-mixed-replace stream: JPEG parts through
                   Pillow when it imports, else PNG parts
  GET /key?k=w     press a movement key (w/a/s/d/space/shift)
  GET /look?dx=&dy=  mouse-look deltas
  GET /wheel?d=1   mouse wheel: movement speed up or down
  GET /denoise     toggle the denoiser (the reference's Tab bypass)
  GET /filter      cycle the denoise filter (config default/atrous/neural)
  GET /anim        toggle animation stepping
  GET /quit        stop the server (Esc)
"""

from __future__ import annotations

import inspect
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from optix_ray_tracer_tpu_torch.scene.camera import FlyCameraController
from optix_ray_tracer_tpu_torch.utils.color import png_bytes
from optix_ray_tracer_tpu_torch.utils.logging import LOG

_PAGE = b"""<!doctype html><html><body style="background:#111;color:#eee;
font-family:monospace"><h3>optix_ray_tracer_tpu_torch viewer</h3>
<img src="/stream" style="image-rendering:pixelated;width:75%%">
<p>keys: GET /key?k=[w|a|s|d|space|shift] &mdash; look: GET /look?dx=10&dy=0
&mdash; wheel: GET /wheel?d=1 &mdash; Tab: toggle denoiser &mdash;
n: cycle denoise filter (atrous/neural) &mdash;
p: toggle animation &mdash; quit: GET /quit</p>
<script>
document.addEventListener('keydown', e => {
  const m = {w:'w',a:'a',s:'s',d:'d',' ':'space',Shift:'shift'};
  if (m[e.key]) fetch('/key?k='+m[e.key]);
  if (e.key === 'Tab') { e.preventDefault(); fetch('/denoise'); }
  if (e.key === 'n') fetch('/filter');
  if (e.key === 'p') fetch('/anim');
});
document.addEventListener('wheel',
  e => fetch('/wheel?d=' + (e.deltaY < 0 ? 1 : -1)));
let drag=false, lx=0, ly=0;
document.addEventListener('mousedown', e=>{drag=true;lx=e.x;ly=e.y;});
document.addEventListener('mouseup', ()=>drag=false);
document.addEventListener('mousemove', e=>{
  if(drag){fetch('/look?dx='+(e.x-lx)+'&dy='+(e.y-ly));lx=e.x;ly=e.y;}
});
</script></body></html>"""




def encoder() -> str:
    """The stream's part format: "jpeg" when Pillow imports, else "png"."""
    try:
        from PIL import Image  # noqa: F401
    except ImportError:
        return "png"
    return "jpeg"


def _encode_frame(rgba: np.ndarray) -> tuple[bytes, bytes]:
    """uint8 (H, W, 3|4) -> (bytes, the part's content type): JPEG
    through Pillow when it imports (parts ~10x smaller), else lossless
    PNG through ``utils/color.png_bytes``."""
    try:
        import io

        from PIL import Image
    except ImportError:
        return png_bytes(rgba), b"image/png"
    buf = io.BytesIO()
    Image.fromarray(rgba[..., :3]).save(buf, "JPEG", quality=85)
    return buf.getvalue(), b"image/jpeg"


def _host(frames) -> np.ndarray:
    """A render function's uint8 output (tensor or array) on the host."""
    if hasattr(frames, "cpu"):
        frames = frames.cpu().numpy()
    return np.asarray(frames)


class ViewerServer:
    """Serve rendered frames; drive the camera from HTTP input.

    ``render_fn(camera) -> uint8 RGBA (H, W, 4)`` is called on a render
    thread whenever the previous frame finishes (1-spp interactive loop,
    like the reference's render loop).
    """

    def __init__(self, camera, render_fn=None, host="127.0.0.1", port=8425,
                 fps_limit: float = 30.0,
                 mouse_sensitivity: float = 0.002,
                 pitch_limit_degree: float = 85.0,
                 move_speed: float = 0.05,
                 render_chunk_fn=None, chunk: int = 4):
        """``render_fn(camera[, denoise_on=, animate=]) -> uint8 (H, W, 4)``
        renders one frame per call.  ``render_chunk_fn(camera, chunk,
        denoise_on, animate) -> uint8 (K, H, W, 4)`` renders K look-ahead
        frames per call (the fused chunk, one host fetch): while the user
        is idle the loop asks for ``chunk`` frames at a time and streams
        them at the FPS cap; any input drops the remaining look-ahead and
        the next call uses chunk=1, so the camera reacts within a frame.
        An exception in the render loop stops the server and stays in
        ``error``."""
        self.controller = FlyCameraController(
            camera, mouse_sensitivity=mouse_sensitivity,
            pitch_limit_degree=pitch_limit_degree, move_speed=move_speed)
        if render_fn is None and render_chunk_fn is None:
            raise ValueError("need render_fn or render_chunk_fn")
        self.render_fn = render_fn
        self.render_chunk_fn = render_chunk_fn
        self.chunk = max(1, int(chunk))
        self.host = host
        self.port = port
        self.fps_limit = fps_limit
        self._frame: bytes | None = None
        self._frame_ctype: bytes = b"image/png"
        self._frame_lock = threading.Lock()
        self._input_lock = threading.Lock()
        self._pending: dict = {"dx": 0, "dy": 0, "wheel": 0, "keys": set()}
        self.denoise_on = True     # Tab-bypass analog: GET /denoise toggles
        self.filter_name = None    # None = config default; GET /filter cycles
        self.animate = False       # GET /anim toggles animation stepping
        self._stop = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None
        self.error: BaseException | None = None
        self.frames_published = 0
        # render_fn may be the 1-argument form (camera) or the full form
        # (camera, denoise_on=..., animate=...)
        try:
            self._rich_render = render_fn is not None and len(
                inspect.signature(render_fn).parameters) >= 3
        except (TypeError, ValueError):
            self._rich_render = False
        try:
            self._chunk_takes_filter = (
                render_chunk_fn is not None and "filter_name"
                in inspect.signature(render_chunk_fn).parameters)
        except (TypeError, ValueError):
            self._chunk_takes_filter = False
        try:
            self._render_takes_filter = (
                render_fn is not None and "filter_name"
                in inspect.signature(render_fn).parameters)
        except (TypeError, ValueError):
            self._render_takes_filter = False

    # ---- input & camera ---------------------------------------------------

    def _apply_input(self):
        with self._input_lock:
            dx, dy = self._pending["dx"], self._pending["dy"]
            wheel = self._pending["wheel"]
            keys = set(self._pending["keys"])
            self._pending = {"dx": 0, "dy": 0, "wheel": 0, "keys": set()}
        if wheel:
            self.controller.scroll(wheel)
        self._had_input = bool(dx or dy or wheel or keys)
        return self.controller.update(
            mouse_dx=dx, mouse_dy=dy,
            forward="w" in keys, back="s" in keys,
            right="d" in keys, left="a" in keys,
            up="space" in keys, down="shift" in keys)

    def _input_pending(self) -> bool:
        with self._input_lock:
            p = self._pending
            return bool(p["dx"] or p["dy"] or p["wheel"] or p["keys"])

    # ---- render loop ------------------------------------------------------

    def _publish(self, rgba: np.ndarray) -> None:
        data, ctype = _encode_frame(rgba)
        with self._frame_lock:
            self._frame = data
            self._frame_ctype = ctype
            self.frames_published += 1

    def _render_loop(self):
        try:
            self._render_frames()
        except BaseException as e:     # a dead loop must not hang clients
            LOG.exception("viewer render loop failed")
            self.error = e
            self.stop()

    def _render_frames(self):
        frame_interval = 1.0 / max(self.fps_limit, 1e-3)
        self._had_input = False
        while not self._stop.is_set():
            t0 = time.time()
            camera = self._apply_input()
            if self.render_chunk_fn is not None:
                # K look-ahead frames per call while idle, 1 while the
                # user steers (so the camera reacts within one frame)
                k = 1 if (self._had_input or self._input_pending()) \
                    else self.chunk
                kw = ({"filter_name": self.filter_name}
                      if self._chunk_takes_filter else {})
                frames = _host(self.render_chunk_fn(
                    camera, k, self.denoise_on, self.animate, **kw))
                for j in range(frames.shape[0]):
                    self._publish(frames[j])
                    dt = time.time() - t0
                    if dt < frame_interval:
                        time.sleep(frame_interval - dt)
                    t0 = time.time()
                    # fresh input invalidates the remaining look-ahead
                    if self._input_pending() or self._stop.is_set():
                        break
                continue
            if self._rich_render:
                kw = ({"filter_name": self.filter_name}
                      if self._render_takes_filter else {})
                rgba = _host(self.render_fn(
                    camera, denoise_on=self.denoise_on,
                    animate=self.animate, **kw))
            else:
                rgba = _host(self.render_fn(camera))
            self._publish(rgba)
            # FPS limiter (the reference sleeps to its target)
            dt = time.time() - t0
            if dt < frame_interval:
                time.sleep(frame_interval - dt)

    # ---- server -----------------------------------------------------------

    def serve(self, blocking: bool = True):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif url.path == "/key":
                    with viewer._input_lock:
                        viewer._pending["keys"].add(q.get("k", [""])[0])
                    self.send_response(204)
                    self.end_headers()
                elif url.path == "/look":
                    def _num(name):
                        try:
                            return int(float(q.get(name, ["0"])[0]))
                        except ValueError:
                            return 0
                    with viewer._input_lock:
                        viewer._pending["dx"] += _num("dx")
                        viewer._pending["dy"] += _num("dy")
                    self.send_response(204)
                    self.end_headers()
                elif url.path == "/wheel":
                    try:
                        d = int(float(q.get("d", ["0"])[0]))
                    except ValueError:
                        d = 0
                    with viewer._input_lock:
                        viewer._pending["wheel"] += d
                    self.send_response(204)
                    self.end_headers()
                elif url.path == "/denoise":
                    viewer.denoise_on = not viewer.denoise_on
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(
                        b"denoise on" if viewer.denoise_on else b"denoise off")
                elif url.path == "/filter":
                    # cycle config-default -> atrous -> neural; an explicit
                    # ?f=atrous|neural sets it directly
                    f = q.get("f", [None])[0]
                    if f in ("atrous", "neural"):
                        viewer.filter_name = f
                    else:
                        cycle = [None, "atrous", "neural"]
                        i = cycle.index(viewer.filter_name) \
                            if viewer.filter_name in cycle else 0
                        viewer.filter_name = cycle[(i + 1) % len(cycle)]
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(
                        (viewer.filter_name or "default").encode())
                elif url.path == "/anim":
                    viewer.animate = not viewer.animate
                    self.send_response(200)
                    self.end_headers()
                    self.wfile.write(b"animation on" if viewer.animate
                                     else b"animation off")
                elif url.path == "/quit":
                    self.send_response(200)
                    self.end_headers()
                    viewer.stop()
                elif url.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    try:
                        while not viewer._stop.is_set():
                            with viewer._frame_lock:
                                frame = viewer._frame
                                ctype = viewer._frame_ctype
                            if frame is not None:
                                self.wfile.write(b"--frame\r\n")
                                self.wfile.write(b"Content-Type: " + ctype
                                                 + b"\r\n\r\n")
                                self.wfile.write(frame)
                                self.wfile.write(b"\r\n")
                            time.sleep(1.0 / viewer.fps_limit)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.timeout = 0.5     # wake to see a stop without requests
        self.port = self._httpd.server_address[1]    # port 0: the OS's
        self._render_thread = threading.Thread(target=self._render_loop,
                                               daemon=True)
        self._render_thread.start()
        LOG.info("viewer at http://%s:%d/", self.host, self.port)
        if blocking:
            try:
                while not self._stop.is_set():
                    self._httpd.handle_request()
            finally:
                self._httpd.server_close()
                # let the frame in flight finish before the caller exits
                self._render_thread.join(timeout=120)
        else:
            threading.Thread(target=self._serve_until_stopped,
                             daemon=True).start()
        return self

    def _serve_until_stopped(self):
        while not self._stop.is_set():
            self._httpd.handle_request()
        self._httpd.server_close()

    def stop(self):
        self._stop.set()

    def latest_frame(self) -> tuple[bytes, bytes] | None:
        """(encoded bytes, content type) of the newest frame, or None."""
        with self._frame_lock:
            if self._frame is None:
                return None
            return self._frame, self._frame_ctype
