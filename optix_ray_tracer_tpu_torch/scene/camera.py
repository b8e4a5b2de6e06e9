"""UVW pinhole / thin-lens camera and the headless fly-camera controller
(port of ``optix_ray_tracer_tpu/scene/camera.py``).

``W = target - center`` (not normalized: |W| sets the field of view),
``U = normalize(cross(W, up))``, ``V = normalize(cross(U, W))``; pixel
directions ``normalize(ndc_x*aspect*U + ndc_y*V + W)`` with image row 0 at
the top.  The controller is the reference's SDL fly camera
(``SDL_GraphicsWindow.cu:79-214``): yaw about V, pitch about U with an
asin clamp against the up axis, WASD movement with the forward direction
projected onto the horizontal plane.
"""

from __future__ import annotations

import dataclasses

import torch

from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)
from optix_ray_tracer_tpu_torch.utils.vecmath import (
    EPS, cross, degrees_to_radians, dot, length, normalize,
    rotate_about_axis,
)


@dataclasses.dataclass(frozen=True)
class Camera(TensorDataclass):
    """center, u, v, w, up, target: (3,) float32 tensors.  ``aperture`` is
    the lens radius (0 = pinhole); ``focus_dist`` <= 0 focuses at |w|."""
    center: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    up: torch.Tensor
    target: torch.Tensor
    aperture: float = 0.0
    focus_dist: float = -1.0

    @staticmethod
    def look_at(center, target, up, aperture: float = 0.0,
                focus_dist: float = -1.0, device=None) -> "Camera":
        dev = resolve_device(device)
        center = torch.as_tensor(center, dtype=torch.float32, device=dev)
        target = torch.as_tensor(target, dtype=torch.float32, device=dev)
        up = normalize(torch.as_tensor(up, dtype=torch.float32, device=dev))
        w = target - center
        u = normalize(cross(w, up))
        v = normalize(cross(u, w))
        return Camera(center=center, u=u, v=v, w=w, up=up, target=target,
                      aperture=float(aperture), focus_dist=float(focus_dist))

    def generate_rays(self, width: int, height: int, jitter=None,
                      lens_uv=None):
        """Primary rays for every pixel; ``jitter`` optional (..., H, W, 2)
        subpixel offsets, ``lens_uv`` optional (..., 2) unit-disk samples.
        Returns (origins, directions) of shape (..., H, W, 3)."""
        dev = self.center.device
        iy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
        ix = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
        if jitter is None:
            ox = oy = 0.5
        else:
            ox = jitter[..., 0]
            oy = jitter[..., 1]
        ndc_x = ((ix + ox) / width) * 2.0 - 1.0
        ndc_y = 1.0 - ((iy + oy) / height) * 2.0
        ndc_x, ndc_y = torch.broadcast_tensors(ndc_x, ndc_y)
        aspect = width / height
        d = (ndc_x[..., None] * aspect * self.u
             + ndc_y[..., None] * self.v + self.w)
        directions = normalize(d)
        origins = self.center.expand(directions.shape)
        if lens_uv is not None:
            origins, directions = self.apply_lens(origins, directions,
                                                  lens_uv)
        return origins, directions

    def generate_rays_for_pixels(self, pixel_id, width: int, height: int,
                                 jitter=None, lens_uv=None):
        """Primary rays for a subset of pixels by flat id (``iy * width +
        ix``, row 0 at the top), the adaptive sampler's generator: for
        every pixel in order the rays are :meth:`generate_rays`'s bit for
        bit.  ``jitter``, ``lens_uv``: optional (R, 2).  Returns
        (origins, directions), each (R, 3)."""
        pid = pixel_id.to(torch.int64)
        ix = (pid % width).to(torch.float32)
        iy = (pid // width).to(torch.float32)
        if jitter is None:
            ox = oy = 0.5
        else:
            ox = jitter[..., 0]
            oy = jitter[..., 1]
        ndc_x = ((ix + ox) / width) * 2.0 - 1.0
        ndc_y = 1.0 - ((iy + oy) / height) * 2.0
        aspect = width / height
        d = (ndc_x[..., None] * aspect * self.u
             + ndc_y[..., None] * self.v + self.w)
        directions = normalize(d)
        origins = self.center.expand(directions.shape)
        if lens_uv is not None:
            origins, directions = self.apply_lens(origins, directions,
                                                  lens_uv)
        return origins, directions

    def apply_lens(self, origins, directions, lens_uv):
        """Thin lens: jitter origins on the aperture disk and re-aim at the
        focus plane; a pinhole camera returns its inputs untouched."""
        if self.aperture <= 0.0:
            return origins, directions
        f = (self.focus_dist if self.focus_dist > 0.0
             else float(length(self.w)))
        w_unit = normalize(self.w)
        cos_w = torch.clamp(dot(directions, w_unit, keepdims=True), min=1e-6)
        p_focus = origins + directions * (f / cos_w)
        offset = self.aperture * (lens_uv[..., 0:1] * self.u
                                  + lens_uv[..., 1:2] * self.v)
        o2 = origins + offset
        return o2, normalize(p_focus - o2)


@dataclasses.dataclass
class FlyCameraController:
    """Headless WASD / mouse fly camera driving a :class:`Camera` from
    programmatic input events (the viewer's and animation scripts').  It
    reads the camera's vectors on the host: one sync per event."""
    camera: Camera
    mouse_sensitivity: float = 0.002
    pitch_limit_degree: float = 85.0
    move_speed: float = 0.02
    speed_stride: float = 0.002

    def scroll(self, wheel_y: int) -> None:
        """The mouse wheel changes the speed
        (``SDL_GraphicsWindow.cu:124-131``)."""
        if wheel_y > 0:
            self.move_speed += self.speed_stride
        else:
            self.move_speed = (0.0 if self.move_speed < self.speed_stride
                               else self.move_speed - self.speed_stride)

    def update(self, mouse_dx: int = 0, mouse_dy: int = 0, forward=False,
               back=False, right=False, left=False, up=False,
               down=False) -> Camera:
        cam = self.camera
        new_center, new_target = cam.center, cam.target
        if mouse_dx != 0 or mouse_dy != 0:
            view_dir = cam.target - cam.center
            u_n, v_n = normalize(cam.u), normalize(cam.v)
            w_n = normalize(cam.w)
            w_n = rotate_about_axis(w_n, v_n,
                                    -float(mouse_dx) * self.mouse_sensitivity)
            w_n = rotate_about_axis(w_n, u_n,
                                    -float(mouse_dy) * self.mouse_sensitivity)
            limit = degrees_to_radians(float(self.pitch_limit_degree))
            new_pitch = float(torch.asin(torch.clamp(dot(w_n, v_n), -1.0,
                                                     1.0)))
            if abs(new_pitch) > limit:
                new_pitch = limit if new_pitch > 0 else -limit
                horiz = normalize(w_n - v_n * dot(w_n, v_n, keepdims=True))
                p = torch.tensor(new_pitch, dtype=torch.float32)
                w_n = horiz * float(torch.cos(p)) + v_n * float(torch.sin(p))
            new_target = new_center + w_n * length(view_dir)

        move = torch.zeros(3, device=cam.center.device)
        w_m = normalize(cam.w)
        world_up = normalize(cam.up)
        projected = w_m - world_up * dot(w_m, world_up, keepdims=True)
        fwd = (normalize(projected) if float(length(projected)) > EPS
               else normalize(cam.u))
        for pressed, step in ((forward, fwd), (back, -fwd), (right, cam.u),
                              (left, -cam.u), (up, cam.up),
                              (down, -cam.up)):
            if pressed:
                move = move + step
        if float((move * move).sum()) > 0.0:
            translation = normalize(move) * self.move_speed
            new_center = new_center + translation
            new_target = new_target + translation
        self.camera = Camera.look_at(new_center, new_target, cam.up,
                                     aperture=cam.aperture,
                                     focus_dist=cam.focus_dist,
                                     device=cam.center.device)
        return self.camera
