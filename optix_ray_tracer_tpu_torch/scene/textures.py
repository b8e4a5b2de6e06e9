"""Texture sampling (port of ``optix_ray_tracer_tpu/scene/textures.py``).

A :class:`TextureSet` packs same-sized RGB textures into one (N, TH, TW, 3)
array with a texture index per material (-1 = untextured).  At shade time
the path tracer multiplies the material albedo by the bilinear sample at
the hit's interpolated uv.  Textures of other sizes are resampled to the
atlas resolution on the host at build time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.utils.color import srgb_to_linear
from optix_ray_tracer_tpu_torch.utils.tensors import (
    TensorDataclass, resolve_device,
)


@dataclasses.dataclass(frozen=True)
class TextureSet(TensorDataclass):
    """atlas: (N, TH, TW, 3) float32, linear; material_texture: (M,) int32
    texture index per material row (-1 = none)."""
    atlas: torch.Tensor
    material_texture: torch.Tensor

    @property
    def count(self) -> int:
        return self.atlas.shape[0]

    def sample(self, material_id, uv):
        """Bilinear, wrap-around sample; untextured materials give 1.
        material_id (R,) int, uv (R, 2) -> (R, 3) multipliers."""
        th, tw = self.atlas.shape[1], self.atlas.shape[2]
        tex_id = self.material_texture[torch.clamp(
            material_id, 0, self.material_texture.shape[0] - 1).long()]
        has_tex = tex_id >= 0
        ti = torch.clamp(tex_id, min=0).long()
        u = uv[..., 0] * tw - 0.5
        v = (1.0 - uv[..., 1]) * th - 0.5   # image row 0 is the top, v=1
        u0 = torch.floor(u)
        v0 = torch.floor(v)
        fu = (u - u0)[..., None]
        fv = (v - v0)[..., None]
        u0i = torch.remainder(u0.to(torch.int64), tw)
        u1i = torch.remainder(u0i + 1, tw)
        v0i = torch.remainder(v0.to(torch.int64), th)
        v1i = torch.remainder(v0i + 1, th)
        c00 = self.atlas[ti, v0i, u0i]
        c01 = self.atlas[ti, v0i, u1i]
        c10 = self.atlas[ti, v1i, u0i]
        c11 = self.atlas[ti, v1i, u1i]
        col = ((c00 * (1 - fu) + c01 * fu) * (1 - fv)
               + (c10 * (1 - fu) + c11 * fu) * fv)
        return torch.where(has_tex[..., None], col, 1.0)


def _resample_nearest(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(th) * h // th).clip(0, h - 1)
    xs = (np.arange(tw) * w // tw).clip(0, w - 1)
    return img[ys][:, xs]


def build_texture_set(textures: list, material_texture_ids: list[int],
                      resolution: int = 256, device=None) -> TextureSet:
    """Pack host textures ((H, W, 3) linear float arrays, or None
    placeholders) into a TextureSet at one resolution, on ``device``
    (None: the card)."""
    dev = resolve_device(device)
    packed = []
    remap = {}
    for i, t in enumerate(textures):
        if t is None:
            continue
        remap[i] = len(packed)
        packed.append(_resample_nearest(np.asarray(t, np.float32),
                                        resolution, resolution))
    if not packed:
        packed = [np.ones((resolution, resolution, 3), np.float32)]
    mat_tex = np.asarray([remap.get(t, -1) if t is not None and t >= 0
                          else -1 for t in material_texture_ids], np.int32)
    return TextureSet(atlas=torch.as_tensor(np.stack(packed, 0), device=dev),
                      material_texture=torch.as_tensor(mat_tex, device=dev))


def checker_texture(res: int = 128, tiles: int = 8,
                    c0=(0.9, 0.9, 0.9), c1=(0.2, 0.2, 0.2)) -> np.ndarray:
    """Procedural checkerboard (tests and benchmarks without assets)."""
    y, x = np.mgrid[0:res, 0:res]
    mask = ((x * tiles // res) + (y * tiles // res)) % 2 == 0
    img = np.where(mask[..., None], np.asarray(c0, np.float32),
                   np.asarray(c1, np.float32))
    return img.astype(np.float32)


def _to_linear(img: np.ndarray) -> np.ndarray:
    return srgb_to_linear(torch.as_tensor(img)).numpy()


def load_texture(path: str) -> np.ndarray:
    """An image file as a linear float texture: PPM natively, PNG and
    JPEG through Pillow (imported here, on use)."""
    if path.lower().endswith(".ppm"):
        return read_ppm_texture(path)
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return _to_linear(img)


def read_ppm_texture(path: str) -> np.ndarray:
    """A binary PPM (P6) as a linear float texture (sRGB-decoded)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P6":
            raise ValueError("only binary PPM (P6) supported")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(v) for v in line.split())
        maxval = int(f.readline())
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    img = data.reshape(h, w, 3).astype(np.float32) / maxval
    return _to_linear(img)
