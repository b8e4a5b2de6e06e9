"""The DEM pile as the Time frontend's contract defines each frame, worked
out from the benchmark's inputs: the pose files' arrays and the STL shapes.

Per file f of F with n frames, frame k: each particle's rotation is the
slerp of its quaternion toward the next file's by k / (n - 1), its
position moves by velocity x duration x k / n; the frame's triangles are
the shapes' vertices rotated and moved, followed by the static ground quad
and, for the path tracer, the emissive panel.  Particle i's albedo is the
viridis ramp at i / (count - 1).  Plain PyTorch and numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import Groups

VIRIDIS = ((0.00, (0.267, 0.004, 0.329)), (0.25, (0.283, 0.141, 0.458)),
           (0.50, (0.254, 0.265, 0.530)), (0.75, (0.196, 0.509, 0.364)),
           (1.00, (0.993, 0.906, 0.144)))

ROUGH, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3


def ramp(count: int) -> np.ndarray:
    """``count`` colours evenly spaced on the viridis stops, linear between
    the first stop at or above u and the one before it."""
    pos = np.asarray([s[0] for s in VIRIDIS], np.float32)
    col = np.asarray([s[1] for s in VIRIDIS], np.float32)
    u = np.arange(count, dtype=np.float32) / np.float32(max(count - 1, 1))
    hi = np.searchsorted(pos, u, side="left").clip(1, len(pos) - 1)
    lo = hi - 1
    t = np.clip((u - pos[lo]) / (pos[hi] - pos[lo]), 0.0, 1.0)[:, None]
    return (col[lo] * (1.0 - t) + col[hi] * t).astype(np.float32)


def face_normals(tris: np.ndarray) -> np.ndarray:
    """Geometric face normals of a closed shape (T, 3, 3), turned outward
    as a whole when most point inward."""
    t = tris.astype(np.float64)
    n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.divide(n, ln, out=np.zeros_like(n), where=ln > 1e-30)
    if ((n * (t.mean(1) - t.mean((0, 1)))).sum(-1) < 0).mean() > 0.5:
        n = -n
    return n.astype(np.float32)


def quad_tris(corners) -> np.ndarray:
    c = np.asarray(corners, np.float32)
    return np.stack([c[[0, 1, 2]], c[[0, 2, 3]]])


def slerp(q1, q2, t):
    """Shortest-arc slerp, normalised lerp where nearly parallel."""
    d = (q1 * q2).sum(-1, keepdim=True)
    q2 = torch.where(d < 0.0, -q2, q2)
    d = d.abs()
    lin = q1 + t[..., None] * (q2 - q1)
    mag = torch.sqrt((lin * lin).sum(-1, keepdim=True))
    nl = torch.where(mag > 0.0, lin / torch.clamp(mag, min=1e-30), lin)
    dc = torch.clamp(d, -1.0, 1.0)
    th0 = torch.arccos(dc)
    th = th0 * t[..., None]
    s0 = torch.sin(th0)
    s0 = torch.where(s0.abs() < 1e-12, torch.ones_like(s0), s0)
    sl = (torch.cos(th) - dc * torch.sin(th) / s0) * q1 + torch.sin(th) / s0 * q2
    return torch.where(d > 0.9995, nl, sl)


def rotation(q):
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-30)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def apply(rot, x):
    """rot (..., 3, 3) times x (..., 3), summed left to right."""
    return torch.stack([(rot[..., i, 0] * x[..., 0] + rot[..., i, 1] * x[..., 1])
                        + rot[..., i, 2] * x[..., 2] for i in range(3)], -1)


@dataclasses.dataclass
class Frame:
    """One frame's geometry: the caster's groups, per triangle its normal,
    material row and particle (-1 for the static extras), and the
    particles' poses at this frame and the one before."""
    groups: Groups
    normals: torch.Tensor
    material: torch.Tensor
    particle: torch.Tensor
    poses: tuple
    prev_poses: tuple


class Pile:
    """The pile's inputs on ``device``.  ``poses``: per file the generator's
    dict (pos, quat, vel, sid, ids); ``shapes``: the library's vertices per
    shape id; ``times``: the files' time stamps; ``fps``; ``panel``: None or
    (corners, radiance)."""

    def __init__(self, poses, shapes, times, fps: int, ground, ground_albedo,
                 panel, device):
        self.dev = device
        f32 = dict(dtype=torch.float32, device=device)
        self.pos = [torch.as_tensor(np.asarray(p["pos"], np.float32), **f32)
                    for p in poses]
        self.quat = [torch.as_tensor(np.asarray(p["quat"], np.float32), **f32)
                     for p in poses]
        self.vel = [torch.as_tensor(np.asarray(p["vel"], np.float32), **f32)
                    for p in poses]
        sid = np.asarray(poses[0]["sid"], np.int64)
        ids = np.asarray(poses[0]["ids"], np.int64)
        dur = [b - a for a, b in zip(times[:-1], times[1:])]
        self.durations = dur + dur[-1:]
        self.n_frames = [max(1, int(t * float(fps))) for t in self.durations]
        # the particles' triangles in particle order
        counts = np.asarray([len(v) for v in shapes], np.int64)
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        lib_v = np.concatenate([np.asarray(v, np.float32) for v in shapes])
        lib_n = np.concatenate([face_normals(np.asarray(v, np.float32))
                                for v in shapes])
        per = counts[sid]
        part = np.repeat(np.arange(len(sid)), per)
        within = np.arange(per.sum()) - np.repeat(np.cumsum(per) - per, per)
        lib = offs[sid[part]] + within
        self.lib_v = torch.as_tensor(lib_v[lib], **f32)
        self.lib_n = torch.as_tensor(lib_n[lib], **f32)
        self.part = torch.as_tensor(part, device=device)
        self.n_part = len(sid)
        # static extras: the ground, then the panel
        ex = [quad_tris(ground)]
        albedo = [ground_albedo]
        emission = [(0.0, 0.0, 0.0)]
        mtype = [ROUGH]
        ex_mat = [0, 0]
        if panel is not None:
            corners, radiance = panel
            ex.append(quad_tris(corners))
            albedo.append((0.0, 0.0, 0.0))
            emission.append(tuple(radiance))
            mtype.append(EMISSIVE)
            ex_mat += [1, 1]
        ex = np.concatenate(ex)
        n = np.cross(ex[:, 1] - ex[:, 0], ex[:, 2] - ex[:, 0])
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        self.ex_v = torch.as_tensor(ex, **f32)
        self.ex_n = torch.as_tensor(n, **f32)
        # material rows: the config's, then the particles' ramp
        base = len(albedo)
        self.albedo = torch.as_tensor(np.concatenate(
            [np.asarray(albedo, np.float32), ramp(len(sid))]), **f32)
        self.emission = torch.as_tensor(np.concatenate(
            [np.asarray(emission, np.float32),
             np.zeros((len(sid), 3), np.float32)]), **f32)
        self.mtype = torch.as_tensor(mtype + [ROUGH] * len(sid),
                                     dtype=torch.int64, device=device)
        self.material = torch.cat([
            torch.as_tensor(ids[part] + base, device=device),
            torch.as_tensor(ex_mat, device=device)])
        self.n_ex = self.ex_v.shape[0]

    def pose(self, fi: int, k: float):
        """(rotations (P, 3, 3), shifts (P, 3)) of file fi at frame k."""
        nxt = min(fi + 1, len(self.pos) - 1)
        n = self.n_frames[fi]
        f = lambda x: torch.tensor(x, dtype=torch.float32, device=self.dev)
        kk = f(np.float32(k))
        factor = torch.clamp(kk * f(np.float32(1.0 / max(n - 1, 1))), 0.0, 1.0)
        q = slerp(self.quat[fi], self.quat[nxt],
                  factor.expand(self.quat[fi].shape[:-1]))
        shift = self.pos[fi] + self.vel[fi] * (
            f(np.float32(self.durations[fi])) * kk
            * f(np.float32(1.0 / max(n, 1))))
        return rotation(q), shift

    def frame(self, fi: int, k: int) -> Frame:
        rot, shift = self.pose(fi, float(k))
        prev = self.pose(fi, float(max(k - 1.0, 0.0)))
        r = rot[self.part]
        v = apply(r[:, None], self.lib_v) + shift[self.part][:, None]
        tris = torch.cat([v, self.ex_v])
        normals = torch.cat([apply(r, self.lib_n), self.ex_n])
        group = torch.cat([self.part, self.n_part + torch.arange(
            self.n_ex, device=self.dev) // 2])
        groups = Groups.build(tris, group, self.n_part + self.n_ex // 2)
        particle = torch.cat([self.part, torch.full(
            (self.n_ex,), -1, dtype=torch.int64, device=self.dev)])
        return Frame(groups, normals, self.material, particle, (rot, shift),
                     prev)
