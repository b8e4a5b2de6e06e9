"""The granular chute's inputs: the LAMMPS chute benchmark's scale
(``bench/in.chute``: 32,000 monodisperse particles in a dense layer
flowing down an incline), as a DEM user's Time series.

The bed is assumed, as the benchmark's data file is not in the
repository: 40 x 40 x 20 sites, each layer a triangular close-packed
lattice (spacing ``A_XY``) with its sites jittered by at most ``JITTER``,
the layers ``A_Z`` apart, so that no two unit spheres overlap in any file
and the solid fraction is about 0.56.  The layers flow along +x at a
speed that grows with height (a Bagnold-like profile), every particle of
a layer at its layer's speed, and roll about +y as they go.  The shapes
(the pile's three-sphere library), the shape ids drawn from ``POSE_SEED``,
the files, the frames and every writer are the pile's
(``gen/pile.py``).  numpy only.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from portbench.gen.pile import (  # noqa: F401  (the names the driver reads)
    ANIM_FPS, ANIM_TIMES, GROUND_ALBEDO, POSE_SEED, TIME_FOCAL, TIME_LIBRARY,
    library_shapes, write_anim_config, write_time_series,
)

N_PARTICLES = 32000
LATTICE = (40, 40, 20)          # sites along x, y and in height
A_XY = 2.06                     # in-layer spacing (diameter 2)
A_Z = 2.04                      # layer spacing
JITTER = (0.02, 0.015)          # largest in-layer and vertical jitter
V_TOP = 4.0                     # the top layer's speed along +x
Z0 = 1.05                       # the lowest layer's centres over the ground
GROUND = ((-70.0, -50.0, 0.0), (70.0, -50.0, 0.0), (70.0, 50.0, 0.0),
          (-70.0, 50.0, 0.0))
TIME_EYE = (76.0, -58.0, 62.0)  # the chute's camera, above the bed's corner
LOOK_AT = (2.0, 0.0, 8.0)


def bed_poses(n: int, times, seed: int = POSE_SEED) -> list:
    """The first ``n`` sites of the bed (layer by layer from the ground,
    row by row), per file f of ``times`` their pose dicts (pos, quat, vel,
    sid, ids, as ``pile.pile_poses`` gives them): shape ids, initial
    quaternions and the jitter drawn from ``seed``; the positions moved by
    their layer's velocity x times[f], the quaternions rolled about +y by
    the distance travelled (unit radius)."""
    nx, ny, nz = LATTICE
    if n > nx * ny * nz:
        raise ValueError(f"{n} particles exceed the bed's {nx * ny * nz} "
                         f"sites")
    gen = np.random.default_rng(seed)
    sid = gen.integers(0, len(TIME_LIBRARY), n)
    q0 = gen.normal(size=(n, 4))
    q0 /= np.linalg.norm(q0, axis=1, keepdims=True)
    k = np.arange(n)
    layer, row, col = k // (nx * ny), k // nx % ny, k % nx
    jxy = gen.uniform(-JITTER[0], JITTER[0], (n, 2))
    jz = gen.uniform(-JITTER[1], JITTER[1], n)
    x = (col + 0.5 * (row % 2) - 0.5 * nx) * A_XY + jxy[:, 0]
    y = (row - 0.5 * (ny - 1)) * A_XY * np.sqrt(3.0) / 2.0 + jxy[:, 1]
    z = Z0 + layer * A_Z + jz
    pos = np.stack([x, y, z], -1)
    h = (layer + 0.5) / nz
    speed = V_TOP * (1.0 - (1.0 - h) ** 1.5)
    vel = np.stack([speed, np.zeros(n), np.zeros(n)], -1)
    out = []
    for t in times:
        half = 0.5 * speed * t              # roll angle / 2 (radius 1)
        roll = np.stack([np.cos(half), np.zeros(n), np.sin(half),
                         np.zeros(n)], -1)
        out.append(dict(pos=pos + vel * t, quat=_qmul(roll, q0), vel=vel,
                        sid=sid, ids=np.arange(n)))
    return out


def _qmul(a, b):
    """Hamilton products of (n, 4) quaternions [w, x, y, z]."""
    aw, ax, ay, az = a.T
    bw, bx, by, bz = b.T
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], -1)


def min_gap(pos) -> float:
    """The smallest centre distance between two particles, minus the
    diameter 2 (negative: an overlap), over a grid of cells."""
    pos = np.asarray(pos, np.float64)
    cell = np.floor(pos / 2.2).astype(np.int64)
    key = {}
    for i, c in enumerate(map(tuple, cell)):
        key.setdefault(c, []).append(i)
    best = np.inf
    for c, members in key.items():
        near = [j for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                for dz in (-1, 0, 1)
                for j in key.get((c[0] + dx, c[1] + dy, c[2] + dz), ())]
        a = pos[members][:, None]
        b = pos[near][None]
        dist = np.linalg.norm(a - b, axis=-1)
        dist[np.asarray(members)[:, None] == np.asarray(near)[None]] = np.inf
        best = min(best, float(dist.min()))
    return best - 2.0


def camera_target():
    """The view point of the chute's camera: TIME_FOCAL from the eye
    toward LOOK_AT (the 48-degree view of the pile's camera)."""
    eye = np.asarray(TIME_EYE, np.float64)
    w = np.asarray(LOOK_AT, np.float64) - eye
    return eye + TIME_FOCAL * w / np.linalg.norm(w)


def write_chute_config(path, series, stl_dir, cache_dir, width: int,
                       height: int, fps: int, depth: int, **extra) -> Path:
    """The pile's Time config (``pile.write_anim_config``) over the
    chute's ground quad and from the chute's camera."""
    path = write_anim_config(path, series, stl_dir, cache_dir, width, height,
                             fps, depth, **extra)
    path.with_suffix(".ground.obj").write_text(
        "".join(f"v {x:g} {y:g} {z:g}\n" for x, y, z in GROUND)
        + "f 1 2 3\nf 1 3 4\n")
    cfg = json.loads(path.read_text())
    cfg["loop-data"]["camera-center"] = list(TIME_EYE)
    cfg["loop-data"]["camera-target"] = camera_target().tolist()
    path.write_text(json.dumps(cfg))
    return path
