"""Linear BVH over a primitive soup (port of
``optix_ray_tracer_tpu/ops/bvh.py``): the structural oracle beside the
cluster marcher, built on the device of the scene's tensors.

1. primitive AABBs and centroids;
2. 30-bit Morton codes of the centroids in the scene bounds;
3. a stable sort of the codes (``torch.sort(stable=True)``: the leaf
   order of ``jnp.argsort``);
4. the Karras hierarchy (HPG 2012): every internal node found on its own
   by longest-common-prefix searches, the key index breaking ties;
5. bottom-up box fitting by passes over all internal nodes, until none
   changes (at most 64).

Node layout (2n - 1 nodes): 0 .. n-2 internal, n-1 .. 2n-2 the leaves;
leaf k (node n-1+k) holds sorted primitive k.  Primitive ids: [0, S)
spheres, [S, S + T) triangles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optix_ray_tracer_tpu_torch.scene.geometry import Scene
from optix_ray_tracer_tpu_torch.utils.tensors import TensorDataclass
from optix_ray_tracer_tpu_torch.utils.vecmath import INF

_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class LBVH(TensorDataclass):
    """node_min / node_max (2n - 1, 3) boxes of every node; left / right
    (n - 1,) int32 child node ids; prim_index (n,) int32 sorted leaf ->
    primitive id."""
    node_min: torch.Tensor
    node_max: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    prim_index: torch.Tensor

    @property
    def num_prims(self) -> int:
        return self.prim_index.shape[0]


def _expand_bits_10(v):
    """Spread the low 10 bits of v (int64) so consecutive bits are 3 apart
    (uint32 arithmetic, wrapped in int64)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v & _MASK


def morton_codes(points, lo, hi):
    """30-bit Morton codes (int64) of (N, 3) points inside the box [lo, hi]."""
    extent = torch.clamp(hi - lo, min=1e-30)
    q = torch.clamp((points - lo) / extent, 0.0, 1.0)
    grid = torch.clamp((q * 1024.0).to(torch.int64), max=1023)
    return ((_expand_bits_10(grid[..., 0]) << 2)
            | (_expand_bits_10(grid[..., 1]) << 1)
            | _expand_bits_10(grid[..., 2]))


def scene_primitive_bounds(scene: Scene):
    """(mins, maxs, centroids), each (P, 3), of spheres then triangles."""
    parts_min, parts_max, parts_c = [], [], []
    if scene.sphere_count > 0:
        c = scene.spheres.centers
        r = scene.spheres.radii[..., None]
        parts_min.append(c - r)
        parts_max.append(c + r)
        parts_c.append(c)
    if scene.triangle_count > 0:
        v = scene.triangles.vertices
        parts_min.append(v.amin(1))
        parts_max.append(v.amax(1))
        # XLA's mean: the sum times the float32 reciprocal of the count
        parts_c.append((v[:, 0] + v[:, 1] + v[:, 2])
                       * np.float32(1.0 / 3.0))
    return (torch.cat(parts_min, 0), torch.cat(parts_max, 0),
            torch.cat(parts_c, 0))


def _clz32(x):
    """Leading zeros of uint32 values held in int64 (32 for 0)."""
    n = torch.zeros_like(x)
    for bits in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - bits))
        n = n + torch.where(small, bits, 0)
        x = torch.where(small, x << bits, x)
    return n + (x == 0).to(x.dtype)


def _delta_fn(codes, n: int):
    """delta(i, j): the common-prefix length of sorted keys i and j, each
    key conceptually extended by its index so that all are distinct
    (Karras sec. 4); -1 when j is out of range."""
    def delta(i, j):
        in_range = (j >= 0) & (j <= n - 1)
        j_c = torch.clamp(j, 0, n - 1)
        ci = codes[i]
        cj = codes[j_c]
        same = ci == cj
        x = torch.where(same, (i ^ j_c) & _MASK, ci ^ cj)
        d = torch.where(same, 32, 0) + _clz32(x)
        return torch.where(in_range, d, -1)
    return delta


def build_hierarchy(codes):
    """The Karras construction over sorted Morton codes (n >= 2): (left,
    right) int32 child node ids of the n - 1 internal nodes (< n - 1
    internal, >= n - 1 leaf)."""
    n = codes.shape[0]
    delta = _delta_fn(codes, n)
    i = torch.arange(n - 1, dtype=torch.int64, device=codes.device)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # an upper bound of the range length: double while the prefix holds
    lmax = torch.full_like(i, 2)
    for _ in range(32):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2,
                           lmax)
    # binary search of the range's other end j = i + l * d
    l = torch.zeros_like(i)
    for shift in range(1, 33):
        t = lmax >> shift
        cond = (t >= 1) & (delta(i, i + (l + t) * d) > delta_min)
        l = torch.where(cond, l + t, l)
    j = i + l * d
    delta_node = delta(i, j)

    # binary search of the split position
    s = torch.zeros_like(i)
    for shift in range(1, 33):
        t = (l + (1 << shift) - 1) >> shift       # ceil(l / 2^shift)
        cond = (t >= 1) & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(cond, s + t, s)
    gamma = i + s * d + torch.clamp(d, max=0)

    n_internal = n - 1
    left = torch.where(torch.minimum(i, j) == gamma, gamma + n_internal,
                       gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1,
                        gamma + 1 + n_internal, gamma + 1)
    return left.to(torch.int32), right.to(torch.int32)


def fit_aabbs(left, right, leaf_min, leaf_max, max_passes: int = 64):
    """Bottom-up boxes: each pass sets every internal node to the union of
    its children's current boxes; after depth passes the tree is exact.
    The augmented key is 62 bits long, so 64 passes always converge; the
    loop stops at the first pass that changes nothing."""
    n = leaf_min.shape[0]
    ni = n - 1
    dev = leaf_min.device
    node_min = torch.cat([torch.full((ni, 3), INF, device=dev), leaf_min])
    node_max = torch.cat([torch.full((ni, 3), -INF, device=dev), leaf_max])
    lft, rgt = left.long(), right.long()
    for _ in range(max_passes):
        new_min = torch.minimum(node_min[lft], node_min[rgt])
        new_max = torch.maximum(node_max[lft], node_max[rgt])
        changed = bool((new_min != node_min[:ni]).any()
                       | (new_max != node_max[:ni]).any())
        node_min = torch.cat([new_min, node_min[ni:]])
        node_max = torch.cat([new_max, node_max[ni:]])
        if not changed:
            break
    return node_min, node_max


def build_lbvh(prim_min, prim_max, centroids) -> LBVH:
    """The LBVH of (n, 3) primitive bounds and centroids, n >= 2."""
    codes = morton_codes(centroids, prim_min.amin(0), prim_max.amax(0))
    codes_sorted, order = torch.sort(codes, stable=True)
    left, right = build_hierarchy(codes_sorted)
    node_min, node_max = fit_aabbs(left, right, prim_min[order],
                                   prim_max[order])
    return LBVH(node_min=node_min, node_max=node_max, left=left,
                right=right, prim_index=order.to(torch.int32))


def build_scene_lbvh(scene: Scene) -> LBVH:
    return build_lbvh(*scene_primitive_bounds(scene))


def validate_lbvh(bvh: LBVH) -> dict:
    """Host-side structure checks: every leaf reached exactly once, every
    internal node at most once, every child box inside its parent's, and
    ``prim_index`` a permutation."""
    n = bvh.num_prims
    left = bvh.left.cpu().numpy()
    right = bvh.right.cpu().numpy()
    nmin = bvh.node_min.cpu().numpy()
    nmax = bvh.node_max.cpu().numpy()

    visits = np.zeros(2 * n - 1, np.int64)
    containment_ok = True
    stack = [0] if n > 1 else []
    while stack:
        node = stack.pop()
        visits[node] += 1
        if node < n - 1:
            for ch in (left[node], right[node]):
                containment_ok &= bool(
                    (nmin[node] <= nmin[ch] + 1e-5).all()
                    and (nmax[node] >= nmax[ch] - 1e-5).all())
                stack.append(int(ch))
    return dict(
        all_leaves_once=bool((visits[n - 1:] == 1).all()),
        internals_once=bool((visits[:n - 1] <= 1).all()),
        containment=containment_ok,
        permutation=bool(np.sort(bvh.prim_index.cpu().numpy()).tolist()
                         == list(range(n))),
    )
