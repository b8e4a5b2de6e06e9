"""Debug/validation mode: the ``debug-mode`` config flag (port of
``optix_ray_tracer_tpu/utils/debug.py``).

The reference maps ``debug-mode`` to validation layers (OptiX validation
mode, ``src/Global/RendererImpl.cu:14``).  Here, as in the JAX package,
it validates the acceleration structure on every build, refit and
rebuild: each triangle's box must lie inside its cluster's box.  The JAX
package also turns on ``jax_debug_nans``; PyTorch has no NaN trap for
forward code, so that half has no counterpart.  With the flag on, the
frontends take their per-frame loop and the plain marcher (no raster
tables), as the JAX package's do.
"""

from __future__ import annotations

import torch

from optix_ray_tracer_tpu_torch.utils.logging import LOG, RendererError

#: process-wide flag, set by :func:`enable_debug_mode`
DEBUG_MODE = False


def enable_debug_mode() -> None:
    """Turn on accel validation.  Idempotent."""
    global DEBUG_MODE
    if DEBUG_MODE:
        return
    DEBUG_MODE = True
    LOG.info("debug-mode: accel validation on")


def validate_clusters(clusters, tri_vertices, num_tris: int) -> None:
    """Raise :class:`RendererError` unless every valid triangle lies in
    its cluster's box (``clusters``: ops.sweep.ClusterSet;
    ``tri_vertices``: (T, 3, 3)).  One reduction on the clusters'
    device and one host read."""
    from optix_ray_tracer_tpu_torch.ops.sweep import CHUNK

    n_pad = clusters.prim_index.shape[0]
    C = n_pad // CHUNK
    tv = tri_vertices.float()
    sorted_tris = tv[clusters.prim_index.long()]
    valid = (torch.arange(n_pad, device=tv.device) < num_tris)[:, None]
    inf = torch.tensor(float("inf"), device=tv.device)
    lo = torch.where(valid, sorted_tris.amin(1), inf)
    hi = torch.where(valid, sorted_tris.amax(1), -inf)
    clo = lo.reshape(C, CHUNK, 3).amin(1)
    chi = hi.reshape(C, CHUNK, 3).amax(1)
    cmin, cmax = clusters.cluster_min, clusters.cluster_max
    empty = torch.isnan(cmin[:, 0])
    extent = (cmax[~torch.isnan(cmax)].max()
              - cmin[~torch.isnan(cmin)].min())
    eps = 1e-4 * torch.clamp(extent, min=1.0)
    # pure-padding groups inside a non-empty cluster reduce to +-inf
    ok = (((clo >= cmin - eps) & (chi <= cmax + eps)) | empty[:, None]
          | torch.isinf(clo))
    bad = int((~ok).sum())
    if bad:
        raise RendererError(
            f"accel validation failed: {bad} cluster-containment "
            f"violations (debug-mode)")
    LOG.debug("accel validation ok: %d clusters", C)


def maybe_validate_accel(intersector, scene) -> None:
    """Debug-mode hook of the frontends' intersector choice."""
    if not DEBUG_MODE or intersector is None:
        return
    from optix_ray_tracer_tpu_torch.ops.march import MarchIntersector

    if isinstance(intersector, MarchIntersector):
        validate_clusters(intersector.clusters, scene.triangles.vertices,
                          intersector.num_tris)
