"""Roofline shares of the deep marcher kernels F2 and C2
(``csrc/block_march.cu``), from what each launch's wave holds: its rays,
the live ones among them and the scene's clusters, as
``drivers/chute_stream`` records them while a profiler traces the window
(the run's ``stats["deep_waves"]``).

A launch's floor is the least that any exact answer on its tables needs,
whatever the kernel chooses to test:

- bytes: every ray's bounds (t_min, t_max) read and its answer written, a
  live ray's origin and direction read too, and the hypercluster table
  read once;
- FP32 operations: each live ray's slab test of every hypercluster.  The
  tables have no level above the hyperclusters, so no exact answer can
  leave one untested; a slab test is SLAB_OPS operations, the count of
  PERF.md's kernel table.

Its time is the larger of the bytes at 3.35 TB/s and the operations at
67 TFLOP/s, so the share cannot pass 100%.  A ray is live where
t_min < t_max and its origin and direction are finite; every other ray's
answer is a miss without a test.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
GROUP = 8           # clusters a supercluster, superclusters a hypercluster
ROW_BYTES = 32      # one cull row [min3, max3, pad2]
SLAB_OPS = 26       # one (ray, box) slab entry
#: bytes of one ray's answer: F2's t and slot, C2's cluster id
ANSWER_BYTES = {"deep_warp_march_kernel": 8, "deep_probe_kernel": 4}


def hyperclusters(clusters: int) -> int:
    return -(-(-(-clusters // GROUP)) // GROUP)


def floor_s(kernel: str, rays: int, live: int, clusters: int) -> float:
    """Seconds of the floor of one launch of ``kernel`` on a wave of
    ``rays`` rays, ``live`` of them live, over ``clusters`` clusters."""
    top = hyperclusters(clusters)
    nbytes = (rays * (8 + ANSWER_BYTES[kernel]) + live * 24
              + top * ROW_BYTES)
    ops = live * top * SLAB_OPS
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS)


def share_pct(ctx, kernel: str):
    """100 x the mean floor of the recorded launches of ``kernel`` over
    the mean device time of its launches in the trace (matched by name);
    None where the kernel never ran or no launch was recorded."""
    trace = ctx["trace"]
    waves = ctx["stats"].get("deep_waves", {}).get(kernel)
    if trace is None or not waves:
        return None
    durs = [dur for name, _, dur in trace.device if kernel in name]
    if not durs:
        return None
    floor = sum(floor_s(kernel, *w) for w in waves) / len(waves)
    return 100.0 * floor * len(durs) / (sum(durs) / 1e6)
