#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (optix_ray_tracer_tpu_torch) on
one NVIDIA GPU.  From the repository root:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU or to the plain versions):

1. build the CUDA kernels from optix_ray_tracer_tpu_torch/csrc into
   build/kernels/;
2. check each hit-path kernel against its plain PyTorch version at the
   main path's shapes: A (tile raster) on the bench camera wave (g=4,
   gated on 8x4 pixel blocks of its 32x32 tiles) and the flipped
   point-light shadow wave (g=2, in the camera wave's tile order, so on
   8x4 blocks too), whole waves,
   t, slot, u, v and the Woop-tested rows per warp equal
   (:func:`raster_wave`); B (block march) and C (cluster probe, 388
   clusters) on 1M random rays and on the camera wave, on 65,536 rays
   (2,048 warps spread over the wave), with the hit rule (prim ids
   equal, or |dt| <= 1e-5 |t| + 1e-6) and no exceptions, C's ids
   exactly; resident warps per SM (the runtime's occupancy number) of
   A, B and C; B's Woop-tested rows per warp and Woop tests beside the
   ones the subset needs (:func:`needed_work`), C's box tests beside the
   ones its answers need (:func:`needed_probe_work`) and the flat
   scan's; A's Woop tests beside the per-ray gate's and the whole-tile
   gate's (the plain version gated on 1 and on 1,024 rays), the needed
   ones (:func:`needed_raster_work`) and the scheduled ones;
3. the bench step of bench.py: a 1024x1024 camera wave plus a point-light
   shadow wave over a 100k-triangle sphere, per-wave calibrated pair
   capacities, both exactness guards, timed with CUDA events (best of 5
   runs, each the mean of 5 back-to-back steps), and the incoherent
   1M-ray metric;
4. a 1024x1024, spp=4, depth-5 Whitted frame through wavefront.render with
   a raster-enabled MarchIntersector; the launch counts of A, B, C, H, J
   and O-U are zeroed just before and read just after it, and each must
   be > 0;
5. the Time scene (models/renderer_time.py): a 4,096-particle DEM pile of
   three sphere shapes as instances over a static ground quad, its TLAS
   library and pairs (<= 8192) and its flatten route (>= 3072 clusters, so
   coherent waves take kernel F);
6. kernels D (instanced tile raster: the 1024x1024 camera wave and a
   flipped point-light shadow wave in its tile order, gated on 8x4
   blocks, calibrated capacities, no overflow; whole waves, as A in
   phase 2),
   E (instanced block march: 1M incoherent rays inside the pile, nearest
   and any-hit, and the TLAS frame's own first bounce wave, captured from
   a depth-2 render of frame 0) and F (hierarchical block march: the
   flatten route's Morton-sorted camera wave through block_march's
   routing, nearest and any-hit, timed beside kernel B) against their
   plain versions on subsets (E: 8,192 rays, F: 16,384; warps spread
   over each wave), with the hit rule and no exceptions; E's and F's
   resident warps per SM, Woop-tested rows per warp and Woop tests run
   beside the ones the subset needs (:func:`needed_work`); and C on the
   flatten frame's own first bounce wave
   (3,368 clusters, captured from a depth-2 render of flatten frame 0),
   its ids against the plain version's on 65,536 rays spread over it;
7. the slice's main path: the camera wave's primary hits through both
   routes (counts zeroed, then D and F > 0; the hit rule on all but 1e-4
   of the rays), then frames 0 and 1 (poses refit between them) through
   the TLAS route and frame 0 through the flatten route at 1024x1024, spp
   4, depth 5 (counts zeroed before the TLAS frames, then D and E > 0);
   the TLAS and flatten images agree, both are finite, sky pixels are the
   background; the live share (t_max > t_min) of each bounce wave of
   the TLAS and flatten frames, as phase 4 prints the Whitted frame's;
8. the sweep path on the bench scene (388 clusters): kernel G (leaf
   sweep) against its plain version on the first pass's blocks of the 1M
   camera wave and the 1M incoherent wave (65,536-ray subsets, exact
   equality) and the live share of their lanes (t_min < best t);
   SweepIntersector on both full waves against the marcher's hits (the
   hit rule on all but 1e-5 of the rays, no ray active at the pass cap);
   then phase 4's frame through SweepIntersector (G's count zeroed
   before, > 0 after; the live share of G's lanes in each pass), held to
   phase 4's marcher frame;
9. the frame's tail on phase 4's frame: render_frame with the a-trous and
   the neural denoiser (committed weights), each against the same
   denoiser on the CPU copy of the frame, accumulated into a Film and
   written as PNGs;
10. the animation entry point, ``optix_ray_tracer_tpu_torch.__main__.main``
   on files this phase writes (:func:`animation_phase`): phase 5's pile
   as a Time series (three STL shapes, 3 pose VTK files, a manifest, a
   config at the reference's defaults: 1200x800, spp 1, depth 5,
   whitted, a-trous, temporal on, 4 frames per file) through the default
   route (flatten, fused: a host build on file 0, a device rebuild per
   file, a refit per frame), all 12 frames to PNGs, with the seconds of
   commit, the host build and the rebuilds ("median", and "morton" once
   beside it), the refit ms, the wall s/frame, the launches per frame
   of A-F (B, C, F > 0) and B's and F's device ms on each file's first
   and last frame; the same series through the TLAS route
   (``ORT_TIME_TLAS=1``, D, E > 0); with ``temporal`` off, flatten frame
   0 against TLAS frame 0 and the fused loop against the per-frame loop
   (``set_update_fn``) on frames 0-5, each pair > 2 LSB on < 1% of the
   channels; the flatten route's peak device bytes per packed triangle
   beside the TLAS route's; and Mesh mode (the pile as strip cells, 2
   files x 2 frames) baked through ``"cache": true``, then rendered.
   Every PNG shows the background on sky pixels;
11. the path tracer (:func:`path_phase`): (a) BASELINE config 5
   (``models/benchmarks.config5_sponza_class``: 110k triangles, 1920x1088,
   spp 4, depth 6, a checker floor, a sky with a sun and environment NEE)
   through ``benchmarks.run``, s/frame, spp/s, Mpaths/s and the launches
   of A, B and C per frame, held to the same frame without raster tables
   (B and C only; > 2 LSB on < 1% of channels); (b) config 4 (the
   Cornell box, NEE+MIS, 1024x1024, depth 8) at CORNELL_SPP of its 1024
   spp, spp/s; (c) phase 10's series with ``"integrator": "path"`` and an
   emissive panel over the pile (an EMISSIVE OBJ extra) through
   ``__main__.main``: the flatten route (camera waves to F, bounces C
   then B, the area-light NEE segments on bundle schedules through A),
   s/frame, the bundle pair counts against their capacity and the
   launches per frame; the same with a larger panel, whose NEE waves
   overflow the heuristic capacity and take the marcher; the TLAS route
   (D, E); flatten frame 0 against TLAS frame 0 with ``temporal`` off;
   (d) A's and D's ``common="dir"``
   variant on sun waves (config 5's sun) from the camera-wave hit points
   of phases 2 and 6, through ``intersect_from(mode="ortho")`` (counts
   zeroed, held to the marcher) and against their plain twins on the
   whole waves; (e) A on the first bundle NEE wave of (c) (captured
   through ``raster.BUNDLE_OBSERVERS``) against its plain twin on
   BUNDLE_BLOCKS blocks spread over it.  ``tools/kernel_bench.py
   --routes`` times the bundle route against the marcher on such waves;
12. the product extras (:func:`extras_phase`): (a) phase 11c's series and
   panel through ``__main__.main`` with ``"integrator": "restir"`` and
   ``"restir-gi"``, RESTIR_FLAT_FRAMES frames flattened (the per-frame
   loop) and RESTIR_TLAS_FRAMES through the TLAS route, s per
   ``render_frame`` and the launches per frame (B, C, F; E), flatten frame
   0 against TLAS frame 0 (> 2 LSB on < 1%); (b) config 4 through
   ``restir.render_restir_gi_progressive`` at CORNELL_SPP, spp/s beside
   the path tracer at pixel centers, the image means within 2%; (c)
   ``--progressive PROGRESSIVE_SPP`` on the pile's frame 0 (path, path
   ``--adaptive``, restir), straight and resumed from half, the PNGs and
   checkpoints bit-equal, s per batch; (d) phase 10's series fused with
   ``"sampler": "pcg"`` and ``"sobol"``, s/frame; (e) ``python -m
   optix_ray_tracer_tpu_torch --viewer`` in a subprocess at each of
   VIEWER_SIZES: fps over VIEWER_WINDOW seconds of /stream with /key,
   /look and /wheel sent during it, the encoder, /quit and exit code 0
   (its launches read from its log).  The in-process runs share each
   distinct scene's host SAH build (:func:`shared_builds`).
13. the parallel layer, the trainer and the LBVH (:func:`parallel_phase`):
   (a) phase 4's frame through ``parallel/sharding.render_sharded`` on
   meshes SHARD_MESHES of ``cuda:0`` repeated, s/frame and launches of A,
   B, C per mesh, each held to phase 4's image (> 2 LSB on < 1% of
   channels); (b) phase 10's series (SHARD_FRAMES frames, 1200x800)
   through ``__main__.main`` with and without ``--shard`` (the fused
   sharded route, 1x1) and through ``render_frames_sharded`` on a 4x1
   mesh of cuda:0, each held to the unsharded PNGs by the same rule; (c)
   ``render/train_denoiser``: the JAX package's synthetic test (three
   96x96 images, TRAIN_STEPS steps, batch 8, crop 48; neural > raw + 5
   dB), ms/step at batch 16, crop 64, and a reduced ``build_dataset``
   (96x96, 1 view, 2 procedural scenes, clean spp 64) trained
   DATASET_STEPS steps with its PSNR rows; (d) ``graft.entry``'s LBVH
   flagship step, ms and its camera wave's hits against brute force
   (hit rule, no exception);
14. the bounce loop's kernels (:func:`bounce_phase`): (a) H (PCG4D:
   ``rng.uniform4``, and its integer lanes, ``rng.pcg4d``) and I (Sobol-
   Owen: ``qmc.sobol_owen4``) on a 4M-id draw of phase 4's ids against
   their plain versions on the same CUDA tensors, exact; (b) J (the
   Whitted scatter) on phase 4's bounce-1 wave (4M rays, captured from a
   depth-2 render) under PCG and under Sobol against
   ``wavefront.scatter_plain``, exact, mismatches named by material and
   their largest ulp; (c) phase 4's frame, PCG then Sobol, by the kernels
   (counts zeroed, H and J, and I under Sobol, > 0) and by the plain
   versions called explicitly (:func:`twin_route`: no H-K launch),
   s/frame of each and the 2-LSB rule (< 1% of channels); (d) K (the
   path tracer's BSDF step) against ``pathtracer.bsdf_step_plain`` on
   the waves of a path frame of phase 4's scene with a DIELECTRIC and an
   EMISSIVE sphere added (ROUGH, METAL, DIELECTRIC and EMISSIVE hits and
   dead lanes; bounces 1 and 2, Russian roulette from 2) under PCG and
   under Sobol, and on config 5's bounce-1 wave, exact, mismatches named
   by material; (e) a config-4 frame (spp 4) under Sobol and a config-5
   frame by the kernels (counts zeroed, K-N and H or I > 0, no plain
   version called) and by the plain versions (no H-N launch), 0 channels
   > 2 LSB; (f) L, M and N (the path tracer's NEE samples, their
   shadowed contributions, the miss and emitter terms) against
   ``pathtracer.nee_sample_plain``, ``nee_add_plain`` and
   ``hit_radiance_plain`` on config 5's bounce-1 wave, config 4's under
   PCG and Sobol, the mixed scene of (d) with config 4's light table and
   config 5's sky (clamp NEE_CLAMP) and a ``restir_direct`` wave at
   bounces 0 and 1, exact.  Phase 11's config-5, config-4 and path-pile
   frames must launch K-N too;
15. the marcher's wave glue and the shading frame (:func:`glue_phase`):
   (a) O (coherence-sort keys), P (the sorted ray pack), Q (the hit
   record, unsorted, with u and v) and R (the shading frame) against
   ``march_glue.march_keys_plain``, ``gather_rays_plain``,
   ``finish_hits_plain`` and ``intersect.shading_frame_plain`` on every
   call of three waves, exact: phase 4's bounce-1 wave (probe: P, C, O,
   P, B, Q, then its shading frame), the flatten frame's camera wave
   (Morton: O, P, F, Q; its shading frame) and config 5's first env NEE
   shadow wave (any-hit; R on that frame's first shading frame); (b)
   each kernel's device ms per launch on phase 4's bounce-1 wave beside
   its bytes bound (:func:`glue_work`) and P's beside
   ``torch.index_select`` of the wave's prebuilt (R, 8) rows; (c) phase
   4's Whitted frame and config 5's frame by the kernels (counts zeroed,
   O-R > 0, no plain version of H-R called) and with O-R's twins called
   explicitly (:func:`glue_twin_route`: no O-R launch), max |diff| 0.
   Phase 4's frame must launch O-R too.
16. the raster binning (:func:`binning_phase`): (a) S (the projection
   basis and the window rects), T (block bounds and pair counts) and U
   (the sorted pair schedule) against ``binning.bin_basis_rects_plain``
   (``bin_basis_plain``, then ``bin_rects_plain``), ``bin_count_plain``
   and ``bin_emit_plain`` on every call of seven stages, exact: the bench
   camera wave (g 4), the same cut at two thirds of its pairs, the bench
   shadow wave (g 2), the TLAS camera wave (S on the pairs' boxes),
   config 5's first camera wave, the path pile's first bundle NEE wave
   (captured through ``raster.BUNDLE_OBSERVERS``) and one 1,024-ray block
   pairing every one of the flatten route's 13,472 windows at g 4 (U's
   long-row sort); (b) each kernel's device ms per launch on the bench
   camera wave, S's also on the TLAS camera wave (pairs) and S's, T's
   and U's on the path pile's first bundle NEE wave (boxes), beside its
   bound (:func:`binning_work`); (c) phase 4's
   Whitted frame, config 5's frame and the path pile's frame 0 by the
   kernels (counts zeroed, S-U > 0, no plain version of H-U called) and
   with S-U's twins called explicitly (:func:`binning_twin_route`),
   max |diff| 0.  Phase 3's bench step must launch S, T and U twice each.
17. the deep marchers past ``block_march.MAX_CLUSTERS`` (:func:`deep_phase`)
   at the chute cell's shapes: 16,900 spheres of 396 triangles (26,143
   clusters) built by the device median build; counts zeroed, a coherent
   and an incoherent wave through the intersector launch F2 and C2 and
   none of B, C and F; F2 on a Morton-sorted 1200x800 camera wave
   (nearest) and on a probe-sorted 960,000-ray incoherent wave, a third
   of it dead (nearest and any-hit), C2 on that wave, each timed whole and
   held to ``march_deep_plain`` / ``probe_deep_plain`` (and C2 to the flat
   ``probe_plain``) on SUBSET_DEEP rays spread over the wave, 0
   mismatches.  Their rows' bound: the bytes the wave's inputs and outputs
   take, or each live ray's slab test of every hypercluster (the level
   no exact answer can skip).

Every kernel's row in the kernels' JSON object is one whole main-path
wave (a subset would leave most of the card idle): A the bench camera
wave, B and E their 1M-ray incoherent waves, C the flatten frame's first
bounce wave, D the TLAS camera wave, F the flatten camera wave, G the
camera wave's first sweep pass; three more rows hold A's and D's "dir"
variant (phase 11's sun waves; launches: the variant's in its
``intersect_from(mode="ortho")`` runs, ``Kernel.variants``) and A on the
bundle NEE wave (launches: A's full-width launches in phase 11's path
animation); H and I are phase 14's 4M-id draw (H's uniforms), J phase
14's PCG bounce-1 wave (its error the larger of the PCG and Sobol
waves'), their launches those of phases 4, 12, 13 (b) and 14 (c) and
(e), K config 5's bounce-1 wave (its error the largest of (d)'s waves),
L, M and N config 5's bounce-1 wave (their errors the largest of (f)'s
waves), the launches of K-N those of phases 11, 12, 13 (b) and 14 (e);
O-R phase 4's bounce-1 wave (their errors the largest of phase 15 (a)'s
calls), their launches those of phases 4, 12, 13 (b) and 15 (c), their
bound the bytes each ray's own data and each table row it reads take;
S-U the bench camera wave (their errors the largest of phase 16 (a)'s
calls), their launches those of phases 4, 7, 10, 11, 12, 13 (b) and 16
(c), their bound the larger of the bytes each input and output takes
once and the operations of the wave's projections, of the tests its live
blocks (octants) need and of U's keys and sorts of the pairs it keeps
(:func:`binning_work`); four more rows hold S on the TLAS camera wave's
pairs and on the path pile's first bundle NEE wave's boxes, T and U on
that bundle wave (launches: their pair, box and bundle launches in those
phases, ``Kernel.variants``);
F2 (``block_march_deep``) and C2 (``probe_deep``) phase 17's incoherent
960,000-ray wave at the chute's shapes (F2's error the largest of its
three waves'), their launches those of phase 17's two routed waves;
their work the RNG's integer operations (:func:`sobol_ops`: the per-byte
table lookups) and J's to N's float operations per lobe or part
(:func:`scatter_ops`, :func:`bsdf_ops`, :func:`nee_work`,
:func:`add_work`, :func:`hit_work`), at the FP32 rate, their bytes those
each row needs (:func:`bsdf_bytes`, :func:`row_bytes`), their time the
kernel's device time per launch in a profiler trace (:func:`device_ms`:
a wrapper call's host work outlasts them). It
carries the kernel's launches on the main paths (phases 4, 7, 8, 10, 11, 12 and 13), its error against its plain
version,
the whole wave's time, the plain version's time on what it compared (A,
D: the whole wave), and the bound: the larger of the bytes the wave's
inputs and outputs take over 3.35 TB/s and the float operations its
answers need over 67 TFLOP/s FP32, the H100 SXM's published peaks. The
work is counted from this run's data, whatever the kernel did: A and D
:func:`needed_raster_work` on the whole wave (live rays only, each to its
nearest hit, an occlusion ray to its first hit in the kernel's visit
order; a Woop test at
WOOP_SHARED_ORIGIN_OPS: the tile shares its origin; WOOP_SHARED_DIR_OPS
for "dir", its direction; WOOP_OPS on the bundle wave), C
:func:`needed_probe_work` on the whole wave, B, E and F
:func:`needed_work` on the subset scaled by the rays of the wave over
the subset's (its warps spread evenly over the wave), G every (ray, row)
test of the pass's live lanes (t_min < best t: a filler lane of a window
group or a dead ray accepts no row). The last two lines of standard
output are the kernels' JSON object and the device JSON object.
``tools/prof_port.py`` profiles the same cells through
:func:`bench_setup`, :func:`bench_step`, :func:`whitted_setup`,
:func:`time_setup`, :func:`time_frame` and :func:`tail_setup`;
``tools/kernel_bench.py`` times the kernels on the same waves through
:func:`b_waves`, :func:`e_waves`, :func:`coherent_wave`,
:func:`first_pass_blocks`, :func:`flatten_bounce_wave` and
:func:`tlas_shadow_wave`.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

N_TRIS = 100_000
WIDTH = HEIGHT = 1024
SPP = 4
DEPTH = 5
TILE = 32
REPS = 5
TRACE_TRIES = 3   # trace windows device_ms takes before it gives up
SUBSET = 65_536
LIGHT = (3.0, 3.0, 3.0)
SKY = (218, 232, 244)     # sRGB of the default background (0.7, 0.8, 0.9)
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
# the Time scene (phases 5-7)
N_PARTICLES = 4096
TIME_LIBRARY = (80, 200, 450)      # sphere shapes of 60, 168, 396 triangles
TIME_EYE = (45.0, 3.0, 5.0)
TIME_FOCAL = 2.25                  # view axis length: a 48-degree view
TIME_LIGHT = (30.0, 20.0, 40.0)
TIME_DURATION = 1.0
TIME_FRAMES = 2
SUBSET_TIME = 16_384
SUBSET_E = 8_192          # the plain E visits every pair: the slowest twin
SUBSET_DEEP = 8_192       # F2's and C2's plain twins walk every level
F_SEGMENT = 40.0          # t_max of F's occlusion (any-hit) camera wave
SWEEP_HIT_EXCEPTIONS = 1e-5   # sweep vs marcher: allowed share of rays
# card vs CPU, relative: tests/test_torch_denoise.py's tolerances
DENOISE_RTOL = {"atrous": 8e-6, "neural": 2.4e-5}
# the bound: float operations per unit of work (a compare, abs or negate
# counts as one) over the H100 SXM's published peaks
WOOP_OPS = 47     # one (ray, triangle) Woop test: projections, t, u, v, test
# the same test when the tile shares its origin: the row's three
# o-projections (18 operations) are the tile's, computed once per row
WOOP_SHARED_ORIGIN_OPS = WOOP_OPS - 18
# ... or its direction: the row's three d-projections (15 operations)
WOOP_SHARED_DIR_OPS = WOOP_OPS - 15
SLAB_OPS = 26     # one (ray, box) slab entry
INST_OPS = 33     # one ray moved into an instance's space
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
CHUNK = 256       # triangles per cluster (ops/sweep.CHUNK)
#: the kernels by letter, filled in by main(); "t" and "u" are T's and
#: U's launches on bundle waves (:class:`VariantCount`)
K: dict = {}


class VariantCount:
    """One variant's launches of a kernel (its ``Kernel.variants`` entry,
    zeroed with the kernel's counts), read as a row of its own."""

    def __init__(self, kernel, variant: str, name: str):
        self.kernel, self.variant, self.name = kernel, variant, name

    @property
    def launches(self) -> int:
        return self.kernel.variants.get(self.variant, 0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` back-to-back calls after one warm-up call, by
    CUDA events on the current stream."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor among ``objs`` (dicts, tuples and lists are
    searched), each counted once."""
    import torch
    seen, total = set(), 0
    stack = list(objs)
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor) and x.data_ptr() not in seen:
            seen.add(x.data_ptr())
            total += x.numel() * x.element_size()
    return total


def needed_ops(work: dict) -> int:
    """Float operations of ``block_march.needed_work``'s counts."""
    return (work["slab"] * SLAB_OPS + work["inst"] * INST_OPS
            + work["woop"] * WOOP_OPS)


def march_work(label: str, visits, work: dict) -> None:
    """Print a warp marcher's Woop tests (its per-warp Woop-tested rows x
    32 lanes) beside the ones the answers need."""
    run = int(visits.sum()) * 32
    print(f"    {label}: {visits.float().mean().item():.1f} Woop-tested "
          f"rows per warp; Woop tests run {run} vs needed {work['woop']} "
          f"({run / max(work['woop'], 1):.2f}x); needed slab tests "
          f"{work['slab']}, ray transforms {work['inst']}")


def warp_rays(R: int, n: int):
    """Indices of n rays: n // 32 warps spread evenly over R rays."""
    import torch
    starts = torch.linspace(0, R // 32 - 1, n // 32).round().long() * 32
    return (starts[:, None] + torch.arange(32)).reshape(-1)


def row(err: float, ms: float, plain_ms: float, io_bytes: int,
        ops: float, ms_by: str = "cuda events") -> dict:
    """A kernel's JSON row from its measurements and its work: the bound
    is the larger of bytes over the memory rate and operations over the
    FP32 rate; ``ms_by`` says how ``ms`` was timed (:func:`time_ms`'s
    "cuda events", or :func:`device_ms`'s method)."""
    t_bytes = io_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None, ms_by=ms_by)


def wave_row(name: str, err: float, full_ms: float, plain_ms: float,
             io_bytes: int, work: dict, n_sub: int, n_full: int) -> dict:
    """A marcher's JSON row for a whole wave: its time, and the bound of
    its bytes and of the needed work of a subset of ``n_sub`` of its
    ``n_full`` rays (warps spread evenly over the wave) scaled to the
    wave; ``plain_ms`` is the plain version's on the subset."""
    r = row(err, full_ms, plain_ms, io_bytes,
            needed_ops(work) * n_full / n_sub)
    print(f"    {name}: full-wave bound {r['bound_ms']:.4f} ms, by "
          f"{r['bound_by']} (needed work scaled {n_full / n_sub:.0f}x from "
          f"the subset), {100 * r['bound_ms'] / full_ms:.2f}% of the "
          f"{full_ms:.3f} ms wave")
    return r


def raster_wave(name: str, call, plain, inp: dict, W: int, any_hit: bool,
                keys, card: str, common: str | None = "origin",
                woop_ops: int = None) -> dict:
    """A raster kernel (A or D: ``call``, its plain version ``plain``) in
    its ``common`` variant on one whole schedule ``inp`` of a wave in W-ray
    tiles in ``raster.to_tiles`` order (a warp's 32 rays are an 8x4 pixel
    block):
    the kernel against its plain version on the whole wave (0 mismatches,
    max |dt|, |du|, |dv| 0, the same Woop-tested rows per warp), its
    time, and its Woop tests beside the per-ray gate's and the whole-tile
    gate's (the kernels' first, CTA-wide design) from the plain version,
    the needed ones (:func:`needed_raster_work`) and the scheduled ones.
    Returns the JSON row: the bound counts the needed work at ``woop_ops``
    per Woop test (default: WOOP_SHARED_ORIGIN_OPS)."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
    woop_ops = woop_ops or WOOP_SHARED_ORIGIN_OPS
    args = dict(w=W, any_hit=any_hit, common=common)
    kern = call(**inp, **args, visits=True)
    ms = time_ms(lambda: call(**inp, **args), REPS)
    ref, p_ms = time_once(lambda: plain(**inp, **args, visits=True))
    err = compare(name, keys, kern, ref, any_hit)
    duv = max(float((kern[i] - ref[i]).abs().max()) for i in (2, 3))
    run, twin = (int(x[4].sum()) * 32 for x in (kern, ref))
    rows_equal = bool(torch.equal(kern[4], ref[4]))
    print(f"    max |du|, |dv| {duv:.3g}; Woop-tested rows per warp equal: "
          f"{rows_equal}")
    if err or duv or not rows_equal:
        raise AssertionError(f"{name}: kernel and plain version differ")
    per_ray = int(tr._raster_plain(inp, W, any_hit, common, 1)[4].sum())
    tile = int(tr._raster_plain(inp, W, any_hit, common, W)[4].sum()) * W
    # the needed work: live rays, each to its nearest hit (an occlusion
    # ray to its first hit in the kernel's visit order)
    work = tr.needed_raster_work(inp, W, kern[0], kern[1], any_hit=any_hit)
    n_pairs = int((inp["pair_tiles"] < inp["n_blocks"]).sum())
    g = inp.get("granularity", 1)
    scheduled = n_pairs * W * (CHUNK // g)
    r = row(err, ms, p_ms, tensor_bytes(inp, kern),
            work["slab"] * SLAB_OPS + work["inst"] * INST_OPS
            + work["woop"] * woop_ops)
    print(f"    {name}: {inp['n_blocks']} tiles of {W} rays, {n_pairs} "
          f"pairs, warps of 8x4-pixel blocks; kernel {ms:.3f} ms [{card}], "
          f"plain {p_ms:.1f} ms; "
          f"{tr.raster_occupancy('pair_insts' in inp, any_hit, common)} "
          f"resident warps per SM")
    print(f"    {name}: Woop tests run {run} (plain {twin}), per-ray gate "
          f"{per_ray} ({run / max(per_ray, 1):.3f}x), whole-tile gate "
          f"{tile} ({tile / max(run, 1):.2f}x run), needed {work['woop']}, "
          f"scheduled {scheduled}; slab tests {work['slab']}, ray "
          f"transforms {work['inst']}; bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}, {100 * r['bound_ms'] / ms:.2f}% of the wave")
    return r


def prim_keys(clusters):
    """slot -> triangle id (-1 for a miss) of a flat ClusterSet."""
    import torch
    return lambda s: torch.where(
        s < 0, -1, clusters.prim_index[s.clamp(min=0).long()])


def compare(name: str, keys, kern, plain, any_hit: bool) -> float:
    """Hold a kernel's (t, slot) against its plain version's: hit/miss for
    occlusion waves, the hit rule on the hit identities ``keys(slot)``
    otherwise.  Returns max |dt| over rays both hit (0 for occlusion
    waves, whose t is the -INF hit marker)."""
    from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
    tk, sk = kern[0].reshape(-1), kern[1].reshape(-1)
    tp, sp = plain[0].reshape(-1), plain[1].reshape(-1)
    if any_hit:
        bad = int(((sk >= 0) != (sp >= 0)).sum())
        err = 0.0
    else:
        bad = hit_mismatches(keys(sk), tk, keys(sp), tp)
        both = (sk >= 0) & (sp >= 0)
        err = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
    print(f"  {name}: {bad} mismatches of {sk.numel()} rays (slots "
          f"identical on {int((sk == sp).sum())}, {int((sk >= 0).sum())} "
          f"hits), max |dt| {err:.3g}")
    if bad:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version on {bad} rays")
    return err


def build_kernels() -> None:
    """Phase 1: build (or load) the kernel library and report ptxas."""
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    t0 = time.perf_counter()
    _lib.load()
    nvcc = ("cached" if _lib.build_seconds is None
            else f"nvcc {_lib.build_seconds:.2f} s")
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"({nvcc})")
    for line in (_lib.build_log or "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def bench_setup(device) -> SimpleNamespace:
    """bench.py's scene, camera wave (in tile order), point-light shadow
    wave (as the flipped occlusion wave intersect_from traces), per-wave
    calibrated pair capacities and the 1M incoherent rays."""
    import torch

    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops.march import (
        DEFAULT_ANYHIT_GRANULARITY, DEFAULT_GRANULARITY,
        make_march_intersector,
    )
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, Spheres, Triangles,
    )

    v, n = sphere_with_n_triangles(N_TRIS)
    scene = Scene(Spheres.empty(device), Triangles.from_arrays(v, n,
                                                               device=device))
    t0 = time.perf_counter()
    inter = make_march_intersector(scene, raster=True)
    print(f"[scene] {scene.triangle_count} triangles, "
          f"{inter.clusters.num_clusters} clusters (host SAH build "
          f"{time.perf_counter() - t0:.2f} s)")
    cs = inter.clusters
    cam = Camera.look_at((3.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=device)
    o, d = (raster.to_tiles(x.reshape(-1, 3), 1, HEIGHT, WIDTH, TILE, TILE)
            for x in cam.generate_rays(WIDTH, HEIGHT))
    R = o.shape[0]
    light = torch.tensor(LIGHT, device=device)
    G, GS = DEFAULT_GRANULARITY, DEFAULT_ANYHIT_GRANULARITY
    tmin0 = torch.full((R,), 1e-3, device=device)
    tmax_inf = torch.full((R,), 1e16, device=device)
    pc1 = raster.measure_pair_count(inter.raster, cs, o, d, tmin0, tmax_inf,
                                    "origin", o[0], granularity=G)
    hit0 = inter.intersect_from(scene, o, d, mode="origin", point=o[0])
    p0 = torch.where(hit0.is_hit[:, None], o + hit0.t[:, None] * d, o)
    dist0 = torch.linalg.norm(light - p0, dim=-1)
    wl0 = (light - p0) / torch.clamp(dist0[:, None], min=1e-6)
    # the flipped occlusion wave intersect_from traces (from the light)
    so0 = light.expand(R, 3).contiguous()
    sd0 = -wl0
    d0 = ((light - (p0 + wl0 * 1e-3)) * wl0).sum(-1)
    s_tmin, s_tmax = d0 - dist0, d0 - 1e-3
    pc2 = raster.measure_pair_count(inter.raster, cs, so0, sd0, s_tmin,
                                    s_tmax, "origin", light, granularity=GS)
    pc_max1, pc_max2 = raster.round_pc_max(pc1), raster.round_pc_max(pc2)
    print(f"[calibrate] primary g={G}: {pc1} pairs -> pc_max {pc_max1}; "
          f"shadow g={GS}: {pc2} pairs -> pc_max {pc_max2}")

    gen = np.random.default_rng(11)
    oi = torch.as_tensor(gen.uniform(-0.9, 0.9, (R, 3)).astype(np.float32),
                         device=device)
    di = gen.normal(size=(R, 3)).astype(np.float32)
    di /= np.linalg.norm(di, axis=-1, keepdims=True)
    di = torch.as_tensor(di, device=device)
    return SimpleNamespace(
        scene=scene, inter=inter, cs=cs, o=o, d=d, R=R, light=light,
        tmin0=tmin0, tmax_inf=tmax_inf, shadow=(so0, sd0, s_tmin, s_tmax),
        pc_max1=pc_max1, pc_max2=pc_max2, oi=oi, di=di)


def bench_step(b: SimpleNamespace):
    """bench.py's step: the camera wave, then the point-light shadow wave
    from its hit points, each at its calibrated pair capacity."""
    import torch
    hit = b.inter.intersect_from(b.scene, b.o, b.d, mode="origin",
                                 point=b.o[0], pc_max=b.pc_max1)
    point = torch.where(hit.is_hit[:, None], b.o + hit.t[:, None] * b.d, b.o)
    to_light = b.light - point
    dist = torch.linalg.norm(to_light, dim=-1, keepdim=True)
    wl = to_light / torch.clamp(dist, min=1e-6)
    # the shadow rays keep the camera wave's tile order
    shadowed = b.inter.any_hit_from(
        b.scene, point + wl * 1e-3, wl, mode="target", point=b.light,
        t_max=dist[:, 0], pc_max=b.pc_max2)
    return hit.t, shadowed


def b_waves(b: SimpleNamespace) -> dict:
    """Kernel B's 1M-ray waves of the bench scene, sorted as the marcher
    sorts them: label -> (march_call arguments, the unsorted (o, d))."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.march import ray_probe_keys
    from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys
    waves = {
        "incoherent": (b.oi, b.di, ray_probe_keys(b.cs, b.oi, b.di, b.tmin0,
                                                  b.tmax_inf), False),
        "camera": (b.o, b.d, ray_sort_keys(b.o, b.d, b.inter.scene_lo,
                                           b.inter.scene_hi), True)}
    out = {}
    for label, (wo, wd, keys, coherent) in waves.items():
        perm = torch.argsort(keys, stable=True)
        out[label] = (bm.march_inputs(b.cs, wo[perm], wd[perm], b.tmin0,
                                      b.tmax_inf, coherent), (wo, wd))
    return out


def e_waves(t: SimpleNamespace, inter) -> dict:
    """Kernel E's 1M-ray waves: random rays inside the particle cloud,
    Morton-sorted as the TLAS marcher sorts them, nearest (t_max INF) and
    occlusion (t_max 2): any_hit -> march_instanced_call arguments."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys
    R, dev = t.o.shape[0], t.device
    gen = np.random.default_rng(11)
    oi = torch.as_tensor(gen.uniform(-15, 15, (R, 3)).astype(np.float32),
                         device=dev)
    di = gen.normal(size=(R, 3)).astype(np.float32)
    di = torch.as_tensor(di / np.linalg.norm(di, axis=-1, keepdims=True),
                         device=dev)
    perm = torch.argsort(ray_sort_keys(oi, di, inter.scene_lo,
                                       inter.scene_hi), stable=True)
    return {any_hit: bm.march_instanced_inputs(
        inter.pair_min, inter.pair_max, inter.sub_min, inter.sub_max,
        inter.pair_shape, inter.pair_inst, inter.inst_rows,
        inter.library.woop_t, oi[perm], di[perm], t.tmin,
        torch.full((R,), 2.0 if any_hit else 1e16, device=dev))
        for any_hit in (False, True)}


def check_kernels(b: SimpleNamespace) -> dict:
    """Phase 2: each kernel against its plain version at the main path's
    shapes; returns {name: JSON row (see :func:`row`)}."""
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
    from optix_ray_tracer_tpu_torch.ops.march import (
        DEFAULT_ANYHIT_GRANULARITY, DEFAULT_GRANULARITY,
    )

    print(f"[kernels vs plain] hit rule, no exceptions, C's ids exactly; "
          f"A on the whole waves; B, C on {SUBSET} rays (warps spread over "
          f"the wave)")
    cs, R = b.cs, b.R
    W = TILE * TILE
    rows = {}

    def raster_case(label, S, g, any_hit):
        return raster_wave(f"A {label}", tr.raster_cluster_call,
                           tr.raster_cluster_plain,
                           raster.schedule_inputs(cs, S, S["nb"], g), W,
                           any_hit, prim_keys(cs), b.card)

    G, GS = DEFAULT_GRANULARITY, DEFAULT_ANYHIT_GRANULARITY
    S1 = raster._coarse_stage(b.inter.raster, cs, b.o, b.d, b.tmin0,
                              b.tmax_inf, "origin", b.o[0], W, b.pc_max1, G)
    S2 = raster._coarse_stage(b.inter.raster, cs, *b.shadow, "origin",
                              b.light, W, b.pc_max2, GS)
    r1 = raster_case("camera wave", S1, G, False)
    r2 = raster_case("shadow wave", S2, GS, True)
    rows["tile_raster"] = dict(r1, max_abs_err=max(r1["max_abs_err"],
                                                   r2["max_abs_err"]))

    march_rows = []
    print(f"  B: {bm.march_occupancy()} resident warps per SM (occupancy)")
    for label, (inp, (wo, wd)) in b_waves(b).items():
        full = bm.march_call(**inp)
        full_ms = time_ms(lambda: bm.march_call(**inp), REPS)
        pick = warp_rays(inp["rays"].shape[1], SUBSET).to(b.o.device)
        sub = dict(inp, rays=inp["rays"][:, pick].contiguous())
        plain_args = {k: v for k, v in sub.items() if k != "w"}
        kern = bm.march_call(**sub)
        plain = bm.march_plain(**plain_args, any_hit=False)
        err = compare(f"B {label}", prim_keys(cs), kern, plain, False)
        ms = time_ms(lambda: bm.march_call(**sub), REPS)
        p_ms = time_ms(lambda: bm.march_plain(**plain_args,
                                               any_hit=False), 1)
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms "
              f"on {SUBSET} rays; full wave ({R} rays, W={inp['w']}, "
              f"n_subs={inp['n_subs']}) {full_ms:.3f} ms, "
              f"{full[2].float().mean().item() / CHUNK:.2f} cluster-"
              f"equivalent visits per warp")
        work = bm.needed_work(sub["rays"], *plain, sub["boxes"],
                              sub["sub_boxes"], inp["n_clusters"],
                              inp["n_subs"])
        march_work(f"{label} subset", kern[2], work)
        march_rows.append(wave_row(f"B {label}", err, full_ms, p_ms,
                                   tensor_bytes(inp, full), work,
                                   SUBSET, inp["rays"].shape[1]))

        probe_case(f"C {label}", bm.probe_inputs(cs, wo, wd, b.tmin0,
                                                 b.tmax_inf), b.card)
    rows["block_march"] = dict(march_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in march_rows))
    return rows


def probe_case(label: str, pin: dict, card: str) -> dict:
    """Kernel C on the wave ``pin`` (``probe_call``'s arguments): its ids
    against the plain version's on SUBSET rays spread over the wave (0
    mismatches), the whole wave timed, its live share (t_max > t_min),
    and the box tests the kernel ran beside the ones the answers need
    (:func:`needed_probe_work`) and the flat scan's.  Returns the whole
    wave's JSON row."""
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    rays = pin["rays"]
    R, C = rays.shape[1], pin["n_clusters"]
    pick = warp_rays(R, SUBSET).to(rays.device)
    psub = dict(pin, rays=rays[:, pick].contiguous())
    kern = bm.probe_call(**psub)[0]
    plain, p_ms = time_once(lambda: bm.probe_plain(**psub))
    bad = int((kern != plain).sum())
    print(f"  {label}: {bad} id mismatches of {SUBSET} rays spread over the "
          f"wave ({int((plain < pin['c_pad']).sum())} entered a cluster)")
    if bad:
        raise AssertionError(f"{label}: {bad} ids differ")
    ids, tests = bm.probe_call(**pin)
    ms = time_ms(lambda: bm.probe_call(**pin), REPS)
    work = bm.needed_probe_work(rays, ids, pin["boxes"], C)
    live = int((rays[7] > rays[6]).sum())
    run = int(tests)
    print(f"    {label}: full wave {R} rays, live share {live / R:.4f}, {C} "
          f"clusters: kernel {ms:.3f} ms [{card}], plain {p_ms:.1f} ms "
          f"on the subset; box tests run {run} vs needed {work['slab']} "
          f"({run / max(work['slab'], 1):.2f}x) vs the flat scan's "
          f"{work['flat']}; {bm.probe_occupancy()} resident warps per SM")
    return row(0.0, ms, p_ms, tensor_bytes(pin, ids),
               work["slab"] * SLAB_OPS)


def bench(b: SimpleNamespace, card: str) -> None:
    """Phase 3: both exactness guards, the no-overflow check and the
    bench's two rates."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.intersect import (
        hit_mismatches, intersect_scene_bruteforce,
    )
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib

    gen7 = np.random.default_rng(7)
    og = torch.as_tensor(gen7.uniform(-1.5, 1.5, (1024, 3)).astype(
        np.float32), device=b.o.device)
    dg = gen7.normal(size=(1024, 3)).astype(np.float32)
    dg /= np.linalg.norm(dg, axis=-1, keepdims=True)
    dg = torch.as_tensor(dg, device=b.o.device)
    h1 = b.inter.intersect(b.scene, og, dg)
    h2 = intersect_scene_bruteforce(b.scene, og, dg)
    bad = int((h1.prim_id != h2.prim_id).sum())
    if bad:
        raise AssertionError(f"bench exactness guard: {bad}/1024 prim ids "
                             f"differ from the brute-force oracle")
    print("[bench] exactness: 1024/1024 prim ids match the oracle")
    o, d = b.o[:1024], b.d[:1024]
    h_r = b.inter.intersect_from(b.scene, o, d, mode="origin", point=b.o[0])
    h_o = intersect_scene_bruteforce(b.scene, o, d)
    bad = hit_mismatches(h_r.prim_id, h_r.t, h_o.prim_id, h_o.t)
    flips = int((h_r.prim_id != h_o.prim_id).sum())
    if bad:
        raise AssertionError(f"raster exactness guard: {bad}/1024")
    print(f"[bench] raster exactness: {1024 - flips}/1024 prim ids match "
          f"the oracle ({flips} fp-tie flips)")

    for k in _lib.KERNELS:
        k.launches = 0
    bench_step(b)
    torch.cuda.synchronize()
    binned = [k.launches for k in (_lib.BIN_RECTS, _lib.BIN_COUNT,
                                   _lib.BIN_EMIT)]
    if _lib.TILE_RASTER.launches != 2 or _lib.BLOCK_MARCH.launches != 0:
        raise AssertionError(
            f"bench step: raster launches {_lib.TILE_RASTER.launches} "
            f"(want 2), march launches {_lib.BLOCK_MARCH.launches} (want 0: "
            f"a schedule overflowed)")
    if binned != [2, 2, 2]:
        raise AssertionError(f"bench step: S, T, U launches {binned} (want "
                             f"2 each: one binning a wave)")
    print("[bench] both waves ran the raster kernel without overflow, each "
          "binned by S, T and U")
    dt = min(time_ms(lambda: bench_step(b), REPS) for _ in range(5))
    mrays = 2 * b.R / (dt * 1e-3) / 1e6
    inc = b.inter.for_incoherent()
    dti = min(time_ms(lambda: inc.intersect(b.scene, b.oi, b.di).t, REPS)
              for _ in range(5))
    mrays_inc = b.R / (dti * 1e-3) / 1e6
    print(f"[bench] primary+shadow: {mrays:.2f} Mrays/s ({dt:.3f} ms/step) "
          f"[{card}]")
    print(f"[bench] incoherent: {mrays_inc:.2f} Mrays/s ({dti:.3f} ms per "
          f"{b.R}-ray wave) [{card}]")


def whitted_setup(v, n, device):
    """The Whitted scene: the sphere mesh (METAL, fuzz 0.05) over a ROUGH
    ground quad, camera (3, 0, 0.5) -> origin.  Returns (scene, materials,
    camera, raster-enabled MarchIntersector) on ``device``."""
    from optix_ray_tracer_tpu_torch.io.meshgen import quad
    from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, Spheres, Triangles,
    )
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    mb = MaterialBuilder()
    metal = mb.add_metal((0.8, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.70, 0.60, 0.50))
    qv, qn = quad((-6, -6, -1), (6, -6, -1), (6, 6, -1), (-6, 6, -1))
    scene = Scene(Spheres.empty(device),
                  Triangles.from_arrays(v, n, metal, device=device).concat(
                      Triangles.from_arrays(qv, qn, ground, device=device)))
    cam = Camera.look_at((3.0, 0.0, 0.5), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         device=device)
    return (scene, mb.build(device), cam,
            make_march_intersector(scene, raster=True))


def whitted(device, card: str):
    """Phase 4: the main path.  A 64x64 frame on the card is first held
    against the same call on CPU tensors (the plain versions); then the
    full frame runs with the launch counts zeroed just before it.  Returns
    the counts and the frame (scene, materials, camera, marcher, seed,
    image, albedo, normal, sRGB frame) for phases 8 and 9."""
    import torch

    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )

    sv, sn = sphere_with_n_triangles(2500)
    small = {}
    for dev in (device, torch.device("cpu")):
        sc, mats, cam, it = whitted_setup(sv, sn, dev)
        small[dev.type] = wavefront.render(sc, mats, cam, 64, 64, spp=SPP,
                                           seed=3, intersector=it)[0].cpu()
    diff = (small["cuda"] - small["cpu"]).abs()
    within = float((diff.amax(-1) <= 1e-4).float().mean())
    print(f"[whitted] 64x64 reference check vs the CPU plain path: mean "
          f"|diff| {float(diff.mean()):.3g}, {within:.4f} of pixels within "
          f"1e-4")
    if float(diff.mean()) > 1e-5 or within < 0.999:
        raise AssertionError("Whitted frame on the card disagrees with the "
                             "CPU plain path")

    v, n = sphere_with_n_triangles(N_TRIS)
    scene, mats, cam, inter = whitted_setup(v, n, device)
    for k in _lib.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with calls_of(bm, "probe_call") as live:
        img, alb, nrm = wavefront.render(scene, mats, cam, WIDTH, HEIGHT,
                                         spp=SPP, seed=1, max_depth=DEPTH,
                                         intersector=inter)
    torch.cuda.synchronize()
    s_frame = time.perf_counter() - t0
    launches = {K[k].name: K[k].launches for k in "ABCHJOPQRSTU"}
    print(f"[whitted] {WIDTH}x{HEIGHT} spp={SPP} depth {DEPTH}: "
          f"{s_frame:.3f} s/frame (first frame) [{card}]; launches "
          f"{launches}; live share of bounce waves 1-{DEPTH - 1}: "
          f"{shares(live)}")
    if not (torch.isfinite(img).all() and torch.isfinite(alb).all()
            and torch.isfinite(nrm).all()):
        raise AssertionError("Whitted frame has non-finite values")
    rgba = color_to_uint8(img)
    if tuple(rgba[0, 0, :3].tolist()) != SKY:
        raise AssertionError(f"sky pixel {rgba[0, 0, :3].tolist()} != {SKY}")
    sky = int((rgba[..., :3] == torch.tensor(SKY, device=device,
                                             dtype=torch.uint8)).all(-1)
              .sum())
    print(f"[whitted] frame finite; {sky} sky pixels equal {SKY}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    t0 = time.perf_counter()
    wavefront.render(scene, mats, cam, WIDTH, HEIGHT, spp=SPP, seed=2,
                     max_depth=DEPTH, intersector=inter)
    torch.cuda.synchronize()
    print(f"[whitted] {time.perf_counter() - t0:.3f} s/frame (second "
          f"frame) [{card}]")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    write_png(OUT_DIR / "whitted.png", rgba)
    print(f"[whitted] wrote {OUT_DIR / 'whitted.png'}")
    return launches, SimpleNamespace(scene=scene, mats=mats, cam=cam,
                                     inter=inter, seed=1, img=img, alb=alb,
                                     nrm=nrm, rgba=rgba)


def time_once(fn):
    """(result, ms) of one call by CUDA events (the plain versions, too
    slow to repeat)."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def time_host(fn):
    """(result, ms) of one call on the host clock (CPU work)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def time_setup(device) -> SimpleNamespace:
    """Phase 5: the Time scene.  A DEM pile of P unit-sphere particles
    (shape ids and quaternions as tools/tlas_bench.py draws them, positions
    uniform in [-15, 15]^3), a second quaternion set and velocities that
    move them between frames 0 and 1, ROUGH / METAL by particle, over a
    static 80x80 ROUGH ground quad at z = -16; the TLAS library, and the
    flatten route's frame-0 scene and cluster build."""
    import torch

    from optix_ray_tracer_tpu_torch.io.meshgen import (
        quad, sphere_with_n_triangles,
    )
    from optix_ray_tracer_tpu_torch.models import renderer_time as rt
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    from optix_ray_tracer_tpu_torch.ops.instanced import (
        build_instanced_library,
    )
    from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, ShapeLibrary, Spheres, Triangles,
    )
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    shapes = ShapeLibrary.from_meshes(
        [sphere_with_n_triangles(s) for s in TIME_LIBRARY], device)
    library = build_instanced_library(shapes.vertices.cpu().numpy(),
                                      shapes.offsets, shapes.counts, device)
    gen = np.random.default_rng(7)
    sid = gen.integers(0, len(TIME_LIBRARY), N_PARTICLES)
    q = gen.normal(size=(N_PARTICLES, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos = gen.uniform(-15.0, 15.0, (N_PARTICLES, 3))
    q_next = gen.normal(size=(N_PARTICLES, 4))
    q_next /= np.linalg.norm(q_next, axis=1, keepdims=True)
    vel = gen.normal(size=(N_PARTICLES, 3)) * 0.5
    mb = MaterialBuilder()
    rough = mb.add_rough((0.65, 0.30, 0.20))
    metal = mb.add_metal((0.80, 0.85, 0.88), 0.05)
    ground = mb.add_rough((0.70, 0.60, 0.50))
    pmat = np.where(np.arange(N_PARTICLES) % 2 == 0, rough, metal)
    valid = np.ones(N_PARTICLES, bool)
    tri_lib, tri_inst, tri_ok = rt.packing_tables(shapes, sid[None],
                                                  valid[None])

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    poses = dict(positions=dev(pos), quats=dev(q), quats_next=dev(q_next),
                 velocities=dev(vel))
    qv, qn = quad((-40, -40, -16), (40, -40, -16), (40, 40, -16),
                  (-40, 40, -16))
    static = Scene(Spheres.empty(device),
                   Triangles.from_arrays(qv, qn, ground, device=device))
    # look_at's view spans +-1 at its target: a target TIME_FOCAL units
    # along the axis toward the origin frames the pile and some sky
    eye = np.asarray(TIME_EYE, np.float32)
    axis = -eye / np.linalg.norm(eye)
    cam = Camera.look_at(tuple(eye), tuple(eye + TIME_FOCAL * axis),
                         (0.0, 0.0, 1.0), device=device)
    t = SimpleNamespace(
        shapes=shapes, library=library, sid=sid, valid=valid,
        tri=(dev(tri_lib[0], torch.int32), dev(tri_inst[0], torch.int32),
             dev(tri_ok[0], torch.bool)),
        pmat=dev(pmat, torch.int32), poses=poses, static=static,
        mats=mb.build(device), cam=cam, device=device)

    v, n, mat = rt._frame_triangles(
        shapes.vertices, shapes.normals, *t.tri, poses["positions"],
        poses["quats"], poses["quats_next"], poses["velocities"], t.pmat,
        TIME_DURATION, 0.0, 1.0 / (TIME_FRAMES - 1), 1.0 / TIME_FRAMES,
        (0.0, 0.0, 0.0), 1.0, False)
    t.flat = Scene(Spheres.empty(device),
                   Triangles(v, n, mat).concat(static.triangles))
    t0 = time.perf_counter()
    t.finter = make_march_intersector(t.flat, raster=True)
    C = t.finter.clusters.num_clusters
    tlas0 = time_frame(t, 0)
    n_pairs = tlas0.tlas.pair_min.shape[0]
    print(f"[time] {N_PARTICLES} particles, library "
          f"{shapes.counts.tolist()} triangles in "
          f"{library.woop_t.shape[0]} clusters; {n_pairs} TLAS pairs; "
          f"flatten route: {t.flat.triangle_count} triangles, {C} clusters "
          f"(host SAH build {time.perf_counter() - t0:.2f} s)")
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    if n_pairs > bm.MAX_CLUSTERS:
        raise AssertionError(f"{n_pairs} pairs exceed {bm.MAX_CLUSTERS}")
    if C < bm.HIER_MIN_CLUSTERS:
        raise AssertionError(f"{C} clusters: coherent waves would not take "
                             f"kernel F (>= {bm.HIER_MIN_CLUSTERS})")
    t.o, t.d = (raster.to_tiles(x.reshape(-1, 3), 1, HEIGHT, WIDTH, TILE,
                                TILE) for x in t.cam.generate_rays(WIDTH,
                                                                   HEIGHT))
    R = t.o.shape[0]
    t.tmin = torch.full((R,), 1e-3, device=device)
    t.tmax = torch.full((R,), 1e16, device=device)
    # the camera wave's pair count; the frames' waves merge SPP samples,
    # SPP times the tiles, so their capacity is SPP times as large
    t.pc1 = ri.measure_instanced_pair_count(tlas0.tlas, t.o, t.d, t.tmin,
                                            t.tmax, "origin", t.o[0])
    t.pc_max1 = raster.round_pc_max(SPP * t.pc1)
    print(f"[calibrate] TLAS camera wave: {t.pc1} pairs -> the frames' "
          f"pc_max {t.pc_max1} ({SPP} samples per wave)")
    return t


def time_frame(t: SimpleNamespace, k: int, pc_max: int | None = None):
    """Frame k's TLASSceneIntersector (the refit for its poses)."""
    from optix_ray_tracer_tpu_torch.models import renderer_time as rt
    return rt.tlas_frame_intersector(
        t.library, t.shapes, t.sid, t.valid, t.tri[0], t.tri[1], t.pmat,
        **t.poses, duration=TIME_DURATION, frame_idx=float(k),
        n_frames=TIME_FRAMES, pc_max=pc_max)


@contextlib.contextmanager
def calls_of(module, name: str, keep=None):
    """Within the block, every call of ``module.name`` appends
    ``keep(*args, **kw)`` of its arguments (default: its keyword
    arguments) to the yielded list."""
    seen = []
    real = getattr(module, name)

    def record(*args, **kw):
        seen.append(keep(*args, **kw) if keep else kw)
        return real(*args, **kw)

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def shares(calls) -> str:
    """The live share (t_max > t_min) of each wave of ``calls``, the
    arguments that :func:`calls_of` recorded."""
    rays = [kw["rays"] for kw in calls]
    return ", ".join(f"{int((r[7] > r[6]).sum()) / r.shape[1]:.4f}"
                     for r in rays)


def bounce_wave(scene, mats, cam, inter, module, name: str) -> dict:
    """The keyword arguments of the first call of ``module.name`` at
    bounce 1 of a frame (seed 1, as phases 4 and 7 render it) rendered to
    depth 2: the frame's own first bounce wave."""
    from optix_ray_tracer_tpu_torch.render import wavefront
    with calls_of(module, name) as seen:
        wavefront.render(scene, mats, cam, WIDTH, HEIGHT, spp=SPP, seed=1,
                         max_depth=2, intersector=inter)
    return seen[-1]


def tlas_bounce_wave(t: SimpleNamespace) -> dict:
    """The ``march_instanced_call`` arguments (any_hit aside) of the TLAS
    frame's first bounce wave: the camera wave goes through kernel D,
    bounce 1 through E."""
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    kw = bounce_wave(t.static, t.mats, t.cam, time_frame(t, 0, t.pc_max1),
                     bm, "march_instanced_call")
    return {k: v for k, v in kw.items() if k != "any_hit"}


def flatten_bounce_wave(t: SimpleNamespace) -> dict:
    """The ``probe_call`` arguments of the flatten frame's first bounce
    wave (the camera wave goes through kernel F, bounce 1 through C to
    sort it, then B)."""
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    return bounce_wave(t.flat, t.mats, t.cam, t.finter, bm, "probe_call")


def sorted_wave(inter, o, d):
    """(o, d) Morton-sorted as MarchIntersector sorts a coherent wave over
    the scene of ``inter`` (a MarchIntersector)."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys
    perm = torch.argsort(ray_sort_keys(o, d, inter.scene_lo, inter.scene_hi),
                         stable=True)
    return o[perm], d[perm]


def coherent_wave(inter, o, d, t_min, t_max, hier: bool) -> dict:
    """The ``march_hier_call`` (``hier``) or ``march_call`` arguments of
    the camera wave (o, d) sorted by :func:`sorted_wave` over the clusters
    of ``inter``: F's flatten waves and the B/F crossover waves."""
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    o, d = sorted_wave(inter, o, d)
    return (bm.hier_inputs if hier else bm.march_inputs)(
        inter.clusters, o, d, t_min, t_max)


def tlas_shadow_wave(t: SimpleNamespace, inter):
    """(light, (o, d, t_min, t_max)): the point-light shadow wave from the
    hit points of the Time camera wave through ``inter`` (an
    InstancedMarchIntersector), flipped to start at the light as
    intersect_from traces occlusion waves; it keeps the camera wave's
    tile order."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import raster
    light = torch.tensor(TIME_LIGHT, device=t.device)
    h0, _ = inter.intersect_from(t.o, t.d, point=t.o[0],
                                 pc_max=raster.round_pc_max(t.pc1))
    p0 = torch.where(h0.is_hit[:, None], t.o + h0.t[:, None] * t.d, t.o)
    dist0 = torch.linalg.norm(light - p0, dim=-1)
    wl0 = (light - p0) / torch.clamp(dist0[:, None], min=1e-6)
    d0 = ((light - (p0 + wl0 * 1e-3)) * wl0).sum(-1)
    return light, (light.expand(t.o.shape[0], 3).contiguous(), -wl0,
                   d0 - dist0, d0 - 1e-3)


def check_time_kernels(t: SimpleNamespace) -> dict:
    """Phase 6: kernels D, E and F against their plain versions at the Time
    scene's full-size waves (compared on subsets), with both full-wave
    times, and F beside B on the same coherent wave.  Returns {name: JSON
    row (see :func:`row`)}."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr

    dev = t.device
    R = t.o.shape[0]
    tlas = time_frame(t, 0)
    inter = tlas.tlas
    W = TILE * TILE
    rows = {}
    print(f"[time kernels vs plain] hit rule, no exceptions [D on the "
          f"whole waves; E, F on {SUBSET_TIME} rays or fewer where the plain "
          f"version is slow]")

    def keys(slot):
        """(instance << 16) + library triangle of TLAS slots."""
        pos = slot.clamp(min=0).long()
        pair = pos // 256
        lib_slot = inter.pair_shape.long()[pair] * 256 + pos % 256
        key = (inter.pair_inst.long()[pair] << 16) \
            + inter.library.prim_index.long()[lib_slot]
        return torch.where(slot < 0, -1, key)

    # D: the frame's camera wave (nearest) and a point-light shadow wave
    # (any-hit, flipped to the light), each at its calibrated capacity
    light, shadow = tlas_shadow_wave(t, inter)
    pc1 = t.pc1
    pc2 = ri.measure_instanced_pair_count(inter, *shadow, "origin", light)
    print(f"[calibrate] TLAS shadow wave: {pc2} pairs")
    d_rows = []
    for label, wave, point, pc, any_hit in (
            ("camera wave", (t.o, t.d, t.tmin, t.tmax), t.o[0], pc1, False),
            ("shadow wave", shadow, light, pc2, True)):
        S = ri.instanced_coarse_stage(inter.pair_min, inter.pair_max, *wave,
                                      "origin", point, W,
                                      raster.round_pc_max(pc),
                                      inter.pair_shape, inter.pair_inst)
        if int(S["pc_total"]) > raster.round_pc_max(pc):
            raise AssertionError(f"D {label}: the schedule overflowed")
        d_rows.append(raster_wave(
            f"D {label}", tr.raster_instanced_call, tr.raster_instanced_plain,
            ri.instanced_schedule_inputs(inter, S), W, any_hit, keys, t.card))
    rows["tile_raster_instanced"] = dict(d_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in d_rows))

    # E: 1M incoherent rays inside the particle cloud, and the frame's
    # first bounce wave
    print(f"  E: {bm.march_occupancy(True)} resident warps per SM "
          f"(occupancy; any-hit {bm.march_occupancy(True, True)})")

    def e_case(label, inp, any_hit, pick, nearest=None):
        """E on the wave ``inp`` (timed whole) against its plain version
        on the rays ``pick``; returns (JSON row of the whole wave, plain
        (t, slot))."""
        full = bm.march_instanced_call(**inp, any_hit=any_hit)
        sub_rays = inp["rays"][:, pick].contiguous()
        reps = REPS if inp["rays"].shape[1] <= R else 2
        full_ms = time_ms(lambda: bm.march_instanced_call(
            **inp, any_hit=any_hit), reps)
        sub = dict(inp, rays=sub_rays)
        kern = bm.march_instanced_call(**sub, any_hit=any_hit)
        plain, p_ms = time_once(lambda: bm.march_instanced_plain(
            **{k: v for k, v in sub.items() if k != "w"}, any_hit=any_hit))
        err = compare(f"E {label}", keys, kern, plain, any_hit)
        ms = time_ms(lambda: bm.march_instanced_call(**sub, any_hit=any_hit),
                     REPS)
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms on "
              f"{sub_rays.shape[1]} rays; full wave "
              f"({inp['rays'].shape[1]} rays, {inp['n_pairs']} pairs) "
              f"{full_ms:.3f} ms [{t.card}], "
              f"{full[2].float().mean().item() / CHUNK:.2f} cluster-"
              f"equivalent visits per warp")
        # an occlusion wave is counted to its nearest hit in the segment:
        # an upper estimate, as an exact any-hit march may stop at any hit
        near = plain if nearest is None else nearest
        seg = (near[1] >= 0) & (near[0] < sub_rays[7])
        work = bm.needed_work(
            sub_rays, torch.where(seg, near[0], sub_rays[7]),
            torch.where(seg, near[1], -1), inp["boxes"], inp["sub_boxes"],
            inp["n_pairs"], inp["sub_boxes"].shape[1], instanced=True)
        march_work(f"{label} subset" + (
            " (needed: an upper estimate, to the nearest hit)" if any_hit
            else ""), kern[2], work)
        return (wave_row(f"E {label}", err, full_ms, p_ms,
                         tensor_bytes(inp, full), work, sub_rays.shape[1],
                         inp["rays"].shape[1]), plain)

    e_rows = []
    nearest = None
    for any_hit, inp in e_waves(t, inter).items():
        label = "incoherent " + ("any-hit" if any_hit else "nearest")
        pick = warp_rays(inp["rays"].shape[1], SUBSET_E).to(dev)
        e_row, plain = e_case(label, inp, any_hit, pick, nearest)
        if nearest is None:
            nearest = plain
        e_rows.append(e_row)
    inp = tlas_bounce_wave(t)
    pick = warp_rays(inp["rays"].shape[1], SUBSET_E).to(dev)
    e_rows.append(e_case("TLAS frame bounce 1 nearest", inp, False,
                         pick)[0])
    rows["block_march_instanced"] = dict(e_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in e_rows))

    # F: the flatten route's Morton-sorted camera wave, through
    # block_march's routing, against the plain F and beside flat B
    cs = t.finter.clusters
    fo, fd = sorted_wave(t.finter, t.o, t.d)
    print(f"  F: {bm.march_occupancy(hier=True)} resident warps per SM "
          f"(occupancy; any-hit {bm.march_occupancy(any_hit=True, hier=True)})")
    prims = prim_keys(cs)
    f_rows, f_near = [], None
    for any_hit in (False, True):
        tmax = torch.full((R,), F_SEGMENT if any_hit else 1e16, device=dev)
        before = (K["F"].launches, K["B"].launches)
        routed = bm.block_march(cs, fo, fd, t.tmin, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        if (K["F"].launches - before[0], K["B"].launches - before[1]) \
                != (1, 0):
            raise AssertionError("block_march did not route the coherent "
                                 "wave to kernel F")
        inp = coherent_wave(t.finter, t.o, t.d, t.tmin, tmax, hier=True)
        kern_full = bm.march_hier_call(**inp, any_hit=any_hit)
        if not torch.equal(kern_full[1][:R], routed[1]):
            raise AssertionError("F through block_march differs from F")
        full_ms = time_ms(lambda: bm.march_hier_call(**inp, any_hit=any_hit),
                          REPS)
        b_inp = coherent_wave(t.finter, t.o, t.d, t.tmin, tmax, hier=False)
        b_ms = time_ms(lambda: bm.march_call(**b_inp, any_hit=any_hit),
                       REPS)
        flat = bm.march_call(**b_inp, any_hit=any_hit)
        label = "any-hit" if any_hit else "nearest"
        compare(f"F vs B camera {label} (full wave)", prims, kern_full, flat,
                any_hit)
        pick = warp_rays(R, SUBSET_TIME).to(dev)
        sub = dict(inp, rays=inp["rays"][:, pick].contiguous())
        kern = bm.march_hier_call(**sub, any_hit=any_hit)
        plain, p_ms = time_once(lambda: bm.march_hier_plain(
            **{k: v for k, v in sub.items() if k != "w"}, any_hit=any_hit))
        err = compare(f"F camera {label}", prims, kern, plain, any_hit)
        ms = time_ms(lambda: bm.march_hier_call(**sub, any_hit=any_hit),
                     REPS)
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms on "
              f"{SUBSET_TIME} rays; full wave ({R} rays, "
              f"{cs.num_clusters} clusters): F {full_ms:.3f} ms "
              f"({kern_full[2].float().mean().item() / CHUNK:.2f} cluster-"
              f"equivalent visits per warp) vs B {b_ms:.3f} ms "
              f"({flat[2].float().mean().item() / CHUNK:.2f}) [{t.card}]")
        if f_near is None:
            f_near = plain
        # an occlusion wave is counted to its nearest hit in the segment
        near, rays = f_near, sub["rays"]
        seg = (near[1] >= 0) & (near[0] < rays[7])
        work = bm.needed_work(
            rays, torch.where(seg, near[0], rays[7]),
            torch.where(seg, near[1], -1), inp["boxes"], inp["sub_boxes"],
            cs.num_clusters, inp["n_subs"], sup_boxes=inp["sup_boxes"])
        march_work(f"{label} subset" + (
            " (needed: an upper estimate, to the nearest hit)" if any_hit
            else ""), kern[2], work)
        f_rows.append(wave_row(f"F camera {label}", err, full_ms, p_ms,
                               tensor_bytes(inp, kern_full), work,
                               SUBSET_TIME, R))
    rows["block_march_hier"] = dict(f_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in f_rows))

    # C: the flatten frame's own first bounce wave (3,368 clusters)
    rows["probe_first_cluster"] = probe_case(
        "C flatten frame bounce 1", flatten_bounce_wave(t), t.card)
    return rows


def time_frames(t: SimpleNamespace, card: str) -> dict:
    """Phase 7, the slice's main path: the camera wave's primary hits on
    both routes (counts zeroed before, read after: D and F), then frames 0
    and 1 through the TLAS route and frame 0 through the flatten route at
    1024x1024, spp 4, depth 5 (counts zeroed before the TLAS frames, read
    after: D, E and the pairs' binning S-U).  Returns the launch counts
    of D, E, F and S-U."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.instanced import refit_instanced
    from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )

    launches = {}
    tlas0 = time_frame(t, 0, t.pc_max1)
    for k in _lib.KERNELS:
        k.launches = 0
    h_t = tlas0.intersect_from(t.static, t.o, t.d, point=t.o[0])
    h_f = t.finter.intersect(t.flat, t.o, t.d)
    torch.cuda.synchronize()
    launches["block_march_hier"] = K["F"].launches
    bad = hit_mismatches(h_t.prim_id, h_t.t, h_f.prim_id, h_f.t)
    R = t.o.shape[0]
    print(f"[time frame] primary hits, TLAS (D) vs flatten (F): {bad} of "
          f"{R} rays differ under the hit rule (silhouette grazes), "
          f"{int(h_t.is_hit.sum())} hits; launches D "
          f"{K['D'].launches}, F {K['F'].launches}")
    if bad > 1e-4 * R:
        raise AssertionError(f"TLAS and flatten primary hits differ on "
                             f"{bad} rays")
    if min(K["D"].launches, K["F"].launches) == 0:
        raise AssertionError("the primary-hit phase missed kernel D or F")

    live = {}

    def render(inter, scene, seed, counted=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with calls_of(bm, counted or "march_instanced_call") as n:
            out = wavefront.render(scene, t.mats, t.cam, WIDTH, HEIGHT,
                                   spp=SPP, seed=seed, max_depth=DEPTH,
                                   intersector=inter)
        torch.cuda.synchronize()
        live.setdefault(counted or "tlas", n)
        return out, time.perf_counter() - t0

    for k in _lib.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tlas0 = time_frame(t, 0, t.pc_max1)
    torch.cuda.synchronize()
    build0 = time.perf_counter() - t0
    img0, s0 = render(tlas0, t.static, 1)
    t0 = time.perf_counter()
    tlas1 = time_frame(t, 1, t.pc_max1)
    torch.cuda.synchronize()
    build1 = time.perf_counter() - t0
    img1, s1 = render(tlas1, t.static, 2)
    torch.cuda.synchronize()
    launches["tile_raster_instanced"] = K["D"].launches
    launches["block_march_instanced"] = K["E"].launches
    for k in BIN_KEYS:                 # the TLAS pairs' binning
        launches[K[k].name] = K[k].launches
    print(f"[time frame] TLAS route {WIDTH}x{HEIGHT} spp={SPP} depth "
          f"{DEPTH}: frame 0 {s0:.3f} s, frame 1 {s1:.3f} s (frame "
          f"builds {build0 * 1e3:.1f} / {build1 * 1e3:.1f} ms) [{card}]; "
          f"launches {({k.name: k.launches for k in _lib.KERNELS})}")
    if min(K["D"].launches, K["E"].launches) == 0:
        raise AssertionError("the TLAS frames missed kernel D or E")
    tl = tlas1.tlas
    valid = torch.as_tensor(t.valid, device=t.device)
    refit_ms = time_ms(lambda: refit_instanced(
        t.library, tl.pair_shape, tl.pair_inst, tlas1.rot,
        tl.inst_rows[:, 9:12], 1.0, valid), REPS)
    print(f"[time frame] refit {refit_ms:.3f} ms ({tl.pair_min.shape[0]} "
          f"pairs, CUDA events) [{card}]")

    imgf, sf = render(t.finter, t.flat, 1, "probe_call")
    print(f"[time frame] flatten route frame 0: {sf:.3f} s [{card}]")
    print(f"[time frame] live share of bounce waves 1-{DEPTH - 1}: TLAS "
          f"frame 0 {shares(live['tlas'])}; flatten frame 0 "
          f"{shares(live['probe_call'])}")
    rgba = []
    for name, out in (("tlas_frame0", img0), ("tlas_frame1", img1),
                      ("flatten_frame0", imgf)):
        if not all(bool(torch.isfinite(x).all()) for x in out):
            raise AssertionError(f"{name} has non-finite values")
        rgba.append(color_to_uint8(out[0]))
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        write_png(OUT_DIR / f"{name}.png", rgba[-1])
    diff = (rgba[0].int() - rgba[2].int()).abs()
    over2 = float((diff > 2).float().mean())
    over6 = float((diff > 6).float().mean())
    sky = (rgba[0][..., :3] == torch.tensor(SKY, device=t.device,
                                            dtype=torch.uint8)).all(-1)
    sky_f = (rgba[2][..., :3] == torch.tensor(SKY, device=t.device,
                                              dtype=torch.uint8)).all(-1)
    print(f"[time frame] TLAS vs flatten frame 0: max {int(diff.max())} "
          f"LSB, {over2:.6f} of channels > 2 LSB, {over6:.6f} > 6 LSB, mean "
          f"{float(diff.float().mean()):.4f} LSB; {int(sky.sum())} sky "
          f"pixels equal {SKY} (flatten {int(sky_f.sum())}); wrote "
          f"{OUT_DIR}/tlas_frame0.png, tlas_frame1.png, flatten_frame0.png")
    # the two routes round each hit differently (object-space vs baked
    # triangles); after a few bounces between convex mirrors a rare path
    # sample diverges, which moves its pixel by up to 1/SPP of its range
    # (more in sRGB where the pixel is dark): no bound on the maximum, 6
    # LSB on all but 0.5% of the channels
    if over2 >= 0.01 or over6 >= 5e-3:
        raise AssertionError("TLAS and flatten frames disagree")
    if int(sky.sum()) == 0:
        raise AssertionError("no sky pixel in the TLAS frame")
    return launches


def first_pass_blocks(clusters, o, d):
    """The leaf sweep's arguments (woop, starts, o, d, t_min, best) in the
    first pass of a sweep query over the wave (o, d), as the pass builds
    them: every group's rays padded to whole 128-ray blocks."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import sweep as sw
    from optix_ray_tracer_tpu_torch.ops.kernels import leaf_sweep as ls
    R = o.shape[0]
    with calls_of(ls, "window_sweep_call", lambda *args: args) as seen:
        state = sw._initial_state(o, torch.full((R,), 1e16, device=o.device))
        sw._sweep_pass(clusters, o, d, torch.full((R,), 1e-3,
                                                  device=o.device), **state)
    return seen[0]


def sweep_phase(b: SimpleNamespace, f: SimpleNamespace, card: str):
    """Phase 8: kernel G against its plain version on the first pass's
    blocks of the camera and incoherent waves; SweepIntersector on both
    full waves against the marcher; phase 4's frame through the sweep,
    with the launch counts zeroed just before it.  Returns (G's JSON row,
    G's launches in the frame)."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import sweep as sw
    from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    from optix_ray_tracer_tpu_torch.ops.kernels import leaf_sweep as ls
    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )

    waves = {"camera": (b.o, b.d), "incoherent": (b.oi, b.di)}
    print(f"[sweep kernels vs plain] G on the first pass's blocks, "
          f"{SUBSET}-ray subsets spread over the windows, exact equality")
    g_rows = []
    for label, (o, d) in waves.items():
        args = first_pass_blocks(b.cs, o, d)
        nb = args[1].shape[0]
        full = ls.window_sweep_call(*args)
        full_ms = time_ms(lambda: ls.window_sweep_call(*args), REPS)
        pick = torch.linspace(0, nb - 1, SUBSET // 128,
                              device=o.device).round().long()
        sub = (args[0],) + tuple(x[pick].contiguous() for x in args[1:5]) \
            + (tuple(x[pick].contiguous() for x in args[5]),)
        kern = ls.window_sweep_call(*sub)
        plain, p_ms = time_once(lambda: ls.window_sweep_plain(*sub))
        bad = int((kern[1] != plain[1]).sum())
        errs = [float((kern[i] - plain[i]).abs().max()) for i in (0, 2, 3)]
        ms = time_ms(lambda: ls.window_sweep_call(*sub), REPS)
        print(f"  G {label}: {bad} slot mismatches of {SUBSET} rays "
              f"({int((kern[1] >= 0).sum())} hits), max |dt| {errs[0]:.3g}, "
              f"|du| {errs[1]:.3g}, |dv| {errs[2]:.3g}; kernel {ms:.3f} ms vs "
              f"plain {p_ms:.1f} ms; the full pass ({nb} blocks) "
              f"{full_ms:.3f} ms [{card}]")
        if bad or max(errs) > 0:
            raise AssertionError(f"G {label}: kernel disagrees with its plain "
                                 f"version")
        # the pass needs every (ray, row) of a live lane (t_min < best t):
        # the others (each group's filler, dead rays) accept no row
        live = int((args[4] < args[5][0]).sum())
        g_rows.append(row(max(errs), full_ms, p_ms, tensor_bytes(args, full),
                          live * CHUNK * WOOP_OPS))
        print(f"    G {label}: live lanes {live} of {nb * 128} "
              f"({live / (nb * 128):.4f}); full-pass bound "
              f"{g_rows[-1]['bound_ms']:.4f} ms by {g_rows[-1]['bound_by']}, "
              f"{100 * g_rows[-1]['bound_ms'] / full_ms:.2f}% of the pass")

    si = sw.SweepIntersector(clusters=b.cs, log=[])
    marcher = {
        "camera": b.inter.intersect_from(b.scene, b.o, b.d, mode="origin",
                                         point=b.o[0], pc_max=b.pc_max1),
        "incoherent": b.inter.for_incoherent().intersect(b.scene, b.oi,
                                                         b.di)}

    def keys(h):
        return torch.where(h.is_hit, h.prim_id, -1)

    for label, (o, d) in waves.items():
        si.log.clear()
        h, ms = time_once(lambda: si.intersect(b.scene, o, d))
        st = si.log[0]
        ref = marcher[label]
        bad = hit_mismatches(keys(h), h.t, keys(ref), ref.t)
        print(f"[sweep] {label} wave ({b.R} rays): {st.passes} passes, live "
              f"rays per pass {st.live}, {ms:.1f} ms by CUDA events "
              f"[{card}]; {bad} rays differ from the marcher under the hit "
              f"rule; " + ("a ray was still active at the cap"
                           if st.unfinished else "no ray active at the cap"))
        if st.unfinished:
            raise AssertionError(f"sweep {label}: rays active at the cap")
        if bad > SWEEP_HIT_EXCEPTIONS * b.R:
            raise AssertionError(f"sweep {label}: {bad} rays differ from the "
                                 f"marcher")

    si = sw.SweepIntersector(clusters=f.inter.clusters, log=[])
    for k in _lib.KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # per launch of G: (lanes, live lanes as a device count)
    with calls_of(ls, "window_sweep_call", lambda woop, starts, o, d, t_min,
                  best: (t_min.numel(), (t_min < best[0]).sum())) as lanes:
        img, alb, nrm = wavefront.render(f.scene, f.mats, f.cam, WIDTH,
                                         HEIGHT, spp=SPP, seed=f.seed,
                                         max_depth=DEPTH, intersector=si)
    torch.cuda.synchronize()
    s_frame = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _lib.KERNELS}
    passes = [st.passes for st in si.log]
    print(f"[sweep frame] {WIDTH}x{HEIGHT} spp={SPP} depth {DEPTH} through "
          f"SweepIntersector: {s_frame:.3f} s/frame [{card}]; launches "
          f"{launches}; passes per wave {passes}")
    if len(lanes) != sum(passes):
        raise AssertionError(f"{len(lanes)} launches of G in {sum(passes)} "
                             f"sweep passes")
    share = iter(f"{int(n_live) / n:.4f}" for n, n_live in lanes)
    print("[sweep frame] live share of G's lanes (t_min < best t) per pass: "
          + "; ".join(f"wave {i}: " + " ".join(next(share) for _ in range(p))
                      for i, p in enumerate(passes)))
    if K["G"].launches == 0:
        raise AssertionError("the sweep frame never launched kernel G")
    if any(st.unfinished for st in si.log):
        raise AssertionError("sweep frame: rays active at the cap")
    if not all(bool(torch.isfinite(x).all()) for x in (img, alb, nrm)):
        raise AssertionError("sweep frame has non-finite values")
    rgba = color_to_uint8(img)
    if tuple(rgba[0, 0, :3].tolist()) != SKY:
        raise AssertionError(f"sweep frame sky pixel {rgba[0, 0, :3]}")
    sky = int((rgba[..., :3] == torch.tensor(SKY, device=rgba.device,
                                             dtype=torch.uint8)).all(-1)
              .sum())
    diff = (rgba.int() - f.rgba.int()).abs()
    over2 = float((diff > 2).float().mean())
    print(f"[sweep frame] finite; {sky} sky pixels equal {SKY}; vs phase "
          f"4's marcher frame: max {int(diff.max())} LSB, {over2:.6f} of "
          f"channels > 2 LSB, mean {float(diff.float().mean()):.4f} LSB")
    if over2 >= 0.01:
        raise AssertionError("sweep and marcher frames disagree")
    write_png(OUT_DIR / "whitted_sweep.png", rgba)
    return g_rows[0], K["G"].launches


def tail_config(denoiser: str) -> SimpleNamespace:
    """The frame step's config (read by attribute, as render_frame reads
    the JAX package's RendererConfig)."""
    return SimpleNamespace(integrator="whitted", background=(0.7, 0.8, 0.9),
                           max_depth=DEPTH, sampler="pcg", denoise=True,
                           denoiser=denoiser)


def tail_setup(f: SimpleNamespace, denoiser: str):
    """The denoiser tail on phase 4's frame, as a callable."""
    from optix_ray_tracer_tpu_torch.models.common import apply_denoiser
    cfg = tail_config(denoiser)
    return lambda: apply_denoiser(f.img, f.alb, f.nrm, cfg)


def frame_tail(f: SimpleNamespace, card: str) -> None:
    """Phase 9: render_frame with each denoiser; each denoiser on phase
    4's frame timed, and held to the same call on the frame's CPU copy;
    the 4 samples accumulated into a Film and written as PNGs."""
    import torch

    from optix_ray_tracer_tpu_torch.models.common import (
        apply_denoiser, render_frame, resolve_denoiser,
    )
    from optix_ray_tracer_tpu_torch.render.film import Film

    cpu = [x.cpu() for x in (f.img, f.alb, f.nrm)]
    for name in ("atrous", "neural"):
        cfg = tail_config(name)
        if resolve_denoiser(cfg) != name:
            raise AssertionError(f"resolve_denoiser gave "
                                 f"{resolve_denoiser(cfg)} for {name}")
        img, alb, nrm = render_frame(cfg, f.scene, f.mats, f.cam, WIDTH,
                                     HEIGHT, SPP, f.seed, f.inter)
        if not all(bool(torch.isfinite(x).all()) for x in (img, alb, nrm)):
            raise AssertionError(f"render_frame ({name}) is not finite")
        ms = time_ms(tail_setup(f, name), REPS)
        card_out = tail_setup(f, name)()
        cpu_out, cpu_ms = time_host(lambda: apply_denoiser(*cpu, cfg))
        rel = (card_out.cpu() - cpu_out).abs() / cpu_out.abs()
        err = float(torch.nan_to_num(rel, nan=0.0).max())
        film = Film.create(WIDTH, HEIGHT, img.device).add(img, alb, nrm,
                                                          samples=SPP)
        path = OUT_DIR / f"whitted_denoised_{name}.png"
        film.save(str(path))
        print(f"[tail] {name}: {ms:.3f} ms per {WIDTH}x{HEIGHT} frame on "
              f"the card (CUDA events) [{card}], {cpu_ms:.0f} ms on the "
              f"host CPU; card vs CPU max |diff| / |cpu| {err:.3g} "
              f"(tolerance {DENOISE_RTOL[name]}); film spp {film.spp}; "
              f"wrote {path}")
        if film.spp != SPP:
            raise AssertionError("the film did not accumulate the samples")
        if not err <= DENOISE_RTOL[name]:
            raise AssertionError(f"{name}: card and CPU disagree by {err}")


# ---------------------------------------------------------------------------
# Phase 10: the animation entry point (python -m optix_ray_tracer_tpu_torch)
# ---------------------------------------------------------------------------

ANIM_WIDTH, ANIM_HEIGHT = 1200, 800    # the reference's window
ANIM_TIMES = (0.0, 0.25, 0.5)          # three pose files
ANIM_FPS = 16                          # 0.25 s x 16 fps x ratio 1 = 4 frames
ANIM_FRAMES = 12
ANIM_TLAS_FRAMES = 4
ANIM_CHECK_FRAMES = 6                  # frames 0-5 cross a file boundary
MESH_TIMES = (0.0, 0.25)               # Mesh mode: 2 files x 2 frames
MESH_FPS = 8


def quat_matrix(q):
    """(n, 4) unit quaternions (w, x, y, z) -> (n, 3, 3) rotations."""
    w, x, y, z = (q[:, i] for i in range(4))
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def pile_poses(n: int, times, seed: int = 7) -> list:
    """Phase 5's pile as a pose series: shape ids, quaternions and
    positions drawn as :func:`time_setup` draws them; in file f the
    positions have moved by velocity x times[f] and the quaternions have
    turned from the first set toward the second by f / (files - 1)."""
    gen = np.random.default_rng(seed)
    sid = gen.integers(0, len(TIME_LIBRARY), n)
    q = gen.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos = gen.uniform(-15.0, 15.0, (n, 3))
    q_next = gen.normal(size=(n, 4))
    q_next /= np.linalg.norm(q_next, axis=1, keepdims=True)
    vel = gen.normal(size=(n, 3)) * 0.5
    out = []
    for f, t in enumerate(times):
        a = f / max(len(times) - 1, 1)
        qf = q * (1.0 - a) + q_next * np.where(
            (q * q_next).sum(1, keepdims=True) < 0, -a, a)
        qf /= np.linalg.norm(qf, axis=1, keepdims=True)
        out.append(dict(pos=pos + vel * t, quat=qf, vel=vel, sid=sid,
                        ids=np.arange(n)))
    return out


def write_stl(path, vertices) -> None:
    """A binary STL of (T, 3, 3) triangles (facet normals left zero: the
    readers recompute them)."""
    rec = np.zeros(len(vertices), dtype=[("n", "<f4", (3,)),
                                         ("v", "<f4", (3, 3)),
                                         ("attr", "<u2")])
    rec["v"] = vertices
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + np.uint32(len(vertices)).tobytes()
                + rec.tobytes())


def write_manifest(path, names, times) -> None:
    Path(path).write_text(json.dumps({"file-series-version": "1.0", "files": [
        {"name": n, "time": t} for n, t in zip(names, times)]}))


def write_time_series(root, shapes, poses, times, binary: bool = True):
    """A Time series under ``root``: one STL per library shape
    (shapes/shapeNN.stl, the lexicographic order is the shape id), one
    pose VTK per file (points with id, quat, vel, shape_id) and
    pile.vtk.series.  Returns (series path, STL directory)."""
    from optix_ray_tracer_tpu_torch.io.vtk import PolyData, write_polydata
    root = Path(root)
    (root / "shapes").mkdir(parents=True, exist_ok=True)
    for i, (v, _) in enumerate(shapes):
        write_stl(root / "shapes" / f"shape{i:02d}.stl", v)
    names = []
    for f, p in enumerate(poses):
        names.append(f"pose{f}.vtk")
        write_polydata(root / names[-1], PolyData(
            points=np.asarray(p["pos"], np.float64), vertices=[], lines=[],
            polygons=[], triangle_strips=[], cell_data={}, point_data={
                "id": np.asarray(p["ids"], np.int32),
                "quat": np.asarray(p["quat"], np.float64),
                "vel": np.asarray(p["vel"], np.float64),
                "shape_id": np.asarray(p["sid"], np.int32)}), binary=binary)
    write_manifest(root / "pile.vtk.series", names, times)
    return root / "pile.vtk.series", root / "shapes"


def sphere_strip(n_target: int):
    """The UV grid of ``sphere_with_n_triangles(n_target)`` as one
    triangle strip: (points (P, 3), strip indices).  Each latitude band is
    a strip; bands join through 4 zero-area triangles."""
    n_lat = max(2, int(np.sqrt(n_target / 4)))
    n_lon = max(3, n_target // (2 * n_lat))
    lat = np.linspace(0.0, np.pi, n_lat + 1)
    lon = np.linspace(0.0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    pts = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                    np.cos(th)], -1).reshape(-1, 3)
    grid = np.arange(pts.shape[0]).reshape(n_lat + 1, n_lon + 1)
    strip = []
    for i in range(n_lat):
        band = np.stack([grid[i], grid[i + 1]], 1).reshape(-1)
        if strip:
            strip += [strip[-1], int(band[0])]
        strip += band.tolist()
    return pts, np.asarray(strip, np.int64)


def write_mesh_series(root, poses, times) -> Path:
    """A Mesh series under ``root``: per file, every particle of the pile
    as one TRIANGLE_STRIPS cell of its world points (its library shape's
    UV grid, rotated and moved to its pose) with its id and velocity.
    Returns the series path."""
    from optix_ray_tracer_tpu_torch.io.vtk import PolyData, write_polydata
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    grids = [sphere_strip(s) for s in TIME_LIBRARY]
    names = []
    for f, p in enumerate(poses):
        rot = quat_matrix(p["quat"])
        points, strips, base = [], [], 0
        for i, s in enumerate(p["sid"]):
            g, strip = grids[s]
            points.append(g @ rot[i].T + p["pos"][i])
            strips.append(strip + base)
            base += g.shape[0]
        names.append(f"mesh{f}.vtk")
        write_polydata(root / names[-1], PolyData(
            points=np.concatenate(points), vertices=[], lines=[],
            polygons=[], triangle_strips=strips, point_data={}, cell_data={
                "id": np.asarray(p["ids"], np.int32),
                "vel": np.asarray(p["vel"], np.float64)}))
    write_manifest(root / "mesh.vtk.series", names, times)
    return root / "mesh.vtk.series"


def write_anim_config(path, series, stl_dir, cache_dir, width: int,
                      height: int, fps: int, mesh: bool = False,
                      **extra) -> Path:
    """A config JSON at the reference's defaults (whitted, spp 1, depth 5,
    a-trous, temporal on) over the pile's ground quad (an OBJ beside it)
    and phase 5's camera; ``extra`` overrides keys."""
    path = Path(path)
    obj = path.with_suffix(".ground.obj")
    obj.write_text("v -40 -40 -16\nv 40 -40 -16\nv 40 40 -16\nv -40 40 -16\n"
                   "f 1 2 3\nf 1 3 4\n")
    eye = np.asarray(TIME_EYE, np.float64)
    target = eye - TIME_FOCAL * eye / np.linalg.norm(eye)
    cfg = {"mesh": mesh, "series-path": str(Path(series).parent),
           "series-name": Path(series).name, "stl-path": str(stl_dir),
           "cache-path": str(cache_dir), "cache": False,
           "particle-material-preset": "viridis",
           "roughs": [{"albedo": [0.70, 0.60, 0.50]}], "metals": [],
           "spheres": [], "meshes": [{"obj": obj.name, "mat-type": "ROUGH",
                                      "mat-index": 0}],
           "integrator": "whitted", "spp": 1, "max-depth": DEPTH,
           "denoise": "atrous", "temporal": True, "seed": 0,
           "loop-data": {"api": "HEADLESS", "window-width": width,
                         "window-height": height, "fps": fps,
                         "render-speed-ratio": 1,
                         "camera-center": eye.tolist(),
                         "camera-target": target.tolist(),
                         "up-direction": [0.0, 0.0, 1.0]}}
    cfg.update(extra)
    path.write_text(json.dumps(cfg))
    return path


def write_light_obj(path, z: float, half: float) -> Path:
    """An area light for the path-traced animation: a 2 half x 2 half
    square at height z, facing down, as an OBJ (an EMISSIVE mesh extra)."""
    path = Path(path)
    path.write_text(f"v {-half} {-half} {z}\nv {-half} {half} {z}\n"
                    f"v {half} {half} {z}\nv {half} {-half} {z}\n"
                    "f 1 2 3\nf 1 3 4\n")
    return path


def read_png(path) -> np.ndarray:
    """(H, W, 4) uint8 of a PNG written by ``utils.color.write_png`` (8-bit
    RGBA, one IDAT, filter 0 on every row)."""
    import struct
    import zlib
    data = Path(path).read_bytes()
    w, h = struct.unpack(">II", data[16:24])
    n = struct.unpack(">I", data[33:37])[0]
    raw = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8)
    rows = raw.reshape(h, 1 + 4 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row is not filter 0")
    return rows[:, 1:].reshape(h, w, 4)


def check_pngs(paths, label: str) -> list:
    """Each PNG decoded; each must show the background on some pixels.
    Returns the images."""
    imgs = [read_png(p) for p in paths]
    for p, img in zip(paths, imgs):
        if not (img[..., :3] == SKY).all(-1).any():
            raise AssertionError(f"{label}: no sky pixel in {p}")
    return imgs


def agree(a, b, label: str) -> None:
    """Phase 7's rule for two 8-bit frames: > 2 LSB on < 1% of channels."""
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    over2 = float((diff > 2).mean())
    print(f"  {label}: max {int(diff.max())} LSB, {over2:.6f} of channels "
          f"> 2 LSB, mean {float(diff.mean()):.4f} LSB")
    if over2 >= 0.01:
        raise AssertionError(f"{label}: the frames disagree")


@contextlib.contextmanager
def timed_calls(module, name: str, log: list, tag=lambda: None):
    """Within the block, every call of ``module.name`` appends (tag(),
    start event, end event), CUDA events on the current stream around
    the call (no synchronisation)."""
    import torch
    real = getattr(module, name)

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args, **kw)
        b.record()
        log.append((tag(), a, b))
        return out

    setattr(module, name, timed)
    try:
        yield log
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def host_timed(module, name: str, log: list, sync: bool = True):
    """Within the block, every call of ``module.name`` appends its seconds
    on the host clock, the device synchronised before and after unless
    ``sync`` is False (host work that must not wait for queued frames)."""
    import torch
    real = getattr(module, name)

    def timed(*args, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        if sync:
            torch.cuda.synchronize()
        log.append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed)
    try:
        yield log
    finally:
        setattr(module, name, real)


def zero_counts():
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    for k in _lib.KERNELS:
        k.reset()


def run_cli(argv) -> None:
    from optix_ray_tracer_tpu_torch import __main__ as cli
    rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise AssertionError(f"main({argv}) returned {rc}")


def animation_phase(card: str) -> dict:
    """Phase 10: the animation entry point, ``__main__.main(argv)`` on a
    series this phase writes.  Returns the launches of A-F and S-U it
    made."""
    import os
    import tempfile

    import torch

    from optix_ray_tracer_tpu_torch.io.config import load_config
    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.models import common, fused
    from optix_ray_tracer_tpu_torch.models import renderer_mesh as rm
    from optix_ray_tracer_tpu_torch.models import renderer_time as rt
    from optix_ray_tracer_tpu_torch.ops import march
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.render.film import U8Frame

    tmp = tempfile.TemporaryDirectory(prefix="anim_")
    root = Path(tmp.name)
    launches = {}
    try:
        poses = pile_poses(N_PARTICLES, ANIM_TIMES)
        series, stl_dir = write_time_series(
            root / "time", [sphere_with_n_triangles(s) for s in TIME_LIBRARY],
            poses, ANIM_TIMES)
        cfg = write_anim_config(root / "time.json", series, stl_dir,
                                root / "cache", ANIM_WIDTH, ANIM_HEIGHT,
                                ANIM_FPS)
        print(f"[anim] wrote a Time series: {len(ANIM_TIMES)} pose files of "
              f"{N_PARTICLES} particles, library {list(TIME_LIBRARY)}; "
              f"{ANIM_WIDTH}x{ANIM_HEIGHT}, spp 1, depth {DEPTH}, whitted, "
              f"a-trous, temporal on, 4 frames per file")

        # 1. the default route: flatten, fused, all frames to PNGs
        commit_s, build_s, rebuilds, refits, marches = [], [], [], [], []
        saves = []
        frame = [-1]

        def tag():
            return frame[0]

        real_refit = fused.refit_march_intersector

        def counted_refit(*args, **kw):
            frame[0] += 1
            return real_refit(*args, **kw)

        zero_counts()
        fused.refit_march_intersector = counted_refit
        try:
            with host_timed(rt, "commit", commit_s), \
                    host_timed(common, "make_march_intersector", build_s), \
                    timed_calls(common, "rebuild_march_intersector",
                                rebuilds), \
                    timed_calls(fused, "refit_march_intersector", refits,
                                tag), \
                    timed_calls(bm, "march_call", marches,
                                lambda: ("B", frame[0])), \
                    timed_calls(bm, "march_hier_call", marches,
                                lambda: ("F", frame[0])), \
                    host_timed(U8Frame, "save", saves, sync=False):
                run_cli(["--config", cfg, "--output", root / "out1",
                         "--frames", ANIM_FRAMES])
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
        finally:
            fused.refit_march_intersector = real_refit
        counts = {k: K[k].launches for k in (*"ABCDEF", *BIN_KEYS)}
        for k in counts:
            launches[K[k].name] = counts[k]
        pngs = sorted((root / "out1").glob("frame_*.png"))
        if len(pngs) != ANIM_FRAMES or frame[0] != ANIM_FRAMES - 1:
            raise AssertionError(f"{len(pngs)} PNGs, {frame[0] + 1} refits")
        imgs = check_pngs(pngs, "flatten fused")
        starts = {f: a for f, a, _ in refits}
        per_frame = starts[2].elapsed_time(end) / (ANIM_FRAMES - 2) / 1e3
        refit_ms = [a.elapsed_time(b) for _, a, b in refits]
        print(f"[anim] flatten route, fused, {ANIM_FRAMES} frames "
              f"[{card}]: commit {commit_s[0]:.3f} s; host SAH build (file "
              f"0) {build_s[0]:.3f} s; device rebuilds (median, files 1-2) "
              + ", ".join(f"{a.elapsed_time(b):.1f}" for _, a, b in rebuilds)
              + f" ms (CUDA events, queued behind the frames); refit + "
              f"attach_raster per frame {np.median(refit_ms):.3f} ms median "
              f"({min(refit_ms):.3f}-{max(refit_ms):.3f}); wall "
              f"{per_frame:.4f} s/frame over frames 2-{ANIM_FRAMES - 1} "
              f"(CUDA events)")
        gaps = [starts[f].elapsed_time(starts[f + 1])
                for f in range(2, ANIM_FRAMES - 1)]
        print(f"  device timeline from each frame's refit to the next's, "
              f"frames 2-{ANIM_FRAMES - 2}: "
              + ", ".join(f"{g:.1f}" for g in gaps)
              + f" ms; PNG encode + write on the host "
              f"{1e3 * np.mean(saves):.1f} ms per frame (the CLI writes "
              f"one chunk's PNGs while the next chunk renders)")
        print("[anim] launches per frame: " + ", ".join(
            f"{k} {counts[k] / ANIM_FRAMES:.2f}" for k in "ABCF"))
        if min(counts["B"], counts["C"], counts["F"]) == 0:
            raise AssertionError("the flatten loop missed kernel B, C or F")
        for f in range(len(ANIM_TIMES)):
            row_ = []
            for j in (0, 3):
                fr = 4 * f + j
                for kk in "BF":
                    ms = sum(a.elapsed_time(b) for (k2, f2), a, b in marches
                             if k2 == kk and f2 == fr)
                    row_.append(f"{kk} {ms:.3f}")
                row_[-2] = f"frame {j}: " + row_[-2]
            print(f"  file {f}: device ms " + "; ".join(row_))

        # the device rebuild alone, median and morton, on file 1's frame 0
        data = rt.commit(load_config(str(cfg)))
        n1 = common.frame_count_for_file(data.durations[1], ANIM_FPS, 1)
        s0 = rt.frame_scene(data, 0, 0, n1)
        s1 = rt.frame_scene(data, 1, 0, n1)
        base = common.choose_intersector(s0)
        t_pack = int(data.tri_lib_idx.shape[1])
        for method in ("median", "morton"):
            ms = time_ms(lambda: march.rebuild_march_intersector(
                base, s1, method=method), 3)
            print(f"  device rebuild {method} of file 1 ({s1.triangle_count}"
                  f" triangles): {ms:.1f} ms (CUDA events, mean of 3) "
                  f"[{card}]")
        del data, base, s0, s1

        # 2. the same series through the TLAS route
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        os.environ["ORT_TIME_TLAS"] = "1"
        tlas_frames, tlas_saves = [], []
        t0 = time.perf_counter()
        try:
            with timed_calls(rt, "tlas_frame_intersector", tlas_frames), \
                    host_timed(U8Frame, "save", tlas_saves, sync=False):
                run_cli(["--config", cfg, "--output", root / "out2",
                         "--frames", ANIM_TLAS_FRAMES])
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
        finally:
            del os.environ["ORT_TIME_TLAS"]
        tlas_s = time.perf_counter() - t0
        tlas_peak = torch.cuda.max_memory_allocated() - mem0
        for k in (*"DE", *BIN_KEYS):
            launches[K[k].name] += K[k].launches
        per_frame = (tlas_frames[1][1].elapsed_time(end)
                     / (ANIM_TLAS_FRAMES - 1) / 1e3)
        print(f"[anim] TLAS route (ORT_TIME_TLAS=1) [{card}]: "
              f"{ANIM_TLAS_FRAMES} frames in {tlas_s:.2f} s with commit and "
              f"library build; wall {per_frame:.4f} s/frame over frames "
              f"1-{ANIM_TLAS_FRAMES - 1} (CUDA events; PNG encode + write "
              f"{1e3 * np.mean(tlas_saves):.1f} ms of it); launches per "
              f"frame: D {K['D'].launches / ANIM_TLAS_FRAMES:.2f}, E "
              f"{K['E'].launches / ANIM_TLAS_FRAMES:.2f}")
        if min(K["D"].launches, K["E"].launches) == 0:
            raise AssertionError("the TLAS loop missed kernel D or E")
        tlas_imgs = check_pngs(sorted((root / "out2").glob("frame_*.png")),
                               "TLAS")

        # 3. agreement with temporal off: flatten fused vs TLAS frame 0,
        # fused vs per-frame on frames 0-5 (a file boundary: a rebuild)
        cfg_nt = write_anim_config(root / "notemporal.json", series, stl_dir,
                                   root / "cache", ANIM_WIDTH, ANIM_HEIGHT,
                                   ANIM_FPS, temporal=False)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        run_cli(["--config", cfg_nt, "--output", root / "out3", "--frames",
                 ANIM_CHECK_FRAMES])
        torch.cuda.synchronize()
        flat_peak = torch.cuda.max_memory_allocated() - mem0
        for k in (*"ABCF", *BIN_KEYS):
            launches[K[k].name] += K[k].launches
        fused_imgs = check_pngs(sorted((root / "out3").glob("frame_*.png")),
                                "flatten fused, temporal off")
        print("[anim] temporal off:")
        agree(fused_imgs[0], tlas_imgs[0], "flatten frame 0 vs TLAS frame 0")
        data = rt.commit(load_config(str(cfg_nt)))
        rt.set_update_fn(data, lambda spheres, k: None)
        zero_counts()
        t0 = time.perf_counter()
        per = [f.to_uint8() for _, _, f in rt.render_frames(
            data, max_frames=ANIM_CHECK_FRAMES, quantize=True)]
        torch.cuda.synchronize()
        print(f"  per-frame loop (set_update_fn): {ANIM_CHECK_FRAMES} frames "
              f"in {time.perf_counter() - t0:.2f} s with its host build "
              f"[{card}]")
        for k in (*"ABCF", *BIN_KEYS):
            launches[K[k].name] += K[k].launches
        for j, (a, b) in enumerate(zip(fused_imgs, per)):
            agree(a, b, f"fused vs per-frame frame {j}")
        del data, per

        # 5. the flatten route's device bytes per packed triangle
        print(f"[anim] peak device memory above the start: flatten "
              f"{flat_peak / 2**20:.1f} MiB, TLAS {tlas_peak / 2**20:.1f} "
              f"MiB; flatten - TLAS over {t_pack} packed triangles: "
              f"{(flat_peak - tlas_peak) / t_pack:.1f} B per triangle "
              f"(renderer_time._FLATTEN_BYTES_PER_TRI = "
              f"{rt._FLATTEN_BYTES_PER_TRI}) [{card}]")

        # 4. Mesh mode: bake through the CLI, then render
        mesh_series = write_mesh_series(root / "mesh", poses[:2], MESH_TIMES)
        bake = write_anim_config(root / "bake.json", mesh_series, stl_dir,
                                 root / "mesh_cache", ANIM_WIDTH,
                                 ANIM_HEIGHT, MESH_FPS, mesh=True,
                                 cache=True)
        t0 = time.perf_counter()
        run_cli(["--config", bake])
        bake_s = time.perf_counter() - t0
        mesh_cfg = write_anim_config(root / "mesh.json", mesh_series,
                                     stl_dir, root / "mesh_cache",
                                     ANIM_WIDTH, ANIM_HEIGHT, MESH_FPS,
                                     mesh=True)
        load_s, mesh_build, mesh_frames = [], [], []
        zero_counts()
        t0 = time.perf_counter()
        with host_timed(rm, "commit", load_s), \
                host_timed(common, "make_march_intersector", mesh_build), \
                timed_calls(fused, "refit_march_intersector", mesh_frames):
            run_cli(["--config", mesh_cfg, "--output", root / "out4"])
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
        mesh_s = time.perf_counter() - t0
        for k in (*"ABCF", *BIN_KEYS):
            launches[K[k].name] += K[k].launches
        mesh_pngs = sorted((root / "out4").glob("frame_*.png"))
        check_pngs(mesh_pngs, "Mesh")
        n_mesh = len(mesh_pngs)
        per_frame = (mesh_frames[1][1].elapsed_time(end) / (n_mesh - 1)
                     / 1e3)
        print(f"[anim] Mesh mode, {len(MESH_TIMES)} files x 2 frames "
              f"[{card}]: bake {bake_s:.2f} s, cache load + commit "
              f"{load_s[0]:.2f} s, host SAH build of file 0 "
              f"{mesh_build[0]:.2f} s, {n_mesh} "
              f"frames in {mesh_s:.2f} s in all; wall {per_frame:.4f} "
              f"s/frame over frames 1-{n_mesh - 1} (CUDA events, a device "
              f"rebuild at frame 2); launches B {K['B'].launches}, C "
              f"{K['C'].launches}, F {K['F'].launches}")
        if n_mesh != 2 * len(MESH_TIMES):
            raise AssertionError(f"Mesh mode wrote {n_mesh} frames")
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        for name, img in (("anim_flatten_frame11", imgs[-1]),
                          ("anim_tlas_frame0", tlas_imgs[0])):
            from optix_ray_tracer_tpu_torch.utils.color import write_png
            write_png(OUT_DIR / f"{name}.png", img)
    finally:
        tmp.cleanup()
    return launches



# ---- phase 11: the path tracer --------------------------------------------

SUN = (0.4, 0.25, 0.88)           # config 5's sun direction (normalised)
CORNELL_SPP = 16                  # config 4's 1024 spp, cut to fit the limit
ANIM_PATH_FRAMES = 8              # two files of the pile series
# the panel's height, half size, radiance: small enough that every
# frame's bounce-0 NEE wave fits the heuristic bundle capacity, so A runs
ANIM_LIGHT = (30.0, 2.0, 100.0)
ANIM_LARGE_LIGHT = 12.0           # half size of a panel whose waves overflow
ANIM_LARGE_FRAMES = 4
BUNDLE_BLOCKS = 64                # A's bundle wave: blocks the plain twin runs


def sponza_cell(card: str) -> dict:
    """Phase 11 (a): config 5 as ``models/benchmarks.config5_sponza_class``
    builds it, through ``benchmarks.run``: twice with raster tables (the
    first frame's launches counted, the second timed), then with none (B
    and C only), and the two images held to each other.  Returns the
    launches of A, B, C, K-N and S-U of one frame."""
    import dataclasses

    import torch

    from optix_ray_tracer_tpu_torch.models import benchmarks
    from optix_ray_tracer_tpu_torch.models.common import choose_intersector
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )

    cfg = benchmarks.config5_sponza_class(device=torch.device("cuda", 0))
    t0 = time.perf_counter()
    inter = choose_intersector(cfg["scene"])
    torch.cuda.synchronize()
    print(f"[path sponza] config 5: {cfg['scene'].triangle_count} triangles "
          f"in {inter.clusters.num_clusters} clusters (host SAH build "
          f"{time.perf_counter() - t0:.2f} s), {cfg['width']}x"
          f"{cfg['height']}, spp {cfg['spp']}, depth {cfg['max_depth']}, "
          f"checker floor, sky with sun, environment NEE")
    zero_counts()
    (img, alb, nrm), st = benchmarks.run(cfg, intersector=inter)
    counts = {k: K[k].launches for k in "ABCKLMN"}
    binning = launch_counts(BIN_KEYS)
    _, st2 = benchmarks.run(cfg, seed=1, intersector=inter)
    print(f"[path sponza] {st2['render_s']:.3f} s/frame, "
          f"{st2['spp_per_sec']:.3f} spp/s, {st2['mpaths_per_sec']:.2f} "
          f"Mpaths/s (second frame; first {st['render_s']:.3f} s) [{card}]; "
          f"launches per frame: " + ", ".join(f"{k} {n}" for k, n in
                                                counts.items()))
    if min(counts.values()) == 0:
        raise AssertionError(f"config 5 missed a kernel: {counts}")
    counts.update(binning)
    if not all(bool(torch.isfinite(x).all()) for x in (img, alb, nrm)):
        raise AssertionError("config 5's frame has non-finite values")
    plain = dataclasses.replace(inter, raster=None)
    zero_counts()
    (ref, _, _), st3 = benchmarks.run(cfg, intersector=plain)
    print(f"[path sponza] without raster tables (camera waves on B): "
          f"{st3['render_s']:.3f} s/frame; launches A {K['A'].launches}, B "
          f"{K['B'].launches}, C {K['C'].launches}")
    if K["A"].launches:
        raise AssertionError("the frame without raster tables launched A")
    a, b = (color_to_uint8(x).cpu().numpy() for x in (img, ref))
    agree(a, b, "config 5 with raster tables vs without")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    write_png(OUT_DIR / "path_sponza.png", a)
    return counts


def cornell_cell(card: str) -> dict:
    """Phase 11 (b): config 4 (Cornell box, NEE+MIS) at 1024x1024, depth
    8, its 1024 spp cut to CORNELL_SPP.  Returns the launches of A, B,
    K-N and S-U."""
    import torch

    from optix_ray_tracer_tpu_torch.models import benchmarks
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )

    cfg = benchmarks.config4_cornell(device=torch.device("cuda", 0))
    benchmarks.run(cfg, spp=1)              # the intersector's first use
    zero_counts()
    (img, _, _), st = benchmarks.run(cfg, spp=CORNELL_SPP)
    counts = {k: K[k].launches for k in "ABKLMN"}
    print(f"[path cornell] config 4, {cfg['width']}x{cfg['height']}, spp "
          f"{CORNELL_SPP} (of {cfg['spp']}), depth {cfg['max_depth']}, "
          f"{st['triangles']} triangles, {cfg['lights'].count} light "
          f"triangles: {st['render_s']:.3f} s, {st['spp_per_sec']:.3f} "
          f"spp/s, {st['mpaths_per_sec']:.2f} Mpaths/s [{card}]; launches "
          + ", ".join(f"{k} {n}" for k, n in counts.items()))
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        raise AssertionError("the Cornell frame is not finite and lit")
    if min(counts.values()) == 0:
        raise AssertionError(f"config 4 missed a kernel: {counts}")
    counts.update(launch_counts(BIN_KEYS))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    write_png(OUT_DIR / "path_cornell.png", color_to_uint8(img))
    return counts


@contextlib.contextmanager
def bundle_log(log: list, waves: list | None = None, keep: int = 0):
    """Within the block, log (pair count, capacity) of every bundle wave
    (``raster.BUNDLE_OBSERVERS``), and keep the ``bundle_stage``
    arguments (args, kw) of the first ``keep`` waves in ``waves``."""
    from optix_ray_tracer_tpu_torch.ops import raster

    def observe(args, kw, S):
        if waves is not None and len(waves) < keep:
            waves.append((args, kw))
        # the query reads the count on the host anyway
        log.append((int(S["pc_total"]), args[6]))

    raster.BUNDLE_OBSERVERS.append(observe)
    try:
        yield
    finally:
        raster.BUNDLE_OBSERVERS.remove(observe)


def bundle_counts(log: list) -> str:
    """The pair counts of a run's bundle waves (DEPTH per frame, in
    bounce order) against their capacity."""
    pcs = np.asarray([pc for pc, _ in log])
    fits = np.asarray([pc <= cap for pc, cap in log])
    by_bounce = [int(fits[b::DEPTH].sum()) for b in range(DEPTH)]
    return (f"{len(log)} NEE bundle waves, pair counts {int(pcs.min())}-"
            f"{int(pcs.max())} (median {int(np.median(pcs))}) against "
            f"pc_max {log[0][1]} (the heuristic): {int(fits.sum())} fit "
            f"(by bounce 0-{DEPTH - 1}: {by_bounce}), "
            f"{len(log) - int(fits.sum())} overflowed to the marcher")


def path_pile_configs(root: Path):
    """Phase 10's pile series written under ``root``, and a function
    ``config(name, half, integrator="path", **extra)`` that writes phase
    10's config with that integrator and an emissive 2*half x 2*half panel
    ANIM_LIGHT[0] above the pile (an EMISSIVE OBJ extra), or with no
    panel for ``half`` None, and returns its path."""
    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    poses = pile_poses(N_PARTICLES, ANIM_TIMES)
    series, stl_dir = write_time_series(
        root / "time", [sphere_with_n_triangles(s) for s in TIME_LIBRARY],
        poses, ANIM_TIMES)
    z, _, radiance = ANIM_LIGHT

    def config(name, half, integrator="path", **extra):
        if half is None:
            return write_anim_config(
                root / name, series, stl_dir, root / "cache", ANIM_WIDTH,
                ANIM_HEIGHT, ANIM_FPS, integrator=integrator, **extra)
        light = write_light_obj(root / f"light_{half:g}.obj", z, half)
        return write_anim_config(
            root / name, series, stl_dir, root / "cache", ANIM_WIDTH,
            ANIM_HEIGHT, ANIM_FPS, integrator=integrator,
            emissives=[{"emission": [radiance] * 3}],
            meshes=[{"obj": f"{Path(name).stem}.ground.obj",
                     "mat-type": "ROUGH", "mat-index": 0},
                    {"obj": str(light), "mat-type": "EMISSIVE",
                     "mat-index": 0}], **extra)
    return config


def path_animation(card: str):
    """Phase 11 (c): phase 10's pile series and config with
    ``"integrator": "path"`` and an emissive panel above the pile (an
    EMISSIVE OBJ extra), through ``__main__.main``: the flatten route
    (fused, temporal on) for ANIM_PATH_FRAMES frames; the same with the
    ANIM_LARGE_LIGHT panel for ANIM_LARGE_FRAMES (its NEE waves overflow
    the bundle capacity and take the marcher); the TLAS route
    (``ORT_TIME_TLAS=1``) for ANIM_TLAS_FRAMES; and with ``temporal`` off
    flatten frame 0 against TLAS frame 0.  Returns (launches of A-F by
    name, A's bundle launches, frame 0's NEE waves as ``bundle_stage``
    arguments)."""
    import os
    import tempfile

    import torch

    from optix_ray_tracer_tpu_torch.models import fused
    from optix_ray_tracer_tpu_torch.models import renderer_time as rt

    tmp = tempfile.TemporaryDirectory(prefix="anim_path_")
    root = Path(tmp.name)
    launches = {K[k].name: 0 for k in (*"ABCDEFKLMN", *BIN_KEYS)}
    try:
        config = path_pile_configs(root)
        z, half, radiance = ANIM_LIGHT
        cfg = config("path.json", half)
        print(f"[path anim] phase 10's series with \"integrator\": \"path\" "
              f"and a {2 * half:g} x {2 * half:g} emissive panel at z = {z:g} "
              f"(radiance {radiance:g}); {ANIM_WIDTH}x{ANIM_HEIGHT}, spp 1, "
              f"depth {DEPTH}, a-trous, temporal on")

        def flatten_run(cfg, out, frames, waves=None):
            """The fused flatten route for ``frames`` frames: (launches
            of A-F, A's launches on bundle schedules, the bundle log,
            wall s/frame over frames 2..)."""
            refits, log = [], []
            zero_counts()
            with bundle_log(log, waves, DEPTH), \
                    timed_calls(fused, "refit_march_intersector", refits):
                run_cli(["--config", cfg, "--output", root / out,
                         "--frames", frames])
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
            counts = launch_counts((*"ABCDEFKLMN", *BIN_KEYS))
            for k in counts:
                launches[K[k].name] += counts[k]
            check_pngs(sorted((root / out).glob("frame_*.png")), out)
            wall = refits[2][1].elapsed_time(end) / (frames - 2) / 1e3
            return counts, K["A"].variants.get("None", 0), log, wall

        # 1. the flatten route, fused: NEE segments on the bundle engine
        waves = []
        counts, bundle_launches, log, per_frame = flatten_run(
            cfg, "out1", ANIM_PATH_FRAMES, waves)
        print(f"[path anim] flatten route, fused, {ANIM_PATH_FRAMES} frames "
              f"[{card}]: wall {per_frame:.4f} s/frame over frames 2-"
              f"{ANIM_PATH_FRAMES - 1} (CUDA events, PNGs included); "
              f"launches per frame: " + ", ".join(
                  f"{k} {counts[k] / ANIM_PATH_FRAMES:.2f}" for k in "ABCFK")
              + f" (A on bundle schedules {bundle_launches})")
        print(f"[path anim] {bundle_counts(log)}")
        if min(counts[k] for k in "BCFKLMN") == 0 or not log:
            raise AssertionError("the path loop missed B, C, F, K-N or the "
                                 "bundle engine")
        if bundle_launches == 0:
            raise AssertionError("no NEE wave ran kernel A on a bundle "
                                 "schedule")

        # 1b. a larger panel: the heuristic capacity overflows
        big = ANIM_LARGE_LIGHT
        counts, big_launches, log, per_frame = flatten_run(
            config("path_large.json", big), "out_large", ANIM_LARGE_FRAMES)
        print(f"[path anim] flatten route with a {2 * big:g} x {2 * big:g} "
              f"panel, {ANIM_LARGE_FRAMES} frames [{card}]: wall "
              f"{per_frame:.4f} s/frame over frames 2-"
              f"{ANIM_LARGE_FRAMES - 1}; launches per frame: " + ", ".join(
                  f"{k} {counts[k] / ANIM_LARGE_FRAMES:.2f}" for k in "ABCFK")
              + f" (A on bundle schedules {big_launches}); "
              + bundle_counts(log))
        bundle_launches += big_launches

        # 2. the TLAS route
        zero_counts()
        os.environ["ORT_TIME_TLAS"] = "1"
        tlas_frames = []
        try:
            with timed_calls(rt, "tlas_frame_intersector", tlas_frames):
                run_cli(["--config", cfg, "--output", root / "out2",
                         "--frames", ANIM_TLAS_FRAMES])
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
        finally:
            del os.environ["ORT_TIME_TLAS"]
        for k in (*"DEKLMN", *BIN_KEYS):
            launches[K[k].name] += K[k].launches
        per_frame = (tlas_frames[1][1].elapsed_time(end)
                     / (ANIM_TLAS_FRAMES - 1) / 1e3)
        print(f"[path anim] TLAS route [{card}]: wall {per_frame:.4f} "
              f"s/frame over frames 1-{ANIM_TLAS_FRAMES - 1}; launches per "
              f"frame D {K['D'].launches / ANIM_TLAS_FRAMES:.2f}, E "
              f"{K['E'].launches / ANIM_TLAS_FRAMES:.2f} (its NEE waves "
              f"take E: the TLAS intersector has no bundle engine)")
        if min(K[k].launches for k in "DEKLMN") == 0:
            raise AssertionError("the TLAS path loop missed kernel D, E "
                                 "or K-N")
        tlas_imgs = check_pngs(sorted((root / "out2").glob("frame_*.png")),
                               "path TLAS")

        # 3. temporal off: flatten frame 0 against TLAS frame 0
        zero_counts()
        log = []
        with bundle_log(log):
            run_cli(["--config", config("path_nt.json", half,
                                         temporal=False),
                     "--output", root / "out3", "--frames", 1])
        for k in (*"ABCFKLMN", *BIN_KEYS):
            launches[K[k].name] += K[k].launches
        nt_launches = K["A"].variants.get("None", 0)
        bundle_launches += nt_launches
        flat = check_pngs(sorted((root / "out3").glob("frame_*.png")),
                          "path flatten, temporal off")
        print(f"[path anim] temporal off: A on bundle schedules "
              f"{nt_launches}; {bundle_counts(log)}")
        agree(flat[0], tlas_imgs[0], "path flatten frame 0 vs TLAS frame 0")
        from optix_ray_tracer_tpu_torch.utils.color import write_png
        write_png(OUT_DIR / "path_anim_flatten_frame0.png", flat[0])
    finally:
        tmp.cleanup()
    return launches, bundle_launches, waves


def sun_wave(o, d, hit):
    """An ortho wave: from the hit points of the camera wave (o, d) along
    config 5's sun direction; dead where the camera ray missed.  Returns
    (o, d, t_min, t_max)."""
    import torch
    sun = torch.tensor(SUN, device=o.device)
    sun = sun / torch.linalg.norm(sun)
    p = torch.where(hit.is_hit[:, None], o + hit.t[:, None] * d, o)
    n = o.shape[0]
    return (p + sun * 1e-3, sun.expand(n, 3).contiguous(),
            torch.full((n,), 1e-4, device=o.device),
            torch.where(hit.is_hit, 1e16, 0.0))


def ortho_rows(b: SimpleNamespace, t: SimpleNamespace, card: str):
    """Phase 11 (d): A's and D's ``common="dir"`` variant on sun waves
    from phase 2's bench camera wave and phase 6's TLAS camera wave (any-hit
    and nearest): each driven through ``intersect_from(mode="ortho")`` with
    the counts zeroed (held to the marcher under the hit rule), then each
    schedule's kernel against its plain twin on the whole wave.  Returns
    ({row name: JSON row}, {row name: launches of the variant})."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    from optix_ray_tracer_tpu_torch.ops.intersect import hit_mismatches
    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr
    from optix_ray_tracer_tpu_torch.ops.march import (
        DEFAULT_ANYHIT_GRANULARITY, DEFAULT_GRANULARITY,
    )

    W = TILE * TILE
    rows, launches = {}, {}
    print(f"[ortho] sun waves along {SUN} (normalised) from camera-wave hit "
          f"points, A and D common=\"dir\"")
    # A: the bench sphere
    hit0 = b.inter.intersect_from(b.scene, b.o, b.d, mode="origin",
                                  point=b.o[0], pc_max=b.pc_max1)
    wave = sun_wave(b.o, b.d, hit0)
    a_rows, a_launch = [], 0
    for any_hit in (False, True):
        g = DEFAULT_ANYHIT_GRANULARITY if any_hit else DEFAULT_GRANULARITY
        pc = raster.round_pc_max(raster.measure_pair_count(
            b.inter.raster, b.cs, *wave, "ortho", granularity=g))
        zero_counts()
        got = b.inter.intersect_from(b.scene, wave[0], wave[1], mode="ortho",
                                     t_min=wave[2], t_max=wave[3],
                                     any_hit=any_hit, pc_max=pc)
        torch.cuda.synchronize()
        a_launch += K["A"].variants.get("dir", 0)
        ref = b.inter.for_incoherent().intersect(b.scene, *wave)
        bad = (int((got.is_hit != ref.is_hit).sum()) if any_hit else
               hit_mismatches(got.prim_id, got.t, ref.prim_id, ref.t))
        label = "any-hit" if any_hit else "nearest"
        print(f"  A dir {label} via intersect_from(mode=\"ortho\"): "
              f"{K['A'].variants} launches; vs the marcher {bad} "
              f"mismatches, {int(got.is_hit.sum())} hits of "
              f"{int((wave[3] > 0).sum())} live rays")
        if bad or K["A"].variants.get("dir", 0) != 1:
            raise AssertionError("A's ortho wave disagrees or missed \"dir\"")
        S = raster._coarse_stage(b.inter.raster, b.cs, *wave, "ortho", None,
                                 W, pc, g)
        a_rows.append(raster_wave(
            f"A dir sun wave {label}", tr.raster_cluster_call,
            tr.raster_cluster_plain, raster.schedule_inputs(b.cs, S, S["nb"],
                                                            g),
            W, any_hit, prim_keys(b.cs), card, "dir", WOOP_SHARED_DIR_OPS))
    rows["tile_raster_dir"] = dict(a_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in a_rows))
    launches["tile_raster_dir"] = a_launch

    # D: the Time pile's TLAS
    tlas = time_frame(t, 0).tlas
    h0, _ = tlas.intersect_from(t.o, t.d, point=t.o[0],
                                pc_max=raster.round_pc_max(t.pc1))
    wave = sun_wave(t.o, t.d, h0)

    def keys(slot):
        pos = slot.clamp(min=0).long()
        pair = pos // 256
        lib_slot = tlas.pair_shape.long()[pair] * 256 + pos % 256
        key = (tlas.pair_inst.long()[pair] << 16) \
            + tlas.library.prim_index.long()[lib_slot]
        return torch.where(slot < 0, -1, key)

    d_rows, d_launch = [], 0
    pc = raster.round_pc_max(ri.measure_instanced_pair_count(
        tlas, *wave, "ortho", None))
    for any_hit in (False, True):
        zero_counts()
        got, gi = tlas.intersect_from(wave[0], wave[1], mode="ortho",
                                      t_min=wave[2], t_max=wave[3],
                                      any_hit=any_hit, pc_max=pc)
        torch.cuda.synchronize()
        d_launch += K["D"].variants.get("dir", 0)
        ref, ri_ = tlas.intersect(*wave, any_hit)
        label = "any-hit" if any_hit else "nearest"
        if any_hit:
            bad = int((got.is_hit != ref.is_hit).sum())
        else:
            kg = torch.where(got.is_hit, (gi.long() << 20) + got.prim_id, -1)
            kr = torch.where(ref.is_hit, (ri_.long() << 20) + ref.prim_id,
                             -1)
            bad = hit_mismatches(kg, got.t, kr, ref.t)
        print(f"  D dir {label} via intersect_from(mode=\"ortho\"): "
              f"{K['D'].variants} launches; vs the marcher {bad} "
              f"mismatches, {int(got.is_hit.sum())} hits of "
              f"{int((wave[3] > 0).sum())} live rays")
        if bad or K["D"].variants.get("dir", 0) != 1:
            raise AssertionError("D's ortho wave disagrees or missed \"dir\"")
        S = ri.instanced_coarse_stage(tlas.pair_min, tlas.pair_max, *wave,
                                      "ortho", None, W, pc, tlas.pair_shape,
                                      tlas.pair_inst)
        d_rows.append(raster_wave(
            f"D dir sun wave {label}", tr.raster_instanced_call,
            tr.raster_instanced_plain, ri.instanced_schedule_inputs(tlas, S),
            W, any_hit, keys, card, "dir", WOOP_SHARED_DIR_OPS))
    rows["tile_raster_instanced_dir"] = dict(d_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in d_rows))
    launches["tile_raster_instanced_dir"] = d_launch
    return rows, launches


def block_subset(inp: dict, W: int, blocks) -> dict:
    """The raster schedule ``inp`` cut to the tiles ``blocks`` (ascending),
    renumbered 0.., with the trailing dead block: the same pairs in the
    same order for those tiles."""
    import torch
    nb = inp["n_blocks"]
    dev = inp["pair_tiles"].device
    blocks = torch.as_tensor(blocks, device=dev)
    new = torch.full((nb + 1,), len(blocks), dtype=torch.int32, device=dev)
    new[blocks] = torch.arange(len(blocks), dtype=torch.int32, device=dev)
    keep = torch.isin(inp["pair_tiles"], blocks.to(torch.int32))
    cols = torch.cat([(blocks[:, None] * W + torch.arange(W, device=dev)
                       ).reshape(-1), torch.arange(nb * W, (nb + 1) * W,
                                                   device=dev)])
    return dict(inp, pair_tiles=new[inp["pair_tiles"][keep].long()],
                pair_clusters=inp["pair_clusters"][keep],
                rays_t_ext=inp["rays_t_ext"][:, cols].contiguous(),
                n_blocks=len(blocks))


def full_schedule(args, kw):
    """(bundle_stage's schedule at the capacity its pair count needs, that
    capacity) for a wave's ``bundle_stage`` arguments."""
    from optix_ray_tracer_tpu_torch.ops import raster
    S = raster.bundle_stage(*args, **kw)
    pc = raster.round_pc_max(int(S["pc_total"]))
    if pc > args[6]:
        S = raster.bundle_stage(*args[:6], pc, **kw)
    return S, pc


def bundle_row(waves, card: str) -> dict:
    """Phase 11 (e): kernel A (common=None, the bundle walk) on the first
    NEE bundle wave of the path animation's flatten run, the whole wave
    timed, against its plain twin on BUNDLE_BLOCKS blocks spread over the
    wave and the block with the longest row (t, slot, u, v and the
    Woop-tested rows equal).  The bound counts the work its live rays need
    up to their first hit in the kernel's visit order
    (:func:`needed_raster_work`) at WOOP_OPS per Woop test."""
    import torch

    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops.kernels import tile_raster as tr

    args, kw = waves[0]
    clusters, W = args[0], args[5]
    # the whole schedule, whatever capacity the wave ran at
    S, _ = full_schedule(args, kw)
    nb = S["nb"]
    inp = raster.schedule_inputs(clusters, S, nb)
    call = dict(w=W, any_hit=True, common=None)
    kern = tr.raster_cluster_call(**inp, **call, visits=True)
    ms = time_ms(lambda: tr.raster_cluster_call(**inp, **call), REPS)
    cnt = S["cnt_b"].long()
    blocks = torch.linspace(0, nb - 1, min(BUNDLE_BLOCKS, nb)).round().long()
    blocks = torch.unique(torch.cat([blocks, cnt.argmax().reshape(1).cpu()]))
    sub = block_subset(inp, W, blocks)
    ks = tr.raster_cluster_call(**sub, **call, visits=True)
    ref, p_ms = time_once(lambda: tr.raster_cluster_plain(**sub, **call,
                                                          visits=True))
    err = compare("A bundle NEE wave (block subset)", prim_keys(clusters),
                  ks, ref, True)
    same = all(bool(torch.equal(a, b)) for a, b in zip(ks, ref))
    if not same:
        raise AssertionError("A on the bundle schedule differs from its "
                             "plain twin")
    work = tr.needed_raster_work(inp, W, kern[0], kern[1], any_hit=True)
    n_pairs = int((inp["pair_tiles"] < nb).sum())
    run = int(kern[4].sum())             # the bundle walk counts its tests
    live = (S["tmax_p"][:nb * W] > S["tmin_p"][:nb * W]).reshape(nb, W)
    n_live = int(live.sum())
    packed = (live.sum(1) + 31) // 32
    r = row(err, ms, p_ms, tensor_bytes(inp, kern),
            work["slab"] * SLAB_OPS + work["woop"] * WOOP_OPS)
    print(f"  A bundle NEE wave: {nb} blocks of {W} rays, {n_live} live "
          f"({n_live / (nb * W):.3f}) in {int(packed.sum())} packed warps "
          f"(of {nb * W // 32}), {n_pairs} pairs ({int(S['pc_total'])}), "
          f"rows mean {cnt.float().mean():.1f}, longest {int(cnt.max())} "
          f"(block {int(cnt.argmax())}), staged 64 pairs at a time "
          f"(kChunk); {int(((packed + 3) // 4).sum())} CTAs of 4 packed "
          f"warps walk; kernel "
          f"{ms:.3f} ms [{card}], plain {p_ms:.1f} ms on {len(blocks)} "
          f"blocks, the longest row's among them (equal, Woop-tested rows "
          f"included); Woop tests run {run}, needed {work['woop']} "
          f"({run / max(work['woop'], 1):.2f}x), slab tests needed "
          f"{work['slab']}; bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
          f"{100 * r['bound_ms'] / ms:.2f}% of the wave; "
          f"{tr.raster_occupancy(False, True, None)} resident warps per SM")
    return r


def path_phase(b: SimpleNamespace, t: SimpleNamespace, card: str):
    """Phase 11, the path tracer: (a) config 5, (b) config 4, (c) the
    path-traced animation, (d) the ortho kernels, (e) A on a bundle NEE
    wave.  Returns ({row name: JSON row}, {row name: launches})."""
    launches = {}

    def add(counts):
        for k, n in counts.items():
            name = K[k].name
            launches[name] = launches.get(name, 0) + n

    add(sponza_cell(card))
    add(cornell_cell(card))
    anim, bundle_launches, nee = path_animation(card)
    for name, n in anim.items():
        launches[name] = launches.get(name, 0) + n
    rows, variant = ortho_rows(b, t, card)
    launches.update(variant)
    rows["tile_raster_bundle"] = bundle_row(nee, card)
    launches["tile_raster_bundle"] = bundle_launches
    return rows, launches


# ---- phase 12: the product extras ------------------------------------------

RESTIR_FLAT_FRAMES = 4            # ReSTIR on the path pile, per-frame loop
RESTIR_TLAS_FRAMES = 2
PROGRESSIVE_SPP = 32              # --progressive; the split run stops at half
SOBOL_FRAMES = 4
VIEWER_SIZES = ((320, 240), (640, 480))
VIEWER_WINDOW = 4.0               # seconds of /stream read at each size
VIEWER_LIMIT = 240                # the viewer subprocess's time limit, s


@contextlib.contextmanager
def shared_builds():
    """Within the block, ``models/common.choose_intersector`` builds each
    distinct scene (triangle count and vertex and material checksums)
    once: phase 12 renders the pile's frame 0 in a dozen CLI runs, and the
    host SAH build of its 862k triangles (~10 s) is the same every time.
    Yields the cache (scene key -> intersector)."""
    from optix_ray_tracer_tpu_torch.models import common
    real = common.choose_intersector
    cache = {}

    def cached(scene):
        v = scene.triangles.vertices.double()
        key = (scene.triangle_count, float(v.sum()), float((v * v).sum()),
               float(scene.triangles.material_id.double().sum()))
        if key not in cache:
            cache[key] = real(scene)
        return cache[key]

    common.choose_intersector = cached
    try:
        yield cache
    finally:
        common.choose_intersector = real


#: the keys of K's variant counts: T's and U's bundle launches, S's on
#: pairs and boxes; with S, T and U, the binning's
BIN_VARIANTS = ("t", "u", "s_pair", "s_box")
BIN_KEYS = ("S", "T", "U") + BIN_VARIANTS


def launch_counts(keys=tuple("ABCDEFHIJKLMNOPQRSTU") + BIN_VARIANTS) -> dict:
    """{key: launches} of K's counters ``keys`` (letters or names)."""
    return {k: K[k].launches for k in keys}


def counts_text(counts: dict, per: int = 1) -> str:
    return ", ".join(f"{k} {n / per:g}" for k, n in counts.items())


def restir_pile(card: str, config, root: Path, add) -> None:
    """Phase 12 (a): the path pile (phase 11c's series and 4x4 panel)
    through the CLI with ``"integrator": "restir"`` and ``"restir-gi"``:
    RESTIR_FLAT_FRAMES frames flattened (the per-frame loop: ReSTIR keeps
    no fused chunk) and RESTIR_TLAS_FRAMES through the TLAS route, temporal
    off; flatten frame 0 against TLAS frame 0."""
    import os

    from optix_ray_tracer_tpu_torch.models import common

    for integ in ("restir", "restir-gi"):
        cfg = config(f"{integ}.json", ANIM_LIGHT[1], integrator=integ,
                     temporal=False)
        imgs = {}
        for route, frames in (("flatten", RESTIR_FLAT_FRAMES),
                              ("TLAS", RESTIR_TLAS_FRAMES)):
            out = root / f"{integ}_{route}"
            times = []
            zero_counts()
            if route == "TLAS":
                os.environ["ORT_TIME_TLAS"] = "1"
            try:
                with host_timed(common, "render_frame", times):
                    run_cli(["--config", cfg, "--output", out, "--frames",
                             frames])
            finally:
                os.environ.pop("ORT_TIME_TLAS", None)
            counts = launch_counts()
            add(counts)
            imgs[route] = check_pngs(sorted(out.glob("frame_*.png")),
                                     f"{integ} {route}")
            print(f"[extras restir] {integ}, {route} route, {frames} frames "
                  f"[{card}]: render_frame {times[-1]:.4f} s/frame (last; "
                  f"all {', '.join(f'{x:.3f}' for x in times)}); launches "
                  f"per frame: {counts_text(counts, frames)}")
            # ReSTIR's camera wave is a plain coherent query, as in the
            # JAX package (F flattened, E through the TLAS), not the
            # raster engine's
            need = "E" if route == "TLAS" else "BCF"
            if min(counts[k] for k in need) == 0:
                raise AssertionError(f"{integ} {route} missed one of {need}")
        agree(imgs["flatten"][0], imgs["TLAS"][0],
              f"{integ} flatten frame 0 vs TLAS frame 0")
        from optix_ray_tracer_tpu_torch.utils.color import write_png
        write_png(OUT_DIR / f"{integ}_pile_frame0.png", imgs["flatten"][0])


def restir_gi_cornell(card: str, add) -> None:
    """Phase 12 (b): config 4 (the Cornell box) at 1024x1024, depth 8,
    CORNELL_SPP samples through ``render_restir_gi_progressive`` (the
    ``"restir-gi"`` entry: reservoirs carried across the samples, 16
    candidates, 2 spatial taps) beside the path tracer at pixel centers
    (ReSTIR renders pixel centers) with the same spp: the image means
    within 2% (the JAX package's bound, tests/test_restir.py:330)."""
    import torch

    from optix_ray_tracer_tpu_torch.models import benchmarks
    from optix_ray_tracer_tpu_torch.models.common import choose_intersector
    from optix_ray_tracer_tpu_torch.render import pathtracer, restir
    from optix_ray_tracer_tpu_torch.utils.color import (
        color_to_uint8, write_png,
    )

    cfg = benchmarks.config4_cornell(device=torch.device("cuda", 0))
    inter = choose_intersector(cfg["scene"])
    w, h, depth = cfg["width"], cfg["height"], cfg["max_depth"]
    args = (cfg["scene"], cfg["materials"], cfg["lights"], cfg["camera"],
            w, h)
    kw = dict(seed=0, max_depth=depth, intersector=inter,
              background=cfg["background"])
    restir.render_restir_gi_progressive(*args, spp=1, **kw)   # warm-up

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (path, _, _), path_s = timed(lambda: pathtracer.render_path(
        *args, spp=CORNELL_SPP, jitter=False, **kw))
    zero_counts()
    (gi, _, _), gi_s = timed(lambda: restir.render_restir_gi_progressive(
        *args, spp=CORNELL_SPP, **kw))
    counts = launch_counts("ABCKLMN")
    add(counts)
    pm, gm = float(path.mean()), float(gi.mean())
    print(f"[extras restir-gi] config 4, {w}x{h}, spp {CORNELL_SPP}, depth "
          f"{depth} [{card}]: restir-gi {gi_s:.3f} s, "
          f"{CORNELL_SPP / gi_s:.3f} spp/s; path tracer (pixel centers) "
          f"{path_s:.3f} s, {CORNELL_SPP / path_s:.3f} spp/s; image means "
          f"{gm:.5f} vs {pm:.5f} ({(gm / pm - 1) * 100:+.2f}%); launches "
          f"{counts_text(counts)}")
    if not bool(torch.isfinite(gi).all()):
        raise AssertionError("the restir-gi frame is not finite")
    if abs(gm - pm) > 0.02 * pm:
        raise AssertionError("restir-gi's mean is not within 2% of the "
                             "path tracer's")
    write_png(OUT_DIR / "restir_gi_cornell.png", color_to_uint8(gi))


def progressive_runs(card: str, config, root: Path, add) -> None:
    """Phase 12 (c): ``--progressive PROGRESSIVE_SPP`` on the path pile's
    frame 0 at 1200x800, straight and as half of it resumed from its
    checkpoint: the PNGs and checkpoints bit-equal; uniform (path), with
    ``--adaptive`` (path) and with ``"integrator": "restir"`` (whose
    batches after the first fold sample_offset into the seed, wrapped to
    int32)."""
    import numpy as np

    from optix_ray_tracer_tpu_torch.models import common
    from optix_ray_tracer_tpu_torch.render import adaptive

    for integ, flags in (("path", []), ("path", ["--adaptive"]),
                         ("restir", [])):
        cfg = config(f"prog_{integ}.json", ANIM_LIGHT[1], integrator=integ)
        label = integ + (" --adaptive" if flags else "")
        module, fn = ((adaptive, "adaptive_batch") if flags
                      else (common, "render_frame"))
        results, times = [], []
        zero_counts()
        for name, steps in (("straight", [PROGRESSIVE_SPP]),
                            ("resumed", [PROGRESSIVE_SPP // 2,
                                         PROGRESSIVE_SPP])):
            out = root / f"prog_{integ}{'_adaptive' if flags else ''}_{name}"
            for spp in steps:
                with host_timed(module, fn, times):
                    run_cli(["--config", cfg, "--output", out,
                             "--progressive", spp, "--checkpoint",
                             out / "ckpt.npz", *flags])
            with np.load(out / "ckpt.npz") as z:
                arrays = {k: z[k] for k in z.files}
            results.append(((out / "progressive.png").read_bytes(), arrays))
        counts = launch_counts()
        add(counts)
        (pa, ca), (pb, cb) = results
        same = pa == pb and ca.keys() == cb.keys() and all(
            np.array_equal(ca[k], cb[k]) for k in ca)
        print(f"[extras progressive] {label}, {PROGRESSIVE_SPP} spp at "
              f"{ANIM_WIDTH}x{ANIM_HEIGHT} [{card}]: {len(times)} batches in "
              f"the two runs, {np.mean(times):.4f} s per batch (median "
              f"{np.median(times):.4f}); straight vs resumed at "
              f"{PROGRESSIVE_SPP // 2}: PNG and checkpoint "
              f"{'bit-equal' if same else 'DIFFER'}; launches "
              f"{counts_text(counts)}")
        if not same:
            raise AssertionError(f"{label}: the resumed run differs")
        (OUT_DIR / f"progressive_{label.replace(' --', '_')}.png"
         ).write_bytes(pa)


def sobol_series(card: str, config, root: Path, add) -> None:
    """Phase 12 (d): phase 10's series and config (whitted, a-trous,
    temporal on) through the fused loop for SOBOL_FRAMES frames with
    ``"sampler": "pcg"`` and then ``"sobol"``: wall s/frame over frames
    2.. by CUDA events, as phase 11c."""
    import torch

    from optix_ray_tracer_tpu_torch.models import fused

    for sampler in ("pcg", "sobol"):
        cfg = config(f"sampler_{sampler}.json", None, integrator="whitted",
                     sampler=sampler)
        refits = []
        zero_counts()
        with timed_calls(fused, "refit_march_intersector", refits):
            run_cli(["--config", cfg, "--output", root / f"s_{sampler}",
                     "--frames", SOBOL_FRAMES])
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
        counts = launch_counts()
        add(counts)
        check_pngs(sorted((root / f"s_{sampler}").glob("frame_*.png")),
                   f"sampler {sampler}")
        wall = refits[2][1].elapsed_time(end) / (SOBOL_FRAMES - 2) / 1e3
        print(f"[extras sobol] phase 10's series, sampler {sampler}, fused, "
              f"{SOBOL_FRAMES} frames [{card}]: wall {wall:.4f} s/frame over "
              f"frames 2-{SOBOL_FRAMES - 1}; launches per frame: "
              f"{counts_text(counts, SOBOL_FRAMES)}")
        rng_kernel = "I" if sampler == "sobol" else "H"
        if min(counts[k] for k in "BCFJ" + rng_kernel) == 0:
            raise AssertionError(f"sampler {sampler} missed a kernel: "
                                 f"{counts}")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stream_parts(resp, seconds: float, during=None) -> list:
    """The payloads of the multipart parts read from ``resp`` for
    ``seconds``; ``during(fraction)`` is called as the window passes."""
    buf, t0, done = b"", time.perf_counter(), 0.0
    while (elapsed := time.perf_counter() - t0) < seconds:
        buf += resp.read1(1 << 16)
        if during is not None and elapsed / seconds >= done + 0.25:
            done += 0.25
            during(done)
    parts = []
    for chunk in buf.split(b"--frame\r\n")[1:]:
        head, sep, body = chunk.partition(b"\r\n\r\n")
        if sep and body.endswith(b"\r\n"):
            parts.append(body[:-2])
    return parts


def viewer_cell(card: str, config, root: Path, add) -> None:
    """Phase 12 (e): ``python -m optix_ray_tracer_tpu_torch --viewer --port
    P`` on phase 10's pile (whitted: the fused chunk path) in a subprocess
    at each of VIEWER_SIZES: after its first frame, /stream is read for
    VIEWER_WINDOW seconds while /key, /look and /wheel arrive; fps =
    distinct frames over the window; then /quit, and the process must
    exit 0 within VIEWER_LIMIT.  Its kernel launches come from its log."""
    import os
    import re
    import threading
    import urllib.request

    cfg = config("viewer.json", None, integrator="whitted")
    repo = Path(__file__).resolve().parent
    for w, h in VIEWER_SIZES:
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        proc = subprocess.Popen(
            [sys.executable, "-m", "optix_ray_tracer_tpu_torch", "--config",
             str(cfg), "--viewer", "--port", str(port), "--width", str(w),
             "--height", str(h)], cwd=repo,
            env=dict(os.environ, PYTHONPATH=str(repo)),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        lines = []
        reader = threading.Thread(target=lambda: lines.extend(proc.stderr),
                                  daemon=True)
        reader.start()

        def get(path, timeout=5.0):
            with urllib.request.urlopen(base + path, timeout=timeout) as r:
                return r.read()

        def steer(fraction):
            get({0.25: "/key?k=w", 0.5: "/look?dx=12&dy=-4",
                 0.75: "/wheel?d=1"}.get(fraction, "/key?k=d"))

        t_start = time.perf_counter()
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError("the viewer exited early:\n"
                                         + "".join(lines[-20:]))
                try:
                    get("/", timeout=2.0)
                    break
                except OSError:
                    if time.perf_counter() - t_start > VIEWER_LIMIT:
                        raise AssertionError("the viewer never served")
                    time.sleep(0.2)
            with urllib.request.urlopen(base + "/stream",
                                        timeout=VIEWER_LIMIT) as r:
                r.read1(1 << 16)     # blocks until the first frame is out
                startup = time.perf_counter() - t_start
                parts = stream_parts(r, VIEWER_WINDOW, steer)
        finally:
            try:
                get("/quit")
            except OSError:
                pass
            try:
                rc = proc.wait(timeout=VIEWER_LIMIT)
            finally:
                proc.kill()
                reader.join(timeout=10)
        log = "".join(lines)
        distinct = sum(1 for a, b in zip(parts, parts[1:]) if a != b)
        enc = re.search(r"(jpeg|png) stream parts", log)
        launched = dict(re.findall(r"(\w+)=(\d+)", log.rsplit(
            "kernel launches:", 1)[-1])) if "kernel launches:" in log else {}
        counts = {k: int(launched.get(K[k].name, 0)) for k in "ABCDEF"}
        add(counts)
        fps = distinct / VIEWER_WINDOW
        print(f"[extras viewer] {w}x{h} [{card}]: {fps:.2f} fps "
              f"({distinct} distinct frames of {len(parts)} stream parts"
              f" in {VIEWER_WINDOW:g} s, /key /look /wheel during it); "
              f"first frame {startup:.1f} s after start; encoder "
              f"{enc.group(1) if enc else '?'}; exit {rc}; launches "
              f"{counts_text(counts)}")
        if rc != 0 or distinct == 0 or not enc:
            raise AssertionError(f"the viewer at {w}x{h} failed:\n"
                                 + "".join(lines[-20:]))


def extras_phase(card: str) -> dict:
    """Phase 12, the product extras: (a) ReSTIR on the path pile, (b)
    restir-gi on config 4, (c) progressive and adaptive with resume, (d)
    Sobol, (e) the viewer.  Returns their launches of A-F by name."""
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="extras_")
    root = Path(tmp.name)
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[K[k].name] = launches.get(K[k].name, 0) + n

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        config = path_pile_configs(root)
        with shared_builds() as builds:
            restir_pile(card, config, root, add)
            restir_gi_cornell(card, add)
            progressive_runs(card, config, root, add)
            sobol_series(card, config, root, add)
        viewer_cell(card, config, root, add)
    finally:
        tmp.cleanup()
    print(f"[extras] phase 12 in {time.perf_counter() - t0:.1f} s "
          f"({len(builds)} host builds shared by its in-process runs)")
    return launches


# ---- phase 13: the parallel layer, the trainer, the LBVH ------------------

SHARD_MESHES = ((1, 1), (4, 1), (2, 2), (1, 4))   # (tile, sample) on cuda:0
SHARD_FRAMES = 4                  # phase 10's series, one file
TRAIN_STEPS = 60                  # the JAX package's synthetic training test
TIMED_STEPS = 20                  # s/step at batch 16, crop 64
DATASET_STEPS = 100               # training on the reduced rendered set


def lsb_share(a, b) -> tuple:
    """(max |diff|, share of channels > 2 LSB) of two frames' sRGB."""
    from optix_ray_tracer_tpu_torch.utils.color import color_to_uint8
    qa = color_to_uint8(a)[..., :3].int()
    qb = color_to_uint8(b)[..., :3].int()
    return (float((a - b).abs().max()),
            float(((qa - qb).abs() > 2).float().mean()))


def sharded_frames(frame, card: str) -> dict:
    """Phase 13 (a): phase 4's frame through ``render_sharded`` on meshes
    of ``cuda:0`` repeated, each held to phase 4's image."""
    import torch

    from optix_ray_tracer_tpu_torch.parallel.sharding import (
        make_mesh, render_sharded,
    )

    launches = {}
    dev = torch.device("cuda", 0)
    for tile, sample in SHARD_MESHES:
        mesh = make_mesh(tile, sample, [dev] * (tile * sample))
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render_sharded(frame.scene, frame.mats, frame.cam, WIDTH,
                             HEIGHT, SPP, mesh, seed=frame.seed,
                             max_depth=DEPTH, intersector=frame.inter)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        counts = launch_counts("ABC")
        for k, n in counts.items():
            launches[K[k].name] = launches.get(K[k].name, 0) + n
        err, over2 = lsb_share(img, frame.img)
        print(f"[shard] {tile}x{sample} mesh on cuda:0: {s:.3f} s/frame "
              f"[{card}]; launches {counts_text(counts)}; vs phase 4's "
              f"frame max |diff| {err:.3g}, {over2:.6f} of channels > 2 LSB")
        if not torch.isfinite(img).all() or over2 >= 0.01:
            raise AssertionError(f"the {tile}x{sample} sharded frame "
                                 "disagrees with the single-device frame")
        if min(counts["B"], counts["C"]) == 0:
            raise AssertionError(f"a kernel of the sharded path never "
                                 f"launched: {counts}")
    return launches


def sharded_cli(card: str) -> dict:
    """Phase 13 (b): phase 10's series at 1200x800 through the CLI with
    ``--shard`` (the fused sharded route, 1x1 on one card) and through
    ``render_frames_sharded`` on a 4x1 mesh of cuda:0, each held to the
    unsharded CLI's PNGs; one shared host SAH build."""
    import tempfile

    import torch

    from optix_ray_tracer_tpu_torch.io.config import load_config
    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.models import renderer_time as rt
    from optix_ray_tracer_tpu_torch.parallel.animation import (
        render_frames_sharded,
    )
    from optix_ray_tracer_tpu_torch.parallel.sharding import make_mesh

    tmp = tempfile.TemporaryDirectory(prefix="shard_")
    root = Path(tmp.name)
    launches = {}

    def add(counts):
        for k, n in counts.items():
            launches[K[k].name] = launches.get(K[k].name, 0) + n

    try:
        series, stl_dir = write_time_series(
            root / "time", [sphere_with_n_triangles(s) for s in TIME_LIBRARY],
            pile_poses(N_PARTICLES, ANIM_TIMES), ANIM_TIMES)
        cfg = write_anim_config(root / "time.json", series, stl_dir,
                                root / "cache", ANIM_WIDTH, ANIM_HEIGHT,
                                ANIM_FPS)
        with shared_builds():
            runs = {}
            for tag, extra in (("plain", []), ("shard", ["--shard"])):
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_cli(["--config", cfg, "--output", root / tag,
                         "--frames", SHARD_FRAMES, *extra])
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                counts = launch_counts()
                add(counts)
                runs[tag] = check_pngs(
                    sorted((root / tag).glob("frame_*.png")), tag)
                print(f"[shard cli] {tag}: {SHARD_FRAMES} frames at "
                      f"{ANIM_WIDTH}x{ANIM_HEIGHT} in {s:.2f} s with commit "
                      f"[{card}]; launches {counts_text(counts)}")
                if len(runs[tag]) != SHARD_FRAMES:
                    raise AssertionError(f"{tag}: {len(runs[tag])} PNGs")
            if min(counts["B"], counts["C"], counts["F"]) == 0:
                raise AssertionError("--shard missed kernel B, C or F")
            dev = torch.device("cuda", 0)
            data = rt.commit(load_config(str(cfg)))
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames4 = [f.to_uint8() for _, _, f in render_frames_sharded(
                data, "time", ANIM_WIDTH, ANIM_HEIGHT, 1,
                make_mesh(4, 1, [dev] * 4), max_frames=SHARD_FRAMES,
                quantize=True)]
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            counts = launch_counts()
            add(counts)
            print(f"[shard cli] render_frames_sharded, 4x1 mesh on cuda:0: "
                  f"{SHARD_FRAMES} frames in {s:.2f} s with the device "
                  f"rebuild [{card}]; launches {counts_text(counts)}")
            del data
        for j in range(SHARD_FRAMES):
            agree(runs["shard"][j], runs["plain"][j],
                  f"--shard vs unsharded frame {j}")
            agree(frames4[j], runs["plain"][j],
                  f"4x1 mesh vs unsharded frame {j}")
    finally:
        tmp.cleanup()
    return launches


def synthetic_imgs(n=3, H=96, W=96, noise=0.25, seed=0):
    """tests/test_denoiser_training.py's synthetic noisy / clean pairs."""
    rng = np.random.default_rng(seed)
    imgs = []
    for i in range(n):
        yy, xx = np.mgrid[0:H, 0:W] / H
        alb = np.stack([0.3 + 0.6 * (xx > 0.5), 0.5 * np.ones_like(xx),
                        0.4 + 0.4 * (yy > 0.4)], -1).astype(np.float32)
        irr = (0.5 + 0.4 * np.sin(6 * xx + i) * np.cos(5 * yy)
               )[..., None].astype(np.float32) * np.ones(3, np.float32)
        clean = alb * irr
        noisy = np.maximum(
            clean + rng.normal(0, noise, clean.shape).astype(np.float32),
            0.0)
        nrm = np.stack([np.zeros_like(xx), np.zeros_like(xx),
                        np.ones_like(xx)], -1).astype(np.float32)
        imgs.append((noisy, alb, nrm, clean))
    return imgs


def trainer(card: str) -> None:
    """Phase 13 (c): the denoiser trainer on the card: the JAX package's
    synthetic test (neural > raw + 5 dB), s/step at batch 16, crop 64, and
    a reduced ``build_dataset`` trained and scored."""
    import torch

    from optix_ray_tracer_tpu_torch.render import train_denoiser as td

    dev = torch.device("cuda", 0)
    imgs = synthetic_imgs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = td.train(imgs, steps=TRAIN_STEPS, batch=8, crop=48,
                     verbose=False, device=dev)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    raw, atrous, neural = td.evaluate(model, imgs, verbose=False)
    print(f"[train] synthetic set (3 x 96x96), {TRAIN_STEPS} steps, batch 8, "
          f"crop 48: {s:.2f} s [{card}]; PSNR raw {raw:.2f} dB, a-trous "
          f"{atrous:.2f}, neural {neural:.2f} ({neural - raw:+.2f} dB over "
          f"raw)")
    if not (np.isfinite(neural) and neural > raw + 5.0):
        raise AssertionError("the trained denoiser does not beat the raw "
                             "input by 5 dB")
    td.train(imgs, steps=2, batch=16, crop=64, verbose=False, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    td.train(imgs, steps=TIMED_STEPS, batch=16, crop=64, verbose=False,
             device=dev)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / TIMED_STEPS
    print(f"[train] {per * 1e3:.2f} ms/step at batch 16, crop 64, with the "
          f"crop set's upload (host clock over {TIMED_STEPS} steps) [{card}]")

    # the reduced rendered set: 96x96, one view, two procedural training
    # scenes, clean spp 64 (256 for path scenes, the trainer's floor)
    t0 = time.perf_counter()
    train_imgs, heldout = td.build_dataset(size=96, views=1, clean_spp=64,
                                           procedural=2, verbose=False,
                                           device=dev)
    torch.cuda.synchronize()
    print(f"[train] build_dataset(size=96, views=1, clean_spp=64, "
          f"procedural=2): {len(train_imgs)} training and {len(heldout)} "
          f"held-out images in {time.perf_counter() - t0:.1f} s [{card}] "
          f"(cut from size 192, 4 views, 10 procedural scenes, clean spp "
          f"256; no reference series)")
    t0 = time.perf_counter()
    model = td.train(train_imgs, steps=DATASET_STEPS, batch=16, crop=64,
                     verbose=False, device=dev)
    torch.cuda.synchronize()
    print(f"[train] {DATASET_STEPS} steps on it in "
          f"{time.perf_counter() - t0:.2f} s [{card}] (cut from 3000)")
    for label, subset in (("train[0:4]", train_imgs[:4]),
                          ("held-out", heldout)):
        raw, atrous, neural = td.evaluate(model, subset, verbose=False)
        print(f"  {label}: raw {raw:.2f} dB | a-trous {atrous:.2f} dB | "
              f"neural {neural:.2f} dB")
        if not np.isfinite([raw, atrous, neural]).all():
            raise AssertionError(f"non-finite PSNR on {label}")


def lbvh_step(card: str) -> None:
    """Phase 13 (d): ``graft.entry``'s flagship step (64x64, spp 1, depth
    5, LBVH traversal) on the card: ms, and the camera wave's hits against
    brute force under the hit rule."""
    import torch

    from optix_ray_tracer_tpu_torch.graft import entry
    from optix_ray_tracer_tpu_torch.ops.intersect import (
        hit_mismatches, intersect_scene_bruteforce,
    )

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    fn, args = entry(device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    scene, _, cam, inter, seed = args
    ms = time_ms(lambda: fn(*args), 3)
    img = fn(*args)
    o, d = (x.reshape(-1, 3) for x in cam.generate_rays(64, 64))
    hit = inter.intersect(scene, o, d)
    ref = intersect_scene_bruteforce(scene, o, d)
    bad = hit_mismatches(hit.prim_id, hit.t, ref.prim_id, ref.t)
    occ = int((inter.any_hit(scene, o, d) != ref.is_hit).sum())
    print(f"[lbvh] flagship step 64x64 spp 1 depth 5 through the LBVH "
          f"({scene.sphere_count + scene.triangle_count} primitives, build "
          f"{build_s:.3f} s): {ms:.1f} ms (CUDA events, mean of 3) [{card}];"
          f" camera wave vs brute force: {bad} hit-rule exceptions, {occ} "
          f"occlusion mismatches of {o.shape[0]} rays")
    if bad or occ or not torch.isfinite(img).all():
        raise AssertionError("the LBVH disagrees with brute force")


def parallel_phase(frame, card: str) -> dict:
    """Phase 13: (a) sharded Whitted frames, (b) the CLI with --shard, (c)
    the trainer, (d) the LBVH step.  Returns the launches of A-F of (a)
    and (b) by name."""
    t0 = time.perf_counter()
    launches = sharded_frames(frame, card)
    for name, n in sharded_cli(card).items():
        launches[name] = launches.get(name, 0) + n
    trainer(card)
    lbvh_step(card)
    print(f"[parallel] phase 13 in {time.perf_counter() - t0:.1f} s")
    return launches


# ---- phase 14: the bounce loop's kernels H-N ------------------------------

# integer operations of the RNG (csrc/rng.cuh; a shift, logic operation,
# product, sum or shared-memory load counts as one): PCG4D's 32, one Owen
# scramble's 11, a uniform's 3, a Sobol point's four table lookups 7 each
# (the byte, its row, the 16-byte load, four XORs)
PCG_OPS = 32
OWEN_OPS = 11
UNIT_OPS = 3
SOBOL_LOOKUP_OPS = 4 * 7
# float operations of J's branches per ray (csrc/scatter.cu; a compare,
# select, clamp or a double cos / sin counts as one): what every ray does
# (the gather, normalising the normal, two fallback tests, the last
# normalise), then the ROUGH, METAL and DIELECTRIC branch's own
SCATTER_COMMON_OPS = 44
SCATTER_BRANCH_OPS = {"rough": 20, "metal": 41, "dielectric": 55}
# float operations of K's lobes per ray (csrc/path_scatter.cu, counted as
# J's): what every ray does (the throughput product, the offset origin,
# the outputs' selects), then the cosine lobe's (ROUGH and EMISSIVE rows:
# Frisvad's basis, two normalisations, the pdf), METAL's and
# DIELECTRIC's, and the roulette's where it applies
BSDF_COMMON_OPS = 20
BSDF_LOBE_OPS = {"cosine": 66, "metal": 64, "dielectric": 71}
BSDF_RR_OPS = 11
#: the phase-14 path waves' roulette start (bounce 1 before, 2 from it)
BSDF_RR_START = 2
#: the path tracer's steps with a kernel (K-N), each beside its ``_plain``
#: twin in ``render/pathtracer``
PATH_STEPS = ("bsdf_step", "nee_sample", "nee_add", "hit_radiance")


@contextlib.contextmanager
def swapped(*pairs):
    """Within the block, each (module, name, value) of ``pairs`` replaces
    ``module.name``."""
    real = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in real:
            setattr(m, n, v)


def twin_route():
    """The bounce loop on the plain versions, called explicitly on CUDA
    tensors: the scatter, the path tracer's BSDF step, NEE samples and
    additions and hit radiance, and the uniforms (jitter and light samples
    included) of ``wavefront.render`` and ``pathtracer.render_path`` go
    to ``scatter_plain``, ``bsdf_step_plain``, ``nee_sample_plain``,
    ``nee_add_plain``, ``hit_radiance_plain``, ``uniform4_plain`` and
    ``sobol_owen4_plain``."""
    from optix_ray_tracer_tpu_torch.render import pathtracer, wavefront
    from optix_ray_tracer_tpu_torch.utils import qmc, rng
    return swapped(
        (wavefront, "scatter", wavefront.scatter_plain),
        *((pathtracer, name, getattr(pathtracer, f"{name}_plain"))
          for name in PATH_STEPS),
        (rng, "uniform4", rng.uniform4_plain),
        (qmc, "sobol_owen4", qmc.sobol_owen4_plain))


def glue_steps() -> tuple:
    """The dispatchers of O-R, (module, name), each beside its ``_plain``
    twin in its module."""
    from optix_ray_tracer_tpu_torch.ops import intersect
    from optix_ray_tracer_tpu_torch.ops.kernels import march_glue
    return ((march_glue, "march_keys"), (march_glue, "gather_rays"),
            (march_glue, "finish_hits"), (intersect, "shading_frame"))


def glue_twin_route():
    """The marcher's glue and the shading frame on the plain versions,
    called explicitly on CUDA tensors (O-R's twins; everything else on
    its kernels)."""
    return swapped(*((m, name, getattr(m, f"{name}_plain"))
                     for m, name in glue_steps()))


@contextlib.contextmanager
def no_twin_calls(label: str):
    """Within the block, a call of any plain version of H-U fails the
    run."""
    from optix_ray_tracer_tpu_torch.render import pathtracer, wavefront
    from optix_ray_tracer_tpu_torch.utils import qmc, rng
    twins = ((rng, "uniform4_plain"), (rng, "pcg4d_plain"),
             (qmc, "sobol_owen4_plain"), (wavefront, "scatter_plain"),
             *((pathtracer, f"{name}_plain") for name in PATH_STEPS),
             *((m, f"{name}_plain") for m, name in glue_steps()),
             *((binning_steps()[0][0], name) for name in sorted(
                 binning_plain_names(binning_steps()[0][0]))))
    with contextlib.ExitStack() as stack:
        calls = [stack.enter_context(calls_of(m, n)) for m, n in twins]
        yield
    if any(calls):
        raise AssertionError(f"{label} by the kernels called a plain "
                             f"version")


def sobol_ops(n: int, dims: int) -> int:
    """Integer operations of ``dims`` Sobol-Owen uniforms for each of n
    elements: the PCG4D seeds, the index shuffle, the table lookups, and
    per dimension a scramble and a uniform."""
    return n * (PCG_OPS + OWEN_OPS + SOBOL_LOOKUP_OPS
                + dims * (OWEN_OPS + UNIT_OPS) + 1)


def device_ms(fn, kernel: str, letter: str, reps: int) -> tuple:
    """(mean device ms, how it was timed) of the kernel named ``kernel`` (a substring of its
    CUDA name; launch counter ``K[letter]``) per call of ``fn``, over
    ``reps`` calls after a warm-up, from a ``torch.profiler`` trace
    (build/chip_smoke/trace_*.json): the kernel's own time, without its
    wrapper's host work, which takes longer than H, I or J themselves.
    Each call must launch the kernel once: a window whose counter rose by
    another count fails.  A window opens with one more call, whose event
    the card's activity tracing may drop (a whole smoke run lost one
    event of S's windows every time); the last ``reps`` events are
    timed.  A window whose trace holds fewer than ``reps`` of the
    kernel's events (the tracing dropped more) is profiled again, up to
    TRACE_TRIES windows.  When every window's trace holds no kernel event
    at all (a whole smoke run's tracing recorded none in U's windows; the
    cause is not known), the calls are timed by :func:`queued_ms`
    instead, which counts the wrapper's other device work and the gaps
    between launches too: the method reads "profiler trace" or "queued
    cuda events"."""
    import torch
    fn()
    torch.cuda.synchronize()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    trace = OUT_DIR / f"trace_{kernel}.json"
    traced = 0
    for _ in range(TRACE_TRIES):
        before = K[letter].launches
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps + 1):
                fn()
            torch.cuda.synchronize()
        launched = K[letter].launches - before
        if launched != reps + 1:
            raise AssertionError(f"{letter} launched {launched} times in "
                                 f"{reps + 1} calls")
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "kernel"]
        durs = [e["dur"] for e in sorted(events, key=lambda e: e["ts"])
                if kernel in e.get("name", "")]
        if len(durs) >= reps:
            return sum(durs[-reps:]) / reps / 1e3, "profiler trace"
        traced += len(events)
        print(f"    {len(durs)} {kernel} events in the trace of {reps + 1} "
              f"launches ({len(events)} kernel events in all): profiling "
              f"the calls again")
    if traced == 0:
        ms = queued_ms(fn, letter, reps)
        print(f"    no kernel event traced in {TRACE_TRIES} windows: {kernel} "
              f"timed on the device's clock, {ms:.4f} ms a call "
              f"(:func:`queued_ms`)")
        return ms, "queued cuda events"
    raise AssertionError(f"{len(durs)} {kernel} events in the trace of "
                         f"{reps + 1} launches, {TRACE_TRIES} times")


#: cycles of the spin kernel that queued_ms puts before the timed calls
#: (~10 ms on the H100: longer than the host takes to queue them)
QUEUE_SPIN_CYCLES = 20_000_000


def queued_ms(fn, letter: str, reps: int) -> float:
    """Mean device ms per call of ``fn`` (one launch of ``K[letter]``
    each, and whatever device work its wrapper queues, such as T's
    memset), by CUDA events around ``reps`` calls queued behind a spin
    kernel (``torch.cuda._sleep``), so that the device runs them back to
    back and the host's work between launches does not show.  Fails when
    the host took longer to queue the calls than the device spun."""
    import torch
    fn()
    torch.cuda.synchronize()
    spun, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    before = K[letter].launches
    spun.record()
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    end.record()
    queued_s = time.perf_counter() - t0
    end.synchronize()
    if K[letter].launches - before != reps:
        raise AssertionError(f"{letter} launched "
                             f"{K[letter].launches - before} times in "
                             f"{reps} calls")
    if queued_s * 1e3 >= spun.elapsed_time(start):
        raise AssertionError(f"queueing {reps} calls took {queued_s:.4f} s, "
                             f"longer than the device's spin")
    return start.elapsed_time(end) / reps


def held(name: str, kern, plain) -> tuple:
    """(mismatched elements, max |diff|) of two tuples of tensors, NaN
    equal to NaN."""
    import torch
    bad, err = 0, 0.0
    for a, b in zip(kern, plain):
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)
                           if a.is_floating_point() else False)
        bad += int((~same).sum())
        diff = (a.double() - b.double()).abs()
        err = max(err, float(torch.nan_to_num(diff, nan=0.0).max()))
    print(f"    {name}: {bad} mismatched elements, max |diff| {err:.3g}")
    return bad, err


def rng_rows(frame, card: str) -> dict:
    """Phase 14 (a): H and I on a 4M-id draw of phase 4's frame (its
    pixel and sample ids, bounce 1, the scatter's seed), each against its
    plain version on the same CUDA tensors; H's integer lanes too."""
    import torch

    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.utils import qmc, rng

    dev = frame.img.device
    npix = WIDTH * HEIGHT
    pix = torch.arange(npix, dtype=torch.int64, device=dev).repeat(SPP)
    samp = torch.arange(SPP, dtype=torch.int64,
                        device=dev).repeat_interleave(npix)
    seed = frame.seed ^ wavefront._DIM_SCATTER
    n = pix.numel()
    rows = {}
    cases = (
        ("pcg4d", "H", lambda: rng.uniform4(pix, samp, 1, seed),
         lambda: rng.uniform4_plain(pix, samp, 1, seed),
         n * (PCG_OPS + 4 * UNIT_OPS), "pcg4d_kernel"),
        ("sobol_owen4", "I", lambda: qmc.sobol_owen4(pix, samp, 1, seed),
         lambda: qmc.sobol_owen4_plain(pix, samp, 1, seed),
         sobol_ops(n, 4), "sobol_owen4_kernel"),
    )
    for name, letter, kern_fn, plain_fn, ops, cuda_name in cases:
        before = K[letter].launches
        kern = kern_fn()
        if K[letter].launches != before + 1:
            raise AssertionError(f"{letter} did not launch")
        plain = plain_fn()
        torch.cuda.synchronize()
        bad, err = held(f"{letter} {name}, {n} ids", kern, plain)
        if name == "pcg4d":
            lanes = held("H integer lanes", rng.pcg4d(pix, samp, 1, seed),
                         rng.pcg4d_plain(pix, samp, 1, seed))
            bad += lanes[0]
        if bad:
            raise AssertionError(f"{letter} disagrees with its plain "
                                 f"version on {bad} elements")
        ms, by = device_ms(kern_fn, cuda_name, letter, REPS)
        call_ms = time_ms(kern_fn, REPS)
        plain_ms = time_ms(plain_fn, 1)
        r = row(err, ms, plain_ms, tensor_bytes(pix, samp, kern), ops, by)
        print(f"[bounce] {letter} {name}: device {ms:.4f} ms for {n} ids "
              f"({call_ms:.4f} ms per wrapper call; plain {plain_ms:.3f} "
              f"ms) [{card}]; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({100 * r['bound_ms'] / ms:.1f}%)")
        rows[name] = r
    return rows


def scatter_wave(frame, sampler: str) -> tuple:
    """The positional arguments of ``wavefront.scatter`` on phase 4's
    frame's bounce-1 wave (seed 1, rendered to depth 2)."""
    from optix_ray_tracer_tpu_torch.render import wavefront
    with calls_of(wavefront, "scatter", keep=lambda *a, **k: a) as seen:
        wavefront.render(frame.scene, frame.mats, frame.cam, WIDTH, HEIGHT,
                         spp=SPP, seed=frame.seed, max_depth=2,
                         intersector=frame.inter, sampler=sampler)
    return seen[-1]


def scatter_ops(args, sampler: str) -> int:
    """The operations J does on one wave: per ray its branch's float
    operations and its one draw's integer operations."""
    from optix_ray_tracer_tpu_torch.scene.materials import DIELECTRIC, METAL
    mats, mid = args[0], args[1]
    mtype = mats.gather(mid)[0]
    metal, diel = mtype == METAL, mtype == DIELECTRIC
    sel = (("rough", ~(metal | diel), 2), ("metal", metal, 2),
           ("dielectric", diel, 1))
    ops = mid.numel() * SCATTER_COMMON_OPS
    for name, mask, dims in sel:
        k = int(mask.sum())
        ops += k * SCATTER_BRANCH_OPS[name]
        if sampler == "sobol":
            ops += sobol_ops(k, dims)
        else:
            ops += k * (PCG_OPS + dims * UNIT_OPS)
    return ops


def scatter_row(frame, card: str) -> dict:
    """Phase 14 (b): J on phase 4's bounce-1 wave (4M rays) under PCG and
    under Sobol against ``scatter_plain`` on the same CUDA tensors; the
    row is the PCG wave's, its error the larger of the two."""
    import torch

    from optix_ray_tracer_tpu_torch.render import wavefront
    from optix_ray_tracer_tpu_torch.scene.materials import (
        DIELECTRIC, EMISSIVE, METAL, ROUGH,
    )
    out, errs = None, []
    for sampler in ("pcg", "sobol"):
        args = scatter_wave(frame, sampler)
        before = K["J"].launches
        kern = wavefront.scatter(*args)
        if K["J"].launches != before + 1:
            raise AssertionError("J did not launch")
        plain = wavefront.scatter_plain(*args)
        torch.cuda.synchronize()
        R = args[1].numel()
        bad, err = held(f"J whitted_scatter, {sampler}, {R} rays", kern,
                        plain)
        if bad:
            mtype = args[0].gather(args[1])[0]
            diff = (kern[0] != plain[0]).any(-1)
            ulp = (kern[0].view(torch.int32).long()
                   - plain[0].view(torch.int32).long()).abs().max()
            print(f"    mismatched rays by material: " + ", ".join(
                f"{name} {int((diff & (mtype == m)).sum())}" for name, m in
                (("ROUGH", ROUGH), ("METAL", METAL),
                 ("DIELECTRIC", DIELECTRIC), ("EMISSIVE", EMISSIVE)))
                + f"; largest new_dir difference {int(ulp)} ulp")
            raise AssertionError(f"J disagrees with scatter_plain on "
                                 f"{bad} elements ({sampler})")
        errs.append(err)
        ms, by = device_ms(lambda: wavefront.scatter(*args),
                           "whitted_scatter_kernel", "J", REPS)
        call_ms = time_ms(lambda: wavefront.scatter(*args), REPS)
        plain_ms = time_ms(lambda: wavefront.scatter_plain(*args), 1)
        r = row(err, ms, plain_ms, tensor_bytes(args[1:7], kern),
                scatter_ops(args, sampler), by)
        print(f"[bounce] J whitted_scatter, {sampler}: device {ms:.4f} ms "
              f"for {R} rays ({call_ms:.4f} ms per wrapper call; plain "
              f"{plain_ms:.3f} ms) [{card}]; bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']} ({100 * r['bound_ms'] / ms:.1f}%)")
        out = out or r
    out["max_abs_err"] = max(errs)
    return out


def route_frames(frame, card: str) -> dict:
    """Phase 14 (c): phase 4's frame (PCG, then Sobol) by the kernels,
    with the counts zeroed just before and read just after (H and J
    launched, I under Sobol; no plain version called), and by the plain
    versions called explicitly
    (no launch of H, I or J), the two held to each other by the 2-LSB
    rule (< 1% of channels).  Returns the kernel routes' launches."""
    import torch

    from optix_ray_tracer_tpu_torch.render import wavefront
    launches = {}

    def render(sampler):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = wavefront.render(frame.scene, frame.mats, frame.cam, WIDTH,
                               HEIGHT, spp=SPP, seed=frame.seed,
                               max_depth=DEPTH, intersector=frame.inter,
                               sampler=sampler)[0]
        torch.cuda.synchronize()
        return img, time.perf_counter() - t0

    for sampler, need in (("pcg", "HJ"), ("sobol", "IJ")):
        zero_counts()
        with no_twin_calls(f"the {sampler} frame"):
            img, s_kern = render(sampler)
        counts = launch_counts("HIJ")
        for k, n in counts.items():
            launches[K[k].name] = launches.get(K[k].name, 0) + n
        zero_counts()
        with twin_route():
            twin, s_twin = render(sampler)
        twin_counts = launch_counts("HIJ")
        err, over2 = lsb_share(img, twin)
        print(f"[bounce] phase 4's frame, {sampler}: kernels {s_kern:.3f} "
              f"s/frame (launches {counts_text(counts)}), plain versions "
              f"{s_twin:.3f} s/frame [{card}]; max |diff| {err:.3g}, "
              f"{over2:.6f} of channels > 2 LSB")
        if min(counts[k] for k in need) == 0:
            raise AssertionError(f"the {sampler} frame missed a kernel of "
                                 f"{need}: {counts}")
        if any(twin_counts.values()):
            raise AssertionError(f"the plain route launched {twin_counts}")
        if not torch.isfinite(img).all() or over2 >= 0.01:
            raise AssertionError(f"the {sampler} frame by the kernels "
                                 f"differs from the plain route's")
    return launches


def path_setup(frame) -> SimpleNamespace:
    """Phase 14's path scenes: config 5 and config 4 with their
    intersectors, and phase 4's scene (the METAL sphere over the ROUGH
    quad) with a DIELECTRIC and an EMISSIVE sphere beside the mesh."""
    from optix_ray_tracer_tpu_torch.models import benchmarks
    from optix_ray_tracer_tpu_torch.models.common import choose_intersector
    from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
    from optix_ray_tracer_tpu_torch.scene.geometry import Scene, Spheres
    from optix_ray_tracer_tpu_torch.scene.materials import MaterialBuilder

    dev = frame.img.device
    c5 = benchmarks.config5_sponza_class(device=dev)
    c4 = benchmarks.config4_cornell(device=dev)
    mb = MaterialBuilder()
    mb.add_metal((0.8, 0.85, 0.88), 0.05)      # phase 4's rows 0 and 1
    mb.add_rough((0.70, 0.60, 0.50))
    glass = mb.add_dielectric(1.5)
    lamp = mb.add_emissive((4.0, 4.0, 4.0))
    mixed = Scene(Spheres.from_list([((0.2, 1.5, -0.6), 0.4, glass),
                                     ((0.5, -1.4, -0.5), 0.3, lamp)], dev),
                  frame.scene.triangles)
    return SimpleNamespace(
        c5=c5, i5=choose_intersector(c5["scene"]), c4=c4,
        i4=choose_intersector(c4["scene"]), mixed=mixed,
        mixed_mats=mb.build(dev), mixed_inter=make_march_intersector(
            mixed, raster=True), cam=frame.cam)


def path_frame(cfg, inter, sampler: str = "pcg", spp: int | None = None,
               max_depth: int | None = None):
    """``pathtracer.render_path`` of a benchmark config (seed 1): the
    frame ``benchmarks.run`` renders, with the sampler named."""
    from optix_ray_tracer_tpu_torch.render import pathtracer
    return pathtracer.render_path(
        cfg["scene"], cfg["materials"], cfg.get("lights"), cfg["camera"],
        cfg["width"], cfg["height"], spp=spp or cfg["spp"], seed=1,
        max_depth=max_depth or cfg["max_depth"],
        background=cfg["background"], env=cfg.get("env"),
        textures=cfg.get("textures"), intersector=inter, sampler=sampler)[0]


def bsdf_waves(render, bounces) -> list:
    """The positional arguments of ``pathtracer.bsdf_step`` at each of
    ``bounces`` in the frame ``render()`` draws."""
    from optix_ray_tracer_tpu_torch.render import pathtracer
    with calls_of(pathtracer, "bsdf_step", keep=lambda *a, **k: a) as seen:
        render()
    return [seen[b] for b in bounces]


def bsdf_ops(args) -> int:
    """The operations K does on one wave: per ray its lobe's float
    operations and its draw's integer operations, and the roulette's
    where it applies."""
    from optix_ray_tracer_tpu_torch.scene.materials import DIELECTRIC, METAL
    mtype, alive, b, sampler, rr_start = (args[4], args[8], args[12],
                                          args[14], args[15])
    n = mtype.numel()
    draw = (lambda dims: sobol_ops(1, dims)) if sampler == "sobol" else (
        lambda dims: PCG_OPS + dims * UNIT_OPS)
    metal = int((mtype == METAL).sum())
    diel = int((mtype == DIELECTRIC).sum())
    ops = (n * (BSDF_COMMON_OPS + draw(2))
           + (n - metal - diel) * BSDF_LOBE_OPS["cosine"]
           + metal * BSDF_LOBE_OPS["metal"]
           + diel * BSDF_LOBE_OPS["dielectric"])
    if b >= rr_start:
        ops += int(alive.sum()) * (BSDF_RR_OPS + draw(1))
    return ops


def row_bytes(mask, n: int, *ts) -> int:
    """The bytes of the rows of ``ts`` (tensors of n rows, or smaller
    tables counted whole) that ``mask`` selects; None and values passed by
    value count nothing."""
    rows = int(mask.sum())
    total = 0
    for t in ts:
        if not hasattr(t, "numel"):
            continue
        per_row = t.element_size() * (t.numel() // n)
        total += rows * per_row if t.numel() >= n else (
            t.numel() * t.element_size())
    return total


def bsdf_bytes(args, kern) -> int:
    """The bytes K must move on one wave, counted row by row from the
    wave's masks: on every row mtype, shading_alive, throughput and the
    five outputs; the RNG ids where a draw is needed (ROUGH rows, whose
    prev_pdf takes the lobe's draw, rows that go on, and live rows under
    roulette); n_unit and point on rows that go on, o on the others; d
    on rows that stop and on METAL and DIELECTRIC rows that go on; param
    on those too, front_face on the DIELECTRIC ones; albedo on live rows
    that are not DIELECTRIC.  No row's bytes are rounded up to sectors."""
    import torch

    from optix_ray_tracer_tpu_torch.scene.materials import (
        DIELECTRIC, METAL, ROUGH,
    )
    (d, n_unit, point, front, mtype, albedo, param, thr, alive, o, pix,
     samp) = args[:12]
    b, rr_start = args[12], args[15]
    n = mtype.numel()
    go = kern[4]
    diel = mtype == DIELECTRIC
    lobe = (mtype == METAL) | diel

    every = torch.ones_like(alive)
    draws = (mtype == ROUGH) | go | (alive & (b >= rr_start))
    return (row_bytes(every, n, mtype, alive, thr, *kern)
            + row_bytes(draws, n, pix, samp)
            + row_bytes(go, n, n_unit, point) + row_bytes(~go, n, o)
            + row_bytes(~go | (go & lobe), n, d)
            + row_bytes(go & lobe, n, param)
            + row_bytes(go & diel, n, front)
            + row_bytes(alive & ~diel, n, albedo))


def bsdf_rows(p: SimpleNamespace, card: str) -> dict:
    """Phase 14 (d): K against ``bsdf_step_plain`` on the same CUDA
    tensors, exact, on the mixed scene's waves (1024x1024, spp 1, depth 3,
    roulette from bounce BSDF_RR_START: bounces 1 and 2, under PCG and
    under Sobol), then on config 5's bounce-1 wave (2.09M rays), whose
    row is K's; mismatches named by material."""
    import torch

    from optix_ray_tracer_tpu_torch.render import pathtracer
    from optix_ray_tracer_tpu_torch.scene.materials import (
        DIELECTRIC, EMISSIVE, METAL, ROUGH,
    )
    kinds = (("ROUGH", ROUGH), ("METAL", METAL), ("DIELECTRIC", DIELECTRIC),
             ("EMISSIVE", EMISSIVE))
    waves = []
    for sampler in ("pcg", "sobol"):
        waves += [(f"mixed scene, {sampler}, bounce {k + 1}", a) for k, a in
                  enumerate(bsdf_waves(lambda: pathtracer.render_path(
                      p.mixed, p.mixed_mats, None, p.cam, WIDTH, HEIGHT,
                      spp=1, seed=1, max_depth=3, rr_start=BSDF_RR_START,
                      intersector=p.mixed_inter, sampler=sampler), (1, 2)))]
    waves += [("config 5, pcg, bounce 1", bsdf_waves(
        lambda: path_frame(p.c5, p.i5, max_depth=2), (1,))[0])]
    errs = []
    for label, args in waves:
        mtype, alive = args[4], args[8]
        mix = ", ".join(f"{name} {int((mtype == m).sum())}"
                        for name, m in kinds)
        before = K["K"].launches
        kern = pathtracer.bsdf_step(*args)
        if K["K"].launches != before + 1:
            raise AssertionError("K did not launch")
        plain = pathtracer.bsdf_step_plain(*args)
        torch.cuda.synchronize()
        bad, err = held(f"K path_bsdf, {label}, {mtype.numel()} rays ({mix};"
                        f" {int((~alive).sum())} dead, "
                        f"{int((alive & ~kern[4]).sum())} ended by the "
                        f"roulette)", kern, plain)
        if bad:
            diff = ((kern[1] != plain[1]).any(-1) | (kern[0] != plain[0])
                    .any(-1) | (kern[2] != plain[2]).any(-1)
                    | (kern[3] != plain[3]) | (kern[4] != plain[4]))
            print("    mismatched rays by material: " + ", ".join(
                f"{name} {int((diff & (mtype == m)).sum())}"
                for name, m in kinds))
            raise AssertionError(f"K disagrees with bsdf_step_plain on "
                                 f"{bad} elements ({label})")
        errs.append(err)
        if label.startswith("mixed") and not all(
                int((mtype == m).sum()) for _, m in kinds):
            raise AssertionError(f"the {label} wave lacks a material")
    ms, by = device_ms(lambda: pathtracer.bsdf_step(*args),
                       "path_bsdf_kernel", "K", REPS)
    call_ms = time_ms(lambda: pathtracer.bsdf_step(*args), REPS)
    plain_ms = time_ms(lambda: pathtracer.bsdf_step_plain(*args), 1)
    r = row(max(errs), ms, plain_ms, bsdf_bytes(args, kern), bsdf_ops(args),
            by)
    print(f"[bounce] K path_bsdf, config 5's bounce-1 wave: device {ms:.4f} "
          f"ms for {args[4].numel()} rays ({call_ms:.4f} ms per wrapper "
          f"call; plain {plain_ms:.3f} ms) [{card}]; bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({100 * r['bound_ms'] / ms:.1f}%)")
    return r


# operations of L, M and N per row (csrc/path_nee.cu, counted as J's and
# K's: a compare, select, clamp, libm call or table load counts as one):
# L's shared origin, then per part its sample on every row (the draw's
# integer operations apart; the binary searches at two per step) and its
# contribution where it is valid; the environment's bilinear lookup and
# pdf; the light pdf of an emitter hit; a contribution's add
NEE_ORIGIN_OPS = 6
NEE_AREA_OPS = 52
NEE_ENV_OPS = 48
NEE_CONTRIB_OPS = 22
ENV_LOOKUP_OPS = 40
ENV_PDF_OPS = 12
LIGHT_PDF_OPS = 22
ADD_OPS = 3
#: the firefly clamp of phase 14's mixed waves
NEE_CLAMP = 0.5


def search_ops(n: int) -> int:
    """A binary search's operations over n entries: two per step."""
    return 2 * max(int(n), 1).bit_length()


def nee_work(args, kern) -> tuple:
    """(bytes, operations) L must move and do on one wave, counted row by
    row from its masks: on every row shading_alive, point, n_unit, the
    RNG ids, the origin and each part's direction, t_max and validity,
    and the part's sample; mtype on shading_alive rows; throughput and
    albedo where a part is valid, and each part's contribution there
    (written as 0 elsewhere: counted on every row); the light and map
    tables once."""
    import torch
    point, n_unit, alive, mtype, thr, alb, pix, samp = args[:8]
    sampler, lights, env = args[10], args[11], args[12]
    origin, area, sky = kern
    n = mtype.numel()
    every = torch.ones_like(alive)
    valid = torch.zeros_like(alive)
    total = row_bytes(every, n, alive, point, n_unit, pix, samp, origin) \
        + row_bytes(alive, n, mtype)
    draw = (lambda dims: sobol_ops(1, dims)) if sampler == "sobol" else (
        lambda dims: PCG_OPS + dims * UNIT_OPS)
    ops = n * NEE_ORIGIN_OPS
    for part, dims, sample_ops, tables in (
            (area, 3, lambda: NEE_AREA_OPS + search_ops(lights.count),
             lambda: (lights.v0, lights.e1, lights.e2, lights.normal,
                      lights.emission, lights.cdf, lights.pdf_scale)),
            (sky, 4, lambda: NEE_ENV_OPS + search_ops(env.block_cdf.numel())
             + 14, lambda: (env.image, env.block_cdf, env.cond_cdf,
                            env.pdf_tex))):
        if part is None:
            continue
        ok = part[3]
        valid |= ok
        total += row_bytes(every, n, *part) + tensor_bytes(tables())
        ops += n * (draw(dims) + sample_ops()) + int(ok.sum()) * (
            NEE_CONTRIB_OPS + (ENV_LOOKUP_OPS if dims == 4 else 0))
    return total + row_bytes(valid, n, thr, alb), ops


def add_work(args) -> tuple:
    """(bytes, operations) of M on one wave: radiance in and out and each
    part's validity and occlusion masks on every row, its contribution
    where the sample is valid and its segment not occluded."""
    import torch
    radiance = args[0]
    n = radiance.shape[0]
    every = torch.ones(n, dtype=torch.bool, device=radiance.device)
    total = row_bytes(every, n, radiance, radiance)
    ops = 0
    for c, valid, occ in (args[1:4], args[4:7]):
        if c is not None:
            total += row_bytes(every, n, valid, occ) + row_bytes(
                valid & ~occ, n, c)
            ops += n * ADD_OPS
    return total, ops


def hit_work(args) -> tuple:
    """(bytes, operations) of N on one wave: radiance in and out, missed
    and hit_alive on every row, mtype on live hits; d, throughput and
    (with the environment's MIS) prev_pdf on missed rows, with its lookup
    and pdf; throughput and emission on the emitter hits that count, with
    (given a light table) d, prev_pdf, t, prim_id, prim_type and the light
    pdf, and prim_diff where ReSTIR's bounce-1 rule reads it; the map and
    light tables once."""
    import torch
    (radiance, d, prev_pdf, thr, missed, hit_alive, hit, mtype, emission,
     prim_diff, b, background, lights, env, cap, restir) = args
    n = radiance.shape[0]
    every = torch.ones_like(missed)
    total = row_bytes(every, n, radiance, radiance, missed, hit_alive) \
        + row_bytes(hit_alive, n, mtype)
    ops = n * 2 * ADD_OPS
    weigh = env is not None and env.can_sample
    total += row_bytes(missed, n, d, thr, prev_pdf if weigh else None)
    n_missed = int(missed.sum())
    if env is not None:
        total += tensor_bytes(env.image, env.pdf_tex if weigh else None)
        ops += n_missed * (ENV_LOOKUP_OPS + (ENV_PDF_OPS if weigh else 0))
    else:
        total += tensor_bytes(background)
    ops += n_missed * 4
    vis = hit_alive & (mtype == 3)                  # EMISSIVE
    if restir and b == 1:
        total += row_bytes(vis, n, prim_diff)
        vis = vis & ~prim_diff
    elif restir and b == 0:
        vis = torch.zeros_like(vis)
    total += row_bytes(vis, n, thr, emission)
    ops += int(vis.sum()) * (4 + (LIGHT_PDF_OPS if lights is not None
                                  else 0))
    if lights is not None:
        total += row_bytes(vis, n, d, prev_pdf, hit.t, hit.prim_id,
                           hit.prim_type) + tensor_bytes(
            lights.tri_light_idx, lights.normal, lights.pdf_scale)
    return total, ops


def nee_calls(render) -> tuple:
    """The positional arguments of every ``nee_sample``, ``nee_add`` and
    ``hit_radiance`` call of ``render()``, in order: each NEE sample is
    followed by its addition in the same bounce."""
    from optix_ray_tracer_tpu_torch.render import pathtracer
    keep = lambda *a, **k: a                               # noqa: E731
    with calls_of(pathtracer, "nee_sample", keep=keep) as ls, \
            calls_of(pathtracer, "nee_add", keep=keep) as ms, \
            calls_of(pathtracer, "hit_radiance", keep=keep) as ns:
        render()
    return ls, ms, ns


def nee_flat(out) -> list:
    """L's outputs as one list: the origin, then each part that is on."""
    return [out[0]] + [x for part in out[1:] if part for x in part]


def hold_step(letter: str, name: str, args, label: str) -> tuple:
    """One of L, M, N (``pathtracer.<name>``) against its twin on the same
    CUDA tensors: the kernel launches once, every output is equal.
    Returns (kernel's outputs, max |diff|)."""
    import torch

    from optix_ray_tracer_tpu_torch.render import pathtracer
    before = K[letter].launches
    kern = getattr(pathtracer, name)(*args)
    if K[letter].launches != before + 1:
        raise AssertionError(f"{letter} did not launch")
    plain = getattr(pathtracer, f"{name}_plain")(*args)
    torch.cuda.synchronize()
    flat = nee_flat if letter == "L" else (lambda x: [x])
    ks, ps = flat(kern), flat(plain)
    if len(ks) != len(ps):
        raise AssertionError(f"{letter} returned {len(ks)} outputs, its "
                             f"twin {len(ps)}")
    bad, err = held(f"{letter} {K[letter].name}, {label}", ks, ps)
    if bad:
        for k, (a, b) in enumerate(zip(ks, ps)):
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            ulp = (a.view(torch.int32).long()
                   - b.view(torch.int32).long()).abs()[~same]
            print(f"    output {k}: {int((~same).sum())} mismatched, "
                  f"largest {int(ulp.max()) if ulp.numel() else 0} ulp")
        raise AssertionError(f"{letter} disagrees with {name}_plain on {bad} "
                             f"elements ({label})")
    return kern, err


def nee_rows(p: SimpleNamespace, card: str) -> dict:
    """Phase 14 (f): L, M and N against ``nee_sample_plain``,
    ``nee_add_plain`` and ``hit_radiance_plain`` on the same CUDA
    tensors, exact, on config 5's bounce-1 wave (env only; the rows of
    L, M and N), config 4's bounce-1 wave under PCG and under Sobol (area
    only), the mixed scene of (d) with config 4's light table and config
    5's sky, clamp NEE_CLAMP (bounces 1 and 2 under PCG, 1 under Sobol),
    and config 4's camera wave with config 5's sky under
    ``restir_direct`` (bounces 0 and 1)."""
    import torch

    from optix_ray_tracer_tpu_torch.render import pathtracer

    def restir_wave():
        cam, w, h = p.c4["camera"], p.c4["width"], p.c4["height"]
        o, d = cam.generate_rays(w, h)
        ids = torch.arange(w * h, device=o.device)
        return pathtracer.trace_path(
            p.c4["scene"], p.c4["materials"], p.c4["lights"],
            o.reshape(-1, 3), d.reshape(-1, 3), ids, torch.zeros_like(ids),
            1, p.c4["background"], max_depth=2, intersector=p.i4,
            env=p.c5["env"], restir_direct=True)

    def mixed(sampler):
        return lambda: pathtracer.render_path(
            p.mixed, p.mixed_mats, p.c4["lights"], p.cam, WIDTH, HEIGHT,
            spp=1, seed=1, max_depth=3, clamp=NEE_CLAMP, env=p.c5["env"],
            intersector=p.mixed_inter, sampler=sampler)

    cases = [("config 5, pcg", lambda: path_frame(p.c5, p.i5, spp=1,
                                                   max_depth=2), (1,))]
    cases += [(f"config 4, {s}", lambda s=s: path_frame(
        p.c4, p.i4, s, spp=1, max_depth=2), (1,)) for s in ("pcg", "sobol")]
    cases += [("mixed scene, pcg", mixed("pcg"), (1, 2)),
              ("mixed scene, sobol", mixed("sobol"), (1,)),
              ("config 4, restir_direct", restir_wave, (0, 1))]
    errs, first = {"L": [], "M": [], "N": []}, {}
    for label, render, bounces in cases:
        ls, ms, ns = nee_calls(render)
        for b in bounces:
            waves = (("L", "nee_sample", [a for a in ls if a[8] == b]),
                     ("M", "nee_add", [m for a, m in zip(ls, ms)
                                       if a[8] == b]),
                     ("N", "hit_radiance", [a for a in ns if a[10] == b]))
            if not waves[2][1]:
                raise AssertionError(f"{label}: no hit-radiance wave at "
                                     f"bounce {b}")
            for letter, name, calls in waves:
                if not calls:
                    continue
                args = calls[0]
                R = (args[3] if letter == "L" else args[0]).shape[0]
                parts = ""
                if letter == "L":
                    parts = ": " + ", ".join(
                        part for part, on in (("area", args[11]),
                                              ("sky", args[12]))
                        if on is not None)
                kern, err = hold_step(letter, name, args,
                                      f"{label}, bounce {b}, {R} rays{parts}")
                errs[letter].append(err)
                first.setdefault(letter, (name, args, kern))
    rows = {}
    for letter, cuda_name in (("L", "path_nee_sample_kernel"),
                              ("M", "path_nee_add_kernel"),
                              ("N", "path_hit_radiance_kernel")):
        name, args, kern = first[letter]
        step = getattr(pathtracer, name)
        twin = getattr(pathtracer, f"{name}_plain")
        io_bytes, ops = (nee_work(args, kern) if letter == "L" else
                         add_work(args) if letter == "M" else hit_work(args))
        ms, by = device_ms(lambda: step(*args), cuda_name, letter, REPS)
        call_ms = time_ms(lambda: step(*args), REPS)
        plain_ms = time_ms(lambda: twin(*args), 1)
        r = row(max(errs[letter]), ms, plain_ms, io_bytes, ops, by)
        R = (args[3] if letter == "L" else args[0]).shape[0]
        print(f"[bounce] {letter} {K[letter].name}, config 5's bounce-1 "
              f"wave: device {ms:.4f} ms for {R} rays ({call_ms:.4f} ms per "
              f"wrapper call; plain {plain_ms:.3f} ms) [{card}]; bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"{io_bytes / R:.1f} B a ray ({100 * r['bound_ms'] / ms:.1f}%)")
        rows[K[letter].name] = r
    return rows


def path_route_frames(p: SimpleNamespace, card: str) -> dict:
    """Phase 14 (e): a config-4 frame (spp 4) under the Sobol sampler and
    a config-5 frame by the kernels (counts zeroed just before and read
    just after: K-N launched, and H or I; no plain version called) and
    by the plain versions called explicitly (:func:`twin_route`: no launch
    of H-N); the two frames equal to 2 LSB on every channel.  Returns the
    kernel routes' launches."""
    import torch
    launches = {}

    def render(cfg, inter, sampler, spp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = path_frame(cfg, inter, sampler, spp)
        torch.cuda.synchronize()
        return img, time.perf_counter() - t0

    for label, cfg, inter, sampler, spp, need in (
            ("config 4", p.c4, p.i4, "sobol", 4, "IKLMN"),
            ("config 5", p.c5, p.i5, "pcg", None, "HKLMN")):
        zero_counts()
        with no_twin_calls(f"the {label} frame"):
            img, s_kern = render(cfg, inter, sampler, spp)
        counts = launch_counts("HIJKLMN")
        for k, n in counts.items():
            launches[K[k].name] = launches.get(K[k].name, 0) + n
        zero_counts()
        with twin_route():
            twin, s_twin = render(cfg, inter, sampler, spp)
        twin_counts = launch_counts("HIJKLMN")
        err, over2 = lsb_share(img, twin)
        print(f"[bounce] {label}'s path frame, {sampler}: kernels "
              f"{s_kern:.3f} s/frame (launches {counts_text(counts)}), plain "
              f"versions {s_twin:.3f} s/frame [{card}]; max |diff| "
              f"{err:.3g}, {over2:.6f} of channels > 2 LSB")
        if min(counts[k] for k in need) == 0:
            raise AssertionError(f"the {label} frame missed a kernel of "
                                 f"{need}: {counts}")
        if any(twin_counts.values()):
            raise AssertionError(f"the plain route launched {twin_counts}")
        if not torch.isfinite(img).all() or over2 > 0:
            raise AssertionError(f"the {label} frame by the kernels differs "
                                 f"from the plain route's")
    return launches


def bounce_phase(frame, card: str) -> tuple:
    """Phase 14: the bounce loop's kernels H-N.  Returns (their JSON
    rows, the launches of (c) and (e), the path scenes of
    :func:`path_setup`)."""
    t0 = time.perf_counter()
    rows = rng_rows(frame, card)
    rows["whitted_scatter"] = scatter_row(frame, card)
    launches = route_frames(frame, card)
    p = path_setup(frame)
    rows["path_bsdf"] = bsdf_rows(p, card)
    rows.update(nee_rows(p, card))
    for name, n in path_route_frames(p, card).items():
        launches[name] = launches.get(name, 0) + n
    print(f"[bounce] phase 14 in {time.perf_counter() - t0:.1f} s")
    return rows, launches, p


# ---- phase 15: the marcher's wave glue and the shading frame (O-R) --------

# operations of O-R per unit (csrc/march_glue.cu, csrc/shading_frame.cu,
# counted as J's: a compare, select, clamp, cast, shift or logic operation
# counts as one): a point's Morton code (per axis a subtract, divide, two
# clamps, a multiply, a cast, a clamp and the eight operations of the bit
# spread, then two shifts and two ors), a key's composition; Q's u and v
# from a Woop row (two dots of five, a subtract, a multiply, an add, each
# twice) and its selects; R's point, a triangle's or a sphere's normal,
# the dot and flip, the selects
MORTON_OPS = 3 * 15 + 4
KEY_OPS = 4
FINISH_OPS = 6
UV_OPS = 2 * 13
SHADE_OPS = 6 + 5 + 3 + 4
TRI_NORMAL_OPS = 2 + 15
SPHERE_NORMAL_OPS = 1 + 6


def glue_calls(run) -> list:
    """(name, args, kwargs) of every call of O-R's dispatchers in
    ``run()``, in order."""
    seen = []
    with contextlib.ExitStack() as stack:
        for m, name in glue_steps():
            stack.enter_context(calls_of(m, name, keep=lambda *a, _n=name,
                                         **k: seen.append((_n, a, k))))
        run()
    return seen


def query_calls(calls) -> dict:
    """The glue calls of the last marcher query among ``calls`` (its P
    calls in order, O and Q) and the last shading frame: {letter: [(args,
    kwargs), ...]}."""
    q = max(i for i, c in enumerate(calls) if c[0] == "finish_hits"
            and c[2].get("u") is None)
    start = q
    while start > 0 and calls[start - 1][0] in ("gather_rays", "march_keys"):
        start -= 1
    out = {"O": [], "P": [], "Q": [calls[q][1:]], "R": []}
    for name, a, k in calls[start:q]:
        out["O" if name == "march_keys" else "P"].append((a, k))
    shades = [c[1:] for c in calls if c[0] == "shading_frame"]
    if shades:
        out["R"].append(shades[-1])
    return out


def glue_waves(frame, t, p) -> list:
    """Phase 15's waves: (label, {letter: [(args, kwargs)]}) of phase 4's
    bounce-1 wave (probe: P, C, O, P, B, Q; its shading frame), the
    flatten frame's camera wave (Morton, F) and its shading frame, and
    config 5's first env NEE shadow wave (any-hit) with its frame's first
    shading frame."""
    from optix_ray_tracer_tpu_torch.ops import intersect, march
    from optix_ray_tracer_tpu_torch.render import wavefront
    whitted = query_calls(glue_calls(lambda: wavefront.render(
        frame.scene, frame.mats, frame.cam, WIDTH, HEIGHT, spp=SPP,
        seed=frame.seed, max_depth=2, intersector=frame.inter)))

    def flatten():
        hit = t.finter.intersect(t.flat, t.o, t.d, t.tmin, t.tmax)
        intersect.shading_frame(t.flat, t.o, t.d, hit)
    camera = query_calls(glue_calls(flatten))
    with calls_of(march.MarchIntersector, "intersect",
                  keep=lambda *a, **k: (a, k)) as queries:
        shades = [c for c in glue_calls(lambda: path_frame(
            p.c5, p.i5, spp=1, max_depth=2)) if c[0] == "shading_frame"]
    a, k = next((a, k) for a, k in queries if k.get("_any_hit"))
    env = query_calls(glue_calls(lambda: a[0].intersect(*a[1:], **k)))
    env["R"] = [shades[0][1:]]
    return [("phase 4's bounce-1 wave (probe)", whitted),
            ("the flatten camera wave (Morton, F)", camera),
            ("config 5's env NEE shadow wave (any-hit)", env)]


def glue_rays(letter: str, args) -> int:
    """The rays of a call of O-R with these positional arguments."""
    return (args[0].shape[0] if letter in "OP" else
            args[3] if letter == "Q" else args[3].t.numel())


def glue_outputs(out) -> tuple:
    """A dispatcher's outputs as a tuple of tensors (P's inverse is None
    without a permutation)."""
    return tuple(x for x in out if x is not None) if isinstance(
        out, tuple) else (out,)


def glue_work(letter: str, args, kw, kern) -> tuple:
    """(bytes, operations) one launch of ``letter`` needs on its wave,
    from the wave's data: every ray's own inputs and outputs; a table row
    (a Woop row's eight used values, a prim_index entry, a triangle's
    normals and material, a sphere's row) once however many rays read it;
    a bound broadcast from one value once."""
    import torch

    def nbytes(*ts):
        return sum(x.numel() * x.element_size() for x in ts
                   if isinstance(x, torch.Tensor))

    if letter == "O":
        d, o = args[0], kw.get("o", args[1] if len(args) > 1 else None)
        n = d.shape[0]
        cid = kw.get("cid")
        points = 1 if cid is not None else 2
        io = nbytes(d, kern[0]) + (nbytes(cid) if cid is not None else
                                   nbytes(o) + 24)
        return io, n * (points * MORTON_OPS + KEY_OPS)
    if letter == "P":
        o, d, tmin, tmax = args[:4]
        perm = args[4] if len(args) > 4 else kw.get("perm")
        n = o.shape[0]
        bounds = sum(4 if x.dim() and x.stride(0) == 0 else nbytes(x)
                     for x in (tmin, tmax))
        return nbytes(o, d, perm, *kern) + bounds, 0
    if letter == "Q":
        t, slot, prim_index, n = args[:4]
        slot = slot[:n]
        hits = slot >= 0
        n_hits = int(hits.sum())
        rows = torch.unique(slot[hits]).numel()
        # slot on every ray, t (and given u, v) on hits only: a miss's
        # outputs are constants
        io = 4 * n + 4 * n_hits + nbytes(kw.get("inv"), *kern) + 4 * rows
        ops = n * FINISH_OPS
        if kw.get("u") is not None:
            io += 8 * n_hits
        elif not kw.get("any_hit"):
            io += n_hits * 24 + rows * 32
            ops += n_hits * UV_OPS
        return io, ops
    scene, o, d, hit = args[:4]
    n = hit.t.numel()
    tri = hit.prim_type.reshape(-1) == 2
    pid = hit.prim_id.reshape(-1)
    io = 32 * n + nbytes(*kern) + 12 * int(tri.sum())
    io += 40 * torch.unique(pid[tri].clamp(
        0, max(scene.triangle_count - 1, 0))).numel()
    ops = n * SHADE_OPS + int(tri.sum()) * TRI_NORMAL_OPS
    if scene.sphere_count:
        sph = pid[~tri].clamp(0, scene.sphere_count - 1)
        io += 4 * sph.numel() + 24 * torch.unique(sph).numel()
        ops += sph.numel() * SPHERE_NORMAL_OPS
    return io, ops


GLUE_KERNELS = {"O": "march_keys_kernel", "P": "gather_rays_kernel",
                "Q": "finish_hits_kernel", "R": "shading_frame_kernel"}


def hold_glue(letter: str, args, kw, label: str) -> tuple:
    """One of O-R (its dispatcher) against its twin on the same CUDA
    tensors: one launch, every output equal.  Returns (kernel's outputs,
    max |diff|)."""
    import torch
    module, name = glue_steps()["OPQR".index(letter)]
    before = K[letter].launches
    kern = glue_outputs(getattr(module, name)(*args, **kw))
    if K[letter].launches != before + 1:
        raise AssertionError(f"{letter} did not launch")
    plain = glue_outputs(getattr(module, f"{name}_plain")(*args, **kw))
    torch.cuda.synchronize()
    bad, err = held(f"{letter} {K[letter].name}, {label}", kern, plain)
    if bad:
        raise AssertionError(f"{letter} disagrees with {name}_plain on {bad} "
                             f"elements ({label})")
    return kern, err


def glue_rows(waves, card: str) -> dict:
    """Phase 15 (a), (b): O-R against their twins on every wave, exact;
    each kernel's row on phase 4's bounce-1 wave: device ms per launch
    (profiler trace), the twin's ms, the bytes bound; P's library call,
    ``torch.index_select`` of the wave's prebuilt (R, 8) rows."""
    import torch
    errs = {k: [] for k in "OPQR"}
    for label, calls in waves:
        for letter in "OPQR":
            for a, k in calls[letter]:
                n = glue_rays(letter, a)
                mode = ("probe" if k.get("cid") is not None else "Morton"
                        ) if letter == "O" else (
                    "perm" if len(a) > 4 and a[4] is not None else "in place"
                ) if letter == "P" else ""
                errs[letter].append(hold_glue(
                    letter, a, k, f"{label}, {n} rays {mode}".strip())[1])
    rows = {}
    calls = waves[0][1]
    for letter in "OPQR":
        module, name = glue_steps()["OPQR".index(letter)]
        a, k = calls[letter][-1]
        step = getattr(module, name)
        twin = getattr(module, f"{name}_plain")
        kern = glue_outputs(step(*a, **k))
        io_bytes, ops = glue_work(letter, a, k, kern)
        ms, by = device_ms(lambda: step(*a, **k), GLUE_KERNELS[letter],
                           letter, REPS)
        call_ms = time_ms(lambda: step(*a, **k), REPS)
        plain_ms = time_ms(lambda: twin(*a, **k), 1)
        r = row(max(errs[letter]), ms, plain_ms, io_bytes, ops, by)
        n = glue_rays(letter, a)
        lib = ""
        if letter == "P":
            o, d, tmin, tmax, perm = a[:5]
            packed = torch.cat([o, d, tmin[:, None], tmax[:, None]], 1)
            r["library_ms"] = time_ms(
                lambda: torch.index_select(packed, 0, perm), REPS)
            lib = f"; index_select of the (R, 8) rows {r['library_ms']:.4f} ms"
        print(f"[glue] {letter} {K[letter].name}, phase 4's bounce-1 wave: "
              f"device {ms:.4f} ms for {n} rays ({call_ms:.4f} ms per wrapper "
              f"call; plain {plain_ms:.3f} ms{lib}) [{card}]; bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"{io_bytes / n:.1f} B a ray ({100 * r['bound_ms'] / ms:.1f}%)")
        rows[K[letter].name] = r
    return rows


def glue_frames(frame, p, card: str) -> dict:
    """Phase 15 (c): phase 4's Whitted frame and config 5's frame by the
    kernels (counts zeroed just before and read just after: O-R launched,
    no plain version of H-R called) and with O-R's twins called
    explicitly (:func:`glue_twin_route`: no launch of O-R), held to each
    other at max |diff| 0.  Returns the kernel routes' launches."""
    import torch

    from optix_ray_tracer_tpu_torch.render import wavefront
    launches = {}

    def timed(render):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render()
        torch.cuda.synchronize()
        return img, time.perf_counter() - t0

    for label, render in (
            ("phase 4's Whitted frame", lambda: wavefront.render(
                frame.scene, frame.mats, frame.cam, WIDTH, HEIGHT, spp=SPP,
                seed=frame.seed, max_depth=DEPTH,
                intersector=frame.inter)[0]),
            ("config 5's frame", lambda: path_frame(p.c5, p.i5))):
        zero_counts()
        with no_twin_calls(label):
            img, s_kern = timed(render)
        counts = launch_counts("OPQR")
        for k, n in counts.items():
            launches[K[k].name] = launches.get(K[k].name, 0) + n
        zero_counts()
        with glue_twin_route():
            twin, s_twin = timed(render)
        twin_counts = launch_counts("OPQR")
        err = float((img - twin).abs().max())
        print(f"[glue] {label}: kernels {s_kern:.3f} s/frame (launches "
              f"{counts_text(counts)}), O-R's twins {s_twin:.3f} s/frame "
              f"[{card}]; max |diff| {err:.3g}")
        if min(counts.values()) == 0:
            raise AssertionError(f"{label} missed a kernel of O-R: {counts}")
        if any(twin_counts.values()):
            raise AssertionError(f"the twin route launched {twin_counts}")
        if not torch.isfinite(img).all() or err != 0:
            raise AssertionError(f"{label} by the kernels differs from the "
                                 f"twins'")
    return launches


def glue_phase(frame, t, p, card: str) -> tuple:
    """Phase 15: the marcher's wave glue and the shading frame, O-R.
    Returns (their JSON rows, the launches of (c))."""
    t0 = time.perf_counter()
    rows = glue_rows(glue_waves(frame, t, p), card)
    launches = glue_frames(frame, p, card)
    print(f"[glue] phase 15 in {time.perf_counter() - t0:.1f} s")
    return rows, launches


# ---- phase 16: the raster binning (S, T, U) -------------------------------

#: phase 16's bundle wave, the rows bin_count_bundle and bin_emit_bundle
BUNDLE_WAVE = "the path pile's first bundle NEE wave"
#: phase 16's TLAS wave, the row bin_rects_pair
TLAS_WAVE = "the TLAS camera wave (pairs)"
#: the kernels' CUDA names (substrings of their trace events)
BIN_KERNELS = {"S": "bin_rects_kernel", "T": "bin_count_kernel",
               "U": "bin_emit_kernel"}
# operations per unit (csrc/binning.cu, counted as J's: a compare, select,
# min, max or logic operation counts as one): a point's projection (the
# subtraction, three dots of five, the test, two divides) and its rect
# update (six min / max, the behind test); a ray's projective bounds (its
# projection, two products, two min / max and two sums of the depth,
# four min / max of the rect) or bundle bounds (the octant's three
# compares, fourteen min / max); a (block, window) projective test
# (eight compares, the full-plane or, four ands) or bundle test per live
# octant (per axis two subtractions, four compares, two divides, four
# selects, four min / max; the margins, two min / max, the compare and
# the key); a sort comparison (the 64-bit compare and the swap); a row
# of S's centroid (the subtraction, the NaN test, three additions; a pair
# center's sum and product first)
POINT_OPS = 3 + 15 + 1 + 2 + 8
CENTROID_OPS = 3 + 1 + 3
CENTER_OPS = 6
RAY_RECT_OPS = POINT_OPS + 6 + 4
RAY_BOX_OPS = 3 + 14
RECT_TEST_OPS = 13
BOX_TEST_OPS = 3 * 16 + 8 + 4
SORT_OPS = 2


def binning_steps() -> tuple:
    """The dispatchers of S, T and U, (module, name), each beside its twin
    in ``ops/kernels/binning`` (:func:`binning_twin`)."""
    from optix_ray_tracer_tpu_torch.ops.kernels import binning
    return ((binning, "bin_rects"), (binning, "bin_count"),
            (binning, "bin_emit"))


def binning_twin(module, name: str):
    """The plain version of dispatcher ``name``, with its arguments
    (``binning.TWINS``: S's is ``bin_basis_rects_plain``)."""
    return getattr(module, module.TWINS[name])


def binning_plain_names(module) -> set:
    """Every plain version of S-U: the twins and the two halves of S's."""
    return {*module.TWINS.values(), "bin_basis_plain", "bin_rects_plain"}


def binning_twin_route():
    """The raster binning on the plain versions, called explicitly on CUDA
    tensors (S-U's twins; everything else on its kernels)."""
    return swapped(*((m, name, binning_twin(m, name))
                     for m, name in binning_steps()))


def binning_calls(run) -> dict:
    """{letter: [(args, kwargs), ...]} of every call of S-U's dispatchers
    in ``run()``, in order."""
    seen = {k: [] for k in "STU"}
    with contextlib.ExitStack() as stack:
        for letter, (m, name) in zip("STU", binning_steps()):
            stack.enter_context(calls_of(m, name, keep=lambda *a, _l=letter,
                                         **k: seen[_l].append((a, k))))
        run()
    return seen


def binning_outputs(out) -> tuple:
    """A dispatcher's outputs as a tuple of tensors (U's dict in key
    order; S's cfull and basis are None for bundle boxes)."""
    if isinstance(out, dict):
        return tuple(out[k] for k in sorted(out))
    return tuple(x for x in out if x is not None)


def hold_binning(letter: str, args, kw, label: str) -> tuple:
    """One of S-U (its dispatcher) against its twin on the same CUDA
    tensors: one launch, every output equal (NaN equal to NaN; a zero's
    sign is a reduction's pick and compares equal).  Returns (kernel's
    outputs, max |diff|)."""
    import torch
    module, name = binning_steps()["STU".index(letter)]
    before = K[letter].launches
    kern = getattr(module, name)(*args, **kw)
    if K[letter].launches != before + 1:
        raise AssertionError(f"{letter} did not launch")
    twin = binning_twin(module, name)
    plain = twin(*args, **kw)
    torch.cuda.synchronize()
    bad, err = held(f"{letter} {K[letter].name}, {label}",
                    binning_outputs(kern), binning_outputs(plain))
    if bad:
        raise AssertionError(f"{letter} disagrees with {twin.__name__} on "
                             f"{bad} elements ({label})")
    return kern, err


def binning_work(letter: str, args, kw, kern) -> tuple:
    """(bytes, operations) one launch of ``letter`` needs on its wave,
    from the wave's data: each input read once (a bound or row broadcast
    over the wave once), each output written once; T's tests over the
    blocks with a live lane (bundle: each live octant of a block, every
    window), U's keys of the pairs it keeps (bundle: the test over the
    row's live octants; projective: a load) and its sort, n log2 n
    comparisons a row."""
    import torch

    def nbytes(*ts):
        return sum(x.numel() * x.element_size() for x in ts
                   if isinstance(x, torch.Tensor))

    def rays_in(x):
        return 0 if not isinstance(x, torch.Tensor) or (
            x.dim() and x.stride(0) == 0) else nbytes(x)

    if letter == "S":
        # the geometry read once (the rects' second read is L2's), the
        # point or the wave's first direction, the rects, flags and basis
        source, a = args[0], args[1]
        b = args[2] if len(args) > 2 else kw.get("b")
        io = nbytes(a, b, *binning_outputs(kern)) + 12
        if source == 2:                               # bundle boxes
            return io, (a.numel() // 3) * 6
        rows = a.numel() // 3
        points = rows * (8 if source == 1 else 1)
        centroid = 0
        if (args[3] if len(args) > 3 else kw.get("point")) is not None:
            centroid = rows * (CENTROID_OPS + (CENTER_OPS if source == 1
                                               else 0))
        return io, points * POINT_OPS + centroid
    if letter == "T":
        o, d, t_min, t_max, W, mode, rects = args[:7]
        bounds = kern[3]
        C = rects.shape[1]
        io = (rays_in(o) + rays_in(d) + rays_in(t_min) + rays_in(t_max)
              + nbytes(rects, *args[7:8]) + nbytes(*kern))
        n = o.shape[0]
        if mode == "bundle":
            live_oct = int((bounds[..., 12] < 1e16).sum())
            return io, n * RAY_BOX_OPS + live_oct * C * BOX_TEST_OPS
        live = int((bounds[:, 6] != 0).sum())
        return io, n * RAY_RECT_OPS + live * C * RECT_TEST_OPS
    rects, bounds, cnt_b, offs, mask, pc_max, mode = args[:7]
    nb = cnt_b.shape[0]
    keep = torch.clamp(torch.minimum(
        cnt_b.long(), pc_max - offs[:nb].long()), min=0)
    kf = keep[keep > 1].double()
    sort = int((kf * torch.log2(kf)).sum()) * SORT_OPS
    io = nbytes(cnt_b, offs, mask, *binning_outputs(kern))
    if mode != "bundle":
        return io + nbytes(rects[4]), sort
    live = (bounds[..., 12] < 1e16).sum(1).long()
    keys = int((keep * live).sum()) * BOX_TEST_OPS
    return io + nbytes(rects, bounds), keys + sort


def path_pile_scene(t: SimpleNamespace):
    """Frame 0 of the Time scene's flatten route with phase 11's area
    light over the pile (an EMISSIVE ANIM_LIGHT panel): (scene,
    materials, lights, intersector)."""
    import torch

    from optix_ray_tracer_tpu_torch.io.meshgen import quad
    from optix_ray_tracer_tpu_torch.models.common import choose_intersector
    from optix_ray_tracer_tpu_torch.scene.geometry import Scene, Triangles
    from optix_ray_tracer_tpu_torch.scene.lights import collect_area_lights
    from optix_ray_tracer_tpu_torch.scene.materials import (
        EMISSIVE, MaterialTable,
    )

    device = t.device
    z, half, radiance = ANIM_LIGHT
    lv, ln = quad((-half, -half, z), (-half, half, z), (half, half, z),
                  (half, -half, z))
    m = t.mats
    mats = MaterialTable(
        mtype=torch.cat([m.mtype, torch.tensor([EMISSIVE], device=device,
                                               dtype=torch.int32)]),
        albedo=torch.cat([m.albedo, torch.zeros((1, 3), device=device)]),
        param=torch.cat([m.param, torch.zeros(1, device=device)]),
        emission=torch.cat([m.emission, torch.full((1, 3), radiance,
                                                   device=device)]))
    lamp = Triangles.from_arrays(lv, ln, np.int32(m.count), device=device)
    scene = Scene(t.flat.spheres, t.flat.triangles.concat(lamp))
    return scene, mats, collect_area_lights(scene, mats), choose_intersector(
        scene)


def pile_frame(t: SimpleNamespace, pile) -> "torch.Tensor":
    """``render_path`` of the path pile's frame 0 (1200x800, spp 1, depth
    DEPTH; its NEE segments on the bundle engine)."""
    from optix_ray_tracer_tpu_torch.render import pathtracer
    scene, mats, lights, inter = pile
    return pathtracer.render_path(
        scene, mats, lights, t.cam, ANIM_WIDTH, ANIM_HEIGHT, spp=1, seed=1,
        max_depth=DEPTH, intersector=inter)[0]


def full_block_wave(t: SimpleNamespace):
    """A block that pairs every window: 32x32 rays from far off the
    flatten pile (eye 200 units out, a 90-degree view), one 1,024-ray
    block over the flatten route's 3,368 clusters at g = 4 (13,472
    windows: U's row is longer than its shared-memory sort).  The
    ``_coarse_stage`` arguments."""
    import torch

    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    eye = torch.tensor([150.0, 60.0, 120.0])
    look = eye - eye / torch.linalg.norm(eye)
    cam = Camera.look_at(tuple(eye.tolist()), tuple(look.tolist()),
                         (0.0, 0.0, 1.0), device=t.device)
    o, d = (x.reshape(-1, 3) for x in cam.generate_rays(TILE, TILE))
    n = o.shape[0]
    C = t.finter.clusters.num_clusters * 4
    return (t.finter.raster, t.finter.clusters, o, d,
            torch.full((n,), 1e-3, device=t.device),
            torch.full((n,), 1e16, device=t.device), "origin", o[0], n,
            C + 1000, 4)


def binning_waves(b: SimpleNamespace, t: SimpleNamespace, p, pile) -> list:
    """Phase 16's waves: (label, stage, args) of the bench camera wave (g =
    4) and its cut at two thirds of its pairs, the bench shadow wave (g =
    2), the TLAS camera wave (S on the pairs), config 5's first camera
    wave and the path pile's first bundle NEE wave (each captured from a
    frame), and :func:`full_block_wave`."""
    from optix_ray_tracer_tpu_torch.ops import raster
    from optix_ray_tracer_tpu_torch.ops import raster_instanced as ri
    from optix_ray_tracer_tpu_torch.ops.march import (
        DEFAULT_ANYHIT_GRANULARITY, DEFAULT_GRANULARITY,
    )
    W = TILE * TILE
    G, GS = DEFAULT_GRANULARITY, DEFAULT_ANYHIT_GRANULARITY
    camera = (b.inter.raster, b.cs, b.o, b.d, b.tmin0, b.tmax_inf, "origin",
              b.o[0], W, b.pc_max1, G)
    cut = camera[:9] + (int(raster._coarse_stage(*camera)["pc_total"]) * 2
                        // 3, G)
    tlas = time_frame(t, 0).tlas
    with calls_of(raster, "_coarse_stage",
                  keep=lambda *a, **k: a) as c5_waves:
        path_frame(p.c5, p.i5, spp=1, max_depth=1)
    nee = []
    raster.BUNDLE_OBSERVERS.append(
        lambda args, kw, S: nee.append((args, kw)) if not nee else None)
    try:
        pile_frame(t, pile)
    finally:
        raster.BUNDLE_OBSERVERS.pop()
    args, kw = nee[0]
    return [
        ("the bench camera wave (g 4)", raster._coarse_stage, camera, {}),
        ("the bench camera wave cut at 2/3 of its pairs",
         raster._coarse_stage, cut, {}),
        ("the bench shadow wave (g 2)", raster._coarse_stage,
         (b.inter.raster, b.cs, *b.shadow, "origin", b.light, W, b.pc_max2,
          GS), {}),
        (TLAS_WAVE, ri.instanced_coarse_stage,
         (tlas.pair_min, tlas.pair_max, t.o, t.d, t.tmin, t.tmax, "origin",
          t.o[0], W, raster.round_pc_max(t.pc1), tlas.pair_shape,
          tlas.pair_inst), {}),
        ("config 5's first camera wave", raster._coarse_stage, c5_waves[0],
         {}),
        (BUNDLE_WAVE, raster.bundle_stage, args, kw),
        ("one block pairing every flatten window", raster._coarse_stage,
         full_block_wave(t), {})]


def binning_row(letter: str, call, err: float, label: str,
                card: str) -> dict:
    """One kernel's JSON row on one call ``(args, kwargs)`` of its
    dispatcher: device ms per launch (profiler trace), the twin's ms, the
    bound (:func:`binning_work`)."""
    module, name = binning_steps()["STU".index(letter)]
    a, k = call
    step = getattr(module, name)
    twin = binning_twin(module, name)
    kern = step(*a, **k)
    io_bytes, ops = binning_work(letter, a, k, kern)
    ms, by = device_ms(lambda: step(*a, **k), BIN_KERNELS[letter], letter,
                       REPS)
    call_ms = time_ms(lambda: step(*a, **k), REPS)
    plain_ms = time_ms(lambda: twin(*a, **k), 1)
    r = row(err, ms, plain_ms, io_bytes, ops, by)
    print(f"[binning] {letter} {K[letter].name}, {label}: device {ms:.4f} "
          f"ms ({call_ms:.4f} ms per wrapper call; plain {plain_ms:.3f} ms) "
          f"[{card}]; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({io_bytes} B, {ops} operations; "
          f"{100 * r['bound_ms'] / ms:.1f}%)")
    return r


def binning_rows(waves, card: str) -> dict:
    """Phase 16 (a), (b): S, T and U against their twins on every call of
    every wave's stage, exact; each kernel's row on the bench camera wave,
    S's on the TLAS camera wave (the row bin_rects_pair), and S's, T's and
    U's (the rows bin_rects_box, bin_count_bundle, bin_emit_bundle) on the
    path pile's first bundle NEE wave."""
    import torch
    errs, calls_of_wave = {}, {}
    for label, stage, args, kw in waves:
        calls = binning_calls(lambda: stage(*args, **kw))
        S = stage(*args, **kw)
        nb, total = S["nb"], int(S["pc_total"])
        print(f"[binning] {label}: {S['n']} rays in {nb} blocks, {total} "
              f"pairs, capacity {S['b_i'].shape[0]}, longest row "
              f"{int(S['cnt_b'].max())}")
        for letter in "STU":
            errs[label, letter] = max(
                hold_binning(letter, a, k, label)[1] for a, k in calls[letter])
        if "every" in label:
            a, k = calls["S"][0]
            windows = int((~torch.isnan(binning_steps()[0][0].bin_rects(
                *a, **k)[0][4])).sum())
            if nb != 1 or int(S["cnt_b"][0]) != windows:
                raise AssertionError(f"{label}: {int(S['cnt_b'][0])} pairs "
                                     f"of {windows} windows with a vertex")
        calls_of_wave[label] = calls
    bench, pile = waves[0][0], BUNDLE_WAVE
    rows = {}
    for letter in "STU":
        err = max(e for (_, k), e in errs.items() if k == letter)
        rows[K[letter].name] = binning_row(
            letter, calls_of_wave[bench][letter][0], err, bench, card)
    for letter, name, wave in (("S", "bin_rects_pair", TLAS_WAVE),
                               ("S", "bin_rects_box", pile),
                               ("T", "bin_count_bundle", pile),
                               ("U", "bin_emit_bundle", pile)):
        rows[name] = binning_row(letter, calls_of_wave[wave][letter][0],
                                 errs[wave, letter], wave, card)
    return rows


def binning_frames(frame, p, t: SimpleNamespace, pile, card: str) -> dict:
    """Phase 16 (c): phase 4's Whitted frame, config 5's frame and the path
    pile's frame 0 by the kernels (counts zeroed just before and read just
    after: S, T, U launched, no plain version of H-U called) and with
    S-U's twins called explicitly (:func:`binning_twin_route`: no launch
    of S-U), held to each other at max |diff| 0.  Returns the kernel
    routes' launches."""
    import torch

    from optix_ray_tracer_tpu_torch.render import wavefront
    launches = {}

    def timed(render):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = render()
        torch.cuda.synchronize()
        return img, time.perf_counter() - t0

    for label, render in (
            ("phase 4's Whitted frame", lambda: wavefront.render(
                frame.scene, frame.mats, frame.cam, WIDTH, HEIGHT, spp=SPP,
                seed=frame.seed, max_depth=DEPTH,
                intersector=frame.inter)[0]),
            ("config 5's frame", lambda: path_frame(p.c5, p.i5)),
            ("the path pile's frame 0", lambda: pile_frame(t, pile))):
        zero_counts()
        with no_twin_calls(label):
            img, s_kern = timed(render)
        counts = launch_counts("STU")
        for k, n in {**counts, **launch_counts(BIN_VARIANTS)}.items():
            launches[K[k].name] = launches.get(K[k].name, 0) + n
        zero_counts()
        with binning_twin_route():
            twin, s_twin = timed(render)
        twin_counts = launch_counts("STU")
        err = float((img - twin).abs().max())
        print(f"[binning] {label}: kernels {s_kern:.3f} s/frame (launches "
              f"{counts_text(counts)}), S-U's twins {s_twin:.3f} s/frame "
              f"[{card}]; max |diff| {err:.3g}")
        if min(counts.values()) == 0:
            raise AssertionError(f"{label} missed a kernel of S-U: {counts}")
        if any(twin_counts.values()):
            raise AssertionError(f"the twin route launched {twin_counts}")
        if not torch.isfinite(img).all() or err != 0:
            raise AssertionError(f"{label} by the kernels differs from the "
                                 f"twins'")
    return launches


def binning_phase(b, frame, t, p, card: str) -> tuple:
    """Phase 16: the raster binning, S-U.  Returns (their JSON rows, the
    launches of (c))."""
    t0 = time.perf_counter()
    pile = path_pile_scene(t)
    print(f"[binning] the path pile's scene: {pile[0].triangle_count} "
          f"triangles (host build {time.perf_counter() - t0:.1f} s)")
    rows = binning_rows(binning_waves(b, t, p, pile), card)
    launches = binning_frames(frame, p, t, pile, card)
    print(f"[binning] phase 16 in {time.perf_counter() - t0:.1f} s")
    return rows, launches


#: the variant rows of the kernels' JSON line: name -> (kernel letter,
#: the TPU kernel's file:line)
# ---- phase 17: the deep marchers past MAX_CLUSTERS (F2, C2) ---------------

def deep_setup(device) -> SimpleNamespace:
    """The chute cell's shapes: 16,900 UV spheres of 396 triangles in a
    130 x 130 grid (26,143 clusters, past MAX_CLUSTERS) through the device
    median build a scene of that size gets first, a 1200x800 camera wave
    from above and a 960,000-ray incoherent wave inside the layer, every
    third ray dead (t_max 0)."""
    import torch

    from optix_ray_tracer_tpu_torch.io.meshgen import sphere_with_n_triangles
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.march import make_march_intersector
    from optix_ray_tracer_tpu_torch.scene.camera import Camera
    from optix_ray_tracer_tpu_torch.scene.geometry import (
        Scene, Spheres, Triangles,
    )

    v, n = sphere_with_n_triangles(450)
    k = np.arange(16900)
    centers = (np.stack([k % 130, k // 130, np.zeros(16900)], -1) * 2.2
               ).astype(np.float32)
    scene = Scene(Spheres.empty(device), Triangles.from_arrays(
        (v[None] + centers[:, None, None]).reshape(-1, 3, 3),
        np.broadcast_to(n[None], (16900,) + n.shape).reshape(-1, 3, 3),
        device=device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inter = make_march_intersector(scene, method="median")
    torch.cuda.synchronize()
    cs = inter.clusters
    print(f"[deep scene] {scene.triangle_count} triangles, "
          f"{cs.num_clusters} clusters (device median build "
          f"{time.perf_counter() - t0:.3f} s)")
    if not bm.is_deep(cs.num_clusters):
        raise AssertionError("the deep scene is not past MAX_CLUSTERS")
    cam = Camera.look_at((-30.0, -30.0, 60.0), (143.0, 143.0, 0.0),
                         (0.0, 0.0, 1.0), device=device)
    o, d = (x.reshape(-1, 3) for x in cam.generate_rays(1200, 800))
    gen = np.random.default_rng(8)
    R = 960_000
    oi = torch.as_tensor(np.concatenate([
        gen.uniform(0.0, 286.0, (R, 2)), gen.uniform(-1.2, 1.2, (R, 1))],
        -1).astype(np.float32), device=device)
    di = gen.normal(size=(R, 3)).astype(np.float32)
    di = torch.as_tensor(di / np.linalg.norm(di, axis=-1, keepdims=True),
                         device=device)
    tmax = torch.full((R,), 1e16, device=device)
    tmax[::3] = 0.0
    return SimpleNamespace(scene=scene, inter=inter, cs=cs, o=o, d=d, oi=oi,
                           di=di, tmin=torch.full((R,), 1e-3, device=device),
                           tmax=tmax, R=R)


def deep_bound_ops(rays, n_clusters: int) -> int:
    """Float operations no exact answer of F2 or C2 can skip: each live
    ray's slab test of every hypercluster (the tables' top level)."""
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    live = int(bm.probe_live(rays).sum())
    return live * bm._deep_rows(n_clusters)[1] * SLAB_OPS


def deep_phase(device, card: str) -> tuple:
    """Phase 17: F2 and C2 at the chute cell's shapes.  Returns (their
    JSON rows, their launches in the routed waves)."""
    import torch

    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    from optix_ray_tracer_tpu_torch.ops.kernels import block_march as bm
    from optix_ray_tracer_tpu_torch.ops.march import ray_probe_keys
    from optix_ray_tracer_tpu_torch.ops.raysort import ray_sort_keys

    t0 = time.perf_counter()
    g = deep_setup(device)
    cs, dev = g.cs, device
    prims = prim_keys(cs)
    old = (K["B"], K["C"], K["F"])
    new = (_lib.BLOCK_MARCH_DEEP, _lib.PROBE_DEEP)

    # the intersector's routing: counts zeroed, one coherent and one
    # incoherent wave
    zero_counts()
    g.inter.intersect(g.scene, g.o, g.d)
    g.inter.for_incoherent().intersect(g.scene, g.oi, g.di)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in new}
    ran_old = [k.launches for k in old]
    print(f"[deep] routed waves: launches F2 {launches['block_march_deep']}, "
          f"C2 {launches['probe_deep']}, B/C/F {ran_old}")
    if any(ran_old) or launches != {"block_march_deep": 2, "probe_deep": 1}:
        raise AssertionError("the deep scene's waves did not take F2 and C2 "
                             "alone")
    print(f"  F2: {bm.deep_occupancy()} resident warps per SM (any-hit "
          f"{bm.deep_occupancy(any_hit=True)}); C2: "
          f"{bm.deep_occupancy(probe=True)}")

    # C2 on the incoherent wave, which also gives its probe sort
    pin = bm.probe_inputs(cs, g.oi, g.di, g.tmin, g.tmax)
    ids, tests = bm.probe_call(**pin)
    c_ms = time_ms(lambda: bm.probe_call(**pin), REPS)
    pick = warp_rays(g.R, SUBSET_DEEP).to(dev)
    psub = dict(pin, rays=pin["rays"][:, pick].contiguous())
    kern = bm.probe_call(**psub)[0]
    plain, cp_ms = time_once(lambda: bm.probe_deep_plain(**psub))
    flat = bm.probe_plain(psub["rays"], psub["boxes"], psub["n_clusters"],
                          psub["c_pad"])
    bad = int((kern != plain).sum()) + int((kern != flat).sum())
    bad += int((ids[pick] != kern).sum())
    print(f"  C2 incoherent: {bad} id mismatches of {SUBSET_DEEP} rays "
          f"against the deep and the flat plain probes "
          f"({int((plain < pin['c_pad']).sum())} entered a cluster); full "
          f"wave {g.R} rays {c_ms:.3f} ms [{card}], plain {cp_ms:.1f} ms on "
          f"the subset; box tests run {int(tests)}")
    if bad:
        raise AssertionError(f"C2: {bad} ids differ")
    c_row = row(0.0, c_ms, cp_ms, tensor_bytes(pin, ids),
                deep_bound_ops(pin["rays"], cs.num_clusters))
    print(f"    C2: bound {c_row['bound_ms']:.4f} ms by {c_row['bound_by']}, "
          f"{100 * c_row['bound_ms'] / c_ms:.2f}% of the wave")

    # F2 on the camera wave (Morton-sorted) and on the incoherent wave
    # (probe-sorted), each as the intersector sorts it
    R = g.o.shape[0]
    perm_c = torch.argsort(ray_sort_keys(g.o, g.d, g.inter.scene_lo,
                                         g.inter.scene_hi), stable=True)
    perm_i = torch.argsort(ray_probe_keys(cs, g.oi, g.di, g.tmin, g.tmax),
                           stable=True)
    cam_tmin = torch.full((R,), 1e-3, device=dev)
    cam_tmax = torch.full((R,), 1e16, device=dev)
    f_rows = []
    for label, wave, coherent, any_hit in (
            ("camera nearest", (g.o[perm_c], g.d[perm_c], cam_tmin,
                                cam_tmax), True, False),
            ("incoherent nearest", (g.oi[perm_i], g.di[perm_i], g.tmin,
                                    g.tmax[perm_i]), False, False),
            ("incoherent any-hit", (g.oi[perm_i], g.di[perm_i], g.tmin,
                                   torch.where(g.tmax[perm_i] > 0, 1.5, 0.0)),
             False, True)):
        inp = bm.deep_inputs(cs, *wave, coherent)
        full = bm.march_deep_call(**inp, any_hit=any_hit)
        full_ms = time_ms(lambda: bm.march_deep_call(**inp, any_hit=any_hit),
                          REPS)
        n = inp["rays"].shape[1]
        sub = dict(inp, rays=inp["rays"][:, warp_rays(n, SUBSET_DEEP).to(
            dev)].contiguous())
        kern = bm.march_deep_call(**sub, any_hit=any_hit)
        plain, p_ms = time_once(lambda: bm.march_deep_plain(
            **{k: v for k, v in sub.items() if k != "w"}, any_hit=any_hit))
        err = compare(f"F2 {label}", prims, kern, plain, any_hit)
        ms = time_ms(lambda: bm.march_deep_call(**sub, any_hit=any_hit),
                     REPS)
        r = row(err, full_ms, p_ms, tensor_bytes(inp, full),
                deep_bound_ops(inp["rays"], cs.num_clusters))
        print(f"    {label}: kernel {ms:.3f} ms vs plain {p_ms:.1f} ms on "
              f"{SUBSET_DEEP} rays; full wave ({n} rays) {full_ms:.3f} ms "
              f"[{card}], {full[2].float().mean().item() / CHUNK:.2f} "
              f"cluster-equivalent visits per warp; bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"{100 * r['bound_ms'] / full_ms:.2f}% of the wave")
        f_rows.append(r)
    rows = {"block_march_deep": dict(f_rows[1], max_abs_err=max(
        r["max_abs_err"] for r in f_rows)), "probe_deep": c_row}
    print(f"[deep] phase 17 in {time.perf_counter() - t0:.1f} s")
    return rows, launches


VARIANT_ROWS = {
    "tile_raster_dir": ("A", "optix_ray_tracer_tpu/ops/pallas/"
                        "tile_raster.py:219"),
    "tile_raster_instanced_dir": ("D", "optix_ray_tracer_tpu/ops/pallas/"
                                  "tile_raster.py:219"),
    "tile_raster_bundle": ("A", "optix_ray_tracer_tpu/ops/pallas/"
                           "tile_raster.py:70"),
    "bin_rects_pair": ("S", "optix_ray_tracer_tpu/ops/raster_instanced.py:52"),
    "bin_rects_box": ("S", "optix_ray_tracer_tpu/ops/raster.py:512"),
    "bin_count_bundle": ("T", "optix_ray_tracer_tpu/ops/raster.py:573"),
    "bin_emit_bundle": ("U", "optix_ray_tracer_tpu/ops/raster.py:638"),
}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    import optix_ray_tracer_tpu_torch  # noqa: F401  (fails outside the repo)
    from optix_ray_tracer_tpu_torch.ops.kernels import _lib
    K.update(A=_lib.TILE_RASTER, B=_lib.BLOCK_MARCH, C=_lib.PROBE,
             D=_lib.TILE_RASTER_INSTANCED, E=_lib.BLOCK_MARCH_INSTANCED,
             F=_lib.BLOCK_MARCH_HIER, G=_lib.LEAF_SWEEP, H=_lib.PCG4D,
             I=_lib.SOBOL_OWEN4, J=_lib.WHITTED_SCATTER, K=_lib.PATH_BSDF,
             L=_lib.PATH_NEE_SAMPLE, M=_lib.PATH_NEE_ADD,
             N=_lib.PATH_HIT_RADIANCE, O=_lib.MARCH_KEYS,
             P=_lib.GATHER_RAYS, Q=_lib.FINISH_HITS, R=_lib.SHADING_FRAME,
             S=_lib.BIN_RECTS, T=_lib.BIN_COUNT, U=_lib.BIN_EMIT)
    K.update(t=VariantCount(K["T"], "bundle", "bin_count_bundle"),
             u=VariantCount(K["U"], "bundle", "bin_emit_bundle"),
             s_pair=VariantCount(K["S"], "pair", "bin_rects_pair"),
             s_box=VariantCount(K["S"], "box", "bin_rects_box"))
    card = card_line()
    print(card)      # name and power limit, as nvidia-smi reports them
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    build_kernels()
    b = bench_setup(device)
    b.card = card
    rows = check_kernels(b)
    bench(b, card)
    launches, frame = whitted(device, card)
    t = time_setup(device)
    t.card = card
    rows.update(check_time_kernels(t))
    for name, n in time_frames(t, card).items():
        launches[name] = launches.get(name, 0) + n
    rows["leaf_sweep"], launches["leaf_sweep"] = sweep_phase(b, frame, card)
    frame_tail(frame, card)
    for name, n in animation_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    path_rows, path_launches = path_phase(b, t, card)
    rows.update(path_rows)
    for name, n in path_launches.items():
        launches[name] = launches.get(name, 0) + n
    for name, n in extras_phase(card).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in parallel_phase(frame, card).items():
        launches[name] = launches.get(name, 0) + n
    bounce_rows, bounce_launches, p = bounce_phase(frame, card)
    rows.update(bounce_rows)
    for name, n in bounce_launches.items():
        launches[name] = launches.get(name, 0) + n
    glue_rows, glue_launches = glue_phase(frame, t, p, card)
    rows.update(glue_rows)
    for name, n in glue_launches.items():
        launches[name] = launches.get(name, 0) + n
    bin_rows, bin_launches = binning_phase(b, frame, t, p, card)
    rows.update(bin_rows)
    for name, n in bin_launches.items():
        launches[name] = launches.get(name, 0) + n
    deep_rows, deep_launches = deep_phase(device, card)
    rows.update(deep_rows)
    launches.update(deep_launches)
    kernels = [{"name": k.name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": launches[k.name],
                **rows[k.name]} for k in _lib.KERNELS]
    kernels += [{"name": name, "route": "cuda", "source": K[k].source,
                 "replaces": replaces, "launches": launches[name],
                 **rows[name]} for name, (k, replaces) in VARIANT_ROWS.items()]
    print(f"[smoke] phases 1-17 in {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
