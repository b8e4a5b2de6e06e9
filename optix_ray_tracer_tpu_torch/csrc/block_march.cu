// Block marchers and cluster probe: the nearest-hit / occlusion query of
// incoherent and sorted waves, and the sort keys of those waves.
//
// ort_block_march replaces the Pallas kernel
//   optix_ray_tracer_tpu/ops/pallas/block_march.py:173 _make_kernel
//   (instanced=False; via _march_call / block_march).
// ort_block_march_instanced replaces the same kernel with instanced=True
//   (block_march.py:177-183, 237-240, 270-295; via block_march_instanced,
//   block_march.py:916): cull rows are (instance, library cluster) TLAS
//   pairs.
// ort_block_march_hier replaces
//   optix_ray_tracer_tpu/ops/pallas/block_march.py:463 _make_hier_kernel
//   (via _hier_call / block_march_hier, block_march.py:603, 635).
// ort_probe_first_cluster replaces
//   optix_ray_tracer_tpu/ops/pallas/block_march.py:694 _make_probe_kernel
//   (via probe_first_cluster).
// ort_block_march_deep (F2) and ort_probe_deep (C2) have no Pallas
//   counterpart: they take F's and C's waves past MAX_CLUSTERS, where the
//   JAX package's marchers stop (design notes below C's).
//
// What bounds the march (B, E, F) on the H100: FP32 CUDA-core work, ~47
// operations per (ray, triangle) Woop test and ~26 per (ray, box) slab
// test, and the work is what the rays need.  The TPU kernel re-picks, per
// block of W rays, the nearest cluster any ray still needs from a (C, W)
// entry matrix in VMEM and double-buffers the cluster's DMA.  A CTA-wide
// copy of that walk (one sorted key per cull row in shared memory, 12 KB
// of rows staged per visit between barriers) held E at 8 resident warps
// per SM and made every visit a 128-ray union (E's 1M-ray incoherent wave
// in a 5,495-pair TLAS: 123.1 ms; 32.6 ms with the design below, 28
// resident warps per SM; NVIDIA H100 80GB HBM3, 700 W).  Design here: the
// WARP is the unit of the march.
//
// - Each warp marches its own 32 rays; every decision is a warp vote
//   (__reduce_min_sync / __any_sync) and no barrier spans the CTA, so a
//   warp whose rays are done leaves while its neighbours go on.  The CTA
//   is 4 warps; the callers' block width w (a multiple of 128) only pads
//   the wave.
// - Cull: every lane slab-tests every cull row; a row some lane enters
//   before its best t becomes an (ordered warp-min entry << 32 | row) key
//   in the warp's candidate list (kWarpKeys keys, 4 KB, fixed).  When the
//   list fills, the warp sorts it, keeps the nearest half and drops every
//   later key past a cap, so the list always holds exactly the candidates
//   below the cap.
// - March: the list is sorted and visited nearest first.  A row is visited
//   if some lane enters it before its best t; each part (64- or 128-row
//   sub block) is tested if some lane enters its sub box before its best
//   t.  The warp stops at the first key whose entry is >= every lane's
//   best t.  If keys were dropped and a lane could still enter them, the
//   warp culls again for the keys >= the cap (a lane's own (entry, row)
//   below the cap was tested in an earlier round) under the shrunken best
//   t: no row is ever lost, so the nearest t is exact whatever the
//   capacity; the order decides only equal-t ties (earliest visit, then
//   lowest row, as before).
// - Rows reach the warp without a CTA barrier (ort_warp_rows, common.cuh,
//   shared with the tile raster): lane j loads row j of a 32-row slice
//   with 12 coalesced loads and stores it to the warp's 1.5 KB slice in
//   shared memory; every lane then reads each row as three 16-byte
//   broadcasts.  The next slice's loads are issued before the
//   current slice is tested (the TPU kernel's double buffer, per warp and
//   in registers).  Handing the rows lane to lane by __shfl_sync instead
//   (12 shuffles per row against 3 shared loads, 80 registers, 24
//   resident warps per SM against 28) was 12-19% slower on every wave
//   measured (E's 1M-ray incoherent wave 37.3 ms against 32.6; NVIDIA
//   H100 80GB HBM3, 700 W).
// - E moves each lane's ray into the pair's instance space per visit
//   (ort_to_instance); the library's rows stay in L1/L2.
// - F (HIER) is the same march with 8-cluster superclusters (a NaN-aware
//   union box each) as its cull rows, so the cull and the list shrink
//   eightfold (421 rows at 3,368 clusters: the list fills only past 511
//   superclusters, and rounds keep it exact there).  A visited supercluster
//   merges the keys of its members that some lane enters before its best t
//   into the sorted list (insert_keys), so the warp visits clusters nearest
//   first across superclusters (a member that does not fit below the cap
//   is visited at once).  Exact because a supercluster's entry is <= the
//   entry of every cluster inside it (block_march.py:471), so the stop
//   rule holds.
//   Its first, CTA-wide design (a bitonic sort of every supercluster's
//   block-min entry per 128-ray CTA, a __syncthreads_or per decision, 12 KB
//   of rows staged between barriers per visited cluster) took 3.568 ms on
//   the flatten camera wave (1M rays, 3,368 clusters); this design 2.32
//   ms, Woop tests 1.92x the needed ones; opening a supercluster's members
//   at once in id order instead, 2.70 ms and 2.93x (NVIDIA H100 80GB
//   HBM3, 700 W).
// Shared memory: 5.5 KB per warp whatever the number of cull rows.
// out_visits counts, per warp, the Woop rows it tested (each one test on
// each of its 32 lanes).
//
// The probe (C) is bound by FP32 slab tests (~26 operations each).  The
// TPU kernel tests every (ray, cluster box) from VMEM; a per-thread copy of
// it (every ray, dead or not, against all C boxes restaged into 6 C floats
// of shared memory per 128-ray CTA: 80.8 KB and 8 resident warps per SM at
// 3,368 clusters, an isnan per slab) took 30.7 ms on the flatten frame's
// 4M-ray first bounce wave (NVIDIA H100 80GB HBM3, 700 W).  Design here:
//
// - Live rays only.  A ray with t_max <= t_min, a NaN bound or a NaN in
//   its origin gets c_pad without a box test (every entry is >= t_min; a
//   NaN never enters).  Each 256-ray tile packs its live rays onto its
//   leading warps (ballots and a CTA prefix in shared memory).
// - Supercluster pre-cull.  The union boxes of 8 consecutive clusters
//   (F's superclusters) are tested in ascending id order; a supercluster's
//   members are tested when some lane (warp vote) enters the union below
//   its best entry and its t_max, and a member takes the answer on a
//   strictly smaller entry.  Exact, ties included: a union's entry is <=
//   each member's under monotone rounding, and an earlier answer always
//   has the lower id.
// - Fixed shared memory.  Only the superclusters are staged (32 B each,
//   their member mask in the padding): 32 KB for MAX_CLUSTERS whatever C
//   is.  Each CTA forms the unions from the member rows as it stages them
//   (building them per wave on the host cost ~20 small launches a wave).
//   Member rows are two 16-byte __ldg broadcasts.  Persistent CTAs (one
//   per resident slot) stage once and walk the tiles.
// - NaN handled once.  NaN members are masked out when staged and NaN
//   rays are dead, so the slab tests drop their isnan; a warp holding an
//   infinite origin or direction (inf - inf, inf x 0) scans every box
//   with the NaN check instead.
//
// The flat scan with the same live packing and fixed budget (every member
// of every supercluster) was measured and removed: 32.8 ms on that wave
// and 0.90 ms on the 388-cluster 1M-ray incoherent wave, against 6.70 and
// 0.71 ms for this design in the same run (6.81 and 0.71 ms once the
// unions are formed here; NVIDIA H100 80GB HBM3, 700 W).

#include "common.cuh"

namespace {

constexpr int kGroup = 8;   // clusters per supercluster (block_march.GROUP)

// The warp march (B, E, F)
constexpr int kWarpKeys = 512;   // candidate keys per warp
constexpr int kCtaWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;   // ordered entry: no lane enters
constexpr unsigned long long kNoKey = ~0ull;
constexpr unsigned kMember = 0x80000000u;   // F: a key's row is a cluster

// The probe (C)
constexpr int kProbeThreads = 256;           // rays per tile: 8 warps
constexpr int kProbeWarps = kProbeThreads / 32;
constexpr int kMaxSup = 8192 / kGroup;       // block_march.MAX_CLUSTERS / 8
constexpr int kSupBatch = 4;                 // superclusters per warp vote

struct WarpScratch {
  unsigned long long keys[kWarpKeys];   // (ordered entry << 32 | row)
  float rows[ORT_SLICE * 12];           // one staged slice, 12 per row
};

__device__ __forceinline__ float key_entry(unsigned long long key) {
  return ort_unordered(static_cast<unsigned>(key >> 32));
}

// Sort the warp's first n keys ascending (n a power of two).
__device__ __forceinline__ void warp_sort(unsigned long long* keys, int n,
                                          int lane) {
  __syncwarp();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < n; i += 32) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], b = keys[p];
          if ((a > b) == ((i & k) == 0)) { keys[i] = b; keys[p] = a; }
        }
      }
      __syncwarp();
    }
  }
}

// One round of a warp's cull: the keys (warp-min entry over the lanes that
// enter the row before their best t with their own (entry, row) >= lo)
// of the nearest candidate rows, sorted into ws.keys; returns their count.
// cap = the smallest key dropped for want of room (kNoKey if none): the
// list holds every candidate key below cap.
__device__ __forceinline__ int cull_round(
    WarpScratch& ws, int lane, const float* __restrict__ boxes, int n_rows,
    float ox, float oy, float oz, float ix, float iy, float iz, float tmin,
    float bt, unsigned long long lo, unsigned long long& cap) {
  int n = 0;
  cap = kNoKey;
  for (int c = 0; c < n_rows; ++c) {
    const float e = ort_row_entry(boxes + 8 * static_cast<size_t>(c), ox, oy,
                                  oz, ix, iy, iz, tmin);
    const unsigned oe = ort_ordered(e);
    const bool mine =
        e < bt && ((static_cast<unsigned long long>(oe) << 32) |
                   static_cast<unsigned>(c)) >= lo;
    const unsigned m = __reduce_min_sync(kFull, mine ? oe : kNone);
    if (m == kNone) continue;
    const unsigned long long key =
        (static_cast<unsigned long long>(m) << 32) | static_cast<unsigned>(c);
    if (key >= cap) continue;
    if (lane == 0) ws.keys[n] = key;
    if (++n == kWarpKeys) {   // full: keep the nearest half
      warp_sort(ws.keys, kWarpKeys, lane);
      n = kWarpKeys / 2;
      cap = ws.keys[n];
      __syncwarp();           // every lane has read cap before it is reused
    }
  }
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + lane; i < p; i += 32) ws.keys[i] = kNoKey;
  warp_sort(ws.keys, p, lane);
  return n;
}

// Merge the key mk of each lane that holds one (mk != kNoKey, lanes <
// kGroup, every key above keys[k]) into the warp's sorted keys (k, n):
// each old key moves up by the new keys below it, last 32 first, and each
// new key lands after the old and new keys below it.  Slots [n, n + the
// new keys) must be free.
__device__ __forceinline__ void insert_keys(unsigned long long* keys,
                                            int lane, int k, int n,
                                            unsigned long long mk) {
  unsigned long long nk[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) nk[j] = __shfl_sync(kFull, mk, j);
  int at = n;
  if (mk != kNoKey) {
    int lo = k + 1;
    while (lo < at) {
      const int mid = (lo + at) >> 1;
      if (keys[mid] < mk) lo = mid + 1; else at = mid;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) at += nk[j] < mk;
  }
  __syncwarp();
  for (int b = n - 32; b > k - 32; b -= 32) {
    const int i = b + lane;
    unsigned long long v = 0;
    int up = 0;
    if (i > k) {
      v = keys[i];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) up += nk[j] < v;
    }
    __syncwarp();
    if (up) keys[i + up] = v;
    __syncwarp();
  }
  if (mk != kNoKey) keys[at] = mk;
  __syncwarp();
}

// One visit to cluster (or pair) c: each part gated on a warp vote of its
// sub box, then Woop-tested; returns the rows tested.
template <bool ANY_HIT, bool INST>
__device__ __forceinline__ int visit_row(
    WarpScratch& ws, int lane, int c, const float* __restrict__ sub_boxes,
    int n_subs, const float* __restrict__ woop_t,
    const int* __restrict__ pair_shape, const int* __restrict__ pair_inst,
    const float* __restrict__ inst_rows, float ox, float oy, float oz,
    float ix, float iy, float iz, float dx, float dy, float dz, float tmin,
    float& bt, int& slot) {
  const int step = ORT_CHUNK / n_subs;
  float tox = ox, toy = oy, toz = oz, tdx = dx, tdy = dy, tdz = dz;
  float no_u, no_v;   // u and v are recomputed from the winning row
  const float* w = woop_t + static_cast<size_t>(INST ? pair_shape[c] : c)
                                * ORT_WOOP_ROWS * ORT_CHUNK;
  if (INST)
    ort_to_instance(inst_rows + 128 * static_cast<size_t>(pair_inst[c]),
                    ox, oy, oz, dx, dy, dz, tox, toy, toz, tdx, tdy, tdz);
  int tested = 0;
  for (int part = 0; part < n_subs; ++part) {
    const float se = ort_row_entry(
        sub_boxes + 8 * (static_cast<size_t>(c) * n_subs + part), ox, oy, oz,
        ix, iy, iz, tmin);
    if (!__any_sync(kFull, se < bt)) continue;
    ort_warp_rows<ANY_HIT, ORT_COMMON_NONE, false>(
        ws.rows, lane, w, part * step, step, c * ORT_CHUNK, tox, toy, toz,
        tdx, tdy, tdz, tmin, bt, slot, no_u, no_v);
    tested += step;
  }
  return tested;
}

// INST: rows of boxes / sub_boxes are TLAS pairs; pair c tests library
// cluster pair_shape[c] with the rays moved by inst_rows[pair_inst[c]].
// HIER: rows of boxes are superclusters, row s the union of clusters
// [kGroup s, kGroup s + kGroup) < n_clusters, whose own boxes are rows of
// cl_boxes; sub_boxes and woop_t are per cluster.
// 7 CTAs (28 warps) per SM, at most 72 registers, no spills: E's
// nearest-hit instantiation took 76 on its own once F shared this code,
// which left 24 warps per SM and cost E ~5% on the TLAS frame (NVIDIA
// H100 80GB HBM3, 700 W).
template <bool ANY_HIT, bool INST, bool HIER>
__global__ void __launch_bounds__(32 * kCtaWarps, 7) warp_march_kernel(
    const float* __restrict__ rays, int n_rays,
    const float* __restrict__ boxes, int n_rows,
    const float* __restrict__ cl_boxes, int n_clusters,
    const float* __restrict__ sub_boxes, int n_subs,
    const float* __restrict__ woop_t, const int* __restrict__ pair_shape,
    const int* __restrict__ pair_inst, const float* __restrict__ inst_rows,
    float* __restrict__ out_t, int* __restrict__ out_slot,
    int* __restrict__ out_visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  WarpScratch& ws = reinterpret_cast<WarpScratch*>(smem)[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const float ox = rays[0 * n_rays + ray], oy = rays[1 * n_rays + ray],
              oz = rays[2 * n_rays + ray];
  const float dx = rays[3 * n_rays + ray], dy = rays[4 * n_rays + ray],
              dz = rays[5 * n_rays + ray];
  const float tmin = rays[6 * n_rays + ray];
  float bt = rays[7 * n_rays + ray];
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy), iz = ort_inv_dir(dz);
  int slot = -1;
  int tested = 0;

  unsigned long long lo = 0;   // this round's keys are >= lo
  // every entry is >= t_min: a lane with best t <= t_min needs nothing
  bool more = __any_sync(kFull, tmin < bt);
  while (more) {
    unsigned long long cap;
    int n = cull_round(ws, lane, boxes, n_rows, ox, oy, oz, ix, iy, iz, tmin,
                       bt, lo, cap);
    int k = 0;
    for (; k < n; ++k) {
      const unsigned long long key = ws.keys[k];
      // every later key, this round's and the next's, enters no earlier
      if (!__any_sync(kFull, key_entry(key) < bt)) break;
      const unsigned id = static_cast<unsigned>(key);
      const bool member = HIER && (id & kMember);
      const int c = static_cast<int>(id & ~kMember);
      const float e = ort_row_entry(
          (member ? cl_boxes : boxes) + 8 * static_cast<size_t>(c), ox, oy,
          oz, ix, iy, iz, tmin);
      if (!__any_sync(kFull, e < bt)) continue;
      if (!HIER || member) {
        tested += visit_row<ANY_HIT, INST>(
            ws, lane, c, sub_boxes, n_subs, woop_t, pair_shape, pair_inst,
            inst_rows, ox, oy, oz, ix, iy, iz, dx, dy, dz, tmin, bt, slot);
        continue;
      }
      // a supercluster: lane j takes the key of member kGroup c + j (the
      // warp-min entry of the lanes that enter it before their best t)
      const int m0 = c * kGroup;
      unsigned long long mk = kNoKey;
      for (int j = 0; j < kGroup && m0 + j < n_clusters; ++j) {
        const float em = ort_row_entry(
            cl_boxes + 8 * static_cast<size_t>(m0 + j), ox, oy, oz, ix, iy,
            iz, tmin);
        const unsigned m = __reduce_min_sync(kFull,
                                             em < bt ? ort_ordered(em) : kNone);
        if (lane == j && m != kNone)
          mk = (static_cast<unsigned long long>(m) << 32) |
               (kMember | static_cast<unsigned>(m0 + j));
      }
      const unsigned have = __ballot_sync(kFull, mk != kNoKey);
      // the members join the list in key order (each is above this key: a
      // member's entry is >= its supercluster's), if they fit below cap
      if (n + __popc(have) <= kWarpKeys && !__any_sync(kFull, mk != kNoKey &&
                                                             mk >= cap)) {
        insert_keys(ws.keys, lane, k, n, mk);
        n += __popc(have);
        continue;
      }
      for (unsigned b = have; b; b &= b - 1) {   // no room: visit them now
        const int m = m0 + __ffs(b) - 1;
        const float em = ort_row_entry(cl_boxes + 8 * static_cast<size_t>(m),
                                       ox, oy, oz, ix, iy, iz, tmin);
        if (!__any_sync(kFull, em < bt)) continue;
        tested += visit_row<ANY_HIT, false>(
            ws, lane, m, sub_boxes, n_subs, woop_t, nullptr, nullptr,
            nullptr, ox, oy, oz, ix, iy, iz, dx, dy, dz, tmin, bt, slot);
      }
    }
    // another round only if keys were dropped, the list ran out, and a
    // lane could still enter a dropped row (every one enters at >= cap)
    more = k == n && cap != kNoKey && __any_sync(kFull, key_entry(cap) < bt);
    lo = cap;
    __syncwarp();   // the next round overwrites ws.keys
  }
  out_t[ray] = bt;
  out_slot[ray] = slot;
  if (lane == 0) out_visits[ray >> 5] = tested;
}

// One warp of packed live rays (lane ray < 0: no ray) over the staged
// superclusters; writes each ray's first cluster and adds the warp's box
// tests (rows tested x 32 lanes) to out_tests.
__device__ __forceinline__ void probe_warp(
    const float* __restrict__ rays, int n_rays,
    const float* __restrict__ boxes, int n_clusters, const float* sup,
    int n_sup_pad, int c_pad, int ray, int lane, int* __restrict__ out,
    unsigned long long* __restrict__ out_tests) {
  // a lane without a ray probes as a dead ray at the origin: no box test
  // can bring its entry (>= t_min = 0) below its t_max = 0
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f,
        tmin = 0.0f, tmax = 0.0f;
  if (ray >= 0) {
    ox = rays[0 * n_rays + ray]; oy = rays[1 * n_rays + ray];
    oz = rays[2 * n_rays + ray]; dx = rays[3 * n_rays + ray];
    dy = rays[4 * n_rays + ray]; dz = rays[5 * n_rays + ray];
    tmin = rays[6 * n_rays + ray]; tmax = rays[7 * n_rays + ray];
  }
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy), iz = ort_inv_dir(dz);
  float emin = ORT_INF;
  int first = c_pad;
  unsigned rows = 0;
  const bool finite = isfinite(ox) && isfinite(oy) && isfinite(oz) &&
                      isfinite(dx) && isfinite(dy) && isfinite(dz);
  if (__any_sync(kFull, !finite)) {
    // an infinite origin or direction can make inf - inf or inf * 0 inside
    // a slab test: this warp tests every box, NaN flag on, no pre-cull
    for (int c = 0; c < n_clusters; ++c) {
      const float e = ort_row_entry(boxes + 8 * static_cast<size_t>(c), ox,
                                    oy, oz, ix, iy, iz, tmin);
      if (e < tmax && e < emin) { emin = e; first = c; }
    }
    rows = n_clusters;
  } else {
    for (int s0 = 0; s0 < n_sup_pad; s0 += kSupBatch) {
      float eu[kSupBatch];
      unsigned bits[kSupBatch];
      bool need = false;
#pragma unroll
      for (int j = 0; j < kSupBatch; ++j) {
        const float4* q = reinterpret_cast<const float4*>(sup + 8 * (s0 + j));
        const float4 a = q[0], b = q[1];
        bits[j] = __float_as_uint(b.z);
        eu[j] = ort_slab_entry6<false>(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy,
                                       oz, ix, iy, iz, tmin);
        rows += bits[j] != 0u;
        need |= bits[j] != 0u && eu[j] < emin && eu[j] < tmax;
      }
      if (!__any_sync(kFull, need)) continue;
      for (int j = 0; j < kSupBatch; ++j) {
        // emin may have fallen since: re-vote on the current one
        if (!bits[j] || !__any_sync(kFull, eu[j] < emin && eu[j] < tmax))
          continue;
        const int c0 = (s0 + j) * kGroup;
        for (unsigned m = bits[j]; m; m &= m - 1) {
          const int c = c0 + __ffs(m) - 1;
          const float e = ort_row_entry<false>(
              boxes + 8 * static_cast<size_t>(c), ox, oy, oz, ix, iy, iz,
              tmin);
          ++rows;
          if (e < tmax && e < emin) { emin = e; first = c; }
        }
      }
    }
  }
  if (ray >= 0) out[ray] = first;
  if (lane == 0) atomicAdd(out_tests, 32ull * rows);
}

// Persistent CTAs of kProbeThreads: stage the superclusters once, then
// walk 256-ray tiles, packing each tile's live rays onto its leading warps.
__global__ void __launch_bounds__(kProbeThreads, 4) probe_kernel(
    const float* __restrict__ rays, int n_rays,
    const float* __restrict__ boxes, int n_clusters, int c_pad,
    int* __restrict__ out, unsigned long long* __restrict__ out_tests) {
  // superclusters, rows [min3, max3, member bits, 0]: the union of the
  // members whose bit k is set, cluster 8 s + k being real and free of NaN
  // (a box with a NaN never fires); no bit set: an empty box, never tested
  __shared__ __align__(16) float sup[kMaxSup * 8];
  __shared__ int live_rays[kProbeThreads];
  __shared__ int warp_live[kProbeWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_sup = (n_clusters + kGroup - 1) / kGroup;
  const int n_sup_pad = (n_sup + kSupBatch - 1) / kSupBatch * kSupBatch;
  for (int s = tid; s < n_sup_pad; s += kProbeThreads) {
    float lx = INFINITY, ly = INFINITY, lz = INFINITY;
    float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY;
    unsigned bits = 0;
    for (int k = 0; k < kGroup && s * kGroup + k < n_clusters; ++k) {
      const float4* row = reinterpret_cast<const float4*>(
          boxes + 8 * static_cast<size_t>(s * kGroup + k));
      const float4 p = __ldg(row), q = __ldg(row + 1);
      if (isnan(p.x) || isnan(p.y) || isnan(p.z) || isnan(p.w) ||
          isnan(q.x) || isnan(q.y))
        continue;
      bits |= 1u << k;
      lx = fminf(lx, p.x); ly = fminf(ly, p.y); lz = fminf(lz, p.z);
      hx = fmaxf(hx, p.w); hy = fmaxf(hy, q.x); hz = fmaxf(hz, q.y);
    }
    float4* dst = reinterpret_cast<float4*>(sup + 8 * s);
    dst[0] = make_float4(lx, ly, lz, hx);
    dst[1] = make_float4(hy, hz, __uint_as_float(bits), 0.0f);
  }
  __syncthreads();
  const int n_tiles = (n_rays + kProbeThreads - 1) / kProbeThreads;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray = tile * kProbeThreads + tid;
    bool live = false;
    if (ray < n_rays) {
      // every entry is >= t_min: t_max <= t_min (or a NaN bound) enters
      // nothing, and a NaN in the origin makes every entry NaN
      const float tmin = rays[6 * n_rays + ray], tmax = rays[7 * n_rays + ray];
      live = tmin < tmax && !isnan(rays[0 * n_rays + ray]) &&
             !isnan(rays[1 * n_rays + ray]) && !isnan(rays[2 * n_rays + ray]);
      if (!live) out[ray] = c_pad;
    }
    const unsigned ballot = __ballot_sync(kFull, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, n_live = 0;
    for (int w = 0; w < kProbeWarps; ++w) {
      const int n = warp_live[w];
      base += w < warp ? n : 0;
      n_live += n;
    }
    if (live) live_rays[base + __popc(ballot & ((1u << lane) - 1u))] = ray;
    __syncthreads();
    if (warp * 32 < n_live)   // warp-uniform: whole warps of live rays
      probe_warp(rays, n_rays, boxes, n_clusters, sup, n_sup_pad, c_pad,
                 tid < n_live ? live_rays[tid] : -1, lane, out, out_tests);
    __syncthreads();   // the next tile overwrites live_rays and warp_live
  }
}

// ---- Past MAX_CLUSTERS: the deep march (F2) and the deep probe (C2) ------
//
// C stages at most 8,192 / 8 superclusters, and B and F cull every cull
// row per lane and round: at the 26k clusters of a 32,000-particle chute B
// would slab-test 26k rows a lane and F 3.3k.  Past MAX_CLUSTERS both take
// one more cull level: hyperclusters, the NaN-aware unions of 8
// consecutive superclusters (64 clusters), which the host forms with the
// superclusters (block_march.supercluster_boxes, twice).  A hypercluster's
// entry is <= each member's under monotone rounding, so every argument
// that keeps F and C exact holds one level up.
//
// F2 is F with three levels of keys in one sorted list: the cull rows are
// hyperclusters; a visited hypercluster merges its entered superclusters'
// keys into the list, a visited supercluster its entered clusters' keys,
// nearest first across every level (key bits 31-30: 0 hypercluster, 1
// supercluster, 2 cluster; members that do not fit below the cap are
// opened at once, a supercluster's clusters visited at once).
//
// C2 is C with the hyperclusters staged in shared memory (32 B each, a
// NaN-free flag in the padding: 32 KB for MAX_DEEP_CLUSTERS) and the
// superclusters and clusters read from the tables by 16-byte broadcasts
// with the NaN test (a pure-padding row is NaN and never fires), in
// ascending id order at every level, so the lowest id still wins a tie.

constexpr unsigned kSupKey = 0x40000000u;   // F2: the key's row: supercluster
constexpr unsigned kLevelMask = 0xc0000000u;
constexpr int kMaxHyper = 65536 / (kGroup * kGroup);   // MAX_DEEP_CLUSTERS/64

// Lane j's key for member m0 + j (< n_mem) of a visited row: the warp-min
// entry of the lanes that enter it before their best t, tagged; kNoKey
// where no lane does (or j >= kGroup).
__device__ __forceinline__ unsigned long long member_key(
    int lane, const float* __restrict__ mem_boxes, int m0, int n_mem,
    unsigned tag, float ox, float oy, float oz, float ix, float iy, float iz,
    float tmin, float bt) {
  unsigned long long mk = kNoKey;
  for (int j = 0; j < kGroup && m0 + j < n_mem; ++j) {
    const float em = ort_row_entry(mem_boxes + 8 * static_cast<size_t>(m0 + j),
                                   ox, oy, oz, ix, iy, iz, tmin);
    const unsigned m = __reduce_min_sync(kFull,
                                         em < bt ? ort_ordered(em) : kNone);
    if (lane == j && m != kNone)
      mk = (static_cast<unsigned long long>(m) << 32) |
           (tag | static_cast<unsigned>(m0 + j));
  }
  return mk;
}

// Merge each lane's member key mk into the sorted list after position k
// if all of them fit below cap; false (list untouched) if they do not.
__device__ __forceinline__ bool place_keys(WarpScratch& ws, int lane, int k,
                                           int& n, unsigned long long cap,
                                           unsigned long long mk) {
  const int add = __popc(__ballot_sync(kFull, mk != kNoKey));
  if (n + add > kWarpKeys || __any_sync(kFull, mk != kNoKey && mk >= cap))
    return false;
  insert_keys(ws.keys, lane, k, n, mk);
  n += add;
  return true;
}

// Open supercluster s: its entered clusters join the list, or where they
// do not fit are visited now; returns the Woop rows tested.
template <bool ANY_HIT>
__device__ __forceinline__ int open_sup(
    WarpScratch& ws, int lane, int s, int k, int& n, unsigned long long cap,
    const float* __restrict__ cl_boxes, int n_clusters,
    const float* __restrict__ sub_boxes, int n_subs,
    const float* __restrict__ woop_t, float ox, float oy, float oz, float ix,
    float iy, float iz, float dx, float dy, float dz, float tmin, float& bt,
    int& slot) {
  const int m0 = s * kGroup;
  const unsigned long long mk = member_key(lane, cl_boxes, m0, n_clusters,
                                           kMember, ox, oy, oz, ix, iy, iz,
                                           tmin, bt);
  if (place_keys(ws, lane, k, n, cap, mk)) return 0;
  int tested = 0;
  for (unsigned b = __ballot_sync(kFull, mk != kNoKey); b; b &= b - 1) {
    const int m = m0 + __ffs(b) - 1;
    const float em = ort_row_entry(cl_boxes + 8 * static_cast<size_t>(m), ox,
                                   oy, oz, ix, iy, iz, tmin);
    if (!__any_sync(kFull, em < bt)) continue;
    tested += visit_row<ANY_HIT, false>(
        ws, lane, m, sub_boxes, n_subs, woop_t, nullptr, nullptr, nullptr, ox,
        oy, oz, ix, iy, iz, dx, dy, dz, tmin, bt, slot);
  }
  return tested;
}

// F2: the cull rows are hyperclusters (hy_boxes, n_hyper), their members
// superclusters (sup_boxes, n_sup), theirs clusters (cl_boxes,
// n_clusters); sub_boxes and woop_t per cluster; outputs as F's.
template <bool ANY_HIT>
__global__ void __launch_bounds__(32 * kCtaWarps, 7) deep_warp_march_kernel(
    const float* __restrict__ rays, int n_rays,
    const float* __restrict__ hy_boxes, int n_hyper,
    const float* __restrict__ sup_boxes, int n_sup,
    const float* __restrict__ cl_boxes, int n_clusters,
    const float* __restrict__ sub_boxes, int n_subs,
    const float* __restrict__ woop_t, float* __restrict__ out_t,
    int* __restrict__ out_slot, int* __restrict__ out_visits) {
  extern __shared__ __align__(16) unsigned char smem[];
  WarpScratch& ws = reinterpret_cast<WarpScratch*>(smem)[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const float ox = rays[0 * n_rays + ray], oy = rays[1 * n_rays + ray],
              oz = rays[2 * n_rays + ray];
  const float dx = rays[3 * n_rays + ray], dy = rays[4 * n_rays + ray],
              dz = rays[5 * n_rays + ray];
  const float tmin = rays[6 * n_rays + ray];
  float bt = rays[7 * n_rays + ray];
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy), iz = ort_inv_dir(dz);
  int slot = -1;
  int tested = 0;

  unsigned long long lo = 0;
  bool more = __any_sync(kFull, tmin < bt);
  while (more) {
    unsigned long long cap;
    int n = cull_round(ws, lane, hy_boxes, n_hyper, ox, oy, oz, ix, iy, iz,
                       tmin, bt, lo, cap);
    int k = 0;
    for (; k < n; ++k) {
      const unsigned long long key = ws.keys[k];
      if (!__any_sync(kFull, key_entry(key) < bt)) break;
      const unsigned id = static_cast<unsigned>(key);
      const unsigned level = id & kLevelMask;
      const int c = static_cast<int>(id & ~kLevelMask);
      const float* row = level == kMember ? cl_boxes
                         : level == kSupKey ? sup_boxes : hy_boxes;
      const float e = ort_row_entry(row + 8 * static_cast<size_t>(c), ox, oy,
                                    oz, ix, iy, iz, tmin);
      if (!__any_sync(kFull, e < bt)) continue;
      if (level == kMember) {
        tested += visit_row<ANY_HIT, false>(
            ws, lane, c, sub_boxes, n_subs, woop_t, nullptr, nullptr, nullptr,
            ox, oy, oz, ix, iy, iz, dx, dy, dz, tmin, bt, slot);
      } else if (level == kSupKey) {
        tested += open_sup<ANY_HIT>(ws, lane, c, k, n, cap, cl_boxes,
                                    n_clusters, sub_boxes, n_subs, woop_t, ox,
                                    oy, oz, ix, iy, iz, dx, dy, dz, tmin, bt,
                                    slot);
      } else {
        const int s0 = c * kGroup;
        const unsigned long long mk = member_key(
            lane, sup_boxes, s0, n_sup, kSupKey, ox, oy, oz, ix, iy, iz, tmin,
            bt);
        if (place_keys(ws, lane, k, n, cap, mk)) continue;
        // no room: open its superclusters now, in id order
        for (unsigned b = __ballot_sync(kFull, mk != kNoKey); b; b &= b - 1) {
          const int s = s0 + __ffs(b) - 1;
          const float es = ort_row_entry(
              sup_boxes + 8 * static_cast<size_t>(s), ox, oy, oz, ix, iy, iz,
              tmin);
          if (!__any_sync(kFull, es < bt)) continue;
          tested += open_sup<ANY_HIT>(ws, lane, s, k, n, cap, cl_boxes,
                                      n_clusters, sub_boxes, n_subs, woop_t,
                                      ox, oy, oz, ix, iy, iz, dx, dy, dz,
                                      tmin, bt, slot);
        }
      }
    }
    more = k == n && cap != kNoKey && __any_sync(kFull, key_entry(cap) < bt);
    lo = cap;
    __syncwarp();
  }
  out_t[ray] = bt;
  out_slot[ray] = slot;
  if (lane == 0) out_visits[ray >> 5] = tested;
}

// One warp of packed live rays over the staged hyperclusters (C2).
__device__ __forceinline__ void deep_probe_warp(
    const float* __restrict__ rays, int n_rays,
    const float* __restrict__ boxes, int n_clusters,
    const float* __restrict__ sup_boxes, int n_sup, const float* hyper,
    int n_hyper_pad, int c_pad, int ray, int lane, int* __restrict__ out,
    unsigned long long* __restrict__ out_tests) {
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f,
        tmin = 0.0f, tmax = 0.0f;
  if (ray >= 0) {
    ox = rays[0 * n_rays + ray]; oy = rays[1 * n_rays + ray];
    oz = rays[2 * n_rays + ray]; dx = rays[3 * n_rays + ray];
    dy = rays[4 * n_rays + ray]; dz = rays[5 * n_rays + ray];
    tmin = rays[6 * n_rays + ray]; tmax = rays[7 * n_rays + ray];
  }
  const float ix = ort_inv_dir(dx), iy = ort_inv_dir(dy), iz = ort_inv_dir(dz);
  float emin = ORT_INF;
  int first = c_pad;
  unsigned rows = 0;
  const bool finite = isfinite(ox) && isfinite(oy) && isfinite(oz) &&
                      isfinite(dx) && isfinite(dy) && isfinite(dz);
  if (__any_sync(kFull, !finite)) {
    for (int c = 0; c < n_clusters; ++c) {
      const float e = ort_row_entry(boxes + 8 * static_cast<size_t>(c), ox,
                                    oy, oz, ix, iy, iz, tmin);
      if (e < tmax && e < emin) { emin = e; first = c; }
    }
    rows = n_clusters;
  } else {
    for (int h0 = 0; h0 < n_hyper_pad; h0 += kSupBatch) {
      float eu[kSupBatch];
      bool real[kSupBatch];
      bool need = false;
#pragma unroll
      for (int j = 0; j < kSupBatch; ++j) {
        const float4* q =
            reinterpret_cast<const float4*>(hyper + 8 * (h0 + j));
        const float4 a = q[0], b = q[1];
        real[j] = b.z != 0.0f;
        eu[j] = ort_slab_entry6<false>(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy,
                                       oz, ix, iy, iz, tmin);
        rows += real[j];
        need |= real[j] && eu[j] < emin && eu[j] < tmax;
      }
      if (!__any_sync(kFull, need)) continue;
      for (int j = 0; j < kSupBatch; ++j) {
        if (!real[j] || !__any_sync(kFull, eu[j] < emin && eu[j] < tmax))
          continue;
        const int s0 = (h0 + j) * kGroup;
        for (int s = s0; s < s0 + kGroup && s < n_sup; ++s) {
          const float es = ort_row_entry(
              sup_boxes + 8 * static_cast<size_t>(s), ox, oy, oz, ix, iy, iz,
              tmin);
          ++rows;
          if (!__any_sync(kFull, es < emin && es < tmax)) continue;
          const int c0 = s * kGroup;
          for (int c = c0; c < c0 + kGroup && c < n_clusters; ++c) {
            const float e = ort_row_entry(boxes + 8 * static_cast<size_t>(c),
                                          ox, oy, oz, ix, iy, iz, tmin);
            ++rows;
            if (e < tmax && e < emin) { emin = e; first = c; }
          }
        }
      }
    }
  }
  if (ray >= 0) out[ray] = first;
  if (lane == 0) atomicAdd(out_tests, 32ull * rows);
}

// C2's persistent CTAs: stage the hyperclusters once (rows [min3, max3,
// 1 if NaN-free else 0, 0]), then walk 256-ray tiles as C does.
__global__ void __launch_bounds__(kProbeThreads, 4) deep_probe_kernel(
    const float* __restrict__ rays, int n_rays,
    const float* __restrict__ boxes, int n_clusters,
    const float* __restrict__ sup_boxes, int n_sup,
    const float* __restrict__ hy_boxes, int n_hyper, int c_pad,
    int* __restrict__ out, unsigned long long* __restrict__ out_tests) {
  __shared__ __align__(16) float hyper[kMaxHyper * 8];
  __shared__ int live_rays[kProbeThreads];
  __shared__ int warp_live[kProbeWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_hyper_pad = (n_hyper + kSupBatch - 1) / kSupBatch * kSupBatch;
  for (int h = tid; h < n_hyper_pad; h += kProbeThreads) {
    float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f), q = p;
    if (h < n_hyper) {
      const float4* row = reinterpret_cast<const float4*>(
          hy_boxes + 8 * static_cast<size_t>(h));
      p = __ldg(row);
      q = __ldg(row + 1);
    }
    const bool real = h < n_hyper && !(isnan(p.x) || isnan(p.y) ||
                                       isnan(p.z) || isnan(p.w) ||
                                       isnan(q.x) || isnan(q.y));
    float4* dst = reinterpret_cast<float4*>(hyper + 8 * h);
    dst[0] = real ? p : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[1] = make_float4(real ? q.x : 0.0f, real ? q.y : 0.0f,
                         real ? 1.0f : 0.0f, 0.0f);
  }
  __syncthreads();
  const int n_tiles = (n_rays + kProbeThreads - 1) / kProbeThreads;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray = tile * kProbeThreads + tid;
    bool live = false;
    if (ray < n_rays) {
      const float tmin = rays[6 * n_rays + ray], tmax = rays[7 * n_rays + ray];
      live = tmin < tmax && !isnan(rays[0 * n_rays + ray]) &&
             !isnan(rays[1 * n_rays + ray]) && !isnan(rays[2 * n_rays + ray]);
      if (!live) out[ray] = c_pad;
    }
    const unsigned ballot = __ballot_sync(kFull, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, n_live = 0;
    for (int w = 0; w < kProbeWarps; ++w) {
      const int n = warp_live[w];
      base += w < warp ? n : 0;
      n_live += n;
    }
    if (live) live_rays[base + __popc(ballot & ((1u << lane) - 1u))] = ray;
    __syncthreads();
    if (warp * 32 < n_live)
      deep_probe_warp(rays, n_rays, boxes, n_clusters, sup_boxes, n_sup,
                      hyper, n_hyper_pad, c_pad,
                      tid < n_live ? live_rays[tid] : -1, lane, out,
                      out_tests);
    __syncthreads();
  }
}

enum MarchKind { kFlat = 0, kInstanced = 1, kHier = 2 };   // B, E, F

template <bool A>
const void* march_fn(int kind) {
  switch (kind) {
    case kInstanced:
      return reinterpret_cast<const void*>(warp_march_kernel<A, true, false>);
    case kHier:
      return reinterpret_cast<const void*>(warp_march_kernel<A, false, true>);
    default:
      return reinterpret_cast<const void*>(warp_march_kernel<A, false, false>);
  }
}

// 4-warp CTAs (n_rays % 128 == 0).
template <bool A, bool I, bool H>
int launch_march(cudaStream_t s, const float* rays, int n_rays,
                 const float* boxes, int n_rows, const float* cl_boxes,
                 int n_clusters, const float* sub_boxes, int n_subs,
                 const float* woop_t, const int* pair_shape,
                 const int* pair_inst, const float* inst_rows, float* out_t,
                 int* out_slot, int* out_visits) {
  const int threads = 32 * kCtaWarps;
  const size_t smem = kCtaWarps * sizeof(WarpScratch);
  warp_march_kernel<A, I, H><<<n_rays / threads, threads, smem, s>>>(
      rays, n_rays, boxes, n_rows, cl_boxes, n_clusters, sub_boxes, n_subs,
      woop_t, pair_shape, pair_inst, inst_rows, out_t, out_slot, out_visits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rays: (8, n_rays) rows [o, d, t_min, t_max], n_rays % block_rays == 0,
// block_rays % 128 == 0 (the callers' padding; the kernel marches each
// warp on its own in 4-warp CTAs); boxes: (>= n_clusters, 8) rows [min3, max3, 0, 0];
// sub_boxes: (>= n_clusters, n_subs, 8); woop_t: (C, 16, 256).
// Outputs: out_t, out_slot (n_rays,), out_visits (n_rays / 32,): each
// warp's Woop-tested rows.  Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int ort_block_march(const float* rays, int n_rays,
                               const float* boxes, int n_clusters,
                               const float* sub_boxes, int n_subs,
                               const float* woop_t, int any_hit,
                               int block_rays, float* out_t, int* out_slot,
                               int* out_visits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = any_hit ? &launch_march<true, false, false>
                        : &launch_march<false, false, false>;
  return launch(s, rays, n_rays, boxes, n_clusters, nullptr, 0, sub_boxes,
                n_subs, woop_t, nullptr, nullptr, nullptr, out_t, out_slot,
                out_visits);
}

// The TLAS march: boxes / sub_boxes are (>= n_pairs, 8) / (>= n_pairs,
// n_subs, 8) WORLD pair boxes; pair_shape, pair_inst: (n_pairs,) library
// cluster and instance of each pair; inst_rows: (P, 128) rows [A(9), b(3),
// 0...] of the world->object affine; woop_t: (SC, 16, 256) library rows.
// Slots are pair * 256 + row; out_visits as ort_block_march.
extern "C" int ort_block_march_instanced(
    const float* rays, int n_rays, const float* boxes, int n_pairs,
    const float* sub_boxes, int n_subs, const int* pair_shape,
    const int* pair_inst, const float* inst_rows, const float* woop_t,
    int any_hit, int block_rays, float* out_t, int* out_slot,
    int* out_visits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = any_hit ? &launch_march<true, true, false>
                        : &launch_march<false, true, false>;
  return launch(s, rays, n_rays, boxes, n_pairs, nullptr, 0, sub_boxes,
                n_subs, woop_t, pair_shape, pair_inst, inst_rows, out_t,
                out_slot, out_visits);
}

// The hierarchical march: sup_boxes (>= n_sup, 8) union boxes of clusters
// [8 s, 8 s + 8) are the cull rows; the rest as ort_block_march (out_visits
// per warp).
extern "C" int ort_block_march_hier(
    const float* rays, int n_rays, const float* sup_boxes, int n_sup,
    const float* boxes, int n_clusters, const float* sub_boxes, int n_subs,
    const float* woop_t, int any_hit, int block_rays, float* out_t,
    int* out_slot, int* out_visits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = any_hit ? &launch_march<true, false, true>
                        : &launch_march<false, false, true>;
  return launch(s, rays, n_rays, sup_boxes, n_sup, boxes, n_clusters,
                sub_boxes, n_subs, woop_t, nullptr, nullptr, nullptr, out_t,
                out_slot, out_visits);
}

// Resident warps per SM of the B (kind 0), E (1) or F (2) kernel at its
// 4-warp launch, by cudaOccupancyMaxActiveBlocksPerMultiprocessor on the
// current device.  Returns the CUDA error code.
extern "C" int ort_march_occupancy(int kind, int any_hit, int* warps_per_sm) {
  int blocks = 0;
  const int err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, any_hit ? march_fn<true>(kind) : march_fn<false>(kind),
      32 * kCtaWarps, kCtaWarps * sizeof(WarpScratch)));
  *warps_per_sm = blocks * kCtaWarps;
  return err;
}

// rays: (8, n_rays); boxes: (>= n_clusters, 8) rows [min3, max3, 0, 0]
// (min <= max, or NaN).  out: (n_rays,) the id of the nearest cluster entered before t_max (lowest id
// on ties), else c_pad; out_tests (1,) += the box tests run (rows x 32
// lanes per warp).  Returns the CUDA error code (0 = launched).
extern "C" int ort_probe_first_cluster(const float* rays, int n_rays,
                                       const float* boxes, int n_clusters,
                                       int c_pad, int* out,
                                       unsigned long long* out_tests,
                                       void* stream) {
  int dev = 0, sms = 0, blocks = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, probe_kernel, kProbeThreads, 0));
  if (err) return err;
  const int n_tiles = (n_rays + kProbeThreads - 1) / kProbeThreads;
  probe_kernel<<<max(1, min(n_tiles, blocks * sms)), kProbeThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      rays, n_rays, boxes, n_clusters, c_pad, out, out_tests);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps per SM of the probe (C), whatever the cluster count (its
// shared memory is fixed), by cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int ort_probe_occupancy(int* warps_per_sm) {
  int blocks = 0;
  const int err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, probe_kernel, kProbeThreads, 0));
  *warps_per_sm = blocks * kProbeWarps;
  return err;
}

// F2, the deep march past MAX_CLUSTERS: hy_boxes (>= n_hyper, 8) unions of
// superclusters [8 h, 8 h + 8), sup_boxes (>= n_sup, 8) unions of clusters
// [8 s, 8 s + 8), boxes (>= n_clusters, 8); the rest as ort_block_march
// (4-warp CTAs, n_rays % 128 == 0; out_visits per warp).
extern "C" int ort_block_march_deep(
    const float* rays, int n_rays, const float* hy_boxes, int n_hyper,
    const float* sup_boxes, int n_sup, const float* boxes, int n_clusters,
    const float* sub_boxes, int n_subs, const float* woop_t, int any_hit,
    float* out_t, int* out_slot, int* out_visits, void* stream) {
  const int threads = 32 * kCtaWarps;
  const size_t smem = kCtaWarps * sizeof(WarpScratch);
  auto kernel = any_hit ? deep_warp_march_kernel<true>
                        : deep_warp_march_kernel<false>;
  kernel<<<n_rays / threads, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      rays, n_rays, hy_boxes, n_hyper, sup_boxes, n_sup, boxes, n_clusters,
      sub_boxes, n_subs, woop_t, out_t, out_slot, out_visits);
  return static_cast<int>(cudaGetLastError());
}

// C2, the deep probe past MAX_CLUSTERS: as ort_probe_first_cluster, with
// the supercluster and hypercluster tables of ort_block_march_deep
// (n_hyper <= 65,536 / 64).
extern "C" int ort_probe_deep(const float* rays, int n_rays,
                              const float* boxes, int n_clusters,
                              const float* sup_boxes, int n_sup,
                              const float* hy_boxes, int n_hyper, int c_pad,
                              int* out, unsigned long long* out_tests,
                              void* stream) {
  if (n_hyper > kMaxHyper) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, blocks = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err) err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, deep_probe_kernel, kProbeThreads, 0));
  if (err) return err;
  const int n_tiles = (n_rays + kProbeThreads - 1) / kProbeThreads;
  deep_probe_kernel<<<max(1, min(n_tiles, blocks * sms)), kProbeThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rays, n_rays, boxes, n_clusters, sup_boxes, n_sup, hy_boxes, n_hyper,
      c_pad, out, out_tests);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps per SM of F2 (kind 0) or C2 (kind 1) on the current
// device, by cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int ort_deep_occupancy(int kind, int any_hit, int* warps_per_sm) {
  int blocks = 0;
  int err;
  if (kind == 1) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, deep_probe_kernel, kProbeThreads, 0));
    *warps_per_sm = blocks * kProbeWarps;
    return err;
  }
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, any_hit ? deep_warp_march_kernel<true>
                       : deep_warp_march_kernel<false>,
      32 * kCtaWarps, kCtaWarps * sizeof(WarpScratch)));
  *warps_per_sm = blocks * kCtaWarps;
  return err;
}
