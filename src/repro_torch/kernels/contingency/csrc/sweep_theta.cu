// Multi-candidate sweep contingency -> Θ kernel for Hopper (sm_90a), on
// class-ordered granule segments: the hot loop of the greedy reduction (plan
// backend "sweep").
//
// Replaces the TPU kernel `sweep_theta_pallas` / `_sweep_kernel` of
// src/repro/kernels/contingency/sweep.py (wrapper ops.sweep_theta): raw
// Θ'[c] = Σ over 256-bin tiles, in ascending order, of Σ_rows θ'_δ(row) of
// the contingency of keys p = r_ids[g]·V + x_t[c, g] against d_g, weighted
// by w_g.  Granules with w = 0, r outside [0, ceil(n_bins/V)) or d outside
// [0, n_dec) count nothing (padding carries r = -1 or w = 0).  Requires x_t
// in [0, V), as the slab of attribute values always is: a class r then owns
// the keys [r·V, r·V + V) and no other.
//
// What bounds it on this card: one read of the slab x_t [nc, G] int32 and of
// r_ids/d/w [G] — about 4·(nc + 3)·G bytes, ~23 MB at the kdd99 shapes —
// over the memory rate; the flops are a few per granule.
//
// Design.  Tile t holds keys [256t, 256t + 256): the classes ⌊256t/V⌋ …
// ⌊(256t + 255)/V⌋.  Ordering the granules by class once a launch makes each
// tile's granules one contiguous segment of the ordered list (a class that
// straddles two tiles, when V does not divide 256, is read by both), so a
// tile reads only its own granules instead of all G of them.  The order is
// by bucket, not by class: class r goes to bucket 2·⌊rV/256⌋ + s, s = 1 when
// its keys run into the next tile.  Tile t's segment is then the buckets
// 2(t - S) + 1 … 2t + 1, S = ⌈V/256⌉ — for V ≤ 256 exactly the classes that
// touch tile t, as class order gives — and the scan runs over 2·n_tiles
// buckets instead of one entry per class.
//
// 1. count_kernel: granules per bucket (warp-aggregated atomics).
// 2. plan_kernel, one CTA: exclusive scan of the counts; each tile's segment;
//    the work lists: tiles of at most kShortMax granules, and chunks of at
//    most `chunk` granules of the longer tiles; which tiles hold a granule,
//    and the last that does.
// 3. scatter_kernel: each live granule's {g, r, d, w} into its bucket's range
//    (warp-aggregated cursors).  The order inside a bucket follows the
//    atomics and changes from run to run; no result depends on it (below).
// 4.-6. the segment kernels of segments.cuh (short tiles, long tiles, ordered
//    sum), reading the granules of this ordering through SweepSource.
//
// No result depends on the order inside a bucket; segments.cuh says why a
// tile's partial is the same bits on every run and at every ladder rung.
//
// The launch shape is the tiling's (kernels/contingency/autotune.py, kernel
// "sweep"): `bc`, the candidates a segment entry is read for at once (1, 2,
// 4 or 8, and at most nc and what one long CTA's histograms fit in shared
// memory; pinned: 4); `chunk`, the fewest granules of a long tile's chunk
// (pinned: 4,096); `threads`, the CTA of the count and scatter passes, with
// 2,048 / threads CTAs an SM (pinned: 256).  No field changes a bit.
// Built with --fmad=false; no fast math.
#include "segments.cuh"

namespace {

using repro::kTile;

constexpr int kMaxSplit = 64;      // bounds the tiles cut into several chunks

__device__ __forceinline__ bool live(int r, int d, float w, int n_cls, int n_dec) {
  return r >= 0 && r < n_cls && d >= 0 && d < n_dec && w != 0.f;
}

// Bucket of class r: 2·(first tile of its keys) + (1 when they run into the next).
__device__ __forceinline__ int bucket(int r, int V) {
  const int first = r * V / kTile;
  return 2 * first + ((r * V + V - 1) / kTile > first);
}

// Tile t's segment: buckets [max(0, 2(t - S) + 1), 2t + 2) of start[].
__device__ __forceinline__ int2 segment(const int* start, int t, int S) {
  return make_int2(start[max(0, 2 * (t - S) + 1)], start[2 * t + 2]);
}

// An entry of the class ordering is {g, r, d, w bits}; a segment is a tile,
// read by every block of bc candidates, whose keys r·V + x_t[c, g] are
// gathered from the slab.
struct SweepSource {
  using Entry = int4;
  const int* __restrict__ x_t;
  const int4* __restrict__ sorted;
  int G, V;
  __device__ __forceinline__ Entry load(int i) const { return sorted[i]; }
  static __device__ __forceinline__ Entry none() { return make_int4(0, -1, 0, 0); }
  static __device__ __forceinline__ bool valid(const Entry& e) { return e.y >= 0; }
  static __device__ __forceinline__ float weight(const Entry& e) { return __int_as_float(e.w); }
  static __device__ __forceinline__ int dec(const Entry& e) { return e.z; }
  __device__ __forceinline__ int tile(int seg) const { return seg; }
  __device__ __forceinline__ int first_cand(int, int cb, int bc) const { return cb * bc; }
  template <int BC>
  __device__ __forceinline__ void keys(const Entry& e, int c0, int nk, int lo,
                                       int (&p)[BC]) const {
    int x[BC];
#pragma unroll
    for (int k = 0; k < BC; ++k)
      x[k] = k < nk ? x_t[static_cast<size_t>(c0 + k) * G + e.x] : 0;
#pragma unroll
    for (int k = 0; k < BC; ++k) p[k] = e.y * V + x[k] - lo;
  }
};

// ---------------------------------------------------------------- ordering

__global__ void count_kernel(const int* __restrict__ r, const int* __restrict__ d,
                             const float* __restrict__ w, int* __restrict__ cnt,
                             int G, int n_cls, int V, int n_dec) {
  const int lane = threadIdx.x % 32;
  const int threads = gridDim.x * blockDim.x;
  for (int base = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * 32; base < G;
       base += threads) {
    const int g = base + lane;
    const int rg = g < G ? r[g] : -1;
    const bool ok = g < G && live(rg, d[g], w[g], n_cls, n_dec);
    const int key = ok ? bucket(rg, V) : -1;
    // one atomic per distinct bucket in the warp (at K = 1 every granule
    // would hit one address)
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (ok && lane == __ffs(same) - 1) atomicAdd(&cnt[key], __popc(same));
  }
}

// One CTA of kPlanThreads: bucket starts, tile segments, work lists, and a
// flag a tile (1: it holds a granule).  Both passes walk their arrays in
// rounds of consecutive elements, carrying the running totals.
__global__ void __launch_bounds__(repro::kPlanThreads)
plan_kernel(int* __restrict__ start, int* __restrict__ cursor, int n_keys, int n_tiles,
            int S, int chunk, int4* __restrict__ short_items, int4* __restrict__ long_items,
            int* __restrict__ split_chunks, unsigned char* __restrict__ tile_live,
            int* __restrict__ counters) {
  using repro::block_exclusive_scan;
  using repro::kPlanThreads;
  using repro::kShortMax;
  __shared__ int n_live;
  const int tid = threadIdx.x;
  if (tid == 0) n_live = 0;

  // 1. counts -> exclusive starts, in place; start[n_keys] = live granules
  int carry = 0;
  for (int base = 0; base < n_keys; base += 4 * kPlanThreads) {
    const int k = base + 4 * tid;
    int c[4], sum = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[e] = k + e < n_keys ? start[k + e] : 0;
      sum += c[e];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, &total);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + e < n_keys) {
        start[k + e] = run;
        cursor[k + e] = run;
      }
      run += c[e];
    }
    carry += total;
  }
  if (tid == 0) start[n_keys] = carry;
  __syncthreads();  // the block's writes to start[] are visible below

  // 2. four consecutive tiles a thread a round: classify, scan, write the
  //    lists in tile order
  constexpr int kPer = 4;
  int o_short = 0, o_long = 0, o_split = 0;
  for (int base = 0; base < n_tiles; base += kPer * kPlanThreads) {
    int2 seg[kPer];
    int n_short = 0, n_long = 0, n_split = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = base + kPer * tid + e;
      seg[e] = t < n_tiles ? segment(start, t, S) : make_int2(0, 0);
      const int len = seg[e].y - seg[e].x;
      if (t < n_tiles) tile_live[t] = len > 0;
      if (len > 0) atomicMax(&n_live, t + 1);
      const int nch = len > kShortMax ? (len + chunk - 1) / chunk : 0;
      n_short += len > 0 && len <= kShortMax;
      n_long += nch;
      n_split += nch > 1;
    }
    int t_short, t_long, t_split;
    int i_short = o_short + block_exclusive_scan(n_short, &t_short);
    int i_long = o_long + block_exclusive_scan(n_long, &t_long);
    int i_split = o_split + block_exclusive_scan(n_split, &t_split);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = base + kPer * tid + e;
      const int len = seg[e].y - seg[e].x;
      if (len > 0 && len <= kShortMax) short_items[i_short++] = make_int4(t, seg[e].x, seg[e].y, -1);
      if (len <= kShortMax) continue;
      const int nch = (len + chunk - 1) / chunk;
      const int slot = nch > 1 ? i_split++ : -1;
      if (slot >= 0) split_chunks[slot] = nch;
      for (int j = 0; j < nch; ++j)
        long_items[i_long++] = make_int4(t, seg[e].x + j * chunk,
                                         min(seg[e].x + (j + 1) * chunk, seg[e].y), slot);
    }
    o_short += t_short;
    o_long += t_long;
    o_split += t_split;
  }
  __syncthreads();
  if (tid == 0) {
    counters[repro::kNShort] = o_short;
    counters[repro::kNLong] = o_long;
    counters[repro::kNSplit] = o_split;
    counters[repro::kNLive] = n_live;
  }
}

// Each live granule into its bucket's range as {g, r, d, w bits}; then zero
// the split tiles' buffers and ticket counters that this launch will use.
__global__ void scatter_kernel(const int* __restrict__ r, const int* __restrict__ d,
                               const float* __restrict__ w, int* __restrict__ cursor,
                               int4* __restrict__ sorted, int G, int n_cls, int V, int n_dec,
                               const int* __restrict__ counters, float4* __restrict__ gbuf,
                               size_t slot_words4, int* __restrict__ done, int n_cb) {
  const int lane = threadIdx.x % 32;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * blockDim.x;
  for (int base = tid / 32 * 32; base < G; base += threads) {
    const int g = base + lane;
    const int rg = g < G ? r[g] : -1;
    const int dg = g < G ? d[g] : -1;
    const float wg = g < G ? w[g] : 0.f;
    const bool ok = live(rg, dg, wg, n_cls, n_dec);
    const int key = ok ? bucket(rg, V) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    const int leader = __ffs(same) - 1;
    int pos = 0;
    if (ok && lane == leader) pos = atomicAdd(&cursor[key], __popc(same));
    pos = __shfl_sync(0xffffffffu, pos, leader);
    if (ok) sorted[pos + __popc(same & ((1u << lane) - 1u))] =
        make_int4(g, rg, dg, __float_as_int(wg));
  }
  const int n_split = counters[repro::kNSplit];
  const size_t words4 = static_cast<size_t>(n_split) * slot_words4;
  for (size_t i = tid; i < words4; i += threads) gbuf[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < n_split * n_cb; i += threads) done[i] = 0;
}

// ------------------------------------------------------------------ launch

struct Plan {
  int n_cls, n_tiles, n_keys, S, chunk, split_cap, long_cap, bc, n_cb;
  size_t off_counters, off_start, off_cursor, off_sorted, off_short, off_long, off_split,
      off_done, off_live, off_gbuf, off_partial, bytes;
};

// p.bc = 0: one [256, n_dec] histogram does not fit, bc is not an instance,
// or chunk is below 256 granules.
Plan make_plan(int nc, int G, int V, int n_bins, int n_dec, int bc, int chunk, int smem_limit) {
  Plan p{};
  if ((bc != 1 && bc != 2 && bc != 4 && bc != 8) || chunk < kTile) return p;
  p.n_cls = (n_bins + V - 1) / V;
  p.n_tiles = (n_bins + kTile - 1) / kTile;
  p.n_keys = 2 * p.n_tiles;
  p.S = (V + kTile - 1) / kTile;
  // a granule is read by at most S + 1 tiles, so the segments hold at most
  // (S + 1)·G granules in all; the chunk keeps the split tiles below kMaxSplit
  const long long reads = static_cast<long long>(p.S + 1) * G;
  const long long want = (reads + kMaxSplit - 1) / kMaxSplit;
  p.chunk = static_cast<int>(std::max<long long>(chunk, (want + kTile - 1) / kTile * kTile));
  p.split_cap = static_cast<int>(std::min<long long>(p.n_tiles, reads / p.chunk + 1));
  p.long_cap = static_cast<int>(std::min<long long>(
      p.n_tiles + reads / p.chunk + 1, reads / (repro::kShortMax + 1) + reads / p.chunk + 1));
  p.bc = repro::candidates_per_block(nc, n_dec, smem_limit, bc);
  p.n_cb = p.bc > 0 ? (nc + p.bc - 1) / p.bc : 0;
  size_t off = 0;
  auto take = [&off](size_t bytes) { const size_t at = off; off = repro::align16(off + bytes); return at; };
  p.off_counters = take(repro::kNCounters * sizeof(int));
  p.off_start = take((static_cast<size_t>(p.n_keys) + 1) * sizeof(int));
  p.off_cursor = take(static_cast<size_t>(p.n_keys) * sizeof(int));
  p.off_sorted = take(static_cast<size_t>(G) * sizeof(int4));
  p.off_short = take(static_cast<size_t>(p.n_tiles) * sizeof(int4));
  p.off_long = take(static_cast<size_t>(p.long_cap) * sizeof(int4));
  p.off_split = take(static_cast<size_t>(p.split_cap) * sizeof(int));
  p.off_done = take(static_cast<size_t>(p.split_cap) * std::max(p.n_cb, 1) * sizeof(int));
  p.off_live = take(static_cast<size_t>(p.n_tiles));
  p.off_gbuf = take(static_cast<size_t>(p.split_cap) * p.n_cb * p.bc * kTile * n_dec * sizeof(float));
  p.off_partial = take(static_cast<size_t>(nc) * p.n_tiles * sizeof(float));
  p.bytes = off;
  return p;
}

template <int DELTA, int BC>
cudaError_t launch_delta(const int* x_t, const int* r, const int* d, const float* w,
                         char* ws, float* raw, int nc, int G, int V, int n_bins,
                         int n_dec, const Plan& p, int threads, int sms, cudaStream_t stream) {
  int* counters = reinterpret_cast<int*>(ws + p.off_counters);
  int* start = reinterpret_cast<int*>(ws + p.off_start);
  int* cursor = reinterpret_cast<int*>(ws + p.off_cursor);
  int4* sorted = reinterpret_cast<int4*>(ws + p.off_sorted);
  int4* short_items = reinterpret_cast<int4*>(ws + p.off_short);
  int4* long_items = reinterpret_cast<int4*>(ws + p.off_long);
  int* split_chunks = reinterpret_cast<int*>(ws + p.off_split);
  int* done = reinterpret_cast<int*>(ws + p.off_done);
  auto* tile_live = reinterpret_cast<unsigned char*>(ws + p.off_live);
  float* gbuf = reinterpret_cast<float*>(ws + p.off_gbuf);
  float* partial = reinterpret_cast<float*>(ws + p.off_partial);

  cudaError_t err = cudaMemsetAsync(start, 0, (static_cast<size_t>(p.n_keys) + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int flat_blocks = std::max(1, std::min((G + threads - 1) / threads, sms * (2048 / threads)));
  if (G > 0) {
    count_kernel<<<flat_blocks, threads, 0, stream>>>(r, d, w, start, G, p.n_cls, V, n_dec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  plan_kernel<<<1, repro::kPlanThreads, 0, stream>>>(start, cursor, p.n_keys, p.n_tiles, p.S,
                                                     p.chunk, short_items, long_items,
                                                     split_chunks, tile_live, counters);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t slot_words4 = static_cast<size_t>(p.n_cb) * p.bc * kTile * n_dec / 4;
  scatter_kernel<<<flat_blocks, threads, 0, stream>>>(
      r, d, w, cursor, sorted, G, p.n_cls, V, n_dec, counters,
      reinterpret_cast<float4*>(gbuf), slot_words4, done, p.n_cb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const repro::SegmentLists lists{short_items, long_items, counters, split_chunks, done, gbuf,
                                  tile_live, p.n_tiles, p.long_cap};
  return repro::launch_segments<DELTA, BC>(SweepSource{x_t, sorted, G, V}, lists, partial, raw, nc,
                                       n_bins, n_dec, p.n_tiles, p.bc, p.n_cb, sms, stream);
}

template <int DELTA>
cudaError_t launch_bc(const int* x_t, const int* r, const int* d, const float* w, char* ws,
                      float* raw, int nc, int G, int V, int n_bins, int n_dec, int bc,
                      const Plan& p, int threads, int sms, cudaStream_t stream) {
  switch (bc) {
    case 1: return launch_delta<DELTA, 1>(x_t, r, d, w, ws, raw, nc, G, V, n_bins, n_dec, p, threads, sms, stream);
    case 2: return launch_delta<DELTA, 2>(x_t, r, d, w, ws, raw, nc, G, V, n_bins, n_dec, p, threads, sms, stream);
    case 4: return launch_delta<DELTA, 4>(x_t, r, d, w, ws, raw, nc, G, V, n_bins, n_dec, p, threads, sms, stream);
    case 8: return launch_delta<DELTA, 8>(x_t, r, d, w, ws, raw, nc, G, V, n_bins, n_dec, p, threads, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of scratch sweep_theta_launch needs for these shapes and this tiling
// (0: the shapes do not fit a block's shared memory, or the tiling is not
// one the kernel has).
extern "C" size_t sweep_theta_workspace_bytes(int nc, int G, int v_max, int n_bins, int n_dec,
                                              int bc, int chunk) {
  const Plan p = make_plan(nc, G, v_max, n_bins, n_dec, bc, chunk,
                           repro::device_info().smem_limit);
  return p.bc > 0 ? p.bytes : 0;
}

// x_t [nc, G], r_ids/d [G] int32, w [G] f32, raw [nc] f32, workspace of
// sweep_theta_workspace_bytes(..., bc, chunk) bytes (16-byte aligned); all
// on the stream's device.  Requires nc >= 1, n_bins >= 1, v_max >= 1, bc in
// {1, 2, 4, 8}, threads a multiple of 32 that divides 2,048.
extern "C" cudaError_t sweep_theta_launch(const void* x_t, const void* r_ids, const void* d,
                                          const void* w, void* workspace, void* raw, int nc,
                                          int G, int v_max, int n_bins, int n_dec, int delta,
                                          int bc, int chunk, int threads, void* stream) {
  if (nc < 1 || n_bins < 1 || v_max < 1 || n_dec < 1 || G < 0) return cudaErrorInvalidValue;
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || 2048 % threads != 0)
    return cudaErrorInvalidValue;
  const repro::Device dev = repro::device_info();
  const Plan p = make_plan(nc, G, v_max, n_bins, n_dec, bc, chunk, dev.smem_limit);
  if (p.bc < 1) return cudaErrorInvalidValue;
  const auto* xt = static_cast<const int*>(x_t);
  const auto* r = static_cast<const int*>(r_ids);
  const auto* dd = static_cast<const int*>(d);
  const auto* ww = static_cast<const float*>(w);
  auto* ws = static_cast<char*>(workspace);
  auto* out = static_cast<float*>(raw);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (delta) {
    case repro::kPR: return launch_bc<repro::kPR>(xt, r, dd, ww, ws, out, nc, G, v_max, n_bins, n_dec, bc, p, threads, dev.sms, s);
    case repro::kSCE: return launch_bc<repro::kSCE>(xt, r, dd, ww, ws, out, nc, G, v_max, n_bins, n_dec, bc, p, threads, dev.sms, s);
    case repro::kLCE: return launch_bc<repro::kLCE>(xt, r, dd, ww, ws, out, nc, G, v_max, n_bins, n_dec, bc, p, threads, dev.sms, s);
    case repro::kCCE: return launch_bc<repro::kCCE>(xt, r, dd, ww, ws, out, nc, G, v_max, n_bins, n_dec, bc, p, threads, dev.sms, s);
    default: return cudaErrorInvalidValue;
  }
}
