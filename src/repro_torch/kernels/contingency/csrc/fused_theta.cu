// Fused contingency -> Θ kernel for Hopper (sm_90a), on per-candidate tile
// segments (plan backend "fused").
//
// Replaces the TPU kernel `fused_theta_pallas` / `_fused_kernel` of
// src/repro/kernels/contingency/fused.py (wrapper ops.fused_theta): raw
// Θ'[c] = Σ over 256-bin tiles, in ascending order, of Σ_rows θ'_δ(row) of
// the contingency of the keys packed[c, g] against d_g, weighted by w_g, the
// [nc, n_bins, n_dec] contingency never leaving on-chip memory.  A key is
// any int32: nothing here assumes packed = r·V + x.  A (c, g) with key
// outside [0, n_bins), d outside [0, n_dec) or w = 0 counts nothing
// (padding carries -1 sentinels or w = 0), as contingency_ref drops it.
//
// What bounds it on this card: one read of packed [nc, G] int32 plus d/w
// [G] — about 4·(nc + 2)·G bytes, ~21.5 MB at the kdd99 shapes — over the
// memory rate; the flops are a few per key.
//
// Design.  A tile that found its keys by scanning all of them would read
// nc·G keys once per tile (5,120 times at the kdd99 top bin bound).  So each
// candidate's live keys are ordered once a launch by their tile p >> 8 — a
// counting sort over nc × n_tiles buckets — and segment (c, t) of the
// ordered list holds exactly the keys of candidate c in tile t; each tile
// reads only its own:
//
// 1. count_kernel, one CTA of `threads` per (key chunk, candidate): keys per bucket,
//    aggregated per warp with __match_any_sync and per CTA in a shared-memory
//    histogram of the candidate's tiles (when n_tiles·4 bytes fit in 48 KB;
//    else straight into the global counts), so that K = 1, where every key
//    of a candidate lies in one tile, does not serialize on one counter.
// 2. plan_kernel, one CTA per candidate: exclusive scan of its counts into
//    the candidate's range [c·G, c·G + G) of the ordered list; its segments
//    into the work lists (segments of at most kShortMax keys, and chunks of
//    at most `chunk` keys of the longer ones, `chunk` at least the tiling's;
//    list slots reserved with one atomic a round, so the lists' order varies
//    and nothing depends on it);
//    a +0 partial for each empty tile; the last live tile.
// 3. scatter_kernel: each live key into its bucket's range as one int,
//    g << 8 | (p - 256t) (warp-aggregated cursors; the order inside a bucket
//    changes from run to run and no result depends on it).  Four bytes a key
//    keep the ordered list (nc·G·4 bytes, 21.5 MB at kdd99) inside the 50 MB
//    L2, where the scatter's random writes land; d_g and w_g are gathered
//    again (from L2: 1 MB) by the tile kernels.  From G = 2^23 on, g leaves
//    no room for the offset: an entry is g alone, and the tile kernels
//    gather the key packed[c, g] again for it (c = entry index / G, since
//    candidate c's range is [c·G, c·G + G)).  Four bytes a key either way.
// 4.-6. the segment kernels of segments.cuh — short tiles one warp each,
//    long tiles in chunks of shared-memory histograms merged through
//    integer-valued atomics and a ticket, the ordered per-tile sum — the same
//    code the sweep kernel runs, reading segment (c, t) through FusedSource
//    with one candidate a block.  So Θ_PR is the sweep's bits wherever both
//    run, and the same on every run and at every ladder rung.
//
// The ordering costs a read of the keys for the counts, a read and a 4-byte
// write a live key for the scatter, and a 4-byte read and the gathers of d
// and w (and of the key, from G = 2^23) a live key for the tiles.
// The launch shape is the tiling's (kernels/contingency/autotune.py, kernel
// "fused"): `chunk`, the fewest keys of a long segment's chunk (pinned:
// 4,096), and `threads`, the CTA of the count and scatter passes (instances
// 128, 256, 512 and 1,024; pinned: 256), whose keys per CTA are at least
// four a thread.  The segment kernels read one candidate a block (bc = 1)
// through the BC = 4 instance, the pinned one.  No field changes a bit:
// segments.cuh says why.
// Built with --fmad=false; no fast math.
#include <climits>

#include "segments.cuh"

namespace {

using repro::kTile;

constexpr int kCountSmemBytes = 48 * 1024;  // a count CTA's tile histogram, when it fits
constexpr int kMaxChunks = 512;     // the chunk keeps the split segments near this
constexpr int kFlatKeysPerThread = 4;  // keys per CTA of count / scatter, at least, per thread
constexpr int kBC = 4;              // the segment kernels' instance (one candidate a block)
constexpr int kWideG = 1 << 23;     // from this G on, an entry is g alone (g << 8 overflows)

__device__ __forceinline__ bool live(int p, int d, float w, int n_bins, int n_dec) {
  return p >= 0 && p < n_bins && d >= 0 && d < n_dec && w != 0.f;
}

// An entry of the per-candidate ordering is g << 8 | (p - 256t), or g when
// `wide` (G >= kWideG), loaded as {p - 256t, d_g, w_g bits}; segment
// c·n_tiles + t is candidate c's tile t, read by one candidate.
struct FusedSource {
  using Entry = int4;
  const int* __restrict__ sorted;
  const int* __restrict__ packed;
  const int* __restrict__ d;
  const float* __restrict__ w;
  int n_tiles, G;
  bool wide;
  __device__ __forceinline__ Entry load(int i) const {
    const int e = sorted[i];
    int g = e >> 8, off = e & (kTile - 1);
    if (wide) {  // the key again, from candidate i / G's row
      g = e;
      off = packed[static_cast<size_t>(i / G) * G + g] & (kTile - 1);
    }
    return make_int4(off, d[g], __float_as_int(w[g]), 0);
  }
  static __device__ __forceinline__ Entry none() { return make_int4(-1, 0, 0, 0); }
  static __device__ __forceinline__ bool valid(const Entry& e) { return e.x >= 0; }
  static __device__ __forceinline__ float weight(const Entry& e) { return __int_as_float(e.z); }
  static __device__ __forceinline__ int dec(const Entry& e) { return e.y; }
  __device__ __forceinline__ int tile(int seg) const { return seg % n_tiles; }
  __device__ __forceinline__ int first_cand(int seg, int, int) const { return seg / n_tiles; }
  template <int BC>
  __device__ __forceinline__ void keys(const Entry& e, int, int, int, int (&p)[BC]) const {
    p[0] = e.x;
#pragma unroll
    for (int k = 1; k < BC; ++k) p[k] = -1;
  }
};

// ---------------------------------------------------------------- ordering

// counts[c·(n_tiles + 1) + t] += live keys of candidate c in tile t, over
// the keys [blockIdx.x·chunk, +chunk) of candidate blockIdx.y.
template <int THREADS, bool kShared>
__global__ void __launch_bounds__(THREADS)
count_kernel(const int* __restrict__ packed, const int* __restrict__ d,
             const float* __restrict__ w, int* __restrict__ counts, int G, int n_bins,
             int n_dec, int n_tiles, int chunk) {
  extern __shared__ int hist[];  // [n_tiles] when kShared
  const int c = blockIdx.y;
  const int g0 = blockIdx.x * chunk, g1 = min(g0 + chunk, G);
  const int lane = threadIdx.x % 32;
  const int* keys = packed + static_cast<size_t>(c) * G;
  int* out = counts + static_cast<size_t>(c) * (n_tiles + 1);
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  for (int base = g0 + threadIdx.x / 32 * 32; base < g1; base += blockDim.x) {  // warp-uniform
    const int g = base + lane;
    const int p = g < g1 ? keys[g] : -1;
    const bool ok = g < g1 && live(p, d[g], w[g], n_bins, n_dec);
    const int t = ok ? p / kTile : -1;
    const unsigned same = __match_any_sync(0xffffffffu, t);
    if (ok && lane == __ffs(same) - 1) {
      if constexpr (kShared) {
        atomicAdd(&hist[t], __popc(same));
      } else {
        atomicAdd(&out[t], __popc(same));
      }
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
      const int v = hist[i];
      if (v != 0) atomicAdd(&out[i], v);
    }
  }
}

// One CTA of kPlanThreads per candidate c: its counts -> exclusive starts in
// place (start[c·(n_tiles + 1) + n_tiles] = the end of its range), its
// segments into the work lists, +0 partials for its empty tiles, and the
// last live tile over all candidates.  Both passes walk the tiles in rounds
// of consecutive elements.
__global__ void __launch_bounds__(repro::kPlanThreads)
plan_kernel(int* __restrict__ start, int* __restrict__ cursor, int G, int n_tiles, int chunk,
            int4* __restrict__ short_items, int4* __restrict__ long_items,
            int* __restrict__ split_chunks, float* __restrict__ partial,
            int* __restrict__ counters) {
  using repro::block_exclusive_scan;
  using repro::kPlanThreads;
  using repro::kShortMax;
  __shared__ int n_live, at_short, at_long, at_split;
  const int c = blockIdx.x, tid = threadIdx.x;
  int* st = start + static_cast<size_t>(c) * (n_tiles + 1);
  int* cur = cursor + static_cast<size_t>(c) * (n_tiles + 1);
  float* part = partial + static_cast<size_t>(c) * n_tiles;
  if (tid == 0) n_live = 0;

  // 1. counts -> exclusive starts from c·G
  int carry = c * G;
  for (int base = 0; base < n_tiles; base += 4 * kPlanThreads) {
    const int k = base + 4 * tid;
    int n[4], sum = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      n[e] = k + e < n_tiles ? st[k + e] : 0;
      sum += n[e];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, &total);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + e < n_tiles) {
        st[k + e] = run;
        cur[k + e] = run;
      }
      run += n[e];
    }
    carry += total;
  }
  if (tid == 0) st[n_tiles] = carry;
  __syncthreads();  // the block's writes to st[] are visible below

  // 2. four consecutive tiles a thread a round: classify, scan, reserve list
  //    slots, write the items
  constexpr int kPer = 4;
  for (int base = 0; base < n_tiles; base += kPer * kPlanThreads) {
    int2 seg[kPer];
    int n_short = 0, n_long = 0, n_split = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = base + kPer * tid + e;
      seg[e] = t < n_tiles ? make_int2(st[t], st[t + 1]) : make_int2(0, 0);
      const int len = seg[e].y - seg[e].x;
      if (t < n_tiles && len == 0) part[t] = 0.f;
      if (len > 0) atomicMax(&n_live, t + 1);
      const int nch = len > kShortMax ? (len + chunk - 1) / chunk : 0;
      n_short += len > 0 && len <= kShortMax;
      n_long += nch;
      n_split += nch > 1;
    }
    int t_short, t_long, t_split;
    int i_short = block_exclusive_scan(n_short, &t_short);
    int i_long = block_exclusive_scan(n_long, &t_long);
    int i_split = block_exclusive_scan(n_split, &t_split);
    if (tid == 0) {
      at_short = atomicAdd(&counters[repro::kNShort], t_short);
      at_long = atomicAdd(&counters[repro::kNLong], t_long);
      at_split = atomicAdd(&counters[repro::kNSplit], t_split);
    }
    __syncthreads();
    i_short += at_short;
    i_long += at_long;
    i_split += at_split;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = base + kPer * tid + e;
      const int len = seg[e].y - seg[e].x;
      const int id = c * n_tiles + t;
      if (len > 0 && len <= kShortMax) short_items[i_short++] = make_int4(id, seg[e].x, seg[e].y, -1);
      if (len <= kShortMax) continue;
      const int nch = (len + chunk - 1) / chunk;
      const int slot = nch > 1 ? i_split++ : -1;
      if (slot >= 0) split_chunks[slot] = nch;
      for (int j = 0; j < nch; ++j)
        long_items[i_long++] = make_int4(id, seg[e].x + j * chunk,
                                         min(seg[e].x + (j + 1) * chunk, seg[e].y), slot);
    }
    __syncthreads();  // at_* are reused by the next round
  }
  if (tid == 0) atomicMax(&counters[repro::kNLive], n_live);
}

// Each live key into its bucket's range; then zero the split segments'
// buffers and ticket counters that this launch will use.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
scatter_kernel(const int* __restrict__ packed, const int* __restrict__ d,
               const float* __restrict__ w, int* __restrict__ cursor,
               int* __restrict__ sorted, int G, int n_bins, int n_dec, int n_tiles, int chunk,
               const int* __restrict__ counters, float4* __restrict__ gbuf,
               size_t slot_words4, int* __restrict__ done, bool wide) {
  const int c = blockIdx.y;
  const int g0 = blockIdx.x * chunk, g1 = min(g0 + chunk, G);
  const int lane = threadIdx.x % 32;
  const int* keys = packed + static_cast<size_t>(c) * G;
  int* cur = cursor + static_cast<size_t>(c) * (n_tiles + 1);
  for (int base = g0 + threadIdx.x / 32 * 32; base < g1; base += blockDim.x) {  // warp-uniform
    const int g = base + lane;
    const int p = g < g1 ? keys[g] : -1;
    const int dg = g < g1 ? d[g] : -1;
    const float wg = g < g1 ? w[g] : 0.f;
    const bool ok = live(p, dg, wg, n_bins, n_dec);
    const int t = ok ? p / kTile : -1;
    const unsigned same = __match_any_sync(0xffffffffu, t);
    const int leader = __ffs(same) - 1;
    int pos = 0;
    if (ok && lane == leader) pos = atomicAdd(&cur[t], __popc(same));
    pos = __shfl_sync(0xffffffffu, pos, leader);
    if (ok) sorted[pos + __popc(same & ((1u << lane) - 1u))] = wide ? g : g << 8 | (p & (kTile - 1));
  }
  const int tid = (blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * gridDim.y * blockDim.x;
  const int n_split = counters[repro::kNSplit];
  const size_t words4 = static_cast<size_t>(n_split) * slot_words4;
  for (size_t i = tid; i < words4; i += threads) gbuf[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < n_split; i += threads) done[i] = 0;
}

// ------------------------------------------------------------------ launch

struct Plan {
  int n_tiles, chunk, split_cap;
  long long short_cap, long_cap;
  size_t off_counters, off_start, off_cursor, off_sorted, off_short, off_long, off_split,
      off_done, off_gbuf, off_partial, bytes;
};

// 0 bytes: the shapes do not fit (a tile's histogram past shared memory, or
// nc·G past an int), or `chunk` is below 256 keys.
Plan make_plan(int nc, int G, int n_bins, int n_dec, int chunk, int smem_limit) {
  Plan p{};
  const long long reads = static_cast<long long>(nc) * G;  // each live key in one segment
  if (repro::candidates_per_block(1, n_dec, smem_limit, 1) < 1 || reads > INT_MAX ||
      chunk < kTile)
    return p;
  p.n_tiles = (n_bins + kTile - 1) / kTile;
  const long long buckets = static_cast<long long>(nc) * p.n_tiles;
  const long long want = (reads + kMaxChunks - 1) / kMaxChunks;
  p.chunk = static_cast<int>(std::max<long long>(chunk, (want + kTile - 1) / kTile * kTile));
  p.split_cap = static_cast<int>(std::min<long long>(buckets, reads / p.chunk + 1));
  p.short_cap = buckets;
  p.long_cap = reads / p.chunk + std::min<long long>(buckets, reads / (repro::kShortMax + 1)) + 1;
  size_t off = 0;
  auto take = [&off](size_t bytes) { const size_t at = off; off = repro::align16(off + bytes); return at; };
  p.off_counters = take(repro::kNCounters * sizeof(int));
  p.off_start = take(static_cast<size_t>(nc) * (p.n_tiles + 1) * sizeof(int));
  p.off_cursor = take(static_cast<size_t>(nc) * (p.n_tiles + 1) * sizeof(int));
  p.off_sorted = take(static_cast<size_t>(reads) * sizeof(int));
  p.off_short = take(static_cast<size_t>(p.short_cap) * sizeof(int4));
  p.off_long = take(static_cast<size_t>(p.long_cap) * sizeof(int4));
  p.off_split = take(static_cast<size_t>(p.split_cap) * sizeof(int));
  p.off_done = take(static_cast<size_t>(p.split_cap) * sizeof(int));
  p.off_gbuf = take(static_cast<size_t>(p.split_cap) * kTile * n_dec * sizeof(float));
  p.off_partial = take(static_cast<size_t>(buckets) * sizeof(float));
  p.bytes = off;
  return p;
}

template <int DELTA, int THREADS>
cudaError_t launch_delta(const int* packed, const int* d, const float* w, char* ws, float* raw,
                         int nc, int G, int n_bins, int n_dec, const Plan& p, int sms,
                         cudaStream_t stream) {
  int* counters = reinterpret_cast<int*>(ws + p.off_counters);
  int* start = reinterpret_cast<int*>(ws + p.off_start);
  int* cursor = reinterpret_cast<int*>(ws + p.off_cursor);
  int* sorted = reinterpret_cast<int*>(ws + p.off_sorted);
  int4* short_items = reinterpret_cast<int4*>(ws + p.off_short);
  int4* long_items = reinterpret_cast<int4*>(ws + p.off_long);
  int* split_chunks = reinterpret_cast<int*>(ws + p.off_split);
  int* done = reinterpret_cast<int*>(ws + p.off_done);
  float* gbuf = reinterpret_cast<float*>(ws + p.off_gbuf);
  float* partial = reinterpret_cast<float*>(ws + p.off_partial);

  // counters and counts lie first and together
  cudaError_t err = cudaMemsetAsync(ws, 0, p.off_cursor, stream);
  if (err != cudaSuccess) return err;
  // keys per CTA of the flat kernels: about 1,024 threads an SM, and a
  // shared histogram's flush amortized over at least as many keys as it has
  // tiles (THREADS 256, pinned: four CTAs an SM and at least 1,024 keys)
  const bool shared_count = static_cast<long long>(p.n_tiles) * sizeof(int) <= kCountSmemBytes;
  const long long ctas = static_cast<long long>(sms) * (1024 / THREADS);
  long long flat = (static_cast<long long>(nc) * G + ctas - 1) / ctas;
  flat = std::max<long long>(flat, kFlatKeysPerThread * THREADS);
  if (shared_count) flat = std::max<long long>(flat, p.n_tiles);
  flat = std::min<long long>((flat + THREADS - 1) / THREADS * THREADS,
                             (static_cast<long long>(G) + THREADS - 1) / THREADS * THREADS);
  const int flat_chunk = static_cast<int>(std::max<long long>(flat, THREADS));
  const dim3 flat_grid((G + flat_chunk - 1) / flat_chunk, nc);
  if (G > 0) {
    if (shared_count)
      count_kernel<THREADS, true><<<flat_grid, THREADS, p.n_tiles * sizeof(int), stream>>>(
          packed, d, w, start, G, n_bins, n_dec, p.n_tiles, flat_chunk);
    else
      count_kernel<THREADS, false><<<flat_grid, THREADS, 0, stream>>>(
          packed, d, w, start, G, n_bins, n_dec, p.n_tiles, flat_chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  plan_kernel<<<nc, repro::kPlanThreads, 0, stream>>>(start, cursor, G, p.n_tiles, p.chunk,
                                                      short_items, long_items, split_chunks,
                                                      partial, counters);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const bool wide = G >= kWideG;
  if (G > 0) {  // with no keys no segment is split: nothing to zero
    scatter_kernel<THREADS><<<flat_grid, THREADS, 0, stream>>>(
        packed, d, w, cursor, sorted, G, n_bins, n_dec, p.n_tiles, flat_chunk, counters,
        reinterpret_cast<float4*>(gbuf), static_cast<size_t>(kTile) * n_dec / 4, done, wide);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const repro::SegmentLists lists{short_items, long_items, counters, split_chunks, done, gbuf,
                                  nullptr, p.short_cap, p.long_cap};
  return repro::launch_segments<DELTA, kBC>(FusedSource{sorted, packed, d, w, p.n_tiles, G, wide},
                                       lists, partial, raw, nc,
                                       n_bins, n_dec, p.n_tiles, 1, 1, sms, stream);
}

template <int DELTA>
cudaError_t launch_threads(const int* packed, const int* d, const float* w, char* ws, float* raw,
                           int nc, int G, int n_bins, int n_dec, int threads, const Plan& p,
                           int sms, cudaStream_t stream) {
  switch (threads) {
    case 128: return launch_delta<DELTA, 128>(packed, d, w, ws, raw, nc, G, n_bins, n_dec, p, sms, stream);
    case 256: return launch_delta<DELTA, 256>(packed, d, w, ws, raw, nc, G, n_bins, n_dec, p, sms, stream);
    case 512: return launch_delta<DELTA, 512>(packed, d, w, ws, raw, nc, G, n_bins, n_dec, p, sms, stream);
    case 1024: return launch_delta<DELTA, 1024>(packed, d, w, ws, raw, nc, G, n_bins, n_dec, p, sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of scratch fused_theta_launch needs for these shapes and this chunk
// (0: the shapes do not fit a block's shared memory, nc·G is past an int,
// or the chunk is below 256 keys).
extern "C" size_t fused_theta_workspace_bytes(int nc, int G, int n_bins, int n_dec, int chunk) {
  return make_plan(nc, G, n_bins, n_dec, chunk, repro::device_info().smem_limit).bytes;
}

// packed [nc, G], d [G] int32, w [G] f32, raw [nc] f32, workspace of
// fused_theta_workspace_bytes(..., chunk) bytes (16-byte aligned); all on the
// stream's device.  Requires nc >= 1, n_bins >= 1, threads in {128, 256,
// 512, 1024}.
extern "C" cudaError_t fused_theta_launch(const void* packed, const void* d, const void* w,
                                          void* workspace, void* raw, int nc, int G,
                                          int n_bins, int n_dec, int delta, int chunk,
                                          int threads, void* stream) {
  if (nc < 1 || n_bins < 1 || n_dec < 1 || G < 0) return cudaErrorInvalidValue;
  const repro::Device dev = repro::device_info();
  const Plan p = make_plan(nc, G, n_bins, n_dec, chunk, dev.smem_limit);
  if (p.bytes == 0) return cudaErrorInvalidValue;
  const auto* pk = static_cast<const int*>(packed);
  const auto* dd = static_cast<const int*>(d);
  const auto* ww = static_cast<const float*>(w);
  auto* ws = static_cast<char*>(workspace);
  auto* out = static_cast<float*>(raw);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (delta) {
    case repro::kPR: return launch_threads<repro::kPR>(pk, dd, ww, ws, out, nc, G, n_bins, n_dec, threads, p, dev.sms, s);
    case repro::kSCE: return launch_threads<repro::kSCE>(pk, dd, ww, ws, out, nc, G, n_bins, n_dec, threads, p, dev.sms, s);
    case repro::kLCE: return launch_threads<repro::kLCE>(pk, dd, ww, ws, out, nc, G, n_bins, n_dec, threads, p, dev.sms, s);
    case repro::kCCE: return launch_threads<repro::kCCE>(pk, dd, ww, ws, out, nc, G, n_bins, n_dec, threads, p, dev.sms, s);
    default: return cudaErrorInvalidValue;
  }
}
