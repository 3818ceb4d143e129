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
// 4. short_tiles_kernel: one warp per (short tile, block of bc candidates),
//    one granule a lane.  Granules of one row, and of one cell, find each
//    other with __match_any_sync; only rows a granule touches get a θ', built
//    from their cells alone (no dense row is zeroed or read), and a row of
//    one granule in closed form.
// 5. long_tiles_kernel: one CTA per (chunk, block of bc candidates), with
//    bc dense [256, n_dec] histograms in shared memory; each granule's r, d, w
//    is read once for the bc candidates.  A tile cut into several chunks (the
//    first greedy iterations put every granule in one or two tiles) adds its
//    non-zero counts into a global per-tile buffer; the last chunk to finish
//    (a ticket counter) runs the epilogue.
// 6. ordered_sum_kernel: raw[c] = ((0 + p0) + p1) + ... over the tiles in
//    ascending order, one f32 add at a time, an empty tile adding +0, up to
//    the last tile that holds a granule (the rest would add +0, and x + 0 is
//    x for every sum here: none is -0); never float atomics across tiles.
//
// Every count is an integer-valued f32 below 2^24, so the order of the adds
// that build it (atomics, merges, the order inside a bucket) cannot change a
// bit.  A row's θ' is built on both paths from the pieces row_theta is made
// of (common.cuh: row_ctx, cell_term, row_finish; single_theta for a row of
// one granule), its cell terms summed in ascending decision order (a zero
// cell's term is +0, and an all-zero row's θ' is exactly 0), placed at the
// row's index in a 256-entry array and summed by tile_sum256's fixed order.  So a tile's partial is a function of its
// contingency alone: the same on every run and at every ladder rung (a
// smaller rung's tiles are a prefix of a larger rung's, and the extra tiles
// add exact zeros: DESIGN.md §5.3).  Built with --fmad=false; no fast math.
#include <algorithm>
#include <mutex>
#include <vector>

#include "common.cuh"

namespace {

using repro::kTile;

constexpr int kShortMax = 32;      // granules of a short tile: one a lane
constexpr int kMaxBC = 4;          // candidates that share one read of a granule
constexpr int kLongThreads = kTile;  // one thread per bin row in the dense epilogue
constexpr int kShortThreads = 256;
constexpr int kPlanThreads = 1024;
constexpr int kMaxSplit = 64;      // bounds the tiles cut into several chunks
constexpr int kMinChunk = 4096;    // granules per chunk of a long tile, at least
constexpr int kSumSlab = 4096;     // partials staged at a time by ordered_sum_kernel
constexpr int kUnroll = 4;         // granules a thread loads at once in the long path

// counters[]: what plan_kernel found
enum Counter : int { kNShort = 0, kNLong = 1, kNSplit = 2, kNLive = 3, kNCounters = 4 };

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

// The fixed order of a tile's sum over its 256 row values `red`: lane l adds
// rows l, l + 32, ..., l + 224 one at a time, then a xor butterfly over the
// 32 lanes (every lane ends with the same bits).
__device__ __forceinline__ float tile_sum256(const float* red, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kTile / 32; ++i) acc += red[lane + 32 * i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

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

// Exclusive scan of one int a thread across a block of kPlanThreads.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int sums[kPlanThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  const int prefix = (warp > 0 ? sums[warp - 1] : 0) + x - v;
  *total = sums[kPlanThreads / 32 - 1];
  __syncthreads();  // sums[] is reused by the next call
  return prefix;
}

// One CTA of kPlanThreads: bucket starts, tile segments, work lists, and a
// flag a tile (1: it holds a granule).  Both passes walk their arrays in
// rounds of consecutive elements, carrying the running totals.
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(int* __restrict__ start, int* __restrict__ cursor, int n_keys, int n_tiles,
            int S, int chunk, int4* __restrict__ short_items, int4* __restrict__ long_items,
            int* __restrict__ split_chunks, unsigned char* __restrict__ tile_live,
            int* __restrict__ counters) {
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
    counters[kNShort] = o_short;
    counters[kNLong] = o_long;
    counters[kNSplit] = o_split;
    counters[kNLive] = n_live;
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
  const int n_split = counters[kNSplit];
  const size_t words4 = static_cast<size_t>(n_split) * slot_words4;
  for (size_t i = tid; i < words4; i += threads) gbuf[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < n_split * n_cb; i += threads) done[i] = 0;
}

// ------------------------------------------------------------------ tiles

// One warp per (short tile, candidate block), lane i holding the segment's
// granule i.  Shared memory per warp: red[256] (row values; 0 where no
// granule falls, restored after each candidate by the lanes that wrote it)
// and, per lane, its weight, and its cell's term, count and decision.
template <int DELTA>
__global__ void __launch_bounds__(kShortThreads)
short_tiles_kernel(const int* __restrict__ x_t, const int4* __restrict__ sorted,
                   const int4* __restrict__ items, const int* __restrict__ counters,
                   float* __restrict__ partial, int nc, int G, int V, int n_bins,
                   int n_dec, int n_tiles, int bc, int n_cb) {
  constexpr int kPerWarp = kTile + 4 * 32;
  __shared__ float smem[kShortThreads / 32 * kPerWarp];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* red = smem + warp * kPerWarp;
  float* wbuf = red + kTile;
  float* tbuf = wbuf + 32;
  float* cbuf = tbuf + 32;                        // a cell's count at its leader
  int* dbuf = reinterpret_cast<int*>(cbuf + 32);  // a cell's decision at its leader, else -1
  for (int i = lane; i < kTile; i += 32) red[i] = 0.f;
  __syncwarp();

  const int n_items = counters[kNShort] * n_cb;
  for (int it = blockIdx.x * warps + warp; it < n_items; it += gridDim.x * warps) {
    const int4 item = items[it / n_cb];
    const int cb = it % n_cb;
    const int lo = item.x * kTile;
    const int nb = min(kTile, n_bins - lo);
    const bool has = item.y + lane < item.z;
    const int4 s = has ? sorted[item.y + lane] : make_int4(0, 0, 0, 0);
    const float wg = __int_as_float(s.w);
    int xk[kMaxBC];
#pragma unroll
    for (int k = 0; k < kMaxBC; ++k) {
      const int c = cb * bc + k;
      xk[k] = (has && k < bc && c < nc) ? x_t[static_cast<size_t>(c) * G + s.x] : 0;
    }
#pragma unroll
    for (int k = 0; k < kMaxBC; ++k) {
      const int c = cb * bc + k;
      if (k >= bc || c >= nc) break;  // warp-uniform
      const int p = s.y * V + xk[k] - lo;
      const bool ok = has && static_cast<unsigned>(p) < static_cast<unsigned>(nb);
      // lanes of one row; a row of one granule is not built: its θ' is
      // single_theta of the weight
      const unsigned row = __match_any_sync(0xffffffffu, ok ? p : -1 - lane);
      const bool multi = ok && __popc(row) > 1;
      if (__any_sync(0xffffffffu, multi)) {
        // lanes of one cell (row, decision); others unique
        const unsigned cell = __match_any_sync(0xffffffffu, multi ? p * n_dec + s.z : -1 - lane);
        wbuf[lane] = multi ? wg : 0.f;
        __syncwarp();
        float e = 0.f;  // the row's sum
        if (multi) {
          float cnt = 0.f;  // integer-valued sums: any order gives the same bits
          for (unsigned m = cell; m; m &= m - 1) cnt += wbuf[__ffs(m) - 1];
          for (unsigned m = row; m; m &= m - 1) e += wbuf[__ffs(m) - 1];
          const bool cell_lead = lane == __ffs(cell) - 1;
          tbuf[lane] = cell_lead ? repro::cell_term<DELTA>(cnt, repro::row_ctx<DELTA>(e)) : 0.f;
          cbuf[lane] = cell_lead ? cnt : 0.f;
          dbuf[lane] = cell_lead ? s.z : -1;
        }
        __syncwarp();
        if (multi && lane == __ffs(row) - 1) {  // the row's leader: its θ'
          float acc = 0.f, mx = 0.f;
          for (int last = -1;;) {  // the row's cells in ascending decision order
            int pick = -1, pick_d = 0x7fffffff;
            for (unsigned m = row; m; m &= m - 1) {
              const int j = __ffs(m) - 1, dj = dbuf[j];
              if (dj > last && dj < pick_d) { pick = j; pick_d = dj; }
            }
            if (pick < 0) break;
            acc += tbuf[pick];
            mx = fmaxf(mx, cbuf[pick]);
            last = pick_d;
          }
          red[p] = repro::row_finish<DELTA>(acc, e, mx);
        }
      }
      if (ok && !multi) red[p] = repro::single_theta<DELTA>(wg);
      __syncwarp();
      const float v = tile_sum256(red, lane);
      if (lane == 0) partial[static_cast<size_t>(c) * n_tiles + item.x] = v;
      __syncwarp();
      if (ok) red[p] = 0.f;
      __syncwarp();
    }
  }
}

// One CTA of kLongThreads per (chunk of a long tile, candidate block).
// Shared memory: hist[bc][256 * n_dec], red[bc][256].
template <int DELTA>
__global__ void __launch_bounds__(kLongThreads)
long_tiles_kernel(const int* __restrict__ x_t, const int4* __restrict__ sorted,
                  const int4* __restrict__ items, const int* __restrict__ counters,
                  const int* __restrict__ split_chunks, int* __restrict__ done,
                  float* __restrict__ gbuf, float* __restrict__ partial, int nc, int G,
                  int V, int n_bins, int n_dec, int n_tiles, int bc, int n_cb) {
  extern __shared__ float hist[];
  __shared__ int last;
  const int hsize = kTile * n_dec;
  float* red = hist + static_cast<size_t>(bc) * hsize;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int n_items = counters[kNLong] * n_cb;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int4 item = items[it / n_cb];
    const int cb = it % n_cb;
    const int lo = item.x * kTile;
    const int nb = min(kTile, n_bins - lo);
    const int c0 = cb * bc;
    const int nk = min(bc, nc - c0);
    const int words = nk * hsize;  // a multiple of 256: float4-aligned

    float4* h4 = reinterpret_cast<float4*>(hist);
    for (int i = tid; i < words / 4; i += kLongThreads) h4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    // kUnroll granules a thread at once, so their loads are in flight together
    for (int i0 = item.y + tid; i0 < item.z; i0 += kUnroll * kLongThreads) {
      int4 s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kLongThreads;
        s[u] = i < item.z ? sorted[i] : make_int4(0, -1, 0, 0);
      }
      int x[kUnroll][kMaxBC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < kMaxBC; ++k)
          x[u][k] = (s[u].y >= 0 && k < nk) ? x_t[static_cast<size_t>(c0 + k) * G + s[u].x] : 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s[u].y < 0) continue;
        const float wg = __int_as_float(s[u].w);
        const int key0 = s[u].y * V - lo;
#pragma unroll
        for (int k = 0; k < kMaxBC; ++k) {
          const int p = key0 + x[u][k];
          if (k < nk && static_cast<unsigned>(p) < static_cast<unsigned>(nb))
            atomicAdd(&hist[k * hsize + p * n_dec + s[u].z], wg);
        }
      }
    }
    __syncthreads();

    bool finish = true;
    if (item.w >= 0) {  // one chunk of a split tile: merge, the last one finishes
      float* g = gbuf + (static_cast<size_t>(item.w) * nc + c0) * hsize;
      for (int i = tid; i < words; i += kLongThreads) {
        const float v = hist[i];
        if (v != 0.f) atomicAdd(&g[i], v);
      }
      __threadfence();
      __syncthreads();
      if (tid == 0)
        last = atomicAdd(&done[item.w * n_cb + cb], 1) == split_chunks[item.w] - 1;
      __syncthreads();
      finish = last;
      if (finish) {
        __threadfence();
        for (int i = tid; i < words; i += kLongThreads) hist[i] = __ldcg(&g[i]);
        __syncthreads();
      }
    }
    if (finish) {
      for (int k = 0; k < nk; ++k)
        red[k * kTile + tid] = repro::row_theta<DELTA>(&hist[k * hsize + tid * n_dec], n_dec);
      __syncthreads();
      if (warp < nk) {
        const float v = tile_sum256(&red[warp * kTile], lane);
        if (lane == 0) partial[static_cast<size_t>(c0 + warp) * n_tiles + item.x] = v;
      }
    }
    __syncthreads();  // hist and red are reused by the next item
  }
}

// raw[c] = ((0 + p0) + p1) + ... in ascending tile order, an empty tile's
// partial read as +0 (never written), up to the last live tile; one CTA a
// candidate, its partials staged in shared memory for the serial chain.
__global__ void ordered_sum_kernel(const float* __restrict__ partial,
                                   const unsigned char* __restrict__ tile_live,
                                   const int* __restrict__ counters, float* __restrict__ raw,
                                   int n_tiles) {
  __shared__ float4 buf[kSumSlab / 4];
  float* b1 = reinterpret_cast<float*>(buf);
  const int c = blockIdx.x;
  const int n_live = counters[kNLive];
  const float* row = partial + static_cast<size_t>(c) * n_tiles;
  float acc = 0.f;
  for (int base = 0; base < n_live; base += kSumSlab) {
    const int n = min(kSumSlab, n_live - base);
    __syncthreads();
    for (int i = threadIdx.x; i < (n + 3) / 4 * 4; i += blockDim.x)
      b1[i] = (i < n && tile_live[base + i]) ? row[base + i] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int i = 0; i < (n + 3) / 4; ++i) {  // the padding past n adds +0
        const float4 v = buf[i];
        acc += v.x;
        acc += v.y;
        acc += v.z;
        acc += v.w;
      }
    }
  }
  if (threadIdx.x == 0) raw[c] = acc;
}

// ------------------------------------------------------------------ launch

struct Plan {
  int n_cls, n_tiles, n_keys, S, chunk, split_cap, long_cap, bc, n_cb;
  size_t off_counters, off_start, off_cursor, off_sorted, off_short, off_long, off_split,
      off_done, off_live, off_gbuf, off_partial, bytes;
};

size_t align16(size_t x) { return (x + 15) / 16 * 16; }

Plan make_plan(int nc, int G, int V, int n_bins, int n_dec, int smem_limit) {
  Plan p{};
  p.n_cls = (n_bins + V - 1) / V;
  p.n_tiles = (n_bins + kTile - 1) / kTile;
  p.n_keys = 2 * p.n_tiles;
  p.S = (V + kTile - 1) / kTile;
  // a granule is read by at most S + 1 tiles, so the segments hold at most
  // (S + 1)·G granules in all; the chunk keeps the split tiles below kMaxSplit
  const long long reads = static_cast<long long>(p.S + 1) * G;
  const long long want = (reads + kMaxSplit - 1) / kMaxSplit;
  p.chunk = static_cast<int>(std::max<long long>(kMinChunk, (want + kTile - 1) / kTile * kTile));
  p.split_cap = static_cast<int>(std::min<long long>(p.n_tiles, reads / p.chunk + 1));
  p.long_cap = static_cast<int>(std::min<long long>(
      p.n_tiles + reads / p.chunk + 1, reads / (kShortMax + 1) + reads / p.chunk + 1));
  const int per_cand = (kTile * n_dec + kTile) * static_cast<int>(sizeof(float));
  p.bc = std::min(std::min(kMaxBC, nc), smem_limit / per_cand);
  p.n_cb = p.bc > 0 ? (nc + p.bc - 1) / p.bc : 0;
  size_t off = 0;
  auto take = [&off](size_t bytes) { const size_t at = off; off = align16(off + bytes); return at; };
  p.off_counters = take(kNCounters * sizeof(int));
  p.off_start = take((static_cast<size_t>(p.n_keys) + 1) * sizeof(int));
  p.off_cursor = take(static_cast<size_t>(p.n_keys) * sizeof(int));
  p.off_sorted = take(static_cast<size_t>(G) * sizeof(int4));
  p.off_short = take(static_cast<size_t>(p.n_tiles) * sizeof(int4));
  p.off_long = take(static_cast<size_t>(p.long_cap) * sizeof(int4));
  p.off_split = take(static_cast<size_t>(p.split_cap) * sizeof(int));
  p.off_done = take(static_cast<size_t>(p.split_cap) * std::max(p.n_cb, 1) * sizeof(int));
  p.off_live = take(static_cast<size_t>(p.n_tiles));
  p.off_gbuf = take(static_cast<size_t>(p.split_cap) * nc * kTile * n_dec * sizeof(float));
  p.off_partial = take(static_cast<size_t>(nc) * p.n_tiles * sizeof(float));
  p.bytes = off;
  return p;
}

struct Device {
  int sms = 0, smem_limit = 0;
};

Device device_info() {
  int dev = 0;
  Device d;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&d.smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  return d;
}

// CTAs of `kernel` an SM holds at this block size and dynamic shared memory,
// computed once per (kernel, device, size); the first call also lets the
// kernel take the device's whole opt-in shared memory.
int blocks_per_sm(const void* kernel, int threads, int smem) {
  struct Entry { const void* kernel; int dev, threads, smem, blocks; };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.kernel == kernel && e.dev == dev && e.threads == threads && e.smem == smem) return e.blocks;
  int limit = 0, blocks = 0;
  cudaFuncAttributes attr;
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           limit - static_cast<int>(attr.sharedSizeBytes)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) != cudaSuccess)
    return -1;
  cache.push_back({kernel, dev, threads, smem, blocks});
  return blocks;
}

int grid_for(long long need, int sms, int per_sm) {
  return static_cast<int>(std::max<long long>(
      1, std::min<long long>(need, static_cast<long long>(sms) * std::max(per_sm, 1))));
}

template <int DELTA>
cudaError_t launch_delta(const int* x_t, const int* r, const int* d, const float* w,
                         char* ws, float* raw, int nc, int G, int V, int n_bins,
                         int n_dec, const Plan& p, int sms, cudaStream_t stream) {
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

  const auto short_kernel = short_tiles_kernel<DELTA>;
  const auto long_kernel = long_tiles_kernel<DELTA>;
  const int long_smem = p.bc * (kTile * n_dec + kTile) * static_cast<int>(sizeof(float));
  const int short_per_sm = blocks_per_sm(reinterpret_cast<const void*>(short_kernel), kShortThreads, 0);
  const int long_per_sm = blocks_per_sm(reinterpret_cast<const void*>(long_kernel), kLongThreads, long_smem);
  if (short_per_sm < 0 || long_per_sm < 0) return cudaErrorInvalidValue;

  cudaError_t err = cudaMemsetAsync(start, 0, (static_cast<size_t>(p.n_keys) + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int flat_blocks = std::max(1, std::min((G + 255) / 256, sms * 8));
  if (G > 0) {
    count_kernel<<<flat_blocks, 256, 0, stream>>>(r, d, w, start, G, p.n_cls, V, n_dec);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  plan_kernel<<<1, kPlanThreads, 0, stream>>>(start, cursor, p.n_keys, p.n_tiles, p.S, p.chunk,
                                              short_items, long_items, split_chunks, tile_live,
                                              counters);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t slot_words4 = static_cast<size_t>(nc) * kTile * n_dec / 4;
  scatter_kernel<<<flat_blocks, 256, 0, stream>>>(
      r, d, w, cursor, sorted, G, p.n_cls, V, n_dec, counters,
      reinterpret_cast<float4*>(gbuf), slot_words4, done, p.n_cb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long short_need = (static_cast<long long>(p.n_tiles) * p.n_cb + 7) / 8;
  short_kernel<<<grid_for(short_need, sms, short_per_sm), kShortThreads, 0, stream>>>(
      x_t, sorted, short_items, counters, partial, nc, G, V, n_bins, n_dec, p.n_tiles, p.bc,
      p.n_cb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  long_kernel<<<grid_for(static_cast<long long>(p.long_cap) * p.n_cb, sms, long_per_sm),
                kLongThreads, long_smem, stream>>>(x_t, sorted, long_items, counters,
                                                   split_chunks, done, gbuf, partial, nc, G, V,
                                                   n_bins, n_dec, p.n_tiles, p.bc, p.n_cb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ordered_sum_kernel<<<nc, 256, 0, stream>>>(partial, tile_live, counters, raw, p.n_tiles);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch sweep_theta_launch needs for these shapes (0: the shapes
// do not fit a block's shared memory).
extern "C" size_t sweep_theta_workspace_bytes(int nc, int G, int v_max, int n_bins, int n_dec) {
  const Plan p = make_plan(nc, G, v_max, n_bins, n_dec, device_info().smem_limit);
  return p.bc > 0 ? p.bytes : 0;
}

// x_t [nc, G], r_ids/d [G] int32, w [G] f32, raw [nc] f32, workspace of
// sweep_theta_workspace_bytes(...) bytes (16-byte aligned); all on the
// stream's device.  Requires nc >= 1, n_bins >= 1, v_max >= 1.
extern "C" cudaError_t sweep_theta_launch(const void* x_t, const void* r_ids, const void* d,
                                          const void* w, void* workspace, void* raw, int nc,
                                          int G, int v_max, int n_bins, int n_dec, int delta,
                                          void* stream) {
  if (nc < 1 || n_bins < 1 || v_max < 1 || n_dec < 1 || G < 0) return cudaErrorInvalidValue;
  const Device dev = device_info();
  const Plan p = make_plan(nc, G, v_max, n_bins, n_dec, dev.smem_limit);
  if (p.bc < 1) return cudaErrorInvalidValue;
  const auto* xt = static_cast<const int*>(x_t);
  const auto* r = static_cast<const int*>(r_ids);
  const auto* dd = static_cast<const int*>(d);
  const auto* ww = static_cast<const float*>(w);
  auto* ws = static_cast<char*>(workspace);
  auto* out = static_cast<float*>(raw);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (delta) {
    case repro::kPR: return launch_delta<repro::kPR>(xt, r, dd, ww, ws, out, nc, G, v_max, n_bins, n_dec, p, dev.sms, s);
    case repro::kSCE: return launch_delta<repro::kSCE>(xt, r, dd, ww, ws, out, nc, G, v_max, n_bins, n_dec, p, dev.sms, s);
    case repro::kLCE: return launch_delta<repro::kLCE>(xt, r, dd, ww, ws, out, nc, G, v_max, n_bins, n_dec, p, dev.sms, s);
    case repro::kCCE: return launch_delta<repro::kCCE>(xt, r, dd, ww, ws, out, nc, G, v_max, n_bins, n_dec, p, dev.sms, s);
    default: return cudaErrorInvalidValue;
  }
}
