// The segment half of the two Θ kernels (sweep_theta.cu, fused_theta.cu):
// once a launch has ordered its live granules so that every (256-bin tile,
// candidate set) reads one contiguous segment of an ordered list, these
// kernels turn the segments into raw Θ' [nc].
//
// * short_tiles_kernel: one warp per (segment of at most kShortMax entries,
//   candidate block), one entry a lane.  Entries of one row, and of one
//   cell, find each other with __match_any_sync; only rows an entry touches
//   get a θ', built from their cells alone (no dense row is zeroed or read),
//   and a row of one entry in closed form.
// * long_tiles_kernel: one CTA per (chunk of a longer segment, candidate
//   block), with bc dense [256, n_dec] histograms in shared memory.  A
//   segment cut into several chunks adds its non-zero counts into a global
//   per-segment buffer; the last chunk to finish (a ticket counter) runs the
//   epilogue.
// * ordered_sum_kernel: raw[c] = ((0 + p0) + p1) + ... over the tiles in
//   ascending order, one f32 add at a time; never float atomics across tiles.
//
// The ordering itself is each kernel's own (the sweep orders granules once
// by the tile bucket of their class, the fused kernel each candidate's keys
// by their tile), and so is the segment source, a template parameter that
// says what an entry of the ordered list holds:
//
//   struct Source {
//     using Entry = ...;                       // one entry of the ordered list
//     Entry load(int i) const;                 // entry i
//     static Entry none();                     // an entry that counts nothing
//     static bool valid(const Entry&);
//     static float weight(const Entry&);       // w_g
//     static int dec(const Entry&);            // d_g
//     int tile(int seg) const;                 // the 256-bin tile of a segment
//     int first_cand(int seg, int cb, int bc) const;  // its first candidate
//     // keys p - lo of a valid entry for candidates c0 .. c0 + nk - 1
//     // (nk <= BC); a key outside [0, 256) is dropped by the caller
//     template <int BC>
//     void keys(const Entry&, int c0, int nk, int lo, int (&p)[BC]) const;
//   };
//
// An item of the work lists is int4 {segment, begin, end, split slot (-1:
// not split)}; n_cb candidate blocks of bc candidates each read it.  A
// (candidate, tile) partial is written by exactly one warp or CTA.
//
// The launch shape is the caller's (the tiling of kernels/contingency/
// autotune.py): bc, the candidates that share one read of an entry, at most
// the template's BC (instances 1, 2, 4 and 8), and the chunk of a long
// segment, in the caller's work lists.  Neither changes a bit: a partial
// is a function of its (candidate, tile) contingency alone (below).  The
// 256-bin tile itself is not a knob: the plain versions and the ladder
// share it.
//
// Every count is an integer-valued f32 below 2^24, so the order of the adds
// that build it (atomics, merges, the order inside a segment) cannot change
// a bit.  A row's θ' is built on both paths from the pieces row_theta is
// made of (common.cuh: row_ctx, cell_term, row_finish; single_theta for a
// row of one entry), its cell terms summed in ascending decision order (a
// zero cell's term is +0, and an all-zero row's θ' is exactly 0), placed at
// the row's index in a 256-entry array and summed by tile_sum256's fixed
// order.  So a tile's partial is a function of its contingency alone: the
// same on every run, at every ladder rung, and from either ordering
// (DESIGN.md §5.3).
#pragma once

#include <algorithm>
#include <mutex>
#include <vector>

#include "common.cuh"

namespace repro {

constexpr int kShortMax = 32;        // entries of a short segment: one a lane
constexpr int kMaxBC = 8;            // the largest bc instance: a long CTA's 8 warps sum 8 tiles
constexpr int kLongThreads = kTile;  // one thread per bin row in the dense epilogue
constexpr int kShortThreads = 256;
constexpr int kPlanThreads = 1024;
constexpr int kSumSlab = 4096;       // partials staged at a time by ordered_sum_kernel
constexpr int kUnroll = 4;           // entries a thread loads at once in the long path

// counters[]: what an ordering's plan found
enum Counter : int { kNShort = 0, kNLong = 1, kNSplit = 2, kNLive = 3, kNCounters = 4 };

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

// Exclusive scan of one int a thread across a block of kPlanThreads.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
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

// ------------------------------------------------------------------ tiles

// One warp per (short segment, candidate block), lane i holding the
// segment's entry i.  Shared memory per warp: red[256] (row values; 0 where
// no entry falls, restored after each candidate by the lanes that wrote it)
// and, per lane, its weight, and its cell's term, count and decision.
template <int DELTA, class Src, int BC>
__global__ void __launch_bounds__(kShortThreads)
short_tiles_kernel(Src src, const int4* __restrict__ items, const int* __restrict__ counters,
                   float* __restrict__ partial, int nc, int n_bins, int n_dec, int n_tiles,
                   int bc, int n_cb) {
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
    const int tile = src.tile(item.x);
    const int c0 = src.first_cand(item.x, cb, bc);
    const int nk = min(bc, nc - c0);
    const int lo = tile * kTile;
    const int nb = min(kTile, n_bins - lo);
    const bool has = item.y + lane < item.z;
    const typename Src::Entry s = has ? src.load(item.y + lane) : Src::none();
    const float wg = Src::weight(s);
    const int dg = Src::dec(s);
    int pk[BC];
    if (has) {
      src.keys(s, c0, nk, lo, pk);
    } else {
#pragma unroll
      for (int k = 0; k < BC; ++k) pk[k] = -1;
    }
#pragma unroll
    for (int k = 0; k < BC; ++k) {
      if (k >= nk) break;  // warp-uniform
      const int c = c0 + k;
      const int p = pk[k];
      const bool ok = has && static_cast<unsigned>(p) < static_cast<unsigned>(nb);
      // lanes of one row; a row of one entry is not built: its θ' is
      // single_theta of the weight
      const unsigned row = __match_any_sync(0xffffffffu, ok ? p : -1 - lane);
      const bool multi = ok && __popc(row) > 1;
      if (__any_sync(0xffffffffu, multi)) {
        // lanes of one cell (row, decision); others unique
        const unsigned cell = __match_any_sync(0xffffffffu, multi ? p * n_dec + dg : -1 - lane);
        wbuf[lane] = multi ? wg : 0.f;
        __syncwarp();
        float e = 0.f;  // the row's sum
        if (multi) {
          float cnt = 0.f;  // integer-valued sums: any order gives the same bits
          for (unsigned m = cell; m; m &= m - 1) cnt += wbuf[__ffs(m) - 1];
          for (unsigned m = row; m; m &= m - 1) e += wbuf[__ffs(m) - 1];
          const bool cell_lead = lane == __ffs(cell) - 1;
          tbuf[lane] = cell_lead ? cell_term<DELTA>(cnt, row_ctx<DELTA>(e)) : 0.f;
          cbuf[lane] = cell_lead ? cnt : 0.f;
          dbuf[lane] = cell_lead ? dg : -1;
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
          red[p] = row_finish<DELTA>(acc, e, mx);
        }
      }
      if (ok && !multi) red[p] = single_theta<DELTA>(wg);
      __syncwarp();
      const float v = tile_sum256(red, lane);
      if (lane == 0) partial[static_cast<size_t>(c) * n_tiles + tile] = v;
      __syncwarp();
      if (ok) red[p] = 0.f;
      __syncwarp();
    }
  }
}

// One CTA of kLongThreads per (chunk of a long segment, candidate block).
// Shared memory: hist[bc][256 * n_dec], red[bc][256].  A split segment's
// buffer in gbuf is bc histograms at ((slot·n_cb + cb)·bc)·256·n_dec.
template <int DELTA, class Src, int BC>
__global__ void __launch_bounds__(kLongThreads)
long_tiles_kernel(Src src, const int4* __restrict__ items, const int* __restrict__ counters,
                  const int* __restrict__ split_chunks, int* __restrict__ done,
                  float* __restrict__ gbuf, float* __restrict__ partial, int nc, int n_bins,
                  int n_dec, int n_tiles, int bc, int n_cb) {
  extern __shared__ float hist[];
  __shared__ int last;
  const int hsize = kTile * n_dec;
  float* red = hist + static_cast<size_t>(bc) * hsize;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int n_items = counters[kNLong] * n_cb;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int4 item = items[it / n_cb];
    const int cb = it % n_cb;
    const int tile = src.tile(item.x);
    const int c0 = src.first_cand(item.x, cb, bc);
    const int nk = min(bc, nc - c0);
    const int lo = tile * kTile;
    const int nb = min(kTile, n_bins - lo);
    const int words = nk * hsize;  // a multiple of 256: float4-aligned

    float4* h4 = reinterpret_cast<float4*>(hist);
    for (int i = tid; i < words / 4; i += kLongThreads) h4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    // kUnroll entries a thread at once, so their loads are in flight together
    for (int i0 = item.y + tid; i0 < item.z; i0 += kUnroll * kLongThreads) {
      typename Src::Entry s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kLongThreads;
        s[u] = i < item.z ? src.load(i) : Src::none();
      }
      int p[kUnroll][BC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (Src::valid(s[u])) {
          src.keys(s[u], c0, nk, lo, p[u]);
        } else {
#pragma unroll
          for (int k = 0; k < BC; ++k) p[u][k] = -1;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!Src::valid(s[u])) continue;
        const float wg = Src::weight(s[u]);
        const int dg = Src::dec(s[u]);
#pragma unroll
        for (int k = 0; k < BC; ++k) {
          if (k < nk && static_cast<unsigned>(p[u][k]) < static_cast<unsigned>(nb))
            atomicAdd(&hist[k * hsize + p[u][k] * n_dec + dg], wg);
        }
      }
    }
    __syncthreads();

    bool finish = true;
    if (item.w >= 0) {  // one chunk of a split segment: merge, the last one finishes
      float* g = gbuf + (static_cast<size_t>(item.w) * n_cb + cb) * bc * hsize;
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
        red[k * kTile + tid] = row_theta<DELTA>(&hist[k * hsize + tid * n_dec], n_dec);
      __syncthreads();
      if (warp < nk) {
        const float v = tile_sum256(&red[warp * kTile], lane);
        if (lane == 0) partial[static_cast<size_t>(c0 + warp) * n_tiles + tile] = v;
      }
    }
    __syncthreads();  // hist and red are reused by the next item
  }
}

// raw[c] = ((0 + p0) + p1) + ... in ascending tile order up to the last live
// tile (counters[kNLive]); one CTA a candidate, its partials staged in shared
// memory for the serial chain.  With `tile_live`, a tile it marks empty is
// read as +0 (its partial was never written); without, every partial up to
// the last live tile was written (+0 for an empty tile).
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
      b1[i] = (i < n && (tile_live == nullptr || tile_live[base + i])) ? row[base + i] : 0.f;
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

inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

struct Device {
  int sms = 0, smem_limit = 0;
};

inline Device device_info() {
  int dev = 0;
  Device d;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&d.smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  return d;
}

// Candidates a long-path CTA holds in shared memory: at most bc and nc;
// 0 when one [256, n_dec] histogram does not fit.
inline int candidates_per_block(int nc, int n_dec, int smem_limit, int bc) {
  const int per_cand = (kTile * n_dec + kTile) * static_cast<int>(sizeof(float));
  return std::min(std::min(bc, nc), smem_limit / per_cand);
}

// CTAs of `kernel` an SM holds at this block size and dynamic shared memory,
// computed once per (kernel, device, size); the first call also lets the
// kernel take the device's whole opt-in shared memory.
inline int blocks_per_sm(const void* kernel, int threads, int smem) {
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

inline int grid_for(long long need, int sms, int per_sm) {
  return static_cast<int>(std::max<long long>(
      1, std::min<long long>(need, static_cast<long long>(sms) * std::max(per_sm, 1))));
}

// Where an ordering left its work lists, and how large they may be.
struct SegmentLists {
  const int4* short_items;  // at most short_cap
  const int4* long_items;   // at most long_cap
  const int* counters;      // [kNCounters], filled by the ordering's plan
  const int* split_chunks;  // chunks of each split segment
  int* done;                // tickets, [split slots · n_cb], zeroed
  float* gbuf;              // split segments' histograms, zeroed
  const unsigned char* tile_live;  // see ordered_sum_kernel; may be null
  long long short_cap, long_cap;
};

// The short tiles, the long tiles, then the ordered sum into raw [nc]; bc <= BC.
template <int DELTA, int BC, class Src>
cudaError_t launch_segments(const Src& src, const SegmentLists& l, float* partial, float* raw,
                            int nc, int n_bins, int n_dec, int n_tiles, int bc, int n_cb,
                            int sms, cudaStream_t stream) {
  const auto short_kernel = short_tiles_kernel<DELTA, Src, BC>;
  const auto long_kernel = long_tiles_kernel<DELTA, Src, BC>;
  const int long_smem = bc * (kTile * n_dec + kTile) * static_cast<int>(sizeof(float));
  const int short_per_sm = blocks_per_sm(reinterpret_cast<const void*>(short_kernel), kShortThreads, 0);
  const int long_per_sm = blocks_per_sm(reinterpret_cast<const void*>(long_kernel), kLongThreads, long_smem);
  if (short_per_sm < 0 || long_per_sm < 0) return cudaErrorInvalidValue;
  cudaError_t err;
  short_kernel<<<grid_for((l.short_cap * n_cb + 7) / 8, sms, short_per_sm), kShortThreads, 0,
                 stream>>>(src, l.short_items, l.counters, partial, nc, n_bins, n_dec, n_tiles,
                           bc, n_cb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  long_kernel<<<grid_for(l.long_cap * n_cb, sms, long_per_sm), kLongThreads, long_smem,
                stream>>>(src, l.long_items, l.counters, l.split_chunks, l.done, l.gbuf,
                          partial, nc, n_bins, n_dec, n_tiles, bc, n_cb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ordered_sum_kernel<<<nc, 256, 0, stream>>>(partial, l.tile_live, l.counters, raw, n_tiles);
  return cudaGetLastError();
}

}  // namespace repro
