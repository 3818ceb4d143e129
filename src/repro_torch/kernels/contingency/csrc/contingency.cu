// Batched contingency kernel for Hopper (sm_90a): plan backend "pallas".
//
// Replaces the TPU kernel `contingency_pallas` / `_contingency_kernel` of
// src/repro/kernels/contingency/kernel.py (wrapper ops.contingency):
//   counts[c, k, j] = Σ_g w_g · 1[packed[c, g] = k] · 1[d_g = j]
// The TPU computes it as a one-hot [BK, BG] @ [BG, M] matmul because it has
// no fast atomics (kernel.py:11-13) and pads M to 128 lanes (ops.py:36-44).
// Neither applies here: one thread per (c, g) does a global atomicAdd of w_g
// into out[c, p, d_g], and the decision axis is n_dec wide.
//
// What bounds it on this card: writing the [nc, n_bins, n_dec] f32 output
// (the wrapper's zero fill) and reading packed [nc, G]; the adds are one per
// granule.  The launch shape is the tiling's (kernels/contingency/
// autotune.py, kernel "contingency"): `threads` a CTA and a grid of at most
// `ctas` CTAs an SM, each striding over the (c, g) pairs (pinned: 256
// and 64).  Counts are integer-valued f32 below 2^24 (DESIGN.md §3.1), so
// the atomics' order cannot change a bit: the result equals the plain
// scatter-add bit for bit.  Keys outside [0, n_bins) — the -1 padding
// sentinel — and zero weights are skipped.
#include "common.cuh"

namespace {

__global__ void contingency_kernel(const int* __restrict__ packed,
                                   const int* __restrict__ d,
                                   const float* __restrict__ w,
                                   float* __restrict__ out, int nc, int G,
                                   int n_bins, int n_dec) {
  const long long total = static_cast<long long>(nc) * G;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int g = static_cast<int>(i % G);
    const float wg = w[g];
    if (wg == 0.f) continue;
    const int p = packed[i];
    if (p < 0 || p >= n_bins) continue;
    const int dg = d[g];
    if (dg < 0 || dg >= n_dec) continue;
    const long long c = i / G;
    atomicAdd(out + (c * n_bins + p) * n_dec + dg, wg);
  }
}

}  // namespace

// `out` must be zero-filled [nc, n_bins, n_dec] f32 on the stream's device;
// threads a multiple of 32 up to 1,024, ctas >= 1.
extern "C" cudaError_t contingency_launch(const void* packed, const void* d,
                                          const void* w, void* out, int nc,
                                          int G, int n_bins, int n_dec,
                                          int threads, int ctas, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || ctas < 1)
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(nc) * G;
  if (total == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = static_cast<long long>(sms) * ctas;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  contingency_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), static_cast<const int*>(d),
      static_cast<const float*>(w), static_cast<float*>(out), nc, G, n_bins,
      n_dec);
  return cudaGetLastError();
}
