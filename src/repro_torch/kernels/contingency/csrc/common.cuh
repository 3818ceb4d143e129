// Shared pieces of the contingency kernels: the plain C error interface and
// the θ' row epilogues of the four measures (repro_torch/core/measures.py).
//
// Built with --fmad=false (kernels/build.py): every product and
// sum below rounds on its own, as the plain PyTorch version's elementwise
// ops do, so a row's θ' matches the plain version up to the order of the
// sums over the decision axis.  No --use_fast_math: logf must stay the
// accurate one, or the argmin tie band would start deciding differently.
#pragma once

#include <cuda_runtime.h>

namespace repro {

// Bin tile of the Θ kernels: plan.LADDER_TILE, one thread per bin row.
constexpr int kTile = 256;

enum Measure : int { kPR = 0, kSCE = 1, kLCE = 2, kCCE = 3 };

// θ'_δ of one contingency row, in three steps that the dense row_theta and
// the sweep kernel's sparse rows (sweep_theta.cu) share, so that both give
// the same bits: with e the row's sum and mx its largest count,
//   θ' = row_finish(Σ_j cell_term(c_j, row_ctx(e)), e, mx),
// the cell terms added one at a time in ascending decision order.  A zero
// cell's term is +0, so a sum over the non-zero cells alone has the same
// bits.  Counts are integer-valued f32, exact below 2^24.

// The row's constant of its cell terms: log e for SCE (log 1 for an empty
// row), e for the others.
template <int DELTA>
__device__ __forceinline__ float row_ctx(float e) {
  if constexpr (DELTA == kSCE) return logf(e > 0.f ? e : 1.f);
  return e;
}

// One cell's term, for a cell of count c >= 0; +0 for c = 0, and for PR.
template <int DELTA>
__device__ __forceinline__ float cell_term(float c, float ctx) {
  if constexpr (DELTA == kSCE) {
    return c > 0.f ? c * (logf(c) - ctx) : 0.f;
  } else if constexpr (DELTA == kLCE) {
    return c * (ctx - c);
  } else if constexpr (DELTA == kCCE) {
    return c * c * fmaxf(c - 1.f, 0.f);
  } else {
    return 0.f;  // PR needs no terms
  }
}

// θ' from the sum of the cell terms `acc`, the row's sum e and its max mx.
template <int DELTA>
__device__ __forceinline__ float row_finish(float acc, float e, float mx) {
  if constexpr (DELTA == kPR) {
    return (mx == e && e > 0.f) ? e : 0.f;
  } else if constexpr (DELTA == kCCE) {
    return e * e * fmaxf(e - 1.f, 0.f) - acc;
  } else {
    return acc;
  }
}

// θ'_δ of a dense row `row[0..m)`.  An all-zero row gives exactly 0 for
// every measure.
template <int DELTA>
__device__ __forceinline__ float row_theta(const float* row, int m) {
  float e = 0.f;
  float mx = 0.f;  // counts are >= 0, so 0 is the identity of max here
  for (int j = 0; j < m; ++j) {
    e += row[j];
    mx = fmaxf(mx, row[j]);
  }
  float acc = 0.f;
  if constexpr (DELTA != kPR) {
    const float ctx = row_ctx<DELTA>(e);
    for (int j = 0; j < m; ++j) acc += cell_term<DELTA>(row[j], ctx);
  }
  return row_finish<DELTA>(acc, e, mx);
}

// θ'_δ of a row whose one non-zero cell holds c > 0: the closed form of
// row_theta for that row.  e = mx = c, so PR gives c; every other measure's
// terms cancel to exactly +0 (SCE: c·(log c − log c); LCE: c·(c − c);
// CCE: c²·max(c − 1, 0) minus the same product).
template <int DELTA>
__device__ __forceinline__ float single_theta(float c) {
  if constexpr (DELTA == kPR) return c > 0.f ? c : 0.f;
  return 0.f;
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
