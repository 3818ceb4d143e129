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

// θ'_δ of one contingency row `row[0..m)` (counts are integer-valued f32,
// exact below 2^24).  An all-zero row gives exactly 0 for every measure.
template <int DELTA>
__device__ __forceinline__ float row_theta(const float* row, int m) {
  float e = 0.f;
  float mx = 0.f;  // counts are >= 0, so 0 is the identity of max here
  for (int j = 0; j < m; ++j) {
    e += row[j];
    mx = fmaxf(mx, row[j]);
  }
  if constexpr (DELTA == kPR) {
    return (mx == e && e > 0.f) ? e : 0.f;
  } else if constexpr (DELTA == kSCE) {
    const float le = logf(e > 0.f ? e : 1.f);
    float acc = 0.f;
    for (int j = 0; j < m; ++j) {
      const float c = row[j];
      if (c > 0.f) acc += c * (logf(c) - le);
    }
    return acc;
  } else if constexpr (DELTA == kLCE) {
    float acc = 0.f;
    for (int j = 0; j < m; ++j) {
      const float c = row[j];
      acc += c * (e - c);
    }
    return acc;
  } else {  // kCCE
    float acc = 0.f;
    for (int j = 0; j < m; ++j) {
      const float c = row[j];
      acc += c * c * fmaxf(c - 1.f, 0.f);
    }
    return e * e * fmaxf(e - 1.f, 0.f) - acc;
  }
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
