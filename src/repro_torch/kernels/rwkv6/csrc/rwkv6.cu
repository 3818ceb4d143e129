// RWKV6 (Finch) recurrence for Hopper (sm_90a): every RWKV time-mix call.
//
// Replaces the TPU kernel `rwkv6_scan` / `_rwkv6_kernel` of
// src/repro/kernels/rwkv6/kernel.py (wrapper ops.rwkv6).  Per (b, h), with
// the f32 state S [D, D] (row i: key channel, column j: value channel):
//   o_t[j] = Σ_i r_t[i] · (S[i][j] + u[i] · k_t[i] · v_t[j])
//   S[i][j] <- w_t[i] · S[i][j] + k_t[i] · v_t[j]
// with the decay in linear space, as the TPU kernel keeps it.
//
// Design.  Column j of S depends only on v_t[j], so one thread owns one
// column and keeps S[:, j] (D floats) in registers: the update needs no
// cross-thread reduction.  A CTA holds `cols` columns of one (b, h); the
// wrapper splits the D columns over 1, 2 or 4 CTAs so that a single request
// (B·H = 40 at rwkv6-3b) still spreads over the SMs.  Tokens loop inside
// the CTA (no chunk axis, no padding): the CTA stages 32 tokens of r, k, v,
// w in shared memory, then every thread walks them, reading r, k, w and u as
// float4 broadcasts.  A CTA has as few as 16 threads, so the staging keeps
// 16 loads in flight a thread (16-byte loads where the operands are 16-byte
// aligned): with one load at a time, a stage cost ~2,400 cycles a token.
// The output sum runs in four partial sums (one per float4 lane) to shorten
// its dependency chain.  Decode (T = 1) launches the same kernel.
//
// What bounds it on this card: ~7·D² f32 operations per token and head
// against one read of r, k, v, w, one write of o and one read and write of
// the state.  In practice the per-token chain of D dependent steps in each
// thread bounds it (latency, not bandwidth or issue rate).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStage = 32;  // tokens staged in shared memory at a time
constexpr int kInFlight = 4;  // staging iterations a thread keeps in flight

// Copy `count` elements of type V (float or float4) of r, k, w, v from
// global to shared memory: every thread issues kInFlight iterations' loads
// (four arrays each) before it stores any of them.
template <typename V>
__device__ __forceinline__ void stage(const float* r, const float* k, const float* w,
                                      const float* v, float* rs, float* ks, float* ws,
                                      float* vs, int count, int tid, int cols) {
  const V* src[4] = {reinterpret_cast<const V*>(r), reinterpret_cast<const V*>(k),
                     reinterpret_cast<const V*>(w), reinterpret_cast<const V*>(v)};
  V* dst[4] = {reinterpret_cast<V*>(rs), reinterpret_cast<V*>(ks),
               reinterpret_cast<V*>(ws), reinterpret_cast<V*>(vs)};
  for (int base = tid; base < count; base += kInFlight * cols) {
    V buf[kInFlight][4];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int e = base + i * cols;
      if (e < count) {
#pragma unroll
        for (int a = 0; a < 4; ++a) buf[i][a] = src[a][e];
      }
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int e = base + i * cols;
      if (e < count) {
#pragma unroll
        for (int a = 0; a < 4; ++a) dst[a][e] = buf[i][a];
      }
    }
  }
}

template <int D>
__global__ void rwkv6_kernel(const float* __restrict__ r,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ w,
                             const float* __restrict__ u,
                             const float* __restrict__ s0,
                             float* __restrict__ o, float* __restrict__ s_out,
                             int H, int T, int cols, bool aligned) {
  constexpr int D4 = D / 4;
  __shared__ __align__(16) float rs[kStage * D];
  __shared__ __align__(16) float ks[kStage * D];
  __shared__ __align__(16) float ws[kStage * D];
  __shared__ __align__(16) float vs[kStage * D];
  __shared__ __align__(16) float us[D];

  const int bh = blockIdx.x;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int j = blockIdx.y * cols + tid;  // the column this thread owns
  const size_t seq = static_cast<size_t>(bh) * T * D;
  const size_t st = static_cast<size_t>(bh) * D * D;

  float S[D];
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = s0[st + static_cast<size_t>(i) * D + j];
  for (int e = tid; e < D; e += cols) us[e] = u[h * D + e];

  for (int t0 = 0; t0 < T; t0 += kStage) {
    const int n = min(kStage, T - t0);
    __syncthreads();  // the previous stage has been read
    const size_t g = seq + static_cast<size_t>(t0) * D;
    if (aligned)
      stage<float4>(r + g, k + g, w + g, v + g, rs, ks, ws, vs, n * D / 4, tid, cols);
    else
      stage<float>(r + g, k + g, w + g, v + g, rs, ks, ws, vs, n * D, tid, cols);
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt * D + j];
      const float4* r4 = reinterpret_cast<const float4*>(rs + tt * D);
      const float4* k4 = reinterpret_cast<const float4*>(ks + tt * D);
      const float4* w4 = reinterpret_cast<const float4*>(ws + tt * D);
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < D4; ++c) {
        const float4 rr = r4[c], kk = k4[c], ww = w4[c], uu = u4[c];
        float kv;
        kv = kk.x * vj; a0 = fmaf(rr.x, fmaf(uu.x, kv, S[4 * c + 0]), a0);
        S[4 * c + 0] = fmaf(ww.x, S[4 * c + 0], kv);
        kv = kk.y * vj; a1 = fmaf(rr.y, fmaf(uu.y, kv, S[4 * c + 1]), a1);
        S[4 * c + 1] = fmaf(ww.y, S[4 * c + 1], kv);
        kv = kk.z * vj; a2 = fmaf(rr.z, fmaf(uu.z, kv, S[4 * c + 2]), a2);
        S[4 * c + 2] = fmaf(ww.z, S[4 * c + 2], kv);
        kv = kk.w * vj; a3 = fmaf(rr.w, fmaf(uu.w, kv, S[4 * c + 3]), a3);
        S[4 * c + 3] = fmaf(ww.w, S[4 * c + 3], kv);
      }
      o[seq + static_cast<size_t>(t0 + tt) * D + j] = (a0 + a1) + (a2 + a3);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) s_out[st + static_cast<size_t>(i) * D + j] = S[i];
}

template <int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* o, void* s_out, int BH,
                   int H, int T, int split, cudaStream_t stream) {
  if (split < 1 || D % split != 0) return cudaErrorInvalidValue;
  const int cols = D / split;
  // D is a multiple of 4, so every (b, h, token) row of an aligned operand
  // starts on a 16-byte boundary
  const bool aligned = ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) %
                        16) == 0;
  rwkv6_kernel<D><<<dim3(BH, split), cols, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(s_out), H, T, cols, aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r, k, v, w, o [BH, T, D], u [H, D], s0 and s_out [BH, D, D]: contiguous f32
// (BH = B·H, b-major).  The D columns go to `split` CTAs of D / split threads.
extern "C" cudaError_t rwkv6_launch(const void* r, const void* k, const void* v,
                                    const void* w, const void* u,
                                    const void* s0, void* o, void* s_out,
                                    int BH, int H, int T, int D, int split,
                                    void* stream) {
  if (BH == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 4: return launch<4>(r, k, v, w, u, s0, o, s_out, BH, H, T, split, s);
    case 8: return launch<8>(r, k, v, w, u, s0, o, s_out, BH, H, T, split, s);
    case 16: return launch<16>(r, k, v, w, u, s0, o, s_out, BH, H, T, split, s);
    case 32: return launch<32>(r, k, v, w, u, s0, o, s_out, BH, H, T, split, s);
    case 64: return launch<64>(r, k, v, w, u, s0, o, s_out, BH, H, T, split, s);
    default: return cudaErrorInvalidValue;
  }
}
