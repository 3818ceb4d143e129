// Flash-attention forward for Hopper (sm_90a): the LM prefill's attention.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py (wrapper ops.flash_attention):
// softmax(q kᵀ · scale) v over q [B, Hq, Sq, Dh] and k, v [B, Hkv, Skv, Dh],
// with GQA (query head h reads kv head h / group, never a repeated kv),
// causal and sliding-window masks aligned to the sequence end (query i sits
// at absolute position skv - sq + i) and an f32 online softmax.  A row that
// sees no key writes 0.
//
// Design.  One CTA of 256 threads per (b, query head, 64-row q tile).  The
// q tile sits in shared memory as f32; 64-row k and v tiles stream through
// shared memory.  The 16 x 16 thread grid gives each thread 4 query rows
// (ty + 16 i) and 4 score columns (tx + 16 j) of the [64, 64] score tile,
// then the same 4 rows and Dh/16 output columns (tx + 16 j) of the f32
// accumulator, which stays in registers.  A row's max and sum are reduced
// over the 16 lanes of one half warp.  Every product and sum is f32 on the
// CUDA cores, as the TPU kernel casts q, k, v to f32 before both products.
//
// The recurrence is the TPU kernel's: m' = max(m, rowmax s); alpha = 0 while
// m is the -1e30 sentinel, else exp(m - m'); p = exp(s - m') on visible keys,
// 0 elsewhere; l' = alpha l + Σp; acc' = alpha acc + p v; out = acc / max(l,
// 1e-30).  A kv tile that lies wholly past the causal edge or wholly before
// the window leaves m, l and acc unchanged in that recurrence, so skipping
// it is exact: the CTA walks only the tiles its rows can see.
//
// What bounds it on this card: the 4·Hq·Dh operations per visible (query,
// key) pair on the f32 CUDA cores (67 TFLOP/s), far above the bytes of q, k,
// v and o at prefill lengths; the shared-memory reads of the inner products
// (8 loads per 16 FMAs) keep it well below that peak.  Tensor cores, TMA and
// wgmma are left to a later change: a bf16 mma would round p where the TPU
// kernel keeps it in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;      // a 16 x 16 thread grid
constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBKV = 64;           // kv rows per tile
constexpr int kRows = kBQ / 16;    // query rows per thread
constexpr int kCols = kBKV / 16;   // score columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int DH>
constexpr int smem_bytes() {
  // q and k tiles padded to DH + 1 floats a row (no bank conflicts when 16
  // threads read 16 rows at one column), v unpadded, p padded to kBKV + 1
  return static_cast<int>(sizeof(float)) *
         (kBQ * (DH + 1) + kBKV * (DH + 1) + kBKV * DH + kBQ * (kBKV + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
                 int sq, int skv, float scale, int causal, int window) {
  constexpr int QS = DH + 1;
  constexpr int PS = kBKV + 1;
  constexpr int DC = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][QS]
  float* ks = qs + kBQ * QS;    // [kBKV][QS]
  float* vs = ks + kBKV * QS;   // [kBKV][DH]
  float* ps = vs + kBKV * DH;   // [kBQ][PS]

  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = iq * kBQ;
  const int offset = skv - sq;  // absolute position of query row 0

  const T* qg = q + static_cast<size_t>(b * hq + h) * sq * DH;
  const T* kg = k + static_cast<size_t>(b * hkv + hk) * skv * DH;
  const T* vg = v + static_cast<size_t>(b * hkv + hk) * skv * DH;
  T* og = o + static_cast<size_t>(b * hq + h) * sq * DH;

  // rows past sq are zeros: computed like any row, never written
  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    qs[r * QS + c] = (q0 + r < sq) ? to_f32(qg[static_cast<size_t>(q0 + r) * DH + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // the keys any real row of this tile can see: tiles outside are skipped
  const int q_first = q0 + offset;
  const int q_last = min(q0 + kBQ, sq) - 1 + offset;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int t_begin = k_begin / kBKV;
  const int t_end = (k_end + kBKV - 1) / kBKV;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();  // every read of the previous tile is done
    for (int e = tid; e < kBKV * DH; e += kThreads) {
      const int r = e / DH, c = e % DH;
      const bool in = k0 + r < skv;
      const size_t gi = static_cast<size_t>(k0 + r) * DH + c;
      ks[r * QS + c] = in ? to_f32(kg[gi]) : 0.f;
      vs[r * DH + c] = in ? to_f32(vg[gi]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty + 16 * i + offset;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < skv && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = (m[i] == kNegInf) ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      // xor butterfly: every lane of the half warp ends with the same sum
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    // a row's p was written by the 16 lanes of its own half warp
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[kRows], vv[DC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      og[static_cast<size_t>(row) * DH + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int hq, int hkv, int sq, int skv, float scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH>();
  static_assert(bytes <= 232448, "tiles exceed a block's shared memory");
  auto kernel = flash_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, skv, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, const void* q, const void* k, const void* v,
                     void* o, int b, int hq, int hkv, int sq, int skv,
                     float scale, int causal, int window, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 256: return launch<T, 256>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [b, hq, sq, dh], k/v [b, hkv, skv, dh], o like q: contiguous, all f32
// (is_bf16 = 0) or all bf16 (is_bf16 = 1).  window <= 0 means no window.
extern "C" cudaError_t flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int b, int hq,
    int hkv, int sq, int skv, int dh, int is_bf16, float scale, int causal,
    int window, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch<__nv_bfloat16>(dh, q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s)
      : dispatch<float>(dh, q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
}
