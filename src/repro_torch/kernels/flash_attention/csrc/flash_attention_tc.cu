// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 q, k, v:
// the LM prefill's attention.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py (wrapper ops.flash_attention)
// for bf16 inputs at head widths 64, 128 and 256: softmax(q kᵀ · scale) v
// over q [B, Hq, Sq, Dh] and k, v [B, Hkv, Skv, Dh], with GQA (query head h
// reads kv head h / group), causal and sliding-window masks aligned to the
// sequence end (query i sits at absolute position skv - sq + i) and an f32
// online softmax.  A row that sees no key writes 0.  f32 inputs, and bf16 at
// head widths 16 and 32, stay on flash_attention.cu's f32 kernel.
//
// Numerics.  S = Q·Kᵀ takes bf16 operands and accumulates in f32 (products
// of bf16 values are exact in f32), then the scale.  The recurrence is the
// TPU kernel's, in f32: m' = max(m, rowmax s); alpha = 0 while m is the
// -1e30 sentinel, else exp(m - m'); p = exp(s - m') on visible keys, 0
// elsewhere; l' = alpha l + Σp; acc' = alpha acc + p v; out = acc / max(l,
// 1e-30), with exp taken as exp2 of log2(e)-scaled scores.  p goes into the
// product with v as bf16 parts (below); l sums the f32 p.  The TPU kernel
// casts to f32 and calls jnp.dot(p, v, preferred_element_type=f32), and an
// f32 matmul at JAX's default precision is one bf16 pass of the MXU, so on
// its own chip it rounds p to bf16 there.  A kv tile wholly past the causal
// edge or before the window leaves m, l and acc unchanged, so skipping it is
// exact.
//
// Design.  One CTA per (b, query head, 64 query rows), heads varying
// fastest in the grid so that every head's longest causal rows start first:
// one consumer warpgroup, then one producer warp.  The producer's lane 0 starts TMA loads
// (3-D tensor maps over [B·H, S, Dh], 128-byte swizzle, rows past S
// zero-filled): the q tile once, then 64-key k and v tiles through a ring of
// kStages stages in shared memory, tracked by mbarriers (full: the TMA
// transaction bytes; empty: every consumer thread arrives when it is done
// with the stage), so later tiles load while the current ones are
// multiplied.  The warpgroup runs wgmma.mma_async m64n64k16 bf16 -> f32:
// S = Q·Kᵀ with Q and K from shared memory (K-major descriptors), and
// O += P·V with P in registers as the A operand (the accumulator layout of S
// is the A-fragment layout) and V from shared memory (an MN-major
// descriptor), Dh/64 products of 64 columns a k-step.  The products overlap
// the softmax: tile t's Q·Kᵀ and tile t-1's P·V start together, the
// softmax of tile t runs while P·V is still on the tensor cores, and only
// then is O rescaled.  Tiles that every row sees whole skip the mask.
//
// P as bf16 in one pass put elements past the port's per-element bf16 check
// against the plain version (|d| <= 1e-2·|plain| + 2e-3) on the card: the
// rounding of p and the rounding of the output add up to two bf16 steps.
// So p is split in two bf16 parts, hi = bf16(p) and lo = bf16(p - hi), and
// O += hi·V + lo·V: two products on the tensor cores, p carried with 16 bits
// of mantissa.
//
// What bounds it on this card: the 4·Hq·Dh operations per visible (query,
// key) pair on the bf16 tensor cores (989 TFLOP/s); at Dh = 64 the exp of
// every score on the SFU is of the same order.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;                 // query rows per CTA: one warpgroup
constexpr int kBKV = 64;                // keys per kv tile
constexpr int kBlock = 64 * 128;        // a column block: 64 rows x 64 bf16, 128-byte swizzled

template <int DH, int kStages>
struct Cfg {
  static constexpr int kNB = DH / 64;                   // 64-column blocks of a row
  static constexpr int kThreads = 128 + 32;             // the warpgroup, then the producer warp
  static constexpr int kTileBytes = kNB * kBlock;       // a q, k or v tile
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kSmem = 1024 + (1 + 2 * kStages) * kTileBytes + kBarBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  The spin is a
// loop inside the asm: a C++ loop on the per-thread result would look
// divergent to the compiler, which then serializes the wgmma that follow.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle: 8-row groups 1024 bytes
// apart (SBO); the leading offset is unused by these shapes.  A k-step of 16
// columns inside a 64-column block starts 32 bytes further into the atom.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; results below 2^-126 flush to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator registers across the async ops.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x64] (+)= A[64x16] · B[16x64]; A from shared memory (K-major), B K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] += A[64x16] · B[16x64]; A from registers (bf16 pairs), B MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (a, b) = hi + lo per element, hi = bf16(x) and lo = bf16(x - hi): the pair
// carries 16 bits of each p's mantissa into the tensor cores.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(a - __bfloat162float(h.x), b - __bfloat162float(h.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The kv tiles [t_begin, t_end) that query rows [r0, r1) can see.
__device__ __forceinline__ int2 tile_range(int r0, int r1, int offset, int skv, int causal,
                                           int window) {
  const int first = r0 + offset, last = r1 - 1 + offset;
  const int k_begin = window > 0 ? max(0, first - window + 1) : 0;
  const int k_end = causal ? min(skv, last + 1) : skv;
  const int t_begin = k_begin / kBKV;
  return make_int2(t_begin, max(t_begin, (k_end + kBKV - 1) / kBKV));
}

// ---- the online softmax of one tile

struct Rows {  // a thread's two rows: running max (log2 units) and sum
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
};

struct Mask {  // what decides whether a (query, key) pair is visible
  int qa, qb, col, skv, causal, window, q_first, q_last;
  float c2;  // scale · log2(e)
};

// Scores of the tile at keys [k0, k0 + 64) in sc (row a: e < 2, row b: e >=
// 2 of each 4), in place to p; the rows' m and l advance, alpha out.  A tile
// every row of the CTA sees whole skips the mask.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], int k0, const Mask& mk, Rows& st,
                                             float& alpha_a, float& alpha_b) {
  const bool whole = k0 + kBKV <= mk.skv && (!mk.causal || k0 + kBKV - 1 <= mk.q_first) &&
                     (mk.window <= 0 || k0 > mk.q_last - mk.window);
  uint32_t vis = 0xffffffffu;
  if (!whole) {
    vis = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + mk.col + (e & 1);
        const int qpos = e < 2 ? mk.qa : mk.qb;
        const bool ok = kpos < mk.skv && (!mk.causal || kpos <= qpos) &&
                        (mk.window <= 0 || kpos > qpos - mk.window);
        vis |= static_cast<uint32_t>(ok) << (4 * j + e);
      }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[4 * j + e] * mk.c2;
      sc[4 * j + e] = x;
      if ((vis >> (4 * j + e)) & 1) {
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    }
  // a row lives in the 4 lanes of a quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);  // the sentinel while unseen
  alpha_a = st.m_a == kNegInf ? 0.f : ex2(st.m_a - mn_a);
  alpha_b = st.m_b == kNegInf ? 0.f : ex2(st.m_b - mn_b);
  float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = (vis >> (4 * j + e)) & 1 ? ex2(sc[4 * j + e] - (e < 2 ? mn_a : mn_b)) : 0.f;
      sc[4 * j + e] = p;
      if (e < 2) rs_a += p; else rs_b += p;
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rs_a += __shfl_xor_sync(0xffffffffu, rs_a, off);
    rs_b += __shfl_xor_sync(0xffffffffu, rs_b, off);
  }
  st.l_a = alpha_a * st.l_a + rs_a;
  st.l_b = alpha_b * st.l_b + rs_b;
  st.m_a = mn_a;
  st.m_b = mn_b;
}

// ---- the kernel

// At Dh 64 the registers are capped so that three CTAs share an SM (a few
// bytes spill); the wider heads keep theirs.
template <int DH, int kStages>
__global__ void __launch_bounds__(Cfg<DH, kStages>::kThreads, DH == 64 ? 3 : 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o, int hq,
                int hkv, int sq, int skv, float scale, int causal, int window) {
  using C = Cfg<DH, kStages>;
  constexpr int NB = C::kNB;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms must start 1024-byte aligned
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + C::kTileBytes;
  uint8_t* sV = sK + kStages * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kTileBytes);
  uint64_t* kv_full = q_full + 1;          // [kStages]
  uint64_t* kv_empty = kv_full + kStages;  // [kStages]

  // heads vary fastest, so every head's longest causal rows start first
  const int h = blockIdx.x, iq = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = iq * kBQ;
  const int offset = skv - sq;  // absolute position of query row 0
  const int2 tiles = tile_range(q0, min(q0 + kBQ, sq), offset, skv, causal, window);
  // warpgroup 0 computes, warpgroup 1 (one warp) loads; read through a
  // shuffle so the compiler knows the branch is warp-uniform
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the producer warp leaves below

  if (role == 1) {  // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, C::kTileBytes);
      for (int j = 0; j < NB; ++j)
        tma_load(sQ + j * kBlock, &tm_q, q_full, j * 64, q0, b * hq + h);
      for (int t = tiles.x, i = 0; t < tiles.y; ++t, ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&kv_empty[s], ((i / kStages) - 1) & 1);
        mbar_expect_tx(&kv_full[s], 2 * C::kTileBytes);
        for (int j = 0; j < NB; ++j) {
          tma_load(sK + s * C::kTileBytes + j * kBlock, &tm_k, &kv_full[s], j * 64, t * kBKV,
                   b * hkv + hk);
          tma_load(sV + s * C::kTileBytes + j * kBlock, &tm_v, &kv_full[s], j * 64, t * kBKV,
                   b * hkv + hk);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows are row_a = q0 + 16·warp +
  // lane / 4 and row_b = row_a + 8, its columns of every 8-column chunk col
  // and col + 1 (the wgmma accumulator layout)
  const int row_a = q0 + 16 * warp + lane / 4, row_b = row_a + 8;
  const int qa = row_a + offset, qb = row_b + offset;
  const int col = 2 * (lane % 4);
  const int q_first = q0 + offset, q_last = min(q0 + kBQ, sq) - 1 + offset;
  const float c2 = scale * kLog2e;  // scores in log2 units: exp(s - m) = 2^(s·log2e - m·log2e)

  float acc[NB][32];
#pragma unroll
  for (int jb = 0; jb < NB; ++jb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[jb][i] = 0.f;
  Rows st;  // m in log2 units, the -1e30 sentinel while a row has seen no key
  uint32_t hi[4][4], lo[4][4];  // the previous tile's P
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;  // overwritten: the first k-step does not accumulate
  const int n = tiles.y - tiles.x;
  const Mask mask{qa, qb, col, skv, causal, window, q_first, q_last, c2};

  // start S = Q·Kᵀ of the tile in stage s
  auto start_qk = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int col_off = (kk % 4) * 32;
      wgmma_ss(sc, desc(sQ + (kk / 4) * kBlock + col_off),
               desc(sK + s * C::kTileBytes + (kk / 4) * kBlock + col_off), kk > 0);
    }
    wg_commit();
  };
  // start O += P·V of the tile in stage s, P = hi + lo
  auto start_pv = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int jb = 0; jb < NB; ++jb) {
        const uint64_t dv = desc(sV + s * C::kTileBytes + jb * kBlock + kk * 16 * 128);
        wgmma_rs(acc[jb], hi[kk], dv);
        wgmma_rs(acc[jb], lo[kk], dv);
      }
    wg_commit();
  };
  auto fence_acc = [&]() {
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) fence_regs(acc[jb]);
  };
  // rescale O by the rows' alpha, then P of this tile into hi/lo
  auto rescale_and_split = [&](float alpha_a, float alpha_b) {
#pragma unroll
    for (int jb = 0; jb < NB; ++jb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[jb][4 * j + 0] *= alpha_a;
        acc[jb][4 * j + 1] *= alpha_a;
        acc[jb][4 * j + 2] *= alpha_b;
        acc[jb][4 * j + 3] *= alpha_b;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
  };

  mbar_wait(q_full, 0);  // also when no tile is seen: no load outlives the CTA
  if (n > 0) {
    // the first tile: S, softmax, P (no P·V in flight yet)
    mbar_wait(&kv_full[0], 0);
    wg_fence();
    start_qk(0);
    wg_wait<0>();
    fence_regs(sc);
    float alpha_a, alpha_b;
    softmax_tile(sc, tiles.x * kBKV, mask, st, alpha_a, alpha_b);
    rescale_and_split(alpha_a, alpha_b);
    // tile t's Q·Kᵀ and tile t - 1's P·V together; t's softmax while P·V runs
    for (int i = 1; i < n; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      mbar_wait(&kv_full[s], (i / kStages) & 1);
      fence_acc();
      wg_fence();
      start_qk(s);
      start_pv(sp);
      wg_wait<1>();  // S is ready; P·V may still run
      fence_regs(sc);
      softmax_tile(sc, (tiles.x + i) * kBKV, mask, st, alpha_a, alpha_b);
      wg_wait<0>();
      fence_acc();
      mbar_arrive(&kv_empty[sp]);  // this thread is done with stage sp
      rescale_and_split(alpha_a, alpha_b);
    }
    const int sp = (n - 1) % kStages;
    fence_acc();
    wg_fence();
    start_pv(sp);
    wg_wait<0>();
    fence_acc();
    mbar_arrive(&kv_empty[sp]);
  }
  const float l_a = st.l_a, l_b = st.l_b;

  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* og = o + static_cast<size_t>(b * hq + h) * sq * DH;
#pragma unroll
  for (int jb = 0; jb < NB; ++jb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * jb + 8 * j + col;
      if (row_a < sq)
        *reinterpret_cast<__nv_bfloat162*>(og + static_cast<size_t>(row_a) * DH + c) =
            __floats2bfloat162_rn(acc[jb][4 * j + 0] / den_a, acc[jb][4 * j + 1] / den_a);
      if (row_b < sq)
        *reinterpret_cast<__nv_bfloat162*>(og + static_cast<size_t>(row_b) * DH + c) =
            __floats2bfloat162_rn(acc[jb][4 * j + 2] / den_b, acc[jb][4 * j + 3] / den_b);
    }
}

// ---- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no link
// against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [heads, rows, dh] bf16, contiguous; 64 x 64 boxes, 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, const void* ptr, int heads, int rows, int dh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(rows) * dh * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int kStages>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv,
                   int sq, int skv, float scale, int causal, int window, cudaStream_t stream) {
  using C = Cfg<DH, kStages>;
  static_assert(C::kSmem <= 232448, "tiles exceed a block's shared memory");
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, b * hq, sq, DH) || !make_map(&mk, k, b * hkv, skv, DH) ||
      !make_map(&mv, v, b * hkv, skv, DH))
    return cudaErrorInvalidValue;
  auto kernel = flash_tc_kernel<DH, kStages>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(hq, (sq + kBQ - 1) / kBQ, b);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o),
                                                  hq, hkv, sq, skv, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [b, hq, sq, dh], k/v [b, hkv, skv, dh], o like q: contiguous bf16, each
// 16-byte aligned; dh in {64, 128, 256}.  window <= 0 means no window.
extern "C" cudaError_t flash_attention_tc_launch(const void* q, const void* k, const void* v,
                                                 void* o, int b, int hq, int hkv, int sq,
                                                 int skv, int dh, float scale, int causal,
                                                 int window, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || skv < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (skv == 0)  // no key: every row writes 0
    return cudaMemsetAsync(o, 0, static_cast<size_t>(b) * hq * sq * dh * 2, s);
  switch (dh) {
    // stages: as many as keep the CTAs an SM holds (3, 2, 1) in its shared memory
    case 64: return launch<64, 3>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 128: return launch<128, 2>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    case 256: return launch<256, 2>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}
