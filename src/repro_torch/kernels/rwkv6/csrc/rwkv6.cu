// RWKV6 (Finch) recurrence for Hopper (sm_90a): every RWKV time-mix call.
//
// Replaces the TPU kernel `rwkv6_scan` / `_rwkv6_kernel` of
// src/repro/kernels/rwkv6/kernel.py (wrapper ops.rwkv6).  Per (b, h), with
// the f32 state S [D, D] (row i: key channel, column j: value channel):
//   o_t[j] = Σ_i r_t[i] · (S[i][j] + u[i] · k_t[i] · v_t[j])
//   S[i][j] <- w_t[i] · S[i][j] + k_t[i] · v_t[j]
// with the decay in linear space, as the TPU kernel keeps it.  Column j of S
// depends only on v[j], so the D columns split over `split` CTAs of a head
// (ops.column_split, ops.chunk_split), a CTA holding COLS = D / split.  Two paths,
// chosen by the wrapper by T:
//
// * rwkv6_decode_kernel (T below the chunk length: a decode step): 4 row
//   groups × COLS columns a CTA, thread (g, j) holding S[i][j] for its D/4
//   rows i in registers.  The state is read and written once; o[j] is the
//   four groups' partial sums added in a fixed order through shared memory,
//   so no result depends on scheduling.  Bound: the state's bytes,
//   2·B·H·D²·4, against a few flops an entry.
//
// * rwkv6_chunked_kernel (prefill, T from the chunk length on): chunks of
//   L tokens in order inside the CTA, the state's COLS columns in shared
//   memory; ops.chunk_split keeps the grid within one CTA an SM.  For a
//   chunk of n tokens entering with state S₀, with A_t = Π_{s<t} w_s and
//   B_s = Π_{s<q<n} w_q, running products from the chunk's two ends:
//     o_t = (r_t ⊙ A_t)·S₀ + Σ_{s<t} M[t, s]·v_s + (r_t·(u ⊙ k_t))·v_t
//     M[t, s] = Σ_i r_t[i]·k_s[i]·Π_{s<q<t} w_q[i]
//     S_n = diag(A_n)·S₀ + Σ_s (k_s ⊙ B_s)ᵀ·v_s
//   M is built from running products too (row t walks s downward,
//   multiplying in w_s after each step), never as the ratio A_t / A_{s+1}:
//   the model's decays (w = exp(−exp(·)), below 1e-30) underflow A inside a
//   chunk, and the ratio would be 0/0 — the instability the TPU kernel's
//   note rejects.  Every factor is a product of decays in [0, 1]: nothing
//   overflows.  A ragged last chunk reads as r = k = v = 0, w = 1, which
//   adds nothing and decays nothing.  A CTA is two warp groups, pipelined
//   over the chunks (double-buffered operands, one barrier a chunk):
//   * the prep group (warps 4-7) builds chunk c + 1 while the state group
//     runs chunk c: it stages the chunk after with cp.async (16-byte copies
//     where the operands allow), then the running products (r ⊙ A, k ⊙ B,
//     A_n), then M: each thread walks two rows (t and L-1-t: L-1 steps)
//     over L/4 key channels, the partial sums added over the channel groups
//     in a fixed order;
//   * the state group (warps 0-3) runs the two products on the tensor cores
//     as 3xTF32 (hi + lo parts, three mma.sync m16n8k8 a k-step; one TF32
//     pass keeps ~3 digits and fails the 1e-4 check): o = [r ⊙ A | M]·[S ;
//     V], K split over the warps when there are few tiles and the parts
//     added in order, and S' = A_n ⊙ S + KBᵀ·V into the other state buffer.
//   What bounds it: not the bytes (one read of r, k, v, w and write of o)
//   nor the operations (~4·D² + 3·L·D a token), but
//   each chunk's chain of dependent steps in the slower of the two groups
//   (M's walk and its reduction in the prep group; the mma k-steps in the
//   state group once a CTA holds 64 columns).  L = kChunk = 16, compiled
//   in: it beat L = 32 (PERF.md): M's walk grows with L and the rest does
//   not shrink as fast.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;     // threads of a chunked CTA
constexpr int kHalf = 128;        // its two warp groups: state (warps 0-3), prep (4-7)
constexpr int kGroups = 4;        // row groups of a decode CTA
constexpr int kChunk = 16;        // tokens a chunk (L); ops.CHUNK

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

template <int D, int COLS>
__global__ void __launch_bounds__(kGroups * 64)
rwkv6_decode_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ o, float* __restrict__ s_out, int H, int T) {
  constexpr int RP = D / kGroups;  // rows a thread
  __shared__ float rs[D], ks[D], ws[D], us[D];
  __shared__ float red[kGroups][COLS];
  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int jj = tid % COLS, g = tid / COLS;
  const int j = blockIdx.y * COLS + jj;
  const size_t seq = static_cast<size_t>(bh) * T * D;
  const size_t st = static_cast<size_t>(bh) * D * D;

  float S[RP];
#pragma unroll
  for (int q = 0; q < RP; ++q) S[q] = s0[st + static_cast<size_t>(g * RP + q) * D + j];
  if (tid < D) us[tid] = u[h * D + tid];
  for (int t = 0; t < T; ++t) {
    const size_t at = seq + static_cast<size_t>(t) * D;
    if (tid < D) {
      rs[tid] = r[at + tid];
      ks[tid] = k[at + tid];
      ws[tid] = w[at + tid];
    }
    const float vj = v[at + j];
    __syncthreads();  // rs/ks/ws/us staged; red[] read by the previous token
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < RP; ++q) {
      const int i = g * RP + q;
      const float kv = ks[i] * vj;
      acc = fmaf(rs[i], fmaf(us[i], kv, S[q]), acc);
      S[q] = fmaf(ws[i], S[q], kv);
    }
    red[g][jj] = acc;
    __syncthreads();  // every partial in red[]; rs/ks/ws free for the next token
    if (g == 0) o[at + j] = ((red[0][jj] + red[1][jj]) + red[2][jj]) + red[3][jj];
  }
#pragma unroll
  for (int q = 0; q < RP; ++q) s_out[st + static_cast<size_t>(g * RP + q) * D + j] = S[q];
}

// 3xTF32 on the tensor cores: x = hi + lo, hi its top 19 bits (a TF32
// value, cut by a mask: no conversion instruction) and lo = x − hi exactly,
// of which the mma reads the top 19 bits again; a·b ≈ a_lo·b_hi + a_hi·b_lo
// + a_hi·b_hi keeps ~21 bits, where one TF32 pass keeps ~11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A[16 × K] · B[K × 8] over the STEPS k-steps k0, k0 + 8, ..., in 3xTF32, A row-major at `a`
// (stride lda), B row-major at `b` (stride ldb): the m16n8k8 fragments of
// lane (g, q) = (lane / 4, lane % 4) read A[g (+8)][k + q (+4)] and
// B[k + q (+4)][g]; c holds D[g (+8)][2q (+1)].  The hi·hi products and the
// two corrections chain in three accumulators, added at the end (the
// corrections first), so that no mma waits on another.
template <int STEPS>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const float* __restrict__ a, int lda,
                                           const float* __restrict__ b, int ldb, int lane,
                                           int k0) {
  const int g = lane / 4, q = lane % 4;
  float e1[4] = {0.f, 0.f, 0.f, 0.f}, e2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int k = k0 + 8 * st;
    uint32_t ah[4], al[4], bh[2], bl[2];
    split_tf32(a[g * lda + k + q], ah[0], al[0]);
    split_tf32(a[(g + 8) * lda + k + q], ah[1], al[1]);
    split_tf32(a[g * lda + k + q + 4], ah[2], al[2]);
    split_tf32(a[(g + 8) * lda + k + q + 4], ah[3], al[3]);
    split_tf32(b[(k + q) * ldb + g], bh[0], bl[0]);
    split_tf32(b[(k + q + 4) * ldb + g], bh[1], bl[1]);
    mma_tf32(e1, al, bh);
    mma_tf32(e2, ah, bl);
    mma_tf32(c, ah, bh);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += e1[i] + e2[i];
}

constexpr int round8(int x) { return (x + 7) / 8 * 8; }

// The chunked CTA's shared-memory layout, in floats.  X, KB, AL and Y are
// double-buffered: the prep warps fill one chunk's while the state warps
// read the other's.
template <int D, int L, int COLS>
struct ChunkLayout {
  static constexpr int NP = round8(COLS);   // columns of the products, padded
  static constexpr int TO = (L / 16) * (NP / 8);  // m16n8 tiles of the outputs
  static constexpr int PO = TO >= kHalf / 32 ? 1 : kHalf / 32 / TO;  // K parts a tile
  // K of the output product, zero-padded to equal parts of whole k-steps
  static constexpr int KP = (D + L + 8 * PO - 1) / (8 * PO) * (8 * PO);
  static constexpr int XS = KP + 4;         // row stride of X (conflict-free A fragments)
  static constexpr int YS = NP + 8;         // row stride of Y (conflict-free B fragments)
  static constexpr int DP = D < 16 ? 16 : D;  // state rows, padded to the m16 tiles
  static constexpr int KS = L + 4;          // row stride of KB
  static constexpr int CPT = L / 4 < D ? L / 4 : D;  // key channels a thread of the M walk
  static constexpr int NGM = D / CPT;       // channel groups of the M walk
  static constexpr int MPS = L * L + 1;     // stride of a group's partials (no bank conflicts)
  static constexpr int kXB = L * XS, kYB = KP * YS, kKBB = DP * KS;  // one buffer of each
  static constexpr int kSB = 3 * L * D + L * COLS;  // one chunk's staged r, k, w, v
  static constexpr int kX = 2 * kSB, kY = kX + 2 * kXB, kKB = kY + 2 * kYB,
                       kAL = kKB + 2 * kKBB, kU = kAL + 2 * D, kMP = kU + D,
                       kCP = kMP + NGM * MPS, kFloats = kCP + (PO > 1 ? TO * PO * 128 : 0);
};

// Asynchronous copy of BYTES (4 or 16) global -> shared, zero-filled when
// !valid.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
  }
}

// A barrier of the kHalf threads of one warp group (1: prep, 2: state).
__device__ __forceinline__ void group_barrier(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kHalf) : "memory");
}

template <int D, int L, int COLS>
__global__ void __launch_bounds__(kThreads)
rwkv6_chunked_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ s0,
                     float* __restrict__ o, float* __restrict__ s_out, int H, int T) {
  using Lay = ChunkLayout<D, L, COLS>;
  static_assert(D % 4 == 0 && L % 16 == 0 && COLS <= D && 2 * D <= kHalf, "shapes");
  constexpr int NG = D / 4;  // float4 groups of a row
  constexpr int XS = Lay::XS, YS = Lay::YS, KS = Lay::KS, NP = Lay::NP;
  constexpr int kGroupWarps = kHalf / 32;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Sb = sm;                  // 2 × staged chunk: r, k, w [L][D], v [L][COLS]
  float* Xb = sm + Lay::kX;        // 2 × [L][XS]: r_t ⊙ A_t (cols < D) | M[t][s] (D + s)
  float* Yb = sm + Lay::kY;        // 2 × [KP][YS]: S (rows < D) | v_s (rows D + s)
  float* KBb = sm + Lay::kKB;      // 2 × [DP][KS]: (k_s ⊙ B_s)[i] at row i, column s
  float* ALb = sm + Lay::kAL;      // 2 × [D] A_n
  float* us = sm + Lay::kU;        // [D]
  float* Mp = sm + Lay::kMP;       // [NGM][MPS] M's partial sums by channel group
  float* Cp = sm + Lay::kCP;       // [PO][TO][128] the output tiles' K parts

  const int bh = blockIdx.x, h = bh % H, tid = threadIdx.x;
  const int j0 = blockIdx.y * COLS;
  const size_t seq = static_cast<size_t>(bh) * T * D;
  const size_t st = static_cast<size_t>(bh) * D * D;
  const int n_chunks = (T + L - 1) / L;
  const bool prep = tid >= kHalf;
  const int gt = tid % kHalf;                 // thread index in its warp group
  const int gw = gt / 32, lane = tid % 32;    // warp index in its group

  // zero what padding reads (pads of X, Y, KB, and M above the diagonal),
  // then the state and u
  for (int e = tid; e < Lay::kFloats - Lay::kX; e += kThreads) Xb[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < D * COLS; e += kThreads)
    Yb[(e / COLS) * YS + e % COLS] = s0[st + static_cast<size_t>(e / COLS) * D + j0 + e % COLS];
  for (int e = tid; e < D; e += kThreads) us[e] = u[h * D + e];
  __syncthreads();

  // The prep group stages chunk c's r, k, w [L, D] and v [L, COLS] into
  // staging buffer c % 2 with asynchronous copies, one chunk ahead of its
  // use; rows past the sequence are zero-filled (w's are read as 1 below).
  // Operands on 16-byte boundaries take 16-byte copies (a row of D floats,
  // and a CTA's COLS of it, are whole numbers of them), others 4-byte ones.
  const bool vec = ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) % 16) == 0;
  auto stage_by = [&](auto bytes, int c) {
    constexpr int E = decltype(bytes)::value / 4;  // floats a copy
    float* sb = Sb + (c % 2) * Lay::kSB;
    const int c0 = c * L, n = min(L, T - c0);
    const float* src[3] = {r, k, w};
    for (int e = gt * E; e < L * D; e += kHalf * E) {
      const bool ok = e / D < n;
      const size_t at = seq + static_cast<size_t>(ok ? c0 * D + e : 0);
#pragma unroll
      for (int a = 0; a < 3; ++a) copy_async<4 * E>(sb + a * L * D + e, src[a] + at, ok);
    }
    for (int e = gt * E; e < L * COLS; e += kHalf * E) {
      const int t = e / COLS;
      const bool ok = t < n;
      const size_t at = seq + (ok ? static_cast<size_t>(c0 + t) * D + j0 + e % COLS : 0);
      copy_async<4 * E>(sb + 3 * L * D + e, v + at, ok);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  auto stage = [&](int c) {
    if (vec) stage_by(std::integral_constant<int, 16>{}, c);
    else stage_by(std::integral_constant<int, 4>{}, c);
  };

  // The prep group builds chunk c's operands in buffer b: the inputs, the
  // running products, then M (r ⊙ A, M into X; KB; A_n; v into Y's rows D..).
  auto prepare = [&](int c, int b) {
    float* X = Xb + b * Lay::kXB;
    float* Y = Yb + b * Lay::kYB;
    float* KB = KBb + b * Lay::kKBB;
    float* AL = ALb + b * D;
    // 1. stage the next chunk; wait for this one's copies; its v into Y
    const int n = min(L, T - c * L);
    const float* rs = Sb + (c % 2) * Lay::kSB;
    const float* ks = rs + L * D;
    const float* ws = ks + L * D;
    const float* vs = ws + L * D;
    const float4* r4 = reinterpret_cast<const float4*>(rs);
    const float4* k4 = reinterpret_cast<const float4*>(ks);
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    if (c + 1 < n_chunks) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    group_barrier(1);
    for (int e = gt; e < L * COLS; e += kHalf) Y[(D + e / COLS) * YS + e % COLS] = vs[e];
    // 2. running products from both ends of the chunk (each thread's inputs
    //    loaded first, so no store waits on a load)
    if (gt < 2 * D) {
      const int i = gt % D;
      float rk[L], wv[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        rk[t] = gt < D ? rs[t * D + i] : ks[t * D + i];
        wv[t] = t < n ? ws[t * D + i] : 1.f;  // past the sequence: decay nothing
      }
      float a = 1.f;
      if (gt < D) {
#pragma unroll
        for (int t = 0; t < L; ++t) {
          X[t * XS + i] = rk[t] * a;
          a *= wv[t];
        }
        AL[i] = a;
      } else {
#pragma unroll
        for (int t = L - 1; t >= 0; --t) {
          KB[i * KS + t] = rk[t] * a;
          a *= wv[t];
        }
      }
    }
    // 3. M's partial sums over CPT key channels: thread (pair p, group g)
    //    walks rows p and L-1-p (L-1 steps in all) with q = r_t ⊙
    //    Π_{s<q'<t} w_q' (a running product, never a ratio)
    {
      constexpr int C4 = Lay::CPT / 4, NGM = Lay::NGM;
      if (gt < NGM * (L / 2)) {
        const int g = gt % NGM, p = gt / NGM;
        // restrict: the partials' stores never alias the inputs
        float* __restrict__ mp = Mp + g * Lay::MPS;
        const float4* __restrict__ kr = k4 + g * C4;
        const float4* __restrict__ wr = w4 + g * C4;
        const float4* __restrict__ rr4 = r4 + g * C4;
        const float4* u4 = reinterpret_cast<const float4*>(us) + g * C4;
        const int ta = p, tb = L - 1 - p;
        float4 qv[C4];
        float da = 0.f, db = 0.f, part[L - 1];
#pragma unroll
        for (int cc = 0; cc < C4; ++cc) {
          const float4 uu = u4[cc], ra = rr4[ta * NG + cc], rb2 = rr4[tb * NG + cc];
          da += dot4(make_float4(ra.x * uu.x, ra.y * uu.y, ra.z * uu.z, ra.w * uu.w),
                     kr[ta * NG + cc]);
          db += dot4(make_float4(rb2.x * uu.x, rb2.y * uu.y, rb2.z * uu.z, rb2.w * uu.w),
                     kr[tb * NG + cc]);
          qv[cc] = ta > 0 ? ra : rb2;
        }
        // step m: row ta at s = ta-1-m while m < ta, then row tb at
        // s = tb-1-(m-ta); unrolled, the stores after
#pragma unroll
        for (int m = 0; m < L - 1; ++m) {
          const int s = m < ta ? ta - 1 - m : tb - 1 - (m - ta);
          part[m] = 0.f;
#pragma unroll
          for (int cc = 0; cc < C4; ++cc) {
            const float4 kk = kr[s * NG + cc], ww = wr[s * NG + cc];
            part[m] += dot4(qv[cc], kk);
            qv[cc].x *= ww.x;
            qv[cc].y *= ww.y;
            qv[cc].z *= ww.z;
            qv[cc].w *= ww.w;
            if (m + 1 == ta) qv[cc] = rr4[tb * NG + cc];  // row ta done: start row tb
          }
        }
        mp[ta * L + ta] = da;
        mp[tb * L + tb] = db;
#pragma unroll
        for (int m = 0; m < L - 1; ++m) {
          if (m < ta) mp[ta * L + ta - 1 - m] = part[m];
          else mp[tb * L + tb - 1 - (m - ta)] = part[m];
        }
      }
    }
    group_barrier(1);
    // M[t][s] = Σ_g partial, groups in ascending order, into X[t][D + s]
    for (int e = gt; e < L * L; e += kHalf) {
      const int t = e / L, s = e % L;
      if (s > t) continue;  // stays 0
      float m = 0.f;
#pragma unroll
      for (int g = 0; g < Lay::NGM; ++g) m += Mp[g * Lay::MPS + e];
      X[t * XS + D + s] = m;
    }
  };

  // The state group runs chunk c from buffer b on the tensor cores, in
  // 3xTF32, one m16n8 tile a warp at a time, and writes the new state into
  // buffer nb's rows < D:
  //   o[t, :] = [r ⊙ A | M][t, :] · [S ; V]      (TO tiles, each split into
  //                                               PO parts of K when TO < 4)
  //   S'[i, :] = A_n[i]·S[i, :] + KB[i, :] · V   (DP/16 × NP/8 tiles)
  auto advance = [&](int c, int b, int nb) {
    const float* X = Xb + b * Lay::kXB;
    const float* Y = Yb + b * Lay::kYB;
    const float* KB = KBb + b * Lay::kKBB;
    const float* AL = ALb + b * D;
    float* Yn = Yb + nb * Lay::kYB;
    const int t0 = c * L, n = min(L, T - t0);
    constexpr int TO = Lay::TO, PO = Lay::PO;
    constexpr int kPartSteps = Lay::KP / 8 / PO;
    constexpr int kST = (Lay::DP / 16) * (NP / 8);
    const int gq = lane / 4, qq = lane % 4;
#pragma unroll
    for (int it = 0; it < (TO * PO + kGroupWarps - 1) / kGroupWarps; ++it) {
      const int item = gw + it * kGroupWarps;
      if (item >= TO * PO) break;
      const int tile = item % TO, part = item / TO;  // K steps [part·kPartSteps, +kPartSteps)
      const int tr = tile / (NP / 8) * 16, nc0 = tile % (NP / 8) * 8;
      float cf[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32<kPartSteps>(cf, X + tr * XS, XS, Y + nc0, YS, lane, 8 * kPartSteps * part);
      if constexpr (PO > 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) Cp[(part * TO + tile) * 128 + lane * 4 + e] = cf[e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tr + gq + (e / 2) * 8, j = nc0 + 2 * qq + e % 2;
          if (t < n && j < COLS) o[seq + static_cast<size_t>(t0 + t) * D + j0 + j] = cf[e];
        }
      }
    }
#pragma unroll
    for (int it = 0; it < (kST + kGroupWarps - 1) / kGroupWarps; ++it) {
      const int tile = gw + it * kGroupWarps;
      if (tile >= kST) break;
      const int ir = tile / (NP / 8) * 16, nc0 = tile % (NP / 8) * 8;
      float cf[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ir + gq + (e / 2) * 8, j = nc0 + 2 * qq + e % 2;
        cf[e] = i < D ? AL[i] * Y[i * YS + j] : 0.f;
      }
      mma_3xtf32<L / 8>(cf, KB + ir * KS, KS, Y + D * YS + nc0, YS, lane, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ir + gq + (e / 2) * 8, j = nc0 + 2 * qq + e % 2;
        if (i < D && j < COLS) Yn[i * YS + j] = cf[e];
      }
    }
    if constexpr (PO > 1) {  // o = the K parts added in ascending order
      group_barrier(2);
      for (int e = gt; e < TO * 128; e += kHalf) {
        const int tile = e / 128, ln = e % 128 / 4, x = e % 4;
        float acc = 0.f;
#pragma unroll
        for (int part = 0; part < PO; ++part) acc += Cp[(part * TO + tile) * 128 + e % 128];
        const int t = tile / (NP / 8) * 16 + ln / 4 + (x / 2) * 8;
        const int j = tile % (NP / 8) * 8 + 2 * (ln % 4) + x % 2;
        if (t < n && j < COLS) o[seq + static_cast<size_t>(t0 + t) * D + j0 + j] = acc;
      }
    }
  };

  if (prep) {
    stage(0);
    prepare(0, 0);
  }
  __syncthreads();
  // chunk c runs on the state group while the prep group builds chunk c + 1
  for (int c = 0; c < n_chunks; ++c) {
    if (!prep) advance(c, c % 2, (c + 1) % 2);
    else if (c + 1 < n_chunks) prepare(c + 1, (c + 1) % 2);
    __syncthreads();
  }
  const float* Sf = Yb + (n_chunks % 2) * Lay::kYB;
  for (int e = tid; e < D * COLS; e += kThreads)
    s_out[st + static_cast<size_t>(e / COLS) * D + j0 + e % COLS] = Sf[(e / COLS) * YS + e % COLS];
}

struct Args {
  const float *r, *k, *v, *w, *u, *s0;
  float *o, *s_out;
  int BH, H, T;
  cudaStream_t stream;
};

template <int D, int COLS>
cudaError_t decode(const Args& a, int split) {
  rwkv6_decode_kernel<D, COLS><<<dim3(a.BH, split), kGroups * COLS, 0, a.stream>>>(
      a.r, a.k, a.v, a.w, a.u, a.s0, a.o, a.s_out, a.H, a.T);
  return cudaGetLastError();
}

template <int D, int L, int COLS>
cudaError_t chunked(const Args& a, int split) {
  const auto kernel = rwkv6_chunked_kernel<D, L, COLS>;
  constexpr int smem = ChunkLayout<D, L, COLS>::kFloats * static_cast<int>(sizeof(float));
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return set;
  kernel<<<dim3(a.BH, split), kThreads, smem, a.stream>>>(a.r, a.k, a.v, a.w, a.u, a.s0, a.o,
                                                         a.s_out, a.H, a.T);
  return cudaGetLastError();
}

// The CTAs of a head: 1, 2 or 4, keeping at least 16 columns a CTA (D >= 16).
template <int D, template <int, int> class Path>
cudaError_t by_split(const Args& a, int split) {
  switch (split) {
    case 1: return Path<D, D>::run(a, split);
    case 2: if constexpr (D / 2 >= 16) return Path<D, D / 2>::run(a, split); break;
    case 4: if constexpr (D / 4 >= 16) return Path<D, D / 4>::run(a, split); break;
  }
  return cudaErrorInvalidValue;
}

template <int D, int COLS>
struct Decode {
  static cudaError_t run(const Args& a, int split) { return decode<D, COLS>(a, split); }
};

template <int D, int COLS>
struct Chunked {
  static cudaError_t run(const Args& a, int split) { return chunked<D, kChunk, COLS>(a, split); }
};

template <template <int, int> class Path>
cudaError_t by_dim(const Args& a, int D, int split) {
  switch (D) {
    case 4: return by_split<4, Path>(a, split);
    case 8: return by_split<8, Path>(a, split);
    case 16: return by_split<16, Path>(a, split);
    case 32: return by_split<32, Path>(a, split);
    case 64: return by_split<64, Path>(a, split);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r, k, v, w, o [BH, T, D], u [H, D], s0 and s_out [BH, D, D]: contiguous f32
// (BH = B·H, b-major).  The D columns go to `split` CTAs a head.  With
// `decode_path` the decode kernel runs, else the chunked kernel with chunks
// of kChunk tokens.
extern "C" cudaError_t rwkv6_launch(const void* r, const void* k, const void* v,
                                    const void* w, const void* u, const void* s0, void* o,
                                    void* s_out, int BH, int H, int T, int D, int split,
                                    int decode_path, void* stream) {
  if (BH == 0) return cudaSuccess;
  const Args a{static_cast<const float*>(r), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(w),
               static_cast<const float*>(u), static_cast<const float*>(s0),
               static_cast<float*>(o), static_cast<float*>(s_out), BH, H, T,
               static_cast<cudaStream_t>(stream)};
  return decode_path ? by_dim<Decode>(a, D, split) : by_dim<Chunked>(a, D, split);
}
