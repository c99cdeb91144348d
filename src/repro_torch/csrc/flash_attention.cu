// Blockwise causal (optionally sliding-window) attention forward (GQA) for
// Hopper (sm_90a), on the TF32 tensor cores at f32 accuracy.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:149
// `flash_attention_fwd` (body `_fwd_kernel`, :38): q (B, Sq, H, hd)
// attends over k/v (B, Sk, KV, hd) with an f32 online softmax (m, l, acc),
// query row i and key j at positions i and j: a key is visible iff j < Sk
// and i - j >= 0 and, with a window, i - j < window.  A row with no
// visible key outputs 0.  Plain version: `kernels.ref.blockwise_attention`
// (oracle `kernels.ref.mha_ref`; the kernel's arithmetic on the CPU:
// `blockwise_attention(..., einsum=ref.einsum_3xtf32)`).
//
// What bounds it on this card: operations.  A (Br x Bc) tile costs
// 4 Br Bc hd flops for Bc hd x 2 floats read; at prefill lengths the work
// grows as S^2 and the bytes as S.  The port compares floats in f32
// within 2e-5, which one TF32 product (10 mantissa bits) misses by two
// orders of magnitude, so every product is taken as 3xTF32 (CUTLASS's
// "fast f32"): x = hi + lo with hi = tf32_rna(x), lo = tf32_rna(x - hi),
// and a.b = lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), three MMAs
// accumulating in f32.  At the prefill shape (B=4, S=256, H=14, KV=2,
// hd=64, causal) that is 3 x 471.6 MFLOP over the 495 TFLOP/s TF32 rate =
// 0.00286 ms, against 0.0025 ms for the bytes.
//
// What the design does about it (FlashAttention-2 in registers):
//   * One CTA per (batch, kv head, tile of Br query positions) carries
//     the G query heads of that kv head: G Br rows, group-major (row
//     r = g Br + i), so each K/V tile serves all G heads.  The rows go in
//     m16 tiles, one warp each; for hd > 64 a warp carries a 128-wide
//     slice of the output and the warps of other slices recompute the
//     same scores.  Br is the largest power of two with G Br <= 64 that
//     Sq needs, halved until shared memory fits 200 KB and 8 warps: at
//     qwen2-0.5b (G = 7, Br = 8) a CTA takes ~104 KB and 8 warps, so two
//     share an SM.
//   * Two key groups of warps, where registers and shared memory allow,
//     take alternate key tiles, each through its own two-stage ring and
//     its own named barrier, and merge their (m, l, acc) at the end: the
//     longest CTA's walk halves.  The second group starts when the first
//     has its first scores, so one group's softmax (ALU, MUFU) tends to
//     run under the other's products (tensor cores).
//   * CTAs go in order of work, the query tiles with the most keys first;
//     where the whole grid is resident at once (at most two CTAs an SM)
//     the second round runs from the lightest up, so that each SM pairs a
//     heavy tile with a light one.  Causal work per tile grows with its
//     position; without the pairing the SMs that hold two of the heaviest
//     tiles set the time.
//   * S = Q K^T and O += P V are mma.sync.m16n8k8 TF32 products with f32
//     accumulators in registers (3xTF32 each; the operands are split as
//     the fragments are read).  P goes from the score accumulators to the
//     A operand without shuffles: the product's key order within each
//     8-key step is permuted (A column t <-> key 2t, t + 4 <-> key
//     2t + 1), and V's B-fragment rows follow the same order.
//   * The online softmax (m, l, alpha) is per row in registers, reduced
//     over the quad of lanes that shares a row with __shfl_xor_sync, in
//     base 2 (the scale folds log2 e, exp2f); the -inf / m_safe handling
//     is the plain version's, and the mask is only evaluated on tiles that
//     the diagonal, the window or Sk cut.  No score or accumulator goes
//     through shared memory.
//   * K/V tiles of 32 keys arrive by 16-byte cp.async (.cg): a group's
//     next tile is in flight while its current one is multiplied, one
//     named barrier a tile.  Rows are padded to hd8 + 4 floats (hd8 = hd
//     rounded up to 8), so the fragment reads (8 rows x 4 columns per
//     instruction) hit 32 distinct banks.  Keys past Sk, query rows past
//     Sq and the columns past hd are zero (src-size 0 copies) and masked;
//     a head width that is not a multiple of 4, or an unaligned tensor,
//     takes 4-byte copies.
//   * Tiles that the causal or window mask empties are never loaded: the
//     key loop runs from the window's first tile to the diagonal.
//   * The dynamic shared-memory limit is raised once per device, at the
//     first launch, not before every launch.
//   * wgmma is the step after this one: it is the only path to the full
//     TF32 rate, but for TF32 it needs both operands K-major, so V would
//     have to be staged transposed.
//
// The kernel is templated on the element type.  The bf16 instantiation
// (`flash_attention_bf16_launch`) computes what the TPU kernel computes
// on bf16 inputs: S = Q K^T as exact bf16 x bf16 products summed in f32,
// the same f32 online softmax, P rounded to bf16 (nearest even) into a
// bf16 x bf16 -> f32 P V, l summed from the unrounded f32 P, the output
// rounded to bf16.  Plain version: `kernels.ref.blockwise_attention` on
// bf16 tensors.  Its bound is operations too: 4 Br Bc hd flops a tile at
// the bf16 rate (989 TFLOP/s), a third of the f32 path's three products
// at half the TF32 rate.  Its design keeps the CTA plan above and
// changes the products:
//   * each product is one mma.sync.m16n8k16.bf16 (exact products, f32
//     sums) where the f32 path takes three m16n8k8 TF32;
//   * up to 128 query rows a CTA (G Br <= 128, the f32 path's 64): each
//     K/V tile a CTA loads serves twice the rows, which halves the tiles
//     read again from L2 at long S (at qwen2-0.5b's G = 7: Br = 16, 14
//     warps, one CTA an SM by registers);
//   * K/V tiles of 64 keys (half the bytes a row: a tile of 64 bf16 keys
//     is the f32 tile's 32 keys in bytes) by 16-byte cp.async, 8 values
//     a copy (element copies where hd % 8 != 0 or a tensor is
//     unaligned); rows padded to hd16 + 8 values (hd16 = hd rounded up
//     to 16), so the 8 rows an ldmatrix phase reads fall on 8 distinct
//     16-byte bank groups;
//   * Q and K fragments by ldmatrix.x4, V's by ldmatrix.x4.trans: V
//     stays in shared memory as it arrives (keys x dims) and no
//     transposed copy is staged;
//   * P goes from the score accumulators to the A operand of P V as
//     bf16 pairs (__floats2bfloat162_rn) without shuffles or a key
//     permutation: m16n8k16's C fragment of two n8 key tiles is its A
//     fragment of one k16 key step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Per element type: keys per K/V tile, the depth of one product (hd is
// padded to it), the row padding (elements), the elements in one 16-byte
// copy, and the most query rows (G Br) a CTA carries.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kBc = 32, kStep = 8, kPad = 4, kVec = 4, kRows = 64;
};
template <>
struct Tile<bf16> {
  static constexpr int kBc = 64, kStep = 16, kPad = 8, kVec = 8, kRows = 128;
};

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

__device__ __forceinline__ float to_t(float x, float*) { return x; }
__device__ __forceinline__ bf16 to_t(float x, bf16*) {
  return __float2bfloat16_rn(x);
}

// hd padded to the depth of one product
template <typename T>
__host__ __device__ __forceinline__ int hd_pad(int hd) {
  return (hd + Tile<T>::kStep - 1) & ~(Tile<T>::kStep - 1);
}

constexpr long long kMaxSmem = 200 * 1024;  // bytes of shared memory
constexpr int kMaxDevices = 64;

// Named barriers: the threads of one key group meet at bar_sync(id, n);
// bar_arrive signals one without waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 16 bytes (kVec elements) from global to shared memory, or zero-fill
// them where `full` is false.
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, bool full) {
  cp_async16(reinterpret_cast<float*>(dst),
             reinterpret_cast<const float*>(src), full);
}

// One element: f32 by a 4-byte cp.async; bf16 (2 bytes, below cp.async's
// smallest copy) by a plain load and store, which the barrier that
// follows every tile's copies publishes as it publishes the cp.async.
__device__ __forceinline__ void copy1(float* dst, const float* src,
                                      bool full) {
  cp_async4(dst, src, full);
}
__device__ __forceinline__ void copy1(bf16* dst, const bf16* src, bool full) {
  *dst = full ? *src : __float2bfloat16_rn(0.0f);
}

// Rows [0, kBc) of a K or V tile (row c at src + c * gstride) into dst
// (row stride st): rows >= nvalid and columns >= hd (up to hdk, hd
// padded to the product's depth) zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int st, const T* src,
                                          size_t gstride, int nvalid, int hd,
                                          int hdk, bool vec, int tid,
                                          int nthreads) {
  constexpr int kBc = Tile<T>::kBc, kVec = Tile<T>::kVec;
  if (vec) {
    const int cpr = hdk / kVec;  // 16-byte chunks per row
    for (int e = tid; e < kBc * cpr; e += nthreads) {
      const int c = e / cpr, d = (e - c * cpr) * kVec;
      const bool full = c < nvalid && d < hd;
      copy16(dst + c * st + d, full ? src + c * gstride + d : src, full);
    }
  } else {
    for (int e = tid; e < kBc * hdk; e += nthreads) {
      const int c = e / hdk, d = e - c * hdk;
      const bool full = c < nvalid && d < hd;
      copy1(dst + c * st + d, full ? src + c * gstride + d : src, full);
    }
  }
}

// kNT: the n8 tiles of output a warp carries (its slice of hd is 8 kNT
// wide), 8 for hd8 <= 64 and 16 above.  A thread with 16 output tiles
// needs more registers, so its CTA carries half the warps.
__host__ __device__ constexpr int max_warps(int nt) { return nt <= 8 ? 16 : 8; }

template <typename T, int kNT>
__global__ void __launch_bounds__(max_warps(kNT) * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Sk, int H, int KV, int hd, int Br,
                           int nkg, int window, float scale, int vec,
                           int nsm) {
  constexpr int kBc = Tile<T>::kBc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int G = H / KV;
  const int Q = G * Br;
  const int nmt = (Q + 15) >> 4;   // m16 tiles of query rows
  const int hd8 = hd_pad<T>(hd);   // hd padded to the product's depth
  const int nds = (hd8 + 8 * kNT - 1) / (8 * kNT);  // slices of hd
  const int wg = nmt * nds;        // warps of one key group
  const int st = hd8 + Tile<T>::kPad;  // row stride of Q, K and V tiles
  T* q_s = smem;                        // (16 nmt, st)
  T* ring = q_s + 16 * nmt * st;        // nkg x 2 stages x (K, V) x kBc rows
  // CTAs in order of work, the query tiles nearest the end (the most
  // keys) first.  Where the grid is at most two CTAs per SM, all of it is
  // resident at once and the second round runs from the lightest up, so
  // that an SM's two CTAs pair a heavy tile with a light one.
  const int ntile = (Sq + Br - 1) / Br;
  const int nbk = (int)(gridDim.x / ntile);  // (batch, kv head) pairs
  int rank = (int)blockIdx.x;
  if ((int)gridDim.x <= 2 * nsm && rank >= nsm)
    rank = (int)gridDim.x - 1 - (rank - nsm);
  const int it = ntile - 1 - rank / nbk;
  const int kvh = rank % nbk % KV;
  const int b = rank % nbk / KV;
  const int q0 = it * Br;
  const float scale2 = scale * 1.4426950408889634f;  // base-2 logits
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g8 = lane >> 2;             // the fragment's row (and B column)
  const int t4 = lane & 3;              // the fragment's column (and B row)
  const int kg = warp / wg;             // the warp's key group
  const int gtid = tid - kg * 32 * wg;  // its thread index in the group
  const int gn = 32 * wg;               // threads of a key group
  const int mt = warp % nmt;            // the warp's 16 rows
  const int d0 = (warp % wg) / nmt * 8 * kNT;  // the first dim of its slice
  const int nt = min(kNT, (hd8 - d0) >> 3);
  const size_t qrow = (size_t)H * hd;   // between positions in q / out
  const size_t krow = (size_t)KV * hd;  // between positions in k / v

  // the key range the mask leaves visible to positions q0 .. q0+Br-1
  int j_lo = 0;
  const int j_hi = min(Sk, q0 + Br);
  if (window > 0) j_lo = max(0, q0 - window + 1);
  j_lo = (j_lo / kBc) * kBc;
  const int ntk = j_hi > j_lo ? (j_hi - j_lo + kBc - 1) / kBc : 0;
  if (ntk == 0) {  // no visible key for any row of the tile: outputs 0
    for (int e = tid; e < Q * hd; e += nthreads) {
      const int r = e / hd, i = q0 + r % Br;
      if (i < Sq)
        out[((size_t)b * Sq + i) * qrow + (size_t)(kvh * G + r / Br) * hd +
            e % hd] = to_t(0.0f, (T*)nullptr);
    }
    return;
  }

  // Q rows: row r = g Br + i is head kvh G + g at position q0 + i
  const T* qb = q + (size_t)b * Sq * qrow + (size_t)kvh * G * hd;
  if (vec) {
    constexpr int kVec = Tile<T>::kVec;
    const int cpr = hd8 / kVec;
    for (int e = tid; e < 16 * nmt * cpr; e += nthreads) {
      const int r = e / cpr, d = (e - r * cpr) * kVec;
      const int i = q0 + r % Br;
      const bool full = r < Q && i < Sq && d < hd;
      copy16(q_s + r * st + d,
             full ? qb + (size_t)i * qrow + (size_t)(r / Br) * hd + d : qb,
             full);
    }
  } else {
    for (int e = tid; e < 16 * nmt * hd8; e += nthreads) {
      const int r = e / hd8, d = e - r * hd8;
      const int i = q0 + r % Br;
      const bool full = r < Q && i < Sq && d < hd;
      copy1(q_s + r * st + d,
            full ? qb + (size_t)i * qrow + (size_t)(r / Br) * hd + d : qb,
            full);
    }
  }
  cp_commit();

  // Key group kg takes tiles kg, kg + nkg, ...: its n-th lands in its own
  // ring's stage n & 1, loaded and awaited by its own threads.
  const T* kb = k + (size_t)b * Sk * krow + (size_t)kvh * hd;
  const T* vb = v + (size_t)b * Sk * krow + (size_t)kvh * hd;
  const int nmine = ntk > kg ? (ntk - kg + nkg - 1) / nkg : 0;
  T* myring = ring + kg * 4 * kBc * st;
  auto fetch = [&](int n) {
    const int j0 = j_lo + (n * nkg + kg) * kBc;
    T* ks = myring + (n & 1) * 2 * kBc * st;
    load_tile(ks, st, kb + (size_t)j0 * krow, krow, Sk - j0, hd, hd8, vec,
              gtid, gn);
    load_tile(ks + kBc * st, st, vb + (size_t)j0 * krow, krow, Sk - j0, hd,
              hd8, vec, gtid, gn);
    cp_commit();
  };
  if (nmine > 0) fetch(0);
  if (nmine > 0) cp_wait<1>(); else cp_wait<0>();
  __syncthreads();  // Q landed for every warp

  // this thread's two rows (g8 and g8 + 8 of the warp's m-tile) and their
  // positions; rows past Q are padding (zero queries, never written)
  const int r0 = mt * 16 + g8, r1 = r0 + 8;
  const int i0 = q0 + r0 % Br, i1 = q0 + r1 % Br;
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  // the second key group starts once the first has its first scores, so
  // that one group's softmax runs while the other's products do
  if (nkg > 1 && kg == 1) bar_sync(3, 2 * gn);

  for (int n = 0; n < nmine; ++n) {
    const int j0 = j_lo + (n * nkg + kg) * kBc;
    cp_wait<0>();  // tile n landed, for this thread's copies
    // ... for every copy of the group, and every warp of the group is
    // done with tile n - 1, whose stage tile n + 1 now takes
    bar_sync(1 + kg, gn);
    if (n + 1 < nmine) fetch(n + 1);
    const T* k_s = myring + (n & 1) * 2 * kBc * st;
    const T* v_s = k_s + kBc * st;

    // S = Q K^T for the warp's 16 rows and the tile's kBc keys
    float s[kBc / 8][4];
#pragma unroll
    for (int c = 0; c < kBc / 8; ++c)
      s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.0f;
    if constexpr (is_f32<T>()) {
      const float* qa = q_s + r0 * st + t4;
      const float* ka = k_s + g8 * st + t4;
#pragma unroll 2
      for (int kk = 0; kk < hd8; kk += 8) {
        uint32_t ah[4], al[4];
        split(qa[kk], ah[0], al[0]);
        split(qa[kk + 8 * st], ah[1], al[1]);
        split(qa[kk + 4], ah[2], al[2]);
        split(qa[kk + 8 * st + 4], ah[3], al[3]);
#pragma unroll
        for (int c = 0; c < kBc / 8; ++c) {
          uint32_t bh[2], bl[2];
          split(ka[c * 8 * st + kk], bh[0], bl[0]);
          split(ka[c * 8 * st + kk + 4], bh[1], bl[1]);
          mma_3xtf32(s[c], ah, al, bh, bl);
        }
      }
    } else {
      // ldmatrix rows: Q's A fragment (rows lane % 16, columns 8 (lane /
      // 16) onwards); K's B fragments of two n8 key tiles (keys lane % 8
      // + 8 (lane / 16), dims 8 ((lane / 8) % 2) onwards)
      const T* qa = q_s + (mt * 16 + (lane & 15)) * st + (lane >> 4) * 8;
      const T* ka = k_s + ((lane & 7) + (lane >> 4) * 8) * st +
                    ((lane >> 3) & 1) * 8;
#pragma unroll 2
      for (int kk = 0; kk < hd8; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, qa + kk);
#pragma unroll
        for (int c = 0; c < kBc / 8; c += 2) {
          uint32_t b[4];
          ldsm_x4(b, ka + c * 8 * st + kk);
          mma_bf16(s[c], a, b[0], b[1]);
          mma_bf16(s[c + 1], a, b[2], b[3]);
        }
      }
    }
    if (nkg > 1 && kg == 0 && n == 0) bar_arrive(3, 2 * gn);

    // scale, and mask where the tile is not wholly visible to the
    // CTA's positions; c0/c1 are row r0, keys 2 t4 and 2 t4 + 1 of each
    // n8 tile, c2/c3 row r1
    const bool inside = j0 + kBc <= Sk && j0 + kBc - 1 <= q0 &&
                        (window <= 0 || q0 + Br - 1 - j0 < window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBc / 8; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[c][h] *= scale2;
        s[c][2 + h] *= scale2;
        if (!inside) {
          const int j = j0 + c * 8 + 2 * t4 + h;
          const int e0 = i0 - j, e1 = i1 - j;
          if (!(j < Sk && e0 >= 0 && (window <= 0 || e0 < window)))
            s[c][h] = -INFINITY;
          if (!(j < Sk && e1 >= 0 && (window <= 0 || e1 < window)))
            s[c][2 + h] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[c][h]);
        mx1 = fmaxf(mx1, s[c][2 + h]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = isfinite(mn0) ? mn0 : 0.0f;
    const float ms1 = isfinite(mn1) ? mn1 : 0.0f;
    const float a0 = isfinite(m0) ? exp2f(m0 - ms0) : 0.0f;
    const float a1 = isfinite(m1) ? exp2f(m1 - ms1) : 0.0f;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int c = 0; c < kBc / 8; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[c][h] = s[c][h] == -INFINITY ? 0.0f : exp2f(s[c][h] - ms0);
        s[c][2 + h] =
            s[c][2 + h] == -INFINITY ? 0.0f : exp2f(s[c][2 + h] - ms1);
        ps0 += s[c][h];
        ps1 += s[c][2 + h];
      }
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }

    if constexpr (is_f32<T>()) {
      // O += P V over the tile's 8-key steps; A column t is key 2 t,
      // column t + 4 key 2 t + 1 (the accumulator layout of S), so V's
      // B-fragment rows are keys 2 t4 and 2 t4 + 1
#pragma unroll
      for (int c = 0; c < kBc / 8; ++c) {
        uint32_t ah[4], al[4];
        split(s[c][0], ah[0], al[0]);
        split(s[c][2], ah[1], al[1]);
        split(s[c][1], ah[2], al[2]);
        split(s[c][3], ah[3], al[3]);
        const float* vr = v_s + (c * 8 + 2 * t4) * st + d0 + g8;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j < nt) {
            uint32_t bh[2], bl[2];
            split(vr[j * 8], bh[0], bl[0]);
            split(vr[st + j * 8], bh[1], bl[1]);
            mma_3xtf32(acc[j], ah, al, bh, bl);
          }
        }
      }
    } else {
      // O += P V over the tile's 16-key steps: the S accumulators of key
      // tiles 2 c and 2 c + 1 are the A fragment of step c, as bf16
      // pairs; V's B fragments of two n8 dim tiles by ldmatrix.trans
      // (keys lane % 8 + 8 ((lane / 8) % 2), dims 8 (lane / 16) onwards)
      const T* va = v_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * st + d0 +
                    (lane >> 4) * 8;
#pragma unroll
      for (int c = 0; c < kBc / 16; ++c) {
        const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                               pack_bf16(s[2 * c][2], s[2 * c][3]),
                               pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                               pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          if (j < nt) {
            uint32_t b[4];
            ldsm_x4_trans(b, va + c * 16 * st + j * 8);
            mma_bf16(acc[j], a, b[0], b[1]);
            mma_bf16(acc[j + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }
  // a first group with no tile to walk still releases the second
  if (nkg > 1 && kg == 0 && nmine == 0) bar_arrive(3, 2 * gn);
  __syncthreads();  // the rings are free for the hand-over

  // two key groups: the second hands its (m, l, acc) to the first through
  // the rings, and the first merges them
  if (nkg > 1) {
    float* xs = reinterpret_cast<float*>(ring) +
                ((size_t)(warp % wg) * 32 + lane) * (4 + 4 * kNT);
    if (kg == 1) {
      xs[0] = m0;
      xs[1] = m1;
      xs[2] = l0;
      xs[3] = l1;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) xs[4 + 4 * j + c] = acc[j][c];
    }
    __syncthreads();
    if (kg == 1) return;
    const float mb0 = xs[0], mb1 = xs[1];
    const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
    const float ms0 = isfinite(mn0) ? mn0 : 0.0f;
    const float ms1 = isfinite(mn1) ? mn1 : 0.0f;
    const float wa0 = isfinite(m0) ? exp2f(m0 - ms0) : 0.0f;
    const float wa1 = isfinite(m1) ? exp2f(m1 - ms1) : 0.0f;
    const float wb0 = isfinite(mb0) ? exp2f(mb0 - ms0) : 0.0f;
    const float wb1 = isfinite(mb1) ? exp2f(mb1 - ms1) : 0.0f;
    l0 = l0 * wa0 + xs[2] * wb0;
    l1 = l1 * wa1 + xs[3] * wb1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      acc[j][0] = acc[j][0] * wa0 + xs[4 + 4 * j] * wb0;
      acc[j][1] = acc[j][1] * wa0 + xs[5 + 4 * j] * wb0;
      acc[j][2] = acc[j][2] * wa1 + xs[6 + 4 * j] * wb1;
      acc[j][3] = acc[j][3] * wa1 + xs[7 + 4 * j] * wb1;
    }
  }

  // out = acc / l for the rows and columns that exist
  const float dl0 = fmaxf(l0, 1e-30f), dl1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nt) continue;
    const int d = d0 + j * 8 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? r1 : r0, i = h ? i1 : i0;
      if (r >= Q || i >= Sq) continue;
      const float dl = h ? dl1 : dl0;
      T* o = out + ((size_t)b * Sq + i) * qrow +
             (size_t)(kvh * G + r / Br) * hd;
      if (d < hd) o[d] = to_t(acc[j][2 * h] / dl, (T*)nullptr);
      if (d + 1 < hd) o[d + 1] = to_t(acc[j][2 * h + 1] / dl, (T*)nullptr);
    }
  }
}

// Warps of one key group at tile height Br: m-tiles x slices of hd.
int warps(int G, int hd8, int nt, int Br) {
  return (int)(((long long)G * Br + 15) / 16) *
         ((hd8 + 8 * nt - 1) / (8 * nt));
}

// Shared memory (bytes) of one CTA: Q, then each key group's two-stage
// K/V ring, which the second group's hand-over (m, l and its f32
// accumulators, lane by lane) reuses at the end.
template <typename T>
long long smem_bytes(int G, int hd8, int nt, int Br, int nkg) {
  const long long nmt = ((long long)G * Br + 15) / 16;
  const long long st = hd8 + Tile<T>::kPad;
  const long long rings = (long long)sizeof(T) * 4 * nkg * Tile<T>::kBc * st;
  const long long hand = nkg > 1 ? (long long)sizeof(float) * 32 *
                                       warps(G, hd8, nt, Br) * (4 + 4 * nt)
                                 : 0;
  return (long long)sizeof(T) * 16 * nmt * st + (rings > hand ? rings : hand);
}

// The CTA's shape: query positions Br (0 where even one does not fit)
// and key groups nkg.  Br is the largest power of two with G Br <= kRows
// that Sq needs, halved until one key group fits kMaxSmem and 8 warps;
// a second key group is added where its warps and ring fit too.
template <typename T>
void plan(int G, int hd8, int nt, int Sq, int& Br, int& nkg) {
  int br = 1;
  while (G * (long long)br * 2 <= Tile<T>::kRows && br < Sq) br *= 2;
  auto fits = [&](int b, int n) {
    return smem_bytes<T>(G, hd8, nt, b, n) <= kMaxSmem &&
           n * warps(G, hd8, nt, b) <= (n > 1 ? max_warps(nt) : 8);
  };
  while (br > 1 && !fits(br, 1)) br /= 2;
  Br = fits(br, 1) ? br : 0;
  nkg = Br && fits(br, 2) ? 2 : 1;
}

// Raise the kernel's dynamic shared-memory limit and learn the SM count,
// once per device.
template <typename T, int kNT>
cudaError_t configure(int& nsm) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    e = cudaFuncSetAttribute(flash_attention_kernel<T, kNT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return e;
  }
  nsm = sms[dev];
  return cudaSuccess;
}

template <typename T, int kNT>
int launch(const T* q, const T* k, const T* v, T* out, int B, int Sq, int Sk,
           int H, int KV, int hd, int window, float scale, int vec,
           cudaStream_t stream) {
  const int G = H / KV, hd8 = hd_pad<T>(hd);
  int Br, nkg;
  plan<T>(G, hd8, kNT, Sq, Br, nkg);
  if (Br == 0) return (int)cudaErrorInvalidValue;
  int nsm = 0;
  cudaError_t e = configure<T, kNT>(nsm);
  if (e != cudaSuccess) return (int)e;
  const long long ntile = (Sq + Br - 1) / Br;
  const long long grid = (long long)B * KV * ntile;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<T, kNT>
      <<<(unsigned)grid, 32 * nkg * warps(G, hd8, kNT, Br),
         (size_t)smem_bytes<T>(G, hd8, kNT, Br, nkg), stream>>>(
          q, k, v, out, Sq, Sk, H, KV, hd, Br, nkg, window, scale, vec, nsm);
  return (int)cudaGetLastError();
}

// The entry for element type T: 16-byte copies where hd is a whole number
// of them and every tensor is 16-byte aligned; 8 n8 output tiles a warp
// up to a padded hd of 64, 16 above.
template <typename T>
int entry(const void* q, const void* k, const void* v, void* out, int B,
          int Sq, int Sk, int H, int KV, int hd, int window, float scale,
          void* stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || KV < 1 || H % KV != 0 || hd < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  const int vec = hd % Tile<T>::kVec == 0 &&
                  (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0;
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  T* o = (T*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd_pad<T>(hd) <= 64)
    return launch<T, 8>(qt, kt, vt, o, B, Sq, Sk, H, KV, hd, window, scale,
                        vec, st);
  return launch<T, 16>(qt, kt, vt, o, B, Sq, Sk, H, KV, hd, window, scale,
                       vec, st);
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd) and out (B, Sq, H, hd), f32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int KV, int hd,
                                      int window, float scale, void* stream) {
  return entry<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, window, scale,
                      stream);
}

// The same in bf16.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int Sq, int Sk, int H, int KV,
                                           int hd, int window, float scale,
                                           void* stream) {
  return entry<bf16>(q, k, v, out, B, Sq, Sk, H, KV, hd, window, scale,
                     stream);
}
