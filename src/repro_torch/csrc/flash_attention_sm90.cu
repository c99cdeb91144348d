// Blockwise causal (optionally sliding-window) attention forward (GQA) in
// bf16 for Hopper (sm_90a), on its own instructions: TMA tile loads, a
// producer warp, and warpgroup products (wgmma) whose softmax overlaps
// the tensor cores.
//
// Replaces, for bf16 inputs at head widths 64, 128 and 256, the TPU kernel
// src/repro/kernels/flash_attention.py:149 `flash_attention_fwd` (body
// `_fwd_kernel`, :38), as csrc/flash_attention.cu's bf16 instantiation
// (`mma.sync`) does at every width; the wrapper routes by shape
// (`kernels.flash_attention.wgmma_route`).  It computes exactly what that
// instantiation computes: q (B, Sq, H, hd) attends over k/v (B, Sk, KV,
// hd); query i sees key j iff j < Sk, i >= j and, with a window,
// i - j < window; S = Q K^T as exact bf16 x bf16 products summed in f32;
// the online softmax in f32, base 2, with the plain version's -inf /
// m_safe handling; P rounded to bf16 (nearest even) into P V, l summed
// from the unrounded f32 P; a row with no visible key outputs 0; the
// output rounded to bf16.  Plain version: `kernels.ref.blockwise_attention`
// on bf16 tensors.
//
// What bounds it on this card (B=1, S=32768, H=14, KV=2, hd=64, causal:
// prefill_32k's length at qwen2-0.5b's heads): operations.  The products
// are 4 H S^2/2 hd = 1.92 TFLOP, 1.95 ms at 989 TFLOP/s; the softmax's
// 2^x are H S^2/2 = 7.5e9 MUFU.EX2, ~1.9 ms at 16 a clock an SM; its
// scale, max, sum and conversion add ~1.4 ms of FP32-pipe issue.  The
// three units reach their bound only together, so the design overlaps
// them; the bytes from device memory (~59 MB) are nothing beside them.
//
// What the design does about it (FlashAttention-3's plan):
//   * Warp specialisation.  A CTA is one producer warpgroup and two
//     consumer warpgroups (384 threads).  One thread of the producer keeps
//     TMA loads in flight: Q's tile once, then K and V tiles into two rings
//     of `kStages` stages each, with full and empty mbarriers; K and V have
//     rings of their own because a tile's K is done a step before its V
//     (below), so each is freed as soon as it is read.  setmaxnreg gives
//     the producer 24 registers and each consumer thread 240, inside the
//     one if/else that splits the roles for the kernel's life.
//   * S = Q K^T is wgmma m64n{Bc}k16 with both operands in shared memory
//     (K stored keys x hd is K-major for B); O += P V is wgmma m64n{hd}k16
//     with P as the A operand from registers, converted in place from S's
//     accumulator fragment (the f32 accumulator of a k16 step's two n8
//     blocks is the bf16 A fragment of that step), and V read as it
//     arrives through the descriptor's transpose bit: no transposed copy.
//   * Softmax overlapped with the products, two ways.  Within a
//     warpgroup, step n issues S_n = Q K_n^T and then O += P_{n-1} V_{n-1},
//     waits only for S_n, and takes S_n's softmax while P_{n-1} V_{n-1}
//     runs; O is rescaled once that product is done.  Between the two
//     warpgroups, named barriers make them take turns issuing (ping-pong),
//     so one's softmax runs under the other's products.
//   * GQA rows and L2 reuse.  A CTA carries all G heads of one kv head for
//     Bp = floor(128 / G) positions, position-major (row r is head r % G at
//     position q0 + r / G): one 4-D TMA box of (64 columns, G heads, Bp
//     positions) lands Q's rows in that order, so one K/V tile in shared
//     memory serves every head, and the rows of a 64-row warpgroup tile
//     span only ~64 / G positions, which keeps the causal diagonal's
//     masked waste to one or two key tiles.  At G = 7 that is 126 rows a
//     CTA (the mma.sync kernel: 112), 3642 CTAs at S = 32768, each reading
//     on average 16384 keys x 256 bytes of K/V from L2: ~15.3 GB in all,
//     ~2 ms at L2's rate, carried by TMA under the products.
//   * Masks only where they cut: the causal diagonal, the window or Sk.
//     Tiles that the mask empties are never loaded (the key loop runs from
//     the window's first tile to the diagonal), and CTAs start in order of
//     work, the query tiles with the most keys first.
//   * TMA descriptors are encoded on the host with cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint (no -lcuda), and passed as
//     __grid_constant__ parameters; 128-byte swizzle, one 64-column
//     (128-byte) slab a box, so hd 128 and 256 take 2 and 4 slabs a tile.
//     Keys past Sk and positions past Sq arrive as zeros (TMA's
//     out-of-bounds fill) and are masked or never written.
//   * Tiles: Bc = 128 keys for hd <= 128 and 64 for hd 256, so that S, O
//     and P fit a consumer's 240 registers (hd 128: 64 + 64 + 32; hd 256:
//     32 + 128 + 16); 4 stages of K and V at hd 64, 2 above.
//
// Head widths other than 64, 128 and 256, G > 128, and tensors not 16-byte
// aligned take csrc/flash_attention.cu's bf16 kernel instead: a route by
// shape, decided in the wrapper.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kRows = 128;     // query rows a CTA: 64 a consumer
constexpr int kMaxDevices = 64;

template <int HD>
struct Plan {
  static constexpr int kBc = HD <= 128 ? 128 : 64;  // keys a tile
  static constexpr int kSlabs = HD / 64;            // 128-byte column slabs
  static constexpr int kStages = HD == 64 ? 4 : 2;  // of each of K and V
  static constexpr int kSlabQ = kRows * 128;        // bytes of a Q slab
  static constexpr int kSlabKV = kBc * 128;         // of a K or V slab
  static constexpr int kTile = kSlabs * kSlabKV;    // of a K or V tile
  static constexpr int kQ = kSlabs * kSlabQ;
  static constexpr int kBars = 1 + 4 * kStages;     // q, K/V full, empty
  // Q, the K ring, the V ring, the barriers, and 1 KB to align the base
  static constexpr int kSmem = kQ + 2 * kStages * kTile + 8 * kBars + 1024;
  static constexpr int kS = kBc / 2;  // S accumulators a thread
  static constexpr int kO = HD / 2;   // O accumulators a thread
};

template <int N>
struct Wgmma;
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int sd) {
    wgmma_ss_n64(d, a, b, sd);
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n64(d, a, b, 1);
  }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int sd) {
    wgmma_ss_n128(d, a, b, sd);
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n128(d, a, b, 1);
  }
};
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n256(d, a, b, 1);
  }
};

// S = Q K^T for a warpgroup's 64 rows (Q's tile at q_base) and one K
// tile, over hd in k16 steps: 32 bytes along a 128-byte row a step, the
// next 64-column slab every 4 steps.
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[Plan<HD>::kS],
                                        uint32_t q_base, uint32_t k_tile) {
  using P = Plan<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    Wgmma<P::kBc>::ss(
        s, desc_sw128(q_base + (kk >> 2) * P::kSlabQ + off, 16, 1024),
        desc_sw128(k_tile + (kk >> 2) * P::kSlabKV + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one V tile (keys x hd, read MN-major), over the tile's keys
// in k16 steps of 16 rows (2048 bytes); P's fragment for step ks is the
// bf16 pairs 4 ks .. 4 ks + 3.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[Plan<HD>::kO],
                                         const uint32_t (&p)[Plan<HD>::kS / 2],
                                         uint32_t v_tile) {
  using P = Plan<HD>;
#pragma unroll
  for (int ks = 0; ks < P::kBc / 16; ++ks) {
    const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2],
                           p[4 * ks + 3]};
    Wgmma<HD>::rs(o, a, desc_sw128(v_tile + ks * 2048, P::kSlabKV, 1024));
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(r[i]);
}

// One arrival a warp on an empty barrier once the warp's reads are done.
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A thread's two rows: running maxima in base-2 units and its share of
// the running sums.
struct Rows {
  float m0, m1, l0, l1;
};

// The online softmax of one tile's scores s (s[4c + h]: row r0, key
// j0 + 8c + 2 t4 + h; s[4c + 2 + h]: row r1) in place: masked where the
// tile is not wholly visible to the CTA's positions, the running maxima
// (scale2 = scale log2 e > 0, so the max of the scaled scores is the
// scaled max; m_safe = 0 while a row has seen no key), P = 2^(s scale2 -
// m) in f32, the rows' rescale factors a0 and a1 (0 while m was -inf).
template <int kBc>
__device__ __forceinline__ void softmax(float (&s)[kBc / 2], Rows& r,
                                        float& a0, float& a1, bool inside,
                                        int j0, int t4, int i0, int i1,
                                        int Sk, int window, float scale2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int c = 0; c < kBc / 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!inside) {
        const int j = j0 + c * 8 + 2 * t4 + h;
        const int e0 = i0 - j, e1 = i1 - j;
        if (!(j < Sk && e0 >= 0 && (window <= 0 || e0 < window)))
          s[4 * c + h] = -INFINITY;
        if (!(j < Sk && e1 >= 0 && (window <= 0 || e1 < window)))
          s[4 * c + 2 + h] = -INFINITY;
      }
      mx0 = fmaxf(mx0, s[4 * c + h]);
      mx1 = fmaxf(mx1, s[4 * c + 2 + h]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(r.m0, mx0 * scale2);
  const float mn1 = fmaxf(r.m1, mx1 * scale2);
  const float ms0 = mn0 == -INFINITY ? 0.0f : mn0;
  const float ms1 = mn1 == -INFINITY ? 0.0f : mn1;
  a0 = ex2(r.m0 - ms0);
  a1 = ex2(r.m1 - ms1);
  float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
  for (int c = 0; c < kBc / 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[4 * c + h] = ex2(fmaf(s[4 * c + h], scale2, -ms0));
      s[4 * c + 2 + h] = ex2(fmaf(s[4 * c + 2 + h], scale2, -ms1));
      ps0 += s[4 * c + h];
      ps1 += s[4 * c + 2 + h];
    }
  }
  r.l0 = r.l0 * a0 + ps0;  // this thread's share; summed at the end
  r.l1 = r.l1 * a1 + ps1;
  r.m0 = mn0;
  r.m1 = mn1;
}

// P rounded to bf16 pairs: S's accumulator pair (2i, 2i + 1) is the A
// fragment's pair i.
template <int kBc>
__device__ __forceinline__ void pack(uint32_t (&p)[kBc / 4],
                                     const float (&s)[kBc / 2]) {
#pragma unroll
  for (int i = 0; i < kBc / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out, int Sq,
    int Sk, int H, int KV, int Bp, int window, float scale2, int ntile) {
  using P = Plan<HD>;
  constexpr int kBc = P::kBc, kNS = P::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + P::kQ;            // kNS tiles
  unsigned char* v_s = k_s + kNS * P::kTile;   // kNS tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + kNS * P::kTile);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kNS;
  uint64_t* k_empty = v_full + kNS;
  uint64_t* v_empty = k_empty + kNS;

  const int G = H / KV;
  const int tid = threadIdx.x;
  // CTAs in order of work: the query tiles nearest the end (most keys)
  // first
  const int nbk = (int)(gridDim.x / ntile);  // (batch, kv head) pairs
  const int rank = (int)blockIdx.x;
  const int it = ntile - 1 - rank / nbk;
  const int kvh = rank % nbk % KV;
  const int b = rank % nbk / KV;
  const int q0 = it * Bp;
  const int q_hi = min(q0 + Bp, Sq);  // positions q0 .. q_hi-1 are written
  const int rows = G * Bp;            // real rows; the rest pad to 128

  // the key tiles the mask leaves visible to the CTA's positions
  int j_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  j_lo = j_lo / kBc * kBc;
  const int j_hi = min(Sk, q_hi);
  const int ntk = j_hi > j_lo ? (j_hi - j_lo + kBc - 1) / kBc : 0;
  const size_t orow = (size_t)H * HD;  // between positions in out
  bf16* ob = out + (size_t)b * Sq * orow + (size_t)kvh * G * HD;
  if (ntk == 0) {  // no visible key for any row: outputs 0
    for (int e = tid; e < rows * HD; e += kThreads) {
      const int r = e / HD, i = q0 + r / G;
      if (i < Sq) ob[(size_t)i * orow + (size_t)(r % G) * HD + e % HD] =
          __float2bfloat16_rn(0.0f);
    }
    return;
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kNS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrival a consumer warp
      mbar_init(&v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index, made warp-uniform in the compiler's eyes (a
  // shuffle from lane 0): wgmma in a path it takes for divergent is
  // serialised
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    regs_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, (uint32_t)(P::kSlabs * 128 * rows));
      for (int s = 0; s < P::kSlabs; ++s)
        tma_load_4d(q_s + s * P::kSlabQ, &qmap, q_full, s * 64, kvh * G, q0,
                    b);
      // K_n, then V_{n-1}: the order in which the consumers free them
      for (int n = 0; n <= ntk; ++n) {
        if (n < ntk) {
          const int st = n % kNS;
          mbar_wait(&k_empty[st], ((n / kNS) & 1) ^ 1);
          mbar_expect_tx(&k_full[st], P::kTile);
          for (int s = 0; s < P::kSlabs; ++s)
            tma_load_4d(k_s + st * P::kTile + s * P::kSlabKV, &kmap,
                        &k_full[st], s * 64, kvh, j_lo + n * kBc, b);
        }
        if (n > 0) {
          const int m = n - 1, st = m % kNS;
          mbar_wait(&v_empty[st], ((m / kNS) & 1) ^ 1);
          mbar_expect_tx(&v_full[st], P::kTile);
          for (int s = 0; s < P::kSlabs; ++s)
            tma_load_4d(v_s + st * P::kTile + s * P::kSlabKV, &vmap,
                        &v_full[st], s * 64, kvh, j_lo + m * kBc, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    regs_inc<240>();
    const int wg = role - 1;  // 0 or 1
    const int wt = tid % 128;
    const int lane = wt & 31;
    const int t4 = lane & 3;
    const int r0 = wg * 64 + (wt >> 5) * 16 + (lane >> 2), r1 = r0 + 8;
    const int i0 = q0 + r0 / G, i1 = q0 + r1 / G;  // the rows' positions
    // ping-pong: this warpgroup waits at my_bar to issue its products and
    // then lets the other one issue
    const int my_bar = 1 + wg, other_bar = 2 - wg;

    float o[P::kO];
#pragma unroll
    for (int i = 0; i < P::kO; ++i) o[i] = 0.0f;
    float s[P::kS];
#pragma unroll
    for (int i = 0; i < P::kS; ++i) s[i] = 0.0f;
    uint32_t p[P::kS / 2];
    Rows st{-INFINITY, -INFINITY, 0.0f, 0.0f};
    float a0, a1;  // the rescale factors of the thread's two rows

    const uint32_t q_base = smem_u32(q_s) + wg * 64 * 128;
    const uint32_t k_base = smem_u32(k_s), v_base = smem_u32(v_s);
    auto inside = [&](int n) {  // tile n wholly visible to the positions
      const int j0 = j_lo + n * kBc;
      return j0 + kBc <= Sk && j0 + kBc - 1 <= q0 &&
             (window <= 0 || q0 + Bp - 1 - j0 < window);
    };
    mbar_wait(q_full, 0);
    if (wg == 1) bar_arrive(1, 256);  // the first turn is warpgroup 0's

    // tile 0: S_0 alone
    mbar_wait(&k_full[0], 0);
    bar_sync(my_bar, 256);
    wgmma_fence();
    issue_s<HD>(s, q_base, k_base);
    bar_arrive(other_bar, 256);
    wgmma_wait<0>();
    fence_regs(s);
    release(&k_empty[0], lane);
    softmax<kBc>(s, st, a0, a1, inside(0), j_lo, t4, i0, i1, Sk, window,
                 scale2);
    pack<kBc>(p, s);

    // tile n: S_n, then P_{n-1} V_{n-1}; S_n's softmax runs under the
    // second product
    for (int n = 1; n < ntk; ++n) {
      const int sk = n % kNS, sv = (n - 1) % kNS;
      mbar_wait(&k_full[sk], (n / kNS) & 1);
      mbar_wait(&v_full[sv], ((n - 1) / kNS) & 1);
      bar_sync(my_bar, 256);
      wgmma_fence();
      issue_s<HD>(s, q_base, k_base + sk * P::kTile);
      issue_pv<HD>(o, p, v_base + sv * P::kTile);
      bar_arrive(other_bar, 256);
      wgmma_wait<1>();
      fence_regs(s);
      release(&k_empty[sk], lane);
      softmax<kBc>(s, st, a0, a1, inside(n), j_lo + n * kBc, t4, i0, i1, Sk,
                   window, scale2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(&v_empty[sv], lane);
#pragma unroll
      for (int i = 0; i < P::kO; i += 4) {
        o[i] *= a0;
        o[i + 1] *= a0;
        o[i + 2] *= a1;
        o[i + 3] *= a1;
      }
      pack<kBc>(p, s);
    }

    // the last tile's P V
    const int sv = (ntk - 1) % kNS;
    mbar_wait(&v_full[sv], ((ntk - 1) / kNS) & 1);
    bar_sync(my_bar, 256);
    wgmma_fence();
    issue_pv<HD>(o, p, v_base + sv * P::kTile);
    if (wg == 0) bar_arrive(other_bar, 256);  // warpgroup 1's last turn
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    release(&v_empty[sv], lane);

    // out = O / l for the rows that exist
    float l0 = st.l0, l1 = st.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float dl0 = fmaxf(l0, 1e-30f), dl1 = fmaxf(l1, 1e-30f);
    const bool w0 = r0 < rows && i0 < Sq, w1 = r1 < rows && i1 < Sq;
    bf16* o0 = ob + (size_t)i0 * orow + (size_t)(r0 % G) * HD + 2 * t4;
    bf16* o1 = ob + (size_t)i1 * orow + (size_t)(r1 % G) * HD + 2 * t4;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      if (w0)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * c) =
            __floats2bfloat162_rn(o[4 * c] / dl0, o[4 * c + 1] / dl0);
      if (w1)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * c) =
            __floats2bfloat162_rn(o[4 * c + 2] / dl1, o[4 * c + 3] / dl1);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (B, S, N, hd) as a 4-D map with boxes of (64 columns, nbox
// of N, sbox of S, 1 of B), 128-byte swizzle.
CUresult encode(CUtensorMap* map, const void* ptr, int B, int S, int N,
                int hd, int nbox, int sbox) {
  EncodeTiled fn = encoder();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)N, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)N * hd * 2,
                                 (cuuint64_t)S * N * hd * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)nbox, (cuuint32_t)sbox, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Raise the kernel's dynamic shared-memory limit once per device.
template <int HD>
cudaError_t configure() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Plan<HD>::kSmem);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  const int G = H / KV, Bp = kRows / G;
  CUtensorMap qm, km, vm;
  CUresult r = encode(&qm, q, B, Sq, H, HD, G, Bp);
  if (r == CUDA_SUCCESS) r = encode(&km, k, B, Sk, KV, HD, 1, Plan<HD>::kBc);
  if (r == CUDA_SUCCESS) r = encode(&vm, v, B, Sk, KV, HD, 1, Plan<HD>::kBc);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;  // a driver error, offset
  cudaError_t e = configure<HD>();
  if (e != cudaSuccess) return (int)e;
  const long long ntile = (Sq + Bp - 1) / Bp;
  const long long grid = (long long)B * KV * ntile;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_wgmma_kernel<HD>
      <<<(unsigned)grid, kThreads, Plan<HD>::kSmem, stream>>>(
          qm, km, vm, (bf16*)out, Sq, Sk, H, KV, Bp, window,
          scale * 1.4426950408889634f, (int)ntile);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd) and out (B, Sq, H, hd), bf16,
// contiguous and 16-byte aligned; hd 64, 128 or 256; 1 <= H / KV <= 128;
// B, Sq, Sk >= 1.  Returns a cudaError_t, or 10000 + a CUresult of the
// tensor-map encoding.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int B,
                                            int Sq, int Sk, int H, int KV,
                                            int hd, int window, float scale,
                                            void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || H / KV > kRows ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, out, B, Sq, Sk, H, KV, window, scale, st);
    case 128:
      return launch<128>(q, k, v, out, B, Sq, Sk, H, KV, window, scale, st);
    case 256:
      return launch<256>(q, k, v, out, B, Sq, Sk, H, KV, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
