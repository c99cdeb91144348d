// Blockwise causal (optionally sliding-window) attention forward (GQA) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:149
// `flash_attention_fwd` (body `_fwd_kernel`, :38): q (B, Sq, H, hd)
// attends over k/v (B, Sk, KV, hd) with an f32 online softmax (m, l, acc),
// query row i and key j at positions i and j: a key is visible iff j < Sk
// and i - j >= 0 and, with a window, i - j < window.  A row with no
// visible key outputs 0.  Plain version: `kernels.ref.blockwise_attention`
// (oracle `kernels.ref.mha_ref`).
//
// What bounds it on this card: operations.  A (Br x Bc) tile costs
// 4 Br Bc hd flops for Bc hd x 2 floats read; at prefill lengths the work
// grows as S^2 and the bytes as S, so the f32 FMA rate is the floor (this
// first kernel uses no tensor cores: plain FMA loops, as the port's rule
// for a first kernel asks; wgmma / TMA are later work).
//
// What the design does about it:
//   * One CTA per (batch, kv head, tile of Br query positions) carries
//     the G query heads of that kv head: Q = G Br query rows (group-major,
//     row r = g Br + i), so each staged K/V tile serves all G heads.  Br is
//     the largest power of two with Q <= 128 that Sq needs, halved until
//     the CTA's shared memory fits 200 KB (`tile_rows`).
//   * K and V tiles of 32 rows are staged in shared memory; K rows are
//     padded to hd + 1 floats so the 32 lanes of a warp, one key each,
//     read distinct banks while the query row is a broadcast.  Keys past
//     Sk are zero and masked (the TPU wrapper padded K/V in HBM instead).
//   * Tiles that the causal or window mask empties are never visited: the
//     key loop runs from the window's first tile to the diagonal.
//   * Softmax: one warp per query row, one key per lane, reductions by
//     shuffle; the accumulator (Q x hd) lives in shared memory and each
//     thread owns (row, dim) entries of it for the P.V update, reading V
//     rows with consecutive lanes on consecutive dims.
//   * expf, no fast-math: within f32 rounding of the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBc = 32;  // keys per tile (one per lane in the softmax)

__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int Sq, int Sk, int H,
                           int KV, int hd, int Br, int window,
                           float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int Q = G * Br;
  const int ntile = (Sq + Br - 1) / Br;
  const int it = blockIdx.x % ntile;
  const int kvh = (blockIdx.x / ntile) % KV;
  const int b = blockIdx.x / (ntile * KV);
  const int q0 = it * Br;
  const int kst = hd + 1;          // padded K row stride in shared memory
  float* q_s = smem;               // (Q, hd)
  float* acc = q_s + Q * hd;       // (Q, hd)
  float* k_s = acc + Q * hd;       // (kBc, hd + 1)
  float* v_s = k_s + kBc * kst;    // (kBc, hd)
  float* s_s = v_s + kBc * hd;     // (Q, kBc) scores, then probabilities
  float* m_s = s_s + Q * kBc;      // (Q,)
  float* l_s = m_s + Q;            // (Q,)
  float* a_s = l_s + Q;            // (Q,)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const size_t qrow = (size_t)H * hd;   // between positions in q / out
  const size_t krow = (size_t)KV * hd;  // between positions in k / v

  // q rows of this tile: row r = g Br + i is head kvh G + g at q0 + i
  for (int e = tid; e < Q * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int g = r / Br, i = q0 + r % Br;
    q_s[e] = i < Sq ? q[((size_t)b * Sq + i) * qrow +
                         (size_t)(kvh * G + g) * hd + d]
                    : 0.0f;
    acc[e] = 0.0f;
  }
  for (int r = tid; r < Q; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }

  // the key range the mask leaves visible to positions q0 .. q0+Br-1
  int j_lo = 0;
  const int j_hi = min(Sk, q0 + Br);
  if (window > 0) j_lo = max(0, q0 - window + 1);
  j_lo = (j_lo / kBc) * kBc;

  const float* kb = k + (size_t)b * Sk * krow + (size_t)kvh * hd;
  const float* vb = v + (size_t)b * Sk * krow + (size_t)kvh * hd;
  for (int j0 = j_lo; j0 < j_hi; j0 += kBc) {
    __syncthreads();  // the previous tile's k_s / v_s / s_s are consumed
    for (int e = tid; e < kBc * hd; e += kThreads) {
      const int c = e / hd, d = e % hd;
      const int j = j0 + c;
      const bool in = j < Sk;
      k_s[c * kst + d] = in ? kb[(size_t)j * krow + d] : 0.0f;
      v_s[c * hd + d] = in ? vb[(size_t)j * krow + d] : 0.0f;
    }
    __syncthreads();

    // scores: entry (r, c) of the tile, c fastest (one key per lane)
    for (int e = tid; e < Q * kBc; e += kThreads) {
      const int r = e / kBc, c = e % kBc;
      const int i = q0 + r % Br, j = j0 + c;
      const int dd = i - j;
      const bool vis = j < Sk && dd >= 0 && (window <= 0 || dd < window);
      float s = -INFINITY;
      if (vis) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + c * kst;
        float x = 0.0f;
        for (int d = 0; d < hd; ++d) x = fmaf(qr[d], kr[d], x);
        s = x * scale;
      }
      s_s[e] = s;
    }
    __syncthreads();

    // online softmax: one warp per row, one key per lane
    for (int r = warp; r < Q; r += nwarps) {
      const float s = s_s[r * kBc + lane];
      float mb = s;
      for (int o = 16; o > 0; o >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mb);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float p = s == -INFINITY ? 0.0f : expf(s - m_safe);
      float ps = p;
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      s_s[r * kBc + lane] = p;
      if (lane == 0) {
        const float a = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
        a_s[r] = a;
        l_s[r] = l_s[r] * a + ps;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, thread per (row, dim) entry
    for (int e = tid; e < Q * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const float* pr = s_s + r * kBc;
      float x = acc[e] * a_s[r];
#pragma unroll 8
      for (int c = 0; c < kBc; ++c) x = fmaf(pr[c], v_s[c * hd + d], x);
      acc[e] = x;
    }
  }
  __syncthreads();

  for (int e = tid; e < Q * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int g = r / Br, i = q0 + r % Br;
    if (i < Sq)
      out[((size_t)b * Sq + i) * qrow + (size_t)(kvh * G + g) * hd + d] =
          acc[e] / fmaxf(l_s[r], 1e-30f);
  }
}

constexpr long long kMaxRows = 128;          // query rows a CTA carries
constexpr long long kMaxSmem = 200 * 1024;   // bytes of shared memory

// Shared memory (bytes) of one CTA at tile height Br.
long long smem_bytes(int G, int hd, int Br) {
  const long long Q = (long long)G * Br;
  return (long long)sizeof(float) *
         (2 * Q * hd + (long long)kBc * (hd + 1) + (long long)kBc * hd +
          Q * kBc + 3 * Q);
}

// Query positions per CTA; 0 where even one position does not fit.
int tile_rows(int G, int hd, int Sq) {
  int br = 1;
  while (G * (long long)br * 2 <= kMaxRows && br < Sq) br *= 2;
  while (br > 1 && smem_bytes(G, hd, br) > kMaxSmem) br /= 2;
  return smem_bytes(G, hd, br) > kMaxSmem ? 0 : br;
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int KV, int hd,
                                      int window, float scale, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || KV < 1 || H % KV != 0 || hd < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  const int Br = tile_rows(H / KV, hd, Sq);
  if (Br == 0) return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(H / KV, hd, Br);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ntile = (Sq + Br - 1) / Br;
  const long long grid = (long long)B * KV * ntile;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<<<(unsigned)grid, kThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk,
      H, KV, hd, Br, window, scale);
  return (int)cudaGetLastError();
}
