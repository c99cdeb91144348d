// Ragged flash-decode over a block-paged KV pool for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py:119
// `paged_decode` (body `_paged_kernel`, :47): one query token per slot
// attends over the tokens its block table maps, with an f32 online softmax
// (the recurrence of `kernels.ref.flash_decode_block`) and GQA heads
// stacked.  Plain version: `kernels.ref.paged_decode_ref`.
//
// What bounds it on this card: bytes.  Each (slot, kv head) reads len x hd
// floats of K and of V once and does 4 flops per element read, far below
// the ~20 flops/byte the f32 units need to be the limit, so the floor is
// the live K/V bytes over HBM bandwidth.
//
// What the design does about it:
//   * One CTA per (slot, kv head); its threads cover hd (any hd <= 1024,
//     not only powers of two) and it carries all G query rows of the
//     group, so each K/V row is read from HBM once for the G heads that
//     share it.
//   * The block loop is bounded by cdiv(len[s], BS), taken from the data:
//     tail blocks past the slot's length cost nothing, and an idle slot
//     (len 0) writes zeros.  Each iteration reads tbl[s, i] itself (the
//     TPU fed it through a scalar-prefetch index map); a -1 entry is
//     never dereferenced (it reads block 0, masked, like the reference).
//   * Scores: warp w takes tokens w, w + nwarps, ...; its lanes stride
//     over hd, so each token's K row is one coalesced sweep, reduced with
//     warp shuffles.  The G softmax rows are updated by G threads and the
//     probabilities are shared through shared memory; the V update is one
//     coalesced row read per token for the whole CTA.
//   * The kernel is instantiated for G <= 1, 2, 4, 8, 16 and bounded to
//     1024 threads, so the per-thread carries (G scores, G accumulators)
//     stay in registers at hd = 1024.
//   * expf, not __expf, and no fast-math: the result stays within f32
//     rounding of the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 16;  // largest GQA group (H / KV) taken

template <int kMaxG>
__global__ void __launch_bounds__(1024)
    paged_decode_kernel(const float* __restrict__ q,
                        const float* __restrict__ kp,
                        const float* __restrict__ vp,
                        const int* __restrict__ tbl,
                        const int* __restrict__ lens, float* __restrict__ out,
                        int H, int KV, int hd, int BS, int MB, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int s = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  float* q_s = smem;              // (G, hd) query rows of this group
  float* sc = q_s + G * hd;       // (G, BS) scores, then probabilities
  float* alpha_s = sc + G * BS;   // (G,) rescale of this block
  float* l_s = alpha_s + G;       // (G,) running denominators
  float* m_s = l_s + G;           // (G,) running maxima
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row_stride = (size_t)KV * hd;  // between tokens of a block

  const float* qg = q + ((size_t)s * H + (size_t)h * G) * hd;
  for (int e = tid; e < G * hd; e += blockDim.x) q_s[e] = qg[e];
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.0f;

  const int len = lens[s];
  const int nblk = len > 0 ? min((len + BS - 1) / BS, MB) : 0;
  __syncthreads();

  for (int i = 0; i < nblk; ++i) {
    int b = tbl[(size_t)s * MB + i];
    b = b < 0 ? 0 : b;
    const float* kb = kp + ((size_t)b * BS * KV + h) * hd;
    const float* vb = vp + ((size_t)b * BS * KV + h) * hd;
    const int nvalid = min(BS, len - i * BS);

    for (int t = warp; t < BS; t += nwarps) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.0f;
      if (t < nvalid) {
        const float* kr = kb + (size_t)t * row_stride;
        for (int d = lane; d < hd; d += 32) {
          const float kv = kr[d];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) part[g] = fmaf(q_s[g * hd + d], kv, part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float v = part[g];
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0) sc[g * BS + t] = t < nvalid ? v * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    if (tid < G) {
      const int g = tid;
      const float m_prev = m_s[g];
      float mb = -INFINITY;
      for (int t = 0; t < BS; ++t) mb = fmaxf(mb, sc[g * BS + t]);
      const float m_new = fmaxf(m_prev, mb);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float psum = 0.0f;
      for (int t = 0; t < BS; ++t) {
        const float p = t < nvalid ? expf(sc[g * BS + t] - m_safe) : 0.0f;
        sc[g * BS + t] = p;
        psum += p;
      }
      const float a = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
      alpha_s[g] = a;
      l_s[g] = l_s[g] * a + psum;
      m_s[g] = m_new;
    }
    __syncthreads();

    if (tid < hd) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      for (int t = 0; t < nvalid; ++t) {
        const float vv = vb[(size_t)t * row_stride + tid];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(sc[g * BS + t], vv, acc[g]);
      }
    }
    __syncthreads();  // sc is rewritten by the next block
  }

  if (tid < hd) {
    float* og = out + ((size_t)s * H + (size_t)h * G) * hd;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) og[(size_t)g * hd + tid] = acc[g] / fmaxf(l_s[g], 1e-30f);
  }
}

template <int kMaxG>
int launch(const float* q, const float* kp, const float* vp, const int* tbl,
           const int* lens, float* out, int S, int H, int KV, int hd, int BS,
           int MB, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * ((size_t)G * hd + (size_t)G * BS + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<kMaxG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((hd + 31) / 32) * 32;
  paged_decode_kernel<kMaxG><<<S * KV, threads, smem, stream>>>(
      q, kp, vp, tbl, lens, out, H, KV, hd, BS, MB, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tbl,
                                   const void* lens, void* out, int S, int H,
                                   int KV, int hd, int BS, int MB, float scale,
                                   void* stream) {
  if (S < 0 || KV < 1 || H % KV != 0 || H / KV > kMaxGroup || hd < 1 ||
      hd > 1024 || BS < 1 || MB < 1)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const int G = H / KV;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k_pool;
  const float* vf = (const float*)v_pool;
  const int* tb = (const int*)tbl;
  const int* ln = (const int*)lens;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 1) return launch<1>(qf, kf, vf, tb, ln, o, S, H, KV, hd, BS, MB, scale, st);
  if (G <= 2) return launch<2>(qf, kf, vf, tb, ln, o, S, H, KV, hd, BS, MB, scale, st);
  if (G <= 4) return launch<4>(qf, kf, vf, tb, ln, o, S, H, KV, hd, BS, MB, scale, st);
  if (G <= 8) return launch<8>(qf, kf, vf, tb, ln, o, S, H, KV, hd, BS, MB, scale, st);
  return launch<16>(qf, kf, vf, tb, ln, o, S, H, KV, hd, BS, MB, scale, st);
}
