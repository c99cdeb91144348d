// Single-token decode attention over a dense (possibly rolling) KV cache
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:102
// `decode_attention` (body `_decode_kernel`, :34): one query token per
// sequence attends over the C rows of its cache, masked by the per-row
// positions (kv_pos < 0 is empty; a key is visible iff 0 <= q_pos - kv_pos
// and, with a window, q_pos - kv_pos < window), with an f32 online softmax
// and the G query heads of a kv head stacked.  A row with no visible key
// outputs 0.  Plain version: `kernels.ref.single_query_attention`
// (oracle `kernels.ref.decode_attention_ref`).
//
// What bounds it on this card: bytes.  Each (row, kv head) reads C x hd
// floats of K and of V once and does 4 G flops per element, below the ~20
// flops/byte at which the f32 units would be the limit; the floor is the
// cache bytes over HBM bandwidth.
//
// What the design does about it:
//   * One CTA per (row, kv head) carries all G query rows of the group,
//     so each K/V row is read once for the G heads that share it; its
//     threads cover hd (at least 256 of them, so that short heads still
//     have 8 warps on the scores).
//   * The cache is walked in tiles of 64 rows.  Scores: warp w takes rows
//     w, w + nwarps, ...; its lanes stride over hd, so each K row is one
//     coalesced sweep, reduced with warp shuffles.  The mask comes from
//     the stored positions, never from the row index: a rolling ring
//     holds its positions out of order.
//   * Softmax: one warp per query row reduces the tile's 64 scores with
//     shuffles (max, then the sum of exp), so no thread walks a tile
//     alone.  The probabilities go through shared memory to the V update,
//     one coalesced row read per cache row for the whole CTA.
//   * The kernel is instantiated for G <= 1, 2, 4, 8, 16 under
//     __launch_bounds__(1024): the per-thread accumulators (one per query
//     row) stay in registers at hd = 1024 (the paged-decode lesson: one
//     instantiation for G = 16 at 896 threads could not launch).
//   * expf, no fast-math: the result stays within f32 rounding of the
//     plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 16;  // largest GQA group (H / KV) taken
constexpr int kTile = 64;      // cache rows per tile

template <int kMaxG>
__global__ void __launch_bounds__(1024)
    decode_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ kv_pos,
                            const int* __restrict__ q_pos,
                            float* __restrict__ out, int C, int H, int KV,
                            int hd, int window, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  float* q_s = smem;               // (G, hd) query rows of this group
  float* sc = q_s + G * hd;        // (G, kTile) scores, then probabilities
  float* alpha_s = sc + G * kTile;  // (G,) rescale of this tile
  float* l_s = alpha_s + G;        // (G,) running denominators
  float* m_s = l_s + G;            // (G,) running maxima
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row_stride = (size_t)KV * hd;  // between cache rows

  const float* qg = q + ((size_t)b * H + (size_t)h * G) * hd;
  for (int e = tid; e < G * hd; e += blockDim.x) q_s[e] = qg[e];
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.0f;
  const int qp = q_pos[b];
  const int* pos_b = kv_pos + (size_t)b * C;
  const float* kb = k + (size_t)b * C * row_stride + (size_t)h * hd;
  const float* vb = v + (size_t)b * C * row_stride + (size_t)h * hd;
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int nrow = min(kTile, C - c0);
    for (int t = warp; t < kTile; t += nwarps) {
      bool valid = false;
      if (t < nrow) {
        const int kp = pos_b[c0 + t];
        const int d = qp - kp;
        valid = kp >= 0 && d >= 0 && (window <= 0 || d < window);
      }
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.0f;
      if (valid) {
        const float* kr = kb + (size_t)(c0 + t) * row_stride;
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
          float x = part[g];
          for (int o = 16; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
          if (lane == 0) sc[g * kTile + t] = valid ? x * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query row, two scores per lane
    for (int g = warp; g < G; g += nwarps) {
      float* row = sc + g * kTile;
      const float s0 = row[lane], s1 = row[lane + 32];
      float mb = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mb);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float p0 = s0 == -INFINITY ? 0.0f : expf(s0 - m_safe);
      const float p1 = s1 == -INFINITY ? 0.0f : expf(s1 - m_safe);
      float ps = p0 + p1;
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) {
        const float a = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    if (tid < hd) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= alpha_s[g];
      for (int t = 0; t < nrow; ++t) {
        const float vv = vb[(size_t)(c0 + t) * row_stride + tid];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(sc[g * kTile + t], vv, acc[g]);
      }
    }
    __syncthreads();  // sc is rewritten by the next tile
  }

  if (tid < hd) {
    float* og = out + ((size_t)b * H + (size_t)h * G) * hd;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) og[(size_t)g * hd + tid] = acc[g] / fmaxf(l_s[g], 1e-30f);
  }
}

template <int kMaxG>
int launch(const float* q, const float* k, const float* v, const int* kv_pos,
           const int* q_pos, float* out, int B, int C, int H, int KV, int hd,
           int window, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * ((size_t)G * hd + (size_t)G * kTile + 3 * G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<kMaxG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((hd + 31) / 32) * 32;
  if (threads < 256) threads = 256;
  decode_attention_kernel<kMaxG><<<B * KV, threads, smem, stream>>>(
      q, k, v, kv_pos, q_pos, out, C, H, KV, hd, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_pos,
                                       const void* q_pos, void* out, int B,
                                       int C, int H, int KV, int hd,
                                       int window, float scale, void* stream) {
  if (B < 0 || C < 0 || KV < 1 || H % KV != 0 || H / KV > kMaxGroup ||
      hd < 1 || hd > 1024)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int G = H / KV;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const int* kp = (const int*)kv_pos;
  const int* qp = (const int*)q_pos;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (G <= 1)
    return launch<1>(qf, kf, vf, kp, qp, o, B, C, H, KV, hd, window, scale, st);
  if (G <= 2)
    return launch<2>(qf, kf, vf, kp, qp, o, B, C, H, KV, hd, window, scale, st);
  if (G <= 4)
    return launch<4>(qf, kf, vf, kp, qp, o, B, C, H, KV, hd, window, scale, st);
  if (G <= 8)
    return launch<8>(qf, kf, vf, kp, qp, o, B, C, H, KV, hd, window, scale, st);
  return launch<16>(qf, kf, vf, kp, qp, o, B, C, H, KV, hd, window, scale, st);
}
