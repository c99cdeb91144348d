// Single-token decode attention over a dense (possibly rolling) KV cache
// for Hopper (sm_90a): split-K with the merge in the same launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:102
// `decode_attention` (body `_decode_kernel`, :34): one query token per
// sequence attends over the C rows of its cache, masked by the per-row
// positions (kv_pos < 0 is empty; a key is visible iff 0 <= q_pos - kv_pos
// and, with a window, q_pos - kv_pos < window), with an f32 softmax and
// the G query heads of a kv head stacked.  A row with no visible key
// outputs 0.  Plain version: `kernels.ref.single_query_attention`
// (oracle `kernels.ref.decode_attention_ref`; the split arithmetic on the
// CPU: `kernels.ref.decode_attention_split_ref`).
//
// What bounds it on this card: bytes.  Each (row, kv head) reads C x hd
// floats of K and of V once and does 4 G flops per element, below the ~20
// flops/byte at which the f32 units would be the limit; the floor is the
// cache bytes over HBM bandwidth (0.00065 ms at the serving shape B=8,
// C=256, H=14, KV=2, hd=64).  At such a shape the cost is latency: B KV
// CTAs (16) walking the cache row by row leave 116 of 132 SMs idle.
//
// What the design does about it (flash-decoding):
//   * Grid B x KV x nsplit: each CTA takes a run of R consecutive cache
//     rows (the last run ragged).  The wrapper picks nsplit for about one
//     wave on the card's SMs with R >= 32 (`kernels.decode_attention.
//     split_plan`): 8 splits of 32 rows, 128 CTAs, at the serving shape.
//   * A CTA brings its run of K and V into shared memory by 16-byte
//     cp.async (4-byte copies where hd % 4 != 0 or a tensor is unaligned),
//     all of it at once where it fits (T = R rows; wide heads walk the run
//     in T-row chunks through a two-stage ring), so DRAM latency is paid
//     once per run, not once per row.  V lands while the scores and the
//     softmax run.
//   * Every warp takes part in every phase: scores a warp per cache row
//     (lanes over hd, the G dots reduced by shuffles), the softmax a warp
//     per query row, and P V a thread per (query rows, dim) with all
//     threads busy (ngrp = threads / hd groups of query rows).
//   * The merge is in the same launch: each CTA writes its partial
//     (m, l, acc[G][hd]) to a workspace, fences, and takes a ticket on a
//     per-(row, kv head) arrival counter; the CTA that draws the last
//     ticket merges the nsplit partials with log-sum-exp weights, writes
//     out and resets the counter to 0, so the counters stay zero between
//     calls with no memset launch.  A run with no visible key has m = -inf
//     and l = 0 and weighs 0; a row with no visible key at all outputs 0.
//     With nsplit = 1 a CTA writes out directly.
//   * Optionally (a non-null lse) each (row, head)'s log-sum-exp of its
//     visible scores, lse = m + log l (-inf where no key is visible), from
//     the same m and l: what a caller needs to merge the outputs of
//     several sequence shards of one cache (`parallel.shard_attention.
//     lse_merge`).  A null lse writes nothing more.
//   * Instantiated per G bound (1, 2, 4, 8, 16) under __launch_bounds__
//     (1024), so the per-thread partial dots and accumulators stay in
//     registers at hd = 896.
//   * expf, no fast-math: the result stays within f32 rounding of the
//     plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 16;              // largest GQA group (H / KV) taken
constexpr int kMaxSplit = 1024;            // splits per (row, kv head)
constexpr int kMaxSmem = 200 * 1024;       // bytes of shared memory
constexpr int kRingBytes = 112 * 1024;     // the K/V ring's share of it
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n cache rows (row t at src + t * gstride, hd floats) into dst, packed
// (row stride hd), one commit group.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t gstride, int n, int hd,
                                          bool vec, int tid, int nthreads) {
  if (vec) {
    const int cpr = hd >> 2;
    for (int e = tid; e < n * cpr; e += nthreads) {
      const int t = e / cpr, d = (e - t * cpr) << 2;
      cp_async16(dst + t * hd + d, src + t * gstride + d);
    }
  } else {
    for (int e = tid; e < n * hd; e += nthreads) {
      const int t = e / hd, d = e - t * hd;
      cp_async4(dst + e, src + t * gstride + d);
    }
  }
  cp_commit();
}

template <int kMaxG>
__global__ void __launch_bounds__(1024)
    decode_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ kv_pos,
                            const int* __restrict__ q_pos,
                            float* __restrict__ out,
                            float* __restrict__ lse, float* part,
                            int* counters, int C, int H, int KV, int hd,
                            int window, float scale, int nsplit, int R,
                            int T, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / KV;
  const int sp = blockIdx.x % nsplit;
  const int bh = blockIdx.x / nsplit;   // (row, kv head)
  const int b = bh / KV;
  const int h = bh % KV;
  const int c_lo = sp * R;
  const int c_hi = min(C, c_lo + R);
  float* ring = smem;               // 2 stages x (K, V) x (T, hd)
  float* q_s = ring + 4 * T * hd;   // (G, hd) query rows of this group
  float* sc = q_s + G * hd;         // (G, T) scores, then probabilities
  float* m_s = sc + G * T;          // (G,) running maxima
  float* l_s = m_s + G;             // (G,) running denominators
  float* a_s = l_s + G;             // (G,) rescale of this chunk
  float* w_s = a_s + G;             // (nsplit, G) merge weights
  float* L_s = w_s + nsplit * G;    // (G,) merged denominators
  int* vis_s = (int*)(L_s + G);     // (T,) visibility of the chunk's rows
  int* last_s = vis_s + T;          // this CTA merges
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const size_t rs = (size_t)KV * hd;   // between cache rows
  const float* kb = k + (size_t)b * C * rs + (size_t)h * hd;
  const float* vb = v + (size_t)b * C * rs + (size_t)h * hd;
  const int* pos_b = kv_pos + (size_t)b * C;
  const int nch = c_hi > c_lo ? (c_hi - c_lo + T - 1) / T : 0;

  auto fetch = [&](int ch) {  // chunk ch: K then V, two groups
    const int c0 = c_lo + ch * T, n = min(T, c_hi - c0);
    float* ks = ring + (ch & 1) * 2 * T * hd;
    load_rows(ks, kb + (size_t)c0 * rs, rs, n, hd, vec, tid, nthreads);
    load_rows(ks + T * hd, vb + (size_t)c0 * rs, rs, n, hd, vec, tid,
              nthreads);
  };
  if (nch > 0) fetch(0);

  const float* qg = q + ((size_t)b * H + (size_t)h * G) * hd;
  for (int e = tid; e < G * hd; e += nthreads) q_s[e] = qg[e];
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  const int qp = q_pos[b];
  // P V: thread (grp, d) owns query rows grp, grp + ngrp, ... of dim d
  const int ngrp = nthreads / hd;
  const int d = tid % hd;
  const int grp = tid / hd;
  float acc[kMaxG];
#pragma unroll
  for (int r = 0; r < kMaxG; ++r) acc[r] = 0.0f;

  for (int ch = 0; ch < nch; ++ch) {
    const int c0 = c_lo + ch * T, n = min(T, c_hi - c0);
    const float* ks = ring + (ch & 1) * 2 * T * hd;
    const float* vs = ks + T * hd;
    const bool more = ch + 1 < nch;
    if (more) fetch(ch + 1);
    for (int t = tid; t < n; t += nthreads) {
      const int kp = pos_b[c0 + t];
      const int dd = qp - kp;
      vis_s[t] = kp >= 0 && dd >= 0 && (window <= 0 || dd < window);
    }
    if (more)
      cp_wait<3>();  // K of this chunk landed
    else
      cp_wait<1>();
    __syncthreads();

    // scores: a warp per cache row, lanes over hd
    for (int t = warp; t < n; t += nwarps) {
      const bool valid = vis_s[t];
      float part_g[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part_g[g] = 0.0f;
      if (valid) {
        const float* kr = ks + t * hd;
        for (int dd = lane; dd < hd; dd += 32) {
          const float kv = kr[dd];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) part_g[g] = fmaf(q_s[g * hd + dd], kv, part_g[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float x = part_g[g];
          for (int o = 16; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
          if (lane == 0) sc[g * T + t] = valid ? x * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // softmax over the chunk: a warp per query row
    for (int g = warp; g < G; g += nwarps) {
      float* row = sc + g * T;
      float mb = -INFINITY;
      for (int t = lane; t < n; t += 32) mb = fmaxf(mb, row[t]);
      for (int o = 16; o > 0; o >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mb);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float ps = 0.0f;
      for (int t = lane; t < n; t += 32) {
        const float s = row[t];
        const float p = s == -INFINITY ? 0.0f : expf(s - m_safe);
        row[t] = p;
        ps += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      if (lane == 0) {
        const float a = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
        a_s[g] = a;
        l_s[g] = l_s[g] * a + ps;
        m_s[g] = m_new;
      }
    }
    if (more)
      cp_wait<2>();  // V of this chunk landed
    else
      cp_wait<0>();
    __syncthreads();

    // acc = acc * alpha + P V
    if (grp < ngrp) {
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) {
        const int g = grp + r * ngrp;
        if (g < G) {
          const float* pr = sc + g * T;
          float x = acc[r] * a_s[g];
          for (int t = 0; t < n; ++t) x = fmaf(pr[t], vs[t * hd + d], x);
          acc[r] = x;
        }
      }
    }
    __syncthreads();  // the stage, sc and vis_s are rewritten next chunk
  }

  float* og = out + ((size_t)b * H + (size_t)h * G) * hd;
  if (nsplit == 1) {
    if (grp < ngrp) {
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) {
        const int g = grp + r * ngrp;
        if (g < G) og[(size_t)g * hd + d] = acc[r] / fmaxf(l_s[g], 1e-30f);
      }
    }
    if (lse != nullptr && tid < G) {
      const float l = l_s[tid];
      lse[(size_t)b * H + (size_t)h * G + tid] =
          l > 0.0f ? m_s[tid] + logf(l) : -INFINITY;
    }
    return;
  }

  // this split's partial: acc (G, hd) of CTA x at part + x G hd, then
  // (m, l) (2, G) of CTA x past all the accumulators
  const size_t nacc = (size_t)gridDim.x * G * hd;
  float* pa = part + (size_t)blockIdx.x * G * hd;
  if (grp < ngrp) {
#pragma unroll
    for (int r = 0; r < kMaxG; ++r) {
      const int g = grp + r * ngrp;
      if (g < G) pa[(size_t)g * hd + d] = acc[r];
    }
  }
  if (tid < G) {
    float* pml = part + nacc + (size_t)blockIdx.x * 2 * G;
    pml[tid] = m_s[tid];
    pml[G + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_s = atomicAdd(counters + bh, 1) == nsplit - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();

  // the last CTA of (row, kv head) merges its nsplit partials
  const size_t x0 = (size_t)bh * nsplit;   // CTA index of split 0
  for (int g = warp; g < G; g += nwarps) {
    float M = -INFINITY;
    for (int s = lane; s < nsplit; s += 32)
      M = fmaxf(M, __ldcg(part + nacc + (x0 + s) * 2 * G + g));
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float M_safe = isfinite(M) ? M : 0.0f;
    float L = 0.0f;
    for (int s = lane; s < nsplit; s += 32) {
      const float* pml = part + nacc + (x0 + s) * 2 * G;
      const float m = __ldcg(pml + g);
      const float w = isfinite(m) ? expf(m - M_safe) : 0.0f;
      w_s[s * G + g] = w;
      L += w * __ldcg(pml + G + g);
    }
    for (int o = 16; o > 0; o >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, o);
    if (lane == 0) {
      L_s[g] = L;
      if (lse != nullptr)
        lse[(size_t)b * H + (size_t)h * G + g] =
            L > 0.0f ? M_safe + logf(L) : -INFINITY;
    }
  }
  __syncthreads();
  const float* p0 = part + x0 * G * hd;
  for (int e = tid; e < G * hd; e += nthreads) {
    const int g = e / hd;
    float o = 0.0f;
    for (int s = 0; s < nsplit; ++s)
      o = fmaf(w_s[s * G + g], __ldcg(p0 + (size_t)s * G * hd + e), o);
    og[e] = o / fmaxf(L_s[g], 1e-30f);
  }
  if (tid == 0) counters[bh] = 0;
}

// Shared memory (bytes) of one CTA.
size_t smem_bytes(int G, int hd, int T, int nsplit) {
  return sizeof(float) * ((size_t)4 * T * hd + (size_t)G * hd +
                          (size_t)G * T + 4 * (size_t)G +
                          (size_t)nsplit * G) +
         sizeof(int) * ((size_t)T + 1);
}

// Raise the kernel's dynamic shared-memory limit once per device.
template <int kMaxG>
cudaError_t configure() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(decode_attention_kernel<kMaxG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

// Rows per chunk: the whole split where the ring holds it, else the most
// that fit; 0 where even one row does not.
int chunk_rows(int G, int hd, int R, int nsplit) {
  const int fit = kRingBytes / (16 * hd);
  int T = fit < 1 ? 1 : (fit < R ? fit : R);
  while (T > 1 && smem_bytes(G, hd, T, nsplit) > (size_t)kMaxSmem) --T;
  return smem_bytes(G, hd, T, nsplit) > (size_t)kMaxSmem ? 0 : T;
}

template <int kMaxG>
int launch(const float* q, const float* k, const float* v, const int* kv_pos,
           const int* q_pos, float* out, float* lse, float* part,
           int* counters, int B,
           int C, int H, int KV, int hd, int window, float scale, int nsplit,
           int R, int T, int vec, cudaStream_t stream) {
  cudaError_t e = configure<kMaxG>();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(H / KV, hd, T, nsplit);
  int threads = ((hd + 31) / 32) * 32;
  if (threads < 256) threads = 256;
  decode_attention_kernel<kMaxG><<<B * KV * nsplit, threads, smem, stream>>>(
      q, k, v, kv_pos, q_pos, out, lse, part, counters, C, H, KV, hd, window,
      scale, nsplit, R, T, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// lse: null, or (B, H) floats for each (row, head)'s log-sum-exp;
// part: nsplit > 1: B KV nsplit (G hd + 2 G) floats of workspace;
// counters: B KV ints, zero (the kernel leaves them zero).  nsplit and R
// (rows per split) come from the wrapper's plan.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_pos,
    const void* q_pos, void* out, void* lse, void* part, void* counters,
    int B, int C,
    int H, int KV, int hd, int window, float scale, int nsplit, int R,
    void* stream) {
  if (B < 0 || C < 0 || KV < 1 || H % KV != 0 || H / KV > kMaxGroup ||
      H < 1 || hd < 1 || hd > 1024 || nsplit < 1 || nsplit > kMaxSplit ||
      R < 1 || (long long)nsplit * R < C ||
      (nsplit > 1 && (long long)(nsplit - 1) * R >= C) ||
      (long long)B * KV * nsplit > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int G = H / KV;
  const int T = chunk_rows(G, hd, R, nsplit);
  if (T == 0) return (int)cudaErrorInvalidValue;
  const int vec =
      hd % 4 == 0 && (((uintptr_t)k | (uintptr_t)v) & 15) == 0;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const int* kp = (const int*)kv_pos;
  const int* qp = (const int*)q_pos;
  float* o = (float*)out;
  float* ls = (float*)lse;
  float* pw = (float*)part;
  int* cn = (int*)counters;
  cudaStream_t st = (cudaStream_t)stream;
#define DECODE_LAUNCH(MG)                                                  \
  return launch<MG>(qf, kf, vf, kp, qp, o, ls, pw, cn, B, C, H, KV, hd,    \
                    window, scale, nsplit, R, T, vec, st)
  if (G <= 1) DECODE_LAUNCH(1);
  if (G <= 2) DECODE_LAUNCH(2);
  if (G <= 4) DECODE_LAUNCH(4);
  if (G <= 8) DECODE_LAUNCH(8);
  DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
}
