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
//
// The kernel is templated on the element type of q, k and v.  The bf16
// instantiation (`decode_attention_bf16_launch`) computes what the TPU
// kernel computes on bf16 inputs: scores from exact bf16 x bf16 products
// summed in f32, the same f32 softmax, P rounded to bf16 (nearest even)
// before P V with f32 sums, l summed from the unrounded P, the output in
// bf16 — or in f32 where the log-sum-exp is asked for, so that the
// partials of several shards are rounded once, after their merge.  Its
// bound is bytes too, half the f32 path's.  Where hd is a multiple of 16
// up to 128 (the main path's hd = 64) it runs as `decode_tc_kernel`
// below, its products on the tensor cores; elsewhere (hd = 896, 18, 40,
// 256) it keeps the CUDA-core phases above, whose ring holds twice the
// rows in the same 112 KB and whose 16-byte cp.async carries 8 values.
// Both keep the split-K plan and the merge in the same launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxGroup = 16;              // largest GQA group (H / KV) taken
constexpr int kMaxSplit = 1024;            // splits per (row, kv head)
constexpr int kMaxSmem = 200 * 1024;       // bytes of shared memory
constexpr int kRingBytes = 112 * 1024;     // the K/V ring's share of it
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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

// Elements in one 16-byte copy
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// One element: f32 by a 4-byte cp.async; bf16 (2 bytes, below cp.async's
// smallest copy) by a plain load and store, which the barrier before the
// rows are read publishes as it publishes the cp.async.
__device__ __forceinline__ void copy1(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void copy1(bf16* dst, const bf16* src) {
  *dst = *src;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// P as P V takes it: bf16 rounds it (nearest even), f32 keeps it
template <typename T>
__device__ __forceinline__ float p_as(float p) {
  if constexpr (std::is_same<T, float>::value)
    return p;
  else
    return __bfloat162float(__float2bfloat16_rn(p));
}

// Output element i: f32 where `f32` (always for T = float), else T.
template <typename T>
__device__ __forceinline__ void put(void* out, size_t i, float x, bool f32) {
  if (std::is_same<T, float>::value || f32)
    static_cast<float*>(out)[i] = x;
  else
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(x);
}

// n cache rows (row t at src + t * gstride, hd elements) into dst, packed
// (row stride hd), one commit group.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          size_t gstride, int n, int hd,
                                          bool vec, int tid, int nthreads) {
  if (vec) {
    const int cpr = hd / kVec<T>;
    for (int e = tid; e < n * cpr; e += nthreads) {
      const int t = e / cpr, d = (e - t * cpr) * kVec<T>;
      cp_async16(dst + t * hd + d, src + t * gstride + d);
    }
  } else {
    for (int e = tid; e < n * hd; e += nthreads) {
      const int t = e / hd, d = e - t * hd;
      copy1(dst + e, src + t * gstride + d);
    }
  }
  cp_commit();
}

// After every CTA of (row, kv head) ``bh`` wrote its split's partial —
// acc (G, hd) of CTA x at part + x G hd, then (m, l) (2, G) of CTA x
// past all ``nacc`` accumulators — each takes a ticket on the pair's
// arrival counter; the CTA that draws the last merges the nsplit
// partials with log-sum-exp weights (w_s: nsplit G, L_s: G floats of
// shared memory), writes out (at ``og``) and the lse (at ``lse_off``),
// and resets the counter to 0.
template <typename E>
__device__ __forceinline__ void finish_splits(
    const float* part, size_t nacc, int bh, int nsplit, int G, int hd,
    size_t og, size_t lse_off, void* out, float* lse, bool out_f32,
    float* w_s, float* L_s, int* last_s, int* counters) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
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
        lse[lse_off + g] = L > 0.0f ? M_safe + logf(L) : -INFINITY;
    }
  }
  __syncthreads();
  const float* p0 = part + x0 * G * hd;
  for (int e = tid; e < G * hd; e += nthreads) {
    const int g = e / hd;
    float o = 0.0f;
    for (int s = 0; s < nsplit; ++s)
      o = fmaf(w_s[s * G + g], __ldcg(p0 + (size_t)s * G * hd + e), o);
    put<E>(out, og + e, o / fmaxf(L_s[g], 1e-30f), out_f32);
  }
  if (tid == 0) counters[bh] = 0;
}

template <typename E, int kMaxG>
__global__ void __launch_bounds__(1024)
    decode_attention_kernel(const E* __restrict__ q, const E* __restrict__ k,
                            const E* __restrict__ v,
                            const int* __restrict__ kv_pos,
                            const int* __restrict__ q_pos,
                            void* __restrict__ out,
                            float* __restrict__ lse, float* part,
                            int* counters, int C, int H, int KV, int hd,
                            int window, float scale, int nsplit, int R,
                            int T, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  const int sp = blockIdx.x % nsplit;
  const int bh = blockIdx.x / nsplit;   // (row, kv head)
  const int b = bh / KV;
  const int h = bh % KV;
  const int c_lo = sp * R;
  const int c_hi = min(C, c_lo + R);
  const bool out_f32 = lse != nullptr;  // bf16: f32 partials with an lse
  E* ring = reinterpret_cast<E*>(smem_raw);  // 2 stages x (K, V) x (T, hd)
  float* q_s = reinterpret_cast<float*>(ring + 4 * T * hd);  // (G, hd)
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
  const E* kb = k + (size_t)b * C * rs + (size_t)h * hd;
  const E* vb = v + (size_t)b * C * rs + (size_t)h * hd;
  const int* pos_b = kv_pos + (size_t)b * C;
  const int nch = c_hi > c_lo ? (c_hi - c_lo + T - 1) / T : 0;

  auto fetch = [&](int ch) {  // chunk ch: K then V, two groups
    const int c0 = c_lo + ch * T, n = min(T, c_hi - c0);
    E* ks = ring + (ch & 1) * 2 * T * hd;
    load_rows(ks, kb + (size_t)c0 * rs, rs, n, hd, vec, tid, nthreads);
    load_rows(ks + T * hd, vb + (size_t)c0 * rs, rs, n, hd, vec, tid,
              nthreads);
  };
  if (nch > 0) fetch(0);

  const E* qg = q + ((size_t)b * H + (size_t)h * G) * hd;
  for (int e = tid; e < G * hd; e += nthreads) q_s[e] = to_f(qg[e]);
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
    const E* ks = ring + (ch & 1) * 2 * T * hd;
    const E* vs = ks + T * hd;
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
        const E* kr = ks + t * hd;
        for (int dd = lane; dd < hd; dd += 32) {
          const float kv = to_f(kr[dd]);
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
        row[t] = p_as<E>(p);
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
          for (int t = 0; t < n; ++t)
            x = fmaf(pr[t], to_f(vs[t * hd + d]), x);
          acc[r] = x;
        }
      }
    }
    __syncthreads();  // the stage, sc and vis_s are rewritten next chunk
  }

  const size_t og = ((size_t)b * H + (size_t)h * G) * hd;  // out's offset
  if (nsplit == 1) {
    if (grp < ngrp) {
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) {
        const int g = grp + r * ngrp;
        if (g < G)
          put<E>(out, og + (size_t)g * hd + d,
                 acc[r] / fmaxf(l_s[g], 1e-30f), out_f32);
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
  finish_splits<E>(part, nacc, bh, nsplit, G, hd, og,
                   (size_t)b * H + (size_t)h * G, out, lse, out_f32, w_s,
                   L_s, last_s, counters);
}

// ------------------------------------------ the bf16 tensor-core form ----
//
// Where hd is a multiple of 16 up to 128 and q, k, v are 16-byte aligned,
// the bf16 entry launches this kernel instead: the same grid, split plan,
// workspace, merge and outputs, the products on the tensor cores.  The
// G <= 16 query rows of a (row, kv head) are the M side of
// mma.sync.m16n8k16 (rows past G are zero queries, never written), as in
// the flash kernel: S = Q K^T takes K's B fragments by ldmatrix, O += P V
// takes V's by ldmatrix.trans, and P goes from the score accumulators to
// P V's A operand as bf16 pairs.  The work is tiny for the tensor cores
// (4 G hd flops a key against 4 hd bytes), so the design is about the
// bytes: each of a CTA's 4 warps walks its own tiles of 32 keys (tiles w,
// w + 4, ... of the run) through its own two-stage ring — K, V and the
// tile's positions by cp.async, 16 bytes a copy — waiting on nothing but
// its own copies (cp.async.wait_group, __syncwarp), so no barrier of the
// CTA stalls the stream; a CTA takes ~77 KB at hd = 64, so two share an
// SM and 8 warps an SM keep 64 KB in flight.  The warps' (m, l, acc)
// merge through shared memory at the end, then the splits as above.
// Scores are in base 2 (the scale folds log2 e, exp2f); m goes out in
// natural units.

constexpr int kTcWarps = 4;   // warps of a CTA, each its own stream of tiles
constexpr int kTcKeys = 32;   // keys a tile (one position a lane)
constexpr float kLn2 = 0.6931471805599453f;

// 16 (4) bytes from global to shared memory, or zero-fill them (src-size
// 0: nothing is read) where `full` is false.
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool full) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4z(void* dst, const void* src,
                                           bool full) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0));
}

// Bytes of one stage of a warp's ring: the K and V tiles (kTcKeys rows
// of st bf16 each) and the tile's kTcKeys positions.
__host__ __device__ constexpr int tc_stage_bytes(int st) {
  return 4 * kTcKeys * st + 4 * kTcKeys;
}

// kNT: n8 tiles of output a warp carries, hd / 8 <= kNT (8 up to hd = 64,
// 16 up to 128).
template <int kNT>
__global__ void __launch_bounds__(kTcWarps * 32)
    decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ kv_pos,
                     const int* __restrict__ q_pos, void* __restrict__ out,
                     float* __restrict__ lse, float* part, int* counters,
                     int C, int H, int KV, int hd, int window, float scale,
                     int nsplit, int R) {
  static_assert(kTcKeys == 32, "one position a lane");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  const int sp = blockIdx.x % nsplit;
  const int bh = blockIdx.x / nsplit;   // (row, kv head)
  const int b = bh / KV;
  const int h = bh % KV;
  const int c_lo = sp * R;
  const int c_hi = min(C, c_lo + R);
  const bool out_f32 = lse != nullptr;
  const int st = hd + 8;   // row stride (bf16) of Q, K and V tiles
  const int stage = tc_stage_bytes(st);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g8 = lane >> 2;             // the fragment's row (and B column)
  const int t4 = lane & 3;              // the fragment's column (and B row)
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);      // (16, st)
  unsigned char* rings = smem_raw + 32 * st;           // kTcWarps x 2 stages
  unsigned char* ring = rings + warp * 2 * stage;
  const size_t rs = (size_t)KV * hd;    // between cache rows
  const bf16* kb = k + (size_t)b * C * rs + (size_t)h * hd;
  const bf16* vb = v + (size_t)b * C * rs + (size_t)h * hd;
  const int* pos_b = kv_pos + (size_t)b * C;
  const int qp = q_pos[b];
  const float scale2 = scale * 1.4426950408889634f;  // base-2 logits
  const int cpr = hd >> 3;              // 16-byte chunks a row

  // Q: row g < G is head h G + g; rows G .. 15 are zero
  const bf16* qg = q + ((size_t)b * H + (size_t)h * G) * hd;
  for (int e = tid; e < 16 * cpr; e += blockDim.x) {
    const int r = e / cpr, d = (e - r * cpr) << 3;
    cp_async16z(q_s + r * st + d, r < G ? qg + (size_t)r * hd + d : qg,
                r < G);
  }
  cp_commit();

  // warp w takes the run's tiles w, w + kTcWarps, ...: its n-th lands in
  // stage n & 1 of its own ring, copied and awaited by its own lanes
  const int ntile = c_hi > c_lo ? (c_hi - c_lo + kTcKeys - 1) / kTcKeys : 0;
  const int nmine =
      ntile > warp ? (ntile - warp + kTcWarps - 1) / kTcWarps : 0;
  auto fetch = [&](int n) {
    const int j0 = c_lo + (n * kTcWarps + warp) * kTcKeys;
    bf16* ks = reinterpret_cast<bf16*>(ring + (n & 1) * stage);
    bf16* vs = ks + kTcKeys * st;
    for (int e = lane; e < kTcKeys * cpr; e += 32) {
      const int c = e / cpr, d = (e - c * cpr) << 3;
      const bool full = j0 + c < c_hi;
      const size_t off = (size_t)(full ? j0 + c : 0) * rs + d;
      cp_async16z(ks + c * st + d, kb + off, full);
      cp_async16z(vs + c * st + d, vb + off, full);
    }
    const bool full = j0 + lane < c_hi;
    cp_async4z(reinterpret_cast<int*>(vs + kTcKeys * st) + lane,
               pos_b + (full ? j0 + lane : 0), full);
    cp_commit();
  };
  if (nmine > 0) fetch(0);
  if (nmine > 0) cp_wait<1>(); else cp_wait<0>();
  __syncthreads();  // Q landed for every warp

  // Q's A fragments, one a 16-dim step, kept in registers
  uint32_t qf[kNT / 2][4];
  {
    const bf16* qa = q_s + (lane & 15) * st + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk)
      if (kk * 16 < hd) ldsm_x4(qf[kk], qa + kk * 16);
  }
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int n = 0; n < nmine; ++n) {
    const int j0 = c_lo + (n * kTcWarps + warp) * kTcKeys;
    cp_wait<0>();  // tile n landed, for this lane's copies
    __syncwarp();  // ... for the warp's; tile n - 1's stage is free
    if (n + 1 < nmine) fetch(n + 1);
    const bf16* ks = reinterpret_cast<const bf16*>(ring + (n & 1) * stage);
    const bf16* vs = ks + kTcKeys * st;
    const int* ps = reinterpret_cast<const int*>(vs + kTcKeys * st);

    // S = Q K^T: the 16 query rows against the tile's keys (ldmatrix
    // rows: keys lane % 8 + 8 (lane / 16), dims 8 ((lane / 8) % 2) on)
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int c = 0; c < kTcKeys / 8; ++c)
      s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.0f;
    const bf16* ka = ks + ((lane & 7) + (lane >> 4) * 8) * st +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      if (kk * 16 < hd) {
#pragma unroll
        for (int c = 0; c < kTcKeys / 8; c += 2) {
          uint32_t bb[4];
          ldsm_x4(bb, ka + c * 8 * st + kk * 16);
          mma_bf16(s[c], qf[kk], bb[0], bb[1]);
          mma_bf16(s[c + 1], qf[kk], bb[2], bb[3]);
        }
      }
    }

    // scale and mask by the stored positions: c0/c1 are row g8, keys
    // 8 c + 2 t4 and + 1; c2/c3 row g8 + 8, the same keys
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < kTcKeys / 8; ++c) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = c * 8 + 2 * t4 + hh;
        const int dd = qp - ps[t];
        const bool vis = j0 + t < c_hi && ps[t] >= 0 && dd >= 0 &&
                         (window <= 0 || dd < window);
        s[c][hh] = vis ? s[c][hh] * scale2 : -INFINITY;
        s[c][2 + hh] = vis ? s[c][2 + hh] * scale2 : -INFINITY;
        mx0 = fmaxf(mx0, s[c][hh]);
        mx1 = fmaxf(mx1, s[c][2 + hh]);
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
    for (int c = 0; c < kTcKeys / 8; ++c) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        s[c][hh] = s[c][hh] == -INFINITY ? 0.0f : exp2f(s[c][hh] - ms0);
        s[c][2 + hh] =
            s[c][2 + hh] == -INFINITY ? 0.0f : exp2f(s[c][2 + hh] - ms1);
        ps0 += s[c][hh];
        ps1 += s[c][2 + hh];
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

    // O += P V: the S accumulators of key tiles 2 c and 2 c + 1 are the
    // A fragment of step c, as bf16 pairs; V's B fragments of two n8 dim
    // tiles by ldmatrix.trans (keys lane % 8 + 8 ((lane / 8) % 2), dims
    // 8 (lane / 16) on)
    const bf16* va = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * st +
                     (lane >> 4) * 8;
#pragma unroll
    for (int c = 0; c < kTcKeys / 16; ++c) {
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        if (j * 8 < hd) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, va + c * 16 * st + j * 8);
          mma_bf16(acc[j], a, bb[0], bb[1]);
          mma_bf16(acc[j + 1], a, bb[2], bb[3]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with its ring

  // the warps' (m, l, acc) through the rings: xw (kTcWarps, 2, 16), then
  // xa (kTcWarps, G, hd); the CTA's merge weighs warp w's row g by
  // 2^(m_w - M)
  float* xw = reinterpret_cast<float*>(rings);
  float* xa = xw + kTcWarps * 32;
  if (t4 == 0) {
    xw[warp * 32 + g8] = m0;
    xw[warp * 32 + g8 + 8] = m1;
    xw[warp * 32 + 16 + g8] = l0;
    xw[warp * 32 + 24 + g8] = l1;
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int d = j * 8 + 2 * t4;
    if (d < hd) {
      float* x0 = xa + ((size_t)warp * G + g8) * hd + d;
      if (g8 < G) {
        x0[0] = acc[j][0];
        x0[1] = acc[j][1];
      }
      if (g8 + 8 < G) {
        x0[8 * hd] = acc[j][2];
        x0[8 * hd + 1] = acc[j][3];
      }
    }
  }
  __syncthreads();
  const size_t og = ((size_t)b * H + (size_t)h * G) * hd;  // out's offset
  const size_t nacc = (size_t)gridDim.x * G * hd;
  for (int e = tid; e < G * hd; e += blockDim.x) {
    const int g = e / hd;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) M = fmaxf(M, xw[w * 32 + g]);
    const float M_safe = isfinite(M) ? M : 0.0f;
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) {
      const float mw = xw[w * 32 + g];
      const float wt = isfinite(mw) ? exp2f(mw - M_safe) : 0.0f;
      L += wt * xw[w * 32 + 16 + g];
      A += wt * xa[(size_t)w * G * hd + e];
    }
    // m in natural units for the lse and the splits' merge
    const float Mn = isfinite(M) ? M * kLn2 : -INFINITY;
    if (nsplit == 1) {
      put<bf16>(out, og + e, A / fmaxf(L, 1e-30f), out_f32);
      if (lse != nullptr && e % hd == 0)
        lse[(size_t)b * H + (size_t)h * G + g] =
            L > 0.0f ? Mn + logf(L) : -INFINITY;
    } else {
      part[(size_t)blockIdx.x * G * hd + e] = A;
      if (e % hd == 0) {
        float* pml = part + nacc + (size_t)blockIdx.x * 2 * G;
        pml[g] = Mn;
        pml[G + g] = L;
      }
    }
  }
  if (nsplit == 1) return;
  // the merge's scratch reuses the rings: w_s (nsplit, G), L_s (G), last
  __syncthreads();
  float* w_s = reinterpret_cast<float*>(rings);
  float* L_s = w_s + (size_t)nsplit * G;
  finish_splits<bf16>(part, nacc, bh, nsplit, G, hd, og,
                      (size_t)b * H + (size_t)h * G, out, lse, out_f32, w_s,
                      L_s, reinterpret_cast<int*>(L_s + G), counters);
}

// Shared memory (bytes) of one tensor-core CTA: Q's 16 rows, then the
// warps' rings, which the merges reuse.
size_t tc_smem_bytes(int G, int hd, int nsplit) {
  const size_t st = hd + 8;
  const size_t rings = (size_t)kTcWarps * 2 * tc_stage_bytes((int)st);
  const size_t merge =
      sizeof(float) * ((size_t)kTcWarps * 32 + (size_t)kTcWarps * G * hd);
  const size_t split =
      sizeof(float) * ((size_t)nsplit * G + G) + sizeof(int);
  size_t scratch = rings > merge ? rings : merge;
  if (split > scratch) scratch = split;
  return 32 * st + scratch;
}

// Shared memory (bytes) of one CTA.
template <typename E>
size_t smem_bytes(int G, int hd, int T, int nsplit) {
  return sizeof(E) * (size_t)4 * T * hd +
         sizeof(float) * ((size_t)G * hd + (size_t)G * T + 4 * (size_t)G +
                          (size_t)nsplit * G) +
         sizeof(int) * ((size_t)T + 1);
}

// Raise the kernel's dynamic shared-memory limit once per device.
template <typename E, int kMaxG>
cudaError_t configure() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(decode_attention_kernel<E, kMaxG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

// Rows per chunk: the whole split where the ring holds it, else the most
// that fit (the ring's 2 stages of K and V rows, counted in bytes); 0
// where even one row does not.
template <typename E>
int chunk_rows(int G, int hd, int R, int nsplit) {
  const int fit = kRingBytes / (4 * (int)sizeof(E) * hd);
  int T = fit < 1 ? 1 : (fit < R ? fit : R);
  while (T > 1 && smem_bytes<E>(G, hd, T, nsplit) > (size_t)kMaxSmem) --T;
  return smem_bytes<E>(G, hd, T, nsplit) > (size_t)kMaxSmem ? 0 : T;
}

template <typename E, int kMaxG>
int launch(const E* q, const E* k, const E* v, const int* kv_pos,
           const int* q_pos, void* out, float* lse, float* part,
           int* counters, int B, int C, int H, int KV, int hd, int window,
           float scale, int nsplit, int R, int T, int vec,
           cudaStream_t stream) {
  cudaError_t e = configure<E, kMaxG>();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes<E>(H / KV, hd, T, nsplit);
  int threads = ((hd + 31) / 32) * 32;
  if (threads < 256) threads = 256;
  decode_attention_kernel<E, kMaxG>
      <<<B * KV * nsplit, threads, smem, stream>>>(
          q, k, v, kv_pos, q_pos, out, lse, part, counters, C, H, KV, hd,
          window, scale, nsplit, R, T, vec);
  return (int)cudaGetLastError();
}

template <int kNT>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const int* kv_pos,
              const int* q_pos, void* out, float* lse, float* part,
              int* counters, int B, int C, int H, int KV, int hd, int window,
              float scale, int nsplit, int R, cudaStream_t stream) {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {  // raise the dynamic shared-memory limit once
    e = cudaFuncSetAttribute(decode_tc_kernel<kNT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  const size_t smem = tc_smem_bytes(H / KV, hd, nsplit);
  decode_tc_kernel<kNT><<<B * KV * nsplit, kTcWarps * 32, smem, stream>>>(
      q, k, v, kv_pos, q_pos, out, lse, part, counters, C, H, KV, hd, window,
      scale, nsplit, R);
  return (int)cudaGetLastError();
}

// The entry for element type E: for bf16, the tensor-core kernel where
// hd is a multiple of 16 up to 128 and q, k, v are 16-byte aligned (and
// its shared memory fits); otherwise 16-byte copies where hd is a whole
// number of them and k / v are 16-byte aligned, and the kernel
// instantiated for the smallest G bound that holds the group.
template <typename E>
int entry(const void* q, const void* k, const void* v, const void* kv_pos,
          const void* q_pos, void* out, void* lse, void* part,
          void* counters, int B, int C, int H, int KV, int hd, int window,
          float scale, int nsplit, int R, void* stream) {
  if (B < 0 || C < 0 || KV < 1 || H % KV != 0 || H / KV > kMaxGroup ||
      H < 1 || hd < 1 || hd > 1024 || nsplit < 1 || nsplit > kMaxSplit ||
      R < 1 || (long long)nsplit * R < C ||
      (nsplit > 1 && (long long)(nsplit - 1) * R >= C) ||
      (long long)B * KV * nsplit > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int G = H / KV;
  if constexpr (std::is_same<E, bf16>::value) {
    if (hd % 16 == 0 && hd <= 128 &&
        (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0 &&
        tc_smem_bytes(G, hd, nsplit) <= (size_t)kMaxSmem) {
      const bf16* qb = (const bf16*)q;
      const bf16* kb = (const bf16*)k;
      const bf16* vb = (const bf16*)v;
      const int* kp = (const int*)kv_pos;
      const int* qp = (const int*)q_pos;
      if (hd <= 64)
        return launch_tc<8>(qb, kb, vb, kp, qp, out, (float*)lse,
                            (float*)part, (int*)counters, B, C, H, KV, hd,
                            window, scale, nsplit, R, (cudaStream_t)stream);
      return launch_tc<16>(qb, kb, vb, kp, qp, out, (float*)lse,
                           (float*)part, (int*)counters, B, C, H, KV, hd,
                           window, scale, nsplit, R, (cudaStream_t)stream);
    }
  }
  const int T = chunk_rows<E>(G, hd, R, nsplit);
  if (T == 0) return (int)cudaErrorInvalidValue;
  const int vec =
      hd % kVec<E> == 0 && (((uintptr_t)k | (uintptr_t)v) & 15) == 0;
  const E* qe = (const E*)q;
  const E* ke = (const E*)k;
  const E* ve = (const E*)v;
  const int* kp = (const int*)kv_pos;
  const int* qp = (const int*)q_pos;
  float* ls = (float*)lse;
  float* pw = (float*)part;
  int* cn = (int*)counters;
  cudaStream_t st = (cudaStream_t)stream;
#define DECODE_LAUNCH(MG)                                                   \
  return launch<E, MG>(qe, ke, ve, kp, qp, out, ls, pw, cn, B, C, H, KV, hd, \
                       window, scale, nsplit, R, T, vec, st)
  if (G <= 1) DECODE_LAUNCH(1);
  if (G <= 2) DECODE_LAUNCH(2);
  if (G <= 4) DECODE_LAUNCH(4);
  if (G <= 8) DECODE_LAUNCH(8);
  DECODE_LAUNCH(16);
#undef DECODE_LAUNCH
}

}  // namespace

// q (B, H, hd), k/v (B, C, KV, hd) and out (B, H, hd), f32; kv_pos (B, C)
// and q_pos (B,) int32.  lse: null, or (B, H) floats for each (row,
// head)'s log-sum-exp; part: nsplit > 1: B KV nsplit (G hd + 2 G) floats
// of workspace; counters: B KV ints, zero (the kernel leaves them zero).
// nsplit and R (rows per split) come from the wrapper's plan.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_pos,
    const void* q_pos, void* out, void* lse, void* part, void* counters,
    int B, int C,
    int H, int KV, int hd, int window, float scale, int nsplit, int R,
    void* stream) {
  return entry<float>(q, k, v, kv_pos, q_pos, out, lse, part, counters, B,
                      C, H, KV, hd, window, scale, nsplit, R, stream);
}

// The same with q, k and v in bf16: out (B, H, hd) in bf16 where lse is
// null, in f32 beside a non-null lse.
extern "C" int decode_attention_bf16_launch(
    const void* q, const void* k, const void* v, const void* kv_pos,
    const void* q_pos, void* out, void* lse, void* part, void* counters,
    int B, int C, int H, int KV, int hd, int window, float scale,
    int nsplit, int R, void* stream) {
  return entry<bf16>(q, k, v, kv_pos, q_pos, out, lse, part, counters, B, C,
                     H, KV, hd, window, scale, nsplit, R, stream);
}
