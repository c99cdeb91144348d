// Ragged chunked prefill over a block-paged KV pool for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill.py:166
// `paged_prefill` (body `_prefill_kernel`, :53).  One launch serves every
// slot's prompt chunk of a round: slot s has lens[s] new tokens starting at
// absolute position off[s] (the tokens already in its pool blocks).  The
// kernel
//   * writes chunk row j's K and V into block tbl[s, (off+j)/BS], row
//     (off+j)%BS, of the pools (in place), and
//   * computes, for every chunk query row j, attention over the prior
//     tokens 0..off-1 (read from the pool through the table) and the chunk
//     tokens off..off+j (read from k_chunk / v_chunk), with GQA and an f32
//     online softmax taken one table column of BS tokens at a time (the
//     recurrence of `kernels.ref.flash_prefill_block`).
// Plain version: `kernels.ref.paged_prefill_ref`.  The pool writes are
// copies, so the pools equal the plain version's bit for bit; the outputs
// agree to f32 rounding (the sums run in another order).
//
// What bounds it on this card: bytes.  Per (slot, kv head) it must read
// the off prior K/V rows and the chunk rows once and write the chunk rows
// once; the flops, 4 per (query row, key, element), stay below what the
// f32 units need to become the limit for the shapes the engine runs.
//
// What the design does about it:
//   * One CTA per (slot, kv head, tile of R chunk rows).  It carries the
//     tile's Q = G*R query rows (G heads of the group times R rows, Q <= 16),
//     so each K/V row it reads serves all Q rows.  With G = 1 a tile is 16
//     rows, so the prior tokens are read CT/16 times per slot, not CT
//     times as with one CTA per row, and the q tile (Q x hd floats, 57 KB
//     at hd = 896) fits in shared memory where a whole 64-row tile of q and
//     its accumulators would not.
//   * Each CTA writes its own tile's rows to the pool and reads pool rows
//     only at positions < off, which no CTA of the launch writes; chunk
//     keys come from k_chunk / v_chunk.  One launch is race-free without
//     the TPU's trash block, aliased pools or one-hot merge matmul.  A -1
//     table entry is read as block 0 (as the plain version reads it) and
//     never written through.
//   * The key loop ends at the tile's last visible key,
//     min(off + j0 + valid rows, MB*BS): causal rows of an early tile skip
//     the blocks only later rows see; idle slots and rows at or past
//     lens[s] write zeros and cost no loads.
//   * Scores: warp w takes tokens w, w + nwarps, ...; lanes stride over hd
//     and reduce with shuffles.  Q threads update the softmax rows; the V
//     update is one coalesced row read per token for the whole CTA.  The
//     kernel is instantiated for Q <= 1, 2, 4, 8, 16 under
//     __launch_bounds__(1024), so the Q accumulators and partial sums of a
//     thread stay in registers at hd up to 1024 (a build at 80 registers a
//     thread could not launch 896 threads).
//   * expf, not __expf, and no fast-math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;  // query rows (G x R) a CTA carries

template <int kMaxQ>
__global__ void __launch_bounds__(1024)
    paged_prefill_kernel(const float* __restrict__ q,
                         const float* __restrict__ kc,
                         const float* __restrict__ vc,
                         float* __restrict__ kp, float* __restrict__ vp,
                         const int* __restrict__ tbl,
                         const int* __restrict__ offs,
                         const int* __restrict__ lens,
                         float* __restrict__ out, int CT, int H, int KV,
                         int hd, int BS, int MB, int R, int ntiles,
                         float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int Q = G * R;  // query row r = jj * G + g (chunk row j0 + jj)
  const int tile = blockIdx.x % ntiles;
  const int h = (blockIdx.x / ntiles) % KV;
  const int s = blockIdx.x / (ntiles * KV);
  const int j0 = tile * R;
  const int nrow = min(R, CT - j0);  // rows of this tile in the chunk
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t row_stride = (size_t)KV * hd;  // between tokens (pool, chunk)
  const size_t q_stride = (size_t)H * hd;     // between chunk rows of q/out
  const int off = offs[s];
  const int len = min(lens[s], CT);  // rows past CT do not exist
  const int nvalid = max(0, min(nrow, len - j0));  // rows with a token

  float* og = out + ((size_t)s * CT + j0) * q_stride + (size_t)h * G * hd;
  if (nvalid == 0) {  // idle slot or a tile past lens[s]: zero rows
    for (int e = tid; e < nrow * G * hd; e += blockDim.x)
      og[(size_t)(e / (G * hd)) * q_stride + e % (G * hd)] = 0.0f;
    return;
  }

  // (1) this tile's chunk rows go into their pool blocks
  for (int jj = 0; jj < nvalid; ++jj) {
    const int pos = off + j0 + jj;
    const int col = pos / BS;
    const int b = col < MB ? tbl[(size_t)s * MB + col] : -1;
    if (b < 0) continue;
    const size_t dst = ((size_t)b * BS + pos % BS) * row_stride +
                       (size_t)h * hd;
    const size_t src = ((size_t)s * CT + j0 + jj) * row_stride +
                       (size_t)h * hd;
    for (int d = tid; d < hd; d += blockDim.x) {
      kp[dst + d] = kc[src + d];
      vp[dst + d] = vc[src + d];
    }
  }

  // (2) attention of the tile's query rows
  float* q_s = smem;              // (Q, hd) query rows
  float* sc = q_s + Q * hd;       // (Q, BS) scores, then probabilities
  float* alpha_s = sc + Q * BS;   // (Q,) rescale of this block
  float* l_s = alpha_s + Q;       // (Q,) running denominators
  float* m_s = l_s + Q;           // (Q,) running maxima
  const float* qg = q + ((size_t)s * CT + j0) * q_stride + (size_t)h * G * hd;
  for (int e = tid; e < Q * hd; e += blockDim.x) {
    const int r = e / hd;
    const int jj = r / G;
    q_s[e] = jj < nrow ? qg[(size_t)jj * q_stride + (size_t)(r % G) * hd +
                            e % hd]
                       : 0.0f;
  }
  if (tid < Q) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxQ];
#pragma unroll
  for (int r = 0; r < kMaxQ; ++r) acc[r] = 0.0f;

  // keys 0 .. kend-1: the last valid row of the tile sees off + j0 + nvalid - 1
  const int kend = min(off + j0 + nvalid, MB * BS);
  const int nblk = kend > 0 ? (kend + BS - 1) / BS : 0;
  const float* kc_s = kc + (size_t)s * CT * row_stride + (size_t)h * hd;
  const float* vc_s = vc + (size_t)s * CT * row_stride + (size_t)h * hd;
  __syncthreads();

  for (int i = 0; i < nblk; ++i) {
    int b = tbl[(size_t)s * MB + i];
    b = b < 0 ? 0 : b;
    const float* kb = kp + (size_t)b * BS * row_stride + (size_t)h * hd;
    const float* vb = vp + (size_t)b * BS * row_stride + (size_t)h * hd;
    const int nk = min(BS, kend - i * BS);  // keys of this block in view

    for (int t = warp; t < BS; t += nwarps) {
      const int pos = i * BS + t;
      float part[kMaxQ];
#pragma unroll
      for (int r = 0; r < kMaxQ; ++r) part[r] = 0.0f;
      if (t < nk) {
        const float* kr = pos < off ? kb + (size_t)t * row_stride
                                    : kc_s + (size_t)(pos - off) * row_stride;
        for (int d = lane; d < hd; d += 32) {
          const float kv = kr[d];
#pragma unroll
          for (int r = 0; r < kMaxQ; ++r)
            if (r < Q) part[r] = fmaf(q_s[r * hd + d], kv, part[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxQ; ++r) {
        if (r < Q) {
          float v = part[r];
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0) {
            const int jj = r / G;  // causal: row j0+jj sees pos <= off+j0+jj
            const bool vis = t < nk && jj < nvalid && pos <= off + j0 + jj;
            sc[r * BS + t] = vis ? v * scale : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

    if (tid < Q) {
      const int r = tid;
      const float m_prev = m_s[r];
      float mb = -INFINITY;
      for (int t = 0; t < BS; ++t) mb = fmaxf(mb, sc[r * BS + t]);
      const float m_new = fmaxf(m_prev, mb);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float psum = 0.0f;
      for (int t = 0; t < BS; ++t) {
        const float x = sc[r * BS + t];
        const float p = x == -INFINITY ? 0.0f : expf(x - m_safe);
        sc[r * BS + t] = p;
        psum += p;
      }
      const float a = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
      alpha_s[r] = a;
      l_s[r] = l_s[r] * a + psum;
      m_s[r] = m_new;
    }
    __syncthreads();

    if (tid < hd) {
#pragma unroll
      for (int r = 0; r < kMaxQ; ++r)
        if (r < Q) acc[r] *= alpha_s[r];
      for (int t = 0; t < nk; ++t) {
        const int pos = i * BS + t;
        const float vv = pos < off
                             ? vb[(size_t)t * row_stride + tid]
                             : vc_s[(size_t)(pos - off) * row_stride + tid];
#pragma unroll
        for (int r = 0; r < kMaxQ; ++r)
          if (r < Q) acc[r] = fmaf(sc[r * BS + t], vv, acc[r]);
      }
    }
    __syncthreads();  // sc is rewritten by the next block
  }

  if (tid < hd) {
#pragma unroll
    for (int r = 0; r < kMaxQ; ++r) {
      const int jj = r / G;
      if (r < Q && jj < nrow)
        og[(size_t)jj * q_stride + (size_t)(r % G) * hd + tid] =
            acc[r] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <int kMaxQ>
int launch(const float* q, const float* kc, const float* vc, float* kp,
           float* vp, const int* tbl, const int* off, const int* lens,
           float* out, int S, int CT, int H, int KV, int hd, int BS, int MB,
           int R, float scale, cudaStream_t stream) {
  const int Q = (H / KV) * R;
  const size_t smem =
      sizeof(float) * ((size_t)Q * hd + (size_t)Q * BS + 3 * (size_t)Q);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<kMaxQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ntiles = (CT + R - 1) / R;
  const int threads = ((hd + 31) / 32) * 32;
  paged_prefill_kernel<kMaxQ><<<S * KV * ntiles, threads, smem, stream>>>(
      q, kc, vc, kp, vp, tbl, off, lens, out, CT, H, KV, hd, BS, MB, R,
      ntiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_prefill_launch(const void* q, const void* k_chunk,
                                    const void* v_chunk, void* k_pool,
                                    void* v_pool, const void* tbl,
                                    const void* off, const void* lens,
                                    void* out, int S, int CT, int H, int KV,
                                    int hd, int BS, int MB, float scale,
                                    void* stream) {
  if (S < 0 || CT < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxRows ||
      hd < 1 || hd > 1024 || BS < 1 || MB < 1)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const int G = H / KV;
  const int R = min(kMaxRows / G, CT);  // chunk rows per CTA
  const int Q = G * R;
  const float* qf = (const float*)q;
  const float* kf = (const float*)k_chunk;
  const float* vf = (const float*)v_chunk;
  float* kpf = (float*)k_pool;
  float* vpf = (float*)v_pool;
  const int* tb = (const int*)tbl;
  const int* of = (const int*)off;
  const int* ln = (const int*)lens;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (Q <= 1)
    return launch<1>(qf, kf, vf, kpf, vpf, tb, of, ln, o, S, CT, H, KV, hd,
                     BS, MB, R, scale, st);
  if (Q <= 2)
    return launch<2>(qf, kf, vf, kpf, vpf, tb, of, ln, o, S, CT, H, KV, hd,
                     BS, MB, R, scale, st);
  if (Q <= 4)
    return launch<4>(qf, kf, vf, kpf, vpf, tb, of, ln, o, S, CT, H, KV, hd,
                     BS, MB, R, scale, st);
  if (Q <= 8)
    return launch<8>(qf, kf, vf, kpf, vpf, tb, of, ln, o, S, CT, H, KV, hd,
                     BS, MB, R, scale, st);
  return launch<16>(qf, kf, vf, kpf, vpf, tb, of, ln, o, S, CT, H, KV, hd,
                    BS, MB, R, scale, st);
}
