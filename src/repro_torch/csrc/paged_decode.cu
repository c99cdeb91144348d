// Ragged flash-decode over a block-paged KV pool for Hopper (sm_90a): one
// wave of CTAs cuts the round's live pool blocks evenly (split-K), the
// merge in the same launch.
//
// Replaces the TPU kernel src/repro/kernels/paged_decode.py:119
// `paged_decode` (body `_paged_kernel`, :47): one query token per slot
// attends over the tokens its block table maps, with an f32 online softmax
// (the recurrence of `kernels.ref.flash_decode_block`) and the G query
// heads of a kv head stacked.  Plain version: `kernels.ref.paged_decode_ref`;
// the split arithmetic on the CPU: `kernels.ref.paged_decode_split_ref`,
// cut by `kernels.paged_decode.split_plan` exactly as this kernel cuts.
//
// What bounds it on this card: bytes.  Each (slot, kv head) reads its live
// K and V rows once and does 4 G flops per element read: about 1 flop a
// byte, far below the ~20 at which the f32 units would bind, so the floor
// is the live K/V bytes over HBM bandwidth, and the CUDA cores (not the
// tensor cores) do the arithmetic.  The first port ran one CTA per (slot,
// kv head) walking its blocks one after another: the launch lasted as
// long as the longest slot's chain (up to 72 blocks), each block a
// dependent table load, three barriers, a softmax one thread ran over 16
// keys, and no copy in flight while it computed.
//
// What the design does about it:
//   * The unit of work is a live pool block of a (slot, kv head): W =
//     sum_s KV min(cdiv(lens[s], BS), MB) of them in a round.  One wave of
//     `grid` CTAs (the SMs times the CTAs an SM holds) runs; every CTA
//     prefix-sums the block counts from `lens` on the card and takes the
//     blocks [floor(b W / grid), floor((b+1) W / grid)): every CTA walks the
//     same number of blocks give or take one, whatever the slots' lengths.
//     The host reads no data and makes no sync.
//   * A CTA's run of blocks of one (slot, kv head) is a piece.  Its table
//     entries go to shared memory once; its K and V rows, in tiles of KT
//     keys (KT <= min(BS, 8), chosen by the wrapper: at hd = 896, KT = 8
//     holds two CTAs an SM and ran faster than KT = 16 with one), are
//     gathered by 16-byte cp.async (4-byte where hd % 4 != 0 or a pool is
//     unaligned) into a ring of three slots: K(i+1) and V(i+1) are in
//     flight while tile i is reduced.
//   * Scores: a warp per key, its lanes over hd (float4 reads of K and of
//     the query rows from shared memory), the G dots reduced by shuffles.
//     The softmax runs on G KT threads, one (query row, key) each, the max
//     and the sum reduced over the row's KT lanes by shuffles.  P V: a
//     thread per four columns of hd carries the G accumulators.
//   * The merge is in the same launch: a piece of a (slot, kv head) cut
//     across CTAs leaves (m, l, acc) in its CTA's workspace (slot 0: the
//     piece that began before the CTA's range, slot 1: the one that runs
//     past its end), fences and takes a ticket on the (slot, kv head)'s
//     arrival counter; the last piece merges them with log-sum-exp
//     weights, writes out and resets the counter, so the counters stay
//     zero between calls with no memset.  An idle slot (len 0) writes
//     zeros, as the reference's acc / max(l, 1e-30) gives; a -1 table
//     entry is read as block 0 and masked, as in the reference.
//   * Instantiated per G bound (1, 2, 4, 8, 16) under
//     __launch_bounds__(256, 1): the G accumulators stay in registers at
//     hd <= 1024 with no spill (ptxas: 114 registers at G = 1, 220 at
//     G = 16; bounded to 256 threads alone, the G <= 4 instance spilled
//     16 bytes at 128).  expf, no fast-math: the result stays within f32
//     rounding of the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxGroup = 16;   // largest GQA group (H / KV) taken
constexpr int kMaxKT = 8;       // keys a ring slot holds at most
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;  // also the float4 columns of hd
constexpr int kMaxHd = 4 * kThreads;   // 1024
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

struct Args {
  const float* q;
  const float* kp;
  const float* vp;
  const int* tbl;
  const int* lens;
  float* out;
  float* ws;      // 2 grid G hd4 partial accumulators
  float* ml;      // 2 grid 2 G partial (m, l)
  int* counters;  // one per (slot, kv head), zero between calls
  int S, H, KV, hd, hd4, BS, MB, KT;
  float scale;
  int vec;
};

// Live blocks of slot s: min(cdiv(len, BS), MB).
__device__ __forceinline__ int nblocks(const Args& a, int s) {
  const int len = a.lens[s];
  return len > 0 ? min((len + a.BS - 1) / a.BS, a.MB) : 0;
}

// The CTA whose range of the W blocks holds block k:
// max { b : floor(b W / grid) <= k }.
__device__ __forceinline__ int owner(long long k, long long W, int grid) {
  return (int)(((k + 1) * grid + W - 1) / W) - 1;
}

template <int N>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int N>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Max and sum over the KT lanes of a softmax row (KT a power of two <= 8).
__device__ __forceinline__ float row_max(float v, int KT) {
  switch (KT) {
    case 8: return group_max<8>(v);
    case 4: return group_max<4>(v);
    case 2: return group_max<2>(v);
    default: return v;
  }
}
__device__ __forceinline__ float row_sum(float v, int KT) {
  switch (KT) {
    case 8: return group_sum<8>(v);
    case 4: return group_sum<4>(v);
    case 2: return group_sum<2>(v);
    default: return v;
  }
}

__device__ __forceinline__ void cp_wait_n(int n) {
  if (n <= 0)
    cp_wait<0>();
  else if (n == 1)
    cp_wait<1>();
  else
    cp_wait<2>();
}

__device__ __forceinline__ void fma4(float4& acc, float p, const float4& v) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

// Columns 4c .. 4c+3 of an output row (hd floats), where they exist.
__device__ __forceinline__ void store4(float* row, int c, int hd, bool vec,
                                      const float4& x) {
  if (vec) {
    reinterpret_cast<float4*>(row)[c] = x;
    return;
  }
  const int d = 4 * c;
  if (d < hd) row[d] = x.x;
  if (d + 1 < hd) row[d + 1] = x.y;
  if (d + 2 < hd) row[d + 2] = x.z;
  if (d + 3 < hd) row[d + 3] = x.w;
}

template <int kMaxG>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int G = a.H / a.KV;
  const int hd = a.hd, hd4 = a.hd4, KT = a.KT;
  const int nc = hd4 >> 2;              // float4 columns of a row
  const int slot_f = KT * hd4;          // floats of a ring slot
  const int b = blockIdx.x;
  const int grid = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_pairs = a.S * a.KV;
  const size_t rs = (size_t)a.KV * hd;  // between tokens of a block

  float* ring = smem;                   // 3 slots of KT K or V rows
  float* q_s = ring + 3 * slot_f;       // (G, hd4) the piece's query rows
  float* sc = q_s + G * hd4;            // (G, KT) scores
  float* p_s = sc + G * KT;             // (G, KT) probabilities
  float* al_s = p_s + G * KT;           // (16,) rescale of this key tile
  float* ml_s = al_s + kMaxGroup;       // (2, 16) the piece's final m, l
  int* tbl_s = (int*)(ml_s + 2 * kMaxGroup);  // (MB,) the piece's blocks
  int* sc_i = tbl_s + a.MB;             // warp sums, then the range's pairs

  // (0) the cut: prefix sums of the (slot, kv head) pairs' block counts;
  // this CTA takes the blocks [lo, hi) of the W in all
  const int chunk = (n_pairs + kThreads - 1) / kThreads;
  const int c0 = min(n_pairs, tid * chunk);
  const int c1 = min(n_pairs, c0 + chunk);
  int mine = 0;
  for (int p = c0; p < c1; ++p) mine += nblocks(a, p / a.KV);
  int x = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sc_i[warp] = x;
  __syncthreads();
  long long W = 0, pre = x - mine;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pre += sc_i[w];
    W += sc_i[w];
  }
  const long long lo = (long long)b * W / grid;
  const long long hi = (long long)(b + 1) * W / grid;
  if (lo < hi) {  // the pairs that hold blocks lo and hi - 1
    long long P = pre;
    for (int p = c0; p < c1; ++p) {
      const int c = nblocks(a, p / a.KV);
      if (c > 0 && P <= lo && lo < P + c) {
        sc_i[kWarps] = p;
        sc_i[kWarps + 1] = (int)P;
      }
      if (c > 0 && P <= hi - 1 && hi - 1 < P + c) sc_i[kWarps + 2] = p;
      P += c;
    }
  }
  // idle slots write their zero rows, strided over the CTAs
  for (int p = b; p < n_pairs; p += grid) {
    if (nblocks(a, p / a.KV) > 0) continue;
    float* og = a.out + (size_t)p * G * hd;  // (slot, kv head) = p
    for (int e = tid; e < G * hd; e += kThreads) og[e] = 0.0f;
  }
  __syncthreads();
  if (lo >= hi) return;

  // the softmax thread's entry: query row er, key ek of a key tile
  const int er = tid / KT, ek = tid % KT;
  const bool smx = er < G;
  const int p_last = sc_i[kWarps + 2];
  long long P = sc_i[kWarps + 1];
  for (int pr = sc_i[kWarps];; ++pr) {
    const int s = pr / a.KV, h = pr % a.KV;
    const int nblk = nblocks(a, s);
    if (nblk > 0) {
      // the piece: blocks [k0, k1) of the slot
      const int k0 = (int)(max(P, lo) - P);
      const int k1 = (int)(min(P + nblk, hi) - P);
      const int len = min(a.lens[s], a.MB * a.BS);
      const int spb = (a.BS + KT - 1) / KT;   // key tiles of a full block
      const int nv_last = min(a.BS, len - (k1 - 1) * a.BS);
      const int ntk = (k1 - k0 - 1) * spb + (nv_last + KT - 1) / KT;
      const float* qg = a.q + (size_t)pr * G * hd;
      for (int e = tid; e < G * hd4; e += kThreads) {
        const int g = e / hd4, d = e - g * hd4;
        q_s[e] = d < hd ? qg[(size_t)g * hd + d] : 0.0f;
      }
      for (int i = tid; i < k1 - k0; i += kThreads)
        tbl_s[i] = a.tbl[(size_t)s * a.MB + k0 + i];
      __syncthreads();

      // key tile n of the piece: block k0 + n / spb, its rows r0 .. r0 +
      // rows - 1 (rows >= 1)
      auto tile = [&](int n, int& blk, int& r0) {
        blk = n / spb;
        r0 = (n - blk * spb) * KT;
        return min(KT, min(a.BS, len - (k0 + blk) * a.BS) - r0);
      };
      // load n of the piece: K (n even) or V (n odd) of key tile n / 2,
      // into ring slot n % 3; warp w gathers rows w, w + 8, ...
      auto fetch = [&](int n) {
        int blk, r0;
        const int rows = tile(n >> 1, blk, r0);
        float* dst = ring + (n % 3) * slot_f;
        const float* pool = n & 1 ? a.vp : a.kp;
        const float* src0 = pool + ((size_t)max(tbl_s[blk], 0) * a.BS + r0) *
                                       rs + (size_t)h * hd;
        for (int c = warp; c < rows; c += kWarps) {
          const float* src = src0 + (size_t)c * rs;
          float* d0 = dst + c * hd4;
          if (a.vec) {
            for (int d = lane * 4; d < hd4; d += 128)
              cp_async16(d0 + d, src + d, true);
          } else {
            for (int d = lane; d < hd4; d += 32)
              cp_async4(d0 + d, d < hd ? src + d : src, d < hd);
          }
        }
        cp_commit();
      };
      fetch(0);
      fetch(1);

      float m = -INFINITY, l = 0.0f;  // row er's running max, denominator
      float4 acc[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);

      for (int i = 0; i < ntk; ++i) {
        const bool more = i + 1 < ntk;
        int blk, r0;
        const int rows = tile(i, blk, r0);
        if (more) fetch(2 * i + 2);  // K(i+1) into V(i-1)'s slot
        cp_wait_n(more ? 2 : 1);     // K(i) landed
        __syncthreads();

        // scores: warp w takes keys w, w + 8, ...; lanes over hd
        const float* ks = ring + ((2 * i) % 3) * slot_f;
        for (int t = warp; t < KT; t += kWarps) {
          float part[kMaxG];
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) part[g] = 0.0f;
          if (t < rows) {
            const float4* kr = reinterpret_cast<const float4*>(ks + t * hd4);
            for (int c = lane; c < nc; c += 32) {
              const float4 k4 = kr[c];
#pragma unroll
              for (int g = 0; g < kMaxG; ++g) {
                if (g < G) {
                  const float4 q4 =
                      reinterpret_cast<const float4*>(q_s + g * hd4)[c];
                  part[g] = fmaf(q4.x, k4.x, part[g]);
                  part[g] = fmaf(q4.y, k4.y, part[g]);
                  part[g] = fmaf(q4.z, k4.z, part[g]);
                  part[g] = fmaf(q4.w, k4.w, part[g]);
                }
              }
            }
          }
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float v = group_sum<32>(part[g]);
              if (lane == 0) sc[g * KT + t] = t < rows ? v * a.scale : -INFINITY;
            }
          }
        }
        __syncthreads();             // scores in; K(i)'s slot free
        if (more) fetch(2 * i + 3);  // V(i+1) into K(i)'s slot

        // online softmax: thread (er, ek), a row's KT keys on KT lanes
        // (whole warps take part in the shuffles)
        if (warp * 32 < G * KT) {
          const float sx = smx ? sc[tid] : -INFINITY;
          const float mb = row_max(sx, KT);
          const float m_new = fmaxf(m, mb);
          const float m_safe = isfinite(m_new) ? m_new : 0.0f;
          const float p = sx == -INFINITY ? 0.0f : expf(sx - m_safe);
          const float ps = row_sum(p, KT);
          const float alpha = isfinite(m) ? expf(m - m_safe) : 0.0f;
          l = l * alpha + ps;
          m = m_new;
          if (smx) {
            p_s[tid] = p;
            if (ek == 0) al_s[er] = alpha;
          }
        }
        cp_wait_n(more ? 2 : 0);     // V(i) landed
        __syncthreads();

        // acc = acc alpha + P V: thread tid owns float4 column tid of hd
        if (tid < nc) {
          const float* vs = ring + ((2 * i + 1) % 3) * slot_f;
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float al = al_s[g];
              acc[g].x *= al;
              acc[g].y *= al;
              acc[g].z *= al;
              acc[g].w *= al;
            }
          }
          for (int t = 0; t < rows; ++t) {
            const float4 v4 = reinterpret_cast<const float4*>(vs + t * hd4)[tid];
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) fma4(acc[g], p_s[g * KT + t], v4);
          }
        }
        __syncthreads();             // V(i)'s slot and P free
      }

      if (smx && ek == 0) {
        ml_s[er] = m;
        ml_s[kMaxGroup + er] = l;
      }
      __syncthreads();
      float* og = a.out + (size_t)pr * G * hd;
      if (k0 == 0 && k1 == nblk) {  // the whole slot: out = acc / l
        if (tid < nc) {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float inv = 1.0f / fmaxf(ml_s[kMaxGroup + g], 1e-30f);
              float4 o = acc[g];
              o.x *= inv;
              o.y *= inv;
              o.z *= inv;
              o.w *= inv;
              store4(og + (size_t)g * hd, tid, hd, a.vec, o);
            }
          }
        }
      } else {
        // a piece of a cut slot: the partial into this CTA's slot 0 (the
        // slot began before the range) or 1 (it runs past its end)
        const int slot = P < lo ? 0 : 1;
        float* pa = a.ws + (size_t)(2 * b + slot) * G * hd4;
        if (tid < nc) {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G)
              reinterpret_cast<float4*>(pa + (size_t)g * hd4)[tid] = acc[g];
        }
        if (tid < G) {
          a.ml[(size_t)(2 * b + slot) * 2 * G + tid] = ml_s[tid];
          a.ml[(size_t)(2 * b + slot) * 2 * G + G + tid] =
              ml_s[kMaxGroup + tid];
        }
        __threadfence();
        __syncthreads();
        // the slot's pieces: the CTAs from the owner of its first block to
        // that of its last, less those with an empty range
        const int b0 = owner(P, W, grid);
        const int b1 = owner(P + nblk - 1, W, grid);
        auto held = [&](int bb) {
          return (long long)bb * W / grid < (long long)(bb + 1) * W / grid;
        };
        if (tid == 0) {
          int np = 0;
          for (int bb = b0; bb <= b1; ++bb) np += held(bb);
          sc_i[kWarps + 3] = atomicAdd(a.counters + pr, 1) == np - 1;
        }
        __syncthreads();
        if (sc_i[kWarps + 3]) {
          // the last piece merges, a thread per float4 column
          __threadfence();
          auto pslot = [&](int bb) {
            return 2 * bb + (P < (long long)bb * W / grid ? 0 : 1);
          };
          if (tid < nc) {
#pragma unroll
            for (int g = 0; g < kMaxG; ++g) {
              if (g >= G) continue;
              float M = -INFINITY;
              for (int bb = b0; bb <= b1; ++bb)
                if (held(bb))
                  M = fmaxf(M, __ldcg(a.ml + (size_t)pslot(bb) * 2 * G + g));
              const float Ms = isfinite(M) ? M : 0.0f;
              float L = 0.0f;
              float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
              for (int bb = b0; bb <= b1; ++bb) {
                if (!held(bb)) continue;
                const int ps = pslot(bb);
                const float* pm = a.ml + (size_t)ps * 2 * G;
                const float mp = __ldcg(pm + g);
                const float w = isfinite(mp) ? expf(mp - Ms) : 0.0f;
                L = fmaf(w, __ldcg(pm + G + g), L);
                const float4 pp = __ldcg(reinterpret_cast<const float4*>(
                    a.ws + ((size_t)ps * G + g) * hd4) + tid);
                fma4(o, w, pp);
              }
              const float inv = 1.0f / fmaxf(L, 1e-30f);
              o.x *= inv;
              o.y *= inv;
              o.z *= inv;
              o.w *= inv;
              store4(og + (size_t)g * hd, tid, hd, a.vec, o);
            }
          }
          if (tid == 0) a.counters[pr] = 0;
        }
      }
      __syncthreads();  // the ring, q_s, the table and ml_s are reused
    }
    P += nblk;
    if (pr == p_last) break;
  }
}

size_t smem_bytes(int G, int hd, int KT, int MB) {
  const size_t hd4 = (size_t)((hd + 3) & ~3);
  return sizeof(float) * (3 * (size_t)KT * hd4 + (size_t)G * hd4 +
                          2 * (size_t)G * KT + 3 * kMaxGroup) +
         sizeof(int) * ((size_t)MB + kWarps + 4);
}

template <int kMaxG>
cudaError_t configure() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(paged_decode_kernel<kMaxG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int kMaxG>
cudaError_t grid_of(size_t smem, int* grid) {
  cudaError_t e = configure<kMaxG>();
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per, paged_decode_kernel<kMaxG>, kThreads, smem)) != cudaSuccess)
    return e;
  *grid = sms * per;
  return cudaSuccess;
}

template <int kMaxG>
cudaError_t launch(const Args& a, int grid, size_t smem, cudaStream_t st) {
  cudaError_t e = configure<kMaxG>();
  if (e != cudaSuccess) return e;
  paged_decode_kernel<kMaxG><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int H, int KV, int hd, int BS, int MB, int KT) {
  return KV < 1 || H % KV != 0 || H / KV > kMaxGroup || hd < 1 ||
         hd > kMaxHd || BS < 1 || MB < 1 || KT < 1 || KT > kMaxKT ||
         (KT & (KT - 1)) != 0;
}

}  // namespace

// The launch's grid for key tiles of KT rows: one wave, the SMs times the
// CTAs an SM holds at this shape (0 where one CTA does not fit).
extern "C" int paged_decode_grid(int H, int KV, int hd, int BS, int MB,
                                 int KT, void* grid) {
  int* g = (int*)grid;
  *g = 0;
  if (bad_shape(H, KV, hd, BS, MB, KT)) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const size_t smem = smem_bytes(G, hd, KT, MB);
  if (smem > (size_t)kMaxSmem) return (int)cudaSuccess;
  if (G <= 1) return (int)grid_of<1>(smem, g);
  if (G <= 2) return (int)grid_of<2>(smem, g);
  if (G <= 4) return (int)grid_of<4>(smem, g);
  if (G <= 8) return (int)grid_of<8>(smem, g);
  return (int)grid_of<16>(smem, g);
}

// out: S H hd floats, then the workspace (16-byte aligned): 2 grid G hd4
// floats of partial accumulators and 2 grid 2 G floats of (m, l);
// counters: S KV ints, zero (the kernel leaves them zero); grid and KT
// from `paged_decode_grid`.
extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tbl,
                                   const void* lens, void* out, void* ws,
                                   void* counters, int S, int H, int KV,
                                   int hd, int BS, int MB, int KT, float scale,
                                   int grid, void* stream) {
  if (S < 0 || grid < 1 || bad_shape(H, KV, hd, BS, MB, KT) ||
      (long long)S * KV * MB > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const int G = H / KV;
  const size_t smem = smem_bytes(G, hd, KT, MB);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const float*)q;
  a.kp = (const float*)k_pool;
  a.vp = (const float*)v_pool;
  a.tbl = (const int*)tbl;
  a.lens = (const int*)lens;
  a.out = (float*)out;
  a.hd4 = (hd + 3) & ~3;
  a.ws = (float*)ws;
  a.ml = a.ws + (size_t)2 * grid * G * a.hd4;
  a.counters = (int*)counters;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.BS = BS;
  a.MB = MB;
  a.KT = KT;
  a.scale = scale;
  const uintptr_t all = (uintptr_t)q | (uintptr_t)k_pool | (uintptr_t)v_pool |
                        (uintptr_t)out;
  a.vec = hd % 4 == 0 && (all & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (G <= 1)
    e = launch<1>(a, grid, smem, st);
  else if (G <= 2)
    e = launch<2>(a, grid, smem, st);
  else if (G <= 4)
    e = launch<4>(a, grid, smem, st);
  else if (G <= 8)
    e = launch<8>(a, grid, smem, st);
  else
    e = launch<16>(a, grid, smem, st);
  return (int)e;
}
