// Ragged chunked prefill over a block-paged KV pool for Hopper (sm_90a):
// one wave of CTAs cuts the round's key tiles evenly (split-K), the merge
// in the same launch.
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
//     online softmax.
// Plain version: `kernels.ref.paged_prefill_ref`; the split arithmetic on
// the CPU: `kernels.ref.paged_prefill_split_ref`, cut by
// `kernels.paged_prefill.split_plan` exactly as this kernel cuts.  The
// pool writes are copies, so the pools equal the plain version's bit for
// bit; the outputs agree to f32 rounding (the sums run in another order).
//
// What bounds it on this card: bytes.  Per (slot, kv head) it must read
// the off prior K/V rows and the chunk rows once and write the chunk rows
// once (0.039 ms at the chunked engine's round: S=256, CT=64, H=KV=1,
// hd=896, 32 active slots).  The first port walked each tile's prior
// blocks one after another in one CTA, three barriers and a serial
// softmax a 16-key block, with no copy in flight: 1.6 ms, latency-bound.
// The work is ragged (tiles see 1 to 72 key tiles; most slots are idle in
// a round).
//
// What the design does about it:
//   * A tile is (slot, kv head, R chunk rows) with Q = G R <= 16 query rows
//     (the G heads of a kv head times R rows, row r = jj G + g): exactly
//     the m16 of mma.sync.m16n8k8.  Its cost is the number of 16-key tiles
//     it sees (keys 0 .. off + j0 + valid rows - 1), 0 for a tile with no
//     valid row.
//   * One wave of `grid` CTAs (the SMs times the CTAs an SM holds).  Every
//     CTA reads off/lens into shared memory, prefix-sums the tiles' costs
//     (W key tiles in all) and takes the key tiles [floor(b W / grid),
//     floor((b+1) W / grid)) of the concatenation: every CTA walks the
//     same number of key tiles, give or take one, and no CTA is launched
//     for an idle tile.  A tile cut across CTAs leaves a partial in the
//     CTA's workspace slot (slot 0: the tile that began before the CTA's
//     range, slot 1: the one that runs past its end), so the workspace is
//     2 grid Q hd floats, whatever the round.  Idle tiles' zero rows are
//     written in a strided pass shared by all CTAs.
//   * The 16-key K and V tiles are gathered row by row (pool block
//     through the table below off, the chunk from off on) by 16-byte
//     cp.async into a ring of three slots, K(i+1) and V(i+1) issued as
//     soon as their slot frees: two tiles (115 KB at hd = 896) are in
//     flight while a third is multiplied.  Q lives in registers, each warp
//     holding the A fragments of its own k8 steps, which is what makes
//     room for the third slot.
//   * Both products on the TF32 tensor cores at f32 accuracy, 3xTF32 as
//     in csrc/flash_attention.cu (x = hi + lo by cvt.rna; lo hi + hi lo
//     + hi hi into f32).  S = Q K^T: the 16 warps split hd and their
//     16 x 16 partial scores meet in shared memory; O += P V: each warp
//     owns n8 tiles of hd.  The softmax runs on 256 threads, one (row,
//     key) each, reduced over the 16 lanes of a row by shuffles.  Timed
//     inside a key tile on the card, the loads had landed by the time
//     they were waited for: the products and their fragment splits are
//     latency-bound, so the CTA carries 16 warps (at most 128 registers a
//     thread), not 8.
//   * The merge is in the same launch: a CTA with a partial writes (m, l,
//     acc), fences, and takes a ticket on the tile's arrival counter; the
//     last of the tile's pieces merges them with log-sum-exp weights,
//     writes out and resets the counter, so the counters stay zero
//     between calls with no memset.  A piece with no key visible to a row
//     has m = -inf and weighs 0 there.
//   * The CTA that holds a tile's first key tile writes its chunk rows to
//     the pool, and every read of a pool row is at a position < off, which
//     no CTA of the launch writes.  A -1 table entry is read as block 0
//     (as the plain version reads it) and never written through.
//   * The shared-memory limit is raised once per device.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kRows = 16;      // query rows (G x R) a CTA carries
constexpr int kKeys = 16;      // keys a shared-memory tile holds
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSoftmax = kRows * kKeys;  // threads of the softmax, one a
                                         // (row, key) of a key tile
constexpr int kMaxNT = 8;      // k8 steps / n8 tiles of hd a warp carries
                               // (hd <= 1024)
constexpr int kPS = 20;        // row stride of P (conflict-free A reads)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

// One hd-wide row (src, hd floats; nullptr: zeros) into dst, zero-padded
// to hd8, by the 32 lanes of a warp.  A zero fill reads nothing, but its
// source operand is still a global address: `any`.
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         const float* any, int hd, int hd8,
                                         bool vec, int lane) {
  const bool ok = src != nullptr;
  if (vec) {
    for (int d = lane * 4; d < hd8; d += 128)
      cp_async16(dst + d, ok && d < hd ? src + d : any, ok && d < hd);
  } else {
    for (int d = lane; d < hd8; d += 32)
      cp_async4(dst + d, ok && d < hd ? src + d : any, ok && d < hd);
  }
}

// Wait until at most n (0, 1 or 2) of this thread's cp.async groups are
// pending.
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n <= 0)
    cp_wait<0>();
  else if (n == 1)
    cp_wait<1>();
  else
    cp_wait<2>();
}

struct Args {
  const float* q;
  const float* kc;
  const float* vc;
  float* kp;
  float* vp;
  const int* tbl;
  const int* offs;
  const int* lens;
  float* out;
  float* ws;      // 2 grid partial accumulators, (16, hd) each
  float* ml;      // 2 grid partial (m, l), 2 x 16 each
  int* counters;  // one per tile, zero between calls
  int S, CT, H, KV, hd, BS, MB, R, ntiles;
  float scale;
  int vec;
};

// A tile (slot, kv head, rows j0 .. j0 + nrow - 1 of the chunk window) and
// its cost: the 16-key tiles its valid rows see, 0 where it has none.
struct Tile {
  int s, h, j0, nrow, nvalid, off, kend, cost;
};

__device__ __forceinline__ Tile tile_of(const Args& a, const int* off_s,
                                        const int* len_s, int t) {
  Tile x;
  x.s = t / (a.KV * a.ntiles);
  x.h = (t / a.ntiles) % a.KV;
  x.j0 = (t % a.ntiles) * a.R;
  x.nrow = min(a.R, a.CT - x.j0);
  x.off = off_s[x.s];
  x.nvalid = max(0, min(x.nrow, len_s[x.s] - x.j0));
  x.kend = min(x.off + x.j0 + x.nvalid, a.MB * a.BS);
  x.cost = x.nvalid > 0 ? (x.kend + kKeys - 1) / kKeys : 0;
  return x;
}

// The CTA whose range of the W key tiles holds key tile k:
// max { b : floor(b W / grid) <= k }.
__device__ __forceinline__ int owner(long long k, long long W, int grid) {
  return (int)(((k + 1) * grid + W - 1) / W) - 1;
}

__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int G = a.H / a.KV;
  const int Q = G * a.R;
  const int hd = a.hd;
  const int hd8 = (hd + 7) & ~7;
  const int nks = hd8 >> 3;           // k8 steps (scores) = n8 tiles (P V)
  const int stk = hd8 + 4;            // K row stride (conflict-free B)
  const int stv = hd8 + 8;            // V row stride (conflict-free B)
  const int slot_f = kKeys * stv;     // floats of a ring slot
  const int b = blockIdx.x;
  const int grid = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const size_t rs = (size_t)a.KV * hd;  // between tokens (pool, chunk)
  const size_t qs = (size_t)a.H * hd;   // between chunk rows of q/out
  const int n_tiles = a.S * a.KV * a.ntiles;

  float* ring = smem;                   // 3 slots of 16 K or V rows
  float* red = ring + 3 * slot_f;       // (16 warps, 16 x 16) partial scores
  float* p_s = red + kWarps * 256;      // (16, kPS) probabilities
  float* al_s = p_s + kRows * kPS;      // (16,) rescale of this key tile
  float* ml_s = al_s + kRows;           // (2, 16) the piece's final m, l
  int* off_s = (int*)(ml_s + 2 * kRows);  // (S,) chunk starts
  int* len_s = off_s + a.S;             // (S,) chunk lengths (<= CT)
  int* tbl_s = len_s + a.S;             // (MB,) the piece's table row
  int* sc_i = tbl_s + a.MB;             // warp sums, then the range's tiles

  // (0) the cut: prefix sums of the tiles' costs; this CTA takes the key
  // tiles [lo, hi) of the W in all
  for (int s = tid; s < a.S; s += kThreads) {
    off_s[s] = a.offs[s];
    len_s[s] = min(a.lens[s], a.CT);
  }
  __syncthreads();
  const int chunk = (n_tiles + kThreads - 1) / kThreads;
  const int c0 = min(n_tiles, tid * chunk);
  const int c1 = min(n_tiles, c0 + chunk);
  int mine = 0;
  for (int t = c0; t < c1; ++t) mine += tile_of(a, off_s, len_s, t).cost;
  int x = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sc_i[warp] = x;
  __syncthreads();
  int W = 0, pre = x - mine;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pre += sc_i[w];
    W += sc_i[w];
  }
  const long long lo = (long long)b * W / grid;
  const long long hi = (long long)(b + 1) * W / grid;
  if (lo < hi) {  // the tiles that hold key tiles lo and hi - 1
    long long P = pre;
    for (int t = c0; t < c1; ++t) {
      const int c = tile_of(a, off_s, len_s, t).cost;
      if (c > 0 && P <= lo && lo < P + c) {
        sc_i[kWarps] = t;
        sc_i[kWarps + 1] = (int)P;
      }
      if (c > 0 && P <= hi - 1 && hi - 1 < P + c) sc_i[kWarps + 2] = t;
      P += c;
    }
  }
  // idle tiles write their zero rows, strided over the CTAs (float4
  // stores where aligned)
  for (int t = b; t < n_tiles; t += grid) {
    const Tile z = tile_of(a, off_s, len_s, t);
    if (z.cost > 0) continue;
    float* og = a.out + ((size_t)z.s * a.CT + z.j0) * qs +
                (size_t)z.h * G * hd;
    const int per = a.vec ? hd >> 2 : hd;
    for (int e = tid; e < z.nrow * G * per; e += kThreads) {
      const int r = e / per, d = e - r * per;
      float* row = og + (size_t)(r / G) * qs + (size_t)(r % G) * hd;
      if (a.vec)
        reinterpret_cast<float4*>(row)[d] = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        row[d] = 0.0f;
    }
  }
  __syncthreads();
  if (lo >= hi) return;

  // the softmax thread's entry: query row er, key ek of a key tile
  const int er = tid >> 4, ek = tid & 15;
  // this thread's fragment rows
  const int r0 = g8, r1 = g8 + 8;
  const int t_last = sc_i[kWarps + 2];
  long long P = sc_i[kWarps + 1];
  for (int t = sc_i[kWarps];; ++t) {
    const Tile x = tile_of(a, off_s, len_s, t);
    if (x.cost > 0) {
      // the piece: key tiles [k0, k1) of the tile's cost
      const int k0 = (int)(max(P, lo) - P);
      const int k1 = (int)(min(P + x.cost, hi) - P);
      const int s = x.s, h = x.h, off = x.off;
      const int k_lo = k0 * kKeys, k_hi = min(x.kend, k1 * kKeys);
      const int ntk = k1 - k0;
      const float* qg = a.q + ((size_t)s * a.CT + x.j0) * qs +
                        (size_t)h * G * hd;
      float* og = a.out + ((size_t)s * a.CT + x.j0) * qs +
                  (size_t)h * G * hd;
      auto rowoff = [&](int r) {
        return (size_t)(r / G) * qs + (size_t)(r % G) * hd;
      };

      // the slot's table row, so that no copy waits on a table read
      for (int i = tid; i < a.MB; i += kThreads)
        tbl_s[i] = a.tbl[(size_t)s * a.MB + i];
      __syncthreads();
      const float* kc_s = a.kc + (size_t)s * a.CT * rs + (size_t)h * hd;
      const float* vc_s = a.vc + (size_t)s * a.CT * rs + (size_t)h * hd;
      const int* tb = tbl_s;
      // load n of the piece: K (n even) or V (n odd) of key tile n / 2,
      // into ring slot n % 3; warp w gathers row w
      auto fetch = [&](int n) {
        const bool isv = n & 1;
        float* dst = ring + (n % 3) * slot_f;
        const int st = isv ? stv : stk;
        const float* pool = isv ? a.vp : a.kp;
        const float* ch = isv ? vc_s : kc_s;
        for (int c = warp; c < kKeys; c += kWarps) {
          const int pos = k_lo + (n >> 1) * kKeys + c;
          const float* src = nullptr;
          if (pos < k_hi) {
            if (pos >= off)
              src = ch + (size_t)(pos - off) * rs;
            else
              src = pool + ((size_t)max(tb[pos / a.BS], 0) * a.BS +
                            pos % a.BS) * rs + (size_t)h * hd;
          }
          load_row(dst + c * st, src, pool, hd, hd8, a.vec, lane);
        }
        cp_commit();
      };
      fetch(0);
      fetch(1);

      // the CTA with the tile's first key tile writes its chunk rows into
      // the pool (while K(0) and V(0) land): batches of 4 loads, then
      // their 4 stores, so that no load waits on the store before it
      if (k0 == 0) {
        const int per = a.vec ? hd >> 2 : hd;  // float4s or floats a row
        const int n_el = x.nvalid * per;
        for (int e0 = tid; e0 < n_el; e0 += 4 * kThreads) {
          float4 kx[4], vx[4];
          long long dst[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kThreads;
            dst[u] = -1;
            if (e >= n_el) continue;
            const int jj = e / per, d = e - jj * per;
            const int pos = off + x.j0 + jj;
            const int col = pos / a.BS;
            const int bk = col < a.MB ? tbl_s[col] : -1;
            const size_t src = ((size_t)s * a.CT + x.j0 + jj) * rs +
                               (size_t)h * hd;
            if (a.vec) {
              kx[u] = reinterpret_cast<const float4*>(a.kc + src)[d];
              vx[u] = reinterpret_cast<const float4*>(a.vc + src)[d];
            } else {
              kx[u].x = a.kc[src + d];
              vx[u].x = a.vc[src + d];
            }
            if (bk >= 0)
              dst[u] = (long long)(((size_t)bk * a.BS + pos % a.BS) * rs +
                                   (size_t)h * hd) +
                       (a.vec ? 4 * d : d);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (dst[u] < 0) continue;
            if (a.vec) {
              *reinterpret_cast<float4*>(a.kp + dst[u]) = kx[u];
              *reinterpret_cast<float4*>(a.vp + dst[u]) = vx[u];
            } else {
              a.kp[dst[u]] = kx[u].x;
              a.vp[dst[u]] = vx[u].x;
            }
          }
        }
      }

      // Q in registers: warp w holds the A fragments of its k8 steps
      // w, w + 16, ... (rows past Q or the chunk are zero)
      const bool q0 = r0 < Q && r0 / G < x.nrow;
      const bool q1 = r1 < Q && r1 / G < x.nrow;
      const float* qr0 = qg + (q0 ? rowoff(r0) : 0);
      const float* qr1 = qg + (q1 ? rowoff(r1) : 0);
      float qf[kMaxNT][4];
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j) {
        const int kk = (warp + j * kWarps) * 8;
        const int ca = kk + t4, cb = kk + t4 + 4;
        qf[j][0] = q0 && ca < hd ? qr0[ca] : 0.0f;
        qf[j][1] = q1 && ca < hd ? qr1[ca] : 0.0f;
        qf[j][2] = q0 && cb < hd ? qr0[cb] : 0.0f;
        qf[j][3] = q1 && cb < hd ? qr1[cb] : 0.0f;
      }
      // the last key position row er sees (rows past Q or nvalid: none)
      const int ejj = er / G;
      const int elast = er < Q && ejj < x.nvalid ? off + x.j0 + ejj : -1;
      float m = -INFINITY, l = 0.0f;  // row er's running max, denominator
      float acc[kMaxNT][4];
#pragma unroll
      for (int j = 0; j < kMaxNT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

      for (int i = 0; i < ntk; ++i) {
        const bool more = i + 1 < ntk;
        if (more) fetch(2 * i + 2);  // K(i+1) into V(i-1)'s slot
        cp_wait_n(more ? 2 : 1);     // K(i) landed
        __syncthreads();

        // S = Q K^T: warp w takes k8 steps w, w + 16, ...; two accumulator
        // sets (even and odd steps) for independent MMA chains
        const float* ka = ring + ((2 * i) % 3) * slot_f + g8 * stk + t4;
        float sc[2][2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            sc[u][c][0] = sc[u][c][1] = sc[u][c][2] = sc[u][c][3] = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          const int ks = warp + j * kWarps;
          if (ks < nks) {
            const int kk = ks * 8;
            uint32_t ah[4], al[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split(qf[j][e], ah[e], al[e]);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              uint32_t bh[2], bl[2];
              split(ka[c * 8 * stk + kk], bh[0], bl[0]);
              split(ka[c * 8 * stk + kk + 4], bh[1], bl[1]);
              mma_3xtf32(sc[j & 1][c], ah, al, bh, bl);
            }
          }
        }
        float* rw = red + warp * 256;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = c * 8 + 2 * t4;
          rw[g8 * 16 + col] = sc[0][c][0] + sc[1][c][0];
          rw[g8 * 16 + col + 1] = sc[0][c][1] + sc[1][c][1];
          rw[(g8 + 8) * 16 + col] = sc[0][c][2] + sc[1][c][2];
          rw[(g8 + 8) * 16 + col + 1] = sc[0][c][3] + sc[1][c][3];
        }
        __syncthreads();             // partial scores in; K(i)'s slot free
        if (more) fetch(2 * i + 3);  // V(i+1) into K(i)'s slot

        // online softmax: thread (er, ek), a row's 16 keys on 16 lanes
        if (tid < kSoftmax) {
          float sx = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) sx += red[w * 256 + tid];
          const int pos = k_lo + i * kKeys + ek;
          sx = pos < k_hi && pos <= elast ? sx * a.scale : -INFINITY;
          float mb = sx;
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
          const float m_new = fmaxf(m, mb);
          const float m_safe = isfinite(m_new) ? m_new : 0.0f;
          const float p = sx == -INFINITY ? 0.0f : expf(sx - m_safe);
          float ps = p;
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            ps += __shfl_xor_sync(0xffffffffu, ps, o);
          const float alpha = isfinite(m) ? expf(m - m_safe) : 0.0f;
          l = l * alpha + ps;
          m = m_new;
          p_s[er * kPS + ek] = p;
          if (ek == 0) al_s[er] = alpha;
        }
        cp_wait_n(more ? 2 : 0);     // V(i) landed
        __syncthreads();

        // acc = acc * alpha + P V: warp w owns n8 tiles w, w + 16, ... of hd
        {
          const float* vs = ring + ((2 * i + 1) % 3) * slot_f;
          const float a0 = al_s[g8], a1 = al_s[g8 + 8];
          uint32_t ph[2][4], pl[2][4];
#pragma unroll
          for (int kc = 0; kc < 2; ++kc) {
            const float* pr = p_s + g8 * kPS + kc * 8 + t4;
            split(pr[0], ph[kc][0], pl[kc][0]);
            split(pr[8 * kPS], ph[kc][1], pl[kc][1]);
            split(pr[4], ph[kc][2], pl[kc][2]);
            split(pr[8 * kPS + 4], ph[kc][3], pl[kc][3]);
          }
#pragma unroll
          for (int j = 0; j < kMaxNT; ++j) {
            const int nt = warp + j * kWarps;
            if (nt < nks) {
              acc[j][0] *= a0;
              acc[j][1] *= a0;
              acc[j][2] *= a1;
              acc[j][3] *= a1;
#pragma unroll
              for (int kc = 0; kc < 2; ++kc) {
                const float* vr = vs + (kc * 8 + t4) * stv + nt * 8 + g8;
                uint32_t bh[2], bl[2];
                split(vr[0], bh[0], bl[0]);
                split(vr[4 * stv], bh[1], bl[1]);
                mma_3xtf32(acc[j], ph[kc], pl[kc], bh, bl);
              }
            }
          }
        }
        __syncthreads();             // V(i)'s slot and P free
      }

      if (tid < kSoftmax && ek == 0) {
        ml_s[er] = m;
        ml_s[kRows + er] = l;
      }
      __syncthreads();
      if (k0 == 0 && k1 == x.cost) {  // the whole tile: out = acc / l
        const float d0 = fmaxf(ml_s[kRows + r0], 1e-30f);
        const float d1 = fmaxf(ml_s[kRows + r1], 1e-30f);
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          const int d = (warp + j * kWarps) * 8 + 2 * t4;
          if (d >= hd) continue;
          if (q0) {
            og[rowoff(r0) + d] = acc[j][0] / d0;
            if (d + 1 < hd) og[rowoff(r0) + d + 1] = acc[j][1] / d0;
          }
          if (q1) {
            og[rowoff(r1) + d] = acc[j][2] / d1;
            if (d + 1 < hd) og[rowoff(r1) + d + 1] = acc[j][3] / d1;
          }
        }
      } else {
        // a piece of a cut tile: the partial into this CTA's slot 0 (the
        // tile began before the range) or 1 (it runs past its end)
        const int slot = P < lo ? 0 : 1;
        float* pa = a.ws + (size_t)(2 * b + slot) * kRows * hd;
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          const int d = (warp + j * kWarps) * 8 + 2 * t4;
          if (d >= hd) continue;
          if (q0) {
            pa[(size_t)r0 * hd + d] = acc[j][0];
            if (d + 1 < hd) pa[(size_t)r0 * hd + d + 1] = acc[j][1];
          }
          if (q1) {
            pa[(size_t)r1 * hd + d] = acc[j][2];
            if (d + 1 < hd) pa[(size_t)r1 * hd + d + 1] = acc[j][3];
          }
        }
        if (tid < 2 * kRows) a.ml[(size_t)(2 * b + slot) * 2 * kRows + tid] =
            ml_s[tid];
        __threadfence();
        __syncthreads();
        // the tile's pieces: the CTAs from the owner of its first key
        // tile to that of its last, less those with an empty range
        const int b0 = owner(P, W, grid);
        const int b1 = owner(P + x.cost - 1, W, grid);
        auto held = [&](int bb) {
          return (long long)bb * W / grid < (long long)(bb + 1) * W / grid;
        };
        if (tid == 0) {
          int np = 0;
          for (int bb = b0; bb <= b1; ++bb) np += held(bb);
          sc_i[kWarps + 3] = atomicAdd(a.counters + t, 1) == np - 1;
        }
        __syncthreads();
        if (sc_i[kWarps + 3]) {
          // the last piece merges: in each thread's own fragment elements
          __threadfence();
          auto pslot = [&](int bb) {
            return 2 * bb + (P < (long long)bb * W / grid ? 0 : 1);
          };
          float M0 = -INFINITY, M1 = -INFINITY;
          for (int bb = b0; bb <= b1; ++bb) {
            if (!held(bb)) continue;
            const float* pm = a.ml + (size_t)pslot(bb) * 2 * kRows;
            M0 = fmaxf(M0, __ldcg(pm + r0));
            M1 = fmaxf(M1, __ldcg(pm + r1));
          }
          const float S0 = isfinite(M0) ? M0 : 0.0f;
          const float S1 = isfinite(M1) ? M1 : 0.0f;
          float L0 = 0.0f, L1 = 0.0f;
#pragma unroll
          for (int j = 0; j < kMaxNT; ++j)
            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
          for (int bb = b0; bb <= b1; ++bb) {
            if (!held(bb)) continue;
            const int ps = pslot(bb);
            const float* pm = a.ml + (size_t)ps * 2 * kRows;
            const float m0 = __ldcg(pm + r0), m1 = __ldcg(pm + r1);
            const float w0 = isfinite(m0) ? expf(m0 - S0) : 0.0f;
            const float w1 = isfinite(m1) ? expf(m1 - S1) : 0.0f;
            L0 = fmaf(w0, __ldcg(pm + kRows + r0), L0);
            L1 = fmaf(w1, __ldcg(pm + kRows + r1), L1);
            const float* pp = a.ws + (size_t)ps * kRows * hd;
#pragma unroll
            for (int j = 0; j < kMaxNT; ++j) {
              const int d = (warp + j * kWarps) * 8 + 2 * t4;
              if (d >= hd) continue;
              if (q0) {
                acc[j][0] = fmaf(w0, __ldcg(pp + (size_t)r0 * hd + d),
                                 acc[j][0]);
                if (d + 1 < hd)
                  acc[j][1] = fmaf(w0, __ldcg(pp + (size_t)r0 * hd + d + 1),
                                   acc[j][1]);
              }
              if (q1) {
                acc[j][2] = fmaf(w1, __ldcg(pp + (size_t)r1 * hd + d),
                                 acc[j][2]);
                if (d + 1 < hd)
                  acc[j][3] = fmaf(w1, __ldcg(pp + (size_t)r1 * hd + d + 1),
                                   acc[j][3]);
              }
            }
          }
          const float d0 = fmaxf(L0, 1e-30f), d1 = fmaxf(L1, 1e-30f);
#pragma unroll
          for (int j = 0; j < kMaxNT; ++j) {
            const int d = (warp + j * kWarps) * 8 + 2 * t4;
            if (d >= hd) continue;
            if (q0) {
              og[rowoff(r0) + d] = acc[j][0] / d0;
              if (d + 1 < hd) og[rowoff(r0) + d + 1] = acc[j][1] / d0;
            }
            if (q1) {
              og[rowoff(r1) + d] = acc[j][2] / d1;
              if (d + 1 < hd) og[rowoff(r1) + d + 1] = acc[j][3] / d1;
            }
          }
          if (tid == 0) a.counters[t] = 0;
        }
      }
      __syncthreads();  // the ring, red and ml_s are reused by the next piece
    }
    P += x.cost;
    if (t == t_last) break;
  }
}

size_t smem_bytes(int hd, int S, int MB) {
  const size_t hd8 = (size_t)((hd + 7) & ~7);
  return sizeof(float) * (3 * kKeys * (hd8 + 8) + kWarps * 256 +
                          kRows * kPS + 3 * kRows) +
         sizeof(int) * (2 * (size_t)S + MB + kWarps + 4);
}

// Raise the kernel's dynamic shared-memory limit once per device.
cudaError_t configure() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(paged_prefill_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// The launch's grid: one wave, the SMs times the CTAs of this kernel an
// SM holds at head width hd with S slots and MB-entry tables (0 where one
// does not fit).
extern "C" int paged_prefill_grid(int S, int hd, int MB, void* grid) {
  *(int*)grid = 0;
  if (S < 0 || hd < 1 || hd > 8 * kWarps * kMaxNT || MB < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hd, S, MB);
  if (smem > (size_t)kMaxSmem) return (int)cudaSuccess;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per, paged_prefill_kernel, kThreads, smem)) != cudaSuccess)
    return (int)e;
  *(int*)grid = sms * per;
  return (int)cudaSuccess;
}

// ws: 2 grid 16 hd floats of partial accumulators, then 2 grid 2 16
// floats of (m, l); counters: S KV ntiles ints, zero (the kernel leaves
// them zero); grid from `paged_prefill_grid`.
extern "C" int paged_prefill_launch(
    const void* q, const void* k_chunk, const void* v_chunk, void* k_pool,
    void* v_pool, const void* tbl, const void* off, const void* lens,
    void* out, void* ws, void* counters, int S, int CT, int H, int KV, int hd,
    int BS, int MB, float scale, int grid, void* stream) {
  if (S < 0 || CT < 1 || KV < 1 || H % KV != 0 || H / KV > kRows ||
      hd < 1 || hd > 8 * kWarps * kMaxNT || BS < 1 || MB < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(hd, S, MB);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  const int G = H / KV;
  Args a;
  a.q = (const float*)q;
  a.kc = (const float*)k_chunk;
  a.vc = (const float*)v_chunk;
  a.kp = (float*)k_pool;
  a.vp = (float*)v_pool;
  a.tbl = (const int*)tbl;
  a.offs = (const int*)off;
  a.lens = (const int*)lens;
  a.out = (float*)out;
  a.ws = (float*)ws;
  a.ml = a.ws + (size_t)2 * grid * kRows * hd;
  a.counters = (int*)counters;
  a.S = S;
  a.CT = CT;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  a.BS = BS;
  a.MB = MB;
  a.R = min(kRows / G, CT);  // chunk rows per tile
  a.ntiles = (CT + a.R - 1) / a.R;
  a.scale = scale;
  const uintptr_t all = (uintptr_t)q | (uintptr_t)k_chunk |
                        (uintptr_t)v_chunk | (uintptr_t)k_pool |
                        (uintptr_t)v_pool;
  a.vec = hd % 4 == 0 && (all & 15) == 0;
  if ((long long)S * KV * a.ntiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  paged_prefill_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
