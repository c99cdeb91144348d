// Fused multi-tenant QoS admission round for Hopper (sm_90a), data prep
// included: one launch reads the caller's rows and the engine's state as
// they lie and writes the round's outputs as the caller keeps them.
//
// Replaces the TPU kernel src/repro/kernels/qos_admission.py:249
// `qos_round_fused` (body `_qos_kernel`, :52): expire -> weighted stride
// replenish -> waiting-array poke -> tombstone-transparent per-tenant FCFS
// admit -> reclaim.  Plain version: `admission.functional_qos.qos_round`;
// this kernel matches it bit for bit (CPU twins: the rank
// `kernels.ref.qos_live_rank`, the round `kernels.ref.qos_round_kernel_ref`).
//
// What bounds it on this card: neither bytes nor operations.  The backlog
// is a few thousand rows (tens of KB) and the work is O(N log^2 N + 32 S U
// + S T) integer operations, so the round is bound by latency: one launch,
// a chain of dependent phases and their __syncthreads barriers.  The JAX
// wrapper leaves the data preparation around its kernel (the wrap-safe
// ticket order, the conversions, the scatter back) to XLA, which fuses it
// into the same program; in eager PyTorch each of those operations is a
// launch of its own (~40 a round, ~0.7 ms of host time).  So all of it
// moves in here.
//
// What the design does about it:
//   * ONE block of 1024 threads runs the whole round from the caller's
//     buffers: tenant ids i32, tickets and the state counters as int64 u32
//     carriers (read as their low 32 bits, written back masked to 32
//     bits), alive as bytes, deadlines f32.  `now` and `free_units` come
//     by pointer from the engine's device scalars, or by value.  admitted
//     and expired are written in the caller's row order.  The wrapper
//     does checks, one allocation and this launch, nothing else.
//   * The wrap-safe FCFS order is computed here, order-free: each
//     tenant's first-seen row (a shared atomicMin), each live row's key,
//     the signed 32-bit distance of its ticket from that row's ticket, and
//     a bitonic sort of (tenant, key, row) packed into 64 bits in shared
//     memory.  A live row's rank among its tenant's live rows is its
//     sorted position minus its tenant's first position (an exclusive
//     prefix of the live depths): the same integers as the stable argsort
//     of `core.functional.ticket_order` and `live_fifo_rank`.  A tenant's
//     admitted count is then min(depth, avail) in closed form.
//   * Per-tenant depth, dead bump, alloc and avail live in shared memory;
//     the sort keys take 8 bytes a row of dynamic shared memory, so one CTA
//     takes up to kMaxRows rows (the large path below past that).
//   * The stride keys `vpass + k/w` use __fdiv_rn / __fadd_rn (correctly
//     rounded, never contracted) and __float_as_uint, so the 32-step
//     bit-descend selects the same crossings as the reference's stable
//     argsort; ties flow in tenant order.
//   * All counter arithmetic is uint32_t, so it wraps exactly as the
//     reference's uint32.
//
// Past one CTA's limits (more than kMaxRows rows or kMaxTenants tenants)
// the wrapper takes the large path, `qos_round_large_kernel` below: the
// wrapper sorts the rows by `core.functional.ticket_order` first, as the
// reference's wrapper does in XLA outside its pallas_call, and the kernel
// does what the Pallas body does, over the sorted rows, with every
// per-tenant array in a global workspace (CPU twin:
// `kernels.ref.qos_round_large_ref`).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTenants = 256;          // the engine packs tenant < 2^8
constexpr int kMaxRows = 16384;           // 128 KB of sort keys
constexpr int kMaxDevices = 64;
constexpr uint32_t kInfBits = 0x7F800000u;  // f32 +inf; crossings are >= 0
constexpr uint32_t kMix32KA = 0x9ABE94E3u;  // core/hashfn.py MIX32KA
constexpr uint32_t kStride = 17u;           // core/hashfn.py TICKET_STRIDE
constexpr uint32_t kStrideInv = 0xF0F0F0F1u;  // 17^-1 mod 2^32
constexpr unsigned long long kNoKey = ~0ull;  // a row that is not live

struct Shared {
  uint32_t ticket[kMaxTenants];
  uint32_t grant[kMaxTenants];
  uint32_t consumed[kMaxTenants];
  uint32_t dead[kMaxTenants];
  int depth[kMaxTenants];
  uint32_t deadb[kMaxTenants];
  int unmet[kMaxTenants];
  float weight[kMaxTenants];
  float vpass[kMaxTenants];
  uint32_t alloc[kMaxTenants];
  int availr[kMaxTenants];
  uint32_t width[kMaxTenants];
  uint32_t pstart[kMaxTenants];  // poke window start
  int first[kMaxTenants];        // first-seen row
  int rstart[kMaxTenants];       // first sorted position
  int lt[kMaxTenants];
  int eq[kMaxTenants];
  int red[kWarps];
  int leftover;
};

// Bits of a tenant's k-th crossing, vp + k/w (functional_qos.
// stride_alloc): +inf past its unmet demand um or for w <= 0.
__device__ __forceinline__ uint32_t key_at(float w, float vp, int um, int k) {
  const float kf = (float)k;
  float step = 0.0f;
  if (k != 0) step = (w > 0.0f) ? __fdiv_rn(kf, w) : INFINITY;
  const float cross = (kf < (float)um) ? __fadd_rn(vp, step) : INFINITY;
  return __float_as_uint(cross);
}

__device__ __forceinline__ uint32_t cross_key(const Shared& sh, int s, int k) {
  return key_at(sh.weight[s], sh.vpass[s], sh.unmet[s], k);
}

// Sum over the block (``red``: kWarps ints of shared memory); every
// thread gets the total.
__device__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < kWarps; ++w) tot += red[w];
  __syncthreads();
  return tot;
}

__global__ void __launch_bounds__(kThreads) qos_round_kernel(
    const int* __restrict__ ids, const long long* __restrict__ tickets,
    const uint8_t* __restrict__ alive, const float* __restrict__ dl, int n,
    const long long* __restrict__ ticket, const long long* __restrict__ grant,
    const long long* __restrict__ consumed,
    const long long* __restrict__ dead, const float* __restrict__ weight,
    const float* __restrict__ vpass, const long long* __restrict__ seq,
    int table, const long long* __restrict__ salt_p,
    const float* __restrict__ now_p, float now_v,
    const int* __restrict__ free_p, int free_v, int S, int max_units,
    long long* __restrict__ out_u, float* __restrict__ vpass_out,
    int* __restrict__ leftover_out, uint8_t* __restrict__ adm_out,
    uint8_t* __restrict__ exp_out) {
  __shared__ Shared sh;
  extern __shared__ unsigned long long keys[];
  const int tid = threadIdx.x;
  const float now = now_p ? *now_p : now_v;
  const int free_units = free_p ? *free_p : free_v;
  const uint32_t salt = (uint32_t)*salt_p;
  const unsigned uS = (unsigned)S;

  for (int s = tid; s < S; s += kThreads) {
    sh.ticket[s] = (uint32_t)ticket[s];
    sh.grant[s] = (uint32_t)grant[s];
    sh.consumed[s] = (uint32_t)consumed[s];
    sh.dead[s] = (uint32_t)dead[s];
    sh.depth[s] = 0;
    sh.deadb[s] = 0;
    sh.lt[s] = 0;
    sh.eq[s] = 0;
    sh.first[s] = INT_MAX;
    sh.weight[s] = weight[s];
    sh.vpass[s] = vpass[s];
  }
  __syncthreads();

  // (1) expiry, per-tenant live depth and first-seen row.  A row whose
  // tenant id lies outside [0, S) is never live, expired or admitted.
  for (int i = tid; i < n; i += kThreads) {
    const int t = ids[i];
    const bool ok = (unsigned)t < uS;
    const bool a = ok && alive[i] != 0;
    const bool newly = a && (dl[i] <= now);
    exp_out[i] = newly ? 1 : 0;
    if (!(a && !newly)) adm_out[i] = 0;
    if (ok) atomicMin(&sh.first[t], i);
    if (newly) atomicAdd(&sh.deadb[t], 1u);
    else if (a) atomicAdd(&sh.depth[t], 1);
  }
  __syncthreads();

  // (1b) sort keys: (tenant, signed ticket distance from the tenant's
  // first-seen row, row) for live rows; all ones for the rest
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = tid; i < P; i += kThreads) {
    unsigned long long k = kNoKey;
    if (i < n) {
      const int t = ids[i];
      if ((unsigned)t < uS && alive[i] != 0 && !(dl[i] <= now)) {
        const uint32_t d = (uint32_t)tickets[i] -
                           (uint32_t)tickets[sh.first[t]];
        k = ((unsigned long long)t << 48) |
            ((unsigned long long)(d ^ 0x80000000u) << 16) |
            (unsigned long long)i;
      }
    }
    keys[i] = k;
  }
  __syncthreads();
  // bitonic sort of the P keys, ascending
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int e = tid; e < (P >> 1); e += kThreads) {
        const int lo = 2 * j * (e / j) + (e % j);
        const int hi = lo + j;
        const unsigned long long a = keys[lo], b = keys[hi];
        if (((lo & k) == 0) == (a > b)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // (2) closed-form weighted stride replenish
  for (int s = tid; s < S; s += kThreads) {
    const int avail0 = (int)(sh.grant[s] - sh.consumed[s]);
    sh.unmet[s] = max(0, min(sh.depth[s] - avail0, max_units));
  }
  __syncthreads();
  const int total = S * max_units;
  int cnt = 0;
  for (int e = tid; e < total; e += kThreads)
    cnt += cross_key(sh, e / max_units, e % max_units) < kInfBits;
  cnt = block_sum(cnt, sh.red);
  const int take = min(min(max(free_units, 0), max_units), cnt);

  // bit-descend: the largest theta with count(key < theta) < take is the
  // take-th smallest crossing
  uint32_t theta = 0;
  for (int b = 0; b < 32; ++b) {
    const uint32_t cand = theta | (1u << (31 - b));
    int c = 0;
    for (int e = tid; e < total; e += kThreads)
      c += cross_key(sh, e / max_units, e % max_units) < cand;
    c = block_sum(c, sh.red);
    if (c < take) theta = cand;
  }
  for (int e = tid; e < total; e += kThreads) {
    const uint32_t key = cross_key(sh, e / max_units, e % max_units);
    if (key < theta) atomicAdd(&sh.lt[e / max_units], 1);
    else if (key == theta) atomicAdd(&sh.eq[e / max_units], 1);
  }
  __syncthreads();
  if (tid == 0) {
    // units tied at theta flow in tenant order (the stable argsort)
    int lt_total = 0;
    for (int s = 0; s < S; ++s) lt_total += sh.lt[s];
    const int rem = take - lt_total;
    int exc = 0;
    for (int s = 0; s < S; ++s) {
      const int extra = min(max(rem - exc, 0), sh.eq[s]);
      exc += sh.eq[s];
      sh.alloc[s] = (uint32_t)(sh.lt[s] + extra);
    }
    sh.leftover = free_units;
  }
  if (tid < 32) {
    // each tenant's first sorted position: the exclusive prefix of the
    // live depths in tenant order
    int carry = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + tid;
      const int v = s < S ? sh.depth[s] : 0;
      int x = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (tid >= o) x += y;
      }
      if (s < S) sh.rstart[s] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  for (int s = tid; s < S; s += kThreads) {
    const uint32_t a = sh.alloc[s];
    sh.availr[s] = (int)(sh.grant[s] - sh.consumed[s]) + (int)a;
    const float w = sh.weight[s];
    const float dv =
        a > 0 ? (w > 0.0f ? __fdiv_rn((float)a, w) : INFINITY) : 0.0f;
    vpass_out[s] = __fadd_rn(sh.vpass[s], dv);
    // poke window [grant, grant + alloc + dead slack), clamped to the
    // issued-ticket frontier
    const uint32_t dead0 = sh.dead[s] + sh.deadb[s];
    const int outstanding = max((int)(sh.ticket[s] - sh.grant[s]), 0);
    sh.width[s] = (uint32_t)min((int)(a + dead0), outstanding);
    const uint32_t tsalt = salt + (uint32_t)(s + 1) * kMix32KA;
    sh.pstart[s] = tsalt + sh.grant[s] * kStride;
  }
  __syncthreads();
  // waiting-array poke through the coprime-stride inverse: no scatter
  long long* seq_out = out_u + 3 * S;
  for (int j = tid; j < table; j += kThreads) {
    uint32_t bump = 0;
    for (int s = 0; s < S; ++s) {
      const uint32_t off =
          (((uint32_t)j - sh.pstart[s]) * kStrideInv) & (uint32_t)(table - 1);
      bump += off < sh.width[s];
    }
    seq_out[j] = (long long)(uint32_t)((uint32_t)seq[j] + bump);
  }

  // (3) tombstone-transparent FCFS admit: a live row's rank is its sorted
  // position less its tenant's first one
  for (int p = tid; p < P; p += kThreads) {
    const unsigned long long k = keys[p];
    if (k == kNoKey) continue;
    const int t = (int)(k >> 48);
    const int row = (int)(k & 0xFFFFull);
    adm_out[row] = (p - sh.rstart[t]) < sh.availr[t] ? 1 : 0;
  }

  // (4) reclaim stranded credit, decay the dead slack, write the state;
  // the tenant's admitted count is min(depth, avail) in closed form
  for (int s = tid; s < S; s += kThreads) {
    const int sp = max(0, min(sh.depth[s], sh.availr[s]));
    const int depth_after = sh.depth[s] - sp;
    const int avail_after = sh.availr[s] - sp;
    const uint32_t surplus = (uint32_t)max(avail_after - depth_after, 0);
    const uint32_t dead0 = sh.dead[s] + sh.deadb[s];
    out_u[s] = (long long)(uint32_t)(sh.grant[s] + sh.alloc[s]);
    out_u[S + s] =
        (long long)(uint32_t)(sh.consumed[s] + (uint32_t)sp + surplus);
    out_u[2 * S + s] = (long long)(uint32_t)(dead0 - min(dead0, surplus));
    atomicAdd(&sh.leftover, (int)surplus - (int)sh.alloc[s]);
  }
  __syncthreads();
  if (tid == 0) *leftover_out = sh.leftover;
}

// ------------------------------------------------------------- large path
//
// One CTA, any number of rows and tenants.  The rows arrive with their
// wrap-safe per-tenant ticket order (`order`, int64: sorted position ->
// row), computed by the wrapper; ties across tenants do not matter, since
// a rank counts only rows of its own tenant.  The sorted rows are cut into
// kWarps contiguous chunks of whole warp steps, one chunk a warp:
//   phase 0  each warp walks its chunk, 32 rows a step, and counts its live
//            rows per tenant (`cnt[c][t]`, warp-aggregated by
//            __match_any_sync) and the newly expired per tenant (deadb);
//   carry    an exclusive scan of cnt over the chunks gives each chunk its
//            per-tenant rank base, and its total the live depth (the
//            Pallas grid's sequential carry, cut at the chunk bounds);
//   replenish  the same correctly rounded crossing keys and 32-step
//            bit-descend as the one-CTA kernel.  A tenant's keys do not
//            decrease with k (correctly rounded k/w and vpass + k/w are
//            monotone in k), so its count of keys below a candidate is a
//            binary search over k, and the sums over S are block
//            reductions; ties at theta flow in tenant order through a
//            block scan of the tie counts;
//   poke     one thread a (bucket, tenant) pair, bumps added atomically;
//   phase 1  each warp walks its chunk again: a live row's rank is its
//            chunk's base for its tenant plus the live rows of its tenant
//            before it in the chunk; admitted iff rank < avail;
//   reclaim  per tenant in closed form, the leftover a block reduction.
// admitted and expired are written in the caller's row order.  Bound, as
// the one-CTA kernel, by latency, not bytes or operations: each warp walk
// is n / 1024 steps of dependent gathers (order, then the row), and the
// replenish is 35 block reductions.  Spreading the walks over CTAs (a
// second pass for the chunk carries) is the next step past one CTA.

// Workspace, int32 each: cnt (kWarps x S), then deadb, depth, unmet, lt,
// eq, alloc, availr, width, pstart (S each), then bump (table).

// The number of a tenant's crossings k < um whose key lies below cand.
__device__ int count_below(float w, float vp, int um, uint32_t cand) {
  int lo = 0, hi = um;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_at(w, vp, um, mid) < cand) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Exclusive scan over the block in thread order; *total gets the sum.
__device__ int block_exscan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int y = red[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    red[lane] = y;
  }
  __syncthreads();
  const int base = warp ? red[warp - 1] : 0;
  *total = red[kWarps - 1];
  __syncthreads();
  return base + x - v;
}

__global__ void __launch_bounds__(kThreads) qos_round_large_kernel(
    const int* __restrict__ ids, const long long* __restrict__ tickets,
    const uint8_t* __restrict__ alive, const float* __restrict__ dl,
    const long long* __restrict__ order, int n,
    const long long* __restrict__ ticket, const long long* __restrict__ grant,
    const long long* __restrict__ consumed,
    const long long* __restrict__ dead, const float* __restrict__ weight,
    const float* __restrict__ vpass, const long long* __restrict__ seq,
    int table, const long long* __restrict__ salt_p,
    const float* __restrict__ now_p, float now_v,
    const int* __restrict__ free_p, int free_v, int S, int max_units,
    long long* __restrict__ out_u, float* __restrict__ vpass_out,
    int* __restrict__ leftover_out, uint8_t* __restrict__ adm_out,
    uint8_t* __restrict__ exp_out, int* __restrict__ ws) {
  __shared__ int red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const float now = now_p ? *now_p : now_v;
  const int free_units = free_p ? *free_p : free_v;
  const uint32_t salt = (uint32_t)*salt_p;
  const unsigned uS = (unsigned)S;
  int* cnt = ws;
  int* deadb = ws + (size_t)kWarps * S;
  int* depth = deadb + S;
  int* unmet = depth + S;
  int* ltc = unmet + S;
  int* eqc = ltc + S;
  uint32_t* alloc = (uint32_t*)(eqc + S);
  int* availr = (int*)(alloc + S);
  uint32_t* width = (uint32_t*)(availr + S);
  uint32_t* pstart = width + S;
  int* bump = (int*)(pstart + S);

  for (long long e = tid; e < (long long)kWarps * S; e += kThreads) cnt[e] = 0;
  for (int s = tid; s < S; s += kThreads) deadb[s] = 0;
  for (int j = tid; j < table; j += kThreads) bump[j] = 0;
  __syncthreads();

  // each warp's chunk of sorted positions: whole warp steps
  const long long chunk = (((long long)n + kThreads - 1) / kThreads) * 32;
  const long long c0 = chunk * warp;
  int* my_cnt = cnt + (size_t)warp * S;

  // (0) live rows per (chunk, tenant), newly expired per tenant; masks
  // default to not admitted
  for (long long p0 = c0; p0 < c0 + chunk; p0 += 32) {
    const long long p = p0 + lane;
    int key = -1, dkey = -1;
    if (p < n) {
      const long long row = order[p];
      const int t = ids[row];
      const bool a = (unsigned)t < uS && alive[row] != 0;
      const bool newly = a && (dl[row] <= now);
      exp_out[row] = newly ? 1 : 0;
      adm_out[row] = 0;
      if (newly) dkey = t;
      else if (a) key = t;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && (peers & lt_mask) == 0) my_cnt[key] += __popc(peers);
    const unsigned dpeers = __match_any_sync(0xffffffffu, dkey);
    if (dkey >= 0 && (dpeers & lt_mask) == 0)
      atomicAdd(&deadb[dkey], __popc(dpeers));
    __syncwarp();  // the next step's leader of a tenant sees this count
  }
  __syncthreads();

  // chunk bases: exclusive scan over the chunks; the total is the depth
  for (int t = tid; t < S; t += kThreads) {
    int run = 0;
    for (int c = 0; c < kWarps; ++c) {
      const int v = cnt[(size_t)c * S + t];
      cnt[(size_t)c * S + t] = run;
      run += v;
    }
    depth[t] = run;
  }
  __syncthreads();

  // (2) closed-form weighted stride replenish
  int finite = 0;
  for (int s = tid; s < S; s += kThreads) {
    const int avail0 = (int)((uint32_t)grant[s] - (uint32_t)consumed[s]);
    const int um = max(0, min(depth[s] - avail0, max_units));
    unmet[s] = um;
    finite += count_below(weight[s], vpass[s], um, kInfBits);
  }
  finite = block_sum(finite, red);
  const int take = min(min(max(free_units, 0), max_units), finite);
  // bit-descend: the largest theta with count(key < theta) < take is the
  // take-th smallest crossing
  uint32_t theta = 0;
  for (int b = 0; b < 32; ++b) {
    const uint32_t cand = theta | (1u << (31 - b));
    int c = 0;
    for (int s = tid; s < S; s += kThreads)
      c += count_below(weight[s], vpass[s], unmet[s], cand);
    c = block_sum(c, red);
    if (c < take) theta = cand;
  }
  int lt_local = 0;
  for (int s = tid; s < S; s += kThreads) {
    const int l = count_below(weight[s], vpass[s], unmet[s], theta);
    ltc[s] = l;
    eqc[s] = count_below(weight[s], vpass[s], unmet[s], theta + 1u) - l;
    lt_local += l;
  }
  const int rem = take - block_sum(lt_local, red);
  // units tied at theta flow in tenant order (the stable argsort): an
  // exclusive scan of the tie counts, chunk by chunk of tenants
  int exc_carry = 0;
  for (int s0 = 0; s0 < S; s0 += kThreads) {
    const int s = s0 + tid;
    const int e = s < S ? eqc[s] : 0;
    int tot;
    const int exc = exc_carry + block_exscan(e, red, &tot);
    if (s < S) alloc[s] = (uint32_t)(ltc[s] + min(max(rem - exc, 0), e));
    exc_carry += tot;
  }
  for (int s = tid; s < S; s += kThreads) {
    const uint32_t a = alloc[s];
    const uint32_t g = (uint32_t)grant[s];
    availr[s] = (int)(g - (uint32_t)consumed[s]) + (int)a;
    const float w = weight[s];
    const float dv =
        a > 0 ? (w > 0.0f ? __fdiv_rn((float)a, w) : INFINITY) : 0.0f;
    vpass_out[s] = __fadd_rn(vpass[s], dv);
    // poke window [grant, grant + alloc + dead slack), clamped to the
    // issued-ticket frontier
    const uint32_t dead0 = (uint32_t)dead[s] + (uint32_t)deadb[s];
    const int outstanding = max((int)((uint32_t)ticket[s] - g), 0);
    width[s] = (uint32_t)min((int)(a + dead0), outstanding);
    pstart[s] = salt + (uint32_t)(s + 1) * kMix32KA + g * kStride;
  }
  __syncthreads();

  // waiting-array poke through the coprime-stride inverse: one thread a
  // (bucket, tenant) pair
  const int tshift = __ffs(table) - 1;
  for (long long e = tid; e < ((long long)S << tshift); e += kThreads) {
    const int j = (int)(e & (table - 1));
    const int s = (int)(e >> tshift);
    const uint32_t off =
        (((uint32_t)j - pstart[s]) * kStrideInv) & (uint32_t)(table - 1);
    if (off < width[s]) atomicAdd(&bump[j], 1);
  }

  // (3) tombstone-transparent FCFS admit over the sorted rows
  for (long long p0 = c0; p0 < c0 + chunk; p0 += 32) {
    const long long p = p0 + lane;
    int key = -1;
    long long row = 0;
    if (p < n) {
      row = order[p];
      const int t = ids[row];
      if ((unsigned)t < uS && alive[row] != 0 && !(dl[row] <= now)) key = t;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (key >= 0 && lane == leader) {
      base = my_cnt[key];
      my_cnt[key] = base + __popc(peers);
    }
    base = __shfl_sync(0xffffffffu, base, leader);
    if (key >= 0)
      adm_out[row] = (base + __popc(peers & lt_mask)) < availr[key] ? 1 : 0;
    __syncwarp();
  }
  __syncthreads();

  long long* seq_out = out_u + 3 * (size_t)S;
  for (int j = tid; j < table; j += kThreads)
    seq_out[j] = (long long)(uint32_t)((uint32_t)seq[j] + (uint32_t)bump[j]);

  // (4) reclaim stranded credit, decay the dead slack, write the state
  int left = 0;
  for (int s = tid; s < S; s += kThreads) {
    const int sp = max(0, min(depth[s], availr[s]));
    const int depth_after = depth[s] - sp;
    const int avail_after = availr[s] - sp;
    const uint32_t surplus = (uint32_t)max(avail_after - depth_after, 0);
    const uint32_t dead0 = (uint32_t)dead[s] + (uint32_t)deadb[s];
    out_u[s] = (long long)(uint32_t)((uint32_t)grant[s] + alloc[s]);
    out_u[S + s] = (long long)(uint32_t)((uint32_t)consumed[s] +
                                         (uint32_t)sp + surplus);
    out_u[2 * (size_t)S + s] =
        (long long)(uint32_t)(dead0 - min(dead0, surplus));
    left += (int)surplus - (int)alloc[s];
  }
  left = block_sum(left, red);
  if (tid == 0) *leftover_out = free_units + left;
}

// Raise the kernel's dynamic shared-memory limit once per device.
cudaError_t configure() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(qos_round_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(unsigned long long) * kMaxRows));
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// out_u: (3 n_tenants + table) int64 — grant', consumed', dead', then
// bucket_seq'; vpass_out (n_tenants,) f32; leftover_out one int32;
// adm_out / exp_out (n,) bytes.  now / free_units: a device pointer, or
// NULL and the value beside it.
extern "C" int qos_round_launch(
    const void* ids, const void* tickets, const void* alive, const void* dl,
    int n, const void* ticket, const void* grant, const void* consumed,
    const void* dead, const void* weight, const void* vpass, const void* seq,
    int table, const void* salt, const void* now_p, float now_v,
    const void* free_p, int free_v, int n_tenants, int max_units,
    void* out_u, void* vpass_out, void* leftover_out, void* adm_out,
    void* exp_out, void* stream) {
  if (n_tenants < 1 || n_tenants > kMaxTenants || max_units < 1 ||
      table < 1 || (table & (table - 1)) != 0 || n < 0 || n > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  int P = 1;
  while (P < n) P <<= 1;
  qos_round_kernel<<<1, kThreads, sizeof(unsigned long long) * P,
                     (cudaStream_t)stream>>>(
      (const int*)ids, (const long long*)tickets, (const uint8_t*)alive,
      (const float*)dl, n, (const long long*)ticket, (const long long*)grant,
      (const long long*)consumed, (const long long*)dead,
      (const float*)weight, (const float*)vpass, (const long long*)seq,
      table, (const long long*)salt, (const float*)now_p, now_v,
      (const int*)free_p, free_v, n_tenants, max_units, (long long*)out_u,
      (float*)vpass_out, (int*)leftover_out, (uint8_t*)adm_out,
      (uint8_t*)exp_out);
  return (int)cudaGetLastError();
}

// The large path: as qos_round_launch, plus the rows' ticket order
// (`order`, n int64) and the workspace `ws` (int32, (kWarps + 9) *
// n_tenants + table); any n >= 0 and n_tenants >= 1.
extern "C" int qos_round_large_launch(
    const void* ids, const void* tickets, const void* alive, const void* dl,
    const void* order, int n, const void* ticket, const void* grant,
    const void* consumed, const void* dead, const void* weight,
    const void* vpass, const void* seq, int table, const void* salt,
    const void* now_p, float now_v, const void* free_p, int free_v,
    int n_tenants, int max_units, void* out_u, void* vpass_out,
    void* leftover_out, void* adm_out, void* exp_out, void* ws,
    void* stream) {
  if (n_tenants < 1 || max_units < 1 || table < 1 ||
      (table & (table - 1)) != 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  qos_round_large_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ids, (const long long*)tickets, (const uint8_t*)alive,
      (const float*)dl, (const long long*)order, n, (const long long*)ticket,
      (const long long*)grant, (const long long*)consumed,
      (const long long*)dead, (const float*)weight, (const float*)vpass,
      (const long long*)seq, table, (const long long*)salt,
      (const float*)now_p, now_v, (const int*)free_p, free_v, n_tenants,
      max_units, (long long*)out_u, (float*)vpass_out, (int*)leftover_out,
      (uint8_t*)adm_out, (uint8_t*)exp_out, (int*)ws);
  return (int)cudaGetLastError();
}
