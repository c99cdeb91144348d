// Fused multi-tenant QoS admission round for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/qos_admission.py:249
// `qos_round_fused` (body `_qos_kernel`, :52): expire -> weighted stride
// replenish -> waiting-array poke -> tombstone-transparent per-tenant FCFS
// admit -> reclaim, over a backlog the wrapper has put in wrap-safe
// per-tenant ticket order (`core.functional.ticket_order`).  Plain version:
// `admission.functional_qos.qos_round`; this kernel matches it bit for bit.
//
// What bounds it on this card: neither bytes nor operations.  The backlog
// is a few thousand rows (tens of KB) and the work is O(N + 32*S*U + S*T)
// integer operations, so the round is bound by latency: one launch, a
// chain of dependent phases and their __syncthreads barriers.
//
// What the design does about it:
//   * ONE block of 1024 threads runs the whole round.  Its own loops take
//     the place of the TPU's sequential (2, nb) grid and its VMEM carries;
//     per-tenant depth, dead bump, alloc, avail, rank carry and spend live
//     in shared memory, so the round costs one launch and no second pass.
//   * Every count is an integer: per-tenant sums are shared-memory
//     atomics, and the per-tenant live rank is a warp match (lanes holding
//     the same tenant) + ballot popcount inside a warp, plus a per-warp
//     per-tenant table summed across the earlier warps of the chunk, plus
//     the carried per-tenant base.  The TPU's strict-lower-triangular f32
//     MXU matmuls are not used.
//   * The stride keys `vpass + k/w` use __fdiv_rn / __fadd_rn (correctly
//     rounded, never contracted) and __float_as_uint, so the 32-step
//     bit-descend selects the same crossings as the reference's stable
//     argsort; ties flow in tenant order.
//   * u32 state arrives as 32-bit buffers and is read as uint32_t, so all
//     counter arithmetic wraps exactly as the reference's uint32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTenants = 256;          // the engine packs tenant < 2^8
constexpr uint32_t kInfBits = 0x7F800000u;  // f32 +inf; crossings are >= 0
constexpr uint32_t kMix32KA = 0x9ABE94E3u;  // core/hashfn.py MIX32KA
constexpr uint32_t kStride = 17u;           // core/hashfn.py TICKET_STRIDE
constexpr uint32_t kStrideInv = 0xF0F0F0F1u;  // 17^-1 mod 2^32

struct Shared {
  int depth[kMaxTenants];
  uint32_t deadb[kMaxTenants];
  int unmet[kMaxTenants];
  float weight[kMaxTenants];
  float vpass[kMaxTenants];
  uint32_t alloc[kMaxTenants];
  int availr[kMaxTenants];
  int base[kMaxTenants];
  uint32_t spent[kMaxTenants];
  uint32_t width[kMaxTenants];
  uint32_t start[kMaxTenants];
  int lt[kMaxTenants];
  int eq[kMaxTenants];
  int warp_cnt[kWarps][kMaxTenants];
  int red[kWarps];
  int leftover;
};

// Bits of tenant s's k-th crossing, vpass_s + k/w_s (functional_qos.
// stride_alloc): +inf past the tenant's unmet demand or for w <= 0.
__device__ __forceinline__ uint32_t cross_key(const Shared& sh, int s, int k) {
  const float kf = (float)k;
  const float w = sh.weight[s];
  float step = 0.0f;
  if (k != 0) step = (w > 0.0f) ? __fdiv_rn(kf, w) : INFINITY;
  const float cross =
      (kf < (float)sh.unmet[s]) ? __fadd_rn(sh.vpass[s], step) : INFINITY;
  return __float_as_uint(cross);
}

// Sum over the block; every thread gets the total.
__device__ int block_sum(int v, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5] = v;
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < kWarps; ++w) tot += sh.red[w];
  __syncthreads();
  return tot;
}

__global__ void __launch_bounds__(kThreads) qos_round_kernel(
    const int* __restrict__ ids, const uint8_t* __restrict__ alive,
    const float* __restrict__ dl, int n, const uint32_t* __restrict__ ticket,
    const uint32_t* __restrict__ grant, const uint32_t* __restrict__ consumed,
    const uint32_t* __restrict__ dead, const float* __restrict__ weight,
    const float* __restrict__ vpass, const uint32_t* __restrict__ seq,
    int table, const uint32_t* __restrict__ salt_p,
    const float* __restrict__ now_p, const int* __restrict__ free_p, int S,
    int max_units, uint8_t* __restrict__ adm_out,
    uint8_t* __restrict__ exp_out, uint32_t* __restrict__ grant_out,
    uint32_t* __restrict__ consumed_out, uint32_t* __restrict__ dead_out,
    float* __restrict__ vpass_out, uint32_t* __restrict__ seq_out,
    int* __restrict__ leftover_out) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float now = *now_p;
  const int free_units = *free_p;
  const uint32_t salt = *salt_p;

  for (int s = tid; s < S; s += kThreads) {
    sh.depth[s] = 0;
    sh.deadb[s] = 0;
    sh.lt[s] = 0;
    sh.eq[s] = 0;
    sh.base[s] = 0;
    sh.spent[s] = 0;
    sh.weight[s] = weight[s];
    sh.vpass[s] = vpass[s];
  }
  __syncthreads();

  // (1) expiry and per-tenant live depth
  for (int i = tid; i < n; i += kThreads) {
    const bool a = alive[i] != 0;
    const bool newly = a && (dl[i] <= now);
    exp_out[i] = newly ? 1 : 0;
    if (newly) atomicAdd(&sh.deadb[ids[i]], 1u);
    else if (a) atomicAdd(&sh.depth[ids[i]], 1);
  }
  __syncthreads();

  // (2) closed-form weighted stride replenish
  for (int s = tid; s < S; s += kThreads) {
    const int avail0 = (int)(grant[s] - consumed[s]);
    sh.unmet[s] = max(0, min(sh.depth[s] - avail0, max_units));
  }
  __syncthreads();
  const int total = S * max_units;
  int cnt = 0;
  for (int e = tid; e < total; e += kThreads)
    cnt += cross_key(sh, e / max_units, e % max_units) < kInfBits;
  cnt = block_sum(cnt, sh);
  const int take = min(min(max(free_units, 0), max_units), cnt);

  // bit-descend: the largest theta with count(key < theta) < take is the
  // take-th smallest crossing
  uint32_t theta = 0;
  for (int b = 0; b < 32; ++b) {
    const uint32_t cand = theta | (1u << (31 - b));
    int c = 0;
    for (int e = tid; e < total; e += kThreads)
      c += cross_key(sh, e / max_units, e % max_units) < cand;
    c = block_sum(c, sh);
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
  __syncthreads();
  for (int s = tid; s < S; s += kThreads) {
    const uint32_t a = sh.alloc[s];
    sh.availr[s] = (int)(grant[s] - consumed[s]) + (int)a;
    const float w = sh.weight[s];
    const float dv =
        a > 0 ? (w > 0.0f ? __fdiv_rn((float)a, w) : INFINITY) : 0.0f;
    vpass_out[s] = __fadd_rn(sh.vpass[s], dv);
    // poke window [grant, grant + alloc + dead slack), clamped to the
    // issued-ticket frontier
    const uint32_t dead0 = dead[s] + sh.deadb[s];
    const int outstanding = max((int)(ticket[s] - grant[s]), 0);
    sh.width[s] = (uint32_t)min((int)(a + dead0), outstanding);
    const uint32_t tsalt = salt + (uint32_t)(s + 1) * kMix32KA;
    sh.start[s] = tsalt + grant[s] * kStride;
  }
  __syncthreads();
  // waiting-array poke through the coprime-stride inverse: no scatter
  for (int j = tid; j < table; j += kThreads) {
    uint32_t bump = 0;
    for (int s = 0; s < S; ++s) {
      const uint32_t off =
          (((uint32_t)j - sh.start[s]) * kStrideInv) & (uint32_t)(table - 1);
      bump += off < sh.width[s];
    }
    seq_out[j] = seq[j] + bump;
  }

  // (3) tombstone-transparent FCFS admit over the ticket-ordered rows
  for (int c0 = 0; c0 < n; c0 += kThreads) {
    const int i = c0 + tid;
    const bool valid = i < n;
    const int t = valid ? ids[i] : -1;
    bool live = false;
    if (valid) live = alive[i] != 0 && !(dl[i] <= now);
    for (int e = tid; e < kWarps * S; e += kThreads)
      sh.warp_cnt[e / S][e % S] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, t);
    const unsigned live_m = __ballot_sync(0xffffffffu, live);
    const int intra = __popc(peers & live_m & ((1u << lane) - 1u));
    if (valid && lane == __ffs(peers) - 1)
      sh.warp_cnt[warp][t] = __popc(peers & live_m);
    __syncthreads();
    if (valid) {
      int before = sh.base[t] + intra;
      for (int w = 0; w < warp; ++w) before += sh.warp_cnt[w][t];
      const bool admitted = live && before < sh.availr[t];
      adm_out[i] = admitted ? 1 : 0;
      if (admitted) atomicAdd(&sh.spent[t], 1u);
    }
    __syncthreads();
    for (int s = tid; s < S; s += kThreads) {
      int tot = 0;
      for (int w = 0; w < kWarps; ++w) tot += sh.warp_cnt[w][s];
      sh.base[s] += tot;
    }
    __syncthreads();
  }

  // (4) reclaim stranded credit, decay the dead slack, write the state
  for (int s = tid; s < S; s += kThreads) {
    const uint32_t sp = sh.spent[s];
    const int depth_after = sh.depth[s] - (int)sp;
    const int avail_after = sh.availr[s] - (int)sp;
    const uint32_t surplus = (uint32_t)max(avail_after - depth_after, 0);
    const uint32_t dead0 = dead[s] + sh.deadb[s];
    grant_out[s] = grant[s] + sh.alloc[s];
    consumed_out[s] = consumed[s] + sp + surplus;
    dead_out[s] = dead0 - min(dead0, surplus);
    atomicAdd(&sh.leftover, (int)surplus - (int)sh.alloc[s]);
  }
  __syncthreads();
  if (tid == 0) *leftover_out = sh.leftover;
}

}  // namespace

extern "C" int qos_round_launch(
    const void* ids, const void* alive, const void* dl, int n,
    const void* ticket, const void* grant, const void* consumed,
    const void* dead, const void* weight, const void* vpass, const void* seq,
    int table, const void* salt, const void* now, const void* free_units,
    int n_tenants, int max_units, void* adm_out, void* exp_out,
    void* grant_out, void* consumed_out, void* dead_out, void* vpass_out,
    void* seq_out, void* leftover_out, void* stream) {
  if (n_tenants < 1 || n_tenants > kMaxTenants || max_units < 1 ||
      table < 1 || (table & (table - 1)) != 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  qos_round_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ids, (const uint8_t*)alive, (const float*)dl, n,
      (const uint32_t*)ticket, (const uint32_t*)grant,
      (const uint32_t*)consumed, (const uint32_t*)dead, (const float*)weight,
      (const float*)vpass, (const uint32_t*)seq, table,
      (const uint32_t*)salt, (const float*)now, (const int*)free_units,
      n_tenants, max_units, (uint8_t*)adm_out, (uint8_t*)exp_out,
      (uint32_t*)grant_out, (uint32_t*)consumed_out, (uint32_t*)dead_out,
      (float*)vpass_out, (uint32_t*)seq_out, (int*)leftover_out);
  return (int)cudaGetLastError();
}
