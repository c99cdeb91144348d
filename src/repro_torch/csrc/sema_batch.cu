// Batched TWA semaphore pass (take + post + wake) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sema_batch.py:118 `sema_batch`
// (body `_sema_kernel`, :43): a vector of N take requests gets its tickets
// (base + exclusive rank of the requesting rows), its admitted mask
// ((int32)(grant - ticket) > 0), its TWAHash buckets ((salt + 17 t) &
// (T - 1)); the post of `post_n` units bumps the buckets of the enabled
// ticket range [grant, grant + post_n) in the waiting array; `woken`
// marks the requesting rows whose bucket moved.  Plain version:
// `kernels.ref.sema_batch_ref`; this kernel matches it bit for bit.
//
// What bounds it on this card: latency.  The work is O(N + T) integer
// operations on a few tens of KB, far below both the memory and the
// integer rates; the pass costs one launch and a few barriers per tile.
//
// What the design does about it:
//   * ONE block of 1024 threads loops over the rows in tiles of 1024 and
//     carries the running ticket base between tiles in a register, in
//     place of the TPU's sequential grid and its VMEM scratch counter.
//   * The exclusive rank is an integer count: a warp __ballot_sync of the
//     requesting lanes + __popc of the lanes below, plus the per-warp
//     totals of the earlier warps of the tile (shared memory).  The TPU's
//     strict-lower-triangular f32 MXU matmul is not used.
//   * The post needs no scatter and no atomics: stride 17 is odd, hence a
//     unit mod T, so bucket b is hit by exactly one offset of [0, T),
//     o(b) = (17^-1 (b - salt) - grant) mod T, and it is enabled iff
//     o(b) < post_n (offsets past T never exist: the reference enables
//     only arange(T)).  Each thread bumps its own buckets with a plain
//     store, and a row is woken iff its bucket's o(b) < post_n — the same
//     closed form, no barrier between the post and the wake.
//   * u32 state arrives as the caller's int64 carriers, read as their low
//     32 bits: every counter operation wraps mod 2^32 as the reference's
//     uint32.  The four scalars come by pointer (a device
//     tensor, read in the kernel) or by value (a Python int).  Every
//     output is written in the dtype the caller gets, into one buffer the
//     wrapper allocates once (u32 carriers as int64, buckets int32, masks
//     bool), so a call is one launch and no torch operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kStride = 17u;            // core/hashfn.py TICKET_STRIDE
constexpr uint32_t kStrideInv = 0xF0F0F0F1u;  // 17^-1 mod 2^32 (and mod T)

// Is bucket b bumped by the post of the range [grant, grant + post_n)?
__device__ __forceinline__ bool bumped(uint32_t b, uint32_t salt,
                                       uint32_t grant, uint32_t post_n,
                                       uint32_t tmask) {
  const uint32_t o = (kStrideInv * (b - salt) - grant) & tmask;
  return o < post_n;
}

// A scalar: the low 32 bits at p (an int64 device carrier), or v.
__device__ __forceinline__ uint32_t scalar(const uint32_t* p, uint32_t v) {
  return p != nullptr ? *p : v;
}

struct Args {
  const uint8_t* req;
  const long long* seq;  // T carriers
  const uint32_t* sp[4];  // ticket, grant, post_n, salt: pointer or null
  uint32_t sv[4];         // ... or their values
  int n, table;
  long long* ticket_out;  // ticket', grant', bucket_seq' (T), tickets (N)
  int* bucket_out;        // (N,)
  uint8_t* admitted_out;  // (N,)
  uint8_t* woken_out;     // (N,)
};

__global__ void __launch_bounds__(kThreads) sema_batch_kernel(const Args a) {
  __shared__ int warp_cnt[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = a.n, table = a.table;
  const uint32_t ticket0 = scalar(a.sp[0], a.sv[0]);
  const uint32_t grant = scalar(a.sp[1], a.sv[1]);
  const uint32_t post_n = scalar(a.sp[2], a.sv[2]);
  const uint32_t salt = scalar(a.sp[3], a.sv[3]);
  const uint32_t tmask = (uint32_t)table - 1u;
  long long* seq_out = a.ticket_out + 2;
  long long* tickets_out = seq_out + table;

  // post: the waiting array's enabled buckets move by one
  for (int b = tid; b < table; b += kThreads)
    seq_out[b] = (long long)((uint32_t)a.seq[b] +
                             (bumped((uint32_t)b, salt, grant, post_n, tmask)
                                  ? 1u : 0u));

  // take: tickets in row order, tile by tile, the base carried
  uint32_t base = 0;  // requests before this tile
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int r = t0 + tid;
    const bool rq = r < n && a.req[r] != 0;
    const unsigned ball = __ballot_sync(0xffffffffu, rq);
    const int below = __popc(ball & ((1u << lane) - 1u));
    if (lane == 0) warp_cnt[warp] = __popc(ball);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cnt[w];
      if (w < warp) before += c;
      total += c;
    }
    __syncthreads();  // warp_cnt is rewritten by the next tile
    if (r < n) {
      const uint32_t t = ticket0 + base + (uint32_t)(before + below);
      const uint32_t b = (salt + t * kStride) & tmask;
      tickets_out[r] = (long long)t;
      a.admitted_out[r] = (rq && (int32_t)(grant - t) > 0) ? 1 : 0;
      a.bucket_out[r] = (int)b;
      a.woken_out[r] = (rq && bumped(b, salt, grant, post_n, tmask)) ? 1 : 0;
    }
    base += (uint32_t)total;
  }
  if (tid == 0) {
    a.ticket_out[0] = (long long)(uint32_t)(ticket0 + base);
    a.ticket_out[1] = (long long)(uint32_t)(grant + post_n);
  }
}

}  // namespace

// req: n bools; seq: table int64 u32 carriers; ticket, grant, post_n, salt:
// each an int64 device carrier, or null and then given by value (*_v);
// out: 8 (2 + table + n) bytes of int64 (ticket', grant', bucket_seq',
// tickets), 4 n of int32 buckets, then n bools admitted and n bools woken.
extern "C" int sema_batch_launch(const void* req, int n, const void* seq,
                                 int table, const void* ticket,
                                 const void* grant, const void* post_n,
                                 const void* salt, unsigned ticket_v,
                                 unsigned grant_v, unsigned post_n_v,
                                 unsigned salt_v, void* out, void* stream) {
  if (n < 0 || table < 1 || (table & (table - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.req = (const uint8_t*)req;
  a.seq = (const long long*)seq;
  a.sp[0] = (const uint32_t*)ticket;
  a.sp[1] = (const uint32_t*)grant;
  a.sp[2] = (const uint32_t*)post_n;
  a.sp[3] = (const uint32_t*)salt;
  a.sv[0] = ticket_v;
  a.sv[1] = grant_v;
  a.sv[2] = post_n_v;
  a.sv[3] = salt_v;
  a.n = n;
  a.table = table;
  a.ticket_out = (long long*)out;
  a.bucket_out = (int*)(a.ticket_out + 2 + table + n);
  a.admitted_out = (uint8_t*)(a.bucket_out + n);
  a.woken_out = a.admitted_out + n;
  sema_batch_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
