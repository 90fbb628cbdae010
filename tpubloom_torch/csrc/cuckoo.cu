// Cuckoo filter kernels for Hopper (sm_90a): the order-dependent insert and
// delete walks, and the two-bucket query.
//
// Layout and spec (tpubloom/ops/cuckoo.py; the plain versions are
// tpubloom_torch/ops/cuckoo.py): the state is u32[n_buckets][4], one 16-bit
// fingerprint a slot, 0 an empty slot, n_buckets a power of two. A key's
//   fp = (h_a % 0xFFFF) + 1,  i1 = h_b & (n_buckets - 1),
//   i2 = (i1 ^ fp * 0x5BD1E995) & (n_buckets - 1)   (u32 wrap)
// from bloom_hash.cuh's murmur3_32 with the base hashes' seeds (h_a: seed,
// h_b: seed ^ 0x9E3779B9). Keys are u8[B, L] (L a multiple of 4, zero past
// each key's length), lengths i32[B], a negative length marking a padding
// entry, which changes nothing and answers False with 0 kicks.
//
// cuckoo_insert replaces the lax.scan of tpubloom/ops/cuckoo.py:101
// (cuckoo_insert), cuckoo_delete the scan at :184 (cuckoo_delete), and
// cuckoo_query the vectorised query at :172. The results are bit-identical:
// the same slots after an insert or a delete, the same ok / kicks / deleted
// flags and verdicts.
//
// Design. Each key sees the table that the keys before it left, and a kick
// chain moves fingerprints through buckets that no other key's position
// predicts, so an insert or a delete is a walk over the batch in order:
//   launch 1, one thread a key: hash each key into (fp, i1), fp = 0 for
//     padding, into scratch the wrapper allocates (u32[2 B]);
//   launch 2, ONE warp: lane 0 walks the batch in order, 32 keys a step. A
//     bucket is one 16-byte row, read as one uint4 from L2 (__ldcg; every
//     write is an __stcg, so the thread reads its own writes in L2). A key
//     reads i1's and i2's rows together (two loads in flight), takes the
//     first empty slot of i1, then of i2; else runs the kick chain: at step
//     t the carried fingerprint f takes slot (f + t) % 4 of its bucket, and
//     the victim tries the first empty slot of its own alternate bucket (one
//     dependent row read a step), at most MAX_KICKS = 32 steps, each step's
//     (bucket, slot, victim) kept in registers. A chain that ends without a
//     place (FULL) wrote only its swaps, so writing each victim back from
//     the last step to the first leaves the table exactly as it was; kicks
//     is the steps taken (32 for a FULL key). A delete zeroes the first
//     slot of i1, then of i2, that holds fp.
//   The other 31 lanes read the next 32 keys' (fp, i1) while lane 0 walks
//   and prefetch their two rows into L2 (prefetch.global.L2), so the
//   walk's first reads of a key hit L2 instead of device memory. The kick
//   chain's reads cannot be prefetched: each bucket follows from the victim
//   the read before it found.
//
// Bound. Bytes: each key's L + 4 input bytes, 8 bytes of (fp, i1) written
// and read back, its outputs (5 bytes insert, 1 delete), and the 32-byte
// sectors of its two rows read and one written; at the sizes chip_smoke.py
// runs that is well under a millisecond a 2^16-key batch at 3.35 TB/s. The
// real limit is latency: one thread walks the batch, and every key needs
// at least one row read (two in flight) that depends on nothing earlier but
// must come after the previous key's writes; a kick step adds one read that
// depends on the one before it. With the prefetch a key's first read is an
// L2 hit (~0.2-0.3 us on an H100 at its boost clock, measured in PERF.md);
// a kick step that misses L2 is a device-memory read, on the order of
// 1 us. A parallel, order-preserving placement is the redesign this leaves
// open (ROADMAP.md).
//
// cuckoo_query: one thread a key, the same hash, the two rows as two uint4
// loads, 4-lane compares; reads never race, so no order is needed.
//
// Built by tpubloom_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes. Each entry launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"

namespace tpubloom {

constexpr int kCuckooThreads = 256;
constexpr int kCuckooBucket = 4;
constexpr int kCuckooMaxKicks = 32;
constexpr uint32_t kCuckooAltMix = 0x5BD1E995u;

__device__ __forceinline__ uint32_t cuckoo_alt(uint32_t bucket, uint32_t fp, uint32_t mask) {
  return (bucket ^ (fp * kCuckooAltMix)) & mask;
}

__device__ __forceinline__ uint32_t slot_of(const uint4& r, int s) {
  return s == 0 ? r.x : (s == 1 ? r.y : (s == 2 ? r.z : r.w));
}

// The first slot of row r holding v, or -1.
__device__ __forceinline__ int first_slot(const uint4& r, uint32_t v) {
  return r.x == v ? 0 : (r.y == v ? 1 : (r.z == v ? 2 : (r.w == v ? 3 : -1)));
}

// (fp, i1) of key i, fp = 0 for padding.
__device__ __forceinline__ uint2 cuckoo_hash(const uint8_t* __restrict__ keys,
                                             const int32_t* __restrict__ lengths,
                                             int64_t i, int L, uint32_t mask,
                                             uint32_t seed) {
  const int len = lengths[i];
  if (len < 0) return make_uint2(0u, 0u);
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(keys + i * L);
  uint32_t ha, hb;
  if (L == 16) {
    const uint32_t r[4] = {kw[0], kw[1], kw[2], kw[3]};
    ha = murmur3_32_regs(r, len, seed);
    hb = murmur3_32_regs(r, len, seed ^ kSeedXorHB);
  } else {
    ha = murmur3_32(kw, L / 4, len, seed);
    hb = murmur3_32(kw, L / 4, len, seed ^ kSeedXorHB);
  }
  return make_uint2(ha % 0xFFFFu + 1u, hb & mask);
}

__global__ void __launch_bounds__(kCuckooThreads)
cuckoo_hash_kernel(const uint8_t* __restrict__ keys, const int32_t* __restrict__ lengths,
                   uint2* __restrict__ fi, int64_t B, int L, uint32_t mask,
                   uint32_t seed) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) fi[i] = cuckoo_hash(keys, lengths, i, L, mask, seed);
}

__device__ __forceinline__ uint4 load_row(const uint32_t* state, uint32_t b) {
  return __ldcg(reinterpret_cast<const uint4*>(state) + b);
}

__device__ __forceinline__ void store_slot(uint32_t* state, uint32_t b, int s, uint32_t v) {
  __stcg(state + (size_t)b * kCuckooBucket + s, v);
}

__device__ __forceinline__ void prefetch_row(const uint32_t* state, uint32_t b) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(state + (size_t)b * kCuckooBucket));
}

// One key's insert; returns its kicks, and in `ok` whether it was placed.
__device__ __forceinline__ int insert_one(uint32_t* state, uint32_t f, uint32_t b1,
                                          uint32_t mask, bool& ok) {
  const uint32_t b2 = cuckoo_alt(b1, f, mask);
  const uint4 r1 = load_row(state, b1);
  uint4 row = load_row(state, b2);  // read before any write: still current if b1 is full
  int e = first_slot(r1, 0u);
  if (e >= 0) {
    store_slot(state, b1, e, f);
    ok = true;
    return 0;
  }
  e = first_slot(row, 0u);
  if (e >= 0) {
    store_slot(state, b2, e, f);
    ok = true;
    return 0;
  }
  uint32_t path_b[kCuckooMaxKicks], path_v[kCuckooMaxKicks];
  int path_s[kCuckooMaxKicks];
  uint32_t b = b2;
  int t = 0;
  for (; t < kCuckooMaxKicks; ++t) {
    const int s = (int)((f + (uint32_t)t) & 3u);
    const uint32_t victim = slot_of(row, s);
    store_slot(state, b, s, f);
    path_b[t] = b;
    path_s[t] = s;
    path_v[t] = victim;
    const uint32_t nb = cuckoo_alt(b, victim, mask);
    row = load_row(state, nb);  // after the swap: sees it when nb == b
    e = first_slot(row, 0u);
    if (e >= 0) {
      store_slot(state, nb, e, victim);
      ok = true;
      return t + 1;
    }
    f = victim;
    b = nb;
  }
  // FULL: only the swaps were written; undo them from the last step back
  for (t = kCuckooMaxKicks - 1; t >= 0; --t) store_slot(state, path_b[t], path_s[t], path_v[t]);
  ok = false;
  return kCuckooMaxKicks;
}

// One key's delete: whether a copy of f was removed.
__device__ __forceinline__ bool delete_one(uint32_t* state, uint32_t f, uint32_t b1,
                                           uint32_t mask) {
  const uint32_t b2 = cuckoo_alt(b1, f, mask);
  const uint4 r1 = load_row(state, b1);
  const uint4 r2 = load_row(state, b2);  // unchanged unless r1 matched
  int e = first_slot(r1, f);
  if (e >= 0) {
    store_slot(state, b1, e, 0u);
    return true;
  }
  e = first_slot(r2, f);
  if (e >= 0) {
    store_slot(state, b2, e, 0u);
    return true;
  }
  return false;
}

// One key's insert or delete: its kicks (0 for a delete), and in `ok`
// whether it was placed or removed. fp = 0 marks padding.
template <bool kInsert>
__device__ __forceinline__ int walk_key(uint32_t* state, uint2 k, uint32_t mask, bool& ok) {
  ok = false;
  if (!k.x) return 0;
  if constexpr (kInsert) return insert_one(state, k.x, k.y, mask, ok);
  ok = delete_one(state, k.x, k.y, mask);
  return 0;
}

// Launch 2: one warp; lane 0 walks the batch in order, 32 keys a step, the
// other lanes fetch the next step's keys and prefetch their rows.
template <bool kInsert>
__global__ void __launch_bounds__(32)
cuckoo_walk_kernel(uint32_t* __restrict__ state, const uint2* __restrict__ fi,
                   uint8_t* __restrict__ flag, int32_t* __restrict__ kicks, int64_t B,
                   uint32_t mask) {
  __shared__ uint2 step_fi[32];
  __shared__ uint8_t step_flag[32];
  __shared__ int32_t step_kicks[32];
  const int lane = threadIdx.x;
  uint2 next = lane < B ? fi[lane] : make_uint2(0u, 0u);
  for (int64_t c0 = 0; c0 < B; c0 += 32) {
    step_fi[lane] = next;
    const int64_t jn = c0 + 32 + lane;
    next = jn < B ? fi[jn] : make_uint2(0u, 0u);
    if (next.x) {
      prefetch_row(state, next.y);
      prefetch_row(state, cuckoo_alt(next.y, next.x, mask));
    }
    __syncwarp();
    if (lane == 0) {
      const int n = B - c0 < 32 ? (int)(B - c0) : 32;
      for (int j = 0; j < n; ++j) {
        bool ok;
        step_kicks[j] = walk_key<kInsert>(state, step_fi[j], mask, ok);
        step_flag[j] = ok ? 1 : 0;
      }
    }
    __syncwarp();
    if (c0 + lane < B) {
      flag[c0 + lane] = step_flag[lane];
      if constexpr (kInsert) kicks[c0 + lane] = step_kicks[lane];
    }
    __syncwarp();
  }
}

// Launch 2 without the prefetch lanes: one thread walks the batch and
// writes each key's flags itself (timed against the warp above by
// chip_smoke.py).
template <bool kInsert>
__global__ void __launch_bounds__(1)
cuckoo_walk_thread_kernel(uint32_t* __restrict__ state, const uint2* __restrict__ fi,
                          uint8_t* __restrict__ flag, int32_t* __restrict__ kicks, int64_t B,
                          uint32_t mask) {
  for (int64_t j = 0; j < B; ++j) {
    bool ok;
    const int nk = walk_key<kInsert>(state, fi[j], mask, ok);
    flag[j] = ok ? 1 : 0;
    if constexpr (kInsert) kicks[j] = nk;
  }
}

// The latency of one dependent row read, as the walk's kick chain meets
// it: one thread follows `steps` links, each the .x word of a 16-byte row
// read with __ldcg, starting at row `start`; the last row index goes to
// *out so that the chain is not dropped.
__global__ void __launch_bounds__(1)
cuckoo_chase_kernel(const uint4* __restrict__ rows, uint32_t start, int64_t steps,
                    uint32_t* __restrict__ out) {
  uint32_t i = start;
  for (int64_t s = 0; s < steps; ++s) i = __ldcg(rows + i).x;
  *out = i;
}

__global__ void __launch_bounds__(kCuckooThreads)
cuckoo_query_kernel(const uint32_t* __restrict__ state, const uint8_t* __restrict__ keys,
                    const int32_t* __restrict__ lengths, uint8_t* __restrict__ out,
                    int64_t B, int L, uint32_t mask, uint32_t seed) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint2 k = cuckoo_hash(keys, lengths, i, L, mask, seed);
  if (!k.x) {
    out[i] = 0;
    return;
  }
  const uint4* rows = reinterpret_cast<const uint4*>(state);
  const uint4 r1 = __ldg(rows + k.y);
  const uint4 r2 = __ldg(rows + cuckoo_alt(k.y, k.x, mask));
  out[i] = (first_slot(r1, k.x) >= 0 || first_slot(r2, k.x) >= 0) ? 1 : 0;
}

inline unsigned cuckoo_grid(int64_t B) {
  return (unsigned)((B + kCuckooThreads - 1) / kCuckooThreads);
}

template <bool kInsert>
int launch_cuckoo_walk(void* state, const void* keys, const void* lengths, void* fi,
                       void* flag, void* kicks, int64_t B, int L, int64_t n_buckets,
                       uint32_t seed, bool prefetch, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (n_buckets <= 0 || (n_buckets & (n_buckets - 1)) || n_buckets > (1ll << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const uint32_t mask = (uint32_t)(n_buckets - 1);
  uint2* fi2 = static_cast<uint2*>(fi);
  cuckoo_hash_kernel<<<cuckoo_grid(B), kCuckooThreads, 0, cs>>>(
      static_cast<const uint8_t*>(keys), static_cast<const int32_t*>(lengths), fi2, B, L,
      mask, seed);
  if (prefetch)
    cuckoo_walk_kernel<kInsert><<<1, 32, 0, cs>>>(
        static_cast<uint32_t*>(state), fi2, static_cast<uint8_t*>(flag),
        static_cast<int32_t*>(kicks), B, mask);
  else
    cuckoo_walk_thread_kernel<kInsert><<<1, 1, 0, cs>>>(
        static_cast<uint32_t*>(state), fi2, static_cast<uint8_t*>(flag),
        static_cast<int32_t*>(kicks), B, mask);
  return (int)cudaGetLastError();
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t. `state` is u32[n_buckets * 4], 16-byte aligned; `fi` is
// scratch of 8 B bytes, 8-byte aligned. Each returns cudaGetLastError()
// after its launches (cudaErrorInvalidValue for a bucket count that is not
// a power of two up to 2^32).
// ---------------------------------------------------------------------------

extern "C" int tpb_cuckoo_insert(void* state, const void* keys, const void* lengths, void* fi,
                                 void* ok, void* kicks, int64_t B, int L, int64_t n_buckets,
                                 uint32_t seed, void* stream) {
  return tpubloom::launch_cuckoo_walk<true>(state, keys, lengths, fi, ok, kicks, B, L,
                                            n_buckets, seed, true, stream);
}

extern "C" int tpb_cuckoo_delete(void* state, const void* keys, const void* lengths, void* fi,
                                 void* deleted, int64_t B, int L, int64_t n_buckets,
                                 uint32_t seed, void* stream) {
  return tpubloom::launch_cuckoo_walk<false>(state, keys, lengths, fi, deleted, nullptr, B, L,
                                             n_buckets, seed, true, stream);
}

// The insert (insert != 0) or delete walk on either launch 2: the warp with
// its prefetch lanes (prefetch != 0) or the lone thread. For timing.
extern "C" int tpb_cuckoo_walk_variant(void* state, const void* keys, const void* lengths,
                                       void* fi, void* flag, void* kicks, int64_t B, int L,
                                       int64_t n_buckets, uint32_t seed, int insert,
                                       int prefetch, void* stream) {
  return insert ? tpubloom::launch_cuckoo_walk<true>(state, keys, lengths, fi, flag, kicks, B,
                                                     L, n_buckets, seed, prefetch != 0, stream)
                : tpubloom::launch_cuckoo_walk<false>(state, keys, lengths, fi, flag, nullptr, B,
                                                      L, n_buckets, seed, prefetch != 0, stream);
}

// `steps` dependent row reads over `rows` (u32[n_rows * 4], each row's
// first word the next row's index) from row `start`; the last index to
// `out` (u32[1]). For timing.
extern "C" int tpb_cuckoo_chase(const void* rows, uint32_t start, int64_t steps, void* out,
                                void* stream) {
  using namespace tpubloom;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cuckoo_chase_kernel<<<1, 1, 0, cs>>>(static_cast<const uint4*>(rows), start, steps,
                                       static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

extern "C" int tpb_cuckoo_query(const void* state, const void* keys, const void* lengths,
                                void* out, int64_t B, int L, int64_t n_buckets, uint32_t seed,
                                void* stream) {
  using namespace tpubloom;
  if (B <= 0) return (int)cudaSuccess;
  if (n_buckets <= 0 || (n_buckets & (n_buckets - 1)) || n_buckets > (1ll << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cuckoo_query_kernel<<<cuckoo_grid(B), kCuckooThreads, 0, cs>>>(
      static_cast<const uint32_t*>(state), static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(lengths), static_cast<uint8_t*>(out), B, L,
      (uint32_t)(n_buckets - 1), seed);
  return (int)cudaGetLastError();
}
