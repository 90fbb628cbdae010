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
// predicts. But a key's walk depends only on the rows it reads, and a FULL
// key writes nothing net (its chain unwinds), so a window of keys can walk
// at once against the table as it stands and be checked in batch order:
//   launch 1, one thread a key: hash each key into (fp, i1), fp = 0 for
//     padding, into scratch the wrapper allocates (u32[2 B]);
//   launch 2, ONE persistent CTA of W threads (cuckoo_rounds_kernel), a
//     key a thread, in rounds from p = 0 until the batch is done:
//     1. speculate: thread t walks key p + t as the sequential walk does,
//        but writes nothing: each swap and placement goes to a private log
//        of (bucket, slot, value), at most MAX_KICKS + 1 entries, and each
//        row it loads is patched with its own earlier entries for that
//        bucket (a chain that comes back to a bucket sees its own swap; a
//        64-bit signature of the logged buckets skips the patch loop for
//        the rows that cannot need it).
//        It records the buckets its outcome depends on: b1; b2 when b1 had
//        no empty slot (insert) or no match (delete); each chain bucket, at
//        most MAX_KICKS + 2. A FULL key's net write set is empty, a
//        delete's at most one slot, every other key's its log's buckets,
//        all of which it read;
//     2. claim: atomicMin(owner[b], t) for each bucket b of the write set
//        (owner: u32[n_buckets] scratch, all ones between rounds);
//     3. validate: key t is invalid if a bucket it read has owner[b] < t;
//        f is the least invalid t (a shared atomicMin), else the window;
//     4. commit: threads t < f store their logs (__stcg: their write sets
//        are pairwise disjoint, since each lies in its own read set and a
//        valid key's read set misses every earlier key's write set) and
//        their flags; every thread resets the owners it claimed; p += f.
//     Key p + f heads the next round, where nothing precedes it, so each
//     round commits at least one key. A committed key read only rows that
//     no earlier key of its round changed, on a table that holds every
//     earlier round: it did exactly what the sequential walk does, so the
//     result is bit-identical by construction.
//   A bucket is one 16-byte row, read as one uint4 from L2 (__ldcg; the
//   commits are __stcg, and a __syncthreads orders them before the next
//   round's reads). The optional stats out-pointer gets (rounds, keys
//   walked and not committed).
//   The ordered walk, kept for the A/B (tpb_cuckoo_walk_variant): ONE warp
//   whose lane 0 walks the batch in order, 32 keys a step, the swaps
//   written in place and a FULL chain undone from registers, while the
//   other 31 lanes read the next 32 keys' (fp, i1) and prefetch their two
//   rows into L2 (prefetch.global.L2); and the same walk on one thread
//   alone.
//
// Bound. Bytes: each key's L + 4 input bytes, its outputs (5 bytes insert,
// 1 delete), and the 32-byte sectors of the rows the batch reads and
// changes, once; at the sizes chip_smoke.py runs that is ~0.01 ms a
// 2^16-key batch at 3.35 TB/s. The real limit is latency: a round costs
// its window's longest chain, up to MAX_KICKS + 2 dependent row reads, and
// the rounds are about B / f, where f, the keys committed a round, falls
// as the keys' read and write sets grow (at load 0.95 a key reads ~16
// buckets and writes ~6.5; at a quarter load one of each). W = 512
// (kCuckooWindow) was chosen by timing 128 to 1024 on an H100 (PERF.md):
// a wider window commits more keys a round where conflicts are rare, but
// its longer rounds and its threads' local-memory logs cost more at load
// 0.95.
//
// cuckoo_query: a thread a key; reads never race, so no order is needed.
// Bound: bytes, each key's L + 4 input bytes, its verdict and its two
// 32-byte bucket sectors, ~0.0017 ms a 2^16-key batch at 3.35 TB/s, below
// any launch. So its time is the launch and its chain of dependent reads:
// the length and the key's words come in one trip (16-byte streaming
// loads for a 16- or 32-byte key), then, after the hash, both bucket rows
// as two uint4 __ldcg loads in flight together: two device-memory round
// trips where the walks' shared hash (length, then words, then rows) makes
// three. CTAs of kQueryThreads = 128 threads spread a 2^16 batch over 512
// CTAs, all resident at once on the 132 SMs.
//
// Built by tpubloom_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes. Each entry launches on the caller's stream,
// does not synchronise, allocates nothing (the wrapper passes the scratch;
// the round walk's owner array is set here by cudaMemsetAsync), and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"

namespace tpubloom {

constexpr int kCuckooThreads = 256;
constexpr int kQueryThreads = 128;  // a 2^16-key query: 512 CTAs, 3-4 on each of 132 SMs
constexpr int kCuckooBucket = 4;
constexpr int kCuckooMaxKicks = 32;
constexpr uint32_t kCuckooAltMix = 0x5BD1E995u;
constexpr int kCuckooMaxWindow = 1024;  // threads of the round walk's CTA, at most
constexpr int kCuckooWindow = 512;      // the round walk's window on the main path

// The second launches: the round walk, the warp walk, one thread.
enum CuckooWalk { kWalkRounds = 0, kWalkWarp = 1, kWalkThread = 2 };

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

// One bit of 64 for bucket b: a signature of the buckets a log holds.
__device__ __forceinline__ uint64_t bucket_bit(uint32_t b) {
  return 1ull << ((b * 0x9E3779B9u) >> 26);
}

// One key's speculative walk: its read set and its net writes in walk
// order (in local memory), and the signature of the logged buckets, so
// that a row whose bucket is not in the log skips the patch loop. A
// delete reads at most two buckets and writes at most one slot.
template <bool kInsert>
struct SpecWalk {
  static constexpr int kReads = kInsert ? kCuckooMaxKicks + 2 : 2;
  static constexpr int kLog = kInsert ? kCuckooMaxKicks + 1 : 1;
  int n_reads, n_log;
  uint64_t logged;
  uint32_t read_b[kReads];
  uint32_t log_b[kLog], log_v[kLog];
  int log_s[kLog];

  __device__ __forceinline__ void log(uint32_t b, int s, uint32_t v) {
    log_b[n_log] = b;
    log_s[n_log] = s;
    log_v[n_log] = v;
    logged |= bucket_bit(b);
    ++n_log;
  }
};

__device__ __forceinline__ void set_slot(uint4& r, int s, uint32_t v) {
  if (s == 0) r.x = v;
  else if (s == 1) r.y = v;
  else if (s == 2) r.z = v;
  else r.w = v;
}

// Row b of the table as the walk `w` has left it: the stored row patched
// with w's own log entries for b, in order. A row the signature rules out
// needs no patch; otherwise the log's buckets are compared with their
// loads unrolled (a mask of the matching entries), then the rare matches
// applied.
template <bool kInsert>
__device__ __forceinline__ uint4 spec_row(const uint32_t* state, uint32_t b,
                                          const SpecWalk<kInsert>& w) {
  uint4 r = load_row(state, b);
  if (w.logged & bucket_bit(b)) {
    uint64_t hit = 0;
#pragma unroll 8
    for (int j = 0; j < w.n_log; ++j) hit |= (uint64_t)(w.log_b[j] == b) << j;
    while (hit) {
      const int j = __ffsll((long long)hit) - 1;
      hit &= hit - 1;
      set_slot(r, w.log_s[j], w.log_v[j]);
    }
  }
  return r;
}

// Step 1 of a round: key k's insert or delete walked without writing to
// the table (insert_one / delete_one with the writes logged); returns its
// kicks, and in `ok` whether it was placed or removed. fp = 0 marks
// padding, which reads and writes nothing.
template <bool kInsert>
__device__ __forceinline__ int speculate(const uint32_t* state, uint2 k, uint32_t mask,
                                         SpecWalk<kInsert>& w, bool& ok) {
  w.n_reads = w.n_log = 0;
  w.logged = 0;
  ok = false;
  if (!k.x) return 0;
  uint32_t f = k.x;
  const uint32_t want = kInsert ? 0u : f;
  const uint32_t put = kInsert ? f : 0u;
  const uint32_t b2 = cuckoo_alt(k.y, f, mask);
  const uint4 r1 = load_row(state, k.y);
  uint4 row = load_row(state, b2);  // both in flight; nothing logged yet
  w.read_b[w.n_reads++] = k.y;
  int e = first_slot(r1, want);
  if (e >= 0) {
    w.log(k.y, e, put);
    ok = true;
    return 0;
  }
  w.read_b[w.n_reads++] = b2;
  e = first_slot(row, want);
  if (e >= 0) {
    w.log(b2, e, put);
    ok = true;
    return 0;
  }
  if constexpr (!kInsert) {
    return 0;
  } else {
    uint32_t b = b2;
    for (int t = 0; t < kCuckooMaxKicks; ++t) {
      const int s = (int)((f + (uint32_t)t) & 3u);
      const uint32_t victim = slot_of(row, s);
      w.log(b, s, f);
      const uint32_t nb = cuckoo_alt(b, victim, mask);
      w.read_b[w.n_reads++] = nb;
      row = spec_row(state, nb, w);  // after the swap: sees it when nb == b
      e = first_slot(row, 0u);
      if (e >= 0) {
        w.log(nb, e, victim);
        ok = true;
        return t + 1;
      }
      f = victim;
      b = nb;
    }
    w.n_log = 0;  // FULL: the swaps unwind, nothing is written
    return kCuckooMaxKicks;
  }
}

// Launch 2: one CTA of W = blockDim.x threads walks the batch in rounds of
// a window (speculate, claim, validate, commit the valid prefix); see the
// design note at the top. `owner` is all ones on entry and on exit.
template <bool kInsert>
__global__ void __launch_bounds__(kCuckooMaxWindow)
cuckoo_rounds_kernel(uint32_t* __restrict__ state, const uint2* __restrict__ fi,
                     uint32_t* __restrict__ owner, uint8_t* __restrict__ flag,
                     int32_t* __restrict__ kicks, int32_t* __restrict__ stats, int64_t B,
                     uint32_t mask) {
  __shared__ int first_bad;
  const int t = threadIdx.x;
  const int W = blockDim.x;
  if (t == 0) first_bad = W;
  __syncthreads();
  int64_t p = 0, rounds = 0, rewalked = 0;
  while (p < B) {
    const int n = B - p < W ? (int)(B - p) : W;
    SpecWalk<kInsert> w;
    bool ok = false;
    int nk = 0;
    if (t < n) {
      nk = speculate<kInsert>(state, fi[p + t], mask, w, ok);
    } else {
      w.n_reads = w.n_log = 0;
    }
    for (int j = 0; j < w.n_log; ++j) atomicMin(owner + w.log_b[j], (uint32_t)t);
    __syncthreads();
    bool bad = false;
    if constexpr (kInsert) {
      // up to MAX_KICKS + 2 independent owner loads: no early exit, so they overlap
#pragma unroll 4
      for (int j = 0; j < w.n_reads; ++j) bad |= __ldcg(owner + w.read_b[j]) < (uint32_t)t;
    } else {
      for (int j = 0; j < w.n_reads && !bad; ++j) bad = __ldcg(owner + w.read_b[j]) < (uint32_t)t;
    }
    if (bad) atomicMin(&first_bad, t);
    __syncthreads();
    const int f = first_bad < n ? first_bad : n;
    if (t < f) {
      for (int j = 0; j < w.n_log; ++j) store_slot(state, w.log_b[j], w.log_s[j], w.log_v[j]);
      flag[p + t] = ok ? 1 : 0;
      if constexpr (kInsert) kicks[p + t] = nk;
    }
    for (int j = 0; j < w.n_log; ++j) __stcg(owner + w.log_b[j], 0xFFFFFFFFu);
    __syncthreads();  // commits and resets land before the next round reads
    if (t == 0) first_bad = W;
    p += f;
    ++rounds;
    rewalked += n - f;
  }
  if (stats != nullptr && t == 0) {
    stats[0] = (int32_t)rounds;
    stats[1] = (int32_t)rewalked;
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

// The query's own front end (cuckoo_hash, which the walks' hash launch
// shares, loads the length first and the words after its branch): the
// length and the key's words in one trip, the two hashes from registers
// (NW > 0: a key of up to NW words; NW = 0: a longer one, hashed from
// memory), then both rows in flight at once, 8 compares, one byte.
template <int NW>
__global__ void __launch_bounds__(kQueryThreads)
cuckoo_query_kernel(const uint32_t* __restrict__ state, const uint8_t* __restrict__ keys,
                    const int32_t* __restrict__ lengths, uint8_t* __restrict__ out,
                    int64_t B, int L, int vec, uint32_t mask, uint32_t seed) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int len = __ldcs(lengths + i);
  uint32_t r[NW > 0 ? NW : 1];
  if constexpr (NW > 0) load_key_words<NW>(keys, i, L, vec, r);
  if (len < 0) {
    out[i] = 0;
    return;
  }
  uint32_t ha, hb;
  if constexpr (NW > 0) {
    ha = murmur3_32_regs(r, len, seed, L / 4);
    hb = murmur3_32_regs(r, len, seed ^ kSeedXorHB, L / 4);
  } else {
    const uint32_t* kw = reinterpret_cast<const uint32_t*>(keys + i * L);
    ha = murmur3_32(kw, L / 4, len, seed);
    hb = murmur3_32(kw, L / 4, len, seed ^ kSeedXorHB);
  }
  const uint32_t fp = ha % 0xFFFFu + 1u, b1 = hb & mask;
  const uint4* rows = reinterpret_cast<const uint4*>(state);
  const uint4 r1 = __ldcg(rows + b1), r2 = __ldcg(rows + cuckoo_alt(b1, fp, mask));
  out[i] = (r1.x == fp) | (r1.y == fp) | (r1.z == fp) | (r1.w == fp) | (r2.x == fp) |
           (r2.y == fp) | (r2.z == fp) | (r2.w == fp);
}

template <int NW>
int launch_cuckoo_query(const void* state, const void* keys, const void* lengths, void* out,
                        int64_t B, int L, uint32_t mask, uint32_t seed, cudaStream_t cs) {
  const int vec = L % 16 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  cuckoo_query_kernel<NW><<<(unsigned)((B + kQueryThreads - 1) / kQueryThreads), kQueryThreads,
                            0, cs>>>(
      static_cast<const uint32_t*>(state), static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(lengths), static_cast<uint8_t*>(out), B, L, vec, mask, seed);
  return (int)cudaGetLastError();
}

inline unsigned cuckoo_grid(int64_t B) {
  return (unsigned)((B + kCuckooThreads - 1) / kCuckooThreads);
}

template <bool kInsert>
int launch_cuckoo_walk(void* state, const void* keys, const void* lengths, void* fi, void* owner,
                       void* flag, void* kicks, void* stats, int64_t B, int L, int64_t n_buckets,
                       uint32_t seed, int variant, int window, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (n_buckets <= 0 || (n_buckets & (n_buckets - 1)) || n_buckets > (1ll << 32) ||
      variant < kWalkRounds || variant > kWalkThread || window < 1 || window > kCuckooMaxWindow)
    return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const uint32_t mask = (uint32_t)(n_buckets - 1);
  uint2* fi2 = static_cast<uint2*>(fi);
  uint32_t* st = static_cast<uint32_t*>(state);
  uint8_t* fl = static_cast<uint8_t*>(flag);
  int32_t* kk = static_cast<int32_t*>(kicks);
  cuckoo_hash_kernel<<<cuckoo_grid(B), kCuckooThreads, 0, cs>>>(
      static_cast<const uint8_t*>(keys), static_cast<const int32_t*>(lengths), fi2, B, L,
      mask, seed);
  if (variant == kWalkRounds) {
    const cudaError_t err = cudaMemsetAsync(owner, 0xFF, (size_t)n_buckets * 4, cs);
    if (err != cudaSuccess) return (int)err;
    cuckoo_rounds_kernel<kInsert><<<1, window, 0, cs>>>(
        st, fi2, static_cast<uint32_t*>(owner), fl, kk, static_cast<int32_t*>(stats), B, mask);
  } else if (variant == kWalkWarp) {
    cuckoo_walk_kernel<kInsert><<<1, 32, 0, cs>>>(st, fi2, fl, kk, B, mask);
  } else {
    cuckoo_walk_thread_kernel<kInsert><<<1, 1, 0, cs>>>(st, fi2, fl, kk, B, mask);
  }
  return (int)cudaGetLastError();
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t. `state` is u32[n_buckets * 4], 16-byte aligned; `fi` is
// scratch of 8 B bytes, 8-byte aligned; `owner` scratch of 4 n_buckets
// bytes (set to all ones here before the round walk); `stats` null or
// i32[2], which gets (rounds, keys walked and not committed). Each returns
// cudaGetLastError() after its launches (cudaErrorInvalidValue for a bucket
// count that is not a power of two up to 2^32, an unknown variant, or a
// window outside 1..1024).
// ---------------------------------------------------------------------------

extern "C" int tpb_cuckoo_insert(void* state, const void* keys, const void* lengths, void* fi,
                                 void* owner, void* ok, void* kicks, void* stats, int64_t B,
                                 int L, int64_t n_buckets, uint32_t seed, void* stream) {
  using namespace tpubloom;
  return launch_cuckoo_walk<true>(state, keys, lengths, fi, owner, ok, kicks, stats, B, L,
                                  n_buckets, seed, kWalkRounds, kCuckooWindow, stream);
}

extern "C" int tpb_cuckoo_delete(void* state, const void* keys, const void* lengths, void* fi,
                                 void* owner, void* deleted, void* stats, int64_t B, int L,
                                 int64_t n_buckets, uint32_t seed, void* stream) {
  using namespace tpubloom;
  return launch_cuckoo_walk<false>(state, keys, lengths, fi, owner, deleted, nullptr, stats, B, L,
                                   n_buckets, seed, kWalkRounds, kCuckooWindow, stream);
}

// The insert (insert != 0) or delete on any second launch: `variant` 0 the
// round walk of `window` threads (0: the main path's), 1 the warp walk
// with its prefetch lanes, 2 the lone thread. For timing and tests.
extern "C" int tpb_cuckoo_walk_variant(void* state, const void* keys, const void* lengths,
                                       void* fi, void* owner, void* flag, void* kicks,
                                       void* stats, int64_t B, int L, int64_t n_buckets,
                                       uint32_t seed, int insert, int variant, int window,
                                       void* stream) {
  using namespace tpubloom;
  if (window == 0) window = kCuckooWindow;
  return insert ? launch_cuckoo_walk<true>(state, keys, lengths, fi, owner, flag, kicks, stats, B,
                                           L, n_buckets, seed, variant, window, stream)
                : launch_cuckoo_walk<false>(state, keys, lengths, fi, owner, flag, nullptr, stats,
                                            B, L, n_buckets, seed, variant, window, stream);
}

// The round walk's default window (the main path's), for the wrappers.
extern "C" int tpb_cuckoo_window() { return tpubloom::kCuckooWindow; }

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
  const uint32_t mask = (uint32_t)(n_buckets - 1);
  if (L <= 16) return launch_cuckoo_query<4>(state, keys, lengths, out, B, L, mask, seed, cs);
  if (L <= 32) return launch_cuckoo_query<8>(state, keys, lengths, out, B, L, mask, seed, cs);
  return launch_cuckoo_query<0>(state, keys, lengths, out, B, L, mask, seed, cs);
}
