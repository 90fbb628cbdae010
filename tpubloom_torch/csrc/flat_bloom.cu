// Flat bloom filter kernels for Hopper (sm_90a): insert and query on the
// packed bit array, update and query on the packed 4-bit counters.
//
// The flat layout is the Redis-bitmap-compatible one: a key's k positions
// (bloom_hash.cuh, `flat_walk` / `flat_position`; the spec is
// tpubloom/ops/hashing.py `positions`) lie anywhere in the filter. Bit pos is
// bit pos & 31 of word pos >> 5 of u32[n_words]; counter pos is nibble pos & 7
// (bits 4 (pos & 7) and up) of word pos >> 3 of u32[n_counter_words]. Keys
// are u8[B, L] (L a multiple of 4, zero past each key's length), lengths
// i32[B], a negative length marking a padding entry, which changes nothing
// and answers False. The results are bit-identical to tpubloom's: the same
// words after an insert or a delete, the same verdicts from a query (on
// padding tpubloom's unsharded flat queries answer the empty key's
// membership, which its include_batch cuts off; these answer False).
//
// None of these has a Pallas counterpart: tpubloom runs its flat layout on
// XLA ops, which the TPU needs because it cannot do random read-modify-
// writes in HBM: a sort of the B k (word, mask) pairs, a segmented OR-scan
// and a scatter of the last of each run (tpubloom/ops/bitops.py
// `scatter_or`), and the same two-level scan for the counters
// (ops/counting.py `counter_update`). Hopper can: here each thread takes one
// key, hashes it (from registers for a 16-byte key, from memory otherwise)
// and walks its k positions in place. There is no sort and no merge, so
// thousands of keys may hit one word; the atomics make the result
// independent of the order they land in (see each kernel).
//
// Each kernel has a routed instantiation (kRouted = true) for the sharded
// filter array (tpubloom/parallel/sharded.py `_routed_positions`,
// `_routed_counter_positions`): the state is one slot's shards, shard-major,
// m the position count of ONE shard, and a key the slot does not own
// (bloom_hash.cuh `route_key`) costs the routing hash and changes nothing or
// answers False. A position of shard shard_lo + s lies at s m + pos; at
// BASELINE config 5 (m = 2^36 over 64 shards on one card) that is a word
// index up to 2^31, so every offset is 64-bit.
//
// Bound, at the shapes the main path gives them: bytes, each key's 20 input
// bytes and the distinct 32-byte sectors its positions touch (read, and for
// the updates written back). At BASELINE config 2 (m = 2^30 bits, k = 10,
// B = 2^20 keys) the 10.5 M positions fall on ~3.9 M of the 4.2 M sectors:
// ~0.27 GB for the insert, ~0.08 ms at 3.35 TB/s. A thread a key gives each
// position its own L2 request, so the card's rate of random 32-byte
// requests, not its bandwidth, is what these kernels see (a key's k
// positions are k random sectors, so grouping them by key cannot help).
// What helps is grouping the batch's positions by place: for a batch that
// covers much of the state, the insert and the counting pair have
// partitioned kernels (flat_bits.cu, flat_counting.cu) that place each
// position in the segment of its shared-memory tile and sweep the tiles on
// chip; the wrapper (ops/sweep.py flat_takes_tiles) keeps these thread-a-key
// kernels for the small batches below the crossover. The bit query has no
// partitioned twin: it issues fewer requests instead, stopping each key at
// its first zero bit (flat_query_kernel).
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

constexpr int kFlatThreads = 256;
// The counting query issues this many of a key's loads before it tests any
// of them.
constexpr int kFlatGather = 8;
// The bit query issues a key's loads this many at a time and stops after
// the first group that holds a zero bit. One is the fastest of 1, 2 and 4
// on every mix chip_smoke.py times (flat_times, `group_ms`; NVIDIA H100
// 80GB HBM3, 700 W, config 2, ms): absent keys at ~1 % fill 0.039, 0.065,
// 0.118; held keys 0.276 each; config 2's own traffic at a fill of 0.606
// 0.179, 0.186, 0.205. The ~270 K resident keys keep enough loads in
// flight one at a time.
constexpr int kFlatQueryGroup = 1;

// ---------------------------------------------------------------------------
// flat_insert
//
// Replaces make_insert_fn + bitops.scatter_or (tpubloom/filter.py:51-69);
// sharded_flat_insert replaces make_sharded_insert_fn's local insert
// (tpubloom/parallel/sharded.py:139-161). One atomicOr of 1 << (pos & 31) on
// word pos >> 5 a position. OR is commutative and idempotent, so the words
// after the launch are the OR of the pre-batch words and every valid key's
// bits, whatever order the atomics land in: scatter_or's result.
// ---------------------------------------------------------------------------

template <bool kRouted>
__global__ void __launch_bounds__(kFlatThreads)
flat_insert_kernel(uint32_t* __restrict__ state, const uint8_t* __restrict__ keys,
                   const int32_t* __restrict__ lengths, int64_t B, int L,
                   FlatSpec s, RouteSpec route) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  FlatWalk w;
  uint64_t base;
  if (!flat_key<kRouted>(keys, lengths, i, L, s, route, w, base)) return;
  for (int j = 0; j < s.k; ++j) {
    const uint64_t p = base + flat_position(j, w, s);
    atomicOr(state + (p >> 5), 1u << (p & 31u));
  }
}

// ---------------------------------------------------------------------------
// flat_query
//
// Replaces make_query_fn + bitops.query_membership (tpubloom/filter.py:
// 72-83); sharded_flat_query the local query of make_sharded_query_fn
// (sharded.py:164-186), whose verdicts the caller ORs across slots. The
// key's k word gathers go out kGroup at a time; after each group the AND of
// the bits so far is tested, and a key that has met a zero bit issues no
// more. The verdict is the AND of the k bits, as query_membership's: a
// held key reads all k words, an absent one stops at its first zero (one
// read in a sparse filter, ~2.5 at config 2's fill of 0.61). The card's
// random gathers run at ~35 G/s (PERF.md), so each request not issued is
// time saved; at 256 threads a CTA, a launch of 2^20 keys keeps ~270 K keys
// resident (132 SMs x 2,048 threads), each with kGroup loads in flight.
// ---------------------------------------------------------------------------

template <bool kRouted, int kGroup>
__global__ void __launch_bounds__(kFlatThreads)
flat_query_kernel(const uint32_t* __restrict__ state,
                  const uint8_t* __restrict__ keys,
                  const int32_t* __restrict__ lengths, uint8_t* __restrict__ out,
                  int64_t B, int L, FlatSpec s, RouteSpec route) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  FlatWalk w;
  uint64_t base;
  if (!flat_key<kRouted>(keys, lengths, i, L, s, route, w, base)) {
    out[i] = 0;
    return;
  }
  bool hit = true;
  for (int j0 = 0; hit && j0 < s.k; j0 += kGroup) {
    uint32_t v[kGroup], b[kGroup];
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      v[t] = 1u;
      b[t] = 0u;
      if (j0 + t < s.k) {
        const uint64_t p = base + flat_position(j0 + t, w, s);
        v[t] = __ldg(state + (p >> 5));
        b[t] = (uint32_t)(p & 31u);
      }
    }
#pragma unroll
    for (int t = 0; t < kGroup; ++t) hit &= ((v[t] >> b[t]) & 1u) != 0u;
  }
  out[i] = hit ? 1 : 0;
}

// ---------------------------------------------------------------------------
// flat_counting_update
//
// Replaces make_counter_fn + counting.counter_update (tpubloom/filter.py:
// 86-101); sharded_flat_counting_update the local update of
// make_sharded_counter_fn (sharded.py:394-417). A position's +1 (insert) or
// -1 (delete) is a CAS loop on its 32-bit word (bloom_hash.cuh
// counter_step): read the word, stop when the nibble is already at 15
// (insert) or 0 (delete), else CAS the word with the nibble moved by one. A
// plain atomicAdd would carry from one nibble into the next and could not
// saturate.
//
// Why the result equals tpubloom's: tpubloom applies each distinct
// position's multiplicity c in the batch, clamped once against the pre-batch
// nibble v: v + min(c, 15 - v) for an insert, v - min(c, v) for a delete. A
// batch has one sign, so applying the same c steps of +1 (or -1) one at a
// time, each saturating at 15 (or flooring at 0), lands on the same value in
// any order. Two of one key's k positions that coincide count twice in
// tpubloom (it flattens the B x k positions), so they take two steps here.
// The stop on a saturated or floored nibble is safe on a stale read: within
// the batch every nibble moves one way only, so a nibble read at 15
// (insert) or 0 (delete) is still there.
// ---------------------------------------------------------------------------

template <bool kRouted>
__global__ void __launch_bounds__(kFlatThreads)
flat_counting_update_kernel(uint32_t* __restrict__ state,
                            const uint8_t* __restrict__ keys,
                            const int32_t* __restrict__ lengths, int64_t B,
                            int L, FlatSpec s, int increment, RouteSpec route) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  FlatWalk w;
  uint64_t base;
  if (!flat_key<kRouted>(keys, lengths, i, L, s, route, w, base)) return;
  for (int j = 0; j < s.k; ++j) {
    const uint64_t p = base + flat_position(j, w, s);
    counter_step(state + (p >> 3), 4 * (int)(p & 7u), increment);
  }
}

// ---------------------------------------------------------------------------
// flat_counting_query
//
// Replaces make_counting_query_fn + counting.counting_membership
// (tpubloom/filter.py:104-113); sharded_flat_counting_query the local query
// of make_sharded_counting_query_fn (sharded.py:420-440). k nibble gathers,
// kFlatGather of them in flight before their nibbles are tested, with no
// early exit; present when every nibble is non-zero.
// ---------------------------------------------------------------------------

template <bool kRouted>
__global__ void __launch_bounds__(kFlatThreads)
flat_counting_query_kernel(const uint32_t* __restrict__ state,
                           const uint8_t* __restrict__ keys,
                           const int32_t* __restrict__ lengths,
                           uint8_t* __restrict__ out, int64_t B, int L,
                           FlatSpec s, RouteSpec route) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  FlatWalk w;
  uint64_t base;
  if (!flat_key<kRouted>(keys, lengths, i, L, s, route, w, base)) {
    out[i] = 0;
    return;
  }
  bool hit = true;
  for (int j0 = 0; j0 < s.k; j0 += kFlatGather) {
    uint32_t v[kFlatGather], sh[kFlatGather];
#pragma unroll
    for (int t = 0; t < kFlatGather; ++t) {
      v[t] = 15u;
      sh[t] = 0u;
      if (j0 + t < s.k) {
        const uint64_t p = base + flat_position(j0 + t, w, s);
        v[t] = __ldg(state + (p >> 3));
        sh[t] = 4u * (uint32_t)(p & 7u);
      }
    }
#pragma unroll
    for (int t = 0; t < kFlatGather; ++t) hit &= ((v[t] >> sh[t]) & 15u) != 0u;
  }
  out[i] = hit ? 1 : 0;
}

inline unsigned flat_grid(int64_t B) {
  return (unsigned)((B + kFlatThreads - 1) / kFlatThreads);
}

template <bool kRouted>
int launch_flat_insert(void* state, const void* keys, const void* lengths,
                       int64_t B, int L, const FlatSpec& s, const RouteSpec& r,
                       void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  flat_insert_kernel<kRouted><<<flat_grid(B), kFlatThreads, 0, cs>>>(
      static_cast<uint32_t*>(state), static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(lengths), B, L, s, r);
  return (int)cudaGetLastError();
}

template <bool kRouted, int kGroup = kFlatQueryGroup>
int launch_flat_query(const void* state, const void* keys, const void* lengths,
                      void* out, int64_t B, int L, const FlatSpec& s,
                      const RouteSpec& r, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  flat_query_kernel<kRouted, kGroup><<<flat_grid(B), kFlatThreads, 0, cs>>>(
      static_cast<const uint32_t*>(state), static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(lengths), static_cast<uint8_t*>(out), B, L, s, r);
  return (int)cudaGetLastError();
}

template <bool kRouted>
int launch_flat_counting_update(void* state, const void* keys,
                                const void* lengths, int64_t B, int L,
                                const FlatSpec& s, int increment,
                                const RouteSpec& r, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  flat_counting_update_kernel<kRouted><<<flat_grid(B), kFlatThreads, 0, cs>>>(
      static_cast<uint32_t*>(state), static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(lengths), B, L, s, increment, r);
  return (int)cudaGetLastError();
}

template <bool kRouted>
int launch_flat_counting_query(const void* state, const void* keys,
                               const void* lengths, void* out, int64_t B, int L,
                               const FlatSpec& s, const RouteSpec& r,
                               void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  flat_counting_query_kernel<kRouted><<<flat_grid(B), kFlatThreads, 0, cs>>>(
      static_cast<const uint32_t*>(state), static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(lengths), static_cast<uint8_t*>(out), B, L, s, r);
  return (int)cudaGetLastError();
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t; `m` the position count (bits or counters) of the filter, or
// of one shard for the routed entries, whose slot holds shards [shard_lo,
// shard_lo + shards_per_dev) of n_shards. Each returns cudaGetLastError()
// after its launch.
// ---------------------------------------------------------------------------

extern "C" int tpb_flat_insert(void* state, const void* keys, const void* lengths,
                               int64_t B, int L, int64_t m, int k, uint32_t seed,
                               void* stream) {
  using namespace tpubloom;
  return launch_flat_insert<false>(state, keys, lengths, B, L,
                                   make_flat_spec(m, k, seed), RouteSpec{}, stream);
}

extern "C" int tpb_flat_query(const void* state, const void* keys,
                              const void* lengths, void* out, int64_t B, int L,
                              int64_t m, int k, uint32_t seed, void* stream) {
  using namespace tpubloom;
  return launch_flat_query<false>(state, keys, lengths, out, B, L,
                                  make_flat_spec(m, k, seed), RouteSpec{}, stream);
}

// tpb_flat_query with the key's loads issued `group` (1, 2 or 4) at a time
// instead of kFlatQueryGroup: the same verdicts, for chip_smoke.py to time
// the choice of kFlatQueryGroup. cudaErrorInvalidValue for another group.
extern "C" int tpb_flat_query_group(const void* state, const void* keys,
                                    const void* lengths, void* out, int64_t B, int L,
                                    int64_t m, int k, uint32_t seed, int group,
                                    void* stream) {
  using namespace tpubloom;
  const FlatSpec s = make_flat_spec(m, k, seed);
  switch (group) {
    case 1: return launch_flat_query<false, 1>(state, keys, lengths, out, B, L, s, RouteSpec{}, stream);
    case 2: return launch_flat_query<false, 2>(state, keys, lengths, out, B, L, s, RouteSpec{}, stream);
    case 4: return launch_flat_query<false, 4>(state, keys, lengths, out, B, L, s, RouteSpec{}, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int tpb_flat_counting_update(void* state, const void* keys,
                                        const void* lengths, int64_t B, int L,
                                        int64_t m, int k, uint32_t seed,
                                        int increment, void* stream) {
  using namespace tpubloom;
  return launch_flat_counting_update<false>(state, keys, lengths, B, L,
                                            make_flat_spec(m, k, seed), increment,
                                            RouteSpec{}, stream);
}

extern "C" int tpb_flat_counting_query(const void* state, const void* keys,
                                       const void* lengths, void* out, int64_t B,
                                       int L, int64_t m, int k, uint32_t seed,
                                       void* stream) {
  using namespace tpubloom;
  return launch_flat_counting_query<false>(state, keys, lengths, out, B, L,
                                           make_flat_spec(m, k, seed),
                                           RouteSpec{}, stream);
}

extern "C" int tpb_sharded_flat_insert(void* state, const void* keys,
                                       const void* lengths, int64_t B, int L,
                                       int64_t m, int k, uint32_t seed,
                                       int64_t n_shards, int64_t shard_lo,
                                       int64_t shards_per_dev, void* stream) {
  using namespace tpubloom;
  return launch_flat_insert<true>(state, keys, lengths, B, L,
                                  make_flat_spec(m, k, seed),
                                  make_route(n_shards, shard_lo, shards_per_dev),
                                  stream);
}

extern "C" int tpb_sharded_flat_query(const void* state, const void* keys,
                                      const void* lengths, void* out, int64_t B,
                                      int L, int64_t m, int k, uint32_t seed,
                                      int64_t n_shards, int64_t shard_lo,
                                      int64_t shards_per_dev, void* stream) {
  using namespace tpubloom;
  return launch_flat_query<true>(state, keys, lengths, out, B, L,
                                 make_flat_spec(m, k, seed),
                                 make_route(n_shards, shard_lo, shards_per_dev),
                                 stream);
}

extern "C" int tpb_sharded_flat_counting_update(
    void* state, const void* keys, const void* lengths, int64_t B, int L,
    int64_t m, int k, uint32_t seed, int increment, int64_t n_shards,
    int64_t shard_lo, int64_t shards_per_dev, void* stream) {
  using namespace tpubloom;
  return launch_flat_counting_update<true>(
      state, keys, lengths, B, L, make_flat_spec(m, k, seed), increment,
      make_route(n_shards, shard_lo, shards_per_dev), stream);
}

extern "C" int tpb_sharded_flat_counting_query(
    const void* state, const void* keys, const void* lengths, void* out,
    int64_t B, int L, int64_t m, int k, uint32_t seed, int64_t n_shards,
    int64_t shard_lo, int64_t shards_per_dev, void* stream) {
  using namespace tpubloom;
  return launch_flat_counting_query<true>(
      state, keys, lengths, out, B, L, make_flat_spec(m, k, seed),
      make_route(n_shards, shard_lo, shards_per_dev), stream);
}
