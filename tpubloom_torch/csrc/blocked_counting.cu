// Blocked counting filter kernels for Hopper (sm_90a): update and query.
//
// The state is u32[n_blocks, W] packed 4-bit counters (W = block_bits / 32,
// counters_per_block = 8 W; the fat [NB*W/128, 128] storage is the same
// memory): counter c of a block is nibble c & 7 (bits 4*(c & 7) and up) of
// word c >> 3 of the block's row. Keys are u8[B, L] (L a multiple of 4, zero
// past each key's length), lengths i32[B], a negative length marking a
// padding entry. Each thread loads and hashes one key (bloom_hash.cuh, with
// the spec's block_bits set to counters_per_block, as tpubloom does for
// counting layouts), and a key touches only its one block: the query reads
// it in the key's own thread, the update writes it from a group of lanes.
// The results are bit-identical to tpubloom's: the same counters after an
// insert or a delete, the same verdicts from a query.
//
// As in blocked_bloom.cu, each kernel has a routed instantiation (kRouted =
// true) for the sharded filter array: the state is one slot's shards,
// n_blocks the block count of one shard, and a key the slot does not own
// changes nothing and answers False. The unrouted instantiation never reads
// its RouteSpec (the last parameter) and compiles as before.
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

constexpr int kCountThreads = 256;

// ---------------------------------------------------------------------------
// blocked_counting_update
//
// Replaces both TPU counting sweeps of tpubloom/ops/sweep.py:
//   K4 `_fat_count_kernel` / `fat_sweep_counter` (sweep.py:1976, on the fat
//      [NB/J, 128] storage, driven by `apply_fat_counter_updates`), and
//   K2 `_count_kernel` / `sweep_counter_update` (sweep.py:582, on the
//      logical [NB, W] view, driven by `apply_counter_updates`).
// The fat and logical views are the same bytes on the card, so one kernel
// covers both. The TPU sorts the batch by block, streams every partition of
// the counters through VMEM and sums per-counter multiplicities with one-hot
// matmuls, because its HBM cannot do random read-modify-writes; a window that
// overflows under duplicate skew sends the whole batch to a scatter fallback
// (sweep.py:2231-2253). Here each key updates its own row in place.
//
// Per touched 16-byte quarter of a key's row, the kernel builds the
// per-nibble deltas of its four words (the key's multiplicity at each of
// their 32 counters), then runs a CAS loop on the quarter with Hopper's
// 16-byte atomicCAS (sm_90): read it, apply a nibble-wise saturating add
// (insert) or flooring subtract (delete), CAS. A plain atomicAdd would carry
// from one nibble into the next and could not saturate. A delta is kept as
// a nibble that saturates at 15: for a counter v in [0, 15], min(15, v + d)
// and max(0, v - d) do not change when d is clamped at 15, so the
// multiplicity of a key at one counter needs no k <= 15 limit.
//
// Why the result is bit-identical to the one-clamp-per-batch rule of
// tpubloom (ops/counting.py:10-14; sweep.py:2108-2111 clamps once against
// the pre-batch value): a batch is all inserts or all deletes, so every
// delta applied to a nibble has one sign. Saturating adds of non-negative
// deltas, in any order, give min(15, old + sum of deltas); flooring
// subtracts give max(0, old - sum). That is what counter_update computes
// (and the TPU kernel's per-window clamp of the count at 16 changes nothing,
// since 16 already saturates or floors any nibble). The order in which the
// CASes land therefore does not matter.
//
// The CAS is skipped when the new quarter equals the one read: once a hot
// key's counters are saturated (insert) or zero (delete), every further copy
// of it only reads. This is what the TPU's scatter fallback did for
// duplicate skew. The skip is safe even on a stale read: within one batch
// every nibble moves in one direction only, so a nibble read at 15 (insert)
// or 0 (delete) is still there.
//
// Bound: bytes. Per key L + 4 input bytes; each touched row is read once and
// written once. At BASELINE config 4 (m = 2^30 counters, block_bits = 512,
// W = 16, n_blocks = 2^23, B = 2^22, lambda = 0.5 keys a block, ~3.30 M
// distinct rows) that is ~84 MB + 3.30 M x 64 B x 2 = ~0.51 GB, ~0.15 ms at
// 3.35 TB/s. The loads and CASes execute in L2, so the rate of L2 requests
// is the floor to design for: a key's k = 7 counters touch
// 16 (1 - (15/16)^7) = ~5.82 words of its row, 4 (1 - (3/4)^7) = ~3.47 of
// its four quarters and 2 (1 - 2^-7) = ~1.98 of its two 32-byte sectors.
// With one thread a key (the first design) every word was a load and a
// CAS of its own, ~24.4 M of each a launch.
//
// Hence the structure of blocked_insert (blocked_bloom.cu): each lane
// hashes one key once and stages the nibble deltas of its row in shared
// memory; the ballot of the keys to update (a routed slot's owned keys
// only) is the warp's work list, walked with G = W / 4 lanes a key, 32 / G
// keys a step. Lane t of a group reads the key's quarter t with one
// 16-byte __ldcg (from L2, where the CASes land) when its deltas are not
// 0, so the group's loads leave in one instruction over ~1.98 sectors,
// then runs the CAS loop on that quarter alone. The loops diverge; the
// next step's warp collectives come after them. A word-CAS version of the
// same kernel (W lanes a key, a 4-byte CAS a touched word) was slower on
// uniform keys and faster when a quarter of the batch is one key (PERF.md
// has both, on an H100); the counting path's batches are uniform. W = 64
// and 128 (block_bits 2048, 4096) take the wide kernel: 32 lanes a key,
// lane q owns quarter q and computes the k positions from the broadcast
// hash pool.
//
// sharded_blocked_counting_update (kRouted = true) is the per-device update
// of the sharded counting array (configs 4 x 5): K2 at
// tpubloom/parallel/sharded.py:507,525 and K4 at :500. A key the slot does
// not own costs the routing hash and never enters the work list. At
// configs 4 x 5 (m = 2^30 counters over 64 shards, B = 2^22) lambda is
// still 0.5, so the bound is config 4's.
// ---------------------------------------------------------------------------

// One word's update: nibble n of `w` moves by nibble n of `d`, saturating
// at 15 (increment) or flooring at 0.
__device__ __forceinline__ uint32_t nibble_apply(uint32_t w, uint32_t d,
                                                 bool increment) {
  uint32_t out = 0u;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint32_t v = (w >> (4 * n)) & 15u, dn = (d >> (4 * n)) & 15u;
    const uint32_t r = increment ? min(15u, v + dn) : (v > dn ? v - dn : 0u);
    out |= r << (4 * n);
  }
  return out;
}

// Adds one to nibble c & 7 of the delta word `d`, saturating at 15.
__device__ __forceinline__ uint32_t delta_add(uint32_t d, uint32_t c) {
  const uint32_t sh = 4u * (c & 7u);
  return d + ((((d >> sh) & 15u) < 15u) ? (1u << sh) : 0u);
}

// Applies the deltas `d` to the 16-byte quarter row `p` with Hopper's
// 16-byte CAS: one load, then CAS until it lands or nothing would change.
__device__ __forceinline__ void quad_cas(uint4* p, uint4 d, bool increment) {
  uint4 old = __ldcg(p);
  while (true) {
    const uint4 next = make_uint4(nibble_apply(old.x, d.x, increment),
                                  nibble_apply(old.y, d.y, increment),
                                  nibble_apply(old.z, d.z, increment),
                                  nibble_apply(old.w, d.w, increment));
    if (next.x == old.x && next.y == old.y && next.z == old.z && next.w == old.w) break;
    const uint4 seen = atomicCAS(p, old, next);
    if (seen.x == old.x && seen.y == old.y && seen.z == old.z && seen.w == old.w) break;
    old = seen;
  }
}

// W = 4, 8, 16, 32: a group of W / 4 lanes a key, a 16-byte quarter row
// a lane, the deltas staged.
template <int W, bool kRouted>
__global__ void __launch_bounds__(kCountThreads)
blocked_counting_update_row_kernel(uint32_t* __restrict__ state,
                                   const uint8_t* __restrict__ keys,
                                   const int32_t* __restrict__ lengths,
                                   int64_t B, int L, BlockSpec s,
                                   int increment, RouteSpec route) {
  constexpr int kStride = W + 4, G = W / 4;
  __shared__ __align__(16) uint32_t stage[kCountThreads * kStride];
  const LaneKey mine = lane_key<kRouted>(keys, lengths, B, L, W, s, route);
  if (mine.valid) {
    uint32_t* d = stage + threadIdx.x * kStride;
#pragma unroll
    for (int c = 0; c < W / 4; ++c)
      reinterpret_cast<uint4*>(d)[c] = make_uint4(0u, 0u, 0u, 0u);
    for (int j = 0; j < s.k; ++j) {
      const uint32_t c = inblock_bit(j, mine.h, s);
      d[c >> 3] = delta_add(d[c >> 3], c);
    }
  }
  __syncwarp();
  const int lane = threadIdx.x & 31, sub = lane % G;
  const uint32_t* warp_stage = stage + (threadIdx.x - lane) * kStride;
  for (unsigned list = __ballot_sync(kFullMask, mine.valid); list;
       list = next_step<32 / G>(list)) {
    const int src = nth_lane<32 / G>(list, lane / G);
    const uint64_t row = __shfl_sync(kFullMask, mine.row, src < 0 ? 0 : src);
    if (src >= 0) {
      const uint4 d = reinterpret_cast<const uint4*>(warp_stage + src * kStride)[sub];
      if (d.x | d.y | d.z | d.w)
        quad_cas(reinterpret_cast<uint4*>(state + row) + sub, d, increment != 0);
    }
  }
}

// W = 64, 128: 32 lanes a key, lane q owning quarter row q (W / 4 <= 32
// quarters, block_bits <= 4096).
template <bool kRouted>
__global__ void __launch_bounds__(kCountThreads)
blocked_counting_update_wide_kernel(uint32_t* __restrict__ state,
                                    const uint8_t* __restrict__ keys,
                                    const int32_t* __restrict__ lengths,
                                    int64_t B, int L, int W, BlockSpec s,
                                    int increment, RouteSpec route) {
  const LaneKey mine = lane_key<kRouted>(keys, lengths, B, L, W, s, route);
  const uint32_t lane = threadIdx.x & 31;
  for (unsigned list = __ballot_sync(kFullMask, mine.valid); list;
       list &= list - 1u) {
    const LaneKey key = shfl_key(mine, __ffs(list) - 1);
    uint32_t d[4] = {0u, 0u, 0u, 0u};
    for (int j = 0; j < s.k; ++j) {
      const uint32_t c = inblock_bit(j, key.h, s);  // 32 counters a quarter
      if ((c >> 5) != lane) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (((c >> 3) & 3u) == (uint32_t)t) d[t] = delta_add(d[t], c);
    }
    if (d[0] | d[1] | d[2] | d[3])
      quad_cas(reinterpret_cast<uint4*>(state + key.row) + lane,
               make_uint4(d[0], d[1], d[2], d[3]), increment != 0);
  }
}

// ---------------------------------------------------------------------------
// blocked_counting_query
//
// No Pallas counterpart: tpubloom computes blocked-counting membership with
// an XLA gather (`fat_blocked_counting_membership`, ops/counting.py:115-140;
// `blocked_counting_membership`, :97-112). A variant of blocked_query's row
// kernel (blocked_bloom.cu): the key's row is read with W/4 16-byte __ldg's,
// issued before the position arithmetic, and the key is present when each
// of its k nibbles is non-zero. Padding answers False.
//
// Bound: bytes. Per key L + 4 input bytes and one verdict byte out, and its
// row read once: at config 4, B = 2^22, ~84 MB + 4 MB + 3.30 M x 64 B =
// ~0.30 GB, ~0.09 ms at 3.35 TB/s. The rows are random 64-byte reads, so the
// card's random-sector rate is the real floor, as for blocked_query.
//
// sharded_blocked_counting_query (kRouted = true) covers the sharded
// counting membership (fat_blocked_counting_membership /
// blocked_counting_membership inside shard_map, sharded.py:557-571): owned
// && all counters non-zero, False without a row read for a key the slot
// does not own.
// ---------------------------------------------------------------------------

template <int W, bool kRouted>
__global__ void __launch_bounds__(kCountThreads)
blocked_counting_query_row_kernel(const uint32_t* __restrict__ state,
                                  const uint8_t* __restrict__ keys,
                                  const int32_t* __restrict__ lengths,
                                  uint8_t* __restrict__ out, int64_t B, int L,
                                  BlockSpec s, RouteSpec route) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int len = lengths[i];
  if (len < 0) {
    out[i] = 0;
    return;
  }
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(keys + i * L);
  uint64_t base = 0;
  if constexpr (kRouted) {
    const int64_t local = route_key(kw, L / 4, len, s.seed, route);
    if (local < 0) {  // not this slot's key: False, no row read
      out[i] = 0;
      return;
    }
    base = (uint64_t)local * s.n_blocks;
  }
  const KeyHash h = hash_key(kw, L / 4, len, s);
  const uint4* row = reinterpret_cast<const uint4*>(state + (base + h.blk) * W);
  uint32_t r[W];
#pragma unroll
  for (int c = 0; c < W / 4; ++c) {
    const uint4 v = __ldg(row + c);
    r[4 * c + 0] = v.x;
    r[4 * c + 1] = v.y;
    r[4 * c + 2] = v.z;
    r[4 * c + 3] = v.w;
  }
  bool hit = true;
  for (int j = 0; j < s.k; ++j) {
    const uint32_t c = inblock_bit(j, h, s);
    const uint32_t word = c >> 3;
    uint32_t v = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) v = (word == (uint32_t)w) ? r[w] : v;
    hit &= ((v >> (4 * (c & 7u))) & 15u) != 0u;
  }
  out[i] = hit ? 1 : 0;
}

// Any W: each of the k counters' words is read on its own.
template <bool kRouted>
__global__ void __launch_bounds__(kCountThreads)
blocked_counting_query_word_kernel(const uint32_t* __restrict__ state,
                                   const uint8_t* __restrict__ keys,
                                   const int32_t* __restrict__ lengths,
                                   uint8_t* __restrict__ out, int64_t B, int L,
                                   int W, BlockSpec s, RouteSpec route) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int len = lengths[i];
  if (len < 0) {
    out[i] = 0;
    return;
  }
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(keys + i * L);
  uint64_t base = 0;
  if constexpr (kRouted) {
    const int64_t local = route_key(kw, L / 4, len, s.seed, route);
    if (local < 0) {
      out[i] = 0;
      return;
    }
    base = (uint64_t)local * s.n_blocks;
  }
  const KeyHash h = hash_key(kw, L / 4, len, s);
  const uint32_t* row = state + (base + h.blk) * W;
  bool hit = true;
  for (int j = 0; j < s.k && hit; ++j) {
    const uint32_t c = inblock_bit(j, h, s);
    hit = ((__ldg(row + (c >> 3)) >> (4 * (c & 7u))) & 15u) != 0u;
  }
  out[i] = hit ? 1 : 0;
}

inline BlockSpec counting_spec(int64_t n_blocks, int counters_per_block, int k,
                               uint32_t seed, int chunk) {
  BlockSpec s;
  s.n_blocks = (uint64_t)n_blocks;
  s.block_bits = counters_per_block;  // the in-block position domain
  s.log2_bits = 0;
  while ((1 << s.log2_bits) < counters_per_block) ++s.log2_bits;
  s.k = k;
  s.seed = seed;
  s.chunk = chunk;
  return s;
}

inline unsigned counting_grid(int64_t B) {
  return (unsigned)((B + kCountThreads - 1) / kCountThreads);
}

template <bool kRouted>
int launch_counting_update(void* state, const void* keys, const void* lengths,
                           int64_t B, int L, const BlockSpec& s, int increment,
                           const RouteSpec& r, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int W = s.block_bits / 8;  // block_bits is counters_per_block here
  auto st = static_cast<uint32_t*>(state);
  auto ky = static_cast<const uint8_t*>(keys);
  auto ln = static_cast<const int32_t*>(lengths);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const unsigned g = counting_grid(B);
  switch (W) {
    case 4: blocked_counting_update_row_kernel<4, kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, B, L, s, increment, r); break;
    case 8: blocked_counting_update_row_kernel<8, kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, B, L, s, increment, r); break;
    case 16: blocked_counting_update_row_kernel<16, kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, B, L, s, increment, r); break;
    case 32: blocked_counting_update_row_kernel<32, kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, B, L, s, increment, r); break;
    default: blocked_counting_update_wide_kernel<kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, B, L, W, s, increment, r); break;
  }
  return (int)cudaGetLastError();
}

template <bool kRouted>
int launch_counting_query(const void* state, const void* keys,
                          const void* lengths, void* out, int64_t B, int L,
                          const BlockSpec& s, const RouteSpec& r,
                          void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int W = s.block_bits / 8;  // block_bits is counters_per_block here
  auto st = static_cast<const uint32_t*>(state);
  auto ky = static_cast<const uint8_t*>(keys);
  auto ln = static_cast<const int32_t*>(lengths);
  auto o = static_cast<uint8_t*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const unsigned g = counting_grid(B);
  switch (W) {
    case 4: blocked_counting_query_row_kernel<4, kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
    case 8: blocked_counting_query_row_kernel<8, kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
    case 16: blocked_counting_query_row_kernel<16, kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
    case 32: blocked_counting_query_row_kernel<32, kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
    default: blocked_counting_query_word_kernel<kRouted><<<g, kCountThreads, 0, cs>>>(st, ky, ln, o, B, L, W, s, r); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

extern "C" int tpb_blocked_counting_update(void* state, const void* keys,
                                           const void* lengths, int64_t B,
                                           int L, int64_t n_blocks,
                                           int counters_per_block, int k,
                                           uint32_t seed, int chunk,
                                           int increment, void* stream) {
  using namespace tpubloom;
  return launch_counting_update<false>(
      state, keys, lengths, B, L,
      counting_spec(n_blocks, counters_per_block, k, seed, chunk), increment,
      RouteSpec{}, stream);
}

extern "C" int tpb_blocked_counting_query(const void* state, const void* keys,
                                          const void* lengths, void* out,
                                          int64_t B, int L, int64_t n_blocks,
                                          int counters_per_block, int k,
                                          uint32_t seed, int chunk,
                                          void* stream) {
  using namespace tpubloom;
  return launch_counting_query<false>(
      state, keys, lengths, out, B, L,
      counting_spec(n_blocks, counters_per_block, k, seed, chunk), RouteSpec{},
      stream);
}

// The routed entries: `state` is one slot's shards, `n_blocks` the block
// count of one shard, and the slot holds shards [shard_lo, shard_lo +
// shards_per_dev) of n_shards.
extern "C" int tpb_sharded_blocked_counting_update(
    void* state, const void* keys, const void* lengths, int64_t B, int L,
    int64_t n_blocks, int counters_per_block, int k, uint32_t seed, int chunk,
    int increment, int64_t n_shards, int64_t shard_lo, int64_t shards_per_dev,
    void* stream) {
  using namespace tpubloom;
  return launch_counting_update<true>(
      state, keys, lengths, B, L,
      counting_spec(n_blocks, counters_per_block, k, seed, chunk), increment,
      make_route(n_shards, shard_lo, shards_per_dev), stream);
}

extern "C" int tpb_sharded_blocked_counting_query(
    const void* state, const void* keys, const void* lengths, void* out,
    int64_t B, int L, int64_t n_blocks, int counters_per_block, int k,
    uint32_t seed, int chunk, int64_t n_shards, int64_t shard_lo,
    int64_t shards_per_dev, void* stream) {
  using namespace tpubloom;
  return launch_counting_query<true>(
      state, keys, lengths, out, B, L,
      counting_spec(n_blocks, counters_per_block, k, seed, chunk),
      make_route(n_shards, shard_lo, shards_per_dev), stream);
}
