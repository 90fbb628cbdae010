// Blocked bloom filter kernels for Hopper (sm_90a): query and insert.
//
// Both take the filter state as u32[n_blocks, W] (W = block_bits / 32; the
// fat [NB*W/128, 128] storage is the same memory), the keys as u8[B, L]
// (L a multiple of 4, zero past each key's length) and the lengths as
// i32[B], where a negative length marks a padding entry. Each thread loads
// and hashes one key (bloom_hash.cuh), and a key touches only its one
// block: the query gathers it with a group of lanes and tests it in the
// key's own lane, the insert writes it from a group of lanes (see
// blocked_insert). The results are bit-identical to tpubloom's: the same
// filter state after an insert, the same verdicts from a query.
//
// Each kernel has a routed variant for the sharded filter array
// (tpubloom/parallel/sharded.py): the state is then one slot's shards,
// u32[shards_per_dev * n_blocks_per_shard, W]; the key's shard comes from
// the routing hash (bloom_hash.cuh, route_key), and a key the slot does not
// own sets nothing and answers False. It is an instantiation with kRouted =
// true (the unrouted one never reads its RouteSpec, the last parameter);
// the query has besides a kernel of its own for a slot that owns only some
// shards, sharded_blocked_query_row_kernel, which compacts the owned keys
// first.
//
// Built by tpubloom_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes. Each entry launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"

namespace tpubloom {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// blocked_query
//
// Replaces K5, the TPU query sweep `_fat_query_kernel` / `fat_sweep_query`
// (tpubloom/ops/sweep.py:2437, driven by `apply_fat_query`), and the
// presence half (PRES) of K3 `_fat_kernel`. The TPU sorts keys by block and
// streams the whole array through VMEM because its HBM serves random rows
// slowly; Hopper serves a random 64-byte row directly, so each key gathers
// its own row, and no sort, partition window or overflow fallback exists.
//
// Bound: bytes. Per key it reads L key bytes and 4 length bytes, writes
// one verdict byte, and reads its block's row (64 B at block_bits = 512).
// At the main path's shapes (B = 2^23, m = 2^32, lambda = 1) the distinct
// rows are ~63% of the 512 MiB state: ~0.52 GB with the keys, 0.154 ms at
// 3.35 TB/s. With no row shared in the L2 (every key's row read once) it is
// ~0.71 GB, 0.213 ms: the floor a gather that gets no reuse can reach. The
// integer work the function needs, ~282 32-bit operations a key (three
// murmur3 passes, fnv1a, k slices and k bit tests), takes 0.141 ms at the
// card's INT32 rate (132 SMs x 64 lanes x 1.98 GHz), under the byte bound.
// The first design (a thread a key) spent more: its W-word mask took k * W
// selects a key, and each lane's own four 16-byte row loads put 32
// unrelated rows in every load instruction. Hence:
//
// - Keys: each lane loads and hashes one key (lane_key, as the updates
//   do); a 16-byte key is loaded once into registers and hashed there. A lane without a key is
//   a flag, never an early return, so every lane reaches the collectives.
// - Gather (query_warp): G = W / 4 lanes a key copy its row into the key's
//   slot of shared memory, a 16-byte quarter a lane, with cp.async, the
//   row offset broadcast by __shfl_sync. All G steps' copies are issued
//   before one wait: a key's row leaves in one request, each sector once,
//   and the warp's 32 rows are in flight together.
// - Test: the key's own lane reads word b >> 5 of its staged row and tests
//   bit b & 31, ~4 operations a position instead of a W-word mask.
// - W = 64, 128 (block_bits 2048, 4096) keep the chunk kernel: a thread a
//   key, loading only the 16-byte chunks its bits touch.
//
// On an H100 this took the query from 0.367 to 0.323 ms at the main path's
// shapes. Trimming the lane's instructions further (hashing full keys with
// the length a constant, a sliding window for the positions, the test
// unrolled for k = 7) then moved nothing, so what is left is the gather's
// latency and the card's rate for random 64-byte rows (PERF.md).
//
// sharded_blocked_query (the routed kernel) serves the sharded filter
// array's membership: on the TPU, K5 inside shard_map when a device holds
// one shard (tpubloom/parallel/sharded.py:337-354), the row gather
// otherwise. Each slot answers owned && hit; a key it does not own answers
// False without a row read, and the slots' answers are ORed after the
// kernels (the psum at sharded.py:362). A slot that owns only some shards
// (several slots a card, or one slot a card of many) compacts: each thread
// routes kRouteKeys keys (one murmur3 a key), the owned ones are listed in
// shared memory, and the block runs query_warp over that list on full
// warps, so that a slot's hashing, gathers and tests scale with the keys it
// owns, not with the batch. A slot that owns every shard has nothing to
// compact: the thread-a-key kernel runs with the routing hash in front.
// (On an H100 the compaction cost that slot 7 % at kRouteKeys = 1, and a
// slot owning a quarter of the keys ran fastest at kRouteKeys = 2; PERF.md.)
// Bound: bytes, over every key read (and routed) and the owned keys'
// distinct rows; at config 5 on one slot (B = 2^23 over 2^27 blocks) ~0.70
// GB, ~0.21 ms.
// ---------------------------------------------------------------------------

// The query of a warp's keys, one key a lane (`mine`; a lane without a key
// has mine.valid false and answers false). Every lane of the warp calls
// it. G = W / 4 lanes copy a key's row, a 16-byte quarter a lane, into the
// key's slot of the warp's stage (kStride words a lane) with cp.async; the
// row offset comes from the key's lane by __shfl_sync, and all G steps'
// copies are issued before the one wait. Then each lane tests its own k
// positions against its staged row.
template <int W>
__device__ __forceinline__ bool query_warp(const LaneKey& mine,
                                           const uint32_t* __restrict__ state,
                                           uint32_t* warp_stage,
                                           const BlockSpec& s) {
  constexpr int kStride = W + 4, G = W / 4, kPerStep = 32 / G;
  const int lane = threadIdx.x & 31, sub = lane % G, grp = lane / G;
  const unsigned valid = __ballot_sync(kFullMask, mine.valid);
#pragma unroll
  for (int t = 0; t < G; ++t) {
    const int src = t * kPerStep + grp;
    const uint64_t row = __shfl_sync(kFullMask, mine.row, src);
    if ((valid >> src) & 1u)
      __pipeline_memcpy_async(warp_stage + src * kStride + 4 * sub,
                              state + row + 4 * sub, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  bool hit = mine.valid;
  if (hit) {
    const uint32_t* r = warp_stage + lane * kStride;
    for (int j = 0; j < s.k; ++j) {
      const uint32_t b = inblock_bit(j, mine.h, s);
      hit &= ((r[b >> 5] >> (b & 31)) & 1u) != 0u;
    }
  }
  __syncwarp();  // the stage is free again
  return hit;
}

// W = 4, 8, 16, 32: a thread a key, the rows gathered by lane groups
// (query_warp). kRouted: the key is routed in its own thread first, and a
// key the slot does not own answers False; the launch takes this kernel
// for a slot that owns every shard, where there is nothing to compact.
template <int W, bool kRouted>
__global__ void __launch_bounds__(kThreads)
blocked_query_row_kernel(const uint32_t* __restrict__ state,
                         const uint8_t* __restrict__ keys,
                         const int32_t* __restrict__ lengths,
                         uint8_t* __restrict__ out, int64_t B, int L,
                         BlockSpec s, RouteSpec route) {
  __shared__ __align__(16) uint32_t stage[kThreads * (W + 4)];
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const LaneKey mine = lane_key<kRouted>(keys, lengths, B, L, W, s, route);
  const bool hit = query_warp<W>(mine, state, stage + (threadIdx.x & ~31) * (W + 4), s);
  if (i < B) out[i] = hit ? 1 : 0;  // padding answers False
}

// W = 4, 8, 16, 32, routed, for a slot that owns only some shards:
// owned-key compaction. Each thread routes kRouteKeys keys of the block's
// tile (kThreads * kRouteKeys keys); a key the slot does not own, and
// padding, answer False at once. The owned keys' tile indices and local
// shards are listed in shared memory (a ballot a warp, one shared
// counter), and the block then runs query_warp over that list on full
// warps, so that its hashing, gathers and tests scale with the keys the
// slot owns. The list's order is the counter's, which does not matter:
// each verdict is written at its key's index.
constexpr int kRouteKeys = 2;

template <int W>
__global__ void __launch_bounds__(kThreads)
sharded_blocked_query_row_kernel(const uint32_t* __restrict__ state,
                                 const uint8_t* __restrict__ keys,
                                 const int32_t* __restrict__ lengths,
                                 uint8_t* __restrict__ out, int64_t B, int L,
                                 BlockSpec s, RouteSpec route) {
  constexpr int kTile = kThreads * kRouteKeys;
  __shared__ __align__(16) uint32_t stage[kThreads * (W + 4)];
  __shared__ uint16_t list_key[kTile];
  __shared__ uint32_t list_local[kTile];
  __shared__ int n_owned;
  const int lane = threadIdx.x & 31;
  const int64_t tile = (int64_t)blockIdx.x * kTile;
  if (threadIdx.x == 0) n_owned = 0;
  __syncthreads();
  for (int r = 0; r < kRouteKeys; ++r) {
    const int t = r * kThreads + threadIdx.x;
    const int64_t i = tile + t;
    const int len = i < B ? lengths[i] : -1;
    const int64_t local =
        len >= 0 ? route_key(reinterpret_cast<const uint32_t*>(keys + i * L), L / 4,
                             len, s.seed, route)
                 : -1;
    const bool own = local >= 0;
    if (i < B && !own) out[i] = 0;
    const unsigned owners = __ballot_sync(kFullMask, own);
    int at = 0;
    if (lane == 0 && owners) at = atomicAdd(&n_owned, __popc(owners));
    at = __shfl_sync(kFullMask, at, 0) + __popc(owners & ((1u << lane) - 1u));
    if (own) {
      list_key[at] = (uint16_t)t;
      list_local[at] = (uint32_t)local;
    }
  }
  __syncthreads();
  const int n = n_owned;
  uint32_t* warp_stage = stage + (threadIdx.x & ~31) * (W + 4);
  for (int at = 0; at < n; at += kThreads) {
    if (at + (int)(threadIdx.x & ~31) >= n) break;  // the warp has no key left
    LaneKey mine{false, 0, KeyHash{0, 0u, 0u, 0u}};
    int64_t i = -1;
    if (at + (int)threadIdx.x < n) {
      i = tile + list_key[at + threadIdx.x];
      mine = key_at(keys, i, L, lengths[i], W,
                    (uint64_t)list_local[at + threadIdx.x] * s.n_blocks, s);
    }
    const bool hit = query_warp<W>(mine, state, warp_stage, s);
    if (i >= 0) out[i] = hit ? 1 : 0;
  }
}

// Any W (a multiple of 4; block_bits up to 4096): only the 16-byte chunks
// of the row that the key's bits touch are loaded.
template <bool kRouted>
__global__ void __launch_bounds__(kThreads)
blocked_query_chunk_kernel(const uint32_t* __restrict__ state,
                           const uint8_t* __restrict__ keys,
                           const int32_t* __restrict__ lengths,
                           uint8_t* __restrict__ out, int64_t B, int L, int W,
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
    if (local < 0) {
      out[i] = 0;
      return;
    }
    base = (uint64_t)local * s.n_blocks;
  }
  const KeyHash h = hash_key(kw, L / 4, len, s);
  const uint4* row = reinterpret_cast<const uint4*>(state + (base + h.blk) * W);
  bool hit = true;
  for (int c = 0; c < W / 4 && hit; ++c) {
    uint32_t m0 = 0u, m1 = 0u, m2 = 0u, m3 = 0u;
    for (int j = 0; j < s.k; ++j) {
      const uint32_t b = inblock_bit(j, h, s);
      if ((int)(b >> 7) != c) continue;
      const uint32_t one = 1u << (b & 31);
      switch ((b >> 5) & 3u) {
        case 0: m0 |= one; break;
        case 1: m1 |= one; break;
        case 2: m2 |= one; break;
        default: m3 |= one; break;
      }
    }
    if ((m0 | m1 | m2 | m3) == 0u) continue;
    const uint4 r = __ldg(row + c);
    hit = (r.x & m0) == m0 && (r.y & m1) == m1 && (r.z & m2) == m2 &&
          (r.w & m3) == m3;
  }
  out[i] = hit ? 1 : 0;
}

// ---------------------------------------------------------------------------
// blocked_insert
//
// Replaces the TPU insert sweep K3, `_fat_kernel` / `fat_sweep_insert`
// (tpubloom/ops/sweep.py:1463, driven by `apply_fat_updates`). The TPU
// sorts the batch, streams every partition of the array through VMEM and
// merges duplicate blocks with one-hot matmuls, because its HBM cannot do
// random read-modify-writes. Hopper can: each key ORs its mask into its
// one row with atomicOr, in place. OR is commutative and idempotent, so
// keys that share a block need no sort and no merge, and the result does
// not depend on the order of the atomics. The state is updated in place,
// where tpubloom's insert donates its buffer to the jitted step
// (filter.py, `donate_argnums=0`).
//
// Test-and-insert is blocked_query then blocked_insert on the same stream:
// a single pass that read and then ORed would let a later key in the same
// block see an earlier key's bits, and the contract is that every key of a
// batch reports the state before the batch.
//
// Bound: bytes. Per key L + 4 input bytes; each touched row is read once
// and written once. At the main path's shapes (m = 2^32, W = 16, B = 2^23,
// ~5.30 M distinct rows) that is ~0.85 GB, ~0.25 ms at 3.35 TB/s. The
// atomics execute in L2, so the rate of L2 requests is the floor to
// design for. A key's k = 7 bits touch 16 (1 - (15/16)^7) = ~5.82 distinct
// words of its row, but only 2 (1 - 2^-7) = ~1.98 of its two 32-byte
// sectors. With one thread a key (the first design) the 32 lanes of an
// atomic instruction hit 32 unrelated rows, so each word was a request of
// its own: ~5.82 a key, ~48.8 M a launch.
//
// Hence a lane group per key. Each lane loads and hashes one key (hash
// once a key), computes its k positions and ORs them into its row's mask,
// staged in shared memory ([threads][W + 4] words: 16-byte rows,
// staggered so that the 16-byte zeroing stores of 8 lanes hit distinct
// banks). A ballot of the lanes that hold a key to update is the warp's
// work list (a routed slot lists only the keys it owns, so it pays
// nothing for the others). The warp then walks the list with G = W lanes a
// key, 32 / W keys a step: the key's row offset comes from its lane by
// __shfl_sync, lane t of the group reads word t of the staged mask and
// issues atomicOr on word t of the row when it is not 0. A key's atomics
// leave in one instruction, on neighbouring addresses, ~1.98 sectors a
// key. Staging the mask keeps the position arithmetic at once a key: a
// group that recomputed all k positions in every lane from the broadcast
// hash pool would spend ~20 integer operations a position a lane, ~1,100
// lane operations a key at W = 16, about the time of the memory bound.
//
// W = 64 and 128 (block_bits 2048, 4096; the staging would not fit 48 KB)
// take blocked_insert_wide_kernel: 32 lanes a key, lane t owns words t,
// t + 32, ...; the key's row offset and hash pool are broadcast and each
// lane computes the k positions itself.
//
// sharded_blocked_insert (kRouted = true) replaces K1, `_kernel` /
// `sweep_insert` (tpubloom/ops/sweep.py:241, driven by
// `apply_blocked_updates`), where the TPU runs it: the per-device loop of
// the sharded filter array (tpubloom/parallel/sharded.py:282,292), and the
// fat K3 there (:274). The TPU routes the replicated batch, sorts the owned
// keys and sweeps the device's block rows. Here each lane routes its key
// first; a key the slot does not own costs one murmur3 and never enters
// the work list. Row offsets are 64-bit ((local * n_blocks_per_shard +
// blk) * W): at BASELINE config 5 one slot holds 2^31 words (8 GiB).
// Bound: bytes, as above, over the owned keys' distinct rows; at config 5
// (B = 2^23 over 2^27 blocks, lambda = 1/16) ~8.1 M rows, ~1.2 GB,
// ~0.36 ms at 3.35 TB/s.
// ---------------------------------------------------------------------------

// W = 4, 8, 16, 32: a group of W lanes a key, the masks staged.
template <int W, bool kRouted>
__global__ void __launch_bounds__(kThreads)
blocked_insert_row_kernel(uint32_t* __restrict__ state,
                          const uint8_t* __restrict__ keys,
                          const int32_t* __restrict__ lengths, int64_t B,
                          int L, BlockSpec s, RouteSpec route) {
  constexpr int kStride = W + 4;
  __shared__ __align__(16) uint32_t stage[kThreads * kStride];
  const LaneKey mine = lane_key<kRouted>(keys, lengths, B, L, W, s, route);
  if (mine.valid) {
    uint32_t* m = stage + threadIdx.x * kStride;
#pragma unroll
    for (int c = 0; c < W / 4; ++c)
      reinterpret_cast<uint4*>(m)[c] = make_uint4(0u, 0u, 0u, 0u);
    for (int j = 0; j < s.k; ++j) {
      const uint32_t b = inblock_bit(j, mine.h, s);
      m[b >> 5] |= 1u << (b & 31);
    }
  }
  __syncwarp();
  const int lane = threadIdx.x & 31, sub = lane % W;
  const uint32_t* warp_stage = stage + (threadIdx.x - lane) * kStride;
  for (unsigned list = __ballot_sync(kFullMask, mine.valid); list;
       list = next_step<32 / W>(list)) {
    const int src = nth_lane<32 / W>(list, lane / W);
    const uint64_t row = __shfl_sync(kFullMask, mine.row, src < 0 ? 0 : src);
    if (src >= 0) {
      const uint32_t m = warp_stage[src * kStride + sub];
      if (m) atomicOr(state + row + sub, m);
    }
  }
}

// W = 64, 128: 32 lanes a key, kWideWords words a lane at most.
constexpr int kWideWords = 4;  // block_bits <= 4096

template <bool kRouted>
__global__ void __launch_bounds__(kThreads)
blocked_insert_wide_kernel(uint32_t* __restrict__ state,
                           const uint8_t* __restrict__ keys,
                           const int32_t* __restrict__ lengths, int64_t B,
                           int L, int W, BlockSpec s, RouteSpec route) {
  const LaneKey mine = lane_key<kRouted>(keys, lengths, B, L, W, s, route);
  const uint32_t lane = threadIdx.x & 31;
  for (unsigned list = __ballot_sync(kFullMask, mine.valid); list;
       list &= list - 1u) {
    const LaneKey key = shfl_key(mine, __ffs(list) - 1);
    uint32_t m[kWideWords];
#pragma unroll
    for (int u = 0; u < kWideWords; ++u) m[u] = 0u;
    for (int j = 0; j < s.k; ++j) {
      const uint32_t b = inblock_bit(j, key.h, s), w = b >> 5, one = 1u << (b & 31);
#pragma unroll
      for (int u = 0; u < kWideWords; ++u) m[u] |= (w == lane + 32u * u) ? one : 0u;
    }
#pragma unroll
    for (int u = 0; u < kWideWords; ++u)
      if (m[u]) atomicOr(state + key.row + lane + 32u * u, m[u]);
  }
}

inline BlockSpec make_spec(int64_t n_blocks, int block_bits, int k,
                           uint32_t seed, int chunk) {
  BlockSpec s;
  s.n_blocks = (uint64_t)n_blocks;
  s.block_bits = block_bits;
  s.log2_bits = 0;
  while ((1 << s.log2_bits) < block_bits) ++s.log2_bits;
  s.k = k;
  s.seed = seed;
  s.chunk = chunk;
  return s;
}

inline unsigned grid_for(int64_t B) {
  return (unsigned)((B + kThreads - 1) / kThreads);
}

template <bool kRouted>
int launch_query(const void* state, const void* keys, const void* lengths,
                 void* out, int64_t B, int L, const BlockSpec& s,
                 const RouteSpec& r, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int W = s.block_bits / 32;
  auto st = static_cast<const uint32_t*>(state);
  auto ky = static_cast<const uint8_t*>(keys);
  auto ln = static_cast<const int32_t*>(lengths);
  auto o = static_cast<uint8_t*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_for(B);
  if (kRouted && r.shards_per_dev != (int64_t)r.n_shards && W <= 32) {
    const unsigned gr = (unsigned)((B + kThreads * kRouteKeys - 1) / (kThreads * kRouteKeys));
    switch (W) {
      case 4: sharded_blocked_query_row_kernel<4><<<gr, kThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
      case 8: sharded_blocked_query_row_kernel<8><<<gr, kThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
      case 16: sharded_blocked_query_row_kernel<16><<<gr, kThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
      default: sharded_blocked_query_row_kernel<32><<<gr, kThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
    }
  } else {
    switch (W) {
      case 4: blocked_query_row_kernel<4, kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
      case 8: blocked_query_row_kernel<8, kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
      case 16: blocked_query_row_kernel<16, kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
      case 32: blocked_query_row_kernel<32, kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, o, B, L, s, r); break;
      default: blocked_query_chunk_kernel<kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, o, B, L, W, s, r); break;
    }
  }
  return (int)cudaGetLastError();
}

template <bool kRouted>
int launch_insert(void* state, const void* keys, const void* lengths,
                  int64_t B, int L, const BlockSpec& s, const RouteSpec& r,
                  void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int W = s.block_bits / 32;
  auto st = static_cast<uint32_t*>(state);
  auto ky = static_cast<const uint8_t*>(keys);
  auto ln = static_cast<const int32_t*>(lengths);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const unsigned g = grid_for(B);
  switch (W) {
    case 4: blocked_insert_row_kernel<4, kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, B, L, s, r); break;
    case 8: blocked_insert_row_kernel<8, kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, B, L, s, r); break;
    case 16: blocked_insert_row_kernel<16, kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, B, L, s, r); break;
    case 32: blocked_insert_row_kernel<32, kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, B, L, s, r); break;
    default: blocked_insert_wide_kernel<kRouted><<<g, kThreads, 0, cs>>>(st, ky, ln, B, L, W, s, r); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t. Each returns cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

extern "C" int tpb_blocked_query(const void* state, const void* keys,
                                 const void* lengths, void* out, int64_t B,
                                 int L, int64_t n_blocks, int block_bits,
                                 int k, uint32_t seed, int chunk,
                                 void* stream) {
  using namespace tpubloom;
  return launch_query<false>(state, keys, lengths, out, B, L,
                             make_spec(n_blocks, block_bits, k, seed, chunk),
                             RouteSpec{}, stream);
}

extern "C" int tpb_blocked_insert(void* state, const void* keys,
                                  const void* lengths, int64_t B, int L,
                                  int64_t n_blocks, int block_bits, int k,
                                  uint32_t seed, int chunk, void* stream) {
  using namespace tpubloom;
  return launch_insert<false>(state, keys, lengths, B, L,
                              make_spec(n_blocks, block_bits, k, seed, chunk),
                              RouteSpec{}, stream);
}

// The routed entries: `state` is one slot's shards, `n_blocks` the block
// count of one shard, and the slot holds shards [shard_lo, shard_lo +
// shards_per_dev) of n_shards.
extern "C" int tpb_sharded_blocked_query(const void* state, const void* keys,
                                         const void* lengths, void* out,
                                         int64_t B, int L, int64_t n_blocks,
                                         int block_bits, int k, uint32_t seed,
                                         int chunk, int64_t n_shards,
                                         int64_t shard_lo,
                                         int64_t shards_per_dev,
                                         void* stream) {
  using namespace tpubloom;
  return launch_query<true>(state, keys, lengths, out, B, L,
                            make_spec(n_blocks, block_bits, k, seed, chunk),
                            make_route(n_shards, shard_lo, shards_per_dev),
                            stream);
}

extern "C" int tpb_sharded_blocked_insert(void* state, const void* keys,
                                          const void* lengths, int64_t B,
                                          int L, int64_t n_blocks,
                                          int block_bits, int k, uint32_t seed,
                                          int chunk, int64_t n_shards,
                                          int64_t shard_lo,
                                          int64_t shards_per_dev,
                                          void* stream) {
  using namespace tpubloom;
  return launch_insert<true>(state, keys, lengths, B, L,
                             make_spec(n_blocks, block_bits, k, seed, chunk),
                             make_route(n_shards, shard_lo, shards_per_dev),
                             stream);
}
