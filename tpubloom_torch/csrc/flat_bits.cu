// Partitioned flat bit insert for Hopper (sm_90a), for a batch whose
// positions cover much of the state. The batch's bit positions are placed
// in the segments of their tiles (flat_partition.cuh, at 32 bits a word),
// and each tile's mask is then built in shared memory and ORed into the
// state once a word, instead of one random L2 request a position.
//
// Replaces, as flat_bloom.cu's thread-a-key flat_insert does (the same
// words, bit for bit): make_insert_fn + bitops.scatter_or
// (tpubloom/filter.py:51-69, tpubloom/ops/bitops.py:75); the routed twin
// the local insert of make_sharded_insert_fn (tpubloom/parallel/sharded.py:
// 139-161). tpubloom sorts the batch's (word, mask) pairs, OR-scans each
// run and scatters its last; here a partition by tile is enough, because
// OR is commutative and idempotent: the order of a tile's entries, and how
// they are split across CTAs, cannot change the words.
//
// Why: the thread-a-key insert issues one atomicOr a position to a random
// 32-byte sector. At BASELINE config 2 (m = 2^30 bits, k = 10, B = 2^20)
// the 10.5 M positions land on 3.85 M of the 4.19 M sectors of the 128 MiB
// state, at ~17 G atomics/s (0.615 ms): the launch touches 92 % of the state
// anyway, one request at a time. Here each touched sector gets one
// reduction request, from a warp's 32 consecutive words.
//
// Six launches on the caller's stream: the five passes of
// flat_partition.cuh (no probe), then tile_insert_kernel, one CTA a piece
// of a tile's segment:
//   1. it zeroes a 64 KiB mask tile in shared memory;
//   2. it ORs each of its entries' bits into that tile (a shared-memory
//      atomicOr);
//   3. it walks the tile's words and ORs each non-zero mask word into the
//      state with one global atomicOr whose result is unused (a
//      red.global.or.b32): a warp's 32 consecutive words are four whole
//      sectors, one L2 request each.
// A piece that shares its tile with other pieces (a crowd of one key over
// much of the batch makes such tiles) does exactly the same: the global
// ORs of two pieces commute. There is no staging of the state, no
// write-back of unchanged words, and no count tile. A piece of
// kSparseEntries entries or fewer ORs its entries into the state one by one,
// as the thread-a-key kernel does.
//
// Tiles are 2^14 words, 2^19 bits (2,048 tiles at m = 2^30); an entry is
// its bit's index in the tile (19 bits). The plan refuses a state of 2^32
// bits or more (a u32 entry) and more than 2^14 tiles. Scratch at config 2,
// sized for B k entries: two entry buffers of 4 B an entry (2 x 42 MB) and
// the count matrix (4 B a (chunk, tile): 4.2 MB at 512 chunks).
//
// Small batches keep flat_bloom.cu's flat_insert: a batch of 10 K keys
// would pay for two passes over the keys and a CTA for every tile it
// touches. The wrapper (ops/sweep.py flat_takes_tiles) picks this kernel
// when the batch's expected positions (a routed slot: its owned share)
// reach FLAT_BIT_TILE_CROSSOVER a 32-byte sector of the state (from
// chip_smoke.py's flat_crossover phase) and the plan holds the launch.
//
// Bound at config 2, as for the thread-a-key kernel: each key's 20 input
// bytes and the launch's distinct sectors, read and written back: 0.080 ms.
// The design's own floor: the keys read twice, 2 x 42 MB of entries written
// and read, and the touched sectors read and written: ~0.46 GB, 0.14 ms.
//
// Built by tpubloom_torch/ops/_build.py like flat_bloom.cu; each entry
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns the first launch error (cudaErrorInvalidValue for a shape the
// plan refuses or a scratch smaller than the plan's).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"
#include "flat_partition.cuh"

namespace tpubloom {

__global__ void __launch_bounds__(kSweepThreads)
tile_insert_kernel(uint32_t* __restrict__ state, const uint32_t* __restrict__ tile_start,
                   const uint32_t* __restrict__ piece_start,
                   const uint32_t* __restrict__ piece_tile,
                   const uint32_t* __restrict__ entries, TilePlan g) {
  extern __shared__ __align__(16) uint32_t tile[];
  Piece pc;
  if (!sweep_piece(tile_start, piece_start, piece_tile, g, pc)) return;
  uint32_t* words = state + pc.w0;
  if (pc.e1 - pc.e0 <= kSparseEntries) {
    for (uint32_t e = pc.e0 + threadIdx.x; e < pc.e1; e += blockDim.x) {
      const uint32_t x = entries[e];
      atomicOr(words + (x >> 5), 1u << (x & 31u));
    }
    return;
  }
  // m / 32 words need not be a multiple of 4: zero the last 16 bytes whole
  // (the tile holds 2^kTileLog2 words) and apply only the tile's nw words
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  const int n4 = (pc.nw + 3) >> 2;
  for (int v = threadIdx.x; v < n4; v += blockDim.x) tile4[v] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (uint32_t e = pc.e0 + threadIdx.x; e < pc.e1; e += kSweepUnroll * kSweepThreads) {
    uint32_t x[kSweepUnroll];
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      const uint32_t f = e + u * kSweepThreads;
      x[u] = f < pc.e1 ? __ldcs(entries + f) : kNoEntry;
    }
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u)
      if (x[u] != kNoEntry) atomicOr(tile + (x[u] >> 5), 1u << (x[u] & 31u));
  }
  __syncthreads();
  for (int w = threadIdx.x; w < pc.nw; w += blockDim.x) {
    const uint32_t mask = tile[w];
    if (mask) atomicOr(words + w, mask);
  }
}

template <bool kRouted>
int launch_tiled_insert(void* state, const void* keys, const void* lengths, int64_t B, int L,
                        int64_t m, int k, uint32_t seed, const RouteSpec& r, void* scratch,
                        int64_t scratch_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  TilePlan g;
  int err = launch_plan<kBitLog2, kRouted>(B, m, k, false, r, scratch_bytes, &g);
  if (err) return err;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Scratch x = scratch_at(scratch, g);
  err = launch_partition<kBitLog2, kRouted, false>(nullptr, keys, lengths, nullptr, B, L,
                                                   make_flat_spec(m, k, seed), r, g, x, cs);
  if (err) return err;
  const int tile_bytes = (int)sizeof(uint32_t) << kTileLog2;
  cudaFuncSetAttribute(tile_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       tile_bytes);
  tile_insert_kernel<<<g.sweep_grid, kSweepThreads, tile_bytes, cs>>>(
      static_cast<uint32_t*>(state), x.tile_start, x.piece_start, x.piece_tile,
      static_cast<const uint32_t*>(x.entries), g);
  return (int)cudaGetLastError();
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes), beside flat_bloom.cu's tpb_flat_insert with
// the same leading arguments. `scratch` is device memory of at least
// tpb_flat_bits_tiled_scratch_bytes(B, k, n_words) bytes, where n_words is
// the state's words (m / 32, or a routed slot's shards_per_dev * m / 32).
// ---------------------------------------------------------------------------

// The scratch of a partitioned insert, or -1 where the partition cannot
// hold the shape (the wrapper then keeps the thread-a-key kernel).
extern "C" int64_t tpb_flat_bits_tiled_scratch_bytes(int64_t B, int k, int64_t n_words) {
  tpubloom::TilePlan g;
  return tpubloom::make_tile_plan(B, k, n_words, tpubloom::kBitLog2, false, &g) ? g.scratch_bytes
                                                                               : -1;
}

extern "C" int tpb_flat_insert_tiled(void* state, const void* keys, const void* lengths,
                                     int64_t B, int L, int64_t m, int k, uint32_t seed,
                                     void* scratch, int64_t scratch_bytes, void* stream) {
  using namespace tpubloom;
  return launch_tiled_insert<false>(state, keys, lengths, B, L, m, k, seed, RouteSpec{},
                                    scratch, scratch_bytes, stream);
}

extern "C" int tpb_sharded_flat_insert_tiled(void* state, const void* keys, const void* lengths,
                                             int64_t B, int L, int64_t m, int k, uint32_t seed,
                                             int64_t n_shards, int64_t shard_lo,
                                             int64_t shards_per_dev, void* scratch,
                                             int64_t scratch_bytes, void* stream) {
  using namespace tpubloom;
  return launch_tiled_insert<true>(state, keys, lengths, B, L, m, k, seed,
                                   make_route(n_shards, shard_lo, shards_per_dev), scratch,
                                   scratch_bytes, stream);
}
