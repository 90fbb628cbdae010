// Partitioned flat counting kernels for Hopper (sm_90a): the update and the
// query of the flat 4-bit counters for a batch whose positions cover much
// of the state. Each counter position of the batch is placed in the segment
// of its tile (a fixed run of counter words; flat_partition.cuh), and each
// tile's segment is then applied on chip, instead of one random L2 request
// a position.
//
// Replaces, as flat_bloom.cu's thread-a-key kernels do (the same function,
// bit for bit): make_counter_fn + counting.counter_update
// (tpubloom/filter.py:86-101, tpubloom/ops/counting.py:36-90) and
// make_counting_query_fn + counting.counting_membership (filter.py:104-113,
// counting.py:92-95); the routed twins the local update and query of
// make_sharded_counter_fn / make_sharded_counting_query_fn
// (tpubloom/parallel/sharded.py:394-440). tpubloom groups by place too: it
// sorts the batch's positions (lax.sort) and runs a two-level segmented
// scan. Here a partition by tile is enough, because the order of the
// entries inside a tile does not matter (see tile_update_kernel).
//
// Why: a thread-a-key kernel gives each of a key's k positions its own
// request to a random 32-byte sector (k random sectors a key; grouping by
// key cannot help). At BASELINE config 4 (m = 2^30 counters, k = 7, B =
// 2^22) the 29.4 M positions fall on 13.9 M of the 16.8 M sectors of the
// 512 MiB state, so the launch touches 83 % of it anyway, at the card's
// rate of random requests (the update: an __ldcg and a CAS a position, 11.3
// G positions/s, 2.6 ms). Streaming every touched tile through shared
// memory once costs bandwidth instead: ~1.2 GB moved, ~0.36 ms at 3.35
// TB/s (the tiles read and written, the entries written and read, the keys
// read twice).
//
// Six launches on the caller's stream: the five passes of
// flat_partition.cuh at 8 counters a word (kCounterLog2; the query's count
// pass probes each key's position-0 counter, and a key at 0 places
// nothing), then the sweep, one CTA a piece of a tile's segment:
//   - tile_update_kernel, where the CTA is its tile's only piece, stages
//     the tile in shared memory (cp.async, the whole tile in flight),
//     applies each entry's saturating step there (the thread-a-key
//     kernel's CAS loop, counter_step_from) and writes the tile back;
//     where pieces share a tile (a crowd of one key over much of the
//     batch makes such tiles), it counts its entries in a shared-memory
//     tile of nibbles (how many entries hit each counter, to 15) and
//     applies each word's counts to the state once, with a CAS loop
//     (v + min(c, 15 - v), or v - min(c, v));
//   - tile_query_kernel stages the tile in shared memory (cp.async) and
//     stores out[key] = 0 for each entry whose nibble is 0 (idempotent,
//     so order does not matter). Without the probe every absent key
//     placed its k entries and stored a verdict byte for each zero
//     counter: ~28.6 M random byte stores at config 4 flat, which made
//     the query on absent keys 1.10 ms against the thread-a-key 0.92
//     (NVIDIA H100 80GB HBM3, 700 W). In a filter at config 4's fill
//     the probe answers nearly every absent key, which then places and
//     stores nothing;
//   - a piece of kSparseEntries entries or fewer skips shared memory:
//     the update applies each entry with the thread-a-key kernel's CAS
//     step (counter_step), the query reads its nibble from the state.
//
// At 2^14 counter words a tile there are 8,192 tiles at m = 2^30, and an
// entry's index in its tile fits 17 bits. Scratch at config 4 flat, sized
// for B k entries: two entry buffers (by bucket, then by tile) of 4 B an
// entry for the update (2 x 117 MB), 8 B for the query (2 x 235 MB), and
// the 8.7 MB count matrix.
//
// Small batches keep the thread-a-key kernels of flat_bloom.cu: a delete of
// 2^16 keys (0.46 M positions) would pay for two passes over the keys and
// a CTA for every tile they touch. The wrapper picks the partitioned
// kernels when the batch's expected positions (a routed slot: its owned
// share) reach a crossover number of the state's 32-byte sectors
// (FLAT_TILE_CROSSOVER, FLAT_TILE_QUERY_CROSSOVER in ops/sweep.py, from
// chip_smoke.py's flat_crossover phase) and the plan can hold the launch.
//
// Bound at config 4 flat, as for the thread-a-key kernels: each key's 20
// input bytes and the launch's distinct sectors, read and (update) written
// back: 0.29 ms for the update, 0.16 ms for the query. The design's own
// floor is the ~1.2 GB above.
//
// Built by tpubloom_torch/ops/_build.py like flat_bloom.cu; each entry
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns the first launch error (cudaErrorInvalidValue for a shape the
// plan refuses or a scratch smaller than the plan's).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"
#include "flat_partition.cuh"

namespace tpubloom {

constexpr int kApplyUnroll = 4;  // 16-byte state loads in flight a thread, applying counts

// Word `old` with each nibble n moved by its count c = nibble n of d: +min(c,
// 15 - v) (increment) or -min(c, v).
__device__ __forceinline__ uint32_t apply_counts(uint32_t old, uint32_t d, int increment) {
  uint32_t out = old;
#pragma unroll
  for (int sh = 0; sh < 32; sh += 4) {
    const uint32_t c = (d >> sh) & 15u, v = (old >> sh) & 15u;
    const uint32_t nv = increment ? v + min(c, 15u - v) : v - min(c, v);
    out = (out & ~(15u << sh)) | (nv << sh);
  }
  return out;
}

// Update. Why the result equals tpubloom's: tpubloom moves each distinct
// counter by its multiplicity c in the batch, clamped once against the
// pre-batch value v: v + min(c, 15 - v), or v - min(c, v). A batch has one
// sign, and saturating moves of one sign compose: moving by c1, then by c2,
// each clamped, lands on the move by c1 + c2 clamped once. So the entries
// may arrive in any order, in any split across CTAs: a lone piece applies
// single steps to its staged tile, and a sparse piece to the state
// (counter_step); pieces that share a tile count their entries a counter
// (shared-memory nibbles saturating at 15, which loses nothing, as v moves
// 15 at most) and apply the counts clamped with a CAS loop, so that each
// application is whole. Within a tile the counts of two of a key's
// positions that coincide add, as tpubloom counts them twice.

__global__ void __launch_bounds__(kSweepThreads)
tile_update_kernel(uint32_t* __restrict__ state, const uint32_t* __restrict__ tile_start,
                   const uint32_t* __restrict__ piece_start,
                   const uint32_t* __restrict__ piece_tile,
                   const uint32_t* __restrict__ entries, TilePlan g, int increment) {
  extern __shared__ __align__(16) uint32_t tile[];
  Piece pc;
  if (!sweep_piece(tile_start, piece_start, piece_tile, g, pc)) return;
  uint32_t* words = state + pc.w0;
  const uint32_t n = pc.e1 - pc.e0;
  if (n <= kSparseEntries) {
    for (uint32_t e = pc.e0 + threadIdx.x; e < pc.e1; e += blockDim.x) {
      const uint32_t x = entries[e];
      counter_step(words + (x >> 3), 4 * (int)(x & 7u), increment);
    }
    return;
  }
  const int n4 = pc.nw >> 2;  // nw % 4 == 0
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  uint4* words4 = reinterpret_cast<uint4*>(words);
  const bool staged = pc.alone;  // else counts, applied with CASes
  if (staged) {  // the whole tile in flight at once
    for (int v = threadIdx.x; v < n4; v += blockDim.x) __pipeline_memcpy_async(tile4 + v, words4 + v, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    for (int v = threadIdx.x; v < n4; v += blockDim.x) tile4[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // staged: each entry's step on the tile; else each entry counted in the
  // tile's nibbles, to 15
  const int step = staged ? increment : 1;
  for (uint32_t e = pc.e0 + threadIdx.x; e < pc.e1; e += kSweepUnroll * kSweepThreads) {
    uint32_t x[kSweepUnroll];
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      const uint32_t f = e + u * kSweepThreads;
      x[u] = f < pc.e1 ? __ldcs(entries + f) : kNoEntry;
    }
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      if (x[u] == kNoEntry) continue;
      uint32_t* cw = tile + (x[u] >> 3);
      counter_step_from(cw, *(volatile uint32_t*)cw, 4 * (int)(x[u] & 7u), step);
    }
  }
  __syncthreads();
  if (staged) {
    for (int v = threadIdx.x; v < n4; v += blockDim.x) __stcg(words4 + v, tile4[v]);
    return;
  }
  // apply the counts with a CAS loop a word (other pieces share the tile):
  // only the 4-word groups with counts are read, kApplyUnroll loads of a
  // thread issued before their CASes
  for (int v0 = threadIdx.x; v0 < n4; v0 += kApplyUnroll * kSweepThreads) {
    uint4 d[kApplyUnroll], old[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const int v = v0 + u * kSweepThreads;
      d[u] = v < n4 ? tile4[v] : make_uint4(0u, 0u, 0u, 0u);
      old[u] = (d[u].x | d[u].y | d[u].z | d[u].w) ? __ldcg(words4 + v) : d[u];
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      if (!(d[u].x | d[u].y | d[u].z | d[u].w)) continue;
      const int v = v0 + u * kSweepThreads;
      const uint32_t dw[4] = {d[u].x, d[u].y, d[u].z, d[u].w};
      const uint32_t ow[4] = {old[u].x, old[u].y, old[u].z, old[u].w};
      for (int c = 0; c < 4; ++c) {
        if (!dw[c]) continue;
        uint32_t* sw = words + 4 * v + c;
        uint32_t cur = ow[c];
        for (;;) {
          const uint32_t nv = apply_counts(cur, dw[c], increment);
          if (nv == cur) break;
          const uint32_t seen = atomicCAS(sw, cur, nv);
          if (seen == cur) break;
          cur = seen;
        }
      }
    }
  }
}

// Query: out[key] = 0 for each entry whose counter is 0. The state is only
// read, so pieces of one tile each stage it.

__global__ void __launch_bounds__(kSweepThreads)
tile_query_kernel(const uint32_t* __restrict__ state, const uint32_t* __restrict__ tile_start,
                  const uint32_t* __restrict__ piece_start,
                  const uint32_t* __restrict__ piece_tile, const uint2* __restrict__ entries,
                  uint8_t* __restrict__ out, TilePlan g) {
  extern __shared__ __align__(16) uint32_t tile[];
  Piece pc;
  if (!sweep_piece(tile_start, piece_start, piece_tile, g, pc)) return;
  const uint32_t* words = state + pc.w0;
  if (pc.e1 - pc.e0 <= kSparseEntries) {
    for (uint32_t e = pc.e0 + threadIdx.x; e < pc.e1; e += blockDim.x) {
      const uint2 x = entries[e];
      if (((__ldg(words + (x.x >> 3)) >> (4 * (x.x & 7u))) & 15u) == 0u) out[x.y] = 0;
    }
    return;
  }
  for (int w = 4 * threadIdx.x; w < pc.nw; w += 4 * kSweepThreads)  // nw % 4 == 0
    __pipeline_memcpy_async(tile + w, words + w, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (uint32_t e = pc.e0 + threadIdx.x; e < pc.e1; e += kSweepUnroll * kSweepThreads) {
    uint2 x[kSweepUnroll];
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      const uint32_t f = e + u * kSweepThreads;
      x[u] = f < pc.e1 ? __ldcs(entries + f) : make_uint2(kNoEntry, 0u);
    }
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u)
      if (x[u].x != kNoEntry && ((tile[x[u].x >> 3] >> (4 * (x[u].x & 7u))) & 15u) == 0u)
        out[x[u].y] = 0;
  }
}

// ---------------------------------------------------------------------------
// Launch: the partition, then the sweep, in stream order.
// ---------------------------------------------------------------------------

template <bool kRouted>
int launch_tiled_update(void* state, const void* keys, const void* lengths, int64_t B, int L,
                        int64_t m, int k, uint32_t seed, int increment, const RouteSpec& r,
                        void* scratch, int64_t scratch_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  TilePlan g;
  int err = launch_plan<kCounterLog2, kRouted>(B, m, k, false, r, scratch_bytes, &g);
  if (err) return err;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Scratch x = scratch_at(scratch, g);
  err = launch_partition<kCounterLog2, kRouted, false>(nullptr, keys, lengths, nullptr, B, L,
                                                       make_flat_spec(m, k, seed), r, g, x, cs);
  if (err) return err;
  const int tile_bytes = (int)sizeof(uint32_t) << kTileLog2;
  cudaFuncSetAttribute(tile_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       tile_bytes);
  tile_update_kernel<<<g.sweep_grid, kSweepThreads, tile_bytes, cs>>>(
      static_cast<uint32_t*>(state), x.tile_start, x.piece_start, x.piece_tile,
      static_cast<const uint32_t*>(x.entries), g, increment);
  return (int)cudaGetLastError();
}

template <bool kRouted>
int launch_tiled_query(const void* state, const void* keys, const void* lengths, void* out,
                       int64_t B, int L, int64_t m, int k, uint32_t seed, const RouteSpec& r,
                       void* scratch, int64_t scratch_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  TilePlan g;
  int err = launch_plan<kCounterLog2, kRouted>(B, m, k, true, r, scratch_bytes, &g);
  if (err) return err;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Scratch x = scratch_at(scratch, g);
  err = launch_partition<kCounterLog2, kRouted, true>(state, keys, lengths, out, B, L,
                                                      make_flat_spec(m, k, seed), r, g, x, cs);
  if (err) return err;
  const int tile_bytes = (int)sizeof(uint32_t) << kTileLog2;
  cudaFuncSetAttribute(tile_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       tile_bytes);
  tile_query_kernel<<<g.sweep_grid, kSweepThreads, tile_bytes, cs>>>(
      static_cast<const uint32_t*>(state), x.tile_start, x.piece_start, x.piece_tile,
      static_cast<const uint2*>(x.entries), static_cast<uint8_t*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes), beside flat_bloom.cu's thread-a-key entries
// with the same leading arguments. `scratch` is device memory of at least
// tpb_flat_counting_tiled_scratch_bytes(B, k, n_words, query) bytes, where
// n_words is the state's counter words (m / 8, or a routed slot's
// shards_per_dev * m / 8).
// ---------------------------------------------------------------------------

// The scratch of a partitioned launch, or -1 where the partition cannot hold
// the shape (the wrapper then keeps the thread-a-key kernel).
extern "C" int64_t tpb_flat_counting_tiled_scratch_bytes(int64_t B, int k, int64_t n_words,
                                                         int query) {
  tpubloom::TilePlan g;
  return tpubloom::make_tile_plan(B, k, n_words, tpubloom::kCounterLog2, query != 0, &g)
             ? g.scratch_bytes
             : -1;
}

// The partition's tile (log2 of its counter words) and piece (the most
// entries a sweep CTA takes), for records of what a launch's keys put in
// the tiles.
extern "C" int tpb_flat_counting_tile_log2(void) { return tpubloom::kTileLog2; }
extern "C" int64_t tpb_flat_counting_tile_piece(void) { return tpubloom::kPiece; }

extern "C" int tpb_flat_counting_update_tiled(void* state, const void* keys,
                                              const void* lengths, int64_t B, int L,
                                              int64_t m, int k, uint32_t seed, int increment,
                                              void* scratch, int64_t scratch_bytes,
                                              void* stream) {
  using namespace tpubloom;
  return launch_tiled_update<false>(state, keys, lengths, B, L, m, k, seed, increment,
                                    RouteSpec{}, scratch, scratch_bytes, stream);
}

extern "C" int tpb_flat_counting_query_tiled(const void* state, const void* keys,
                                             const void* lengths, void* out, int64_t B, int L,
                                             int64_t m, int k, uint32_t seed, void* scratch,
                                             int64_t scratch_bytes, void* stream) {
  using namespace tpubloom;
  return launch_tiled_query<false>(state, keys, lengths, out, B, L, m, k, seed, RouteSpec{},
                                   scratch, scratch_bytes, stream);
}

extern "C" int tpb_sharded_flat_counting_update_tiled(
    void* state, const void* keys, const void* lengths, int64_t B, int L, int64_t m, int k,
    uint32_t seed, int increment, int64_t n_shards, int64_t shard_lo, int64_t shards_per_dev,
    void* scratch, int64_t scratch_bytes, void* stream) {
  using namespace tpubloom;
  return launch_tiled_update<true>(state, keys, lengths, B, L, m, k, seed, increment,
                                   make_route(n_shards, shard_lo, shards_per_dev), scratch,
                                   scratch_bytes, stream);
}

extern "C" int tpb_sharded_flat_counting_query_tiled(
    const void* state, const void* keys, const void* lengths, void* out, int64_t B, int L,
    int64_t m, int k, uint32_t seed, int64_t n_shards, int64_t shard_lo,
    int64_t shards_per_dev, void* scratch, int64_t scratch_bytes, void* stream) {
  using namespace tpubloom;
  return launch_tiled_query<true>(state, keys, lengths, out, B, L, m, k, seed,
                                  make_route(n_shards, shard_lo, shards_per_dev), scratch,
                                  scratch_bytes, stream);
}
