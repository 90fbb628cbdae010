// The partition of a launch's positions by tile, shared by the
// partitioned kernels: the flat counting update and query
// (flat_counting.cu), the flat bit insert (flat_bits.cu), the count-min
// update (cms.cu) and the blocked test-and-insert (blocked_test_insert.cu).
// Each position of the batch is placed in the segment of its tile (a fixed
// run of state words), so that a sweep can then apply each tile's segment
// on chip instead of giving each position its own random L2 request.
//
// The passes are templates on the position's width, kPosLog2: the log2 of
// the positions a 32-bit word holds, kCounterLog2 (8 4-bit counters),
// kBitLog2 (32 bits) or kU32Log2 (one u32 counter), or negative for a
// position wider than a word: a blocked filter's row of W words is
// -log2(W). A tile is 2^kTileLog2 words whatever the width (64 KiB: 2^17
// counters, 2^19 bits, 2^14 u32 counters or 2^14 / W rows), so an entry's
// index in its tile fits a u32 either way. Two more flags serve the
// count-min grid (a [depth, width] grid of u32 counters stored
// row-major): kRowMajor, where a key's position j is
// j * m + flat_position(j) (row j of the grid, m = width) instead of
// base + flat_position(j); and kKeyed, where an entry carries its key's
// index beside its index in the tile (8 bytes), as a query's does, so that
// a weighted update's sweep can read the key's increment. A query is
// always keyed; an update is keyed only with weights. The blocked
// test-and-insert's entries are 16 bytes: the index and the key, then 64
// bits of payload from its source (the key's in-block hash pool), so that
// its sweep gathers nothing by key. The place and sort passes take an
// entry's width in words, kWords: 1, 2 (keyed) or 4.
//
// Five launches on the caller's stream, then the caller's sweep:
//   1. tile_count_kernel: `chunks` CTAs, each a contiguous chunk of keys;
//      each valid (routed: owned) key is hashed (flat_key / flat_walk) and
//      each of its k positions counted in a shared-memory histogram of the
//      tiles, written out as row `chunk` of counts[chunks][n_tiles]. A
//      query first probes the key's position 0 in the state, a random read
//      a key as a thread-a-key kernel makes, and writes out[i]: 0 where the
//      value there is 0 (or the key is padding, or not the slot's), else 1;
//      only the keys at 1 count, and place, positions 1..k-1.
//   2. tile_scan_columns_kernel: for each tile, the exclusive prefix of its
//      column over the chunks (in place) and the tile's total.
//   3. tile_scan_kernel (one CTA): the exclusive scan of the tiles' totals
//      (tile_start, the segments) and the CTAs of the later passes: a tile
//      of n entries takes ceil(n / piece) sweep CTAs, a bucket of tiles
//      ceil(n / sort_piece) sort CTAs.
//   4. bucket_place_kernel, then tile_sort_kernel: each chunk hashes its
//      keys again (a flat launch's FlatPositions; the blocked
//      test-and-insert reads each key's row from its count pass instead,
//      RowPositions) and writes its positions into the segments of their
//      buckets (64 tiles), ordered by bucket in shared memory first so that
//      each bucket's run goes out whole; then each bucket's entries move
//      into its tiles' segments as indices in the tile (a query: with the
//      key's index). No global atomic an entry. Writing each entry straight
//      into its tile's segment was one random partial-sector write an entry:
//      1.84 ms of a 2.68 ms counting update at config 4 flat (NVIDIA H100
//      80GB HBM3, 700 W, torch.profiler), as much as the random requests it
//      replaces.
// The sweep takes one CTA a piece (at most kPiece entries) of a tile's
// segment (sweep_piece); a tile with no entries takes no CTA.
//
// Tiles run over the state's words, or a routed slot's shard-major words at
// base + pos, or the count-min grid's rows one after another (a tile may
// straddle two rows: the partition sees flat indices only); the last may
// be ragged (m need not be a multiple of the tile). Positions travel as
// u32 (the plan refuses a state of 2^32 positions or more, so kNoEntry is
// never one), the segments' offsets too (the plan refuses B k >= 2^31
// entries). A counter tile's words are a multiple of 4 (m, and a shard's
// m, divide by 32; a count-min grid's depth * width words too), so a
// sweep may move it in 16-byte copies; a bit tile's (m / 32) need not be.
// This header alone sets the partition's sizes; the wrapper asks the
// library for the scratch (make_tile_plan) and allocates it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"

namespace tpubloom {

constexpr int kU32Log2 = 0;      // u32 counters a word: 1
constexpr int kCounterLog2 = 3;  // 4-bit counters a word: 8
constexpr int kBitLog2 = 5;      // bits a word: 32

constexpr int kPassThreads = 512;   // count, place and sort passes
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kScanThreads = 1024;  // the two scans
constexpr int kSweepThreads = 512;
constexpr int kCountUnroll = 4;     // keys a query's count thread probes at once
constexpr int kSweepUnroll = 8;     // loads a sweep thread issues before it uses them
constexpr int kPlaceEntries = 4096;  // entries a place sub-batch orders in shared memory
constexpr int kMaxBuckets = 256;     // buckets of a state (the place pass's shared arrays)
constexpr int kMaxBucketTiles = 64;  // tiles a bucket (the sort pass's shared cursors)
// A piece of kSparseEntries entries or fewer goes to device memory entry by
// entry; a larger one works on its tile in shared memory. The break-even
// for the counting update: staging moves 128 KiB a tile (~39 ns of the
// card's 3.35 TB/s), a CAS entry costs ~88 ps of the thread-a-key kernel's
// 11.3 G positions/s, ~450 entries.
constexpr uint32_t kSparseEntries = 512;
constexpr uint32_t kNoEntry = 0xFFFFFFFFu;  // also "no position": positions are < 2^32 - 1

// The partition's sizes: tiles of 2^14 words, the 64 KiB a sweep CTA holds
// in shared memory; at most 2^14 entries a sweep CTA; the place pass orders
// entries by bucket of 2^6 tiles; at most 2^12 entries a sort CTA moves into
// its tiles.
constexpr int kTileLog2 = 14;
constexpr uint32_t kPiece = 1u << 14;
constexpr int kBucketLog2 = 6;
constexpr uint32_t kSortPiece = 1u << 12;
// The count and place passes: at most four chunks of keys an H100 SM (132
// SMs, a CTA of 512 threads each), each of at least kMinChunkKeys keys.
constexpr int64_t kMaxChunks = 528, kMinChunkKeys = 2048;
// The passes' tile histogram lives in shared memory: at most 2^14 tiles
// (64 KiB of counts).
constexpr int64_t kMaxTiles = 1 << 14;
static_assert(kTileLog2 >= 2, "a whole tile moves in 16-byte copies");
static_assert((1 << kBucketLog2) <= kMaxBucketTiles, "a bucket's tiles fit the sort's cursors");
static_assert((kMaxTiles >> kBucketLog2) <= kMaxBuckets, "the buckets fit the place pass's arrays");
static_assert(kMaxBuckets <= kPassThreads && kMaxBuckets <= kScanThreads, "a thread a bucket");
static_assert(kMaxBucketTiles <= kPassThreads, "a thread a tile of a bucket");

// The launch's partition: its geometry and the layout of its scratch (byte
// offsets from the scratch's base), from the launch's shape alone.
struct TilePlan {
  int64_t n_words;     // words of the state (a routed slot's)
  int n_tiles;         // ceil(n_words / 2^kTileLog2); the last may be ragged
  int n_buckets;       // ceil(n_tiles / 2^kBucketLog2)
  int chunks;          // CTAs of the count and place passes
  int64_t chunk_keys;  // keys a chunk
  int sweep_grid;      // sweep CTAs: n_tiles + ceil(B k / piece), at least the pieces
  int sort_grid;       // sort CTAs: n_buckets + ceil(B k / sort_piece)
  int64_t counts_at;       // u32 counts[chunks][n_tiles]
  int64_t starts_at;       // u32 tile_start[n_tiles + 1], then piece_start[n_tiles + 1]
  int64_t cursor_at;       // u32 tile_cursor[n_tiles]
  int64_t piece_tile_at;   // u32 [sweep_grid]
  int64_t sort_starts_at;  // u32 sort_start[n_buckets + 1]
  int64_t sort_map_at;     // u32 [sort_grid]
  int64_t bucketed_at;     // the entries by bucket
  int64_t entries_at;      // the entries by tile
  int64_t scratch_bytes;
};

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The plan of a launch of B keys, k positions each, on n_words words of
// 2^pos_log2 positions; false where the partition cannot hold it: more
// tiles than the passes' histogram, 2^32 positions or more (a u32 entry),
// or B k at 2^31 entries (the segments' u32 offsets). An entry is
// entry_bytes: 4 (a position, then its index in the tile), 8 (and its key's
// index) or 16 (and a payload).
inline bool make_tile_plan_of(int64_t B, int k, int64_t n_words, int pos_log2,
                              int64_t entry_bytes, TilePlan* g) {
  const int64_t entries = B * k;
  const int64_t n_tiles = ceil_div(n_words, (int64_t)1 << kTileLog2);
  const int64_t positions = pos_log2 >= 0 ? n_words << pos_log2 : n_words >> -pos_log2;
  if (B <= 0 || k <= 0 || n_words <= 0 || entries >= ((int64_t)1 << 31) ||
      n_tiles > kMaxTiles || positions >= ((int64_t)1 << 32))
    return false;
  g->n_words = n_words;
  g->n_tiles = (int)n_tiles;
  g->n_buckets = (int)ceil_div(n_tiles, (int64_t)1 << kBucketLog2);
  const int64_t even = ceil_div(B, kMaxChunks);
  g->chunk_keys = even > kMinChunkKeys ? even : kMinChunkKeys;
  g->chunks = (int)ceil_div(B, g->chunk_keys);
  g->sweep_grid = (int)(n_tiles + ceil_div(entries, kPiece));
  g->sort_grid = (int)(g->n_buckets + ceil_div(entries, kSortPiece));
  g->counts_at = 0;
  g->starts_at = 4 * (int64_t)g->chunks * n_tiles;
  g->cursor_at = g->starts_at + 8 * (n_tiles + 1);
  g->piece_tile_at = g->cursor_at + 4 * n_tiles;
  g->sort_starts_at = g->piece_tile_at + 4 * (int64_t)g->sweep_grid;
  g->sort_map_at = g->sort_starts_at + 4 * (int64_t)(g->n_buckets + 1);
  g->bucketed_at = ceil_div(g->sort_map_at + 4 * (int64_t)g->sort_grid, 16) * 16;
  g->entries_at = g->bucketed_at + ceil_div(entry_bytes * entries, 16) * 16;
  g->scratch_bytes = g->entries_at + entry_bytes * entries;
  return true;
}

// The plan with 4-byte entries, or keyed (a query, a weighted update) 8.
inline bool make_tile_plan(int64_t B, int k, int64_t n_words, int pos_log2, bool keyed,
                           TilePlan* g) {
  return make_tile_plan_of(B, k, n_words, pos_log2, keyed ? 8 : 4, g);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The tile of position p, and p's index inside it.
template <int kPosLog2>
__device__ __forceinline__ int tile_of(uint64_t p) {
  return (int)(p >> (kTileLog2 + kPosLog2));
}
template <int kPosLog2>
__device__ __forceinline__ uint32_t index_in_tile(uint64_t p) {
  return (uint32_t)(p & ((1ull << (kTileLog2 + kPosLog2)) - 1ull));
}

// Position j of a key's walk in the state: base + its walk's position j,
// or (kRowMajor, the count-min grid) row j's flat index, j * m + it.
template <bool kRowMajor>
__device__ __forceinline__ uint64_t walk_at(int j, const FlatWalk& w, const FlatSpec& s,
                                            uint64_t base) {
  return (kRowMajor ? (uint64_t)j * s.m : base) + flat_position(j, w, s);
}

// The value at position p of its word: a counter (4 bits), a bit, or the
// whole word.
template <int kPosLog2>
__device__ __forceinline__ uint32_t value_at(uint32_t word, uint64_t p) {
  if constexpr (kPosLog2 == kU32Log2) {
    return word;  // a 32-bit mask would shift by 32
  } else {
    constexpr int kWidth = 32 >> kPosLog2;
    const int sh = kWidth * (int)(p & ((1u << kPosLog2) - 1u));
    return (word >> sh) & ((1u << kWidth) - 1u);
  }
}

// The exclusive prefix of v over the kThreads threads of the block, and in
// *total their sum: a shuffle scan in each warp, then one of the warps'
// sums. s holds 32 words of shared memory. Every thread of the block calls.
template <int kThreads>
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t* s, uint32_t v,
                                                         uint32_t* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < kWarps ? s[lane] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFullMask, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) s[lane] = w;  // inclusive, over the warps
  }
  __syncthreads();
  const uint32_t before = warp ? s[warp - 1] : 0u;
  *total = s[kWarps - 1];
  __syncthreads();
  return before + x - v;
}

// ---------------------------------------------------------------------------
// 1. Count: row blockIdx.x of counts[chunks][n_tiles] is the chunk's
// positions a tile. A query first probes each valid owned key's position 0
// in the state and writes out[i]: 0 for padding, a key the slot does not
// own, or a zero value there (the key is absent, and places no entry), 1
// otherwise; it then counts only positions 1..k-1 of the keys still at 1.
// A query thread takes kCountUnroll keys at once, so that their probes are
// in flight together; an update thread one.
// ---------------------------------------------------------------------------

template <int kPosLog2, bool kRouted, bool kQuery, bool kRowMajor = false>
__global__ void __launch_bounds__(kPassThreads)
tile_count_kernel(const uint8_t* __restrict__ keys, const int32_t* __restrict__ lengths,
                  const uint32_t* __restrict__ state, uint8_t* __restrict__ out, int64_t B,
                  int L, FlatSpec s, RouteSpec route, TilePlan g,
                  uint32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint32_t hist[];
  for (int t = threadIdx.x; t < g.n_tiles; t += blockDim.x) hist[t] = 0u;
  __syncthreads();
  constexpr int j0 = kQuery ? 1 : 0;  // a query's position 0 is its probe
  constexpr int kUnroll = kQuery ? kCountUnroll : 1;
  const int64_t lo = (int64_t)blockIdx.x * g.chunk_keys, hi = min64(B, lo + g.chunk_keys);
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kUnroll * (int64_t)blockDim.x) {
    FlatWalk w[kUnroll];
    uint64_t base[kUnroll];
    bool ok[kUnroll];
    uint32_t probe[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * blockDim.x;
      ok[u] = i < hi && flat_key<kRouted>(keys, lengths, i, L, s, route, w[u], base[u]);
      probe[u] = 1u;
      if (kQuery && ok[u]) {
        const uint64_t p = walk_at<kRowMajor>(0, w[u], s, base[u]);
        probe[u] = value_at<kPosLog2>(__ldg(state + (p >> kPosLog2)), p);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + (int64_t)u * blockDim.x;
      if constexpr (kQuery) {
        ok[u] = ok[u] && probe[u] != 0u;
        if (i < hi) out[i] = ok[u] ? 1 : 0;
      }
      if (!ok[u]) continue;
      for (int j = j0; j < s.k; ++j)
        atomicAdd(&hist[tile_of<kPosLog2>(walk_at<kRowMajor>(j, w[u], s, base[u]))], 1u);
    }
  }
  __syncthreads();
  uint32_t* row = counts + (int64_t)blockIdx.x * g.n_tiles;
  for (int t = threadIdx.x; t < g.n_tiles; t += blockDim.x) row[t] = hist[t];
}

// ---------------------------------------------------------------------------
// 2. Column scan: 32 tiles a CTA, a tile a lane; the 32 warps take 32 runs
// of chunks, sum them, and rescan them from the sums of the runs before.
// counts[c][t] becomes the positions of chunks < c in tile t; totals[t] the
// tile's positions.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kScanThreads)
tile_scan_columns_kernel(uint32_t* __restrict__ counts, uint32_t* __restrict__ totals,
                         TilePlan g) {
  constexpr int kRuns = kScanThreads / 32;
  __shared__ uint32_t run_sum[kRuns][33];
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + lane;
  const int per = (g.chunks + kRuns - 1) / kRuns;
  const int c0 = r * per, c1 = min(g.chunks, c0 + per);
  uint32_t sum = 0u;
  if (t < g.n_tiles)
    for (int c = c0; c < c1; ++c) sum += counts[(int64_t)c * g.n_tiles + t];
  run_sum[r][lane] = sum;
  __syncthreads();
  uint32_t acc = 0u;
  for (int q = 0; q < r; ++q) acc += run_sum[q][lane];
  if (t >= g.n_tiles) return;
  for (int c = c0; c < c1; ++c) {
    uint32_t* x = counts + (int64_t)c * g.n_tiles + t;
    const uint32_t v = *x;
    *x = acc;
    acc += v;
  }
  if (r == kRuns - 1) totals[t] = acc;
}

// ---------------------------------------------------------------------------
// 3. Tile scan, one CTA: tile_start[t] (in place over the totals; with the
// sum at [n_tiles]) and tile_cursor[t], its copy for the sort pass; the
// sweep's pieces, piece_start[t] (a tile of n entries takes ceil(n /
// piece) CTAs) and piece_tile[b], the tile of sweep CTA b; the same for the
// sort pass by bucket, sort_start[b] and sort_bucket[q].
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(uint32_t* __restrict__ tile_start, uint32_t* __restrict__ piece_start,
                 uint32_t* __restrict__ tile_cursor, uint32_t* __restrict__ piece_tile,
                 uint32_t* __restrict__ sort_start, uint32_t* __restrict__ sort_bucket,
                 TilePlan g) {
  extern __shared__ __align__(16) uint32_t start[];  // [n_tiles + 1]: the totals, then the starts
  __shared__ uint32_t s[32];
  for (int t = threadIdx.x; t < g.n_tiles; t += blockDim.x) start[t] = tile_start[t];
  __syncthreads();
  const int per = (g.n_tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = threadIdx.x * per, t1 = min(g.n_tiles, t0 + per);
  uint32_t e = 0u, p = 0u;
  for (int t = t0; t < t1; ++t) {
    e += start[t];
    p += (start[t] + kPiece - 1u) / kPiece;
  }
  uint32_t e_total, p_total;
  e = block_exclusive_scan<kScanThreads>(s, e, &e_total);
  p = block_exclusive_scan<kScanThreads>(s, p, &p_total);
  for (int t = t0; t < t1; ++t) {
    const uint32_t n = start[t], np = (n + kPiece - 1u) / kPiece;
    start[t] = e;
    piece_start[t] = p;
    for (uint32_t q = 0; q < np; ++q) piece_tile[p + q] = (uint32_t)t;
    e += n;
    p += np;
  }
  if (threadIdx.x == 0) {
    start[g.n_tiles] = e_total;
    piece_start[g.n_tiles] = p_total;
  }
  __syncthreads();
  for (int t = threadIdx.x; t <= g.n_tiles; t += blockDim.x) {
    tile_start[t] = start[t];
    if (t < g.n_tiles) tile_cursor[t] = start[t];
  }
  const int b = threadIdx.x;  // n_buckets <= kMaxBuckets < kScanThreads
  uint32_t nq = 0u;
  if (b < g.n_buckets) {
    const int first = b << kBucketLog2, last = min(g.n_tiles, (b + 1) << kBucketLog2);
    nq = (start[last] - start[first] + kSortPiece - 1u) / kSortPiece;
  }
  uint32_t q_total;
  const uint32_t q0 = block_exclusive_scan<kScanThreads>(s, nq, &q_total);
  if (b < g.n_buckets) {
    sort_start[b] = q0;
    for (uint32_t q = 0; q < nq; ++q) sort_bucket[q0 + q] = (uint32_t)b;
  }
  if (threadIdx.x == 0) sort_start[g.n_buckets] = q_total;
}

// ---------------------------------------------------------------------------
// 4. Place, level 1: the same keys and positions as the count pass (a
// query: the keys whose probe found a non-zero value, from out), written as
// the positions themselves (u32; keyed: and the key's index) into the
// segment of their bucket (2^kBucketLog2 tiles). Writing each entry where
// it goes would be one random partial-sector write an entry, as costly as
// the random requests this design removes. So a chunk takes its keys in
// sub-batches of up to kPlaceEntries entries, orders each by bucket in
// shared memory (a histogram, a scan, a scatter of entry indices), and
// writes each bucket's run whole: ~28 entries a run at 128 buckets. The
// chunk's runs in bucket b follow one another from base[b]: the bucket's
// first entry (tile_start of its first tile) plus the entries earlier
// chunks put in its tiles (the column-scanned count matrix).
// ---------------------------------------------------------------------------

// The positions the place pass writes, a source each: per_key() positions
// a key; load(i, key) false for a key that places none, else what at(j,
// key) needs; places(j) false for a position j that is not placed.
//
// A flat launch's: the same keys and positions as its count pass (a query:
// the keys whose probe found a non-zero value, from position 1).
template <bool kRouted, bool kQuery, bool kRowMajor>
struct FlatPositions {
  const uint8_t* __restrict__ keys;
  const int32_t* __restrict__ lengths;
  const uint8_t* __restrict__ out;
  int L;
  FlatSpec s;
  RouteSpec route;
  struct Key {
    FlatWalk w;
    uint64_t base;
  };
  __device__ __forceinline__ int per_key() const { return s.k; }
  __device__ __forceinline__ bool load(int64_t i, Key& key) const {
    return (!kQuery || out[i] != 0) && flat_key<kRouted>(keys, lengths, i, L, s, route, key.w,
                                                         key.base);
  }
  __device__ __forceinline__ bool places(int j) const { return !kQuery || j > 0; }
  __device__ __forceinline__ uint32_t at(int j, const Key& key) const {
    return (uint32_t)walk_at<kRowMajor>(j, key.w, s, key.base);
  }
};

// The blocked test-and-insert's: one position a key, its row, and a
// 64-bit payload, which its count pass hashed and wrote to pool[i] as
// (payload, row, 0); the row is kNoEntry for padding. payload(key) is read
// by the pass of 16-byte entries only.
struct RowPositions {
  const uint4* __restrict__ pool;
  struct Key {
    uint4 v;
  };
  __device__ __forceinline__ int per_key() const { return 1; }
  __device__ __forceinline__ bool load(int64_t i, Key& key) const {
    key.v = __ldcs(pool + i);
    return key.v.z != kNoEntry;
  }
  __device__ __forceinline__ bool places(int) const { return true; }
  __device__ __forceinline__ uint32_t at(int, const Key& key) const { return key.v.z; }
  __device__ __forceinline__ uint2 payload(const Key& key) const {
    return make_uint2(key.v.x, key.v.y);
  }
};

// An entry of kWords words: a position (or, sorted, its index in the
// tile), then (kWords > 1) its key's index, then (kWords == 4) a 64-bit
// payload; make() builds the place pass's, at() the sort's.
template <int kWords>
struct EntryOf;
template <>
struct EntryOf<1> {
  using T = uint32_t;
  __device__ __forceinline__ static T make(uint32_t p, uint32_t, uint2) { return p; }
  __device__ __forceinline__ static uint32_t pos(T v) { return v; }
  __device__ __forceinline__ static T none() { return kNoEntry; }
  __device__ __forceinline__ static T at(T, uint32_t i) { return i; }
};
template <>
struct EntryOf<2> {
  using T = uint2;
  __device__ __forceinline__ static T make(uint32_t p, uint32_t key, uint2) {
    return make_uint2(p, key);
  }
  __device__ __forceinline__ static uint32_t pos(T v) { return v.x; }
  __device__ __forceinline__ static T none() { return make_uint2(kNoEntry, 0u); }
  __device__ __forceinline__ static T at(T v, uint32_t i) { return make_uint2(i, v.y); }
};
template <>
struct EntryOf<4> {
  using T = uint4;
  __device__ __forceinline__ static T make(uint32_t p, uint32_t key, uint2 pay) {
    return make_uint4(p, key, pay.x, pay.y);
  }
  __device__ __forceinline__ static uint32_t pos(T v) { return v.x; }
  __device__ __forceinline__ static T none() { return make_uint4(kNoEntry, 0u, 0u, 0u); }
  __device__ __forceinline__ static T at(T v, uint32_t i) { return make_uint4(i, v.y, v.z, v.w); }
};

// Shared memory of bucket_place_kernel: the sub-batch's positions, their
// order by bucket (entry indices), a count a (warp, bucket), each bucket's
// first slot in the order and in the segment, the scan; with 16-byte
// entries, the keys' payloads too.
template <int kWords>
constexpr int place_smem_bytes() {
  return (int)sizeof(uint32_t) * (2 * kPlaceEntries + kPassWarps * kMaxBuckets +
                                  2 * kMaxBuckets + 32 + (kWords == 4 ? 2 * kPlaceEntries : 0));
}

template <int kPosLog2, int kWords, class Src>
__global__ void __launch_bounds__(kPassThreads)
bucket_place_kernel(Src src, int64_t B, TilePlan g, const uint32_t* __restrict__ counts,
                    const uint32_t* __restrict__ tile_start, void* __restrict__ bucketed) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* pos = smem;                      // entry e = (key k0 + e / k, position e % k)
  uint32_t* order = pos + kPlaceEntries;     // entry indices by bucket
  uint32_t* bins = order + kPlaceEntries;    // [kPassWarps][kMaxBuckets]
  uint32_t* first = bins + kPassWarps * kMaxBuckets;
  uint32_t* base = first + kMaxBuckets;
  uint32_t* scan = base + kMaxBuckets;
  uint2* pay = reinterpret_cast<uint2*>(scan + 32);  // kWords == 4: a payload a key
  const int nb = g.n_buckets, shift = kTileLog2 + kPosLog2 + kBucketLog2;
  uint32_t* my_bins = bins + (threadIdx.x >> 5) * kMaxBuckets;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) base[b] = 0u;
  __syncthreads();
  const uint32_t* row = counts + (int64_t)blockIdx.x * g.n_tiles;
  for (int t = threadIdx.x; t < g.n_tiles; t += blockDim.x)
    atomicAdd(&base[t >> kBucketLog2], row[t]);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) base[b] += tile_start[b << kBucketLog2];
  // keys a sub-batch: as many as fit, in whole rounds of the CTA's threads
  const int per_key = src.per_key();
  const int fit = kPlaceEntries / per_key;
  const int per = fit >= kPassThreads ? fit / kPassThreads * kPassThreads : fit;
  const int64_t lo = (int64_t)blockIdx.x * g.chunk_keys, hi = min64(B, lo + g.chunk_keys);
  for (int64_t k0 = lo; k0 < hi; k0 += per) {
    const int nk = (int)min64(per, hi - k0);
    for (int x = threadIdx.x; x < kPassWarps * kMaxBuckets; x += blockDim.x) bins[x] = 0u;
    __syncthreads();
    for (int q = threadIdx.x; q < nk; q += blockDim.x) {
      typename Src::Key key;
      const bool ok = src.load(k0 + q, key);
      if constexpr (kWords == 4) pay[q] = ok ? src.payload(key) : make_uint2(0u, 0u);
      for (int j = 0; j < per_key; ++j) {
        uint32_t p = kNoEntry;
        if (ok && src.places(j)) {
          p = src.at(j, key);
          atomicAdd(&my_bins[p >> shift], 1u);
        }
        pos[q * per_key + j] = p;
      }
    }
    __syncthreads();
    // bucket b's staging starts at first[b]; warp w's part of it after the
    // parts of warps < w (bins become the warps' cursors)
    uint32_t n = 0u;
    if ((int)threadIdx.x < nb)
      for (int w = 0; w < kPassWarps; ++w) n += bins[w * kMaxBuckets + threadIdx.x];
    uint32_t total;
    const uint32_t at = block_exclusive_scan<kPassThreads>(scan, n, &total);
    if ((int)threadIdx.x < nb) {
      first[threadIdx.x] = at;
      uint32_t c = at;
      for (int w = 0; w < kPassWarps; ++w) {
        const uint32_t v = bins[w * kMaxBuckets + threadIdx.x];
        bins[w * kMaxBuckets + threadIdx.x] = c;
        c += v;
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < nk; q += blockDim.x) {  // each thread its own keys
      for (int j = 0; j < per_key; ++j) {
        const uint32_t p = pos[q * per_key + j];
        if (p == kNoEntry) continue;
        order[atomicAdd(&my_bins[p >> shift], 1u)] = (uint32_t)(q * per_key + j);
      }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < (int)total; x += blockDim.x) {
      const uint32_t e = order[x], p = pos[e], b = p >> shift;
      const uint32_t dst = base[b] + ((uint32_t)x - first[b]);
      const uint2 v = kWords == 4 ? pay[e / per_key] : make_uint2(0u, 0u);
      static_cast<typename EntryOf<kWords>::T*>(bucketed)[dst] =
          EntryOf<kWords>::make(p, (uint32_t)(k0 + e / per_key), v);
    }
    __syncthreads();
    // the next sub-batch goes after this one's runs
    if ((int)threadIdx.x < nb) {
      const uint32_t next = (int)threadIdx.x + 1 < nb ? first[threadIdx.x + 1] : total;
      base[threadIdx.x] += next - first[threadIdx.x];
    }
  }
}

// ---------------------------------------------------------------------------
// 4b. Sort, level 2: sort CTA q takes a piece of one bucket's segment and
// moves each entry into its tile's segment as the index in its tile
// (keyed: with its key; 16-byte: and its payload): a histogram of its
// entries over the bucket's tiles, one global atomic a (CTA, tile) on
// tile_cursor to reserve its runs, then shared cursors. CTAs run bucket
// by bucket, so what they write at a time is a few buckets' segments,
// which stay in L2 until their sectors are whole.
// ---------------------------------------------------------------------------

// Shared memory of tile_sort_kernel: the piece's entries as ordered by
// tile, and the scan. Each thread holds the kSweepUnroll entries it read in
// registers until it places them.
template <int kWords>
constexpr int sort_smem_bytes() {
  return (int)sizeof(uint32_t) * (kWords * (int)kSortPiece + 32);
}
static_assert(kSortPiece <= (uint32_t)(kSweepUnroll * kPassThreads),
              "a sort thread holds its entries in registers");

template <int kPosLog2, int kWords>
__global__ void __launch_bounds__(kPassThreads)
tile_sort_kernel(const void* __restrict__ bucketed, void* __restrict__ entries,
                 const uint32_t* __restrict__ tile_start, uint32_t* __restrict__ tile_cursor,
                 const uint32_t* __restrict__ sort_start,
                 const uint32_t* __restrict__ sort_bucket, TilePlan g) {
  using E = EntryOf<kWords>;
  using T = typename E::T;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t cursor[kMaxBucketTiles];
  __shared__ uint32_t first[kMaxBucketTiles];
  __shared__ uint32_t dst[kMaxBucketTiles];
  const uint32_t q = blockIdx.x;
  if (q >= sort_start[g.n_buckets]) return;
  T* staged = reinterpret_cast<T*>(smem);
  uint32_t* scan = smem + kWords * kSortPiece;
  const int b = (int)sort_bucket[q];
  const int t0 = b << kBucketLog2, nt = min(g.n_tiles - t0, 1 << kBucketLog2);
  const uint32_t e0 = tile_start[t0] + (q - sort_start[b]) * kSortPiece;
  const int n = (int)(min(tile_start[t0 + nt], e0 + kSortPiece) - e0);
  const T* in = static_cast<const T*>(bucketed) + e0;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) cursor[t] = 0u;
  __syncthreads();
  T v[kSweepUnroll];
#pragma unroll
  for (int u = 0; u < kSweepUnroll; ++u) {
    const int e = threadIdx.x + u * kPassThreads;
    v[u] = e < n ? __ldcs(in + e) : E::none();
  }
#pragma unroll
  for (int u = 0; u < kSweepUnroll; ++u)
    if (E::pos(v[u]) != kNoEntry) atomicAdd(&cursor[tile_of<kPosLog2>(E::pos(v[u])) - t0], 1u);
  __syncthreads();
  uint32_t total;
  const uint32_t c = (int)threadIdx.x < nt ? cursor[threadIdx.x] : 0u;
  const uint32_t at = block_exclusive_scan<kPassThreads>(scan, c, &total);
  if ((int)threadIdx.x < nt) {
    first[threadIdx.x] = cursor[threadIdx.x] = at;
    dst[threadIdx.x] = c ? atomicAdd(&tile_cursor[t0 + threadIdx.x], c) : 0u;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kSweepUnroll; ++u) {
    if (E::pos(v[u]) == kNoEntry) continue;
    staged[atomicAdd(&cursor[tile_of<kPosLog2>(E::pos(v[u])) - t0], 1u)] = v[u];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {  // each tile's run whole
    const T x = staged[e];
    const uint32_t p = E::pos(x);
    const int t = tile_of<kPosLog2>(p) - t0;
    static_cast<T*>(entries)[dst[t] + ((uint32_t)e - first[t])] =
        E::at(x, index_in_tile<kPosLog2>(p));
  }
}

// ---------------------------------------------------------------------------
// 5. The sweep's piece. Sweep CTA b: its tile, its entries [e0, e1), and
// whether other CTAs share the tile; false past the last piece.
// ---------------------------------------------------------------------------

struct Piece {
  int tile;
  uint32_t e0, e1;
  bool alone;
  int64_t w0;  // the tile's first word
  int nw;      // its words (the last tile may be ragged)
};

__device__ __forceinline__ bool sweep_piece(const uint32_t* __restrict__ tile_start,
                                            const uint32_t* __restrict__ piece_start,
                                            const uint32_t* __restrict__ piece_tile,
                                            const TilePlan& g, Piece& pc) {
  const uint32_t b = blockIdx.x;
  if (b >= piece_start[g.n_tiles]) return false;
  pc.tile = (int)piece_tile[b];
  const uint32_t first = piece_start[pc.tile];
  pc.e0 = tile_start[pc.tile] + (b - first) * kPiece;
  pc.e1 = min(tile_start[pc.tile + 1], pc.e0 + kPiece);
  pc.alone = piece_start[pc.tile + 1] - first == 1u;
  pc.w0 = (int64_t)pc.tile << kTileLog2;
  pc.nw = (int)min64(g.n_words - pc.w0, (int64_t)1 << kTileLog2);
  return true;
}

// ---------------------------------------------------------------------------
// Launch: the plan, the scratch, and passes 1-4 in stream order.
// ---------------------------------------------------------------------------

struct Scratch {
  uint32_t* counts;
  uint32_t* tile_start;
  uint32_t* piece_start;
  uint32_t* tile_cursor;
  uint32_t* piece_tile;
  uint32_t* sort_start;
  uint32_t* sort_bucket;
  void* bucketed;
  void* entries;
};

inline Scratch scratch_at(void* base, const TilePlan& g) {
  char* b = static_cast<char*>(base);
  Scratch s;
  s.counts = reinterpret_cast<uint32_t*>(b + g.counts_at);
  s.tile_start = reinterpret_cast<uint32_t*>(b + g.starts_at);
  s.piece_start = s.tile_start + g.n_tiles + 1;
  s.tile_cursor = reinterpret_cast<uint32_t*>(b + g.cursor_at);
  s.piece_tile = reinterpret_cast<uint32_t*>(b + g.piece_tile_at);
  s.sort_start = reinterpret_cast<uint32_t*>(b + g.sort_starts_at);
  s.sort_bucket = reinterpret_cast<uint32_t*>(b + g.sort_map_at);
  s.bucketed = b + g.bucketed_at;
  s.entries = b + g.entries_at;
  return s;
}

// The plan of a launch on the state a kernel takes: the filter's m /
// 2^kPosLog2 words, or a routed slot's shards_per_dev shards of that many
// each (m is then one shard's positions). Refuses, with
// cudaErrorInvalidValue, a shape the partition cannot hold or a scratch
// smaller than the plan's.
template <int kPosLog2, bool kRouted>
int launch_plan(int64_t B, int64_t m, int k, bool query, const RouteSpec& r,
                int64_t scratch_bytes, TilePlan* g) {
  const int64_t n_words = (kRouted ? r.shards_per_dev : 1) * (m >> kPosLog2);
  if (!make_tile_plan(B, k, n_words, kPosLog2, query, g) || scratch_bytes < g->scratch_bytes)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

// Passes 2-4 (the scans, the place pass from `src`, the sort), after a count
// pass has filled the count matrix.
template <int kPosLog2, int kWords, class Src>
int launch_place(const Src& src, int64_t B, const TilePlan& g, const Scratch& x,
                 cudaStream_t cs) {
  tile_scan_columns_kernel<<<(g.n_tiles + 31) / 32, kScanThreads, 0, cs>>>(
      x.counts, x.tile_start, g);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int start_bytes = (g.n_tiles + 1) * (int)sizeof(uint32_t);
  cudaFuncSetAttribute(tile_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       start_bytes);
  tile_scan_kernel<<<1, kScanThreads, start_bytes, cs>>>(
      x.tile_start, x.piece_start, x.tile_cursor, x.piece_tile, x.sort_start, x.sort_bucket, g);
  if ((err = (int)cudaGetLastError())) return err;
  const int place_bytes = place_smem_bytes<kWords>();
  cudaFuncSetAttribute(bucket_place_kernel<kPosLog2, kWords, Src>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, place_bytes);
  bucket_place_kernel<kPosLog2, kWords, Src><<<g.chunks, kPassThreads, place_bytes, cs>>>(
      src, B, g, x.counts, x.tile_start, x.bucketed);
  if ((err = (int)cudaGetLastError())) return err;
  const int sort_bytes = sort_smem_bytes<kWords>();
  cudaFuncSetAttribute(tile_sort_kernel<kPosLog2, kWords>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, sort_bytes);
  tile_sort_kernel<kPosLog2, kWords><<<g.sort_grid, kPassThreads, sort_bytes, cs>>>(
      x.bucketed, x.entries, x.tile_start, x.tile_cursor, x.sort_start, x.sort_bucket, g);
  return (int)cudaGetLastError();
}

template <int kPosLog2, bool kRouted, bool kQuery, bool kRowMajor = false, bool kKeyed = kQuery>
int launch_partition(const void* state, const void* keys, const void* lengths, void* out,
                     int64_t B, int L, const FlatSpec& s, const RouteSpec& r, const TilePlan& g,
                     const Scratch& x, cudaStream_t cs) {
  const int hist_bytes = g.n_tiles * (int)sizeof(uint32_t);
  static_assert(!(kRouted && kRowMajor), "the count-min grid is not routed");
  static_assert(kKeyed || !kQuery, "a query's entries carry their keys");
  cudaFuncSetAttribute(tile_count_kernel<kPosLog2, kRouted, kQuery, kRowMajor>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, hist_bytes);
  const uint8_t* k8 = static_cast<const uint8_t*>(keys);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  uint8_t* verdict = static_cast<uint8_t*>(out);
  tile_count_kernel<kPosLog2, kRouted, kQuery, kRowMajor><<<g.chunks, kPassThreads, hist_bytes, cs>>>(
      k8, len, static_cast<const uint32_t*>(state), verdict, B, L, s, r, g, x.counts);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const FlatPositions<kRouted, kQuery, kRowMajor> src{k8, len, verdict, L, s, r};
  return launch_place<kPosLog2, kKeyed ? 2 : 1>(src, B, g, x, cs);
}

}  // namespace tpubloom
