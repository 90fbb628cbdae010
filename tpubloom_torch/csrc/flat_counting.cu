// Partitioned flat counting kernels for Hopper (sm_90a): the update and the
// query of the flat 4-bit counters for a batch whose positions cover much
// of the state. Each counter position of the batch is placed in the segment
// of its tile (a fixed run of counter words), and each tile's segment is
// then applied on chip, instead of one random L2 request a position.
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
// Six launches on the caller's stream. This file sets every size of the
// partition (make_tile_plan); the wrapper (ops/sweep.py) allocates the
// scratch that tpb_flat_counting_tiled_scratch_bytes gives.
//   1. tile_count_kernel: `chunks` CTAs, each a contiguous chunk of keys;
//      each valid (routed: owned) key is hashed (flat_key / flat_walk) and
//      each of its k positions counted in a shared-memory histogram of the
//      tiles, written out as row `chunk` of counts[chunks][n_tiles]. The
//      query first probes the key's position 0 in the state, a random read
//      a key as the thread-a-key kernel makes, and writes out[i]: 0 where
//      the counter there is 0 (or the key is padding, or not the slot's),
//      else 1; only the keys at 1 count, and place, positions 1..k-1.
//   2. tile_scan_columns_kernel: for each tile, the exclusive prefix of its
//      column over the chunks (in place) and the tile's total.
//   3. tile_scan_kernel (one CTA): the exclusive scan of the tiles' totals
//      (tile_start, the segments) and the CTAs of the later passes: a tile
//      of n entries takes ceil(n / piece) sweep CTAs, a bucket of tiles
//      ceil(n / sort_piece) sort CTAs.
//   4. bucket_place_kernel, then tile_sort_kernel: each chunk hashes its
//      keys again and writes its positions into the segments of their
//      buckets (64 tiles), ordered by bucket in shared memory first so that
//      each bucket's run goes out whole; then each bucket's entries move
//      into its tiles' segments as indices in the tile (the query: with the
//      key's index). No global atomic an entry. Writing each entry straight
//      into its tile's segment was one random partial-sector write an entry:
//      1.84 ms of a 2.68 ms update at config 4 flat (NVIDIA H100 80GB HBM3,
//      700 W, torch.profiler), as much as the random requests it replaces.
//   5. the sweep, one CTA a piece of a tile's segment:
//      - tile_update_kernel, where the CTA is its tile's only piece, stages
//        the tile in shared memory (cp.async, the whole tile in flight),
//        applies each entry's saturating step there (the thread-a-key
//        kernel's CAS loop, counter_step_from) and writes the tile back;
//        where pieces share a tile (a crowd of one key over much of the
//        batch makes such tiles), it counts its entries in a shared-memory
//        tile of nibbles (how many entries hit each counter, to 15) and
//        applies each word's counts to the state once, with a CAS loop
//        (v + min(c, 15 - v), or v - min(c, v));
//      - tile_query_kernel stages the tile in shared memory (cp.async) and
//        stores out[key] = 0 for each entry whose nibble is 0 (idempotent,
//        so order does not matter). Without the probe every absent key
//        placed its k entries and stored a verdict byte for each zero
//        counter: ~28.6 M random byte stores at config 4 flat, which made
//        the query on absent keys 1.10 ms against the thread-a-key 0.92
//        (NVIDIA H100 80GB HBM3, 700 W). In a filter at config 4's fill
//        the probe answers nearly every absent key, which then places and
//        stores nothing;
//      - a piece of kSparseEntries entries or fewer skips shared memory:
//        the update applies each entry with the thread-a-key kernel's CAS
//        step (counter_step), the query reads its nibble from the state.
//      A tile with no entries takes no CTA and is neither read nor written.
//
// Tiles are 2^kTileLog2 counter words (2^14: 64 KiB, 2^17 counters; 8,192
// tiles at m = 2^30), over the state's words, or a
// routed slot's shard-major words at base + pos; the last may be ragged (m
// need not be a multiple of the tile). An entry's index in its tile fits
// 17 bits; the segments' offsets are u32 (the plan refuses B k >= 2^31).
// A tile's words are a multiple of 4 (m, and a shard's m, divide by 32), so
// a tile is staged in 16-byte copies.
// Scratch at config 4 flat, sized for B k entries: two entry buffers (by
// bucket, then by tile) of 4 B an entry for the update (2 x 117 MB), 8 B
// for the query (2 x 235 MB), and the 8.7 MB count matrix.
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

namespace tpubloom {

constexpr int kPassThreads = 512;   // count, place and sort passes
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kScanThreads = 1024;  // the two scans
constexpr int kSweepThreads = 512;
constexpr int kCountUnroll = 4;     // keys a query's count thread probes at once
constexpr int kSweepUnroll = 8;     // loads a sweep thread issues before it uses them
constexpr int kApplyUnroll = 4;     // 16-byte state loads in flight a thread, applying counts
constexpr int kPlaceEntries = 4096;  // entries a place sub-batch orders in shared memory
constexpr int kMaxBuckets = 256;     // buckets of a state (the place pass's shared arrays)
constexpr int kMaxBucketTiles = 64;  // tiles a bucket (the sort pass's shared cursors)
// A piece of kSparseEntries entries or fewer goes to device memory entry by
// entry; a larger one stages its tile. The break-even: staging moves 128 KiB
// a tile (~39 ns of the card's 3.35 TB/s), a CAS entry costs ~88 ps of the
// thread-a-key kernel's 11.3 G positions/s, ~450 entries.
constexpr uint32_t kSparseEntries = 512;
constexpr uint32_t kNoEntry = 0xFFFFFFFFu;  // also "no position": positions are < 2^31

// The partition's sizes, which this file alone sets (the wrapper asks
// tpb_flat_counting_tiled_scratch_bytes for the scratch): tiles of 2^14
// words, the 64 KiB a sweep CTA stages; at most 2^14 entries a sweep CTA;
// the place pass orders entries by bucket of 2^6 tiles; at most 2^12
// entries a sort CTA moves into its tiles.
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
static_assert(kTileLog2 >= 2, "a tile is staged in 16-byte copies");
static_assert((1 << kBucketLog2) <= kMaxBucketTiles, "a bucket's tiles fit the sort's cursors");
static_assert((kMaxTiles >> kBucketLog2) <= kMaxBuckets, "the buckets fit the place pass's arrays");
static_assert(kMaxBuckets <= kPassThreads && kMaxBuckets <= kScanThreads, "a thread a bucket");
static_assert(kMaxBucketTiles <= kPassThreads, "a thread a tile of a bucket");

// The launch's partition: its geometry and the layout of its scratch (byte
// offsets from the scratch's base), from the launch's shape alone.
struct TilePlan {
  int64_t n_words;     // counter words of the state (a routed slot's)
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

// The plan of a launch of B keys, k positions each, on n_words counter
// words; false where the partition cannot hold it: more tiles than the
// passes' histogram, or B k at 2^31 entries (the segments' u32 offsets).
// An entry is 4 bytes (a position, then its index in the tile) or, for the
// query, 8 (and its key's index).
inline bool make_tile_plan(int64_t B, int k, int64_t n_words, bool query, TilePlan* g) {
  const int64_t entries = B * k;
  const int64_t n_tiles = ceil_div(n_words, (int64_t)1 << kTileLog2);
  if (B <= 0 || k <= 0 || n_words <= 0 || entries >= ((int64_t)1 << 31) || n_tiles > kMaxTiles)
    return false;
  g->n_words = n_words;
  g->n_tiles = (int)n_tiles;
  g->n_buckets = (int)ceil_div(n_tiles, (int64_t)1 << kBucketLog2);
  const int64_t even = ceil_div(B, kMaxChunks);
  g->chunk_keys = even > kMinChunkKeys ? even : kMinChunkKeys;
  g->chunks = (int)ceil_div(B, g->chunk_keys);
  g->sweep_grid = (int)(n_tiles + ceil_div(entries, kPiece));
  g->sort_grid = (int)(g->n_buckets + ceil_div(entries, kSortPiece));
  const int64_t entry_bytes = query ? 8 : 4;
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

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The tile of counter position p, and p's index inside it.
__device__ __forceinline__ int tile_of(uint64_t p, const TilePlan& g) {
  return (int)(p >> (kTileLog2 + 3));
}
__device__ __forceinline__ uint32_t index_in_tile(uint64_t p, const TilePlan& g) {
  return (uint32_t)(p & ((1ull << (kTileLog2 + 3)) - 1ull));
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
// positions a tile. The query first probes each valid owned key's position
// 0 in the state and writes out[i]: 0 for padding, a key the slot does not
// own, or a zero counter there (the key is absent, and places no entry), 1
// otherwise; it then counts only positions 1..k-1 of the keys still at 1.
// A query thread takes kCountUnroll keys at once, so that their probes are
// in flight together; an update thread one.
// ---------------------------------------------------------------------------

template <bool kRouted, bool kQuery>
__global__ void __launch_bounds__(kPassThreads)
tile_count_kernel(const uint8_t* __restrict__ keys, const int32_t* __restrict__ lengths,
                  const uint32_t* __restrict__ state, uint8_t* __restrict__ out, int64_t B,
                  int L, FlatSpec s, RouteSpec route, TilePlan g,
                  uint32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint32_t hist[];
  for (int t = threadIdx.x; t < g.n_tiles; t += blockDim.x) hist[t] = 0u;
  __syncthreads();
  constexpr int j0 = kQuery ? 1 : 0;  // the query's position 0 is its probe
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
        const uint64_t p = base[u] + flat_position(0, w[u], s);
        probe[u] = (__ldg(state + (p >> 3)) >> (4 * (int)(p & 7u))) & 15u;
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
        atomicAdd(&hist[tile_of(base[u] + flat_position(j, w[u], s), g)], 1u);
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
// 4. Place, level 1: the same keys and positions as the count pass (the
// query: the keys whose probe found a non-zero counter, from out), written
// as the positions themselves (u32: a partitioned state holds < 2^31
// counters; the query: and the key's index) into the segment of their
// bucket (2^kBucketLog2 tiles). Writing each entry where it goes would be
// one random partial-sector write an entry, as costly as the random
// requests this design removes. So a chunk takes its keys in sub-batches
// of up to kPlaceEntries entries, orders each by bucket in shared memory (a
// histogram, a scan, a scatter of entry indices), and writes each bucket's
// run whole: ~28 entries a run at 128 buckets. The chunk's runs in bucket b
// follow one another from base[b]: the bucket's first entry
// (tile_start of its first tile) plus the entries earlier chunks put in
// its tiles (the column-scanned count matrix).
// ---------------------------------------------------------------------------

// Shared memory of bucket_place_kernel: the sub-batch's positions, their
// order by bucket (entry indices), a count a (warp, bucket), each bucket's
// first slot in the order and in the segment, the scan.
constexpr int kPlaceSmemWords = 2 * kPlaceEntries + kPassWarps * kMaxBuckets + 2 * kMaxBuckets + 32;

template <bool kRouted, bool kQuery>
__global__ void __launch_bounds__(kPassThreads)
bucket_place_kernel(const uint8_t* __restrict__ keys, const int32_t* __restrict__ lengths,
                    const uint8_t* __restrict__ out, int64_t B, int L, FlatSpec s,
                    RouteSpec route, TilePlan g, const uint32_t* __restrict__ counts,
                    const uint32_t* __restrict__ tile_start, void* __restrict__ bucketed) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* pos = smem;                      // entry e = (key k0 + e / k, position e % k)
  uint32_t* order = pos + kPlaceEntries;     // entry indices by bucket
  uint32_t* bins = order + kPlaceEntries;    // [kPassWarps][kMaxBuckets]
  uint32_t* first = bins + kPassWarps * kMaxBuckets;
  uint32_t* base = first + kMaxBuckets;
  uint32_t* scan = base + kMaxBuckets;
  const int nb = g.n_buckets, shift = kTileLog2 + 3 + kBucketLog2;
  uint32_t* my_bins = bins + (threadIdx.x >> 5) * kMaxBuckets;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) base[b] = 0u;
  __syncthreads();
  const uint32_t* row = counts + (int64_t)blockIdx.x * g.n_tiles;
  for (int t = threadIdx.x; t < g.n_tiles; t += blockDim.x)
    atomicAdd(&base[t >> kBucketLog2], row[t]);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) base[b] += tile_start[b << kBucketLog2];
  // keys a sub-batch: as many as fit, in whole rounds of the CTA's threads
  const int fit = kPlaceEntries / s.k;
  const int per = fit >= kPassThreads ? fit / kPassThreads * kPassThreads : fit;
  const int64_t lo = (int64_t)blockIdx.x * g.chunk_keys, hi = min64(B, lo + g.chunk_keys);
  for (int64_t k0 = lo; k0 < hi; k0 += per) {
    const int nk = (int)min64(per, hi - k0);
    for (int x = threadIdx.x; x < kPassWarps * kMaxBuckets; x += blockDim.x) bins[x] = 0u;
    __syncthreads();
    for (int q = threadIdx.x; q < nk; q += blockDim.x) {
      FlatWalk w;
      uint64_t off;
      const int64_t i = k0 + q;
      // the query: only the keys its probe left at 1, from position 1
      const bool ok = (!kQuery || out[i] != 0) &&
                      flat_key<kRouted>(keys, lengths, i, L, s, route, w, off);
      for (int j = 0; j < s.k; ++j) {
        uint32_t p = kNoEntry;
        if (ok && (!kQuery || j > 0)) {
          p = (uint32_t)(off + flat_position(j, w, s));
          atomicAdd(&my_bins[p >> shift], 1u);
        }
        pos[q * s.k + j] = p;
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
      for (int j = 0; j < s.k; ++j) {
        const uint32_t p = pos[q * s.k + j];
        if (p == kNoEntry) continue;
        order[atomicAdd(&my_bins[p >> shift], 1u)] = (uint32_t)(q * s.k + j);
      }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < (int)total; x += blockDim.x) {
      const uint32_t e = order[x], p = pos[e], b = p >> shift;
      const uint32_t dst = base[b] + ((uint32_t)x - first[b]);
      if constexpr (kQuery)
        static_cast<uint2*>(bucketed)[dst] = make_uint2(p, (uint32_t)(k0 + e / s.k));
      else
        static_cast<uint32_t*>(bucketed)[dst] = p;
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
// moves each entry into its tile's segment as the index in its tile (the
// query: with its key): a histogram of its entries over the bucket's
// tiles, one global atomic a (CTA, tile) on tile_cursor to reserve its
// runs, then shared cursors. CTAs run bucket by bucket, so what they write
// at a time is a few buckets' segments, which stay in L2 until their
// sectors are whole.
// ---------------------------------------------------------------------------

// Shared memory of tile_sort_kernel: the piece's positions (the query: and
// key indices) as read and as ordered by tile, and the scan.
template <bool kQuery>
constexpr int sort_smem_bytes() {
  return (int)sizeof(uint32_t) * ((kQuery ? 4 : 2) * (int)kSortPiece + 32);
}

template <bool kQuery>
__global__ void __launch_bounds__(kPassThreads)
tile_sort_kernel(const void* __restrict__ bucketed, void* __restrict__ entries,
                 const uint32_t* __restrict__ tile_start, uint32_t* __restrict__ tile_cursor,
                 const uint32_t* __restrict__ sort_start,
                 const uint32_t* __restrict__ sort_bucket, TilePlan g) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t cursor[kMaxBucketTiles];
  __shared__ uint32_t first[kMaxBucketTiles];
  __shared__ uint32_t dst[kMaxBucketTiles];
  const uint32_t q = blockIdx.x;
  if (q >= sort_start[g.n_buckets]) return;
  uint32_t* in_p = smem;
  uint32_t* st_p = in_p + kSortPiece;
  uint32_t* in_k = st_p + kSortPiece;                     // the query only
  uint32_t* st_k = in_k + (kQuery ? kSortPiece : 0u);     // the query only
  uint32_t* scan = st_k + (kQuery ? kSortPiece : 0u);
  const int b = (int)sort_bucket[q];
  const int t0 = b << kBucketLog2, nt = min(g.n_tiles - t0, 1 << kBucketLog2);
  const uint32_t e0 = tile_start[t0] + (q - sort_start[b]) * kSortPiece;
  const int n = (int)(min(tile_start[t0 + nt], e0 + kSortPiece) - e0);
  const int ts = kTileLog2 + 3;
  const uint32_t* p32 = static_cast<const uint32_t*>(bucketed) + e0;
  const uint2* p64 = static_cast<const uint2*>(bucketed) + e0;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) cursor[t] = 0u;
  __syncthreads();
  for (int e0_ = threadIdx.x; e0_ < n; e0_ += kSweepUnroll * kPassThreads) {
    uint32_t pv[kSweepUnroll], kv[kSweepUnroll];
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      const int e = e0_ + u * kPassThreads;
      pv[u] = kNoEntry;
      kv[u] = 0u;
      if (e < n) {
        if constexpr (kQuery) {
          const uint2 x = __ldcs(p64 + e);
          pv[u] = x.x;
          kv[u] = x.y;
        } else {
          pv[u] = __ldcs(p32 + e);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      if (pv[u] == kNoEntry) continue;
      const int e = e0_ + u * kPassThreads;
      in_p[e] = pv[u];
      if constexpr (kQuery) in_k[e] = kv[u];
      atomicAdd(&cursor[(int)(pv[u] >> ts) - t0], 1u);
    }
  }
  __syncthreads();
  uint32_t total;
  const uint32_t c = (int)threadIdx.x < nt ? cursor[threadIdx.x] : 0u;
  const uint32_t at = block_exclusive_scan<kPassThreads>(scan, c, &total);
  if ((int)threadIdx.x < nt) {
    first[threadIdx.x] = cursor[threadIdx.x] = at;
    dst[threadIdx.x] = c ? atomicAdd(&tile_cursor[t0 + threadIdx.x], c) : 0u;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const uint32_t p = in_p[e];
    const uint32_t slot = atomicAdd(&cursor[(int)(p >> ts) - t0], 1u);
    st_p[slot] = p;
    if constexpr (kQuery) st_k[slot] = in_k[e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {  // each tile's run whole
    const uint32_t p = st_p[e];
    const int t = (int)(p >> ts) - t0;
    const uint32_t slot = dst[t] + ((uint32_t)e - first[t]);
    if constexpr (kQuery)
      static_cast<uint2*>(entries)[slot] = make_uint2(index_in_tile(p, g), st_k[e]);
    else
      static_cast<uint32_t*>(entries)[slot] = index_in_tile(p, g);
  }
}

// ---------------------------------------------------------------------------
// 5. Sweep. The piece of sweep CTA b: its tile, its entries [e0, e1), and
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
// Launch: the five kernels in stream order.
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

// The plan of a launch on the state a kernel takes: the filter's m / 8
// counter words, or a routed slot's shards_per_dev shards of m / 8 each (m
// is then one shard's counters). Refuses, with cudaErrorInvalidValue, a
// shape the partition cannot hold or a scratch smaller than the plan's.
template <bool kRouted>
int launch_plan(int64_t B, int64_t m, int k, bool query, const RouteSpec& r,
                int64_t scratch_bytes, TilePlan* g) {
  const int64_t n_words = (kRouted ? r.shards_per_dev : 1) * (m / 8);
  if (!make_tile_plan(B, k, n_words, query, g) || scratch_bytes < g->scratch_bytes)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <bool kRouted, bool kQuery>
int launch_partition(const void* state, const void* keys, const void* lengths, void* out,
                     int64_t B, int L, const FlatSpec& s, const RouteSpec& r, const TilePlan& g,
                     const Scratch& x, cudaStream_t cs) {
  const int hist_bytes = g.n_tiles * (int)sizeof(uint32_t);
  cudaFuncSetAttribute(tile_count_kernel<kRouted, kQuery>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, hist_bytes);
  const uint8_t* k8 = static_cast<const uint8_t*>(keys);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  uint8_t* verdict = static_cast<uint8_t*>(out);
  tile_count_kernel<kRouted, kQuery><<<g.chunks, kPassThreads, hist_bytes, cs>>>(
      k8, len, static_cast<const uint32_t*>(state), verdict, B, L, s, r, g, x.counts);
  int err = (int)cudaGetLastError();
  if (err) return err;
  tile_scan_columns_kernel<<<(g.n_tiles + 31) / 32, kScanThreads, 0, cs>>>(
      x.counts, x.tile_start, g);
  if ((err = (int)cudaGetLastError())) return err;
  const int start_bytes = (g.n_tiles + 1) * (int)sizeof(uint32_t);
  cudaFuncSetAttribute(tile_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       start_bytes);
  tile_scan_kernel<<<1, kScanThreads, start_bytes, cs>>>(
      x.tile_start, x.piece_start, x.tile_cursor, x.piece_tile, x.sort_start, x.sort_bucket, g);
  if ((err = (int)cudaGetLastError())) return err;
  const int place_bytes = kPlaceSmemWords * (int)sizeof(uint32_t);
  cudaFuncSetAttribute(bucket_place_kernel<kRouted, kQuery>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, place_bytes);
  bucket_place_kernel<kRouted, kQuery><<<g.chunks, kPassThreads, place_bytes, cs>>>(
      k8, len, verdict, B, L, s, r, g, x.counts, x.tile_start, x.bucketed);
  if ((err = (int)cudaGetLastError())) return err;
  const int sort_bytes = sort_smem_bytes<kQuery>();
  cudaFuncSetAttribute(tile_sort_kernel<kQuery>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       sort_bytes);
  tile_sort_kernel<kQuery><<<g.sort_grid, kPassThreads, sort_bytes, cs>>>(
      x.bucketed, x.entries, x.tile_start, x.tile_cursor, x.sort_start, x.sort_bucket, g);
  return (int)cudaGetLastError();
}

template <bool kRouted>
int launch_tiled_update(void* state, const void* keys, const void* lengths, int64_t B, int L,
                        int64_t m, int k, uint32_t seed, int increment, const RouteSpec& r,
                        void* scratch, int64_t scratch_bytes, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  TilePlan g;
  int err = launch_plan<kRouted>(B, m, k, false, r, scratch_bytes, &g);
  if (err) return err;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Scratch x = scratch_at(scratch, g);
  err = launch_partition<kRouted, false>(nullptr, keys, lengths, nullptr, B, L,
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
  int err = launch_plan<kRouted>(B, m, k, true, r, scratch_bytes, &g);
  if (err) return err;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const Scratch x = scratch_at(scratch, g);
  err = launch_partition<kRouted, true>(state, keys, lengths, out, B, L,
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
  return tpubloom::make_tile_plan(B, k, n_words, query != 0, &g) ? g.scratch_bytes : -1;
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
