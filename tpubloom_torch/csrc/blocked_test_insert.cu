// Blocked test-and-insert for Hopper (sm_90a): one launch sequence that
// answers each key's membership BEFORE the batch and sets its bits, on the
// blocked filter's state u32[n_blocks, W] (W = block_bits / 32; the fat
// [NB*W/128, 128] storage is the same memory), keys u8[B, L] (L a multiple
// of 4, zero past each key's length), lengths i32[B] (negative: padding,
// which sets nothing and answers False), verdicts u8[B].
//
// Replaces the presence variant (PRES) of the TPU insert sweeps: K1
// `_kernel` (tpubloom/ops/sweep.py:241, pallas_call at :554) and K3
// `_fat_kernel` (sweep.py:1463, pallas_call at :1723), reached through
// make_sweep_insert_fn(with_presence=True) (sweep.py:2256) from
// make_blocked_test_insert_fn (tpubloom/filter.py:245). The TPU answers a
// key's pre-batch membership from the partition tile it is already
// updating. The result is bit for bit ops/blocked.py
// blocked_test_insert_plain: the same state after the batch, and
// present[i] = key i's membership before the batch (within-batch
// duplicates all report the pre-batch state, padding False), for both
// in-block hashes (chunk, ap).
//
// Why not one pass of atomics: atomicOr's old value already holds the bits
// of earlier keys of the same batch, and at B = 2^23 over 2^23 rows about
// 63 % of keys share their row with another key. Before this kernel the
// port ran blocked_query, then blocked_insert (blocked_bloom.cu): every key
// hashed twice and every touched row fetched twice. Here the batch is
// partitioned by row tile, and each tile is tested and updated on chip:
//
//   1. row_count_kernel: each valid key is hashed once (bloom_hash.cuh
//      hash_key): its row and the 64 bits of its in-block hash pool that
//      its k positions read ((h_b, g_a) for chunk, (g_a, g_b) for ap) go
//      to pool[i], 16 bytes, and its row's tile is counted in the chunk's
//      shared histogram (flat_partition.cuh's count matrix). Padding
//      writes present[i] = 0 and places nothing.
//   2-4. flat_partition.cuh's column scan, tile scan, place (RowPositions:
//      one position a key, its row, with the pool's 64 bits as payload)
//      and sort, with 16-byte entries: each tile's segment holds (row in
//      tile, key, payload), so that the sweep gathers nothing by key. (With
//      8-byte entries the sweep gathered each key's pool by key, a random
//      16-byte read a key: 0.69 ms of sweep on an H100 at the main path's
//      shape, 0.28 with 16-byte entries; chip_smoke.py's times phase.) A
//      tile is 64 KiB of
//      state, 2^14 / W rows (1,024 rows of 512 bits; m = 2^32 has 8,192
//      tiles); rows stand at width -log2(W).
//   5. row_sweep_kernel<W>: one CTA a tile, which takes the tile's whole
//      segment, so that a row's keys never span two CTAs (two CTAs would
//      race on its pre-batch image). It reads its entries (once, into
//      registers, up to 2,048 of them), marks the rows they touch, copies
//      those rows into shared memory (cp.async, 16 bytes a copy, all of
//      the tile's in flight at once), tests every entry's k bits against
//      its row as loaded (the pre-batch verdict, written to present[key]),
//      __syncthreads(), ORs each entry's bits into the shared rows (a
//      shared atomicOr only where the bit is still clear, so that a key
//      repeated over much of the batch costs reads, not serialised
//      atomics), marks the rows that changed, and writes those rows back
//      (16-byte stores). No global atomic.
//
// A tile's segment is never split: a hot tile (a key repeated over a
// quarter of the batch, or thousands of keys on one row) is one CTA's
// work, longer than the others; correctness never depends on it.
//
// Bound: bytes. Each key's L + 4 input bytes, one verdict byte, and the
// distinct touched rows read once and written once. At the main path's
// shapes (m = 2^32, W = 16, B = 2^23, ~5.30 M distinct rows) ~0.855 GB,
// ~0.255 ms at 3.35 TB/s. The design's own traffic: the keys read once,
// the pool written and read once, the 16-byte entries written, sorted and
// read, the touched rows read and written: ~1.5 GB, ~0.45 ms.
//
// A chunk hash whose k positions need more than 64 bits of its pool (k
// log2(block_bits) > 64: block_bits 1024 and k = 7, say) does not fit an
// entry; the plan refuses it, as it does a state over 1 GiB (more than
// 2^14 tiles), and the wrapper keeps blocked_query + blocked_insert.
//
// Small batches keep the two launches too (the partition's six launches
// and a CTA a tile cost ~0.12 ms at any batch): the wrapper (ops/sweep.py
// _takes_fused) takes this kernel from BLOCKED_TEST_INSERT_CROSSOVER keys
// a row, where the plan holds the shape.
//
// Built by tpubloom_torch/ops/_build.py like the others; the entry
// launches on the caller's stream, does not synchronise, allocates nothing
// and returns the first launch error (cudaErrorInvalidValue for a shape the
// plan refuses or a scratch smaller than the plan's).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"
#include "flat_partition.cuh"

namespace tpubloom {

constexpr int log2_of(int w) { return w <= 1 ? 0 : 1 + log2_of(w / 2); }

static_assert(kTileLog2 >= 7, "a tile holds whole rows of up to 128 words");

// The plan of a launch of B keys on n_blocks rows of W words, k positions
// each: the partition's (one 16-byte entry a key, rows at width -log2(W)),
// then the pool (uint4[B]) after it; false where the partition cannot hold
// the shape, or where a chunk hash needs more than the entry's 64 bits of
// payload (k log2(block_bits) > 64).
struct TestInsertPlan {
  TilePlan g;
  int64_t pool_at, scratch_bytes;
};

inline bool test_insert_plan(int64_t B, int64_t n_blocks, int W, int k, int chunk,
                             TestInsertPlan* p) {
  if (W < 4 || W > 128 || (W & (W - 1)) || (chunk && k * (5 + log2_of(W)) > 64) ||
      !make_tile_plan_of(B, 1, n_blocks * W, -log2_of(W), 16, &p->g))
    return false;
  p->pool_at = ceil_div(p->g.scratch_bytes, 16) * 16;
  p->scratch_bytes = p->pool_at + 16 * B;
  return true;
}

// A key's payload: the in-block hash pool's bits its k positions read,
// (h_b, g_a) for chunk (the positions are bits 0 .. k log2(b) - 1 of h_b |
// g_a << 32 | g_b << 64, within the first 64 by the plan), (g_a, g_b) for
// ap; and back.
__device__ __forceinline__ uint2 pack_pool(const KeyHash& h, const BlockSpec& s) {
  return s.chunk ? make_uint2(h.hb, h.ga) : make_uint2(h.ga, h.gb);
}

__device__ __forceinline__ KeyHash unpack_pool(uint32_t a, uint32_t b, const BlockSpec& s) {
  return s.chunk ? KeyHash{0, a, b, 0u} : KeyHash{0, 0u, a, b};
}

// 1. Hash and count: row blockIdx.x of counts[chunks][n_tiles] is the
// chunk's keys a tile.
template <int kPosLog2>
__global__ void __launch_bounds__(kPassThreads)
row_count_kernel(const uint8_t* __restrict__ keys, const int32_t* __restrict__ lengths,
                 uint8_t* __restrict__ out, int64_t B, int L, BlockSpec s, TilePlan g,
                 uint32_t* __restrict__ counts, uint4* __restrict__ pool) {
  extern __shared__ __align__(16) uint32_t hist[];
  for (int t = threadIdx.x; t < g.n_tiles; t += blockDim.x) hist[t] = 0u;
  __syncthreads();
  const int64_t lo = (int64_t)blockIdx.x * g.chunk_keys, hi = min64(B, lo + g.chunk_keys);
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int len = lengths[i];
    uint4 v = make_uint4(0u, 0u, kNoEntry, 0u);
    if (len >= 0) {
      const KeyHash h =
          hash_key(reinterpret_cast<const uint32_t*>(keys + i * L), L / 4, len, s);
      const uint2 pay = pack_pool(h, s);
      v = make_uint4(pay.x, pay.y, (uint32_t)h.blk, 0u);
      atomicAdd(&hist[tile_of<kPosLog2>(h.blk)], 1u);
    } else {
      out[i] = 0;  // padding answers False and places nothing
    }
    pool[i] = v;
  }
  __syncthreads();
  uint32_t* mine = counts + (int64_t)blockIdx.x * g.n_tiles;
  for (int t = threadIdx.x; t < g.n_tiles; t += blockDim.x) mine[t] = hist[t];
}

// 5. The sweep's shared memory: the tile's 2^kTileLog2 words, then a bit a
// row of the rows its keys touch and of the rows that changed.
template <int W>
__host__ __device__ constexpr int row_mask_words() {
  return ((1 << kTileLog2) / W + 31) / 32;
}

template <int W>
constexpr int sweep_smem_bytes() {
  return (int)sizeof(uint32_t) * ((1 << kTileLog2) + 2 * row_mask_words<W>());
}

__device__ __forceinline__ bool row_bit(const uint32_t* mask, int r) {
  return (mask[r >> 5] >> (r & 31)) & 1u;
}

// Entries e, e + blockDim.x, ... (kGatherUnroll of them, those below e1),
// every load issued before any is used; x[u].x is kNoEntry past e1.
constexpr int kGatherUnroll = 4;

__device__ __forceinline__ void load_entries(const uint4* __restrict__ entries, uint32_t e,
                                             uint32_t e1, uint4 (&x)[kGatherUnroll]) {
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    const uint32_t f = e + u * blockDim.x;
    x[u] = f < e1 ? entries[f] : make_uint4(kNoEntry, 0u, 0u, 0u);
  }
}

// What a thread does with its group of entries (kNoEntry: none) in each
// phase of the sweep: mark their rows, test their keys against the rows
// as loaded (each verdict to present[key]), set their bits.
__device__ __forceinline__ void mark_rows(const uint4 (&x)[kGatherUnroll], uint32_t* touched) {
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u)
    if (x[u].x != kNoEntry) atomicOr(&touched[x[u].x >> 5], 1u << (x[u].x & 31u));
}

template <int W>
__device__ __forceinline__ void test_keys(const uint4 (&x)[kGatherUnroll], const uint32_t* tile,
                                          uint8_t* __restrict__ out, const BlockSpec& s) {
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    if (x[u].x == kNoEntry) continue;
    const KeyHash h = unpack_pool(x[u].z, x[u].w, s);
    const uint32_t* row = tile + x[u].x * W;
    bool hit = true;
    for (int j = 0; j < s.k; ++j) {
      const uint32_t b = inblock_bit(j, h, s);
      hit &= ((row[b >> 5] >> (b & 31u)) & 1u) != 0u;
    }
    out[x[u].y] = hit ? 1 : 0;
  }
}

template <int W>
__device__ __forceinline__ void set_keys(const uint4 (&x)[kGatherUnroll], uint32_t* tile,
                                         uint32_t* dirty, const BlockSpec& s) {
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    if (x[u].x == kNoEntry) continue;
    const KeyHash h = unpack_pool(x[u].z, x[u].w, s);
    uint32_t* row = tile + x[u].x * W;
    bool changed = false;
    for (int j = 0; j < s.k; ++j) {
      const uint32_t b = inblock_bit(j, h, s), one = 1u << (b & 31u);
      // a bit another key of the batch has set already needs no atomic
      if (!(*static_cast<volatile uint32_t*>(row + (b >> 5)) & one)) {
        atomicOr(row + (b >> 5), one);
        changed = true;
      }
    }
    if (changed) atomicOr(&dirty[x[u].x >> 5], 1u << (x[u].x & 31u));
  }
}

// A tile of at most kGatherUnroll entries a thread (2,048: twice the mean
// at the main path's shape) reads its entries once and keeps them in
// registers through the phases; a larger one reads them again in each.
template <int W>
__global__ void __launch_bounds__(kSweepThreads)
row_sweep_kernel(uint32_t* __restrict__ state, const uint32_t* __restrict__ tile_start,
                 const uint4* __restrict__ entries, uint8_t* __restrict__ out, TilePlan g,
                 BlockSpec s) {
  extern __shared__ __align__(16) uint32_t tile[];
  uint32_t* touched = tile + (1 << kTileLog2);
  uint32_t* dirty = touched + row_mask_words<W>();
  const int t = blockIdx.x;
  const uint32_t e0 = tile_start[t], e1 = tile_start[t + 1];
  if (e0 == e1) return;
  const bool resident = e1 - e0 <= kGatherUnroll * blockDim.x;
  const uint32_t stride = kGatherUnroll * blockDim.x;
  const int64_t w0 = (int64_t)t << kTileLog2;
  const int nw = (int)min64(g.n_words - w0, (int64_t)1 << kTileLog2);  // whole rows
  uint32_t* words = state + w0;
  uint4 x[kGatherUnroll];
  if (resident) load_entries(entries, e0 + threadIdx.x, e1, x);
  for (int v = threadIdx.x; v < 2 * row_mask_words<W>(); v += blockDim.x) touched[v] = 0u;
  __syncthreads();
  if (resident) {
    mark_rows(x, touched);
  } else {
    for (uint32_t e = e0 + threadIdx.x; e < e1; e += stride) {
      load_entries(entries, e, e1, x);
      mark_rows(x, touched);
    }
  }
  __syncthreads();
  // the touched rows, 16 bytes a copy (a row is W >= 4 words), all in flight
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  uint4* words4 = reinterpret_cast<uint4*>(words);
  for (int v = threadIdx.x; v < nw / 4; v += blockDim.x)
    if (row_bit(touched, 4 * v / W)) __pipeline_memcpy_async(tile4 + v, words4 + v, 16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // every key against its row as loaded: the state before the batch
  if (resident) {
    test_keys<W>(x, tile, out, s);
  } else {
    for (uint32_t e = e0 + threadIdx.x; e < e1; e += stride) {
      load_entries(entries, e, e1, x);
      test_keys<W>(x, tile, out, s);
    }
  }
  __syncthreads();
  if (resident) {
    set_keys<W>(x, tile, dirty, s);
  } else {
    for (uint32_t e = e0 + threadIdx.x; e < e1; e += stride) {
      load_entries(entries, e, e1, x);
      set_keys<W>(x, tile, dirty, s);
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v < nw / 4; v += blockDim.x)
    if (row_bit(dirty, 4 * v / W)) words4[v] = tile4[v];
}

template <int W>
int launch_test_insert(void* state, const void* keys, const void* lengths, void* out,
                       int64_t B, int L, const BlockSpec& s, void* scratch,
                       int64_t scratch_bytes, cudaStream_t cs) {
  constexpr int kPosLog2 = -log2_of(W);
  TestInsertPlan p;
  if (!test_insert_plan(B, (int64_t)s.n_blocks, W, s.k, s.chunk, &p) ||
      scratch_bytes < p.scratch_bytes)
    return (int)cudaErrorInvalidValue;
  const TilePlan& g = p.g;
  const Scratch x = scratch_at(scratch, g);
  char* base = static_cast<char*>(scratch);
  uint4* pool = reinterpret_cast<uint4*>(base + p.pool_at);
  uint8_t* verdict = static_cast<uint8_t*>(out);
  const int hist_bytes = g.n_tiles * (int)sizeof(uint32_t);
  cudaFuncSetAttribute(row_count_kernel<kPosLog2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       hist_bytes);
  row_count_kernel<kPosLog2><<<g.chunks, kPassThreads, hist_bytes, cs>>>(
      static_cast<const uint8_t*>(keys), static_cast<const int32_t*>(lengths), verdict, B, L, s,
      g, x.counts, pool);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_place<kPosLog2, 4>(RowPositions{pool}, B, g, x, cs);
  if (err) return err;
  const int sweep_bytes = sweep_smem_bytes<W>();
  cudaFuncSetAttribute(row_sweep_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       sweep_bytes);
  row_sweep_kernel<W><<<g.n_tiles, kSweepThreads, sweep_bytes, cs>>>(
      static_cast<uint32_t*>(state), x.tile_start, static_cast<const uint4*>(x.entries), verdict,
      g, s);
  return (int)cudaGetLastError();
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). `scratch` is device memory of at least
// tpb_blocked_test_insert_scratch_bytes(B, n_blocks, block_bits, k, chunk)
// bytes.
// ---------------------------------------------------------------------------

// The scratch of a launch, or -1 where the partition cannot hold the shape
// (the wrapper then keeps blocked_query + blocked_insert).
extern "C" int64_t tpb_blocked_test_insert_scratch_bytes(int64_t B, int64_t n_blocks,
                                                         int block_bits, int k, int chunk) {
  tpubloom::TestInsertPlan p;
  return tpubloom::test_insert_plan(B, n_blocks, block_bits / 32, k, chunk, &p) ? p.scratch_bytes
                                                                                : -1;
}

// Where a launch's tile starts (u32[n_tiles + 1], the entries before each
// tile) lie in its scratch, in bytes, or -1 as above: after a launch they
// give the keys each tile took.
extern "C" int64_t tpb_blocked_test_insert_tile_starts_at(int64_t B, int64_t n_blocks,
                                                          int block_bits, int k, int chunk) {
  tpubloom::TestInsertPlan p;
  return tpubloom::test_insert_plan(B, n_blocks, block_bits / 32, k, chunk, &p) ? p.g.starts_at
                                                                                : -1;
}

extern "C" int tpb_blocked_test_insert(void* state, const void* keys, const void* lengths,
                                       void* out, int64_t B, int L, int64_t n_blocks,
                                       int block_bits, int k, uint32_t seed, int chunk,
                                       void* scratch, int64_t scratch_bytes, void* stream) {
  using namespace tpubloom;
  if (B <= 0) return (int)cudaSuccess;
  const BlockSpec s = make_spec(n_blocks, block_bits, k, seed, chunk);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (block_bits / 32) {
    case 4: return launch_test_insert<4>(state, keys, lengths, out, B, L, s, scratch, scratch_bytes, cs);
    case 8: return launch_test_insert<8>(state, keys, lengths, out, B, L, s, scratch, scratch_bytes, cs);
    case 16: return launch_test_insert<16>(state, keys, lengths, out, B, L, s, scratch, scratch_bytes, cs);
    case 32: return launch_test_insert<32>(state, keys, lengths, out, B, L, s, scratch, scratch_bytes, cs);
    case 64: return launch_test_insert<64>(state, keys, lengths, out, B, L, s, scratch, scratch_bytes, cs);
    case 128: return launch_test_insert<128>(state, keys, lengths, out, B, L, s, scratch, scratch_bytes, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}
