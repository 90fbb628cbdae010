// Count-min sketch kernels for Hopper (sm_90a): the update (a scatter-add of
// each key's increment into its depth counters) and the estimate (the
// minimum of the key's depth counters).
//
// Layout and spec (tpubloom/ops/cms.py; the plain versions are
// tpubloom_torch/ops/cms.py): the sketch is a [depth, width] grid of u32
// counters stored flat, row-major (u32[depth * width]). A key's counter in
// row r is position r of its flat walk over m = width positions
// (bloom_hash.cuh `flat_walk` / `flat_position`, tpubloom's
// hashing.positions with k = depth: the 64-bit walk when width is a power
// of two, the mod walk otherwise), at flat index r * width + pos. Keys are
// u8[B, L] (L a multiple of 4, zero past each key's length), lengths i32[B],
// a negative length marking a padding entry, which adds nothing and
// estimates 0.
//
// cms_update replaces tpubloom/ops/cms.py:53 (cms_update, the scatter-add
// words.at[flat].add(inc)); cms_estimate replaces :71 (cms_estimate, a
// gather and a row minimum). The update has two kernels, chosen by the
// wrapper from the batch's shape (ops/sweep.py cms_takes_tiles):
//   - cms_update_kernel, a thread a key: depth atomicAdd(unsigned) calls of
//     the key's increment (1, or its weight), each its own random L2
//     request. It keeps small batches.
//   - cms_update_tiled: the batch's counters partitioned by 64 KiB tile of
//     the grid (flat_partition.cuh at one u32 counter a word, kU32Log2, in
//     row-major mode: position j of a key is j * width + its walk's
//     position j; a unit update's entry is its index in the tile, 4 bytes,
//     a weighted one's also its key, 8 bytes, whose weight the sweep reads
//     from incs[key], 4 MiB at 2^20 keys, in L2), then cms_tile_kernel, a
//     CTA a piece (at most kPiece entries) of a tile's segment:
//       * a tile's only piece stages the tile in shared memory (cp.async,
//         the whole tile in flight), adds each entry's increment there with
//         a shared-memory atomicAdd and writes the tile back;
//       * a piece that shares its tile with others (a key repeated over
//         much of the batch makes such tiles: the path's Zipf(1.1) stream
//         puts ~11 % of a batch on its hottest id) adds into a zeroed
//         shared tile and then applies each non-zero word once with a
//         global atomicAdd;
//       * a piece of kSparseEntries entries or fewer adds each entry with a
//         global atomicAdd, as the thread-a-key kernel does.
//     A warp does not first fold its entries that share a counter: a fold
//     by __match_any_sync on every step was slower than the hot counters'
//     serialised shared-memory atomics it saves (on the sketch path's 2^20
//     Zipf batch 0.19589 against 0.19349 ms, on 2^20 distinct ids 0.21366
//     against 0.18394; chip_smoke.py sketch_times in turns, NVIDIA H100
//     80GB HBM3, 700 W).
// Why both give tpubloom's grid bit for bit: every path adds u32
// increments mod 2^32, and that sum commutes and associates. The grid
// after a launch is the pre-batch grid plus every valid key's increment at
// each of its depth counters, wrapping as .at[].add wraps, whatever the
// order of the atomics, the split of a tile into pieces or the staging.
// The estimate also has two kernels, chosen by the wrapper from the batch
// (ops/sweep.py cms_takes_rows):
//   - cms_estimate_kernel, a thread a key: its depth gathers (eight in
//     flight) through the L1, then their minimum. One round of gathers a
//     key keeps small batches (2^12 keys: 0.0028 ms against 0.0049).
//   - cms_rows_kernel, row-phased: at 2^20 keys a thread a key puts 7.3 M
//     gathers on all seven rows of the grid at once (76 MB, more than the
//     50 MB L2), so a sector is fetched from device memory about as often
//     as it is used (~3 times). This kernel is one launch of as many CTAs
//     as the card holds at once; each thread loads up to 8 keys (each
//     key's length and words in one trip, 16-byte streaming loads) and
//     hashes each once, then takes the rows in order, a row's gathers of
//     all its keys issued together and row r + 1 in flight while row r
//     folds. CTAs that start together and do equal work sweep the grid a
//     10.9 MB row at a time, so each row's sectors come from device memory
//     about once and then hit in the L2. The gathers go through the
//     read-only path with an L2::evict_last policy: the L1 keeps a hot
//     key's counter for the SM's other keys (on the Zipf stream the
//     L2-only gathers took 0.0617 ms against 0.0492), the hint keeps the
//     row (0.0880 against 0.0915 ms on distinct ids, L2-only gathers), and
//     a grid barrier between rows cost more than it kept (0.0965 against
//     0.0915; 0.0838 against 0.0624 on the Zipf stream). Measured on
//     NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py --ab in turns; PERF.md
//     section 6.
//
// Bound, at chip_smoke.py's sizes (width 2,718,304, depth 7: 72.6 MiB,
// batches of 2^20 keys): bytes, each key's L + 4 input bytes (and 4 of its
// weight), and the distinct 32-byte sectors its depth counters touch, read
// (and for the update written back); a 2^20-key batch of the Zipf stream
// puts its 7.3 M counters on ~1.09 M of the grid's 2.38 M sectors, a batch
// of distinct ids on ~2.3 M. The thread-a-key update gives each counter
// its own L2 atomic, so the card's rate of random L2 requests (and the
// serialised atomics of the hot counters), not its bandwidth, is what it
// sees. The partitioned update's own floor is the bytes it moves: the
// keys read twice (2 x 21 MB), 4-byte entries written and read by bucket,
// then by tile (4 x 29.4 MB), the grid read and written (2 x 76.1 MB) and
// the count matrix (~2.4 MB): ~0.31 GB, ~0.09 ms at 3.35 TB/s. The
// estimate's bound counts each key's L + 4 bytes, its 4-byte estimate and
// each distinct sector once: 0.029 ms at 2^20 distinct ids, of which the
// row-phased kernel reaches 0.30. The library yardsticks are index_add_
// and index_select + amin on the same positions.
//
// Built by tpubloom_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes. Each entry launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it refuses or a scratch smaller than
// the partition's plan).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bloom_hash.cuh"
#include "flat_partition.cuh"

namespace tpubloom {

constexpr int kCmsThreads = 256;
constexpr int kCmsMaxDepth = 64;  // FilterConfig's k bound

__global__ void __launch_bounds__(kCmsThreads)
cms_update_kernel(uint32_t* __restrict__ state, const uint8_t* __restrict__ keys,
                  const int32_t* __restrict__ lengths, const uint32_t* __restrict__ incs,
                  int64_t B, int L, FlatSpec s) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int len = lengths[i];
  if (len < 0) return;
  const uint32_t inc = incs ? incs[i] : 1u;
  const FlatWalk w = flat_walk(reinterpret_cast<const uint32_t*>(keys + i * L), L / 4, len, s);
  for (int r = 0; r < s.k; ++r)
    atomicAdd(state + (uint64_t)r * s.m + flat_position(r, w, s), inc);
}

inline unsigned cms_grid(int64_t B) {
  return (unsigned)((B + kCmsThreads - 1) / kCmsThreads);
}

inline bool cms_shape_ok(int64_t width, int depth) {
  return width > 0 && width < (1ll << 31) && depth >= 1 && depth <= kCmsMaxDepth;
}

// ---------------------------------------------------------------------------
// The partitioned update's sweep.
// ---------------------------------------------------------------------------

// Entry e of the tile segments: its index in the tile, and the increment
// it adds (1, or its key's weight).
template <bool kWeighted>
__device__ __forceinline__ void cms_entry(const void* __restrict__ entries,
                                          const uint32_t* __restrict__ incs, uint32_t e,
                                          uint32_t& x, uint32_t& inc) {
  if constexpr (kWeighted) {
    const uint2 v = __ldcs(static_cast<const uint2*>(entries) + e);
    x = v.x;
    inc = __ldg(incs + v.y);
  } else {
    x = __ldcs(static_cast<const uint32_t*>(entries) + e);
    inc = 1u;
  }
}

template <bool kWeighted>
__global__ void __launch_bounds__(kSweepThreads)
cms_tile_kernel(uint32_t* __restrict__ state, const uint32_t* __restrict__ tile_start,
                const uint32_t* __restrict__ piece_start, const uint32_t* __restrict__ piece_tile,
                const void* __restrict__ entries, const uint32_t* __restrict__ incs, TilePlan g) {
  extern __shared__ __align__(16) uint32_t tile[];
  Piece pc;
  if (!sweep_piece(tile_start, piece_start, piece_tile, g, pc)) return;
  uint32_t* words = state + pc.w0;
  if (pc.e1 - pc.e0 <= kSparseEntries) {
    for (uint32_t e = pc.e0 + threadIdx.x; e < pc.e1; e += blockDim.x) {
      uint32_t x, inc;
      cms_entry<kWeighted>(entries, incs, e, x, inc);
      atomicAdd(words + x, inc);
    }
    return;
  }
  const int n4 = pc.nw >> 2;  // nw % 4 == 0
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  uint4* words4 = reinterpret_cast<uint4*>(words);
  if (pc.alone) {  // the whole tile in flight at once
    for (int v = threadIdx.x; v < n4; v += blockDim.x) __pipeline_memcpy_async(tile4 + v, words4 + v, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    for (int v = threadIdx.x; v < n4; v += blockDim.x) tile4[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // kSweepUnroll loads a thread in flight
  for (uint32_t e0 = pc.e0 + threadIdx.x; e0 < pc.e1; e0 += kSweepUnroll * kSweepThreads) {
    uint32_t x[kSweepUnroll], inc[kSweepUnroll];
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      const uint32_t f = e0 + u * kSweepThreads;
      x[u] = kNoEntry;
      inc[u] = 0u;
      if (f < pc.e1) cms_entry<kWeighted>(entries, incs, f, x[u], inc[u]);
    }
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u)
      if (x[u] != kNoEntry) atomicAdd(tile + x[u], inc[u]);
  }
  __syncthreads();
  if (pc.alone) {
    for (int v = threadIdx.x; v < n4; v += blockDim.x) __stcg(words4 + v, tile4[v]);
    return;
  }
  // other pieces share the tile: each word this piece added to, once
  for (int w = threadIdx.x; w < pc.nw; w += blockDim.x) {
    const uint32_t d = tile[w];
    if (d) atomicAdd(words + w, d);
  }
}

// The plan of a partitioned update of B keys on the grid (weighted: 8-byte
// entries); false where the partition cannot hold it (and for a grid whose
// words are not a multiple of 4, which FilterConfig never makes).
inline bool cms_tile_plan(int64_t B, int64_t width, int depth, bool weighted, TilePlan* g) {
  return cms_shape_ok(width, depth) && (width * depth) % 4 == 0 &&
         make_tile_plan(B, depth, width * depth, kU32Log2, weighted, g);
}

template <bool kWeighted>
int launch_cms_tiled(void* state, const void* keys, const void* lengths, const void* incs,
                     int64_t B, int L, int64_t width, int depth, uint32_t seed, void* scratch,
                     int64_t scratch_bytes, cudaStream_t cs) {
  TilePlan g;
  if (!cms_tile_plan(B, width, depth, kWeighted, &g) || scratch_bytes < g.scratch_bytes)
    return (int)cudaErrorInvalidValue;
  const Scratch x = scratch_at(scratch, g);
  int err = launch_partition<kU32Log2, false, false, true, kWeighted>(
      nullptr, keys, lengths, nullptr, B, L, make_flat_spec(width, depth, seed), RouteSpec{}, g,
      x, cs);
  if (err) return err;
  const int tile_bytes = (int)sizeof(uint32_t) << kTileLog2;
  cudaFuncSetAttribute(cms_tile_kernel<kWeighted>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       tile_bytes);
  cms_tile_kernel<kWeighted><<<g.sweep_grid, kSweepThreads, tile_bytes, cs>>>(
      static_cast<uint32_t*>(state), x.tile_start, x.piece_start, x.piece_tile, x.entries,
      static_cast<const uint32_t*>(incs), g);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The estimate.
// ---------------------------------------------------------------------------

// A thread a key: its depth gathers (eight in flight), then their minimum.
__global__ void __launch_bounds__(kCmsThreads)
cms_estimate_kernel(const uint32_t* __restrict__ state, const uint8_t* __restrict__ keys,
                    const int32_t* __restrict__ lengths, uint32_t* __restrict__ out,
                    int64_t B, int L, FlatSpec s) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int len = lengths[i];
  if (len < 0) {
    out[i] = 0u;
    return;
  }
  const FlatWalk w = flat_walk(reinterpret_cast<const uint32_t*>(keys + i * L), L / 4, len, s);
  uint32_t est = 0xFFFFFFFFu;
  for (int r0 = 0; r0 < s.k; r0 += 8) {
    uint32_t v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = r0 + t < s.k ? __ldg(state + (uint64_t)(r0 + t) * s.m + flat_position(r0 + t, w, s))
                          : 0xFFFFFFFFu;
#pragma unroll
    for (int t = 0; t < 8; ++t) est = min(est, v[t]);
  }
  out[i] = est;
}

constexpr int kRowThreads = 256;
constexpr int kRowKeys = 8;   // keys a thread holds
constexpr int kLoadKeys = 4;  // of them loaded and hashed together (registers)
// CTAs an SM must hold: 4 (64 registers a thread) puts 132 x 4 x 256 x 8 =
// 1,081,344 keys in a pass, so a 2^20 batch sweeps the grid once; a key of
// up to 8 words in registers needs more of them.
template <int NW>
constexpr int kRowMinBlocks = NW > 4 ? 2 : 4;

// A key's walk from row to row: its row-r position is its cursor after r
// steps mod m (the mod walk, in 32 bits) or masked to m - 1 (the 64-bit
// walk), as flat_position computes it.
template <bool kPow2>
struct RowWalk {
  uint32_t cur, stride;
  __device__ __forceinline__ void start(const FlatWalk& w) {
    cur = (uint32_t)w.start;
    stride = (uint32_t)w.stride;
  }
  __device__ __forceinline__ uint32_t pos(uint64_t m) const { return cur % (uint32_t)m; }
  __device__ __forceinline__ void step() { cur += stride; }
};

template <>
struct RowWalk<true> {
  uint64_t cur, stride;
  __device__ __forceinline__ void start(const FlatWalk& w) {
    cur = w.start;
    stride = w.stride;
  }
  __device__ __forceinline__ uint64_t pos(uint64_t m) const { return cur & (m - 1); }
  __device__ __forceinline__ void step() { cur += stride; }
};

__device__ __forceinline__ uint64_t l2_evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// A gather through the read-only path (the L1 keeps a hot key's counter
// for the SM's other keys) with the L2::evict_last policy.
__device__ __forceinline__ uint32_t ld_evict_last(const uint32_t* a, uint64_t policy) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(a), "l"(policy));
  return v;
}

// One row's gathers of a thread's live keys (bit j of `live`), all issued
// before any is used; each walk steps to the next row.
template <bool kPow2>
__device__ __forceinline__ void gather_row(const uint32_t* __restrict__ row, uint64_t m,
                                           RowWalk<kPow2> (&w)[kRowKeys], unsigned live,
                                           uint64_t policy, uint32_t (&v)[kRowKeys]) {
#pragma unroll
  for (int j = 0; j < kRowKeys; ++j) {
    v[j] = 0xFFFFFFFFu;
    if (live >> j & 1u) {
      v[j] = ld_evict_last(row + w[j].pos(m), policy);
      w[j].step();
    }
  }
}

// The row-phased estimate: one launch of CTAs that are all resident at
// once, each owning `chunk` keys of a pass (key base + t + j kRowThreads
// on thread t), a pass running every row. NW > 0: a key of up to NW words
// loaded in one trip with its length and hashed from registers; NW = 0: a
// longer key hashed from memory.
template <int NW, bool kPow2>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks<NW>)
cms_rows_kernel(const uint32_t* __restrict__ state, const uint8_t* __restrict__ keys,
                const int32_t* __restrict__ lengths, uint32_t* __restrict__ out, int64_t B,
                int L, int vec, FlatSpec s, int64_t chunk) {
  const uint64_t policy = l2_evict_last_policy();
  const int64_t pass = chunk * gridDim.x;
  for (int64_t p0 = 0; p0 < B; p0 += pass) {
    const int64_t base = p0 + (int64_t)blockIdx.x * chunk + threadIdx.x;
    const int64_t stop = p0 + ((int64_t)blockIdx.x + 1) * chunk, end = stop < B ? stop : B;
    RowWalk<kPow2> w[kRowKeys];
    uint32_t est[kRowKeys];
    unsigned live = 0u;
#pragma unroll
    for (int g = 0; g < kRowKeys; g += kLoadKeys) {
      int32_t len[kLoadKeys];
      uint32_t r[kLoadKeys][NW > 0 ? NW : 1];
#pragma unroll
      for (int u = 0; u < kLoadKeys; ++u) {  // the group's lengths and words in flight at once
        const int64_t i = base + (g + u) * kRowThreads;
        len[u] = -1;
        if (i < end) {
          len[u] = __ldcs(lengths + i);
          if constexpr (NW > 0) load_key_words<NW>(keys, i, L, vec, r[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadKeys; ++u) {
        const int j = g + u;
        est[j] = len[u] < 0 ? 0u : 0xFFFFFFFFu;  // padding estimates 0
        if (len[u] < 0) continue;
        live |= 1u << j;
        if constexpr (NW > 0) {
          w[j].start(flat_walk_regs<NW>(r[u], L / 4, len[u], s));
        } else {
          const uint32_t* kw = reinterpret_cast<const uint32_t*>(keys + (base + j * kRowThreads) * L);
          w[j].start(flat_walk(kw, L / 4, len[u], s));
        }
      }
    }
    uint32_t v0[kRowKeys], v1[kRowKeys] = {};
    gather_row<kPow2>(state, s.m, w, live, policy, v0);
    for (int r = 0; r < s.k; ++r) {
      if (r + 1 < s.k)  // row r + 1 in flight while row r folds
        gather_row<kPow2>(state + (uint64_t)(r + 1) * s.m, s.m, w, live, policy, v1);
#pragma unroll
      for (int j = 0; j < kRowKeys; ++j) {
        est[j] = min(est[j], v0[j]);
        v0[j] = v1[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kRowKeys; ++j)
      if (base + j * kRowThreads < end) __stcs(out + base + j * kRowThreads, est[j]);
  }
}

// One row-phased launch: as many CTAs as the card holds at once, fewer for
// a batch of fewer than kRowThreads keys a CTA, the batch in equal passes
// of at most kRowKeys keys a thread.
template <int NW, bool kPow2>
int launch_rows(const void* state, const void* keys, const void* lengths, void* out, int64_t B,
                int L, const FlatSpec& s, cudaStream_t cs) {
  auto kernel = cms_rows_kernel<NW, kPow2>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (sms * per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t grid = std::min<int64_t>(sms * per_sm, (B + kRowThreads - 1) / kRowThreads);
  const int64_t per_pass = grid * kRowThreads * kRowKeys;
  const int64_t passes = (B + per_pass - 1) / per_pass;
  const int64_t chunk = (B + passes * grid - 1) / (passes * grid);
  const int vec = L % 16 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  kernel<<<(unsigned)grid, kRowThreads, 0, cs>>>(
      static_cast<const uint32_t*>(state), static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(lengths), static_cast<uint32_t*>(out), B, L, vec, s, chunk);
  return (int)cudaGetLastError();
}

int launch_estimate_rows(const void* state, const void* keys, const void* lengths, void* out,
                         int64_t B, int L, int64_t width, int depth, uint32_t seed,
                         cudaStream_t cs) {
  if (B <= 0) return (int)cudaSuccess;
  if (!cms_shape_ok(width, depth)) return (int)cudaErrorInvalidValue;
  const FlatSpec s = make_flat_spec(width, depth, seed);
  if (L <= 16)
    return s.pow2 ? launch_rows<4, true>(state, keys, lengths, out, B, L, s, cs)
                  : launch_rows<4, false>(state, keys, lengths, out, B, L, s, cs);
  if (L <= 32)
    return s.pow2 ? launch_rows<8, true>(state, keys, lengths, out, B, L, s, cs)
                  : launch_rows<8, false>(state, keys, lengths, out, B, L, s, cs);
  return s.pow2 ? launch_rows<0, true>(state, keys, lengths, out, B, L, s, cs)
                : launch_rows<0, false>(state, keys, lengths, out, B, L, s, cs);
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t. `state` is u32[depth * width]; `incs` u32[B], or null for an
// increment of 1 a key. Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for a width outside [1, 2^31) or a depth outside
// [1, 64]; for the partitioned update also for a shape its plan refuses or
// a scratch smaller than the plan's). `scratch` is device memory of at
// least tpb_cms_tiled_scratch_bytes(B, width, depth, incs != null) bytes.
// ---------------------------------------------------------------------------

extern "C" int tpb_cms_update(void* state, const void* keys, const void* lengths,
                              const void* incs, int64_t B, int L, int64_t width, int depth,
                              uint32_t seed, void* stream) {
  using namespace tpubloom;
  if (B <= 0) return (int)cudaSuccess;
  if (!cms_shape_ok(width, depth)) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cms_update_kernel<<<cms_grid(B), kCmsThreads, 0, cs>>>(
      static_cast<uint32_t*>(state), static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(lengths), static_cast<const uint32_t*>(incs), B, L,
      make_flat_spec(width, depth, seed));
  return (int)cudaGetLastError();
}

// The scratch of a partitioned update, or -1 where its partition cannot
// hold the shape (the wrapper then keeps the thread-a-key kernel).
extern "C" int64_t tpb_cms_tiled_scratch_bytes(int64_t B, int64_t width, int depth,
                                               int weighted) {
  tpubloom::TilePlan g;
  return tpubloom::cms_tile_plan(B, width, depth, weighted != 0, &g) ? g.scratch_bytes : -1;
}

// Where a partitioned update's scratch holds, after the launch, the start
// of each tile's entries (u32 tile_start[n_tiles + 1], n_tiles = ceil(width
// depth / 2^14), the entries of tile t being [tile_start[t],
// tile_start[t + 1])): its byte offset, or -1 as above. For holding the
// partition against its plain version.
extern "C" int64_t tpb_cms_tile_starts_at(int64_t B, int64_t width, int depth, int weighted) {
  tpubloom::TilePlan g;
  return tpubloom::cms_tile_plan(B, width, depth, weighted != 0, &g) ? g.starts_at : -1;
}

extern "C" int tpb_cms_update_tiled(void* state, const void* keys, const void* lengths,
                                    const void* incs, int64_t B, int L, int64_t width,
                                    int depth, uint32_t seed, void* scratch,
                                    int64_t scratch_bytes, void* stream) {
  using namespace tpubloom;
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return incs ? launch_cms_tiled<true>(state, keys, lengths, incs, B, L, width, depth, seed,
                                       scratch, scratch_bytes, cs)
              : launch_cms_tiled<false>(state, keys, lengths, incs, B, L, width, depth, seed,
                                        scratch, scratch_bytes, cs);
}

extern "C" int tpb_cms_estimate(const void* state, const void* keys, const void* lengths,
                                void* out, int64_t B, int L, int64_t width, int depth,
                                uint32_t seed, void* stream) {
  using namespace tpubloom;
  if (B <= 0) return (int)cudaSuccess;
  if (!cms_shape_ok(width, depth)) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cms_estimate_kernel<<<cms_grid(B), kCmsThreads, 0, cs>>>(
      static_cast<const uint32_t*>(state), static_cast<const uint8_t*>(keys),
      static_cast<const int32_t*>(lengths), static_cast<uint32_t*>(out), B, L,
      make_flat_spec(width, depth, seed));
  return (int)cudaGetLastError();
}

extern "C" int tpb_cms_estimate_rows(const void* state, const void* keys, const void* lengths,
                                     void* out, int64_t B, int L, int64_t width, int depth,
                                     uint32_t seed, void* stream) {
  return tpubloom::launch_estimate_rows(state, keys, lengths, out, B, L, width, depth, seed,
                                        static_cast<cudaStream_t>(stream));
}
