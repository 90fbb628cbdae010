// Device side of the blocked position spec (tpubloom/ops/hashing.py and
// tpubloom/ops/blocked.py hold the spec; tpubloom_torch/ops/hashing.py and
// tpubloom_torch/ops/blocked.py are the plain PyTorch versions these
// functions are tested against, bit for bit).
//
//   h_a = murmur3_32(key, seed)            blk   = h_a mod n_blocks
//   h_b = murmur3_32(key, seed ^ 0x9E3779B9)
//   g_a = fnv1a_32(key)
//   g_b = murmur3_32(key, seed ^ 0x85EBCA6B)
//   chunk: bit_i = (pool >> (i*log2(b))) mod b, pool = h_b | g_a<<32 | g_b<<64
//   ap:    bit_i = (g_a + i*(g_b|1)) mod b
//
// Sharded filter array (tpubloom/parallel/sharded.py): a key belongs to
// shard murmur3_32(key, seed ^ 0x517CC1B7) mod n_shards (a true mod), and
// hashes into that shard with n_blocks = the shard's block count.
//
// A key is L bytes (L a multiple of 4), zero past its true length, read as
// little-endian u32 words.
#pragma once

#include <stdint.h>

namespace tpubloom {

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kFmix1 = 0x85EBCA6Bu;
constexpr uint32_t kFmix2 = 0xC2B2AE35u;
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;
constexpr uint32_t kSeedXorHB = 0x9E3779B9u;
constexpr uint32_t kSeedXorGB = 0x85EBCA6Bu;
constexpr uint32_t kSeedXorRoute = 0x517CC1B7u;

// The filter geometry and hash identity every kernel needs. For a routed
// (sharded) kernel n_blocks is the block count of ONE shard.
struct BlockSpec {
  uint64_t n_blocks;   // power of two
  int block_bits;      // power of two
  int log2_bits;       // log2(block_bits)
  int k;               // positions per key
  uint32_t seed;
  int chunk;           // 1: "chunk" in-block hash, 0: "ap"
};

// The shards one slot's state holds: shards_per_dev shards from shard_lo
// on, out of n_shards, shard-major (shard shard_lo + s is block rows
// [s * n_blocks, (s + 1) * n_blocks) of the slot's state).
struct RouteSpec {
  uint32_t n_shards;
  int64_t shard_lo;
  int64_t shards_per_dev;
};

inline RouteSpec make_route(int64_t n_shards, int64_t shard_lo,
                            int64_t shards_per_dev) {
  RouteSpec r;
  r.n_shards = (uint32_t)n_shards;
  r.shard_lo = shard_lo;
  r.shards_per_dev = shards_per_dev;
  return r;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// MurmurHash3_x86_32 over the key's first `len` bytes (kw: its nw words;
// as in the spec, bytes past the buffer never enter, but `len` does).
__device__ __forceinline__ uint32_t murmur3_32(const uint32_t* __restrict__ kw,
                                               int nw, int len, uint32_t seed) {
  uint32_t h = seed;
  for (int i = 0; i < nw && 4 * i < len; ++i) {
    uint32_t kk = kw[i] * kC1;
    kk = rotl32(kk, 15);
    kk *= kC2;
    h ^= kk;
    if (len - 4 * i >= 4) {  // full block: rotate + scramble; tail: mix only
      h = rotl32(h, 13);
      h = h * 5u + 0xE6546B64u;
    }
  }
  h ^= (uint32_t)len;
  h ^= h >> 16;
  h *= kFmix1;
  h ^= h >> 13;
  h *= kFmix2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t fnv1a_32(const uint32_t* __restrict__ kw,
                                             int nw, int len) {
  uint32_t h = kFnvOffset;
  for (int j = 0; j < len && j < 4 * nw; ++j) {
    uint32_t byte = (kw[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    h = (h ^ byte) * kFnvPrime;
  }
  return h;
}

// murmur3_32 and fnv1a_32 over a key of NW words held in registers: the
// same functions, with loops of a fixed trip count (a word or byte at or
// past `len` is skipped, which is where the loops above stop), so that
// every index into `r` is a constant and `r` stays in registers. A key of
// 4 words (L = 16, the main path's) is loaded once and hashed this way;
// on an H100 that made the routing pass of a slot owning a quarter of the
// keys 11 % faster.
template <int NW>
__device__ __forceinline__ uint32_t murmur3_32_regs(const uint32_t (&r)[NW],
                                                    int len, uint32_t seed) {
  uint32_t h = seed;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if (4 * i >= len) continue;
    uint32_t kk = r[i] * kC1;
    kk = rotl32(kk, 15);
    kk *= kC2;
    h ^= kk;
    if (len - 4 * i >= 4) {
      h = rotl32(h, 13);
      h = h * 5u + 0xE6546B64u;
    }
  }
  h ^= (uint32_t)len;
  h ^= h >> 16;
  h *= kFmix1;
  h ^= h >> 13;
  h *= kFmix2;
  h ^= h >> 16;
  return h;
}

template <int NW>
__device__ __forceinline__ uint32_t fnv1a_32_regs(const uint32_t (&r)[NW],
                                                  int len) {
  uint32_t h = kFnvOffset;
#pragma unroll
  for (int j = 0; j < 4 * NW; ++j)
    if (j < len) h = (h ^ ((r[j >> 2] >> (8 * (j & 3))) & 0xFFu)) * kFnvPrime;
  return h;
}

// The hashes one key needs: its block and the in-block hash pool.
struct KeyHash {
  uint64_t blk;
  uint32_t hb, ga, gb;
};

// A key of 4 words is hashed from registers, any other from memory.

__device__ __forceinline__ KeyHash hash_key(const uint32_t* __restrict__ kw,
                                            int nw, int len, const BlockSpec& s) {
  KeyHash h;
  if (nw == 4) {
    const uint32_t r[4] = {kw[0], kw[1], kw[2], kw[3]};
    h.blk = (uint64_t)murmur3_32_regs(r, len, s.seed) & (s.n_blocks - 1);
    h.ga = fnv1a_32_regs(r, len);
    h.gb = murmur3_32_regs(r, len, s.seed ^ kSeedXorGB);
    h.hb = s.chunk ? murmur3_32_regs(r, len, s.seed ^ kSeedXorHB) : 0u;
    return h;
  }
  h.blk = (uint64_t)murmur3_32(kw, nw, len, s.seed) & (s.n_blocks - 1);
  h.ga = fnv1a_32(kw, nw, len);
  h.gb = murmur3_32(kw, nw, len, s.seed ^ kSeedXorGB);
  h.hb = s.chunk ? murmur3_32(kw, nw, len, s.seed ^ kSeedXorHB) : 0u;
  return h;
}

// The key's shard relative to the slot (its 64-bit local shard row, so its
// block row is local * n_blocks + blk), or -1 when the slot does not own
// it. Callers skip padding (len < 0) before, which is never owned.
__device__ __forceinline__ int64_t route_key(const uint32_t* __restrict__ kw,
                                             int nw, int len, uint32_t seed,
                                             const RouteSpec& r) {
  uint32_t h;
  if (nw == 4) {
    const uint32_t w[4] = {kw[0], kw[1], kw[2], kw[3]};
    h = murmur3_32_regs(w, len, seed ^ kSeedXorRoute);
  } else {
    h = murmur3_32(kw, nw, len, seed ^ kSeedXorRoute);
  }
  const int64_t local = (int64_t)(h % r.n_shards) - r.shard_lo;
  return (local >= 0 && local < r.shards_per_dev) ? local : -1;
}

// In-block position i of a key (0 <= i < k).
__device__ __forceinline__ uint32_t inblock_bit(int i, const KeyHash& h,
                                                const BlockSpec& s) {
  const uint32_t mask = (uint32_t)s.block_bits - 1u;
  if (s.chunk) {
    const int sh = i * s.log2_bits;
    const int w = sh >> 5, off = sh & 31;
    const uint32_t p0 = w == 0 ? h.hb : (w == 1 ? h.ga : h.gb);
    uint32_t v = p0 >> off;
    if (off + s.log2_bits > 32) {  // the slice straddles two pool words
      const uint32_t p1 = w == 0 ? h.ga : h.gb;
      v |= p1 << (32 - off);
    }
    return v & mask;
  }
  return (h.ga + (uint32_t)i * (h.gb | 1u)) & mask;
}

// ---------------------------------------------------------------------------
// Lane keys, for every lane-group kernel (the queries and the updates):
// each lane hashes the one key it loads (lane_key). Warp work lists, for
// the update kernels (blocked_insert, blocked_counting_update): a ballot
// of the lanes that hold a key to update gives the warp's work list, and
// the warp walks that list with G lanes a key, 32 / G keys a step, so that
// a key's words go out from neighbouring lanes in one instruction. Every
// lane reaches every warp collective: a lane without a key is a flag
// (LaneKey::valid), never an early return.
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// The key a lane loaded: whether it updates anything, the offset in words
// of its row (64-bit: a routed slot can hold 2^31 words and more), and its
// in-block hash pool.
struct LaneKey {
  bool valid;
  uint64_t row;
  KeyHash h;
};

// The key at index i (i < B, len = lengths[i] >= 0), its routing done:
// `base` is the slot's first row of the key's shard (0 unrouted).
__device__ __forceinline__ LaneKey key_at(const uint8_t* __restrict__ keys,
                                          int64_t i, int L, int len, int W,
                                          uint64_t base, const BlockSpec& s) {
  LaneKey k;
  k.h = hash_key(reinterpret_cast<const uint32_t*>(keys + i * L), L / 4, len, s);
  k.row = (base + k.h.blk) * (uint64_t)W;
  k.valid = true;
  return k;
}

// Key i = this thread's global index: invalid past the batch, for padding
// (len < 0), and (kRouted) for a key the slot does not own, which costs
// the routing hash and nothing else. W: words a row.
template <bool kRouted>
__device__ __forceinline__ LaneKey lane_key(const uint8_t* __restrict__ keys,
                                            const int32_t* __restrict__ lengths,
                                            int64_t B, int L, int W,
                                            const BlockSpec& s,
                                            const RouteSpec& route) {
  const LaneKey none{false, 0, KeyHash{0, 0u, 0u, 0u}};
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return none;
  const int len = lengths[i];
  if (len < 0) return none;
  int64_t local = 0;
  if constexpr (kRouted) {
    local = route_key(reinterpret_cast<const uint32_t*>(keys + i * L), L / 4,
                      len, s.seed, route);
    if (local < 0) return none;
  }
  return key_at(keys, i, L, len, W, (uint64_t)local * s.n_blocks, s);
}

// The lane that holds the n-th (from 0) key of the work list `list`, or
// -1 when the list holds n keys or fewer. n < kPerStep; the loop is
// unrolled and predicated, so lanes with different n do not diverge.
template <int kPerStep>
__device__ __forceinline__ int nth_lane(unsigned list, int n) {
#pragma unroll
  for (int t = 0; t < kPerStep - 1; ++t)
    if (t < n) list &= list - 1u;
  return list ? __ffs(list) - 1 : -1;
}

// The work list without its kPerStep first keys (the step just taken).
template <int kPerStep>
__device__ __forceinline__ unsigned next_step(unsigned list) {
#pragma unroll
  for (int t = 0; t < kPerStep; ++t) list &= list - 1u;
  return list;
}

// The key of lane `src` (0 <= src < 32), broadcast to the whole warp.
__device__ __forceinline__ LaneKey shfl_key(const LaneKey& mine, int src) {
  LaneKey k;
  k.valid = true;
  k.row = __shfl_sync(kFullMask, mine.row, src);
  k.h.blk = 0;  // folded into row
  k.h.hb = __shfl_sync(kFullMask, mine.h.hb, src);
  k.h.ga = __shfl_sync(kFullMask, mine.h.ga, src);
  k.h.gb = __shfl_sync(kFullMask, mine.h.gb, src);
  return k;
}

}  // namespace tpubloom
