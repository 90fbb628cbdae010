// bloomhash — the host (C++) hot path of tpubloom_torch's CPU driver.
//
// tpubloom_torch's copy of tpubloom/native/bloomhash.cpp, with the same
// C functions and the same bytes out: bit-exact MurmurHash3_x86_32 /
// FNV-1a, the double-hash position derivation, packed bit-array and
// blocked-layout insert/query loops (tpubloom_torch.cpu_ref, the
// reference's :ruby driver, BASELINE config 1), and the host key packer
// (tpubloom_torch.utils.packing). The spec is tpubloom_torch/ops/hashing.py
// and tpubloom_torch/ops/blocked.py; the tests hold every function to
// tpubloom's library and to the numpy spec, bit for bit.
//
// Host code, not a device kernel: built by g++ at first use
// (tpubloom_torch/ops/_build.py) into a shared library with a plain C
// interface, loaded through ctypes (tpubloom_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// MurmurHash3_x86_32 (public-domain algorithm by Austin Appleby).
static uint32_t murmur3_32(const uint8_t* data, int len, uint32_t seed) {
  const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
  uint32_t h1 = seed;
  const int nblocks = len / 4;
  for (int i = 0; i < nblocks; i++) {
    uint32_t k1;
    std::memcpy(&k1, data + 4 * i, 4);  // little-endian load
    k1 *= c1;
    k1 = rotl32(k1, 15);
    k1 *= c2;
    h1 ^= k1;
    h1 = rotl32(h1, 13);
    h1 = h1 * 5u + 0xe6546b64u;
  }
  const uint8_t* tail = data + 4 * nblocks;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= (uint32_t)tail[2] << 16; [[fallthrough]];
    case 2: k1 ^= (uint32_t)tail[1] << 8;  [[fallthrough]];
    case 1:
      k1 ^= tail[0];
      k1 *= c1;
      k1 = rotl32(k1, 15);
      k1 *= c2;
      h1 ^= k1;
  }
  h1 ^= (uint32_t)len;
  return fmix32(h1);
}

static uint32_t fnv1a_32(const uint8_t* data, int len) {
  uint32_t h = 0x811c9dc5u;
  for (int i = 0; i < len; i++) {
    h ^= data[i];
    h *= 0x01000193u;
  }
  return h;
}

// Seed-derivation constants — must match tpubloom_torch/ops/hashing.py.
static const uint32_t SEED_XOR_HB = 0x9E3779B9u;
static const uint32_t SEED_XOR_GB = 0x85EBCA6Bu;

extern "C" {

void bh_murmur3_batch(const uint8_t* keys, const int32_t* lens, int64_t B,
                      int32_t L, uint32_t seed, uint32_t* out) {
  for (int64_t i = 0; i < B; i++) {
    out[i] = murmur3_32(keys + i * L, lens[i], seed);
  }
}

void bh_fnv1a_batch(const uint8_t* keys, const int32_t* lens, int64_t B,
                    int32_t L, uint32_t* out) {
  for (int64_t i = 0; i < B; i++) {
    out[i] = fnv1a_32(keys + i * L, lens[i]);
  }
}

// k positions per key, exact spec of tpubloom_torch/ops/hashing.py:
//   pow2 m:      pos_i = (H1 + i*H2 mod 2^64) mod m
//   non-pow2 m:  pos_i = ((h_a + i*(g_a|1)) mod 2^32) mod m
void bh_positions(const uint8_t* keys, const int32_t* lens, int64_t B,
                  int32_t L, uint64_t m, int32_t k, uint32_t seed,
                  uint64_t* out) {
  const bool pow2 = (m & (m - 1)) == 0;
  for (int64_t i = 0; i < B; i++) {
    const uint8_t* key = keys + i * L;
    const int len = lens[i];
    const uint32_t h_a = murmur3_32(key, len, seed);
    if (pow2) {
      const uint32_t h_b = murmur3_32(key, len, seed ^ SEED_XOR_HB);
      const uint32_t g_a = fnv1a_32(key, len);
      const uint32_t g_b = murmur3_32(key, len, seed ^ SEED_XOR_GB);
      const uint64_t H1 = ((uint64_t)h_b << 32) | h_a;
      const uint64_t H2 = (((uint64_t)g_b << 32) | g_a) | 1ull;
      uint64_t pos = H1;
      for (int j = 0; j < k; j++) {
        out[i * k + j] = pos & (m - 1);
        pos += H2;  // u64 wrap == mod 2^64
      }
    } else {
      const uint32_t g_a = fnv1a_32(key, len) | 1u;
      uint32_t pos = h_a;
      for (int j = 0; j < k; j++) {
        out[i * k + j] = pos % (uint32_t)m;
        pos += g_a;  // u32 wrap == mod 2^32
      }
    }
  }
}

// Packed-u32 bit-array ops (LSB-first within word, same layout as device).
void bh_insert(uint32_t* words, const uint64_t* pos, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    words[pos[i] >> 5] |= 1u << (pos[i] & 31);
  }
}

void bh_query(const uint32_t* words, const uint64_t* pos, int64_t B,
              int32_t k, uint8_t* out) {
  for (int64_t i = 0; i < B; i++) {
    uint8_t hit = 1;
    for (int32_t j = 0; j < k; j++) {
      const uint64_t p = pos[i * k + j];
      hit &= (uint8_t)((words[p >> 5] >> (p & 31)) & 1u);
      if (!hit) break;  // short-circuit, like the reference's :ruby driver
    }
    out[i] = hit;
  }
}

// Fused hash+insert / hash+query — the native CPU baseline hot loop
// (BASELINE config 1 measures this tier).
void bh_hash_insert(uint32_t* words, const uint8_t* keys, const int32_t* lens,
                    int64_t B, int32_t L, uint64_t m, int32_t k,
                    uint32_t seed) {
  const bool pow2 = (m & (m - 1)) == 0;
  for (int64_t i = 0; i < B; i++) {
    const uint8_t* key = keys + i * L;
    const int len = lens[i];
    const uint32_t h_a = murmur3_32(key, len, seed);
    if (pow2) {
      const uint32_t h_b = murmur3_32(key, len, seed ^ SEED_XOR_HB);
      const uint32_t g_a = fnv1a_32(key, len);
      const uint32_t g_b = murmur3_32(key, len, seed ^ SEED_XOR_GB);
      const uint64_t H2 = (((uint64_t)g_b << 32) | g_a) | 1ull;
      uint64_t pos = ((uint64_t)h_b << 32) | h_a;
      for (int j = 0; j < k; j++) {
        const uint64_t p = pos & (m - 1);
        words[p >> 5] |= 1u << (p & 31);
        pos += H2;
      }
    } else {
      const uint32_t g_a = fnv1a_32(key, len) | 1u;
      uint32_t pos = h_a;
      for (int j = 0; j < k; j++) {
        const uint32_t p = pos % (uint32_t)m;
        words[p >> 5] |= 1u << (p & 31);
        pos += g_a;
      }
    }
  }
}

void bh_hash_query(const uint32_t* words, const uint8_t* keys,
                   const int32_t* lens, int64_t B, int32_t L, uint64_t m,
                   int32_t k, uint32_t seed, uint8_t* out) {
  const bool pow2 = (m & (m - 1)) == 0;
  for (int64_t i = 0; i < B; i++) {
    const uint8_t* key = keys + i * L;
    const int len = lens[i];
    const uint32_t h_a = murmur3_32(key, len, seed);
    uint8_t hit = 1;
    if (pow2) {
      const uint32_t h_b = murmur3_32(key, len, seed ^ SEED_XOR_HB);
      const uint32_t g_a = fnv1a_32(key, len);
      const uint32_t g_b = murmur3_32(key, len, seed ^ SEED_XOR_GB);
      const uint64_t H2 = (((uint64_t)g_b << 32) | g_a) | 1ull;
      uint64_t pos = ((uint64_t)h_b << 32) | h_a;
      for (int j = 0; j < k && hit; j++) {
        const uint64_t p = pos & (m - 1);
        hit &= (uint8_t)((words[p >> 5] >> (p & 31)) & 1u);
        pos += H2;
      }
    } else {
      const uint32_t g_a = fnv1a_32(key, len) | 1u;
      uint32_t pos = h_a;
      for (int j = 0; j < k && hit; j++) {
        const uint32_t p = pos % (uint32_t)m;
        hit &= (uint8_t)((words[p >> 5] >> (p & 31)) & 1u);
        pos += g_a;
      }
    }
    out[i] = hit;
  }
}

// Blocked (cache-line) layout — fused hash+insert / hash+query, exact spec
// of tpubloom_torch/ops/blocked.py: blk = h_a mod n_blocks. In-block positions per
// the `chunk` flag: chunk=1 slices log2(block_bits)-bit chunks from the
// (h_b, g_a, g_b) 96-bit pool; chunk=0 is the legacy AP walk
// (g_a + i*(g_b|1)) mod block_bits. words is uint32[n_blocks * W] row-major,
// W = block_bits/32.
static inline void blocked_positions_one(const uint8_t* key, int len,
                                         uint32_t seed, int32_t block_bits,
                                         int32_t k, int32_t chunk,
                                         uint32_t* bits) {
  const uint32_t bmask = (uint32_t)block_bits - 1u;
  const uint32_t g_a = fnv1a_32(key, len);
  const uint32_t g_b = murmur3_32(key, len, seed ^ SEED_XOR_GB);
  if (chunk) {
    int nb = 0;
    while ((1 << nb) < block_bits) nb++;
    const uint32_t pool[3] = {murmur3_32(key, len, seed ^ SEED_XOR_HB), g_a,
                              g_b};
    for (int j = 0; j < k; j++) {
      const int sh = j * nb;
      const int w = sh >> 5, off = sh & 31;
      uint32_t v = pool[w] >> off;
      if (off + nb > 32) v |= pool[w + 1] << (32 - off);
      bits[j] = v & bmask;
    }
  } else {
    const uint32_t stride = g_b | 1u;
    uint32_t p = g_a;
    for (int j = 0; j < k; j++) {
      bits[j] = p & bmask;
      p += stride;  // u32 wrap == mod 2^32
    }
  }
}

void bh_blocked_insert(uint32_t* words, const uint8_t* keys,
                       const int32_t* lens, int64_t B, int32_t L,
                       uint64_t n_blocks, int32_t block_bits, int32_t k,
                       uint32_t seed, int32_t chunk) {
  const int64_t W = block_bits / 32;
  uint32_t bits[64];
  for (int64_t i = 0; i < B; i++) {
    const uint8_t* key = keys + i * L;
    const int len = lens[i];
    const uint32_t h_a = murmur3_32(key, len, seed);
    blocked_positions_one(key, len, seed, block_bits, k, chunk, bits);
    uint32_t* row = words + (uint64_t)(h_a & (uint32_t)(n_blocks - 1)) * W;
    for (int j = 0; j < k; j++) row[bits[j] >> 5] |= 1u << (bits[j] & 31);
  }
}

void bh_blocked_query(const uint32_t* words, const uint8_t* keys,
                      const int32_t* lens, int64_t B, int32_t L,
                      uint64_t n_blocks, int32_t block_bits, int32_t k,
                      uint32_t seed, int32_t chunk, uint8_t* out) {
  const int64_t W = block_bits / 32;
  uint32_t bits[64];
  for (int64_t i = 0; i < B; i++) {
    const uint8_t* key = keys + i * L;
    const int len = lens[i];
    const uint32_t h_a = murmur3_32(key, len, seed);
    blocked_positions_one(key, len, seed, block_bits, k, chunk, bits);
    const uint32_t* row = words + (uint64_t)(h_a & (uint32_t)(n_blocks - 1)) * W;
    uint8_t hit = 1;
    for (int j = 0; j < k && hit; j++)
      hit &= (uint8_t)((row[bits[j] >> 5] >> (bits[j] & 31)) & 1u);
    out[i] = hit;
  }
}

// Host key packing: scatter a concatenated key buffer into the padded
// uint8[B, L] matrix the device kernels consume (out must be pre-zeroed).
// The ingest hot loop of tpubloom_torch.utils.packing.pack_keys.
void bh_pack(const uint8_t* joined, const int32_t* lens, int64_t B,
             int32_t L, uint8_t* out) {
  int64_t off = 0;
  for (int64_t i = 0; i < B; i++) {
    const int32_t len = lens[i];
    __builtin_memcpy(out + i * L, joined + off, (size_t)len);
    off += len;
  }
}

}  // extern "C"
