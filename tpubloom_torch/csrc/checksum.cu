// A checkpoint payload's bytes and their CRC32C, made on the card (Hopper,
// sm_90a) from a snapshot of a filter's state.
//
// Replaces host numpy in both packages: the payload builder of
// tpubloom/checkpoint.py:95 _serialize (tpubloom/utils/packing.py:93
// words_to_redis_bitmap, a bit reversal of every byte through a lookup
// table, for the flat bit filter's redis_bitmap format; the raw words for
// blocked_le_words and counting_le_words) and the checksum of
// tpubloom/checkpoint.py:165 _frame (tpubloom/utils/crc32c.py:47
// _crc32c_numpy, slicing-by-8 whose carry is a Python loop over 8-byte
// blocks). Same bytes, same CRC: the standard
// Castagnoli CRC (reflected polynomial 0x82F63B78, init and xorout
// 0xFFFFFFFF) over the payload's nbytes = ceil(m / 8) bytes (bit filters)
// or 4 n_words bytes.
//
// Two launches on the caller's stream:
//   1. crc_chunk_kernel: 8 warps a CTA, a warp a contiguous run of 4 KiB
//      chunks (the payload's chunks dealt in equal runs to every warp of a
//      grid of one wave of resident CTAs). For each chunk the warp reads it as 16-byte vectors (one
//      coalesced 512-byte load a warp instruction), reverses each byte's
//      bits where asked (__byte_perm(__brev(w), 0, 0x0123)), writes the
//      payload bytes, and stages the words in shared memory, each row of
//      32 words padded by one so that the transposed reads below hit 32
//      banks. Lane l then computes the raw CRC (zero init) of the chunk's
//      bytes 128 l .. 128 l + 127 from slicing-by-4 tables in shared
//      memory, moves it to the chunk's end (a multiply by x^(8 * 128 *
//      (31 - l)) mod P), and the warp XORs its 32 lanes into the chunk's
//      raw CRC, then folds it into its run's: run = run x^(8 |chunk|) mod
//      P xor chunk. A ragged last chunk is staged right-aligned behind
//      zero bytes: leading zeros leave a zero-init CRC unchanged, so every
//      lane runs the same code and the chunk's raw CRC is that of its true
//      bytes. One raw CRC a warp goes out.
//   2. crc_combine_kernel: one CTA of 1024 threads over the warps' runs.
//      CRC is linear on the raw register with zero init: raw(A || B) =
//      raw(A) x^(8 |B|) mod P xor raw(B). Every run but the last non-empty
//      one is run_chunks full chunks long, so the runs before it are a
//      polynomial in K = x^(8 |run|) mod P with the runs' raw CRCs as
//      coefficients: each thread folds a slice of them by Horner's rule
//      (a multiply by K a run), and a tree over the threads multiplies
//      each right neighbour's sum by a constant of its level. The last
//      run then goes in at its true length, and the standard CRC is
//      ~(raw(D) xor 0xFFFFFFFF x^(8 |D|) mod P): the init and xorout go in
//      once, for the whole payload. The constants are made on the host.
// The chunks are folded in the first kernel, by the warp that made them, so
// the second reads one CRC a warp (a few thousand) instead of one a chunk
// (524,288 at m = 2^34, from strided addresses on one SM), and multiplies
// by constants instead of shifting by arbitrary lengths: PERF.md section 6
// times both earlier designs.
//
// Bound: the snapshot's 4 n_words bytes read and nbytes written once, at
// 3.35 TB/s: 1.28 ms at m = 2^34 (2 GiB in, 2 GiB out). The table lookups
// (one a byte, 2^31 at m = 2^34) run from shared memory, and the lanes'
// shifts are 32 steps of shift-and-xor a 128 bytes; both stay under the
// byte bound.
//
// Built by tpubloom_torch/ops/_build.py like the other sources. The entry
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns the first launch error. tpb_pinned_alloc / tpb_pinned_free
// hold the page-locked host buffer into which a checkpoint's payload is
// copied from the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace tpubloom {

constexpr uint32_t kPoly = 0x82F63B78u;  // reflected CRC32C polynomial
constexpr int kChunkLog2 = 12;
constexpr int kChunk = 1 << kChunkLog2;  // bytes a chunk, one warp's
constexpr int kLaneBytes = kChunk / 32;  // 128 bytes a lane
constexpr int kChunkWords = kChunk / 4;
constexpr int kStageWords = kChunkWords + kChunkWords / 32;  // one pad word a row of 32
constexpr int kWarps = 8;                // a CTA of 256 threads
constexpr int kCombineThreads = 1024;
constexpr int kCombineLevels = 10;  // log2(kCombineThreads)

// x^(2^k) mod P for k < 64 and, for lane l, x^(8 * 128 * (31 - l)) mod P.
// Reflected: bit 31 holds the coefficient of x^0.
struct Consts {
  uint32_t x2n[64];
  uint32_t lane_shift[32];
};

__host__ __device__ __forceinline__ uint32_t gf2_mul(uint32_t a, uint32_t b) {
  // a * b mod P in the reflected representation (zlib's multmodp, without
  // its early exit, so a warp never diverges)
  uint32_t p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

// v x^(8 nbytes) mod P: v advanced through nbytes zero bytes.
__host__ __device__ __forceinline__ uint32_t shift_bytes(uint32_t v, uint64_t nbytes,
                                                         const uint32_t* x2n) {
  uint64_t bits = nbytes << 3;
  for (int k = 0; bits; ++k, bits >>= 1) {
    if (bits & 1u) v = gf2_mul(x2n[k], v);
  }
  return v;
}

__device__ __forceinline__ uint32_t reverse_bytes_bits(uint32_t w) {
  // __brev reverses all 32 bits (and so the byte order); the byte permute
  // puts each byte back in its place
  return __byte_perm(__brev(w), 0, 0x0123);
}

__device__ __forceinline__ void build_tables(uint32_t (*table)[256]) {
  // slicing tables: table[0] the byte table, table[j] a byte advanced
  // through j more zero bytes; needs blockDim.x >= 256
  const int t = threadIdx.x;
  if (t < 256) {
    uint32_t c = t;
#pragma unroll
    for (int i = 0; i < 8; ++i) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
    table[0][t] = c;
  }
  __syncthreads();
  for (int j = 1; j < 4; ++j) {
    if (t < 256) {
      const uint32_t prev = table[j - 1][t];
      table[j][t] = (prev >> 8) ^ table[0][prev & 0xffu];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int staged(int word) { return word + (word >> 5); }

__global__ void __launch_bounds__(kWarps * 32)
    crc_chunk_kernel(const uint32_t* __restrict__ words, uint8_t* __restrict__ out,
                     uint32_t* __restrict__ run_raw, int64_t nbytes, int64_t n_chunks,
                     int64_t run_chunks, int bit_reverse, Consts cs) {
  __shared__ uint32_t table[4][256];
  __shared__ uint32_t lane_shift[32];
  __shared__ uint32_t x2n[64];
  __shared__ uint32_t stage[kWarps][kStageWords];
  build_tables(table);
  if (threadIdx.x < 32) lane_shift[threadIdx.x] = cs.lane_shift[threadIdx.x];
  if (threadIdx.x < 64) x2n[threadIdx.x] = cs.x2n[threadIdx.x];
  const uint32_t x_chunk = cs.x2n[kChunkLog2 + 3];  // x^(8 kChunk) mod P
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* st = stage[warp];
  const int64_t w = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t c_lo = w * run_chunks;
  const int64_t c_hi = c_lo + run_chunks < n_chunks ? c_lo + run_chunks : n_chunks;
  uint32_t run = 0;
  for (int64_t c = c_lo; c < c_hi; ++c) {
    const int64_t base = c * kChunk;
    const int64_t valid = nbytes - base < kChunk ? nbytes - base : kChunk;
    if (valid == kChunk) {
      const uint4* src = reinterpret_cast<const uint4*>(words) + c * (kChunk / 16);
      uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
      for (int j = 0; j < kChunk / 16 / 32; ++j) {
        const int v = j * 32 + lane;  // the chunk's 16-byte vector
        uint4 q = __ldcs(src + v);
        if (bit_reverse) {
          q.x = reverse_bytes_bits(q.x);
          q.y = reverse_bytes_bits(q.y);
          q.z = reverse_bytes_bits(q.z);
          q.w = reverse_bytes_bits(q.w);
        }
        __stcs(dst + v, q);
        const int sw = staged(v * 4);  // four words in one padded row
        st[sw] = q.x;
        st[sw + 1] = q.y;
        st[sw + 2] = q.z;
        st[sw + 3] = q.w;
      }
    } else {
      // the ragged last chunk, right-aligned behind zero bytes
      for (int sw = lane; sw < kStageWords; sw += 32) st[sw] = 0;
      __syncwarp();
      const uint8_t* src = reinterpret_cast<const uint8_t*>(words) + base;
      uint8_t* sb = reinterpret_cast<uint8_t*>(st);
      const int lead = (int)(kChunk - valid);
      for (int i = lane; i < valid; i += 32) {
        uint32_t b = src[i];
        if (bit_reverse) b = __brev(b) >> 24;
        out[base + i] = (uint8_t)b;
        const int p = lead + i;
        sb[staged(p >> 2) * 4 + (p & 3)] = (uint8_t)b;
      }
    }
    __syncwarp();

    // this lane's 128 bytes: 32 words of one padded row, conflict-free
    const uint32_t* mine = st + lane * (32 + 1);
    uint32_t crc = 0;
#pragma unroll 8
    for (int t = 0; t < kLaneBytes / 4; ++t) {
      crc ^= mine[t];
      crc = table[3][crc & 0xffu] ^ table[2][(crc >> 8) & 0xffu] ^
            table[1][(crc >> 16) & 0xffu] ^ table[0][crc >> 24];
    }
    crc = gf2_mul(lane_shift[lane], crc);  // (31 - lane) x 128 bytes follow
#pragma unroll
    for (int s = 16; s; s >>= 1) crc ^= __shfl_xor_sync(0xffffffffu, crc, s);
    // every lane holds the chunk's raw CRC: fold it into the run's
    run = (valid == kChunk ? gf2_mul(x_chunk, run) : shift_bytes(run, (uint64_t)valid, x2n)) ^ crc;
    __syncwarp();  // the stage is rewritten by the next chunk
  }
  if (lane == 0) run_raw[w] = run;  // 0 for a warp past the last chunk
}

// The combine's shifts, made on the host for one launch: every run but the
// last non-empty one holds run_chunks full chunks, so each fold and each
// tree level multiplies by one constant.
struct CombineConsts {
  uint32_t k_run;      // x^(8 run_bytes): one full run
  uint32_t x_last;     // x^(8 |last run|)
  uint32_t x_total;    // x^(8 nbytes)
  uint32_t q[kCombineLevels];  // x^(8 per run_bytes 2^s): a tree level's right part
  int64_t r_last;      // the last non-empty run
  int64_t per;         // full runs a thread folds
};

__global__ void __launch_bounds__(kCombineThreads)
    crc_combine_kernel(const uint32_t* __restrict__ run_raw, uint32_t* __restrict__ crc_out,
                       CombineConsts cc) {
  // raw(D) = raw(full runs) x^(8 |last|) xor raw(last), and the full runs'
  // raw CRC is sum_j raw_(r_last - 1 - j) K^j, K = x^(8 run_bytes): thread
  // t folds j in [t per, (t + 1) per) by Horner's rule, and the tree adds
  // each right neighbour's sum times Q_s = K^(per 2^s)
  __shared__ uint32_t part[kCombineThreads];
  const int t = threadIdx.x;
  const int64_t lo = t * cc.per;
  const int64_t hi = lo + cc.per < cc.r_last ? lo + cc.per : cc.r_last;
  uint32_t acc = 0;
  for (int64_t r = cc.r_last - hi; r < cc.r_last - lo; ++r) acc = gf2_mul(cc.k_run, acc) ^ run_raw[r];
  part[t] = acc;
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kCombineLevels; ++s) {
    if ((t & ((2 << s) - 1)) == 0) part[t] ^= gf2_mul(cc.q[s], part[t + (1 << s)]);
    __syncthreads();
  }
  if (t == 0) {
    const uint32_t raw = gf2_mul(cc.x_last, part[0]) ^ run_raw[cc.r_last];
    crc_out[0] = ~(raw ^ gf2_mul(cc.x_total, 0xffffffffu));
  }
}

static Consts make_consts() {
  Consts c;
  c.x2n[0] = 0x40000000u;  // x^1
  for (int k = 1; k < 64; ++k) c.x2n[k] = gf2_mul(c.x2n[k - 1], c.x2n[k - 1]);
  for (int l = 0; l < 32; ++l) c.lane_shift[l] = shift_bytes(0x80000000u, (uint64_t)kLaneBytes * (31 - l), c.x2n);
  return c;
}

static const Consts& consts() {
  static const Consts c = make_consts();
  return c;
}

}  // namespace tpubloom

extern "C" int tpb_checksum_chunk_bytes() { return tpubloom::kChunk; }

// payload (nbytes bytes) and its CRC32C (crc_out, one u32) from words
// (n_words u32, 4 n_words >= nbytes, 16-byte aligned); run_raw is
// scratch of ceil(nbytes / 4096) + 8 u32 (a raw CRC a warp of the grid).
// out must be 16-byte aligned.
extern "C" int tpb_payload_crc32c(const void* words, int64_t n_words, void* out, void* run_raw,
                                  void* crc_out, int64_t nbytes, int bit_reverse, void* stream) {
  using namespace tpubloom;
  if (nbytes <= 0 || n_words * 4 < nbytes) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int64_t n_chunks = (nbytes + kChunk - 1) / kChunk;
  // one wave of resident CTAs (on an H100 its 64 registers a thread allow 4
  // an SM, fewer than its 38 KB of shared memory would): each warp's run of
  // chunks is then its whole share of the payload
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc_chunk_kernel, kWarps * 32, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t want = (n_chunks + kWarps - 1) / kWarps;
  const int grid = (int)(want < resident ? want : resident);
  const int64_t n_runs = (int64_t)grid * kWarps;  // <= n_chunks + 7
  const int64_t run_chunks = (n_chunks + n_runs - 1) / n_runs;
  crc_chunk_kernel<<<grid, kWarps * 32, 0, cs>>>(
      static_cast<const uint32_t*>(words), static_cast<uint8_t*>(out),
      static_cast<uint32_t*>(run_raw), nbytes, n_chunks, run_chunks, bit_reverse, consts());
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Consts& c = consts();
  const int64_t run_bytes = run_chunks * kChunk;
  CombineConsts cc;
  cc.r_last = (n_chunks - 1) / run_chunks;
  cc.per = (cc.r_last + kCombineThreads - 1) / kCombineThreads;
  cc.k_run = shift_bytes(0x80000000u, (uint64_t)run_bytes, c.x2n);
  cc.x_last = shift_bytes(0x80000000u, (uint64_t)(nbytes - cc.r_last * run_bytes), c.x2n);
  cc.x_total = shift_bytes(0x80000000u, (uint64_t)nbytes, c.x2n);
  cc.q[0] = shift_bytes(0x80000000u, (uint64_t)(cc.per * run_bytes), c.x2n);
  for (int l = 1; l < kCombineLevels; ++l) cc.q[l] = gf2_mul(cc.q[l - 1], cc.q[l - 1]);
  crc_combine_kernel<<<1, kCombineThreads, 0, cs>>>(static_cast<const uint32_t*>(run_raw),
                                                    static_cast<uint32_t*>(crc_out), cc);
  return (int)cudaGetLastError();
}

extern "C" int tpb_pinned_alloc(int64_t nbytes, void** out) {
  return (int)cudaHostAlloc(out, (size_t)nbytes, cudaHostAllocDefault);
}

extern "C" int tpb_pinned_free(void* ptr) { return (int)cudaFreeHost(ptr); }
