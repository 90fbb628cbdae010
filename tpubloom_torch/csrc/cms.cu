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
// gather and a row minimum). One thread a key. The update is depth
// atomicAdd(unsigned) calls of the key's increment (1, or its weight):
// addition mod 2^32 commutes, so the grid after the launch is the pre-batch
// grid plus every valid key's increments, wrapping as .at[].add wraps,
// whatever order the atomics land in: bit-identical to tpubloom. The
// estimate reads the depth counters (all issued before the first is used)
// and writes their minimum.
//
// Bound, at chip_smoke.py's sizes (width 2,718,304, depth 7: 72.6 MiB,
// batches of 2^20 keys): bytes, each key's L + 4 input bytes (and 4 of its
// weight), and the distinct 32-byte sectors its depth counters touch, read
// (and for the update written back); a 2^20-key batch's 7.3 M counters
// fall on ~2.3 M of the grid's 2.4 M sectors, so nearly the whole grid,
// ~0.17 GB for the update. Like the flat kernels, a thread a key gives each
// counter its own L2 request (an atomic for the update), so the card's rate
// of random L2 requests, not its bandwidth, is what they see; the library
// yardsticks are index_add_ and index_select + amin on the same positions.
//
// Built by tpubloom_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with the plain C interface at the bottom of this
// file, loaded with ctypes. Each entry launches on the caller's stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bloom_hash.cuh"

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
  // 8 gathers in flight, then their minimum
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

inline unsigned cms_grid(int64_t B) {
  return (unsigned)((B + kCmsThreads - 1) / kCmsThreads);
}

inline bool cms_shape_ok(int64_t width, int depth) {
  return width > 0 && width < (1ll << 31) && depth >= 1 && depth <= kCmsMaxDepth;
}

}  // namespace tpubloom

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). Pointers are device pointers; `stream` is a
// cudaStream_t. `state` is u32[depth * width]; `incs` u32[B], or null for an
// increment of 1 a key. Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for a width outside [1, 2^31) or a depth outside
// [1, 64]).
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
