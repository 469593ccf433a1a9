// The min-fold shared by the min-hash kernels: a lexicographic
// (h0 || h1, flat index) minimum per thread, per block, and a one-block
// finalize over the blocks' partials.
#pragma once

#include <stdint.h>

namespace bmt {

constexpr int kFinalThreads = 1024;
constexpr uint32_t kI32Max = 0x7FFFFFFFu;
constexpr unsigned long long kKeyMax = ~0ull;

struct Best {
  unsigned long long key;  // (h0 << 32) | h1
  uint32_t idx;
};

__device__ __forceinline__ bool better(unsigned long long k0, uint32_t i0,
                                       unsigned long long k1, uint32_t i1) {
  return k0 < k1 || (k0 == k1 && i0 < i1);
}

// Fold lane (h0, h1, idx) into the running minimum b.
__device__ __forceinline__ void fold(Best& b, uint32_t h0, uint32_t h1,
                                     uint32_t idx) {
  const unsigned long long key = (static_cast<unsigned long long>(h0) << 32) | h1;
  if (better(key, idx, b.key, b.idx)) {
    b.key = key;
    b.idx = idx;
  }
}

// Block-wide lexicographic min of every thread's (key, idx); the result is
// valid in thread 0.
__device__ __forceinline__ Best block_min(Best b) {
  __shared__ unsigned long long s_key[32];
  __shared__ uint32_t s_idx[32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long ok = __shfl_down_sync(0xffffffffu, b.key, off);
    const uint32_t oi = __shfl_down_sync(0xffffffffu, b.idx, off);
    if (better(ok, oi, b.key, b.idx)) {
      b.key = ok;
      b.idx = oi;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_key[warp] = b.key;
    s_idx[warp] = b.idx;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    b.key = lane < n_warps ? s_key[lane] : kKeyMax;
    b.idx = lane < n_warps ? s_idx[lane] : kI32Max;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long ok = __shfl_down_sync(0xffffffffu, b.key, off);
      const uint32_t oi = __shfl_down_sync(0xffffffffu, b.idx, off);
      if (better(ok, oi, b.key, b.idx)) {
        b.key = ok;
        b.idx = oi;
      }
    }
  }
  return b;
}

// Thread 0 of a block writes its partial and, in the sieve form, lowers
// the threshold word to the partial's h0.
__device__ __forceinline__ void write_partial(const Best& b, bool sieve,
                                              unsigned int* th_word,
                                              unsigned long long* partials,
                                              uint32_t part) {
  partials[2 * part] = b.key;
  partials[2 * part + 1] = b.idx;
  if (sieve && b.key != kKeyMax) atomicMin(th_word, unsigned(b.key >> 32));
}

// One block: reduce n partials to out = (h0, h1, flat_idx).
__global__ void __launch_bounds__(kFinalThreads)
    finalize_kernel(const unsigned long long* __restrict__ partials, int n,
                    long long* __restrict__ out) {
  Best b{kKeyMax, kI32Max};
  for (int i = threadIdx.x; i < n; i += kFinalThreads) {
    const unsigned long long key = partials[2 * i];
    const uint32_t idx = uint32_t(partials[2 * i + 1]);
    if (better(key, idx, b.key, b.idx)) {
      b.key = key;
      b.idx = idx;
    }
  }
  b = block_min(b);
  if (threadIdx.x == 0) {
    out[0] = static_cast<long long>(b.key >> 32);
    out[1] = static_cast<long long>(b.key & 0xFFFFFFFFull);
    out[2] = static_cast<long long>(b.idx);
  }
}

}  // namespace bmt
