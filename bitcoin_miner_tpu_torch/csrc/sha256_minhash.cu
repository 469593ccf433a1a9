// Hopper (sm_90a) kernel of the SHA-256 min-hash sweep.
//
// Replaces the Pallas kernel bitcoin_miner_tpu/ops/pallas_sha256.py::
// _build_call, in both forms: the full (h0, h1) lexicographic min-fold
// (sieve=False, bound by make_pallas_minhash / make_pallas_minhash_dyn) and
// the two-stage sieve (sieve=True, the miner's main path).  One binary
// serves every digit class d in [k, 20]: k and the k low digits' (word,
// shift) positions are runtime arguments and the digits are computed in
// registers from the lane index (division by 10 is a multiply-high here).
//
// Function, per dispatch of B chunk rows x 10^k lanes:
//   lane (row, i) is valid when lo_row <= i < hi_row (bounds (B, 2));
//   its message is the row's template words with lane i's k low digits
//   ORed in, hashed from the host-folded midstate; result
//   min over valid lanes of (h0, h1, row * 10^k + i), lowest index on a tie.
//   Sieve form: if that min has h0 <= thresh the output is the min,
//   otherwise (U32_MAX, U32_MAX, I32_MAX) -- also the output when no lane
//   is valid.  Outputs are three int64 holding plain uint32 h0, h1 and the
//   int32 flat index (I32_MAX sentinel).
//
// Bound: 32-bit integer instruction throughput.  Each lane costs one SHA-256
// compression per tail block -- 64 rounds of funnel-shift rotations, LOP3
// logic and 3-input adds plus 48 schedule words -- of which 1.0e3 to 1.3e3
// integer instructions per block depend on the lane (ops/sha256_minhash.py
// lane_ops counts them; shifts and LOP3 issue only on the ALU pipe), against
// 12 B of device traffic per lane for the whole
// dispatch (the ~73 KB template table of a 1024-row dispatch is read once
// per block and stays in L1/L2).  So the design keeps every lane's state in
// registers, folds a running min per thread, and touches device memory
// only for the per-block partial and the final three words.
//
// Reduction: CUDA blocks run in parallel and in no order, unlike the TPU
// grid the Pallas kernel carries its accumulator across.  Each thread
// folds a running min, the block reduces it with warp shuffles and shared
// memory to one partial in a scratch array, and a second one-block kernel
// reduces the partials.  The sieve threshold is one device word that blocks
// lower with atomicMin after their fold and read, possibly stale, before
// it.  A stale value is only looser, the word never drops below the h0 of
// the true minimum, and lanes tying the threshold survive, so the output
// is the pure function above whatever the block order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minhash_fold.cuh"
#include "sha256_lane.cuh"

namespace {

using bmt::Best;
using bmt::kI32Max;
using bmt::kKeyMax;

constexpr int kThreads = 256;
constexpr int kLanesPerThread = 16;
constexpr int kLanesPerBlock = kThreads * kLanesPerThread;

// grid (ceil(10^k / kLanesPerBlock), B): block (x, row) hashes lanes
// [x * kLanesPerBlock, (x + 1) * kLanesPerBlock) of chunk row `row` and
// writes one (key, idx) partial.
template <int NB, bool SIEVE>
__global__ void __launch_bounds__(kThreads)
    minhash_kernel(const uint32_t* __restrict__ midstate,
                   const uint32_t* __restrict__ tail,
                   const int32_t* __restrict__ bounds, uint32_t n_lanes,
                   bmt::DigitArgs da, unsigned int* th_word,
                   unsigned long long* __restrict__ partials) {
  const uint32_t row = blockIdx.y;
  const uint32_t part = row * gridDim.x + blockIdx.x;
  const int64_t lane0 = int64_t(blockIdx.x) * kLanesPerBlock;
  const int64_t lo = bounds[2 * row] > lane0 ? bounds[2 * row] : lane0;
  const int64_t hi_b = bounds[2 * row + 1] < int64_t(n_lanes)
                           ? bounds[2 * row + 1] : int64_t(n_lanes);
  const int64_t hi = hi_b < lane0 + kLanesPerBlock ? hi_b : lane0 + kLanesPerBlock;
  if (lo >= hi) {
    // Padding row (bounds (0, 0)) or a tile outside the row's bounds: the
    // whole block leaves together, before any barrier.
    if (threadIdx.x == 0) {
      partials[2 * part] = kKeyMax;
      partials[2 * part + 1] = kI32Max;
    }
    return;
  }
  uint32_t mid[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mid[i] = midstate[i];
  uint32_t tmpl[NB * 16];
#pragma unroll
  for (int i = 0; i < NB * 16; ++i) tmpl[i] = tail[row * (NB * 16) + i];
  uint32_t th = 0xFFFFFFFFu;
  if (SIEVE) th = *reinterpret_cast<volatile unsigned int*>(th_word);

  Best b{kKeyMax, kI32Max};
  const uint32_t row_base = row * n_lanes;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    uint32_t h0, h1;
    bmt::lane_hash<NB>(mid, tmpl, da, uint32_t(i), h0, h1);
    // Sieve: ties on h0 survive, so a lane equal on h0 but lower on
    // (h1, index) is never lost.
    if (!SIEVE || h0 <= th) bmt::fold(b, h0, h1, row_base + uint32_t(i));
  }
  b = bmt::block_min(b);
  if (threadIdx.x == 0) bmt::write_partial(b, SIEVE, th_word, partials, part);
}

template <int NB, bool SIEVE>
void launch(dim3 grid, cudaStream_t s, const uint32_t* midstate,
            const uint32_t* tail, const int32_t* bounds, uint32_t n_lanes,
            const bmt::DigitArgs& da, unsigned int* th_word,
            unsigned long long* partials) {
  minhash_kernel<NB, SIEVE><<<grid, kThreads, 0, s>>>(
      midstate, tail, bounds, n_lanes, da, th_word, partials);
}

}  // namespace

extern "C" {

// Number of (key, idx) partials -- two uint64 each -- a dispatch writes.
long long bmt_sha256_minhash_partials(int batch, int k) {
  long long n_lanes = 1;
  for (int j = 0; j < k; ++j) n_lanes *= 10;
  return (n_lanes + kLanesPerBlock - 1) / kLanesPerBlock * batch;
}

// Launch one dispatch on `stream`.  Device pointers: midstate (8,) u32,
// tail (batch, 16 * n_tail_blocks) u32, bounds (batch, 2) i32, th_word (1,)
// u32 holding the threshold (sieve only, lowered in place), partials
// (2 * bmt_sha256_minhash_partials,) u64 scratch, out (3,) i64.  Host
// pointers: digit_word / digit_shift, k entries each, most significant
// digit first.  Returns 0, a negative code for arguments the kernel does
// not take, or the cudaError_t of the launches.
int bmt_sha256_minhash(const uint32_t* midstate, const uint32_t* tail,
                       const int32_t* bounds, int batch, int n_tail_blocks,
                       int k, const int* digit_word, const int* digit_shift,
                       int sieve, unsigned int* th_word,
                       unsigned long long* partials, long long* out,
                       void* stream) {
  if (n_tail_blocks != 1 && n_tail_blocks != 2) return -1;
  if (k < 1 || k > bmt::kMaxDigits) return -2;
  if (batch < 1 || batch > 65535) return -3;
  long long n_lanes = 1;
  for (int j = 0; j < k; ++j) n_lanes *= 10;
  if (n_lanes * batch > 0x7FFFFFFFLL) return -4;
  if (sieve && th_word == nullptr) return -5;
  bmt::DigitArgs da{};
  da.k = k;
  da.base_word = digit_word[0];
  for (int j = 0; j < k; ++j) {
    if (digit_word[j] < da.base_word) da.base_word = digit_word[j];
  }
  for (int j = 0; j < k; ++j) {
    const int rel = digit_word[j] - da.base_word;
    if (rel >= bmt::kDigitSlots || digit_word[j] >= 16 * n_tail_blocks) return -6;
    if (digit_shift[j] < 0 || digit_shift[j] > 24 || digit_shift[j] % 8) return -7;
    da.word[j] = digit_word[j];
    da.shift[j] = digit_shift[j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(unsigned((n_lanes + kLanesPerBlock - 1) / kLanesPerBlock),
                  unsigned(batch));
  const uint32_t nl = uint32_t(n_lanes);
  if (n_tail_blocks == 1) {
    if (sieve) launch<1, true>(grid, s, midstate, tail, bounds, nl, da, th_word, partials);
    else launch<1, false>(grid, s, midstate, tail, bounds, nl, da, th_word, partials);
  } else {
    if (sieve) launch<2, true>(grid, s, midstate, tail, bounds, nl, da, th_word, partials);
    else launch<2, false>(grid, s, midstate, tail, bounds, nl, da, th_word, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  bmt::finalize_kernel<<<1, bmt::kFinalThreads, 0, s>>>(partials, int(grid.x * grid.y), out);
  return int(cudaGetLastError());
}

}  // extern "C"
