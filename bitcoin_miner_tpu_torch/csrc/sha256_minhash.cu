// Hopper (sm_90a) kernel of the SHA-256 min-hash sweep.
//
// Replaces the Pallas kernel bitcoin_miner_tpu/ops/pallas_sha256.py::
// _build_call, in both forms: the full (h0, h1) lexicographic min-fold
// (sieve=False, bound by make_pallas_minhash / make_pallas_minhash_dyn) and
// the two-stage sieve (sieve=True, the miner's main path).  One binary
// serves every digit class d in [k, 20]: k, the k low digits' (word,
// shift) positions and the resume point below are runtime arguments; the
// template instances are the tail-block count, the block of the first
// low-digit word and the sieve.
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
// 12 B of device traffic per lane for the whole dispatch (the ~73 KB
// template table of a 1024-row dispatch is read once per block and stays
// in L1/L2).  So every lane's state stays in registers, each thread folds
// a running min, and device memory is touched only for the per-block
// partial and the final three words.  What is not lane-dependent is taken
// off the ALU pipe:
//   - Runs of 10 lanes.  A thread takes runs r of 10 consecutive lanes
//     [10 r, 10 r + 10); the k - 1 upper low digits are the digits of r,
//     made (by division) and ORed into their word slots once per run.
//     The thread's message words sit in a shared-memory column; per lane
//     it stores the one word that holds the lowest digit ('0' + j, one add
//     per lane) and loads the block's 16 words with LDS (the MIO pipe):
//     no division and no runtime word select per lane.
//   - The row's constant prefix.  A block works on one chunk row, whose
//     template is fixed, so every round before the first low-digit word
//     (word 16 FB + p) reads the same words for every lane: thread 0 runs
//     the tail blocks before FB and rounds [0, p) of block FB once per
//     block into shared memory, and each lane resumes at round p
//     (compress_from's switch).  FB and p are worked out on the host.
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
using bmt::kDigitSlots;
using bmt::kI32Max;
using bmt::kKeyMax;
using bmt::kMaxDigits;

constexpr int kThreads = 256;
constexpr int kRunsPerThread = 2;
constexpr int kRunsPerBlock = kThreads * kRunsPerThread;  // 5120 lanes

// The digit layout of a dispatch, from the host.  The k low digits touch
// n_slots consecutive tail words from base_word on; the lowest digit
// (lane % 10) lies in slot low_rel, the k - 1 upper ones (the run's
// digits) in up_rel.
struct RunArgs {
  int k;                         // low digits, 1..9
  int p;                         // rounds of block FB before the first low-digit word
  uint32_t n_lanes;              // 10^k lanes per row
  int base_word;                 // first tail word a low digit touches
  int n_slots;                   // tail words the low digits touch, 1..3
  int low_rel;                   // slot of the lowest digit
  uint32_t low_zero;             // its ASCII '0' in place in the slot word
  uint32_t low_step;             // one step of that digit: 1 << its shift
  int up_rel[kMaxDigits - 1];    // upper digit j (most significant first): slot
  int up_shift[kMaxDigits - 1];  // and the left shift of its ASCII byte
};

// grid (ceil(10^(k-1) / kRunsPerBlock), B): block (x, row) hashes runs
// [x * kRunsPerBlock, (x + 1) * kRunsPerBlock) of chunk row `row` -- run r
// is lanes [10 r, 10 r + 10) -- and writes one (key, idx) partial.  FB is
// the tail block of the first low-digit word (base_word = 16 FB + p).
template <int NB, int FB, bool SIEVE>
__global__ void __launch_bounds__(kThreads)
    minhash_kernel(const uint32_t* __restrict__ midstate,
                   const uint32_t* __restrict__ tail,
                   const int32_t* __restrict__ bounds, RunArgs ra,
                   unsigned int* th_word,
                   unsigned long long* __restrict__ partials) {
  // Each thread's words of tail blocks FB.., one column per thread: word
  // 16 FB + i of thread t at s_msg[i][t], so a warp's loads of one word
  // hit 32 banks.  s_pre: the state entering block FB and the state
  // after its first p rounds, the same for every lane of the row.
  constexpr int kColWords = (NB - FB) * 16;
  __shared__ uint32_t s_msg[kColWords][kThreads];
  __shared__ uint32_t s_pre[16];
  const uint32_t row = blockIdx.y;
  const uint32_t part = row * gridDim.x + blockIdx.x;
  const int32_t b_lo = bounds[2 * row], b_hi = bounds[2 * row + 1];
  const uint32_t lo = b_lo > 0 ? uint32_t(b_lo) : 0u;
  const uint32_t hi =
      b_hi < 0 ? 0u : (uint32_t(b_hi) < ra.n_lanes ? uint32_t(b_hi) : ra.n_lanes);
  // The block's runs that hold a valid lane.
  const uint32_t run0 = blockIdx.x * kRunsPerBlock;
  const uint32_t r_lo = lo / 10u > run0 ? lo / 10u : run0;
  const uint32_t r_end = (hi + 9u) / 10u;
  const uint32_t r_hi = r_end < run0 + kRunsPerBlock ? r_end : run0 + kRunsPerBlock;
  if (lo >= hi || r_lo >= r_hi) {
    // Padding row (bounds (0, 0)) or a tile outside the row's bounds: the
    // whole block leaves together, before any barrier.
    if (threadIdx.x == 0) {
      partials[2 * part] = kKeyMax;
      partials[2 * part + 1] = kI32Max;
    }
    return;
  }
  const uint32_t* trow = tail + row * (NB * 16);
  if (threadIdx.x == 0) {
    // The row's constant prefix, once per block: the tail blocks before
    // FB, then rounds [0, p) of block FB, which read no low-digit word.
    uint32_t st[8], w[16], mid[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = midstate[i];
    if constexpr (FB == 1) {
      uint32_t out[8];
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = trow[i];
      bmt::compress(st, w, out);
#pragma unroll
      for (int i = 0; i < 8; ++i) st[i] = out[i];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = trow[FB * 16 + i];
    bmt::compress_prefix(st, w, ra.p, mid);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s_pre[i] = st[i];
      s_pre[8 + i] = mid[i];
    }
  }
  uint32_t* col = &s_msg[0][threadIdx.x];
#pragma unroll
  for (int i = 0; i < kColWords; ++i) col[i * kThreads] = trow[FB * 16 + i];
  uint32_t slot_t[kDigitSlots];
#pragma unroll
  for (int s = 0; s < kDigitSlots; ++s) {
    slot_t[s] = s < ra.n_slots ? trow[ra.base_word + s] : 0u;
  }
  const int base_col = ra.base_word - FB * 16;
  uint32_t* const low_word = col + (base_col + ra.low_rel) * kThreads;
  __syncthreads();
  uint32_t st[8], mid[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    st[i] = s_pre[i];
    mid[i] = s_pre[8 + i];
  }
  uint32_t th = 0xFFFFFFFFu;
  if (SIEVE) th = *reinterpret_cast<volatile unsigned int*>(th_word);

  Best b{kKeyMax, kI32Max};
  const uint32_t row_base = row * ra.n_lanes;
  for (uint32_t r = r_lo + threadIdx.x; r < r_hi; r += kThreads) {
    // Once per run: the k - 1 upper digits (the digits of r) and the
    // lowest digit's '0' into the slot words, written to the column.
    uint32_t slot[kDigitSlots];
#pragma unroll
    for (int s = 0; s < kDigitSlots; ++s) {
      slot[s] = slot_t[s] | (ra.low_rel == s ? ra.low_zero : 0u);
    }
    uint32_t x = r;
#pragma unroll
    for (int j = kMaxDigits - 2; j >= 0; --j) {
      if (j < ra.k - 1) {
        const uint32_t q = x / 10u;
        const uint32_t c = (48u + (x - q * 10u)) << ra.up_shift[j];
        x = q;
#pragma unroll
        for (int s = 0; s < kDigitSlots; ++s) slot[s] |= ra.up_rel[j] == s ? c : 0u;
      }
    }
#pragma unroll
    for (int s = 0; s < kDigitSlots; ++s) {
      if (s < ra.n_slots) col[(base_col + s) * kThreads] = slot[s];
    }
    uint32_t v = ra.low_rel == 0 ? slot[0] : (ra.low_rel == 1 ? slot[1] : slot[2]);
    // Per lane: the lowest digit's word, then the message from the column.
    const uint32_t lane0 = r * 10u;
#pragma unroll 1
    for (uint32_t j = 0; j < 10u; ++j, v += ra.low_step) {
      *low_word = v;
      uint32_t w[16], out[8];
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = col[i * kThreads];
      bmt::compress_from(st, mid, ra.p, w, out);
      if constexpr (NB == 2 && FB == 0) {
        uint32_t out2[8];
#pragma unroll
        for (int i = 0; i < 16; ++i) w[i] = col[(16 + i) * kThreads];
        bmt::compress(out, w, out2);
        out[0] = out2[0];
        out[1] = out2[1];
      }
      // Lanes outside the row's bounds are hashed with their run but not
      // folded.  Sieve: ties on h0 survive, so a lane equal on h0 but
      // lower on (h1, index) is never lost.
      const uint32_t lane = lane0 + j;
      if (lane >= lo && lane < hi && (!SIEVE || out[0] <= th)) {
        bmt::fold(b, out[0], out[1], row_base + lane);
      }
    }
  }
  b = bmt::block_min(b);
  if (threadIdx.x == 0) bmt::write_partial(b, SIEVE, th_word, partials, part);
}

template <int NB, int FB, bool SIEVE>
void launch(dim3 grid, cudaStream_t s, const uint32_t* midstate,
            const uint32_t* tail, const int32_t* bounds, const RunArgs& ra,
            unsigned int* th_word, unsigned long long* partials) {
  minhash_kernel<NB, FB, SIEVE><<<grid, kThreads, 0, s>>>(
      midstate, tail, bounds, ra, th_word, partials);
}

template <bool SIEVE>
void launch_layout(int n_tail_blocks, int fb, dim3 grid, cudaStream_t s,
                   const uint32_t* midstate, const uint32_t* tail,
                   const int32_t* bounds, const RunArgs& ra,
                   unsigned int* th_word, unsigned long long* partials) {
  if (n_tail_blocks == 1) {
    launch<1, 0, SIEVE>(grid, s, midstate, tail, bounds, ra, th_word, partials);
  } else if (fb == 0) {
    launch<2, 0, SIEVE>(grid, s, midstate, tail, bounds, ra, th_word, partials);
  } else {
    launch<2, 1, SIEVE>(grid, s, midstate, tail, bounds, ra, th_word, partials);
  }
}

uint32_t pow10(int n) {
  uint32_t v = 1;
  for (int j = 0; j < n; ++j) v *= 10u;
  return v;
}

}  // namespace

extern "C" {

// Number of (key, idx) partials -- two uint64 each -- a dispatch writes.
long long bmt_sha256_minhash_partials(int batch, int k) {
  if (k < 1 || k > kMaxDigits) return 0;
  return (long long)((pow10(k - 1) + kRunsPerBlock - 1) / kRunsPerBlock) * batch;
}

// Launch one dispatch on `stream`.  Device pointers: midstate (8,) u32,
// tail (batch, 16 * n_tail_blocks) u32, bounds (batch, 2) i32, th_word (1,)
// u32 holding the threshold (sieve only, lowered in place), partials
// (2 * bmt_sha256_minhash_partials,) u64 scratch, out (3,) i64.  Host
// pointers: digit_word / digit_shift, k entries each, most significant
// digit first.  first_block and resume_round locate the first low-digit
// word (16 * first_block + resume_round): the row's rounds before it run
// once per block.  Returns 0, a negative code for arguments the kernel
// does not take, or the cudaError_t of the launches.
int bmt_sha256_minhash(const uint32_t* midstate, const uint32_t* tail,
                       const int32_t* bounds, int batch, int n_tail_blocks,
                       int k, const int* digit_word, const int* digit_shift,
                       int first_block, int resume_round,
                       int sieve, unsigned int* th_word,
                       unsigned long long* partials, long long* out,
                       void* stream) {
  if (n_tail_blocks != 1 && n_tail_blocks != 2) return -1;
  if (k < 1 || k > kMaxDigits) return -2;
  if (batch < 1 || batch > 65535) return -3;
  if ((long long)pow10(k) * batch > 0x7FFFFFFFLL) return -4;
  if (sieve && th_word == nullptr) return -5;
  RunArgs ra{};
  ra.k = k;
  ra.n_lanes = pow10(k);
  ra.base_word = digit_word[0];
  int last_word = digit_word[0];
  for (int j = 0; j < k; ++j) {
    if (digit_word[j] < ra.base_word) ra.base_word = digit_word[j];
    if (digit_word[j] > last_word) last_word = digit_word[j];
  }
  ra.n_slots = last_word - ra.base_word + 1;
  if (ra.n_slots > kDigitSlots || last_word >= 16 * n_tail_blocks) return -6;
  if (first_block < 0 || first_block >= n_tail_blocks || resume_round < 0 ||
      resume_round > 15 || 16 * first_block + resume_round != ra.base_word) {
    return -8;
  }
  ra.p = resume_round;
  for (int j = 0; j < k; ++j) {
    if (digit_shift[j] < 0 || digit_shift[j] > 24 || digit_shift[j] % 8) return -7;
    const int rel = digit_word[j] - ra.base_word;
    if (j < k - 1) {
      ra.up_rel[j] = rel;
      ra.up_shift[j] = digit_shift[j];
    } else {
      ra.low_rel = rel;
      ra.low_zero = 48u << digit_shift[j];
      ra.low_step = 1u << digit_shift[j];
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((pow10(k - 1) + kRunsPerBlock - 1) / kRunsPerBlock, unsigned(batch));
  if (sieve) {
    launch_layout<true>(n_tail_blocks, first_block, grid, s, midstate, tail,
                        bounds, ra, th_word, partials);
  } else {
    launch_layout<false>(n_tail_blocks, first_block, grid, s, midstate, tail,
                         bounds, ra, th_word, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  bmt::finalize_kernel<<<1, bmt::kFinalThreads, 0, s>>>(partials, int(grid.x * grid.y), out);
  return int(cudaGetLastError());
}

}  // extern "C"
