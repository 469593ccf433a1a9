// Hopper (sm_90a) kernel of the factored SHA-256 min-hash sweep.
//
// Replaces the Pallas kernel bitcoin_miner_tpu/ops/pallas_sha256.py::
// _build_factored_call (bound by make_pallas_minhash_factored), in both
// forms: the full (h0, h1) lexicographic min-fold and the two-stage sieve.
// It computes the same function as sha256_minhash.cu (see there), on the
// same operands, with the lane axis of each row split in two: 10^k lanes
// are 10^k_out outer groups of 10^k_in inner lanes, lane offset
// og * 10^k_in + i.  The outer digits are the same for every lane of a
// group, so every SHA-256 round before the first inner-digit word reads
// only group-constant words: those rounds (the whole tail blocks before
// block FIB = first_inner_word / 16, and the first p = first_inner_word %
// 16 rounds of block FIB) run once per (row, outer group), not once per
// lane.
//
// One binary serves every digit class: k, k_in, p and the digits' (word,
// shift) positions are runtime arguments; the template instances are the
// tail-block count, FIB and the sieve.  The TPU kernel is static per class
// because Mosaic needs the scalar/vector split at trace time; nothing here
// does.
//
// Bound: 32-bit integer instruction throughput, as sha256_minhash.cu.
// Per lane the kernel runs rounds [p, 64) of block FIB and every later
// block; the function's lane-dependent work is the part that depends on
// the inner digits (ops/sha256_minhash.py lane_ops over the inner
// positions), and device traffic stays ~12 B per lane for the dispatch.
//
// Design.  A block takes one tile of one row: up to kThreads outer groups
// with all their inner lanes (or, when a group has more than kLaneCap
// lanes, one slice of one group).  Phase 1: thread t patches group t's
// outer digits into the row template, compresses the blocks before FIB
// and runs the first p rounds of block FIB (compress_prefix), and stores
// the state entering block FIB, the carried state and the three outer
// digit slot words in shared memory.  __syncthreads.  Phase 2: the block's
// threads walk its (group, inner lane) pairs, OR the lane's inner digits
// into the group's words and resume at round p (compress_from's switch
// enters the unrolled rounds there).  Each thread folds a running
// (h0 || h1, flat index) min; the block reduces to one partial; a one-block
// finalize reduces the partials.  The sieve threshold is one device word,
// lowered with atomicMin after a block's fold and read before phase 2; a
// stale read is only looser and ties on h0 survive, so the output is the
// pure function whatever the block order.  The flat index row * 10^k +
// og * 10^k_in + i orders lanes across groups, so the lowest index wins a
// tie across groups too.

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
constexpr int kMaxGroups = kThreads;       // phase 1: one group per thread
constexpr uint32_t kLaneCap = 1u << 18;    // lanes per block, at most
constexpr int kGroupWords = 8 + 8 + kDigitSlots;  // per group in shared memory

struct FactorArgs {
  int k_out;                  // outer digits (per group)
  int k_in;                   // inner digits (per lane)
  int p;                      // rounds of block FIB before the first inner word
  int base_word;              // first tail word any of the k digits touches
  uint32_t s_in;              // 10^k_in lanes per group
  uint32_t g_count;           // 10^k_out groups per row
  uint32_t n_lanes;           // 10^k lanes per row
  uint32_t groups_per_tile;   // groups a block takes
  uint32_t lane_tile;         // inner lanes a block takes per group
  uint32_t lane_tiles;        // tiles a group's lanes are cut into
  int out_rel[kMaxDigits];    // outer digit j: slot (word - base_word), MSB first
  int out_shift[kMaxDigits];
  int in_rel[kMaxDigits];     // inner digit j: slot, MSB first
  int in_shift[kMaxDigits];
};

// OR the n decimal digits of x (most significant first at index 0) as
// ASCII bytes into the three slot words.
BMT_FN void digits_into(uint32_t x, int n, const int rel[kMaxDigits],
                        const int shift[kMaxDigits], uint32_t slot[kDigitSlots]) {
#pragma unroll
  for (int j = kMaxDigits - 1; j >= 0; --j) {
    if (j < n) {
      const uint32_t q = x / 10u;
      const uint32_t c = (48u + (x - q * 10u)) << shift[j];
      x = q;
#pragma unroll
      for (int s = 0; s < kDigitSlots; ++s) slot[s] |= rel[j] == s ? c : 0u;
    }
  }
}

// Words of tail block BLK: the row template with the slot words ORed in.
template <int BLK, int NB>
BMT_FN void block_words(const uint32_t tmpl[NB * 16], int base_word,
                        const uint32_t slot[kDigitSlots], uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int rel = BLK * 16 + i - base_word;
    uint32_t v = tmpl[BLK * 16 + i];
#pragma unroll
    for (int s = 0; s < kDigitSlots; ++s) v |= rel == s ? slot[s] : 0u;
    w[i] = v;
  }
}

// grid (n_tiles, B): block (x, row) takes groups [g0, g1) and inner lanes
// [l0, l1) of each, and writes one (key, idx) partial.
template <int NB, int FIB, bool SIEVE>
__global__ void __launch_bounds__(kThreads)
    factored_kernel(const uint32_t* __restrict__ midstate,
                    const uint32_t* __restrict__ tail,
                    const int32_t* __restrict__ bounds, FactorArgs fa,
                    unsigned int* th_word,
                    unsigned long long* __restrict__ partials) {
  __shared__ uint32_t s_grp[kGroupWords][kMaxGroups];
  const uint32_t row = blockIdx.y;
  const uint32_t part = row * gridDim.x + blockIdx.x;
  const uint32_t gt = blockIdx.x / fa.lane_tiles;
  const uint32_t l0 = (blockIdx.x % fa.lane_tiles) * fa.lane_tile;
  const uint32_t l1 = l0 + fa.lane_tile < fa.s_in ? l0 + fa.lane_tile : fa.s_in;
  const uint32_t g0 = gt * fa.groups_per_tile;
  const uint32_t g1 = g0 + fa.groups_per_tile < fa.g_count
                          ? g0 + fa.groups_per_tile : fa.g_count;
  // The block's lane offsets are [g0 * s_in + l0, (g1 - 1) * s_in + l1).
  const int64_t lo = bounds[2 * row] > 0 ? bounds[2 * row] : 0;
  const int64_t hi = bounds[2 * row + 1] < int64_t(fa.n_lanes)
                         ? bounds[2 * row + 1] : int64_t(fa.n_lanes);
  if (lo >= hi || int64_t(g0) * fa.s_in + l0 >= hi ||
      int64_t(g1 - 1) * fa.s_in + l1 <= lo) {
    // Padding row or a tile outside the row's bounds: the whole block
    // leaves together, before any barrier.
    if (threadIdx.x == 0) {
      partials[2 * part] = kKeyMax;
      partials[2 * part + 1] = kI32Max;
    }
    return;
  }
  uint32_t tmpl[NB * 16];
#pragma unroll
  for (int i = 0; i < NB * 16; ++i) tmpl[i] = tail[row * (NB * 16) + i];

  // Phase 1: the round prefix of each group of the tile, once.
  const uint32_t n_g = g1 - g0;
  for (uint32_t gl = threadIdx.x; gl < n_g; gl += kThreads) {
    uint32_t slot[kDigitSlots] = {0u, 0u, 0u};
    digits_into(g0 + gl, fa.k_out, fa.out_rel, fa.out_shift, slot);
    uint32_t st[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = midstate[i];
    uint32_t w[16];
    if constexpr (FIB == 1) {
      uint32_t out[8];
      block_words<0, NB>(tmpl, fa.base_word, slot, w);
      bmt::compress(st, w, out);
#pragma unroll
      for (int i = 0; i < 8; ++i) st[i] = out[i];
    }
    block_words<FIB, NB>(tmpl, fa.base_word, slot, w);
    uint32_t mid[8];
    bmt::compress_prefix(st, w, fa.p, mid);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s_grp[i][gl] = st[i];
      s_grp[8 + i][gl] = mid[i];
    }
#pragma unroll
    for (int s = 0; s < kDigitSlots; ++s) s_grp[16 + s][gl] = slot[s];
  }
  __syncthreads();

  // Phase 2: every (group, inner lane) pair of the tile, resumed at round p.
  uint32_t th = 0xFFFFFFFFu;
  if (SIEVE) th = *reinterpret_cast<volatile unsigned int*>(th_word);
  Best b{kKeyMax, kI32Max};
  const uint32_t lt = l1 - l0;
  const uint32_t step_g = kThreads / lt, step_l = kThreads % lt;
  const uint32_t row_base = row * fa.n_lanes;
  uint32_t g = threadIdx.x / lt, ln = threadIdx.x % lt;
  while (g < n_g) {
    const uint32_t lane = l0 + ln;
    const uint32_t off = (g0 + g) * fa.s_in + lane;
    if (off >= lo && off < hi) {
      uint32_t slot[kDigitSlots];
#pragma unroll
      for (int s = 0; s < kDigitSlots; ++s) slot[s] = s_grp[16 + s][g];
      digits_into(lane, fa.k_in, fa.in_rel, fa.in_shift, slot);
      uint32_t st[8], mid[8], w[16], out[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        st[i] = s_grp[i][g];
        mid[i] = s_grp[8 + i][g];
      }
      block_words<FIB, NB>(tmpl, fa.base_word, slot, w);
      bmt::compress_from(st, mid, fa.p, w, out);
      if constexpr (NB == 2 && FIB == 0) {
        // The inner digits may straddle into the second block.
        uint32_t out2[8];
        block_words<1, NB>(tmpl, fa.base_word, slot, w);
        bmt::compress(out, w, out2);
        out[0] = out2[0];
        out[1] = out2[1];
      }
      // Sieve: ties on h0 survive, so a lane equal on h0 but lower on
      // (h1, index) is never lost.
      if (!SIEVE || out[0] <= th) bmt::fold(b, out[0], out[1], row_base + off);
    }
    ln += step_l;
    g += step_g;
    if (ln >= lt) {
      ln -= lt;
      ++g;
    }
  }
  b = bmt::block_min(b);
  if (threadIdx.x == 0) bmt::write_partial(b, SIEVE, th_word, partials, part);
}

// The tiling of a row's groups and lanes into blocks; returns the tile
// count (grid.x).
uint32_t tile(FactorArgs& fa) {
  if (fa.s_in <= kLaneCap) {
    fa.lane_tiles = 1;
    fa.lane_tile = fa.s_in;
    uint32_t per = kLaneCap / fa.s_in;
    per = per < 1 ? 1 : (per > uint32_t(kMaxGroups) ? kMaxGroups : per);
    const uint32_t n = (fa.g_count + per - 1) / per;
    fa.groups_per_tile = (fa.g_count + n - 1) / n;  // even tiles
    return n;
  }
  fa.lane_tiles = (fa.s_in + kLaneCap - 1) / kLaneCap;
  fa.lane_tile = (fa.s_in + fa.lane_tiles - 1) / fa.lane_tiles;
  fa.groups_per_tile = 1;
  return fa.g_count * fa.lane_tiles;
}

uint32_t pow10(int n) {
  uint32_t v = 1;
  for (int j = 0; j < n; ++j) v *= 10u;
  return v;
}

template <int NB, int FIB, bool SIEVE>
void launch(dim3 grid, cudaStream_t s, const uint32_t* midstate,
            const uint32_t* tail, const int32_t* bounds, const FactorArgs& fa,
            unsigned int* th_word, unsigned long long* partials) {
  factored_kernel<NB, FIB, SIEVE><<<grid, kThreads, 0, s>>>(
      midstate, tail, bounds, fa, th_word, partials);
}

template <bool SIEVE>
void launch_layout(int n_tail_blocks, int fib, dim3 grid, cudaStream_t s,
                   const uint32_t* midstate, const uint32_t* tail,
                   const int32_t* bounds, const FactorArgs& fa,
                   unsigned int* th_word, unsigned long long* partials) {
  if (n_tail_blocks == 1) {
    launch<1, 0, SIEVE>(grid, s, midstate, tail, bounds, fa, th_word, partials);
  } else if (fib == 0) {
    launch<2, 0, SIEVE>(grid, s, midstate, tail, bounds, fa, th_word, partials);
  } else {
    launch<2, 1, SIEVE>(grid, s, midstate, tail, bounds, fa, th_word, partials);
  }
}

}  // namespace

extern "C" {

// Number of (key, idx) partials -- two uint64 each -- a dispatch writes.
long long bmt_sha256_minhash_factored_partials(int batch, int k, int k_in) {
  if (k_in < 1 || k_in >= k || k > kMaxDigits) return 0;
  FactorArgs fa{};
  fa.s_in = pow10(k_in);
  fa.g_count = pow10(k - k_in);
  return (long long)tile(fa) * batch;
}

// Launch one dispatch on `stream`.  Device pointers: midstate (8,) u32,
// tail (batch, 16 * n_tail_blocks) u32, bounds (batch, 2) i32, th_word (1,)
// u32 holding the threshold (sieve only, lowered in place), partials
// (2 * bmt_sha256_minhash_factored_partials,) u64 scratch, out (3,) i64.
// Host pointers: digit_word / digit_shift, k entries each, most
// significant digit first; the last k_in are the inner digits.  Returns 0,
// a negative code for arguments the kernel does not take, or the
// cudaError_t of the launches.
int bmt_sha256_minhash_factored(const uint32_t* midstate, const uint32_t* tail,
                                const int32_t* bounds, int batch,
                                int n_tail_blocks, int k, int k_in,
                                const int* digit_word, const int* digit_shift,
                                int sieve, unsigned int* th_word,
                                unsigned long long* partials, long long* out,
                                void* stream) {
  if (n_tail_blocks != 1 && n_tail_blocks != 2) return -1;
  if (k < 2 || k > kMaxDigits) return -2;
  if (k_in < 1 || k_in >= k) return -8;
  if (batch < 1 || batch > 65535) return -3;
  if ((long long)pow10(k) * batch > 0x7FFFFFFFLL) return -4;
  if (sieve && th_word == nullptr) return -5;
  FactorArgs fa{};
  fa.k_out = k - k_in;
  fa.k_in = k_in;
  fa.s_in = pow10(k_in);
  fa.g_count = pow10(fa.k_out);
  fa.n_lanes = pow10(k);
  fa.base_word = digit_word[0];
  int first_inner = digit_word[fa.k_out];
  for (int j = 0; j < k; ++j) {
    if (digit_word[j] < fa.base_word) fa.base_word = digit_word[j];
    if (j >= fa.k_out && digit_word[j] < first_inner) first_inner = digit_word[j];
  }
  for (int j = 0; j < k; ++j) {
    const int rel = digit_word[j] - fa.base_word;
    if (rel >= kDigitSlots || digit_word[j] >= 16 * n_tail_blocks) return -6;
    if (digit_shift[j] < 0 || digit_shift[j] > 24 || digit_shift[j] % 8) return -7;
    if (j < fa.k_out) {
      fa.out_rel[j] = rel;
      fa.out_shift[j] = digit_shift[j];
    } else {
      fa.in_rel[j - fa.k_out] = rel;
      fa.in_shift[j - fa.k_out] = digit_shift[j];
    }
  }
  const int fib = first_inner / 16;
  fa.p = first_inner % 16;
  if (fib >= n_tail_blocks) return -9;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tile(fa), unsigned(batch));
  if (sieve) {
    launch_layout<true>(n_tail_blocks, fib, grid, s, midstate, tail, bounds, fa,
                        th_word, partials);
  } else {
    launch_layout<false>(n_tail_blocks, fib, grid, s, midstate, tail, bounds, fa,
                         th_word, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  bmt::finalize_kernel<<<1, bmt::kFinalThreads, 0, s>>>(
      partials, int(grid.x * grid.y), out);
  return int(cudaGetLastError());
}

}  // extern "C"
