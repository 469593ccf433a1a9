// Hopper (sm_90a) kernel of the BLAKE2b-64 min-hash sweep.
//
// Replaces bitcoin_miner_tpu/ops/blake2b.py::make_blake2b_kernel_body, the
// reference's device program for the blake2b64 workload (a jnp body under
// jax.jit, not a Pallas kernel), in both of its sieve forms.  One binary
// serves every digit class: k, the k low digits' positions and the blocks'
// byte counters are runtime arguments; the template instances are the
// tail-block count, the first tail block holding a low digit and the sieve.
//
// Function, per dispatch of B chunk rows x 10^k lanes:
//   lane (row, i) is valid when lo_row <= i < hi_row (bounds (B, 2));
//   its message tail is the row's template with lane i's k low ASCII digits
//   ORed in, compressed from the host-folded midstate (t = tail_off + 128
//   for the first of two tail blocks, t = msg_len and the final flag for
//   the last); the digest's first 8 bytes are h'[0] little-endian, read
//   big-endian: h0 = bswap32(lo32(h'[0])), h1 = bswap32(hi32(h'[0])).
//   Result: min over valid lanes of (h0, h1, row * 10^k + i), lowest index
//   on a tie.  Sieve form: the min if its h0 <= thresh, otherwise
//   (U32_MAX, U32_MAX, I32_MAX) -- also the output when no lane is valid.
//
// Word order.  The operands keep the reference's layout: each u64 word q
// of the midstate and of the tail as the u32 pair (hi, lo) at indices
// (2q, 2q + 1), the reverse of little-endian u32 order.  The kernel
// composes m[q] = (hi << 32) | lo explicitly; the host entry point turns
// each digit's (u32 word, shift) into (u64 word, shift within it).
//
// Bound: integer instruction issue.  A lane costs one BLAKE2b compression
// per tail block -- 12 rounds of 8 G's, each 4 u64 adds (IADD3 + IADD3.X),
// 4 u64 XORs (2 LOP3 each) and the rotations by 24, 16, 63 (2 funnel
// shifts each; rotr 32 swaps the halves) -- about 2,000 lane-dependent
// instructions per block (ops/blake2b.py lane_ops counts them), against
// 12 B of device traffic per lane for the dispatch.  So the lane state
// stays in registers and device memory is touched only for the template
// row, the block partials and the result.  This first kernel is simple:
//   - The message words sit in a shared-memory column per thread (word i
//     of thread t at s_col[i][t]); per lane the one or two u64 words that
//     hold a low digit are stored (a runtime index into shared memory, not
//     into registers) and the 16 words of each block are loaded with
//     compile-time indices, so the message stays in registers.
//   - The digits are made per lane by division by 10.
//   - A tail block before the first low-digit word is the same for every
//     lane of the row: thread 0 compresses it once per CUDA block.
//   What is left for later: runs of 10 lanes (only the lowest digit
//   changes, as in sha256_minhash.cu) and round 0's G's that read no
//   low-digit word, which are per row.
//
// Reduction: as in sha256_minhash.cu -- each thread folds a running min,
// the block reduces it to one partial, a one-block kernel reduces the
// partials (minhash_fold.cuh); the sieve threshold is one device word that
// blocks lower with atomicMin after their fold and read, possibly stale,
// before it.  A stale value is only looser and ties on h0 survive, so the
// output is the function above whatever the block order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "minhash_fold.cuh"

namespace {

using bmt::Best;
using bmt::kI32Max;
using bmt::kKeyMax;

constexpr int kThreads = 128;
constexpr int kLanesPerThread = 32;
constexpr int kLanesPerBlock = kThreads * kLanesPerThread;  // 4096 lanes
constexpr int kMaxDigits = 9;

// The message schedule (RFC 7693 section 2.7), rounds 10 and 11 repeat
// rows 0 and 1; used only as template arguments, so every message-word
// index is a compile-time constant.
__host__ __device__ constexpr int sigma(int r, int i) {
  constexpr int s[10][16] = {
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
      {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
      {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
      {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
      {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
      {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
      {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
      {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
      {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
      {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
  };
  return s[r % 10][i];
}

__device__ __forceinline__ uint64_t pack(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// rotr64(x, n) for 0 < n < 32 as two funnel shifts of the halves.
template <int N>
__device__ __forceinline__ uint64_t rotr_lo(uint64_t x) {
  const uint32_t lo = static_cast<uint32_t>(x), hi = static_cast<uint32_t>(x >> 32);
  return pack(__funnelshift_r(hi, lo, N), __funnelshift_r(lo, hi, N));
}

// rotr64(x, 63) = rotl64(x, 1).
__device__ __forceinline__ uint64_t rotr63(uint64_t x) {
  const uint32_t lo = static_cast<uint32_t>(x), hi = static_cast<uint32_t>(x >> 32);
  return pack(__funnelshift_l(lo, hi, 1), __funnelshift_l(hi, lo, 1));
}

// rotr64(x, 32): the halves swap.
__device__ __forceinline__ uint64_t rotr32(uint64_t x) { return (x >> 32) | (x << 32); }

template <int X, int Y>
__device__ __forceinline__ void g(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d,
                                  const uint64_t* m) {
  a = a + b + m[X];
  d = rotr32(d ^ a);
  c = c + d;
  b = rotr_lo<24>(b ^ c);
  a = a + b + m[Y];
  d = rotr_lo<16>(d ^ a);
  c = c + d;
  b = rotr63(b ^ c);
}

template <int R>
__device__ __forceinline__ void round_(uint64_t* v, const uint64_t* m) {
  g<sigma(R, 0), sigma(R, 1)>(v[0], v[4], v[8], v[12], m);
  g<sigma(R, 2), sigma(R, 3)>(v[1], v[5], v[9], v[13], m);
  g<sigma(R, 4), sigma(R, 5)>(v[2], v[6], v[10], v[14], m);
  g<sigma(R, 6), sigma(R, 7)>(v[3], v[7], v[11], v[15], m);
  g<sigma(R, 8), sigma(R, 9)>(v[0], v[5], v[10], v[15], m);
  g<sigma(R, 10), sigma(R, 11)>(v[1], v[6], v[11], v[12], m);
  g<sigma(R, 12), sigma(R, 13)>(v[2], v[7], v[8], v[13], m);
  g<sigma(R, 14), sigma(R, 15)>(v[3], v[4], v[9], v[14], m);
}

// One compression of message m from chaining state h with byte counter t.
// FINAL: the last block (v[14] inverted); only h'[0] is returned in h[0]
// then, else all 8 words of h are updated.
template <bool FINAL>
__device__ __forceinline__ void compress(uint64_t* h, const uint64_t* m, uint64_t t) {
  uint64_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = h[i];
  v[8] = 0x6A09E667F3BCC908ull;
  v[9] = 0xBB67AE8584CAA73Bull;
  v[10] = 0x3C6EF372FE94F82Bull;
  v[11] = 0xA54FF53A5F1D36F1ull;
  v[12] = 0x510E527FADE682D1ull ^ t;
  v[13] = 0x9B05688C2B3E6C1Full;
  v[14] = FINAL ? ~0x1F83D9ABFB41BD6Bull : 0x1F83D9ABFB41BD6Bull;
  v[15] = 0x5BE0CD19137E2179ull;
  round_<0>(v, m);
  round_<1>(v, m);
  round_<2>(v, m);
  round_<3>(v, m);
  round_<4>(v, m);
  round_<5>(v, m);
  round_<6>(v, m);
  round_<7>(v, m);
  round_<8>(v, m);
  round_<9>(v, m);
  round_<10>(v, m);
  round_<11>(v, m);
  if (FINAL) {
    h[0] ^= v[0] ^ v[8];
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[8 + i];
  }
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
}

// The digit layout of a dispatch, from the host.  The k low digits touch
// n_slots (1 or 2) consecutive u64 tail words from base_q on; digit j
// (most significant first) lies in slot rel[j] at bit shift[j].
struct DigitArgs {
  int k;               // low digits, 1..9
  uint32_t n_lanes;    // 10^k lanes per row
  int base_q;          // first u64 tail word a low digit touches
  int n_slots;         // 1 or 2
  int rel[kMaxDigits];
  int shift[kMaxDigits];
  uint64_t t_first;    // byte counter of the first of two tail blocks
  uint64_t t_last;     // msg_len: the counter of the last block
};

// grid (ceil(10^k / kLanesPerBlock), B): block (x, row) hashes lanes
// [x * kLanesPerBlock, (x + 1) * kLanesPerBlock) of chunk row `row` and
// writes one (key, idx) partial.  FB is the tail block of the first
// low-digit word (base_q / 16).
template <int NB, int FB, bool SIEVE>
__global__ void __launch_bounds__(kThreads)
    blake2b_kernel(const uint32_t* __restrict__ midstate,
                   const uint32_t* __restrict__ tail,
                   const int32_t* __restrict__ bounds, DigitArgs da,
                   unsigned int* th_word,
                   unsigned long long* __restrict__ partials) {
  // Each thread's u64 words of tail blocks FB.., one column per thread.
  constexpr int kColWords = (NB - FB) * 16;
  __shared__ uint64_t s_col[kColWords][kThreads];
  __shared__ uint64_t s_tmpl[NB * 16];
  __shared__ uint64_t s_h[8];
  const uint32_t row = blockIdx.y;
  const uint32_t part = row * gridDim.x + blockIdx.x;
  const int32_t b_lo = bounds[2 * row], b_hi = bounds[2 * row + 1];
  const uint32_t lo = b_lo > 0 ? uint32_t(b_lo) : 0u;
  const uint32_t hi =
      b_hi < 0 ? 0u : (uint32_t(b_hi) < da.n_lanes ? uint32_t(b_hi) : da.n_lanes);
  const uint32_t tile0 = blockIdx.x * kLanesPerBlock;
  const uint32_t l_lo = lo > tile0 ? lo : tile0;
  const uint32_t l_hi = hi < tile0 + kLanesPerBlock ? hi : tile0 + kLanesPerBlock;
  if (l_lo >= l_hi) {
    // Padding row (bounds (0, 0)) or a tile outside the row's bounds: the
    // whole block leaves together, before any barrier.
    if (threadIdx.x == 0) {
      partials[2 * part] = kKeyMax;
      partials[2 * part + 1] = kI32Max;
    }
    return;
  }
  const uint32_t* trow = tail + row * (NB * 32);
  for (int q = threadIdx.x; q < NB * 16; q += kThreads) {
    s_tmpl[q] = pack(trow[2 * q], trow[2 * q + 1]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // The chaining state entering block FB, once per block.
    uint64_t h[8], m[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = pack(midstate[2 * i], midstate[2 * i + 1]);
    if constexpr (FB == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = s_tmpl[i];
      compress<false>(h, m, da.t_first);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s_h[i] = h[i];
  }
  uint64_t* col = &s_col[0][threadIdx.x];
#pragma unroll
  for (int i = 0; i < kColWords; ++i) col[i * kThreads] = s_tmpl[FB * 16 + i];
  const int base_col = da.base_q - FB * 16;
  const uint64_t slot0_t = s_tmpl[da.base_q];
  const uint64_t slot1_t = da.n_slots > 1 ? s_tmpl[da.base_q + 1] : 0ull;
  __syncthreads();
  uint64_t h_in[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h_in[i] = s_h[i];
  uint32_t th = 0xFFFFFFFFu;
  if (SIEVE) th = *reinterpret_cast<volatile unsigned int*>(th_word);

  Best b{kKeyMax, kI32Max};
  const uint32_t row_base = row * da.n_lanes;
  for (uint32_t lane = l_lo + threadIdx.x; lane < l_hi; lane += kThreads) {
    // The lane's k low digits into its one or two digit words.
    uint64_t s0 = slot0_t, s1 = slot1_t;
    uint32_t x = lane;
#pragma unroll
    for (int j = kMaxDigits - 1; j >= 0; --j) {
      if (j < da.k) {
        const uint32_t q = x / 10u;
        const uint64_t c = static_cast<uint64_t>(48u + (x - q * 10u)) << da.shift[j];
        x = q;
        if (da.rel[j] == 0) {
          s0 |= c;
        } else {
          s1 |= c;
        }
      }
    }
    col[base_col * kThreads] = s0;
    if (da.n_slots > 1) col[(base_col + 1) * kThreads] = s1;
    uint64_t h[8], m[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = h_in[i];
    if constexpr (NB == 2 && FB == 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) m[i] = col[i * kThreads];
      compress<false>(h, m, da.t_first);
    }
    constexpr int kLast = (NB - 1 - FB) * 16;  // the last block's column offset
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = col[(kLast + i) * kThreads];
    compress<true>(h, m, da.t_last);
    const uint32_t h0 = bswap32(static_cast<uint32_t>(h[0]));
    const uint32_t h1 = bswap32(static_cast<uint32_t>(h[0] >> 32));
    // Sieve: ties on h0 survive, so a lane equal on h0 but lower on (h1,
    // index) is never lost.
    if (!SIEVE || h0 <= th) bmt::fold(b, h0, h1, row_base + lane);
  }
  b = bmt::block_min(b);
  if (threadIdx.x == 0) bmt::write_partial(b, SIEVE, th_word, partials, part);
}

template <int NB, int FB, bool SIEVE>
void launch(dim3 grid, cudaStream_t s, const uint32_t* midstate,
            const uint32_t* tail, const int32_t* bounds, const DigitArgs& da,
            unsigned int* th_word, unsigned long long* partials) {
  blake2b_kernel<NB, FB, SIEVE><<<grid, kThreads, 0, s>>>(
      midstate, tail, bounds, da, th_word, partials);
}

template <bool SIEVE>
void launch_layout(int n_tail_blocks, int fb, dim3 grid, cudaStream_t s,
                   const uint32_t* midstate, const uint32_t* tail,
                   const int32_t* bounds, const DigitArgs& da,
                   unsigned int* th_word, unsigned long long* partials) {
  if (n_tail_blocks == 1) {
    launch<1, 0, SIEVE>(grid, s, midstate, tail, bounds, da, th_word, partials);
  } else if (fb == 0) {
    launch<2, 0, SIEVE>(grid, s, midstate, tail, bounds, da, th_word, partials);
  } else {
    launch<2, 1, SIEVE>(grid, s, midstate, tail, bounds, da, th_word, partials);
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
long long bmt_blake2b_minhash_partials(int batch, int k) {
  if (k < 1 || k > kMaxDigits) return 0;
  return (long long)((pow10(k) + kLanesPerBlock - 1) / kLanesPerBlock) * batch;
}

// Launch one dispatch on `stream`.  Device pointers: midstate (16,) u32,
// tail (batch, 32 * n_tail_blocks) u32, both as (hi, lo) pairs of u64
// words; bounds (batch, 2) i32; th_word (1,) u32 holding the threshold
// (sieve only, lowered in place); partials (2 *
// bmt_blake2b_minhash_partials,) u64 scratch; out (3,) i64.  Host pointers:
// digit_word / digit_shift, k entries each, most significant digit first,
// in the operands' u32 (word, shift) terms.  t_first / t_last: the byte
// counters of the first of two tail blocks and of the last block.
// Returns 0, a negative code for arguments the kernel does not take, or
// the cudaError_t of the launches.
int bmt_blake2b_minhash(const uint32_t* midstate, const uint32_t* tail,
                        const int32_t* bounds, int batch, int n_tail_blocks,
                        int k, const int* digit_word, const int* digit_shift,
                        unsigned long long t_first, unsigned long long t_last,
                        int sieve, unsigned int* th_word,
                        unsigned long long* partials, long long* out,
                        void* stream) {
  if (n_tail_blocks != 1 && n_tail_blocks != 2) return -1;
  if (k < 1 || k > kMaxDigits) return -2;
  if (batch < 1 || batch > 65535) return -3;
  if ((long long)pow10(k) * batch > 0x7FFFFFFFLL) return -4;
  if (sieve && th_word == nullptr) return -5;
  DigitArgs da{};
  da.k = k;
  da.n_lanes = pow10(k);
  da.t_first = t_first;
  da.t_last = t_last;
  int q[kMaxDigits];
  int last_q = -1;
  da.base_q = 1 << 30;
  for (int j = 0; j < k; ++j) {
    const int w = digit_word[j], s = digit_shift[j];
    if (w < 0 || w >= 32 * n_tail_blocks || s < 0 || s > 24 || s % 8) return -6;
    q[j] = w / 2;
    // The high half (even word) holds bytes 4..7 of the little-endian u64.
    da.shift[j] = s + (w % 2 == 0 ? 32 : 0);
    if (q[j] < da.base_q) da.base_q = q[j];
    if (q[j] > last_q) last_q = q[j];
  }
  da.n_slots = last_q - da.base_q + 1;
  if (da.n_slots > 2) return -7;
  for (int j = 0; j < k; ++j) da.rel[j] = q[j] - da.base_q;
  const int fb = da.base_q / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((pow10(k) + kLanesPerBlock - 1) / kLanesPerBlock, unsigned(batch));
  if (sieve) {
    launch_layout<true>(n_tail_blocks, fb, grid, s, midstate, tail, bounds, da,
                        th_word, partials);
  } else {
    launch_layout<false>(n_tail_blocks, fb, grid, s, midstate, tail, bounds, da,
                         th_word, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  bmt::finalize_kernel<<<1, bmt::kFinalThreads, 0, s>>>(partials, int(grid.x * grid.y), out);
  return int(cudaGetLastError());
}

}  // extern "C"
