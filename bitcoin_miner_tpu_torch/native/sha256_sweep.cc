// Native CPU min-hash sweep — the framework's C++ tier.
//
// The reference's only native-accelerated surface is Go's stdlib assembly
// SHA-256 invoked from its scalar miner loop (bitcoin/hash.go:13-17, see
// SURVEY §2.4); this is the equivalent for the CPU miner backend, so a
// CPU-only worker is a real peer in a heterogeneous fleet rather than a
// Python-speed stand-in.
//
// Same decomposition insight as the TPU kernel (ops/sweep.py): the hashed
// string is "<data> <nonce-decimal>", whose constant prefix blocks fold
// into a midstate once, and whose tail block(s) change only in the decimal
// digit bytes — maintained incrementally (carry-propagating digit buffer,
// repad only when the digit count grows).
//
// Contract (bit-exact vs bitcoin/hash.go): hash = big-endian u64 of the
// first 8 digest bytes; sweep returns the minimum with lowest-nonce ties.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// The SHA-NI path is gated per-function with a target attribute (not
// TU-wide -msha flags): the rest of the object must stay baseline x86-64,
// or the compiler could auto-vectorize the portable code with SSE4.1+ and
// SIGILL on older CPUs despite the runtime dispatch of compress_shani.
#if defined(__x86_64__) && (defined(__GNUC__) || defined(__clang__))
#include <immintrin.h>
#define HAVE_SHANI_BUILD 1
#endif

namespace {

const uint32_t K[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
};

const uint32_t H0[8] = {
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

void compress(uint32_t st[8], const uint8_t *block) {
  uint32_t w[64];
  for (int t = 0; t < 16; ++t) {
    w[t] = (uint32_t(block[t * 4]) << 24) | (uint32_t(block[t * 4 + 1]) << 16) |
           (uint32_t(block[t * 4 + 2]) << 8) | uint32_t(block[t * 4 + 3]);
  }
  for (int t = 16; t < 64; ++t) {
    uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
    uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  for (int t = 0; t < 64; ++t) {
    uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = g ^ (e & (f ^ g));
    uint32_t t1 = h + s1 + ch + K[t] + w[t];
    uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = b ^ ((b ^ a) & (b ^ c));
    uint32_t t2 = s0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

#ifdef HAVE_SHANI_BUILD
// SHA-NI two-rounds-per-instruction compression (the hardware path the Go
// stdlib's assembly uses on this class of CPU).  State lives in the
// ABEF/CDGH register pairing the sha256rnds2 instruction expects; message
// blocks are produced by the msg1/msg2 schedule helpers over a rotating
// 4-register window of W[t-16..t-1].
__attribute__((target("sha,sse4.1,ssse3")))
void compress_shani(uint32_t st[8], const uint8_t *block) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i TMP = _mm_loadu_si128(reinterpret_cast<const __m128i *>(&st[0]));
  __m128i STATE1 = _mm_loadu_si128(reinterpret_cast<const __m128i *>(&st[4]));
  TMP = _mm_shuffle_epi32(TMP, 0xB1);          /* CDAB */
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);    /* EFGH */
  __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);    /* ABEF */
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);         /* CDGH */

  const __m128i ABEF_SAVE = STATE0;
  const __m128i CDGH_SAVE = STATE1;

  __m128i m[4];
  for (int g = 0; g < 16; ++g) {
    __m128i cur;
    if (g < 4) {
      cur = _mm_shuffle_epi8(
          _mm_loadu_si128(reinterpret_cast<const __m128i *>(block + 16 * g)),
          MASK);
    } else {
      // W[4g..4g+3] from the rotating window: msg1 covers sigma0 of
      // W[t-15], alignr injects W[t-7], msg2 covers sigma1 of W[t-2].
      cur = _mm_sha256msg2_epu32(
          _mm_add_epi32(
              _mm_sha256msg1_epu32(m[g & 3], m[(g + 1) & 3]),
              _mm_alignr_epi8(m[(g + 3) & 3], m[(g + 2) & 3], 4)),
          m[(g + 3) & 3]);
    }
    m[g & 3] = cur;
    __m128i msg = _mm_add_epi32(
        cur, _mm_loadu_si128(reinterpret_cast<const __m128i *>(&K[4 * g])));
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, msg);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, msg);
  }

  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);
  TMP = _mm_shuffle_epi32(STATE0, 0x1B);       /* FEBA */
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);    /* DCHG */
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0); /* DCBA */
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);    /* HGFE */
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&st[0]), STATE0);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&st[4]), STATE1);
}
// Two independent blocks with interleaved rounds: one sha256rnds2 chain is
// latency-bound (~4-6 cycles each, serially dependent), so a second
// independent stream in flight nearly doubles throughput — the measured
// scalar loop runs ~190 cycles/block where the port-throughput limit is
// ~half that.
__attribute__((target("sha,sse4.1,ssse3")))
void compress_shani_x2(uint32_t st0[8], uint32_t st1[8], const uint8_t *b0,
                       const uint8_t *b1) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i TA = _mm_loadu_si128(reinterpret_cast<const __m128i *>(&st0[0]));
  __m128i A1 = _mm_loadu_si128(reinterpret_cast<const __m128i *>(&st0[4]));
  __m128i TB = _mm_loadu_si128(reinterpret_cast<const __m128i *>(&st1[0]));
  __m128i B1 = _mm_loadu_si128(reinterpret_cast<const __m128i *>(&st1[4]));
  TA = _mm_shuffle_epi32(TA, 0xB1);
  A1 = _mm_shuffle_epi32(A1, 0x1B);
  TB = _mm_shuffle_epi32(TB, 0xB1);
  B1 = _mm_shuffle_epi32(B1, 0x1B);
  __m128i A0 = _mm_alignr_epi8(TA, A1, 8);
  A1 = _mm_blend_epi16(A1, TA, 0xF0);
  __m128i B0 = _mm_alignr_epi8(TB, B1, 8);
  B1 = _mm_blend_epi16(B1, TB, 0xF0);

  const __m128i A0_SAVE = A0, A1_SAVE = A1, B0_SAVE = B0, B1_SAVE = B1;

  __m128i mA[4], mB[4];
  for (int g = 0; g < 16; ++g) {
    __m128i curA, curB;
    if (g < 4) {
      curA = _mm_shuffle_epi8(
          _mm_loadu_si128(reinterpret_cast<const __m128i *>(b0 + 16 * g)),
          MASK);
      curB = _mm_shuffle_epi8(
          _mm_loadu_si128(reinterpret_cast<const __m128i *>(b1 + 16 * g)),
          MASK);
    } else {
      curA = _mm_sha256msg2_epu32(
          _mm_add_epi32(
              _mm_sha256msg1_epu32(mA[g & 3], mA[(g + 1) & 3]),
              _mm_alignr_epi8(mA[(g + 3) & 3], mA[(g + 2) & 3], 4)),
          mA[(g + 3) & 3]);
      curB = _mm_sha256msg2_epu32(
          _mm_add_epi32(
              _mm_sha256msg1_epu32(mB[g & 3], mB[(g + 1) & 3]),
              _mm_alignr_epi8(mB[(g + 3) & 3], mB[(g + 2) & 3], 4)),
          mB[(g + 3) & 3]);
    }
    mA[g & 3] = curA;
    mB[g & 3] = curB;
    const __m128i kv =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(&K[4 * g]));
    __m128i msgA = _mm_add_epi32(curA, kv);
    __m128i msgB = _mm_add_epi32(curB, kv);
    A1 = _mm_sha256rnds2_epu32(A1, A0, msgA);
    B1 = _mm_sha256rnds2_epu32(B1, B0, msgB);
    msgA = _mm_shuffle_epi32(msgA, 0x0E);
    msgB = _mm_shuffle_epi32(msgB, 0x0E);
    A0 = _mm_sha256rnds2_epu32(A0, A1, msgA);
    B0 = _mm_sha256rnds2_epu32(B0, B1, msgB);
  }

  A0 = _mm_add_epi32(A0, A0_SAVE);
  A1 = _mm_add_epi32(A1, A1_SAVE);
  B0 = _mm_add_epi32(B0, B0_SAVE);
  B1 = _mm_add_epi32(B1, B1_SAVE);
  TA = _mm_shuffle_epi32(A0, 0x1B);
  A1 = _mm_shuffle_epi32(A1, 0xB1);
  A0 = _mm_blend_epi16(TA, A1, 0xF0);
  A1 = _mm_alignr_epi8(A1, TA, 8);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&st0[0]), A0);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&st0[4]), A1);
  TB = _mm_shuffle_epi32(B0, 0x1B);
  B1 = _mm_shuffle_epi32(B1, 0xB1);
  B0 = _mm_blend_epi16(TB, B1, 0xF0);
  B1 = _mm_alignr_epi8(B1, TB, 8);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&st1[0]), B0);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&st1[4]), B1);
}
#endif  // HAVE_SHANI_BUILD

using CompressFn = void (*)(uint32_t *, const uint8_t *);

bool have_shani();

CompressFn pick_compress() {
#ifdef HAVE_SHANI_BUILD
  if (have_shani()) return &compress_shani;
#endif
  return &compress;
}

const CompressFn COMPRESS = pick_compress();

bool have_shani() {
#ifdef HAVE_SHANI_BUILD
  return __builtin_cpu_supports("sha");
#else
  return false;
#endif
}

// Tail layout for one digit count: rem-of-prefix || digits || 0x80 || zeros
// || 64-bit big-endian bit length, in (n_blocks - n_const) 64-byte blocks.
struct Tail {
  uint8_t buf[192];  // data<=~115B tails fit 2 blocks; digits<=20 keeps <=3
  size_t n_blocks;
  size_t digit_off;

  void layout(const uint8_t *rem, size_t rem_len, size_t dlen,
              uint64_t total_msg_len) {
    size_t tail_msg = rem_len + dlen;         // message bytes in the tail
    n_blocks = (tail_msg + 9 + 63) / 64;      // + 0x80 and 8-byte length
    std::memset(buf, 0, sizeof(buf));
    std::memcpy(buf, rem, rem_len);
    digit_off = rem_len;
    buf[rem_len + dlen] = 0x80;
    uint64_t bits = total_msg_len * 8;
    for (int i = 0; i < 8; ++i)
      buf[n_blocks * 64 - 1 - i] = uint8_t(bits >> (8 * i));
  }
};

}  // namespace

extern "C" {

// Whether the SHA-NI compression paths (compress_shani / compress_shani_x2)
// are live on this CPU — exposed so Python tests can record which path the
// sweep actually exercised rather than passing silently either way.
int sha256_have_shani() { return have_shani() ? 1 : 0; }

// Sweep the inclusive nonce range [lower, upper]; returns the min hash and
// its (lowest) nonce through the out params.
void sha256_sweep_min(const uint8_t *data, uint64_t data_len, uint64_t lower,
                      uint64_t upper, uint64_t *out_hash, uint64_t *out_nonce) {
  // Midstate over blocks fully inside "<data> " — computed once.
  const size_t c_len = size_t(data_len) + 1;
  const size_t n_const = c_len / 64;
  uint32_t mid[8];
  std::memcpy(mid, H0, sizeof(mid));
  uint8_t block[64];
  size_t consumed = 0;
  for (size_t b = 0; b < n_const; ++b) {
    for (size_t i = 0; i < 64; ++i) {
      block[i] = (consumed + i < size_t(data_len))
                     ? data[consumed + i]
                     : uint8_t(' ');  // only ever the final prefix byte
    }
    COMPRESS(mid, block);
    consumed += 64;
  }
  // Remainder of the prefix that shares a block with the digits.
  uint8_t rem[64];
  size_t rem_len = c_len - n_const * 64;
  for (size_t i = 0; i < rem_len; ++i)
    rem[i] = (consumed + i < size_t(data_len)) ? data[consumed + i]
                                               : uint8_t(' ');

  // Decimal digit buffer of the current nonce, incremented in place.
  char digits[21];
  size_t dlen = 0;
  {
    uint64_t n = lower;
    char tmp[21];
    size_t i = 0;
    do { tmp[i++] = char('0' + n % 10); n /= 10; } while (n);
    dlen = i;
    for (size_t j = 0; j < dlen; ++j) digits[j] = tmp[dlen - 1 - j];
  }

  Tail tail;
  tail.layout(rem, rem_len, dlen, c_len + dlen);

  uint64_t best_hash = ~uint64_t(0);
  uint64_t best_nonce = lower;
  uint64_t n = lower;

  // digits/dlen/tail always describe nonce n at the top of the outer loop.
  auto advance = [&]() {  // digits += 1, carry + rollover re-pad
    size_t i = dlen;
    while (i > 0) {
      if (++digits[i - 1] <= '9') break;
      digits[i - 1] = '0';
      --i;
    }
    if (i == 0) {  // rolled over: one more digit, re-pad the tail
      std::memmove(digits + 1, digits, dlen);
      digits[0] = '1';
      ++dlen;
      tail.layout(rem, rem_len, dlen, c_len + dlen);
    }
  };
  auto fold = [&](const uint32_t st[8], uint64_t nonce) {
    uint64_t h = (uint64_t(st[0]) << 32) | uint64_t(st[1]);
    if (h < best_hash) { best_hash = h; best_nonce = nonce; }
  };

#ifdef HAVE_SHANI_BUILD
  const bool use_x2 = have_shani();
  Tail tailB;
#endif

  for (;;) {
#ifdef HAVE_SHANI_BUILD
    if (use_x2 && n < upper) {
      // Two-at-a-time within the current digit-count segment (same tail
      // layout for both streams; no rollover can occur inside it).
      uint64_t seg_end = upper;
      if (dlen < 20) {
        uint64_t p10 = 1;
        for (size_t j = 0; j < dlen; ++j) p10 *= 10;
        if (p10 - 1 < seg_end) seg_end = p10 - 1;
      }
      // All arithmetic via differences: n+1 would wrap at the u64 ceiling.
      if (seg_end - n >= 1) {  // >= 2 nonces left in this segment
        tailB = tail;
        for (;;) {
          std::memcpy(tail.buf + tail.digit_off, digits, dlen);
          advance();  // stays inside the segment: no re-pad
          std::memcpy(tailB.buf + tailB.digit_off, digits, dlen);
          uint32_t stA[8], stB[8];
          std::memcpy(stA, mid, sizeof(stA));
          std::memcpy(stB, mid, sizeof(stB));
          for (size_t b = 0; b < tail.n_blocks; ++b)
            compress_shani_x2(stA, stB, tail.buf + b * 64, tailB.buf + b * 64);
          fold(stA, n);
          fold(stB, n + 1);
          if (upper - n == 1) {  // the pair ended exactly at upper
            *out_hash = best_hash;
            *out_nonce = best_nonce;
            return;
          }
          n += 2;
          advance();  // may re-pad when the pair consumed the segment end
          if (n > seg_end || seg_end - n < 1) break;
        }
        continue;  // odd remainder / segment boundary: scalar path below
      }
    }
#endif
    std::memcpy(tail.buf + tail.digit_off, digits, dlen);
    uint32_t st[8];
    std::memcpy(st, mid, sizeof(st));
    for (size_t b = 0; b < tail.n_blocks; ++b) COMPRESS(st, tail.buf + b * 64);
    fold(st, n);

    if (n == upper) break;
    ++n;
    advance();
  }
  *out_hash = best_hash;
  *out_nonce = best_nonce;
}

// Single-nonce hash (for spot checks from Python).
uint64_t sha256_hash_one(const uint8_t *data, uint64_t data_len,
                         uint64_t nonce) {
  uint64_t h, n;
  sha256_sweep_min(data, data_len, nonce, nonce, &h, &n);
  return h;
}

// Multi-threaded sweep: contiguous sub-ranges per thread, (hash, nonce)
// lexicographic reduce — bit-exact with the scalar sweep incl. the
// lowest-nonce tie-break, since each thread already returns its lowest
// nonce and sub-ranges ascend.  nthreads == 0 means hardware concurrency.
void sha256_sweep_min_mt(const uint8_t *data, uint64_t data_len,
                         uint64_t lower, uint64_t upper, uint32_t nthreads,
                         uint64_t *out_hash, uint64_t *out_nonce) {
  uint64_t span = upper - lower + 1;  // callers guarantee lower <= upper
  uint64_t t = nthreads ? nthreads : std::thread::hardware_concurrency();
  if (t < 1) t = 1;
  if (span == 0) t = 1;  // full [0, 2^64-1]: 2^64 nonces wraps the u64 span,
  // and span/t below would divide by zero.  The Python binding refuses this
  // range outright (no sweep of 2^64 nonces ever returns in practice); for
  // a direct C caller the scalar path is the defined — if eternal — answer.
  if (t > span && span != 0) t = span;
  if (t == 1) {
    sha256_sweep_min(data, data_len, lower, upper, out_hash, out_nonce);
    return;
  }
  std::vector<uint64_t> hashes(t), nonces(t);
  std::vector<std::thread> workers;
  workers.reserve(t);
  uint64_t chunk = span / t, rem = span % t, lo = lower;
  for (uint64_t i = 0; i < t; ++i) {
    uint64_t hi = lo + chunk - 1 + (i < rem ? 1 : 0);
    workers.emplace_back([=, &hashes, &nonces] {
      sha256_sweep_min(data, data_len, lo, hi, &hashes[i], &nonces[i]);
    });
    lo = hi + 1;
  }
  uint64_t best_hash = 0, best_nonce = 0;
  for (uint64_t i = 0; i < t; ++i) {
    workers[i].join();
    if (i == 0 || hashes[i] < best_hash ||
        (hashes[i] == best_hash && nonces[i] < best_nonce)) {
      best_hash = hashes[i];
      best_nonce = nonces[i];
    }
  }
  *out_hash = best_hash;
  *out_nonce = best_nonce;
}

}  // extern "C"
