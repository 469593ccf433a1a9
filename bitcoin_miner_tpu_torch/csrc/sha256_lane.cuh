// Per-lane SHA-256 of the min-hash sweeps: the compression rounds, whole
// or split at round p (compress_prefix once per row or group,
// compress_from per lane).
#pragma once

#include <stdint.h>

#define BMT_FN __device__ __forceinline__

namespace bmt {

// The lane axis holds at most 10^9 lanes (batch * 10^k must fit int32),
// so k <= 9 and the k digit bytes span at most 3 consecutive tail words.
constexpr int kMaxDigits = 9;
constexpr int kDigitSlots = 3;

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

BMT_FN uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

// One round: t1 = h + Σ1(e) + ch(e, f, g) + k + wt, t2 = Σ0(a) + maj(a, b, c),
// then the state shifts by one word.  Inlined, the shift is register
// renaming.
BMT_FN void round_step(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d,
                       uint32_t& e, uint32_t& f, uint32_t& g, uint32_t& h,
                       uint32_t k, uint32_t wt) {
  const uint32_t s1e = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
  const uint32_t ch = g ^ (e & (f ^ g));
  const uint32_t t1 = h + s1e + ch + k + wt;
  const uint32_t s0a = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
  const uint32_t maj = (a & b) | (c & (a | b));
  const uint32_t t2 = s0a + maj;
  h = g;
  g = f;
  f = e;
  e = d + t1;
  d = c;
  c = b;
  b = a;
  a = t1 + t2;
}

// Message schedule word t >= 16, written back into the rotating buffer w.
BMT_FN uint32_t schedule(uint32_t w[16], int t) {
  const uint32_t w15 = w[(t - 15) & 15];
  const uint32_t w2 = w[(t - 2) & 15];
  const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
  const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
  const uint32_t wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
  w[t & 15] = wt;
  return wt;
}

// One compression of the 16-word block w (overwritten by the message
// schedule).  out[i] = state[i] + round output i.  Callers that read only
// out[0..1] let the compiler drop the work feeding the other six words.
BMT_FN void compress(const uint32_t st[8], uint32_t w[16], uint32_t out[8]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    const uint32_t wt = t < 16 ? w[t] : schedule(w, t);
    round_step(a, b, c, d, e, f, g, h, kK[t], wt);
  }
  out[0] = st[0] + a;
  out[1] = st[1] + b;
  out[2] = st[2] + c;
  out[3] = st[3] + d;
  out[4] = st[4] + e;
  out[5] = st[5] + f;
  out[6] = st[6] + g;
  out[7] = st[7] + h;
}

// Rounds [0, p) of a compression from state st, 0 <= p <= 16 (they read
// only w[0..p-1]): the carried state mid that compress_from resumes.  The
// min-hash kernels run it once per chunk row or per (row, outer group),
// not per lane.
BMT_FN void compress_prefix(const uint32_t st[8], const uint32_t w[16], int p,
                            uint32_t mid[8]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    if (t < p) round_step(a, b, c, d, e, f, g, h, kK[t], w[t]);
  }
  mid[0] = a;
  mid[1] = b;
  mid[2] = c;
  mid[3] = d;
  mid[4] = e;
  mid[5] = f;
  mid[6] = g;
  mid[7] = h;
}

// Rounds [p, 64) from the carried state mid (compress_prefix's output for
// the same p), then the feed-forward onto the block's initial state st:
// compress_from(st, compress_prefix(st, w, p), p, w) == compress(st, w).
// w holds all 16 words (the schedule reads the early ones) and is
// overwritten.  The switch enters the unrolled rounds at round p; each
// case falls through to the next, so past the entry the rounds are the
// same straight-line code as compress's.
BMT_FN void compress_from(const uint32_t st[8], const uint32_t mid[8], int p,
                          uint32_t w[16], uint32_t out[8]) {
  uint32_t a = mid[0], b = mid[1], c = mid[2], d = mid[3];
  uint32_t e = mid[4], f = mid[5], g = mid[6], h = mid[7];
#define BMT_ROUND_CASE(t) \
  case t:                 \
    round_step(a, b, c, d, e, f, g, h, kK[t], w[t]);
  switch (p) {
    BMT_ROUND_CASE(0)
    BMT_ROUND_CASE(1)
    BMT_ROUND_CASE(2)
    BMT_ROUND_CASE(3)
    BMT_ROUND_CASE(4)
    BMT_ROUND_CASE(5)
    BMT_ROUND_CASE(6)
    BMT_ROUND_CASE(7)
    BMT_ROUND_CASE(8)
    BMT_ROUND_CASE(9)
    BMT_ROUND_CASE(10)
    BMT_ROUND_CASE(11)
    BMT_ROUND_CASE(12)
    BMT_ROUND_CASE(13)
    BMT_ROUND_CASE(14)
    BMT_ROUND_CASE(15)
    default:
      break;
  }
#undef BMT_ROUND_CASE
#pragma unroll
  for (int t = 16; t < 64; ++t) {
    round_step(a, b, c, d, e, f, g, h, kK[t], schedule(w, t));
  }
  out[0] = st[0] + a;
  out[1] = st[1] + b;
  out[2] = st[2] + c;
  out[3] = st[3] + d;
  out[4] = st[4] + e;
  out[5] = st[5] + f;
  out[6] = st[6] + g;
  out[7] = st[7] + h;
}

}  // namespace bmt
