// Hopper (sm_90a) kernel of the hot plane: one dispatch's min-hash outputs
// merged into the job's device-resident carry.
//
// Replaces the device step bitcoin_miner_tpu/ops/sweep.py::make_hot_step
// (its _merge, under jax.jit with the carry donated) together with the
// mesh cascade that feeds it there, bitcoin_miner_tpu/parallel/sweep.py::
// _collective_min (three lax.pmin over the shards).  The plain version is
// ops/hot.py::hot_merge_plain.
//
// Function, per dispatch of N shard outputs (h0, h1, flat), in shard order:
//   the cascade -- g_h0 = min h0; g_h1 = min h1 among the shards at g_h0;
//   g_dev = the lowest shard at (g_h0, g_h1) whose flat is not I32_MAX;
//   g_flat = its flat (g_dev = g_flat = I32_MAX when there is none);
//   the merge -- better = valid & (vacant | g_h0 < bh0 | (g_h0 == bh0 &
//   g_h1 < bh1)), valid = g_flat != I32_MAX, vacant = the carry's flat is
//   I32_MAX; when better, carry = (g_h0, g_h1, seq, g_dev, g_flat).  The
//   strict compare keeps the carried (earlier, lower-nonce) candidate on
//   an exact tie; the vacant clause admits a first candidate even at
//   h0 == U32_MAX.  Then probe = (best_h0, best_seq), and each sieve
//   threshold word on this card is lowered to best_h0 (atomicMin: shards
//   on the card lower the same word, and a word is never raised).
//
// Bound: the latency of one launch.  The work is 3N + 5 words read and 7
// written, with no parallelism worth a second thread, so one thread does
// it and the kernel's time is the launch's; its yardstick is the empty
// kernel below, launched the same way.  What the design does about that
// bound is to make it the whole cost: the step adds one launch to a
// dispatch and no host round trip -- the carry never leaves the card until
// the job's end, and the host reads only the 2-word probe.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxShards = 16;
constexpr int kMaxWords = 16;
constexpr long long kU32Max = 0xFFFFFFFFLL;
constexpr long long kI32Max = 0x7FFFFFFFLL;

struct Shards {
  const long long* out[kMaxShards];
};

struct Words {
  unsigned int* word[kMaxWords];
};

__global__ void hot_merge_kernel(Shards shards, int n, long long seq,
                                 long long* __restrict__ carry,
                                 long long* __restrict__ probe, Words th,
                                 int n_words) {
  long long g_h0 = kU32Max;
  for (int i = 0; i < n; ++i) g_h0 = min(g_h0, shards.out[i][0]);
  long long g_h1 = kU32Max;
  for (int i = 0; i < n; ++i) {
    if (shards.out[i][0] == g_h0) g_h1 = min(g_h1, shards.out[i][1]);
  }
  long long g_dev = kI32Max, g_flat = kI32Max;
  for (int i = 0; i < n; ++i) {
    const long long* o = shards.out[i];
    if (o[0] == g_h0 && o[1] == g_h1 && o[2] != kI32Max) {
      g_dev = i;
      g_flat = o[2];
      break;
    }
  }
  const bool valid = g_flat != kI32Max;
  const bool vacant = carry[4] == kI32Max;
  const bool better = valid && (vacant || g_h0 < carry[0] ||
                                (g_h0 == carry[0] && g_h1 < carry[1]));
  if (better) {
    carry[0] = g_h0;
    carry[1] = g_h1;
    carry[2] = seq;
    carry[3] = g_dev;
    carry[4] = g_flat;
  }
  probe[0] = carry[0];
  probe[1] = carry[2];
  for (int j = 0; j < n_words; ++j) atomicMin(th.word[j], unsigned(carry[0]));
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Launch one merge on `stream`.  Host arrays of device pointers: outs (n
// pointers to (3,) i64 shard outputs, shard order) and th_words (n_words
// pointers to (1,) u32 threshold words; none without the sieve).  Device
// pointers: carry (5,) i64 (best_h0, best_h1, best_seq, best_dev,
// best_flat), updated in place; probe (2,) i64.  Every pointer is on the
// stream's card.  Returns 0, a negative code for arguments the kernel does
// not take, or the cudaError_t of the launch.
int bmt_hot_merge(const long long* const* outs, int n, long long seq,
                  long long* carry, long long* probe,
                  unsigned int* const* th_words, int n_words, void* stream) {
  if (n < 1 || n > kMaxShards) return -1;
  if (n_words < 0 || n_words > kMaxWords) return -2;
  if (seq < 0 || seq > kI32Max) return -3;
  if (carry == nullptr || probe == nullptr) return -4;
  Shards shards{};
  for (int i = 0; i < n; ++i) {
    if (outs[i] == nullptr) return -5;
    shards.out[i] = outs[i];
  }
  Words th{};
  for (int j = 0; j < n_words; ++j) {
    if (th_words[j] == nullptr) return -6;
    th.word[j] = th_words[j];
  }
  hot_merge_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      shards, n, seq, carry, probe, th, n_words);
  return int(cudaGetLastError());
}

// Launch the empty kernel on `stream`: the launch-latency yardstick that
// bounds bmt_hot_merge's time (measuring scripts only; no path runs it).
int bmt_empty_kernel(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

}  // extern "C"
