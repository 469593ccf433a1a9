"""ops/blake2b.py of the port against the JAX package's ops/blake2b.py.

The layout and the host oracle are compared field by field; the plain
version ``blake2b_minhash_plain`` against the reference's kernel body
``make_blake2b_kernel_body`` on the same numpy operands, in both its
full-lane and grouped forms and both sieve settings.  The reference body
runs eagerly (``jax.disable_jit``): the same function, op by op, because
XLA:CPU takes minutes to compile its unrolled 12-round DAG on a small host.
Tolerance 0 (integer hashes).  The CUDA kernel's tests are in
test_torch_kernel_gpu.py.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.ops import blake2b as ref_b2
from bitcoin_miner_tpu.ops import sweep as ref_sweep
from bitcoin_miner_tpu_torch.ops import blake2b as b2
from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
from bitcoin_miner_tpu_torch.ops.sha256_minhash import I32_MAX, U32_MAX

_RNG = np.random.default_rng(20)
# Data lengths 0..300: 0, 1 and 2 prefix blocks fold into the midstate,
# and the digits straddle the 128-byte boundary.
LAYOUT_CASES = [(int(n), int(d), sep)
                for n, d in zip(_RNG.integers(0, 301, 12), _RNG.integers(1, 21, 12))
                for sep in (b" ", b":")] + [(126, 10, b" "), (127, 1, b":"), (255, 20, b" ")]


@pytest.mark.parametrize("n,d,sep", LAYOUT_CASES)
def test_layout_matches_reference(n, d, sep):
    data = bytes(np.random.default_rng(100 * n + d).integers(32, 127, n, dtype=np.uint8))
    got = b2.build_layout(data, d, sep=sep)
    want = ref_b2.build_layout(data, d, sep=sep)
    for field in ("data_len", "digit_count", "msg_len", "tail_off", "midstate",
                  "tail_template", "live_words", "n_tail_blocks", "family"):
        assert getattr(got, field) == getattr(want, field), field
    assert [(p.word, p.shift) for p in got.digit_pos] == [
        (p.word, p.shift) for p in want.digit_pos]


@pytest.mark.parametrize("n", [0, 1, 119, 120, 127, 128, 200, 255, 256, 300])
def test_digest64_matches_hashlib(n):
    msg = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    want = int.from_bytes(hashlib.blake2b(msg, digest_size=8).digest(), "big")
    assert b2.digest64_py(msg) == want == ref_b2.digest64_py(msg)


def _operands(data: bytes, d: int, k: int, batch: int, seed: int):
    """Numpy operands of one dispatch: random high digits per row, bounds
    inside rows, and an empty padding row last."""
    rng = np.random.default_rng(seed)
    lay = ref_b2.build_layout(data, d)
    span = 10**k
    chunks = []
    for _ in range(batch - 1):
        high = int(rng.integers(10 ** (d - k - 1), 10 ** (d - k)))
        lo = int(rng.integers(0, span // 2))
        chunks.append(ref_sweep.Chunk(high * span, lo, int(rng.integers(lo + 1, span + 1))))
    group = ref_sweep.ChunkGroup(d=d, k=k, chunks=tuple(chunks))
    tail, bounds = ref_sweep._fill_templates(lay, group, chunks, batch)
    return lay, np.array(lay.midstate, dtype=np.uint32), tail, bounds


def _reference(lay, k, batch, factored, midstate, tail, bounds, thresh):
    body = ref_b2.make_blake2b_kernel_body(
        lay.msg_len, lay.tail_off, lay.n_tail_blocks, lay.live_words,
        lay.digit_pos[lay.digit_count - k :], k, batch,
        sieve=thresh is not None, factored=factored)
    args = [jnp.asarray(midstate), jnp.asarray(tail), jnp.asarray(bounds)]
    if thresh is not None:
        args.append(jnp.uint32(thresh))
    with jax.disable_jit():
        return [int(v) for v in body(*args)]


# (data, d, k, batch, k_in, thresholds): one tail block; two with the low
# digits straddling the blocks; the grouped form at k_in 1 and 2.
# Thresholds: None (sieve off), "all" (U32_MAX, == min h0, < min h0) or
# "tie" (== min h0).  Two tail blocks with the low digits all in the
# second are held to the plain version on the card (test_torch_kernel_gpu).
PLAIN_CASES = [
    (b"cmu440", 7, 2, 3, 0, None),
    (b"cmu440", 7, 2, 3, 0, "all"),
    (b"x" * 120, 8, 2, 2, 0, None),
    (b"cmu440", 7, 1, 3, 0, "tie"),
    (b"cmu440", 7, 2, 3, 1, "tie"),
    (b"q" * 40, 6, 3, 3, 2, None),
]


@pytest.mark.parametrize("data,d,k,batch,k_in,thresholds", PLAIN_CASES)
def test_plain_matches_reference_body(data, d, k, batch, k_in, thresholds):
    lay, midstate, tail, bounds = _operands(data, d, k, batch, seed=len(data) + k)
    ops = dict(midstate=torch.from_numpy(midstate), tail_const=torch.from_numpy(tail),
               bounds=torch.from_numpy(bounds))
    kw = dict(low_pos=b2.build_layout(data, d).digit_pos[d - k :], k=k,
              msg_len=lay.msg_len, tail_off=lay.tail_off, k_in=k_in)
    full = b2.blake2b_minhash_plain(**ops, **kw).tolist()
    assert full[2] != I32_MAX
    if thresholds is None:
        assert full == _reference(lay, k, batch, k_in, midstate, tail, bounds, None)
        return
    ths = (U32_MAX, full[0], full[0] - 1) if thresholds == "all" else (full[0],)
    for th in ths:
        got = b2.blake2b_minhash_plain(**ops, thresh=th, **kw).tolist()
        assert got == _reference(lay, k, batch, k_in, midstate, tail, bounds, th)
        assert got == (full if th >= full[0] else [U32_MAX, U32_MAX, I32_MAX])


def test_both_forms_and_the_wrapper_agree_on_the_cpu():
    lay, midstate, tail, bounds = _operands(b"x" * 125, 8, 2, 3, seed=3)
    ops = dict(midstate=torch.from_numpy(midstate), tail_const=torch.from_numpy(tail),
               bounds=torch.from_numpy(bounds))
    kw = dict(low_pos=b2.build_layout(b"x" * 125, 8).digit_pos[6:], k=2,
              msg_len=lay.msg_len, tail_off=lay.tail_off)
    full = b2.blake2b_minhash_plain(**ops, **kw).tolist()
    for th in (None, full[0] - 1):
        assert (b2.blake2b_minhash_plain(**ops, thresh=th, k_in=1, **kw).tolist()
                == b2.blake2b_minhash_plain(**ops, thresh=th, **kw).tolist())
    n0 = blake2b_minhash.launches
    got = blake2b_minhash(ops["midstate"], ops["tail_const"], ops["bounds"], kw["low_pos"],
                          msg_len=lay.msg_len, tail_off=lay.tail_off)
    assert got.tolist() == full and blake2b_minhash.launches == n0  # no kernel on the CPU


def test_plain_rejects_what_the_kernel_does_not_take():
    lay, midstate, tail, bounds = _operands(b"cmu440", 7, 2, 2, seed=1)
    kw = dict(low_pos=b2.build_layout(b"cmu440", 7).digit_pos[5:], k=2,
              msg_len=lay.msg_len, tail_off=lay.tail_off)
    with pytest.raises(ValueError):
        b2.blake2b_minhash_plain(torch.from_numpy(midstate[:8]), torch.from_numpy(tail),
                                 torch.from_numpy(bounds), **kw)
    with pytest.raises(ValueError):
        b2.blake2b_minhash_plain(torch.from_numpy(midstate), torch.from_numpy(tail),
                                 torch.from_numpy(bounds), **{**kw, "k": 3})
    with pytest.raises(ValueError):
        b2.blake2b_minhash_plain(torch.from_numpy(midstate), torch.from_numpy(tail),
                                 torch.from_numpy(bounds), **{**kw, "msg_len": 200})


def test_lane_ops_counts_only_lane_dependent_live_work():
    one = b2.build_layout(b"cmu440", 10).digit_pos[4:]
    logic, adds = b2.lane_ops(one, 1)
    # At most 12 rounds x 8 G's of 14 logic and 8 adds, plus the output.
    assert 0 < logic < 12 * 8 * 14 + 4 and 0 < adds < 12 * 8 * 8
    # Round 0 has G's that read no digit word and see only constants.
    assert (logic, adds) < (12 * 8 * 14, 12 * 8 * 8)
    # Digits all in the second of two tail blocks: the first is per row.
    fb1 = b2.build_layout(b"z" * 126, 10).digit_pos[4:]
    assert min(p.word for p in fb1) >= 32
    assert b2.lane_ops(fb1, 2)[0] < 1.1 * logic
    # Digits in the first block: both blocks are per lane.
    straddle = b2.build_layout(b"x" * 120, 10).digit_pos[4:]
    assert b2.lane_ops(straddle, 2)[0] > 1.8 * logic
    ms = b2.bound_seconds(1024 * 10**6, one, 1, 1980e6) * 1e3
    assert 50 < ms < 100
