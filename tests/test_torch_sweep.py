"""ops/sweep.py and ops/sha256_minhash.py of the port against the JAX package.

The JAX Pallas kernel runs in interpret mode on the CPU, as the JAX
package's own tests run it; the port's plain version runs on the CPU.  The
same numpy operands go to both (``operands_from_reference``), and outputs
must agree bit for bit (tolerance 0: integer hashes).  The CUDA kernel's
tests are in test_torch_kernel_gpu.py.
"""

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu.ops import sweep as ref_sweep
from bitcoin_miner_tpu.ops.pallas_sha256 import (
    dyn_params,
    make_pallas_minhash,
    make_pallas_minhash_dyn,
    window_contribs_np,
)
from bitcoin_miner_tpu.ops.sha256 import build_layout as ref_build_layout
from bitcoin_miner_tpu.ops.sha256 import compress as ref_compress
from bitcoin_miner_tpu_torch.ops import sha256_minhash, sweep
from bitcoin_miner_tpu_torch.ops.sha256 import build_layout
from bitcoin_miner_tpu_torch.ops.sha256_minhash import (
    I32_MAX,
    U32_MAX,
    minhash,
    minhash_plain,
    operands_from_reference,
)

RANGES = [(0, 0), (0, 9), (5, 123), (95, 321), (985, 1040), (9985, 10015),
          (99_990, 100_020), (123_456, 1_234_567), (10**19 - 3, 10**19 + 2)]


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("max_k", [1, 2, 6])
def test_decompose_range_parity(lo, hi, max_k):
    got = list(sweep.decompose_range(lo, hi, max_k=max_k))
    want = list(ref_sweep.decompose_range(lo, hi, max_k=max_k))
    assert [(g.d, g.k, [(c.base, c.lo_off, c.hi_off) for c in g.chunks]) for g in got] == [
        (g.d, g.k, [(c.base, c.lo_off, c.hi_off) for c in g.chunks]) for g in want
    ]


@pytest.mark.parametrize("data", ["", "abc", "s" * 61, "x" * 120])
def test_fill_templates_parity(data):
    for lo, hi in [(95, 321), (9985, 10015), (123_456, 1_234_567)]:
        for g, rg in zip(sweep.decompose_range(lo, hi, 2),
                         ref_sweep.decompose_range(lo, hi, 2)):
            lay = build_layout(data.encode(), g.d)
            rlay = ref_build_layout(data.encode(), rg.d)
            for s in range(0, len(g.chunks), 3):
                t, b = sweep._fill_templates(lay, g, g.chunks[s : s + 3], 4)
                rt, rb = ref_sweep._fill_templates(rlay, rg, rg.chunks[s : s + 3], 4)
                np.testing.assert_array_equal(t, rt)
                np.testing.assert_array_equal(b, rb)
                assert t.dtype == rt.dtype and b.dtype == rb.dtype


def _reference_operands(data: str, d: int, k: int, batch: int, seed: int):
    """Numpy operands of one JAX dispatch: random high digits per row,
    partial bounds, and a padding row when batch > 2."""
    rng = np.random.default_rng(seed)
    lay = ref_build_layout(data.encode(), d)
    span = 10**k
    group_chunks = []
    for r in range(batch - (1 if batch > 2 else 0)):
        high = int(rng.integers(10 ** (d - k - 1), 10 ** (d - k)))
        lo = int(rng.integers(0, span // 2))
        hi = int(rng.integers(lo + 1, span + 1))
        group_chunks.append(ref_sweep.Chunk(base=high * span, lo_off=lo, hi_off=hi))
    group = ref_sweep.ChunkGroup(d=d, k=k, chunks=tuple(group_chunks))
    tail, bounds = ref_sweep._fill_templates(lay, group, group_chunks, batch)
    tailcb = np.concatenate([tail, bounds.astype(np.uint32)], axis=1)
    return lay, np.array(lay.midstate, dtype=np.uint32), tailcb


def _flip(th: int) -> np.ndarray:
    return np.array([th ^ 0x80000000], dtype=np.uint32).view(np.int32)


def _plain(lay, midstate, tailcb, thresh, low_pos):
    ops = operands_from_reference(
        midstate, tailcb.reshape(-1), None if thresh is None else _flip(thresh),
        low_pos, n_tail_blocks=lay.n_tail_blocks,
    )
    if thresh is not None:
        assert ops["thresh"] == thresh
    return minhash_plain(**ops).tolist()


def test_minhash_plain_vs_pallas_static():
    # make_pallas_minhash: one tail block, full fold and sieve forms.
    lay, mid, tailcb = _reference_operands("abc", 4, 2, 2, seed=1)
    low = lay.digit_pos[2:]
    fn = make_pallas_minhash(lay.n_tail_blocks, low, 2, batch=2, interpret=True)
    want = [int(x) for x in fn(mid, tailcb)]
    assert _plain(lay, mid, tailcb, None, low) == want
    fs = make_pallas_minhash(
        lay.n_tail_blocks, low, 2, batch=2, interpret=True, sieve=True
    )
    ws = [int(x) for x in fs(mid, tailcb, _flip(U32_MAX))]
    assert ws == want
    assert _plain(lay, mid, tailcb, U32_MAX, low) == ws


def test_minhash_plain_vs_pallas_dyn_thresholds():
    # make_pallas_minhash_dyn on a two-tail-block layout whose digits
    # straddle the blocks: the full fold, then the sieve with U32_MAX, the
    # min's own h0 (the tie survives) and one below it (I32_MAX sentinel).
    data = "s" * 61
    lay, mid, tailcb = _reference_operands(data, 4, 2, 3, seed=2)
    assert lay.n_tail_blocks == 2
    w_lo, w_hi = dyn_params(lay, 2)
    low = lay.digit_pos[2:]
    fn, n_pad = make_pallas_minhash_dyn(2, w_lo, w_hi, 2, batch=3, interpret=True)
    contribs = window_contribs_np(2, low, w_lo, w_hi, n_pad)
    full = [int(x) for x in fn(mid, tailcb, *contribs)]
    assert full[2] != I32_MAX
    assert _plain(lay, mid, tailcb, None, low) == full
    fs, _ = make_pallas_minhash_dyn(
        2, w_lo, w_hi, 2, batch=3, interpret=True, sieve=True
    )
    for th, expect in [(U32_MAX, full), (full[0], full),
                       (full[0] - 1, [U32_MAX, U32_MAX, I32_MAX])]:
        got = [int(x) for x in fs(mid, tailcb, _flip(th), *contribs)]
        assert got == expect, th
        assert _plain(lay, mid, tailcb, th, low) == got, th


def test_minhash_plain_padding_and_ties():
    lay = build_layout(b"tie", 3)
    low = lay.digit_pos[1:]
    tail = np.tile(np.array(lay.tail_template, dtype=np.uint32), (3, 1))
    dp = lay.digit_pos[0]
    tail[:, dp.word] |= np.uint32(ord("1") << dp.shift)
    bounds = np.array([[0, 100], [0, 100], [0, 0]], dtype=np.int32)
    args = dict(midstate=torch.from_numpy(np.array(lay.midstate, dtype=np.uint32)),
                tail=torch.from_numpy(tail), bounds=torch.from_numpy(bounds),
                low_pos=low)
    h0, h1, idx = minhash_plain(**args).tolist()
    assert idx < 100  # duplicate rows tie: the lower row wins
    assert ((h0 << 32) | h1, 100 + idx) == min_hash_range("tie", 100, 199)
    empty = dict(args, bounds=torch.zeros((3, 2), dtype=torch.int32))
    assert minhash_plain(**empty).tolist() == [U32_MAX, U32_MAX, I32_MAX]
    # The wrapper takes the plain version for CPU tensors.
    assert minhash(**args).tolist() == [h0, h1, idx]


def test_minhash_plain_chunks_split_rows(monkeypatch):
    """Chunks of the plain version that split rows and skip a padding row
    between valid ones fold to the same result as one chunk."""
    lay = build_layout(b"chunks", 4)
    rng = np.random.default_rng(7)
    tail = np.tile(np.array(lay.tail_template, dtype=np.uint32), (4, 1))
    for r in range(4):
        for j, dp in enumerate(lay.digit_pos[:2]):
            tail[r, dp.word] |= np.uint32((48 + int(rng.integers(1, 10))) << dp.shift)
    bounds = np.array([[3, 90], [0, 0], [10, 100], [0, 55]], dtype=np.int32)
    args = dict(midstate=torch.from_numpy(np.array(lay.midstate, dtype=np.uint32)),
                tail=torch.from_numpy(tail), bounds=torch.from_numpy(bounds),
                low_pos=lay.digit_pos[2:])
    whole = minhash_plain(**args).tolist()
    monkeypatch.setattr(sha256_minhash, "PLAIN_LANES", 7)
    assert minhash_plain(**args).tolist() == whole
    assert whole[2] // 100 in (0, 2, 3)


def test_lane_ops_counts_only_lane_dependent_work():
    every = [(w, 0) for w in range(16)]
    # Every word varies: 63 rounds x 10 logic (Σ0, Σ1 4 each, ch, maj) + 48
    # schedule words x 8 (σ0, σ1); round 0 reads the constant midstate, so
    # only its 3 adds (t1, a, e) count.  Adds 3 + 63 x 4 - 1 (dead last e)
    # + 48 x 2 + 2 (h0, h1 feed-forward).
    assert sha256_minhash.lane_ops(every, 1) == (630 + 384, 3 + 251 + 96 + 2)
    # A second block of constant words: its schedule is per-dispatch work;
    # the first block feeds all 8 words forward.
    assert sha256_minhash.lane_ops(every, 2) == (1014 + 640, 3 + 252 + 96 + 8 + 255 + 2)
    # cmu440 at d=10, k=6: the digits start in word 2, so rounds 0-1 and the
    # first schedule word are per-row constants.
    low = build_layout(b"cmu440", 10).digit_pos[4:]
    logic, adds = sha256_minhash.lane_ops(low, 1)
    assert (logic, adds) < (1014, 352) and logic > 900
    b = sha256_minhash.bound_seconds(10**9, low, 1, 1.98e9)
    assert b == pytest.approx(10**9 * max(logic / 64, (logic + adds) / 128) / (132 * 1.98e9))


# "cmu440" and messages of 50, 54 and 56 characters: at d = 10 the low six
# digits lie in the one tail block (words 2-4), at the end of block 1
# (words 13-15), and across blocks 1 and 2 (words 14-16, 15-16).
RESUME_DATA = ["cmu440", "The quick brown fox jumps over the lazy dog again!",
               "How vexingly quick daft zebras jump, said the old man.",
               "Pack my box with five dozen liquor jugs, then ship it!!!"]


def _lane_words(lay, lane):
    """The reference layout's tail words of lane ``lane`` of the chunk row
    whose high digits are 1 followed by zeros."""
    digits = str(10 ** (lay.digit_count - 1) + lane)
    words = [np.uint32(w) for w in lay.tail_template]
    for ch, pos in zip(digits, lay.digit_pos):
        words[pos.word] |= np.uint32(ord(ch) << pos.shift)
    return words


@pytest.mark.parametrize("data", RESUME_DATA)
@pytest.mark.parametrize("d", range(7, 21))
def test_resume_point_against_reference_layout(data, d):
    lay = ref_build_layout(data.encode(), d)
    n_tb = lay.n_tail_blocks
    for k in range(1, min(d, 9) + 1):
        low = lay.digit_pos[d - k :]
        fb, p = sha256_minhash.resume_point(low, n_tb)
        assert 0 <= fb < n_tb and 0 <= p < 16
        assert 16 * fb + p == min(q.word for q in low)


@pytest.mark.parametrize("data", RESUME_DATA)
@pytest.mark.parametrize("d", [7, 10, 16, 20])
def test_resume_point_state_is_row_constant(data, d):
    # With the reference compression, on the lowest and the highest lane of
    # a row at the main path's k: the state at the resume point is the
    # same for both, and one round later it is not.
    lay = ref_build_layout(data.encode(), d)
    n_tb = lay.n_tail_blocks
    k = min(d - 1, 6)
    fb, p = sha256_minhash.resume_point(lay.digit_pos[d - k :], n_tb)
    lanes = [_lane_words(lay, lane) for lane in (0, 10**k - 1)]
    words = [np.array(pair, dtype=np.uint32) for pair in zip(*lanes)]
    state = [np.full(2, v, dtype=np.uint32) for v in lay.midstate]
    for blk in range(fb):
        state = ref_compress(state, words[16 * blk : 16 * blk + 16])
    block = words[16 * fb : 16 * fb + 16]
    at = np.array(ref_compress(state, block, stop_round=p)[1])
    after = np.array(ref_compress(state, block, stop_round=p + 1)[1])
    assert (at[:, 0] == at[:, 1]).all()
    assert (after[:, 0] != after[:, 1]).any()


def test_resume_point_rejects_a_word_outside_the_tail():
    assert sha256_minhash.resume_point([(31, 0), (32, 24)], 3) == (1, 15)
    with pytest.raises(ValueError):
        sha256_minhash.resume_point([(31, 0), (32, 24)], 2)


def test_minhash_rejects_bad_operands():
    lay = build_layout(b"abc", 3)
    args = dict(midstate=torch.zeros(8, dtype=torch.uint32),
                tail=torch.zeros((2, 16), dtype=torch.uint32),
                bounds=torch.zeros((2, 2), dtype=torch.int32),
                low_pos=lay.digit_pos[1:])
    for bad in (dict(tail=torch.zeros((2, 16), dtype=torch.int64)),
                dict(bounds=torch.zeros((3, 2), dtype=torch.int32)),
                dict(midstate=torch.zeros(7, dtype=torch.uint32)),
                dict(tail=torch.zeros((2, 17), dtype=torch.uint32))):
        with pytest.raises(ValueError):
            minhash(**dict(args, **bad))
    with pytest.raises(ValueError, match="int32"):
        minhash(**dict(args, tail=torch.zeros((3, 16), dtype=torch.uint32),
                       bounds=torch.zeros((3, 2), dtype=torch.int32),
                       low_pos=build_layout(b"abc", 10).digit_pos[1:]))


@pytest.mark.parametrize("data,lo,hi", [("abc", 95, 321), ("cmu440", 9985, 10015),
                                        ("s" * 61, 100, 460)])
@pytest.mark.parametrize("sieve", [False, True])
def test_sweep_min_hash_cpu_matches_oracle(data, lo, hi, sieve):
    r = sweep.sweep_min_hash(
        data, lo, hi, device="cpu", max_k=2, batch=2, sieve=sieve, host_lane_budget=0
    )
    assert (r.hash, r.nonce) == min_hash_range(data, lo, hi)
    assert r.lanes_swept == hi - lo + 1


def test_sweep_host_routing_and_defaults():
    # Tiny digit classes fold on the host; the result is unchanged.
    r = sweep.sweep_min_hash("abc", 95, 321, device="cpu", host_lane_budget=10**3)
    assert (r.hash, r.nonce) == min_hash_range("abc", 95, 321)
    cpu = torch.device("cpu")
    assert sweep.auto_tune(None, None, None, None, cpu) == ("torch", 4, 5, False, False)
    with pytest.raises(ValueError, match="CUDA"):
        sweep.auto_tune("cuda", None, None, None, cpu)
    with pytest.raises(ValueError, match="int32"):
        sweep.auto_tune("torch", 4096, 6, None, cpu)


def test_sweep_without_device_raises_when_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    from bitcoin_miner_tpu_torch.utils.platform import NoDeviceError

    with pytest.raises(NoDeviceError):
        sweep.sweep_min_hash("abc", 0, 10)


def test_pipeline_cpu_matches_oracle_and_closes():
    p = sweep.SweepPipeline(device="cpu", max_k=2, batch=2, host_lane_budget=0,
                            max_inflight=2)
    try:
        futs = [p.submit("abc", 95, 321), p.submit("cmu440", 985, 1040)]
        got = [f.result(timeout=60) for f in futs]
        assert (got[0].hash, got[0].nonce) == min_hash_range("abc", 95, 321)
        assert (got[1].hash, got[1].nonce) == min_hash_range("cmu440", 985, 1040)
        bad = p.submit("abc", 5, 1)  # empty range: the future fails
        with pytest.raises(ValueError):
            bad.result(timeout=60)
    finally:
        p.close()
    assert not p._dispatcher.is_alive() and not p._fetcher.is_alive()


def test_platform_probe_without_card():
    from bitcoin_miner_tpu_torch.utils import platform

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(platform.NoDeviceError):
        platform.default_device()
    assert platform.resolve_device("cpu") == torch.device("cpu")
    assert platform.device_desc().startswith("cpu")
