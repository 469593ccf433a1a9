"""The factored min-hash of the port against the JAX package and hashlib.

The port's plain version (``minhash_factored_plain``) runs on the CPU; the
JAX side runs the xla body ``make_kernel_body(factored=k_in)`` and the
Pallas kernel ``make_pallas_minhash_factored`` in interpret mode, as the
JAX package's own tests run them.  Inputs are made with numpy from a seed
and handed to both sides; tolerance 0 (the outputs are integers).  The
CUDA kernel's tests are in test_torch_kernel_gpu.py.

Layouts (``"<data> <nonce>"`` at d = 10 with k = 3): the inner digits in
the one tail block (``cmu440``), straddling into the second block (54
characters), and all in the second block, so that block 1 is per-group
work (56 characters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu.ops import sha256 as ref_sha
from bitcoin_miner_tpu.ops import sweep as ref_sweep
from bitcoin_miner_tpu.ops.pallas_sha256 import make_pallas_minhash_factored
from bitcoin_miner_tpu_torch.ops import sha256 as port_sha
from bitcoin_miner_tpu_torch.ops import sweep
from bitcoin_miner_tpu_torch.ops.sha256_minhash import (
    I32_MAX,
    U32_MAX,
    minhash_plain,
    operands_from_reference,
)
from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import (
    minhash_factored,
    minhash_factored_plain,
)

STRADDLE = "How vexingly quick daft zebras jump, said the old man."  # 54
FIB1 = "Pack my box with five dozen liquor jugs, then ship it!!!"  # 56
# (data, d, k, k_in, first inner word): the three layouts.
LAYOUTS = [("cmu440", 10, 3, 1, 4), (STRADDLE, 10, 3, 2, 15), (FIB1, 10, 3, 2, 16)]


def _operands(data: str, d: int, k: int, batch: int, seed: int):
    """Numpy operands of one dispatch: random high digits per row, partial
    bounds, a padding row last.  Returns (JAX layout, midstate, (B, nw + 2)
    chunk table)."""
    rng = np.random.default_rng(seed)
    lay = ref_sha.build_layout(data.encode(), d)
    span = 10**k
    chunks = []
    for _ in range(batch - 1):
        high = int(rng.integers(10 ** (d - k - 1), 10 ** (d - k)))
        lo = int(rng.integers(0, span // 2))
        chunks.append(ref_sweep.Chunk(high * span, lo, int(rng.integers(lo + 1, span + 1))))
    group = ref_sweep.ChunkGroup(d=d, k=k, chunks=tuple(chunks))
    tail, bounds = ref_sweep._fill_templates(lay, group, chunks, batch)
    tailcb = np.concatenate([tail, bounds.astype(np.uint32)], axis=1)
    return lay, np.array(lay.midstate, dtype=np.uint32), tailcb


def _port_args(lay, mid, tailcb, k):
    ops = operands_from_reference(mid, tailcb, None, lay.digit_pos[lay.digit_count - k:],
                                  n_tail_blocks=lay.n_tail_blocks)
    del ops["thresh"]
    return ops


def _flip(th: int) -> np.ndarray:
    return np.array([th ^ 0x80000000], dtype=np.uint32).view(np.int32)


def test_compress_resume_matches_reference():
    rng = np.random.default_rng(3)
    state = rng.integers(0, 2**32, size=(8, 5), dtype=np.uint64).astype(np.uint32)
    words = rng.integers(0, 2**32, size=(16, 5), dtype=np.uint64).astype(np.uint32)
    st = [torch.from_numpy(s.astype(np.int64)) for s in state]
    w = [torch.from_numpy(x.astype(np.int64)) for x in words]
    jst = [jnp.asarray(s) for s in state]
    jw = [jnp.asarray(x) for x in words]
    full = [x.tolist() for x in port_sha.compress(st, w)]
    assert full == [np.asarray(x).tolist() for x in ref_sha.compress(jst, jw)]
    for p in range(17):
        gs = port_sha.compress(st, w, stop_round=p)
        rp, rmid = ref_sha.compress(jst, jw[:p], stop_round=p)
        assert gs[0] == rp == p
        assert [x.tolist() for x in gs[1]] == [np.asarray(x).tolist() for x in rmid], p
        for form, n in ((False, 8), (True, 2), ("h0", 1)):
            got = port_sha.compress(st, w, final_only=form, group_state=gs)
            assert [x.tolist() for x in got] == full[:n], (p, form)
    with pytest.raises(ValueError):
        port_sha.compress(st, w, stop_round=17)


@pytest.mark.parametrize("n", [6, 50, 54, 56, 61])
def test_factor_layout_parity(n):
    data = bytes((5 * i + n) % 94 + 33 for i in range(n))
    for d in (3, 7, 10):
        lay, rlay = port_sha.build_layout(data, d), ref_sha.build_layout(data, d)
        for k in range(2, min(d, 6) + 1):
            assert sweep.default_factor_k_in(k) == ref_sweep.default_factor_k_in(k)
            for k_in in range(1, k):
                a, b = lay.factor(k, k_in), rlay.factor(k, k_in)
                assert (a.k_out, a.k_in, a.first_inner_word) == (b.k_out, b.k_in, b.first_inner_word)
                assert [(p.word, p.shift) for p in a.outer_pos + a.inner_pos] == [
                    (p.word, p.shift) for p in b.outer_pos + b.inner_pos]
                assert a == port_sha.factor_low_pos(lay.digit_pos[d - k:], k_in)
                words, table = port_sha.outer_patch_table(a.outer_pos)
                rwords, rtable = ref_sha.outer_patch_table(b.outer_pos)
                assert words == rwords
                np.testing.assert_array_equal(table, rtable)
                assert table.dtype == np.uint32 and not table.flags.writeable
    with pytest.raises(ValueError):
        port_sha.factor_low_pos(lay.digit_pos[:3], 3)


@pytest.mark.parametrize("data,d,k,k_in,fiw", LAYOUTS)
def test_plain_matches_xla_factored_body(data, d, k, k_in, fiw):
    lay, mid, tailcb = _operands(data, d, k, 3, seed=len(data))
    low = lay.digit_pos[d - k:]
    assert lay.factor(k, k_in).first_inner_word == fiw
    nw = 16 * lay.n_tail_blocks
    tail, bounds = tailcb[:, :nw], tailcb[:, nw:].astype(np.int32)
    body = jax.jit(ref_sweep.make_kernel_body(
        lay.n_tail_blocks, low, k, 3, rolled=True, factored=k_in))
    want = [int(x) for x in body(mid, tail, bounds)]
    assert want[2] != I32_MAX
    args = _port_args(lay, mid, tailcb, k)
    assert minhash_factored_plain(**args, k_in=k_in).tolist() == want
    sieve = jax.jit(ref_sweep.make_kernel_body(
        lay.n_tail_blocks, low, k, 3, rolled=True, sieve=True, factored=k_in))
    for th in (U32_MAX, want[0], want[0] - 1):
        ws = [int(x) for x in sieve(mid, tail, bounds, np.uint32(th))]
        assert ws == (want if th >= want[0] else [U32_MAX, U32_MAX, I32_MAX]), th
        assert minhash_factored_plain(**args, k_in=k_in, thresh=th).tolist() == ws, th


def _tie_fixture():
    """One chunk row of [100, 199] for 'tie' (d 3, k 2, k_in 1: 10 outer
    groups of 10 lanes) and its expected (h0, h1, lane)."""
    lay = ref_sha.build_layout(b"tie", 3)
    h, n = min_hash_range("tie", 100, 199)
    row = np.array(lay.tail_template, dtype=np.uint64)
    dp = lay.digit_pos[0]
    row[dp.word] |= np.uint64(ord("1") << dp.shift)
    tailcb = np.concatenate([row, [0, 100]]).astype(np.uint32)[None, :]
    return lay, np.array(lay.midstate, dtype=np.uint32), tailcb, [h >> 32, h & U32_MAX, n - 100]


def test_plain_matches_pallas_factored_tie_fixture():
    lay, mid, tailcb, expect = _tie_fixture()
    low = lay.digit_pos[1:]
    fs = make_pallas_minhash_factored(lay.n_tail_blocks, low, 2, 1, batch=1,
                                      interpret=True, sieve=True)
    args = _port_args(lay, mid, tailcb, 2)
    for th, want in ((expect[0], expect), (expect[0] - 1, [U32_MAX, U32_MAX, I32_MAX])):
        got = [int(x) for x in fs(mid, tailcb, _flip(th))]
        assert got == want, th
        assert minhash_factored_plain(**args, k_in=1, thresh=th).tolist() == got, th
    # Duplicate rows tie on (h0, h1) everywhere: the lower row wins through
    # the remapped flat index.
    dup = np.tile(tailcb, (2, 1))
    fn = make_pallas_minhash_factored(lay.n_tail_blocks, low, 2, 1, batch=2, cpb=2,
                                      interpret=True)
    got = [int(x) for x in fn(mid, dup)]
    assert got == expect
    assert minhash_factored_plain(**_port_args(lay, mid, dup, 2), k_in=1).tolist() == got


def test_plain_matches_pallas_factored_block1_per_group():
    # 56 characters, k 4 / k_in 2: both inner digits in tail block 2, so
    # the whole first tail block is in the per-group prefix.
    lay, mid, tailcb = _operands(FIB1, 10, 4, 2, seed=9)
    low = lay.digit_pos[6:]
    assert lay.factor(4, 2).first_inner_word == 16
    fs = make_pallas_minhash_factored(lay.n_tail_blocks, low, 4, 2, batch=2,
                                      interpret=True, sieve=True)
    got = [int(x) for x in fs(mid, tailcb, _flip(U32_MAX))]
    assert got[2] != I32_MAX
    args = _port_args(lay, mid, tailcb, 4)
    assert minhash_factored_plain(**args, k_in=2).tolist() == got
    assert minhash_factored_plain(**args, k_in=2, thresh=U32_MAX).tolist() == got


@pytest.mark.parametrize("data,d,k,k_in,fiw", LAYOUTS + [("s" * 61, 4, 3, 1, 16)])
def test_plain_equals_unfactored_plain(data, d, k, k_in, fiw):
    lay, mid, tailcb = _operands(data, d, k, 4, seed=d + k)
    args = _port_args(lay, mid, tailcb, k)
    want = minhash_plain(**args).tolist()
    for ki in range(1, k):
        assert minhash_factored_plain(**args, k_in=ki).tolist() == want, ki
        # The wrapper takes the plain version for CPU tensors.
        assert minhash_factored(**args, k_in=ki, thresh=want[0]).tolist() == want
    empty = dict(args, bounds=torch.zeros_like(args["bounds"]))
    assert minhash_factored_plain(**empty, k_in=k_in).tolist() == [U32_MAX, U32_MAX, I32_MAX]


def test_factored_rejects_bad_k_in():
    lay = port_sha.build_layout(b"abc", 6)
    args = dict(midstate=torch.zeros(8, dtype=torch.uint32),
                tail=torch.zeros((2, 16), dtype=torch.uint32),
                bounds=torch.zeros((2, 2), dtype=torch.int32),
                low_pos=lay.digit_pos[3:])
    for k_in in (0, 3):
        with pytest.raises(ValueError, match="k_in"):
            minhash_factored(**args, k_in=k_in)


@pytest.mark.parametrize("data,lo,hi,max_k", [
    ("cmu440", 5, 15, 2),        # d = 1 (k = 1: the unfactored kernel) and d = 2
    ("cmu440", 93, 107, 2),      # 99 -> 100
    ("cmu440", 985, 1040, 2),    # 999 -> 1000
    ("big", (1 << 64) - 51, (1 << 64) - 1, 1),  # the u64 edge, k = 1 only
    (FIB1, 10**9 + 120, 10**9 + 380, 3),
])
def test_sweep_factored_matches_reference_and_oracle(data, lo, hi, max_k):
    want = min_hash_range(data, lo, hi)
    for sieve in (False, True):
        r = sweep.sweep_min_hash(data, lo, hi, device="cpu", backend="torch", max_k=max_k,
                                 batch=2, factored=True, sieve=sieve)
        assert (r.hash, r.nonce) == want
        assert r.lanes_swept == hi - lo + 1
    ref = ref_sweep.sweep_min_hash(data, lo, hi, backend="xla", max_k=max_k, batch=2,
                                   factored=True, sieve=False)
    assert (ref.hash, ref.nonce) == want


def test_pipeline_factored_cpu_and_auto_tune():
    cpu = torch.device("cpu")
    assert sweep.auto_tune(None, None, None, None, cpu) == ("torch", 4, 5, False, False)
    assert sweep.auto_tune("torch", 2, 3, True, cpu, True) == ("torch", 2, 3, True, True)
    p = sweep.SweepPipeline(device="cpu", max_k=2, batch=2, host_lane_budget=0,
                            factored=True, max_inflight=2)
    try:
        assert p._factored
        futs = [p.submit("abc", 95, 321), p.submit(FIB1, 985, 1040)]
        got = [f.result(timeout=60) for f in futs]
        assert (got[0].hash, got[0].nonce) == min_hash_range("abc", 95, 321)
        assert (got[1].hash, got[1].nonce) == min_hash_range(FIB1, 985, 1040)
    finally:
        p.close()
    assert not p._dispatcher.is_alive() and not p._fetcher.is_alive()
