"""ops/sha256.py of the port against the JAX package's and hashlib.

Inputs are made with numpy from a seed and fed to both sides as numpy.
"""

import hashlib

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu.ops import sha256 as ref
from bitcoin_miner_tpu_torch.ops import sha256 as port


def _layout_tuple(lay):
    return (
        lay.data_len, lay.digit_count, lay.midstate, lay.tail_template,
        tuple((p.word, p.shift) for p in lay.digit_pos), lay.n_tail_blocks,
    )


@pytest.mark.parametrize("d", [1, 2, 9, 10, 20])
def test_build_layout_parity_all_lengths(d):
    # Data lengths 0..130 cover 0, 1 and 2 constant prefix blocks and the
    # 1 -> 2 tail-block edge (a 55-byte message still fits one block).
    edges = set()
    for n in range(0, 131):
        data = bytes((7 * i + n) % 94 + 33 for i in range(n))
        a = port.build_layout(data, d)
        b = ref.build_layout(data, d)
        assert _layout_tuple(a) == _layout_tuple(b), (n, d)
        edges.add(a.n_tail_blocks)
        digits = str(10 ** (d - 1) + n)[:d] if d > 1 else str(n % 10)
        msg = data + b" " + digits.encode()
        want = int.from_bytes(hashlib.sha256(msg).digest()[:8], "big")
        assert port.digest_u64_py(a, digits) == want
    assert edges == {1, 2}


def test_tail_block_edge():
    # 55 bytes of message + 9 padding bytes = 64: the last one-block length.
    assert port.build_layout(b"x" * 52, 2).n_tail_blocks == 1
    assert port.build_layout(b"x" * 53, 2).n_tail_blocks == 2


def test_build_layout_rejects_bad_digit_count():
    for d in (0, 21):
        with pytest.raises(ValueError):
            port.build_layout(b"abc", d)


def test_constants_match():
    np.testing.assert_array_equal(port.K, ref.K)
    np.testing.assert_array_equal(port.H0, ref.H0)


def test_compress_matches_py_and_jax():
    rng = np.random.default_rng(0)
    n = 64
    state = rng.integers(0, 2**32, size=(8, n), dtype=np.uint64).astype(np.uint32)
    words = rng.integers(0, 2**32, size=(16, n), dtype=np.uint64).astype(np.uint32)
    got = port.compress(
        [torch.from_numpy(s.astype(np.int64)) for s in state],
        [torch.from_numpy(w.astype(np.int64)) for w in words],
    )
    got = np.stack([g.numpy() for g in got]).astype(np.uint32)
    for lane in range(0, n, 9):
        block = b"".join(int(w).to_bytes(4, "big") for w in words[:, lane])
        want = ref.compress_py([int(s) for s in state[:, lane]], block)
        assert got[:, lane].tolist() == want
        assert port.compress_py([int(s) for s in state[:, lane]], block) == want
    import jax.numpy as jnp

    jx = ref.compress([jnp.asarray(s) for s in state], [jnp.asarray(w) for w in words])
    np.testing.assert_array_equal(got, np.stack([np.asarray(x) for x in jx]))
    # The output-mask forms agree with the full compression.
    ints = ([int(s) for s in state[:, 0]], [int(w) for w in words[:, 0]])
    full = port.compress(*ints)
    assert port.compress(*ints, final_only=True) == full[:2]
    assert port.compress(*ints, final_only="h0") == full[:1]
