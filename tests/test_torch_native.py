"""The port's native host tier (native/) against the JAX package's.

Both packages compile the same C++ sweep with g++; the port builds it into
``bitcoin_miner_tpu_torch/build/``.  Results must equal the reference's
``min_hash_range_native`` and the hashlib oracle bit for bit.  Skips with a
reason where g++ is missing.
"""

import shutil

import numpy as np
import pytest

from bitcoin_miner_tpu import native as ref_native
from bitcoin_miner_tpu.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu_torch import native
from bitcoin_miner_tpu_torch.ops import sweep


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native sweep")
    assert native.available() and ref_native.available()


_RNG = np.random.default_rng(15)
CASES = [("cmu440", 0, 500), ("", 99_990, 100_009), ("x" * 60, 999_950, 1_000_049),
         ("y" * 130, 5, 123)] + [
    (f"seed{int(s)}", int(lo), int(lo) + int(n))
    for s, lo, n in zip(_RNG.integers(0, 10**6, 3), _RNG.integers(0, 10**12, 3),
                        _RNG.integers(0, 3000, 3))]


@pytest.mark.parametrize("data,lo,hi", CASES)
def test_native_matches_reference_and_oracle(built, data, lo, hi):
    got = native.min_hash_range_native(data, lo, hi)
    assert got == ref_native.min_hash_range_native(data, lo, hi)
    assert got == min_hash_range(data, lo, hi)
    assert native.min_hash_range_native(data, lo, hi, threads=1) == got


def test_native_tie_keeps_the_lowest_nonce(built):
    # Many threads over one range: the reduce must keep the scalar loop's
    # lowest nonce; a one-nonce range repeated gives equal hashes.
    assert native.min_hash_range_native("tie", 0, 2000, threads=7) == \
        native.min_hash_range_native("tie", 0, 2000, threads=1)
    h, n = native.min_hash_range_native("tie", 77, 77, threads=4)
    assert (h, n) == min_hash_range("tie", 77, 77)


def test_native_rejects_bad_ranges(built):
    for lo, hi in ((5, 4), (-1, 3), (0, 1 << 64)):
        with pytest.raises(ValueError):
            native.min_hash_range_native("x", lo, hi)
    assert native.have_shani() == ref_native.have_shani()


def test_host_fold_of_the_sweep_uses_the_native_tier(built):
    # 10^d <= the budget: the whole range folds on the host.
    r = sweep.sweep_min_hash("cmu440", 99_990, 100_009, device="cpu",
                             host_lane_budget=10**6)
    assert (r.hash, r.nonce) == min_hash_range("cmu440", 99_990, 100_009)
    assert sweep._host_min("cmu440", 0, 99) == ref_native.min_hash_range_native("cmu440", 0, 99)
