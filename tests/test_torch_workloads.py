"""The port's workload registry and its sweeps against the JAX package's.

The registry must agree with ``bitcoin_miner_tpu.workloads``: names, golden
vectors (literal equality), tier ladders under the map ``pallas`` →
``cuda``, ``xla`` → ``torch``, the resolve and state-envelope helpers,
``hash_nonce`` and each cpu rung.  ``sweep_min_hash(workload=...)`` on the
CPU must equal the reference's ``sweep_min_hash(backend="xla",
workload=...)`` and the workload's oracle.  The reference's BLAKE2b body
runs eagerly (``jax.disable_jit``; see test_torch_blake2b.py).  Tolerance 0.
"""

import jax
import numpy as np
import pytest

from bitcoin_miner_tpu import workloads as ref_workloads
from bitcoin_miner_tpu.ops import sweep as ref_sweep
from bitcoin_miner_tpu_torch import workloads
from bitcoin_miner_tpu_torch.ops import sweep

TIER_MAP = {"pallas": "cuda", "xla": "torch", "cpu": "cpu", "hashlib": "hashlib"}


def test_names_and_golden_vectors_match_the_reference():
    assert workloads.names() == ref_workloads.names()
    assert workloads.DEFAULT_WORKLOAD == ref_workloads.DEFAULT_WORKLOAD
    assert workloads.WORKLOAD_ENV == ref_workloads.WORKLOAD_ENV
    for name in workloads.names():
        w, ref = workloads.get(name), ref_workloads.get(name)
        assert w.golden == ref.golden
        for data, nonce, want in w.golden:
            assert w.hash_nonce(data, nonce) == want
        assert (w.sep, w.kernel_family, w.native_ok) == (ref.sep, ref.kernel_family, ref.native_ok)


@pytest.mark.parametrize("name", ["sha256d", "preimage", "blake2b64"])
def test_tier_ladders_under_the_map(name):
    w, ref = workloads.get(name), ref_workloads.get(name)
    assert workloads.TIER_LADDER == tuple(TIER_MAP[t] for t in ref_workloads.TIER_LADDER)
    mapped = [TIER_MAP[t] for t in ref.tiers]
    if name == "blake2b64":
        # The reference's only device rung is xla; the kernel and its plain
        # version take the device rungs here.
        assert mapped == ["torch", "cpu", "hashlib"]
        mapped = ["cuda"] + mapped
    assert list(w.tiers) == mapped


def test_resolve_and_state_envelopes_round_trip():
    for value in (None, "", "sha256d", "preimage", "blake2b64"):
        assert workloads.resolve(value).name == ref_workloads.resolve(value).name
        nd, ref_nd = workloads.resolve_nondefault(value), ref_workloads.resolve_nondefault(value)
        assert (nd is None) == (ref_nd is None)
    w = workloads.get("preimage")
    assert workloads.resolve(w) is w
    with pytest.raises(ValueError, match="unknown workload"):
        workloads.get("nope")
    payload = {"jobs": [1, 2], "x": "y"}
    for name in (None, "sha256d", "preimage", "blake2b64"):
        stamped = workloads.stamp_state(payload, name)
        assert stamped == ref_workloads.stamp_state(payload, name)
        back = workloads.unwrap_state(stamped, name)
        assert back == ref_workloads.unwrap_state(stamped, name)
        assert {key: back[key] for key in payload} == payload  # the default stays flat
        for other in ("sha256d", "preimage", "blake2b64"):
            assert workloads.unwrap_state(stamped, other) == ref_workloads.unwrap_state(stamped, other)
    assert workloads.unwrap_state("torn", None) is None
    assert workloads.unwrap_state({"jobs": []}, None) == {"jobs": []}  # unstamped = default


def test_registration_invariants():
    with pytest.raises(ValueError, match="golden"):
        workloads.register(workloads.Sha256Workload("fresh", sep="-"))
    with pytest.raises(ValueError, match="already registered"):
        workloads.register(workloads.Sha256Workload("preimage", golden=(("a", 0, 1),)))
    with pytest.raises(ValueError, match="native_ok"):
        workloads.register(workloads.Sha256Workload(
            "liar", sep=":", native_ok=True, golden=(("a", 0, 1),)))
    with pytest.raises(ValueError, match="devices"):
        workloads.get("preimage").make_search("cpu", devices=2)


def test_hash_nonce_matches_the_reference_on_seeded_pairs():
    rng = np.random.default_rng(9)
    for name in workloads.names():
        w, ref = workloads.get(name), ref_workloads.get(name)
        for _ in range(20):
            data = "".join(chr(c) for c in rng.integers(32, 127, int(rng.integers(0, 140))))
            nonce = int(rng.integers(0, 2**63))
            assert w.hash_nonce(data, nonce) == ref.hash_nonce(data, nonce)


@pytest.mark.parametrize("name", ["sha256d", "preimage", "blake2b64"])
def test_cpu_rung_across_digit_boundaries(name):
    w, ref = workloads.get(name), ref_workloads.get(name)
    cpu = w.make_search("cpu")
    for lo, hi in ((99_990, 100_009), (5, 15), (995, 1004)):
        want = ref.min_range("wl", lo, hi)
        assert cpu("wl", lo, hi) == want == w.min_range("wl", lo, hi)
        assert w.make_search("hashlib")("wl", lo, hi) == want


def test_layout_cache_keys_on_separator_and_family():
    # One process, one job's data, two workloads: a cache keyed on
    # (data, d) alone would hand the second sweep the first one's layout.
    data, lo, hi = "cache", 1000, 1200
    pre, default, b2 = (workloads.get(n) for n in ("preimage", "sha256d", "blake2b64"))
    for w in (pre, default, b2, pre):
        r = sweep.sweep_min_hash(data, lo, hi, device="cpu", max_k=2, workload=w)
        assert (r.hash, r.nonce) == w.min_range(data, lo, hi)
    keys = {sweep._layout_cache(data.encode(), 4, w.sep, w.kernel_family).tail_template
            for w in (pre, default, b2)}
    assert len(keys) == 3


@pytest.mark.parametrize("name,data,lo,hi", [
    ("preimage", "p" * 60, 9_995, 10_012),
    ("blake2b64", "cmu440", 95, 104),
])
def test_sweep_matches_reference_and_oracle(name, data, lo, hi):
    w, ref = workloads.get(name), ref_workloads.get(name)
    got = sweep.sweep_min_hash(data, lo, hi, device="cpu", max_k=2, batch=3, workload=w)
    with jax.disable_jit(name == "blake2b64"):
        want = ref_sweep.sweep_min_hash(data, lo, hi, backend="xla", max_k=2, batch=3,
                                        factored=False, workload=ref)
    assert (got.hash, got.nonce, got.lanes_swept) == (want.hash, want.nonce, want.lanes_swept)
    assert (got.hash, got.nonce) == ref.min_range(data, lo, hi)
    f = sweep.sweep_min_hash(data, lo, hi, device="cpu", max_k=2, factored=True, workload=w)
    assert (f.hash, f.nonce) == (got.hash, got.nonce)


def test_blake2b_rung_defaults():
    import torch

    cpu = torch.device("cpu")
    assert sweep.auto_tune(None, None, None, None, cpu, None, "blake2b") == (
        "torch", 4, 5, False, False)
    assert sweep.auto_tune("torch", None, None, None, cpu, True, "blake2b")[4] is True
    assert sweep.auto_tune(None, None, None, None, cpu, None, "sha256")[3] is False
    card = torch.device("cuda", 0)  # a device object; nothing runs on it
    assert sweep.auto_tune(None, None, None, None, card, None, "blake2b") == (
        "cuda", 1024, 6, False, False)
    with pytest.raises(ValueError, match="one form"):
        sweep.auto_tune(None, None, None, None, card, True, "blake2b")
    with pytest.raises(ValueError):
        sweep.auto_tune(None, None, None, None, cpu, None, "md5")
