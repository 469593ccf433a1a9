"""parallel/ of the port against the JAX package's, on the CPU.

The port's ``_collective_min`` is held to the reference's three-``pmin``
cascade, run under ``shard_map`` on the conftest's 8-device CPU mesh; the
port's ``sweep_min_hash_sharded`` over CPU shards (the plain versions of the
kernels, one per shard) to the reference's sharded sweeps on that mesh and
to the hashlib oracle; ``SweepPipeline(devices=)`` to the single-device
pipeline.  Tolerance 0 throughout: the outputs are integers.  The same
paths on the card are in test_torch_kernel_gpu.py.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bitcoin_miner_tpu.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu.parallel import sweep as ref_psweep
from bitcoin_miner_tpu_torch import workloads
from bitcoin_miner_tpu_torch.ops.sweep import SweepPipeline, sweep_min_hash
from bitcoin_miner_tpu_torch.parallel import mesh, sweep_min_hash_sharded
from bitcoin_miner_tpu_torch.parallel.sweep import (
    I32_MAX,
    U32_MAX,
    World,
    _candidate,
    _cascade,
    _collective_min,
    shard_operands,
)
from bitcoin_miner_tpu_torch.utils.platform import NoDeviceError

SENTINEL = (U32_MAX, U32_MAX, I32_MAX)
N_MESH = 8


@pytest.fixture(scope="module")
def ref_cascade():
    """The reference's ``_collective_min`` under ``shard_map`` over the
    8-device CPU mesh: one (h0, h1, flat) per device in, the replicated
    ``(g_h0, g_h1, g_dev, g_flat)`` out."""
    m = Mesh(np.array(jax.devices()[:N_MESH]), ("miners",))

    def local(h0, h1, flat):
        return ref_psweep._collective_min(h0[0], h1[0], flat[0], "miners")

    fn = jax.jit(ref_psweep._shard_map(
        local, mesh=m, in_specs=(P("miners"),) * 3, out_specs=(P(),) * 4,
        check_vma=False))

    def run(triples):
        a = np.array(triples, dtype=np.int64)
        out = fn(a[:, 0].astype(np.uint32), a[:, 1].astype(np.uint32),
                 a[:, 2].astype(np.int32))
        return tuple(int(x) for x in out)

    return run


def _cases():
    rng = np.random.default_rng(7)

    def rand(n):
        return [(int(rng.integers(0, 2**32)), int(rng.integers(0, 2**32)),
                 int(rng.integers(0, 2**31 - 1))) for _ in range(n)]

    distinct = rand(N_MESH)
    h0_ties = [(5, int(rng.integers(0, 2**32)), i * 11) for i in range(N_MESH)]
    h0_ties[2] = (5, 3, 900)
    h0_ties[6] = (5, 3, 100)  # ties (h0, h1) on shards 2 and 6: shard 2 wins
    pair_ties = [(9, 9, 50 - i) for i in range(N_MESH)]  # every shard ties
    with_sentinels = rand(N_MESH)
    for i in (0, 3, 4, 7):
        with_sentinels[i] = SENTINEL
    # A real lane hashing to (U32_MAX, U32_MAX) beside sentinels: it wins.
    max_lane = [SENTINEL] * N_MESH
    max_lane[5] = (U32_MAX, U32_MAX, 12)
    # The min h0 sits on shard 6 only; shards 1 and 4 tie the runner-up.
    runner = rand(N_MESH)
    runner[1] = runner[4] = (1, 0, 0)
    runner[6] = (0, U32_MAX, 7)
    return {"distinct": distinct, "h0 ties": h0_ties, "(h0, h1) ties": pair_ties,
            "sentinels": with_sentinels, "all sentinel": [SENTINEL] * N_MESH,
            "max lane beside sentinels": max_lane, "min on one shard": runner}


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_min_matches_reference(ref_cascade, name):
    triples = CASES[name]
    got = _collective_min(triples)
    assert got == ref_cascade(triples), name
    if name == "all sentinel":
        assert got == (U32_MAX, U32_MAX, I32_MAX, I32_MAX)


@pytest.mark.parametrize("split", [(4, 4), (1, 7), (3, 1, 4), (1,) * 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cascade_per_rank_then_across_ranks_equals_one_cascade(name, split):
    """The multi-process path: each rank folds its own shards, then the
    ranks' results go through the same cascade with global device indices
    (what the ranks' collective mins compute together)."""
    triples, per_rank, off = CASES[name], [], 0
    for n in split:
        h0, h1, dev, flat = _collective_min(triples[off:off + n])
        per_rank.append((h0, h1, off + dev if dev != I32_MAX else I32_MAX, flat))
        off += n
    a = np.array(per_rank, dtype=np.int64)
    got = _cascade(a[:, 0], a[:, 1], a[:, 2], a[:, 3], np.min)
    assert got == _collective_min(triples)


def test_candidate_uses_device_rows_not_a_global_flat_index():
    """``row = dev * per_dev_batch + flat // n_lanes``: a winner on shard 3
    of 4 rows per shard, lane 7 of row 1 of that shard."""
    n_lanes, per_dev = 10**6, 4
    vals = [SENTINEL] * 3 + [(0, 5, 1 * n_lanes + 7)]
    bases = [r * n_lanes for r in range(16)]
    want_row = 3 * per_dev + 1
    assert _candidate(vals, bases, n_lanes, per_dev, World(0, 4)) == (
        5, bases[want_row] + 7)
    assert _candidate([SENTINEL] * 4, bases, n_lanes, per_dev, World(0, 4)) is None


def test_shard_operands_split_rows_contiguously():
    tail = np.arange(24, dtype=np.uint32).reshape(12, 2)
    bounds = np.arange(24, dtype=np.int32).reshape(12, 2)
    parts = shard_operands(tail, bounds, 2, 3, first=1)
    np.testing.assert_array_equal(parts[0][0], tail[3:6])
    np.testing.assert_array_equal(parts[1][1], bounds[6:9])
    assert all(t.flags.c_contiguous and b.flags.c_contiguous for t, b in parts)


# (data, lower, upper, batch_per_device, max_k, n_devices): tests/test_parallel.py's
SHARDED = [
    ("cmu440", 1000, 2234, 2, 2, 8),  # one digit group, padded rows
    ("x", 95, 305, 2, 1, 8),  # a digit boundary
    ("cmu440", 1000, 1999, 2, 2, 2),  # a subset of the devices
]


# Each case with the baseline kernel; the first two with the per-shard
# sieve, the first with the factored kernels too.
SHARDED_FORMS = [(*case, False, False) for case in SHARDED] + [
    (*SHARDED[0], True, False), (*SHARDED[1], True, False),
    (*SHARDED[0], False, True), (*SHARDED[0], True, True)]


@pytest.mark.parametrize("data,lo,hi,bpd,max_k,n,sieve,factored", SHARDED_FORMS)
def test_sharded_matches_reference_xla_and_oracle(data, lo, hi, bpd, max_k, n, sieve,
                                                  factored):
    ref_stats, stats = {}, {}
    ref = ref_psweep.sweep_min_hash_sharded(
        data, lo, hi, mesh=Mesh(np.array(jax.devices()[:n]), ("miners",)),
        backend="xla", max_k=max_k, batch_per_device=bpd, sieve=sieve,
        factored=factored, hot=False, stats=ref_stats)
    got = sweep_min_hash_sharded(
        data, lo, hi, devices=["cpu"] * n, backend="torch", max_k=max_k,
        batch_per_device=bpd, sieve=sieve, factored=factored, stats=stats)
    assert (got.hash, got.nonce, got.lanes_swept, stats["dispatches"]) == (
        ref.hash, ref.nonce, ref.lanes_swept, ref_stats["dispatches"])
    assert (got.hash, got.nonce) == min_hash_range(data, lo, hi)
    assert got.lanes_swept == hi - lo + 1


@pytest.mark.parametrize("sieve", [False, True])
def test_sharded_matches_reference_pallas_interpret(sieve):
    data, lo, hi = "cmu440", 1000, 2234
    ref_stats, stats = {}, {}
    ref = ref_psweep.sweep_min_hash_sharded(
        data, lo, hi, backend="pallas", interpret=True, max_k=2, batch_per_device=2,
        sieve=sieve, hot=False, stats=ref_stats)
    got = sweep_min_hash_sharded(data, lo, hi, devices=["cpu"] * N_MESH, backend="torch",
                                 max_k=2, batch_per_device=2, sieve=sieve, stats=stats)
    assert (got.hash, got.nonce, got.lanes_swept, stats["dispatches"]) == (
        ref.hash, ref.nonce, ref.lanes_swept, ref_stats["dispatches"])


# Ranges across 10^19 and ending at the u64 edge (2^64 - 1).
EDGES = [(10**19 - 40, 10**19 + 25), (2**64 - 60, 2**64 - 1)]


@pytest.mark.parametrize("name", ["sha256d", "preimage", "blake2b64"])
@pytest.mark.parametrize("lo,hi", [(95, 305), (99_990, 100_020)] + EDGES)
def test_sharded_workloads_match_oracle_and_single_device(name, lo, hi):
    """Every workload over CPU shards: equal to its oracle and to the
    port's single-device sweep (the reference's sharded BLAKE2b body takes
    minutes to compile on XLA:CPU, so it is not run here)."""
    w = workloads.get(name)
    got = sweep_min_hash_sharded("wl-mesh", lo, hi, devices=["cpu"] * 3, backend="torch",
                                 max_k=2, batch_per_device=2, workload=w)
    one = sweep_min_hash("wl-mesh", lo, hi, device="cpu", max_k=2, batch=2, workload=w)
    assert (got.hash, got.nonce, got.lanes_swept) == (one.hash, one.nonce, one.lanes_swept)
    assert (got.hash, got.nonce) == w.min_range("wl-mesh", lo, hi)


@pytest.mark.parametrize("lo,hi", EDGES)
def test_blake2b_cpu_sweep_at_the_u64_edge(lo, hi):
    """The BLAKE2b plain version at d = 20 (and across 10^19) on the
    CPU, in both forms, against the oracle."""
    w = workloads.get("blake2b64")
    for factored in (False, True):
        r = sweep_min_hash("edge", lo, hi, device="cpu", workload=w, factored=factored)
        assert (r.hash, r.nonce) == w.min_range("edge", lo, hi), factored


@pytest.mark.parametrize("name", ["sha256d", "blake2b64"])
def test_mesh_pipeline_matches_single_device_pipeline(name):
    """SweepPipeline(devices=[cpu] * 3) against the single-device pipeline:
    back-to-back jobs over digit boundaries, another data string, and a
    range whose last dispatch fills one shard of three."""
    w = workloads.get(name)
    jobs = [("cmu440", 1000, 2234), ("cmu440", 2235, 3499), ("x", 95, 305),
            ("x", 99_990, 100_020), ("cmu440", 10_000, 10_299)]
    kw = dict(backend="torch", max_k=2, batch=2, host_lane_budget=0, workload=w)
    mesh_p = SweepPipeline(devices=["cpu"] * 3, **kw)
    one_p = SweepPipeline(device="cpu", **kw)
    try:
        futs = [(job, mesh_p.submit(*job), one_p.submit(*job)) for job in jobs]
        for job, fm, fo in futs:
            a, b = fm.result(timeout=120), fo.result(timeout=120)
            assert (a.hash, a.nonce, a.lanes_swept) == (b.hash, b.nonce, b.lanes_swept), job
            assert (a.hash, a.nonce) == w.min_range(*job), job
    finally:
        mesh_p.close()
        one_p.close()


def test_hot_plane_is_refused_loudly():
    """One process runs the hot plane (tests/test_torch_hot.py holds it to
    the reference); a multi-process world, the multihost miner's, refuses
    it by name."""
    got = sweep_min_hash_sharded("x", 0, 10, devices=["cpu"], backend="torch", hot=True)
    assert (got.hash, got.nonce) == min_hash_range("x", 0, 10)
    world = World(offset=0, n_shards=2, pmin=lambda v: v)
    with pytest.raises(ValueError, match="multi-process world"):
        sweep_min_hash_sharded("x", 0, 10, devices=["cpu"], backend="torch", hot=True,
                               world=world)


def test_resolve_devices():
    cpu = torch.device("cpu")
    assert mesh.resolve_devices(3, "cpu") == [cpu] * 3
    assert mesh.resolve_devices(["cpu", "cpu"]) == [cpu, cpu]
    for bad in (0, -2):
        with pytest.raises(ValueError, match=">= 1"):
            mesh.resolve_devices(bad, "cpu")
    with pytest.raises(ValueError, match="names one card"):
        mesh.resolve_devices(2, "cuda:1")
    with pytest.raises(ValueError, match="mixed"):
        mesh.resolve_devices(["cpu", "meta"])


def test_no_card_raises_rather_than_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(NoDeviceError):
        mesh.default_devices()
    with pytest.raises(NoDeviceError):
        mesh.resolve_devices(2)
    with pytest.raises(NoDeviceError):
        sweep_min_hash_sharded("x", 0, 10)
    with pytest.raises(NoDeviceError):
        SweepPipeline(devices=["cuda:0", "cuda:0"])
