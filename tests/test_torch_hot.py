"""The port's hot plane against the JAX package's, on the CPU.

``ops/hot.py::hot_merge_plain`` (the plain version of ``csrc/hot_merge.cu``)
is held step by step to the reference's ``make_hot_step`` (XLA:CPU) fed the
same dispatch outputs, in the single-device form and, after the reference's
``_collective_min`` cascade on the conftest's 8-device mesh, in the mesh
form: carries, probes and the threshold word after every step.  The hot
sweeps (``sweep_min_hash``, ``sweep_min_hash_sharded``, ``SweepPipeline``
with and without ``devices=``) are held to the reference's hot sweeps and to
the workload's oracle; ``_HotLoop`` is driven directly for its contracts;
the miner's watchdog ladder with the hot rung forced on.  Inputs come from
numpy with fixed seeds.  Tolerance 0: the outputs are integers.  The
kernel itself is held to the plain version in test_torch_kernel_gpu.py.
"""

import functools
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bitcoin_miner_tpu import workloads as ref_workloads
from bitcoin_miner_tpu.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu.ops import sweep as ref_sweep
from bitcoin_miner_tpu.parallel import sweep as ref_psweep
from bitcoin_miner_tpu_torch import workloads
from bitcoin_miner_tpu_torch.apps import miner
from bitcoin_miner_tpu_torch.ops import sweep
from bitcoin_miner_tpu_torch.ops.blake2b import build_layout as build_blake2b_layout
from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
from bitcoin_miner_tpu_torch.ops.hot import VACANT, hot_merge, hot_merge_plain, new_carry
from bitcoin_miner_tpu_torch.ops.sha256 import build_layout
from bitcoin_miner_tpu_torch.ops.sha256_minhash import I32_MAX, U32_MAX, minhash, minhash_plain
from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored
from bitcoin_miner_tpu_torch.parallel import sweep_min_hash_sharded
from bitcoin_miner_tpu_torch.utils.metrics import METRICS

SENTINEL = (U32_MAX, U32_MAX, I32_MAX)
N_MESH = 8


# --------------------------------------------------------------------------
# (a) the merge, step by step
# --------------------------------------------------------------------------


def _outputs(seed: int, n_steps: int, n_shards: int):
    """Per step, ``n_shards`` dispatch outputs drawn from few values, so
    exact ties across steps and shards, sentinels and real lanes at
    ``h0 == U32_MAX`` all occur; the first step is one such lane beside
    sentinels, which must enter the vacant carry."""
    rng = np.random.default_rng(seed)
    hs = [0, 1, 2, 7, U32_MAX - 1, U32_MAX]
    steps = [[(U32_MAX, U32_MAX, 5)] + [SENTINEL] * (n_shards - 1)]
    for _ in range(n_steps - 1):
        step = []
        for _ in range(n_shards):
            if rng.random() < 0.25:
                step.append(SENTINEL)
            else:
                step.append((int(rng.choice(hs)), int(rng.choice(hs)),
                             int(rng.integers(0, 50))))
        steps.append(step)
    return steps


def _ref_step(sieve: bool, mesh: bool):
    """The reference's hot step around a fake kernel that returns the
    operands it is given: ``(h0, h1)`` and ``(flat,)`` or ``(dev, flat)``."""
    if mesh:
        def kern(hh, df, _bounds, *_th):
            return hh[0], hh[1], df[0], df[1]
    else:
        def kern(hh, df, _bounds, *_th):
            return hh[0], hh[1], df[0]
    return ref_sweep.make_hot_step("xla", kern, sieve, mesh=mesh)


def _ref_carry(mesh: bool):
    vals = [jnp.uint32(U32_MAX), jnp.uint32(U32_MAX), jnp.int32(-1)]
    return tuple(vals + ([jnp.int32(0)] if mesh else []) + [jnp.int32(I32_MAX)])


@pytest.fixture(scope="module")
def ref_cascade():
    """The reference's ``_collective_min`` under ``shard_map`` on the
    8-device CPU mesh (as tests/test_torch_parallel.py runs it)."""
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


def _word_value(w: torch.Tensor) -> int:
    return int(w[0]) & U32_MAX


def _i32(v) -> int:
    """A uint32 (the reference probe's seq) as the int32 it holds."""
    v = int(v)
    return v - (1 << 32) if v > I32_MAX else v


@pytest.mark.parametrize("sieve", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_merge_matches_reference_hot_step(sieve, seed):
    """Single-device form: carry and probe equal the reference's after each
    of 200 steps (its carry has no device entry; its probe's seq is u32)."""
    step = _ref_step(sieve, mesh=False)
    ref = _ref_carry(mesh=False)
    carry = new_carry("cpu")
    word = torch.full((1,), -1, dtype=torch.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # XLA:CPU cannot donate the carry
        for seq, (out,) in enumerate(_outputs(seed, 200, 1)):
            ref, ref_probe = step(ref, jnp.int32(seq), jnp.array(out[:2], jnp.uint32),
                                  jnp.array(out[2:], jnp.int32), jnp.zeros(1, jnp.int32))
            probe = hot_merge_plain([torch.tensor(out)], seq, carry, [word] if sieve else [])
            rh0, rh1, rseq, rflat = (int(x) for x in ref)
            assert carry.tolist() == [rh0, rh1, rseq, 0, rflat], seq
            assert probe.tolist() == [int(ref_probe[0]), _i32(ref_probe[1])]
            if sieve:
                assert _word_value(word) == carry.tolist()[0]
    assert carry.tolist()[4] != I32_MAX  # the first step's U32_MAX lane entered
    if not sieve:
        assert _word_value(word) == U32_MAX


@pytest.mark.parametrize("sieve", [False, True])
def test_merge_mesh_form_matches_reference_cascade_and_hot_step(ref_cascade, sieve):
    """Mesh form: the port merges the 8 shard outputs itself; the reference
    cascades them on its mesh and merges the cascade in its mesh step."""
    step = _ref_step(sieve, mesh=True)
    ref = _ref_carry(mesh=True)
    carry = new_carry("cpu")
    word = torch.full((1,), -1, dtype=torch.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for seq, outs in enumerate(_outputs(3, 120, N_MESH)):
            g_h0, g_h1, g_dev, g_flat = ref_cascade(outs)
            ref, ref_probe = step(ref, jnp.int32(seq), jnp.array([g_h0, g_h1], jnp.uint32),
                                  jnp.array([g_dev, g_flat], jnp.int32),
                                  jnp.zeros(1, jnp.int32))
            probe = hot_merge_plain([torch.tensor(o) for o in outs], seq, carry,
                                    [word] if sieve else [])
            assert carry.tolist() == [int(x) for x in ref], seq
            assert probe.tolist() == [int(ref_probe[0]), _i32(ref_probe[1])]


def test_merge_contract_cases():
    """The contract's cases by hand: a vacant carry takes a lane at
    (U32_MAX, U32_MAX); an exact tie keeps the carried seq; a sentinel
    changes nothing; a strictly better h1 moves the carry; the word is
    never raised; the CPU wrapper is the plain version."""
    carry = new_carry("cpu")
    assert carry.tolist() == list(VACANT)
    word = torch.tensor([5], dtype=torch.int32)
    assert hot_merge([torch.tensor(SENTINEL)], 0, carry, [word]).tolist() == [U32_MAX, -1]
    assert hot_merge([torch.tensor((U32_MAX, U32_MAX, 9))], 1, carry, [word]).tolist() == [
        U32_MAX, 1]
    assert _word_value(word) == 5
    hot_merge([torch.tensor((3, 4, 7))], 2, carry, [word])
    assert hot_merge([torch.tensor((3, 4, 1))], 3, carry, [word]).tolist() == [3, 2]
    assert hot_merge([torch.tensor((3, 3, 8)), torch.tensor((3, 3, 2))], 4, carry,
                     [word]).tolist() == [3, 4]
    assert carry.tolist() == [3, 3, 4, 0, 8] and _word_value(word) == 3
    with pytest.raises(ValueError, match="outside int32"):
        hot_merge([torch.tensor(SENTINEL)], I32_MAX + 1, carry)


# --------------------------------------------------------------------------
# The wrappers' device threshold
# --------------------------------------------------------------------------


def _tie_setup(family: str = "sha256"):
    """One chunk row of [100, 199] for "tie" (d = 3, k = 2) and the
    ``sha256d`` oracle over it, as the reference's TestHotPlane builds it."""
    lay = (build_layout(b"tie", 3) if family == "sha256"
           else build_blake2b_layout(b"tie", 3))
    group = sweep.ChunkGroup(d=3, k=2, chunks=(sweep.Chunk(100, 0, 100),))
    tail, bounds = sweep._fill_templates(lay, group, group.chunks, 1)
    h, n = min_hash_range("tie", 100, 199)
    ops = (torch.from_numpy(np.array(lay.midstate, dtype=np.uint32)),
           torch.from_numpy(tail), torch.from_numpy(bounds))
    return lay, ops, (h >> 32, h & U32_MAX, n - 100)


@pytest.mark.parametrize("kind", ["minhash", "minhash_factored", "blake2b"])
def test_th_word_is_the_threshold_and_is_lowered_in_place(kind):
    lay, ops, (eh0, _eh1, _elane) = _tie_setup("blake2b" if kind == "blake2b" else "sha256")
    if kind == "blake2b":
        fn = functools.partial(blake2b_minhash, low_pos=lay.digit_pos[1:],
                               msg_len=lay.msg_len, tail_off=lay.tail_off)
    elif kind == "minhash":
        fn = functools.partial(minhash, low_pos=lay.digit_pos[1:])
    else:
        fn = functools.partial(minhash_factored, low_pos=lay.digit_pos[1:], k_in=1)
    full = fn(*ops).tolist()
    for th in (U32_MAX, full[0], full[0] - 1):
        word = torch.tensor([th - (1 << 32) if th > I32_MAX else th], dtype=torch.int32)
        got = fn(*ops, th_word=word).tolist()
        assert got == fn(*ops, thresh=th).tolist()
        assert _word_value(word) == (min(th, full[0]) if got[2] != I32_MAX else th)
    if kind != "blake2b":
        assert full[0] == eh0
    with pytest.raises(ValueError, match="not both"):
        fn(*ops, thresh=1, th_word=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="th_word"):
        fn(*ops, th_word=torch.zeros(1, dtype=torch.int64))


# --------------------------------------------------------------------------
# (b) the single-device hot sweep
# --------------------------------------------------------------------------

RANGES = [(5, 15, 2), (93, 107, 2), (985, 1040, 2), (2**64 - 60, 2**64 - 1, 1)]


@pytest.mark.parametrize("name", ["sha256d", "preimage"])
@pytest.mark.parametrize("lo,hi,max_k", RANGES)
@pytest.mark.parametrize("sieve", [False, True])
def test_hot_sweep_matches_reference_hot_sweep_and_oracle(name, lo, hi, max_k, sieve):
    w = workloads.get(name)
    ref = ref_sweep.sweep_min_hash("cmu440", lo, hi, backend="xla", max_k=max_k, hot=True,
                                   sieve=sieve, workload=ref_workloads.get(name))
    got = sweep.sweep_min_hash("cmu440", lo, hi, device="cpu", max_k=max_k, hot=True,
                               sieve=sieve, workload=w)
    assert (got.hash, got.nonce, got.lanes_swept) == (ref.hash, ref.nonce, ref.lanes_swept)
    assert (got.hash, got.nonce) == w.min_range("cmu440", lo, hi)


@pytest.mark.parametrize("lo,hi,max_k", RANGES)
@pytest.mark.parametrize("sieve", [False, True])
def test_blake2b_hot_sweep_matches_per_chunk_and_oracle(lo, hi, max_k, sieve):
    w = workloads.get("blake2b64")
    kw = dict(device="cpu", max_k=max_k, batch=2, sieve=sieve, workload=w)
    got = sweep.sweep_min_hash("cmu440", lo, hi, hot=True, **kw)
    per_chunk = sweep.sweep_min_hash("cmu440", lo, hi, hot=False, **kw)
    assert (got.hash, got.nonce, got.lanes_swept) == (
        per_chunk.hash, per_chunk.nonce, per_chunk.lanes_swept)
    assert (got.hash, got.nonce) == w.min_range("cmu440", lo, hi)


def test_hot_sweep_many_dispatches_with_host_folds_and_factored():
    """batch 2 at k 2: many dispatches through one carry, with the d <= 3
    classes folded on the host and the factored plain version."""
    lo, hi = 5, 2099
    for factored in (False, True):
        got = sweep.sweep_min_hash("cmu440", lo, hi, device="cpu", max_k=2, batch=2,
                                   sieve=True, hot=True, factored=factored,
                                   host_lane_budget=10**3)
        assert (got.hash, got.nonce) == min_hash_range("cmu440", lo, hi)
        assert got.lanes_swept == hi - lo + 1


def test_auto_hot_is_off_by_default():
    for backend in ("cuda", "torch"):
        for family in ("sha256", "blake2b"):
            assert sweep.auto_hot(None, backend, family) is False
            assert sweep.auto_hot(True, backend, family) is True
            assert sweep.auto_hot(False, backend, family) is False


def test_hot_on_the_cuda_rung_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(ValueError, match="CUDA device"):
        sweep.sweep_min_hash("x", 0, 10, backend="cuda", device="cpu", hot=True)


# --------------------------------------------------------------------------
# (c) _HotLoop driven directly
# --------------------------------------------------------------------------


def test_hot_loop_tie_pruning_finish_and_metrics():
    """Two dispatches of one descriptor: the second ties exactly and keeps
    seq 0; the carry is the same tensor throughout; the drain prunes seq 1;
    finish gives the oracle; the upload and dispatch counters and the
    staleness gauge move."""
    lay, ops, (eh0, eh1, elane) = _tie_setup()
    kern = functools.partial(minhash_plain, low_pos=lay.digit_pos[1:])
    arrays = [t.numpy() for t in ops]
    refills0 = METRICS.get("sweep.ring_refills")
    dispatched0 = METRICS.get("sweep.donated_dispatches")
    loop = sweep._HotLoop("torch", True, [torch.device("cpu")], per_dev_batch=1)
    tok = loop.dispatch(kern, *arrays)
    loop.drain(tok, [100], 100)
    carry = loop.carry
    assert tok.probe.tolist() == [eh0, 0]
    assert METRICS.gauge("kernel.thresh_staleness") == 1.0
    tok = loop.dispatch(kern, *arrays)
    loop.drain(tok, [100], 100)
    assert loop.carry is carry
    assert tok.probe.tolist() == [eh0, 0]  # the exact tie kept the carried seq
    assert set(loop._bases) == {0}
    assert loop.finish() == ((eh0 << 32) | eh1, 100 + elane)
    assert METRICS.get("sweep.ring_refills") - refills0 == 2
    assert METRICS.get("sweep.donated_dispatches") - dispatched0 == 2


def test_hot_loop_prunes_descriptors_to_in_flight():
    lay, ops, _ = _tie_setup()
    kern = functools.partial(minhash_plain, low_pos=lay.digit_pos[1:])
    arrays = [t.numpy() for t in ops]
    loop = sweep._HotLoop("torch", False, [torch.device("cpu")], per_dev_batch=1)
    toks = [loop.dispatch(kern, *arrays) for _ in range(6)]
    for tok in toks:
        loop.drain(tok, [100], 100)
        assert len(loop._bases) <= 2
    assert set(loop._bases) == {0}


def test_hot_loop_vacant_and_missing_descriptor():
    lay, ops, _ = _tie_setup()
    kern = functools.partial(minhash_plain, low_pos=lay.digit_pos[1:])
    arrays = [t.numpy() for t in ops]
    loop = sweep._HotLoop("torch", True, [torch.device("cpu")], per_dev_batch=1)
    assert loop.finish() is None  # no dispatch at all
    padding = [arrays[0], arrays[1], np.zeros((1, 2), dtype=np.int32)]
    loop.drain(loop.dispatch(kern, *padding), [100], 100)
    assert loop.finish() is None  # only a padding row: the carry stays vacant
    loop.dispatch(kern, *arrays)  # its drain is dropped, as a wedge drops it
    with pytest.raises(RuntimeError, match="descriptor was never drained"):
        loop.finish()
    loop._seq = I32_MAX + 1
    with pytest.raises(OverflowError, match="int32"):
        loop.dispatch(kern, *arrays)


# --------------------------------------------------------------------------
# (d) SweepPipeline(hot=True)
# --------------------------------------------------------------------------

JOBS = [("cmu440", 1000, 2234), ("cmu440", 5, 500), ("x", 95, 305), ("x", 99_990, 100_020)]


@pytest.mark.parametrize("name", ["sha256d", "blake2b64"])
def test_hot_pipeline_matches_per_chunk_pipeline(name):
    """Back-to-back jobs, one wholly host-folded ([5, 500] with a budget of
    10^3), against the per-chunk pipeline and the oracle."""
    w = workloads.get(name)
    kw = dict(backend="torch", device="cpu", max_k=2, batch=2, host_lane_budget=10**3,
              sieve=True, workload=w)
    hot, per_chunk = sweep.SweepPipeline(hot=True, **kw), sweep.SweepPipeline(**kw)
    try:
        futs = [(job, hot.submit(*job), per_chunk.submit(*job)) for job in JOBS]
        for job, fh, fp in futs:
            a, b = fh.result(timeout=120), fp.result(timeout=120)
            assert (a.hash, a.nonce, a.lanes_swept) == (b.hash, b.nonce, b.lanes_swept), job
            assert (a.hash, a.nonce) == w.min_range(*job), job
    finally:
        hot.close()
        per_chunk.close()


def test_wedge_dispatch_fires_through_the_hot_path(monkeypatch):
    """``BMT_WEDGE_DISPATCH=1`` hangs the first fetch of a hot pipeline as
    it does a per-chunk one; the watchdog moves the chunk to the next tier."""
    monkeypatch.setenv("BMT_WEDGE_DISPATCH", "1")
    monkeypatch.setitem(sweep._WEDGE_STATE, "fired", False)
    ts = miner._TieredSearch(
        [("torch-hot", lambda: miner._PipelineSearch("torch", device="cpu", hot=True)),
         ("hashlib", lambda: miner._PoolSearch(min_hash_range))],
        wedge_seconds=1.0)
    try:
        assert ts.submit("wedgehot", 0, 80).result(timeout=60) == min_hash_range(
            "wedgehot", 0, 80)
        assert ts.active_tier == "hashlib"
        assert sweep._WEDGE_STATE["fired"]
    finally:
        ts.close()


def test_make_async_search_passes_hot_to_the_default_workload_only():
    s = miner.make_async_search("torch", "cpu", hot=True)
    try:
        assert s._p._hot is True
        assert s.submit("cmu440", 95, 305).result(timeout=60) == min_hash_range(
            "cmu440", 95, 305)
    finally:
        s.close()
    s = miner.make_async_search("torch", "cpu", workload="blake2b64", hot=True)
    try:
        assert s._p._hot is False
    finally:
        s.close()


# --------------------------------------------------------------------------
# (e) the sharded hot sweep and the mesh pipeline
# --------------------------------------------------------------------------


@pytest.mark.parametrize("data,lo,hi,max_k,sieve", [
    ("cmu440", 1000, 2234, 2, True),  # the reference's test_sharded_hot_matches_oracle
    ("x", 95, 305, 1, False),  # its test_sharded_hot_digit_boundary
])
def test_sharded_hot_matches_reference_sharded_hot(data, lo, hi, max_k, sieve):
    ref = ref_psweep.sweep_min_hash_sharded(data, lo, hi, backend="xla", max_k=max_k,
                                            batch_per_device=2, sieve=sieve, hot=True)
    stats = {}
    got = sweep_min_hash_sharded(data, lo, hi, devices=["cpu"] * N_MESH, backend="torch",
                                 max_k=max_k, batch_per_device=2, sieve=sieve, hot=True,
                                 stats=stats)
    assert (got.hash, got.nonce, got.lanes_swept) == (ref.hash, ref.nonce, ref.lanes_swept)
    assert (got.hash, got.nonce) == min_hash_range(data, lo, hi)
    assert stats["dispatches"] > 0


@pytest.mark.parametrize("name", ["sha256d", "preimage", "blake2b64"])
def test_sharded_hot_workloads_match_oracle(name):
    w = workloads.get(name)
    for lo, hi in ((95, 305), (2**64 - 60, 2**64 - 1)):
        got = sweep_min_hash_sharded("wl-mesh", lo, hi, devices=["cpu"] * 3,
                                     backend="torch", max_k=2, batch_per_device=2,
                                     workload=w, sieve=True, hot=True)
        assert (got.hash, got.nonce) == w.min_range("wl-mesh", lo, hi)
        assert got.lanes_swept == hi - lo + 1


def test_mesh_pipeline_hot_matches_reference_mesh_pipeline():
    """The reference's test_mesh_pipeline_hot_matches_oracle jobs through its
    mesh pipeline and the port's ``SweepPipeline(devices=[cpu] * 3)``."""
    jobs = [("cmu440", 1000, 2234), ("cmu440", 2235, 3499)]
    ref = ref_sweep.SweepPipeline(backend="xla", mesh=ref_psweep.default_mesh(N_MESH),
                                  max_k=2, batch=2, host_lane_budget=0, sieve=True,
                                  hot=True)
    port = sweep.SweepPipeline(devices=["cpu"] * 3, backend="torch", max_k=2, batch=2,
                               host_lane_budget=0, sieve=True, hot=True)
    try:
        futs = [(job, ref.submit(*job), port.submit(*job)) for job in jobs]
        for job, fr, fp in futs:
            a, b = fr.result(timeout=300), fp.result(timeout=120)
            assert (b.hash, b.nonce, b.lanes_swept) == (a.hash, a.nonce, a.lanes_swept), job
            assert (b.hash, b.nonce) == min_hash_range(*job), job
    finally:
        ref.close()
        port.close()


# --------------------------------------------------------------------------
# (f) the watchdog ladder's per-chunk rung (the multi-process refusal is
# tests/test_torch_parallel.py::test_hot_plane_is_refused_loudly)
# --------------------------------------------------------------------------


class _Wedged:
    """A device tier whose chunks never complete."""

    def submit(self, data, lower, upper):
        from concurrent.futures import Future

        return Future()

    def close(self):
        pass


def test_hot_rung_on_inserts_cuda_perchunk(monkeypatch):
    """With the hot rung forced on, the cuda tier is followed by its
    per-chunk form (built with hot=False) before the host tiers; a wedged
    hot tier hands the chunk to it."""
    built = []

    def fake(backend, device=None, host_lane_budget=None, workload=None, devices=None,
             hot=None):
        built.append((backend, device, hot))
        if hot is None:
            return _Wedged()
        return miner._PoolSearch(min_hash_range)

    monkeypatch.setattr(sweep, "auto_hot", lambda hot, backend, family="sha256": True)
    monkeypatch.setattr(miner, "make_async_search", fake)
    ts = miner.make_tiered_search("cuda", "cuda:0", wedge_seconds=0.5)
    try:
        assert [t for t, _ in ts._chain] == ["cuda", "cuda-perchunk", "cpu", "hashlib"]
        assert ts.submit("rung", 10, 400).result(timeout=60) == min_hash_range("rung", 10, 400)
        assert ts.active_tier == "cuda-perchunk"
        assert built == [("cuda", "cuda:0", None), ("cuda", "cuda:0", False)]
    finally:
        ts.close()
    w = miner.make_tiered_search("cuda", "cuda:0", wedge_seconds=0.5, workload="blake2b64")
    try:
        assert "cuda-perchunk" not in [t for t, _ in w._chain]  # the default workload only
    finally:
        w.close()


def test_hot_pipeline_submitters_race():
    """Several threads submit to one hot pipeline at once: each job keeps its
    own carry (no result crosses jobs)."""
    p = sweep.SweepPipeline(backend="torch", device="cpu", max_k=2, batch=2,
                            host_lane_budget=0, sieve=True, hot=True)
    jobs = [(f"race{i}", 100 + 37 * i, 400 + 53 * i) for i in range(6)]
    results = {}

    def run(job):
        results[job] = p.submit(*job).result(timeout=120)

    threads = [threading.Thread(target=run, args=(job,)) for job in jobs]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        p.close()
    for job in jobs:
        assert (results[job].hash, results[job].nonce) == min_hash_range(*job), job
