"""The CUDA min-hash kernels against their plain PyTorch versions, on the card.

The SHA-256 kernels (main and factored) and the BLAKE2b-64 kernel, each
held to its plain version on the same operands; the cuda rung's sweeps of
each workload held to the workload's oracle, across 10^19 and up to the
u64 edge too; and the sharded sweep (one and two shards on one card, and
the mesh pipeline) held to the single-device sweep.  The hot plane's merge
kernel is held to its plain version step by step, and the hot sweeps of
the three kernels' paths to the per-chunk ones and the oracle.  The model
entry is held to its plain version, and two in-process federation
replicas with cuda miners answer a forwarded job exactly.

Marked ``gpu``: without a CUDA card each test skips with a reason.  This
file imports only the port (no JAX), so it also runs on a machine without
JAX; there the JAX-bound ``tests/conftest.py`` is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_gpu.py -m gpu

Tolerance 0: the outputs are integers (hashes and a lane index).
"""

import numpy as np
import pytest
import torch

from bitcoin_miner_tpu_torch import workloads
from bitcoin_miner_tpu_torch.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu_torch.ops import blake2b, sweep
from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
from bitcoin_miner_tpu_torch.ops.hot import hot_merge, hot_merge_plain, new_carry
from bitcoin_miner_tpu_torch.ops.sha256 import build_layout
from bitcoin_miner_tpu_torch.ops.sha256_minhash import (
    I32_MAX,
    U32_MAX,
    minhash,
    minhash_plain,
)
from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import (
    minhash_factored,
    minhash_factored_plain,
)
from bitcoin_miner_tpu_torch.parallel import sweep_min_hash_sharded


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _operands(data: str, d: int, k: int, batch: int, seed: int, device):
    """One dispatch with random high digits, partial bounds and a padding
    row, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    lay = build_layout(data.encode(), d)
    span = 10**k
    chunks = []
    for _ in range(batch - 1):
        high = int(rng.integers(10 ** (d - k - 1), 10 ** (d - k)))
        lo = int(rng.integers(0, span // 2))
        chunks.append(sweep.Chunk(high * span, lo, int(rng.integers(lo + 1, span + 1))))
    group = sweep.ChunkGroup(d=d, k=k, chunks=tuple(chunks))
    tail, bounds = sweep._fill_templates(lay, group, chunks, batch)
    return dict(
        midstate=torch.tensor(lay.midstate, dtype=torch.int64).to(torch.uint32).to(device),
        tail=torch.from_numpy(tail).to(device),
        bounds=torch.from_numpy(bounds).to(device),
        low_pos=lay.digit_pos[d - k :],
    )


@pytest.mark.gpu
@pytest.mark.parametrize("data,d,k", [("cmu440", 10, 6), ("s" * 61, 4, 3),
                                      ("x" * 50, 10, 5)])
@pytest.mark.parametrize("sieve", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, data, d, k, sieve):
    ops = _operands(data, d, k, 4, seed=d + k, device=cuda_device)
    full = minhash_plain(**ops).tolist()
    assert full[2] != I32_MAX
    ths = [U32_MAX, full[0], full[0] - 1] if sieve else [None]
    for th in ths:
        got = minhash(**ops, thresh=th)
        torch.cuda.synchronize()
        assert got.tolist() == minhash_plain(**ops, thresh=th).tolist(), th


FIFTY = "The quick brown fox jumps over the lazy dog again!"
STRADDLE = "How vexingly quick daft zebras jump, said the old man."
FIB1 = "Pack my box with five dozen liquor jugs, then ship it!!!"
# (data, d, k): rows shorter than a run of 10 lanes or a block's tile (k 1
# to 4, one and two tail blocks); the low digits straddling tail blocks 1
# and 2 (56 and 54 characters, k 6) or all in block 2 (56 characters, k 3,
# so the row's constant prefix is all of block 1).
RUN_LAYOUTS = ([("cmu440", 10, k) for k in (1, 2, 3, 4)]
               + [(FIFTY, 10, k) for k in (1, 2, 3, 4)]
               + [(FIB1, 10, 6), (FIB1, 10, 3), (STRADDLE, 10, 6)])


def _run_operands(data: str, d: int, k: int, device):
    """One dispatch whose partial rows start and end inside a run of 10
    lanes (no bound a multiple of 10), plus a padding row."""
    lay = build_layout(data.encode(), d)
    span = 10**k
    high = 10 ** (d - k - 1) + 7
    bounds = [(0, span), (span // 7 + 4, span - span // 9 - 1),
              (span // 2 + 1, span // 2 + span // 50 + 3)]
    chunks = [sweep.Chunk((high + 3 * r) * span, lo, hi) for r, (lo, hi) in enumerate(bounds)]
    group = sweep.ChunkGroup(d=d, k=k, chunks=tuple(chunks))
    tail, bnd = sweep._fill_templates(lay, group, chunks, len(chunks) + 1)
    return dict(
        midstate=torch.tensor(lay.midstate, dtype=torch.int64).to(torch.uint32).to(device),
        tail=torch.from_numpy(tail).to(device),
        bounds=torch.from_numpy(bnd).to(device),
        low_pos=lay.digit_pos[d - k :],
    )


@pytest.mark.gpu
@pytest.mark.parametrize("data,d,k", RUN_LAYOUTS)
@pytest.mark.parametrize("sieve", [False, True])
def test_kernel_runs_and_row_prefix_match_plain_on_card(cuda_device, data, d, k, sieve):
    ops = _run_operands(data, d, k, cuda_device)
    full = minhash_plain(**ops).tolist()
    assert full[2] != I32_MAX
    ths = [U32_MAX, full[0], full[0] - 1] if sieve else [None]
    for th in ths:
        got = minhash(**ops, thresh=th)
        torch.cuda.synchronize()
        assert got.tolist() == minhash_plain(**ops, thresh=th).tolist(), th


@pytest.mark.gpu
def test_kernel_padding_only_dispatch(cuda_device):
    ops = _operands("cmu440", 10, 6, 2, seed=0, device=cuda_device)
    ops["bounds"].zero_()
    assert minhash(**ops).tolist() == [U32_MAX, U32_MAX, I32_MAX]


@pytest.mark.gpu
def test_sweep_cuda_matches_oracle(cuda_device):
    n0 = minhash.launches
    r = sweep.sweep_min_hash("cmu440", 999_990, 1_000_020, device=cuda_device)
    assert (r.hash, r.nonce) == min_hash_range("cmu440", 999_990, 1_000_020)
    assert minhash.launches > n0


# (data, d, k, k_in): inner digits in the one tail block; straddling into
# the second; all in the second (the first block is per-group work).
FACTORED_LAYOUTS = [
    ("cmu440", 10, 6, 3),
    ("How vexingly quick daft zebras jump, said the old man.", 10, 6, 3),
    ("Pack my box with five dozen liquor jugs, then ship it!!!", 10, 6, 3),
    ("Pack my box with five dozen liquor jugs, then ship it!!!", 10, 4, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("data,d,k,k_in", FACTORED_LAYOUTS)
@pytest.mark.parametrize("sieve", [False, True])
def test_factored_kernel_matches_plain_on_card(cuda_device, data, d, k, k_in, sieve):
    ops = _operands(data, d, k, 4, seed=d + k + k_in, device=cuda_device)
    full = minhash_factored_plain(**ops, k_in=k_in).tolist()
    assert full[2] != I32_MAX
    assert minhash_plain(**ops).tolist() == full
    ths = [U32_MAX, full[0], full[0] - 1] if sieve else [None]
    for th in ths:
        got = minhash_factored(**ops, k_in=k_in, thresh=th)
        torch.cuda.synchronize()
        assert got.tolist() == minhash_factored_plain(**ops, k_in=k_in, thresh=th).tolist(), th


@pytest.mark.gpu
def test_factored_kernel_padding_only_dispatch(cuda_device):
    ops = _operands("cmu440", 10, 6, 2, seed=0, device=cuda_device)
    ops["bounds"].zero_()
    assert minhash_factored(**ops, k_in=3).tolist() == [U32_MAX, U32_MAX, I32_MAX]


@pytest.mark.gpu
def test_sweep_factored_cuda_matches_oracle(cuda_device):
    n0 = minhash_factored.launches
    r = sweep.sweep_min_hash("cmu440", 999_990, 1_000_020, device=cuda_device,
                             factored=True)
    assert (r.hash, r.nonce) == min_hash_range("cmu440", 999_990, 1_000_020)
    assert minhash_factored.launches > n0


# (data, d, k, batch): one tail block (the prefix folded into the midstate
# or not); two with the low digits straddling them; two with the low digits
# all in the second (its first block once per CUDA block); k 1 to 6.
BLAKE2B_LAYOUTS = [
    ("cmu440", 10, 6, 4), ("cmu440", 7, 1, 3), ("cmu440", 10, 3, 2),
    ("y" * 200, 10, 5, 4), ("x" * 120, 10, 6, 3), ("x" * 120, 8, 2, 4),
    ("z" * 126, 10, 6, 4), ("z" * 126, 10, 4, 3),
]


def _blake2b_operands(data: str, d: int, k: int, batch: int, seed: int, device):
    """One BLAKE2b dispatch with random high digits, bounds inside rows and
    a padding row, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    lay = blake2b.build_layout(data.encode(), d)
    span = 10**k
    chunks = []
    for _ in range(batch - 1):
        high = int(rng.integers(10 ** (d - k - 1), 10 ** (d - k)))
        lo = int(rng.integers(0, span // 2))
        chunks.append(sweep.Chunk(high * span, lo, int(rng.integers(lo + 1, span + 1))))
    group = sweep.ChunkGroup(d=d, k=k, chunks=tuple(chunks))
    tail, bounds = sweep._fill_templates(lay, group, chunks, batch)
    ops = dict(
        midstate=torch.tensor(lay.midstate, dtype=torch.int64).to(torch.uint32).to(device),
        tail=torch.from_numpy(tail).to(device),
        bounds=torch.from_numpy(bounds).to(device),
        low_pos=lay.digit_pos[d - k :],
    )
    return ops, dict(msg_len=lay.msg_len, tail_off=lay.tail_off)


def _blake2b_plain(ops, counters, thresh=None):
    return blake2b.blake2b_minhash_plain(
        ops["midstate"], ops["tail"], ops["bounds"], thresh, low_pos=ops["low_pos"],
        k=len(ops["low_pos"]), **counters).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("data,d,k,batch", BLAKE2B_LAYOUTS)
@pytest.mark.parametrize("sieve", [False, True])
def test_blake2b_kernel_matches_plain_on_card(cuda_device, data, d, k, batch, sieve):
    ops, counters = _blake2b_operands(data, d, k, batch, seed=d + k, device=cuda_device)
    full = _blake2b_plain(ops, counters)
    assert full[2] != I32_MAX
    ths = [U32_MAX, full[0], full[0] - 1] if sieve else [None]
    for th in ths:
        got = blake2b_minhash(**ops, thresh=th, **counters)
        torch.cuda.synchronize()
        assert got.tolist() == _blake2b_plain(ops, counters, th), th


@pytest.mark.gpu
def test_blake2b_kernel_padding_only_dispatch(cuda_device):
    ops, counters = _blake2b_operands("cmu440", 10, 6, 2, seed=0, device=cuda_device)
    ops["bounds"].zero_()
    assert blake2b_minhash(**ops, **counters).tolist() == [U32_MAX, U32_MAX, I32_MAX]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["blake2b64", "preimage"])
def test_sweep_cuda_matches_workload_oracle(cuda_device, name):
    w = workloads.get(name)
    n0 = blake2b_minhash.launches, minhash.launches
    r = sweep.sweep_min_hash("cmu440", 999_990, 1_000_020, device=cuda_device, workload=w)
    assert (r.hash, r.nonce) == w.min_range("cmu440", 999_990, 1_000_020)
    launched = (blake2b_minhash.launches - n0[0], minhash.launches - n0[1])
    assert launched[0] > 0 if name == "blake2b64" else launched[1] > 0


# The three kernels' paths: (workload, factored) -> the wrapper it launches.
KERNEL_PATHS = [("sha256d", False, minhash), ("sha256d", True, minhash_factored),
                ("blake2b64", False, blake2b_minhash)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,factored,kernel", KERNEL_PATHS)
@pytest.mark.parametrize("sieve", [False, True])
@pytest.mark.parametrize("n", [1, 2])
def test_sharded_on_one_card_matches_single_device(cuda_device, name, factored, kernel,
                                                   sieve, n):
    """n shards on cuda:0 against the single-device sweep with as many rows
    per dispatch: 4 rows per shard, so the d = 7 class's 13 chunks spread
    over both shards and the last dispatch pads."""
    w = workloads.get(name)
    kw = dict(max_k=3, workload=w, sieve=sieve, factored=factored)
    lo, hi = 999_000, 1_012_345
    n0 = kernel.launches
    got = sweep_min_hash_sharded("mesh", lo, hi, devices=[cuda_device] * n,
                                 batch_per_device=4, **kw)
    assert kernel.launches > n0
    one = sweep.sweep_min_hash("mesh", lo, hi, device=cuda_device, batch=4 * n, **kw)
    assert (got.hash, got.nonce, got.lanes_swept) == (one.hash, one.nonce, one.lanes_swept)
    assert (got.hash, got.nonce) == w.min_range("mesh", lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("name,factored,kernel", KERNEL_PATHS)
@pytest.mark.parametrize("lo,hi", [(10**19 - 40, 10**19 + 25), (2**64 - 60, 2**64 - 1)])
@pytest.mark.parametrize("n", [None, 2])
def test_sweep_across_1e19_and_to_the_u64_edge_on_card(cuda_device, name, factored, kernel,
                                                        lo, hi, n):
    """d = 19 and 20 at the cuda rung's defaults, one device (n None) or
    two shards on cuda:0, against the oracle."""
    w = workloads.get(name)
    n0 = kernel.launches
    if n is None:
        r = sweep.sweep_min_hash("edge", lo, hi, device=cuda_device, workload=w,
                                 factored=factored)
    else:
        r = sweep_min_hash_sharded("edge", lo, hi, devices=[cuda_device] * n, workload=w,
                                   factored=factored)
    assert kernel.launches > n0
    assert (r.hash, r.nonce) == w.min_range("edge", lo, hi)


@pytest.mark.gpu
def test_mesh_pipeline_on_one_card_matches_single_device(cuda_device):
    jobs = [("cmu440", 999_000, 1_012_345), ("x", 95, 100_020), ("cmu440", 10**8, 10**8 + 99)]
    kw = dict(backend="cuda", max_k=3, batch=4, host_lane_budget=0)
    mesh_p = sweep.SweepPipeline(devices=[cuda_device] * 2, **kw)
    one_p = sweep.SweepPipeline(device=cuda_device, **kw)
    try:
        futs = [(job, mesh_p.submit(*job), one_p.submit(*job)) for job in jobs]
        for job, fm, fo in futs:
            a, b = fm.result(timeout=120), fo.result(timeout=120)
            assert (a.hash, a.nonce, a.lanes_swept) == (b.hash, b.nonce, b.lanes_swept), job
            assert (a.hash, a.nonce) == min_hash_range(*job), job
    finally:
        mesh_p.close()
        one_p.close()


@pytest.mark.gpu
def test_wrappers_launch_on_their_tensors_card(cuda_device):
    """A launch on cuda:1 from a thread whose current device is cuda:0:
    each wrapper makes the operands' card current around its launch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    ops = _operands("cmu440", 10, 6, 4, seed=3, device=other)
    assert minhash(**ops).tolist() == minhash_plain(**ops).tolist()
    assert minhash_factored(**ops, k_in=3).tolist() == minhash_plain(**ops).tolist()
    b_ops, counters = _blake2b_operands("cmu440", 10, 6, 4, seed=3, device=other)
    assert blake2b_minhash(**b_ops, **counters).tolist() == _blake2b_plain(b_ops, counters)


def _merge_steps(seed: int, n_steps: int, n: int):
    """Per step, n shard outputs from few values (ties, sentinels, real
    lanes at h0 == U32_MAX); the first a U32_MAX lane into the vacant carry."""
    rng = np.random.default_rng(seed)
    hs = [0, 1, 2, 7, U32_MAX - 1, U32_MAX]
    sentinel = (U32_MAX, U32_MAX, I32_MAX)
    steps = [[(U32_MAX, U32_MAX, 5)] + [sentinel] * (n - 1)]
    for _ in range(n_steps - 1):
        steps.append([sentinel if rng.random() < 0.25 else
                      (int(rng.choice(hs)), int(rng.choice(hs)), int(rng.integers(0, 50)))
                      for _ in range(n)])
    return steps


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("sieve", [False, True])
def test_hot_merge_matches_plain_on_card(cuda_device, n, sieve):
    """Carry, probe and threshold word equal the plain version's after every
    step, on the card, with the kernel's launch count one per step."""
    carry, ref = new_carry(cuda_device), new_carry(cuda_device)
    words = [torch.full((1,), -1, dtype=torch.int32, device=cuda_device) for _ in range(2)]
    n0 = hot_merge.launches
    for seq, outs in enumerate(_merge_steps(n + 10 * sieve, 150, n)):
        outs = [torch.tensor(o, device=cuda_device) for o in outs]
        got = hot_merge(outs, seq, carry, words[:1] if sieve else [])
        want = hot_merge_plain(outs, seq, ref, words[1:] if sieve else [])
        torch.cuda.synchronize()
        assert got.tolist() == want.tolist(), seq
        assert carry.tolist() == ref.tolist(), seq
        assert words[0].tolist() == words[1].tolist(), seq
    assert hot_merge.launches - n0 == 150


@pytest.mark.gpu
@pytest.mark.parametrize("name,factored,kernel", KERNEL_PATHS)
@pytest.mark.parametrize("sieve", [False, True])
def test_hot_sweep_matches_per_chunk_and_oracle_on_card(cuda_device, name, factored, kernel,
                                                        sieve):
    """Small batches over digit boundaries, across 10^19 and at the u64
    edge: the hot sweep launches the kernel and the merge once per dispatch
    and equals the per-chunk sweep and the oracle."""
    w = workloads.get(name)
    for lo, hi, kw in ((985, 101_234, dict(max_k=3, batch=4)),
                       (10**19 - 40, 10**19 + 25, {}), (2**64 - 60, 2**64 - 1, {})):
        kw = dict(device=cuda_device, workload=w, sieve=sieve, factored=factored, **kw)
        kernels = (minhash, minhash_factored, blake2b_minhash)
        n0, m0, k0 = sum(k.launches for k in kernels), hot_merge.launches, kernel.launches
        got = sweep.sweep_min_hash("hot", lo, hi, hot=True, **kw)
        assert sum(k.launches for k in kernels) - n0 == hot_merge.launches - m0
        assert kernel.launches > k0
        per_chunk = sweep.sweep_min_hash("hot", lo, hi, **kw)
        assert (got.hash, got.nonce, got.lanes_swept) == (
            per_chunk.hash, per_chunk.nonce, per_chunk.lanes_swept)
        assert (got.hash, got.nonce) == w.min_range("hot", lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("sieve", [False, True])
def test_hot_two_shards_on_one_card_match_one_device(cuda_device, sieve):
    """Two shards on cuda:0 share one threshold word; the sharded sweep
    and the mesh pipeline with hot=True equal one device's sweep."""
    lo, hi = 999_000, 1_012_345
    one = sweep.sweep_min_hash("mesh", lo, hi, device=cuda_device, max_k=3, batch=8,
                               sieve=sieve)
    got = sweep_min_hash_sharded("mesh", lo, hi, devices=[cuda_device] * 2, max_k=3,
                                 batch_per_device=4, sieve=sieve, hot=True)
    assert (got.hash, got.nonce, got.lanes_swept) == (one.hash, one.nonce, one.lanes_swept)
    jobs = [("cmu440", 999_000, 1_012_345), ("x", 95, 100_020), ("cmu440", 10**8, 10**8 + 99)]
    p = sweep.SweepPipeline(devices=[cuda_device] * 2, backend="cuda", max_k=3, batch=4,
                            host_lane_budget=0, sieve=sieve, hot=True)
    try:
        for job, fut in [(job, p.submit(*job)) for job in jobs]:
            r = fut.result(timeout=120)
            assert (r.hash, r.nonce) == min_hash_range(*job), job
    finally:
        p.close()


@pytest.mark.gpu
def test_hot_sharded_across_two_cards(cuda_device):
    """Shards on cuda:0 and cuda:1: outputs reach the merge on cuda:0, and
    cuda:1's threshold word is copied from the merged one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    lo, hi = 999_000, 1_012_345
    for sieve in (False, True):
        got = sweep_min_hash_sharded("cards", lo, hi, devices=devs, max_k=3,
                                     batch_per_device=4, sieve=sieve, hot=True)
        assert (got.hash, got.nonce) == min_hash_range("cards", lo, hi)


@pytest.mark.gpu
def test_model_entry_and_a_forwarded_federation_job_on_card(cuda_device):
    """``forward_step_example`` on the card launches the kernel and equals
    its plain version; two in-process replicas, a cuda miner on each,
    answer a job forwarded from the non-home cell exactly."""
    import threading

    from bitcoin_miner_tpu_torch import lsp
    from bitcoin_miner_tpu_torch.apps import client, miner
    from bitcoin_miner_tpu_torch.federation import Replica, Ring
    from bitcoin_miner_tpu_torch.models import forward_step_example

    fn, args = forward_step_example()
    assert fn is minhash and args[0].device.type == "cuda"
    n0 = minhash.launches
    assert fn(*args).tolist() == minhash_plain(*args).tolist()
    assert minhash.launches == n0 + 1

    params = lsp.Params(5, 200, 5)
    ports = {}
    for name in ("p", "q"):
        sock = lsp.Server(0, params)  # a free UDP port for each federation port
        ports[name] = sock.port
        sock.close()
    cells = {name: Replica(name, {o: ("127.0.0.1", ports[o]) for o in ports if o != name},
                           fed_port=ports[name], params=params, gossip_interval=0.15,
                           tick_interval=0.05).start() for name in ports}
    try:
        for cell in cells.values():
            conn = lsp.Client("127.0.0.1", cell.port, params)
            threading.Thread(target=miner.run_miner, args=(conn, miner.make_search("cuda")),
                             daemon=True).start()
        ring = Ring(list(cells))
        key = next(f"gpu-fwd-{i}" for i in range(4096) if ring.home(f"gpu-fwd-{i}") == "q")
        n0 = minhash.launches
        conn = lsp.Client("127.0.0.1", cells["p"].port, params)
        try:
            got = client.request_once(conn, key, 2 * 10**8, timeout=60)
        finally:
            conn.close()
        r = sweep.sweep_min_hash(key, 0, 2 * 10**8, device=cuda_device)
        assert got == (r.hash, r.nonce)
        assert minhash.launches > n0
    finally:
        for cell in cells.values():
            cell.close()
