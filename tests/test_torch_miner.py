"""The port's miner end to end over LSP, against the JAX package's server.

The JAX package's ``serve`` + ``Scheduler`` and client speak the frozen wire
protocol to a port miner on ``--backend torch`` on the CPU, built with
``host_lane_budget=0`` so the plain version of the kernel, not the host
fold, answers; for the default workload and, through ``--workload``, for
``preimage`` and ``blake2b64`` (the scheduler then serves the same
workload), and with ``--devices 3`` (three CPU shards).  The watchdog drill
wedges the torch rung's pipeline and checks the logged, counted downgrade.
The CLI's stdout lines are pinned as tests/test_cli_contracts.py pins the
JAX package's.  In-process, loopback UDP, small LSP epochs.
"""

import io
import threading
from contextlib import redirect_stdout

import pytest
import torch

from bitcoin_miner_tpu import lsp as ref_lsp
from bitcoin_miner_tpu import lspnet as ref_lspnet
from bitcoin_miner_tpu import workloads as ref_workloads
from bitcoin_miner_tpu.apps import client as ref_client
from bitcoin_miner_tpu.apps import server as ref_server
from bitcoin_miner_tpu.apps.scheduler import Scheduler
from bitcoin_miner_tpu.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu_torch import lsp, workloads
from bitcoin_miner_tpu_torch.apps import miner
from bitcoin_miner_tpu_torch.ops import sweep
from bitcoin_miner_tpu_torch.bitcoin.message import Message as PortMessage
from bitcoin_miner_tpu_torch.bitcoin.message import MsgType as PortMsgType
from bitcoin_miner_tpu.bitcoin.message import Message as RefMessage

REF_PARAMS = ref_lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)
PARAMS = lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)


@pytest.fixture(autouse=True)
def _clean_network():
    ref_lspnet.reset_faults()
    yield
    ref_lspnet.reset_faults()


def test_port_miner_serves_reference_scheduler():
    server = ref_lsp.Server(0, REF_PARAMS)
    st = threading.Thread(
        target=ref_server.serve, args=(server, Scheduler(min_chunk=50)), daemon=True
    )
    st.start()
    search = miner.make_async_search("torch", device="cpu", host_lane_budget=0)
    mc = lsp.Client("127.0.0.1", server.port, PARAMS)
    mt = threading.Thread(target=miner.run_miner, args=(mc, search), daemon=True)
    mt.start()
    try:
        c = ref_lsp.Client("127.0.0.1", server.port, REF_PARAMS)
        try:
            # 99_950..100_049 crosses into the 6-digit class.
            res = ref_client.request_once(c, "cmu440", 100_049, lower=99_950,
                                          timeout=60)
        finally:
            c.close()
        assert res == min_hash_range("cmu440", 99_950, 100_049)
    finally:
        server.close()
        mt.join(timeout=30)
        mc.close()
    assert not mt.is_alive()


def test_wire_codec_matches_reference():
    for m in (PortMessage.join(), PortMessage.request("cmu440", 5, 10**19),
              PortMessage.result(2**64 - 1, 7)):
        raw = m.marshal()
        r = RefMessage.unmarshal(raw)
        assert r is not None and r.marshal() == raw
    assert PortMessage.unmarshal(b'{"Type":1,"Lower":-1}') is None
    assert PortMessage.unmarshal(raw).type == PortMsgType.RESULT


def test_auto_backend_without_card_is_a_configuration_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: auto resolves to cuda")
    out = io.StringIO()
    with redirect_stdout(out):
        rc = miner.main(["miner", "127.0.0.1:9", "--backend", "auto"])
    assert rc == 0
    assert out.getvalue().startswith("Invalid miner configuration:")
    with pytest.raises(ValueError):
        miner.make_async_search("auto")
    with redirect_stdout(io.StringIO()) as out2:
        miner.main(["miner", "127.0.0.1:9", "--backend", "cuda"])
    assert out2.getvalue().startswith("Invalid miner configuration:")


def test_cpu_backends_resolve_without_card():
    assert miner._resolve_backend("auto", "cpu") == "torch"
    want = min_hash_range("abc", 95, 120)
    assert miner.make_search("cpu")("abc", 95, 120) == want
    assert miner.make_search("torch", device="cpu")("abc", 95, 120) == want


@pytest.mark.parametrize("name", ["preimage", "blake2b64"])
def test_port_miner_serves_reference_scheduler_per_workload(name):
    ref_wl = ref_workloads.get(name)
    server = ref_lsp.Server(0, REF_PARAMS)
    st = threading.Thread(
        target=ref_server.serve,
        args=(server, Scheduler(min_chunk=50, workload=ref_wl)), daemon=True,
    )
    st.start()
    search = miner.make_async_search("torch", device="cpu", host_lane_budget=0,
                                     workload=name)
    mc = lsp.Client("127.0.0.1", server.port, PARAMS)
    mt = threading.Thread(target=miner.run_miner, args=(mc, search), daemon=True)
    mt.start()
    try:
        c = ref_lsp.Client("127.0.0.1", server.port, REF_PARAMS)
        try:
            res = ref_client.request_once(c, "cmu440", 100_049, lower=99_950, timeout=60)
        finally:
            c.close()
        assert res == ref_wl.min_range("cmu440", 99_950, 100_049)
        assert res == workloads.get(name).min_range("cmu440", 99_950, 100_049)
    finally:
        server.close()
        mt.join(timeout=30)
        mc.close()
    assert not mt.is_alive()


def test_watchdog_drill_downgrades_torch_to_cpu(monkeypatch, capfd):
    """``BMT_WEDGE_DISPATCH=1`` hangs the first fetch of the torch rung's
    pipeline; the chain abandons it, logs and counts the downgrade, and the
    chunk re-runs bit-exact on the workload's cpu rung."""
    w = workloads.get("blake2b64")
    monkeypatch.setenv("BMT_WEDGE_DISPATCH", "1")
    monkeypatch.setitem(sweep._WEDGE_STATE, "fired", False)
    ts = miner.make_tiered_search("torch", "cpu", wedge_seconds=1.0, workload=w)
    try:
        assert [t for t, _ in ts._chain] == ["torch", "cpu", "hashlib"]
        got = ts.submit("wl-wedge", 200_000, 200_600).result(timeout=60)
        assert got == w.min_range("wl-wedge", 200_000, 200_600)
        assert ts.active_tier == "cpu" and ts.downgrades == 1
        assert sweep._WEDGE_STATE["fired"]
    finally:
        ts.close()
    err = capfd.readouterr().err
    lines = [ln for ln in err.splitlines() if "downgrading" in ln]
    assert lines == ["miner: tier 'torch' wedged (> 1s/chunk); downgrading to 'cpu' "
                     "(downgrade 1)"]


def test_watchdog_chain_follows_the_workload_ladder():
    for name in ("sha256d", "preimage", "blake2b64"):
        ts = miner.make_tiered_search("torch", "cpu", workload=name)
        try:
            assert [t for t, _ in ts._chain] == ["torch", "cpu", "hashlib"]
            assert ts.downgrades == 0
        finally:
            ts.close()
    ts = miner.make_tiered_search("cpu", workload="preimage")
    try:
        assert [t for t, _ in ts._chain] == ["cpu", "hashlib"]
        assert ts.submit("ladder", 0, 300).result(timeout=30) == \
            workloads.get("preimage").min_range("ladder", 0, 300)
    finally:
        ts.close()


class _FakeTier:
    """A device tier stand-in: every chunk raises ``error``, or hangs until
    closed when ``error`` is None (a wedged card)."""

    def __init__(self, error=None):
        self.error, self.closed = error, threading.Event()

    def submit(self, data, lower, upper):
        from concurrent.futures import Future

        fut = Future()
        if self.error is not None:
            fut.set_exception(self.error)
        return fut

    def close(self):
        self.closed.set()


def _fake_cuda(monkeypatch, tier):
    """make_async_search with its cuda rung replaced by ``tier``; the
    other rungs are the real ones.  Records (tier, device) per build."""
    real, built = miner.make_async_search, []

    def fake(backend, device=None, host_lane_budget=None, workload=None, devices=None):
        built.append((backend, device))
        return tier if backend == "cuda" else real(backend, device, workload=workload)

    monkeypatch.setattr(miner, "make_async_search", fake)
    return built


def test_watchdog_wedged_cuda_downgrades_to_host_not_the_card(monkeypatch, capfd):
    """From cuda the chain is cuda -> cpu -> hashlib: a wedged card hands
    the chunk to the host, never to the plain version on the same card."""
    w = workloads.get("blake2b64")
    built = _fake_cuda(monkeypatch, _FakeTier())
    ts = miner.make_tiered_search("cuda", "cuda:0", wedge_seconds=0.5, workload=w)
    try:
        assert [t for t, _ in ts._chain] == ["cuda", "cpu", "hashlib"]
        got = ts.submit("wl-wedge", 99_990, 100_009).result(timeout=60)
        assert got == w.min_range("wl-wedge", 99_990, 100_009)
        assert ts.active_tier == "cpu" and ts.downgrades == 1
        assert built == [("cuda", "cuda:0"), ("cpu", None)]
    finally:
        ts.close()
    lines = [ln for ln in capfd.readouterr().err.splitlines() if "downgrading" in ln]
    assert lines == ["miner: tier 'cuda' wedged (> 0.5s/chunk); downgrading to 'cpu' "
                     "(downgrade 1)"]


def test_watchdog_failing_cuda_fails_the_chunk(monkeypatch, capfd):
    """A cuda tier that raises (a kernel that does not build or launch)
    fails the chunk: no downgrade, no other engine answers it."""
    err = RuntimeError("kernel launch failed")
    _fake_cuda(monkeypatch, _FakeTier(err))
    ts = miner.make_tiered_search("cuda", "cuda:0", wedge_seconds=30, workload="preimage")
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            ts.submit("strict", 0, 500).result(timeout=30)
        assert ts.active_tier == "cuda" and ts.downgrades == 0
    finally:
        ts.close()
    assert "downgrading" not in capfd.readouterr().err


def test_watchdog_cuda_without_card_is_a_configuration_error():
    with pytest.raises(ValueError, match="CUDA device"):
        miner.make_tiered_search("cuda", "cpu", workload="blake2b64")


def test_throttle_paces_each_submit():
    """--throttle-nps: a chunk of n nonces waits n / rate seconds before
    it reaches the search."""
    import time

    paced = miner._PacedSearch(miner._PoolSearch(workloads.get("sha256d").min_range), 2000.0)
    try:
        t0 = time.monotonic()
        got = paced.submit("pace", 0, 499).result(timeout=30)
        assert time.monotonic() - t0 >= 0.25
        assert got == min_hash_range("pace", 0, 499)
    finally:
        paced.close()


def test_miner_log_prints_submit_and_done(capfd):
    """BMT_MINER_LOG: one stderr line at each chunk's submit and one at its
    completion, with the range."""
    logged = miner._LoggedSearch(miner._PoolSearch(min_hash_range))
    try:
        assert logged.submit("log", 10, 40).result(timeout=30) == min_hash_range("log", 10, 40)
    finally:
        logged.close()
    lines = capfd.readouterr().err.splitlines()
    assert [ln.split()[1:3] for ln in lines] == [["submit", "[10,40]"], ["done", "[10,40]"]]
    assert lines[0].endswith("size=3.100e+01") and " dt=" in lines[1]


@pytest.mark.parametrize("argv", [
    ["--workload", "nope", "--backend", "torch", "--device", "cpu"],
    ["--backend", "pallas", "--device", "cpu"],
    ["--backend", "xla", "--workload", "blake2b64"],
    ["--backend", "auto", "--workload", "preimage", "--watchdog", "5"],
    ["--backend", "cuda", "--device", "cpu", "--watchdog", "5"],
    ["--backend", "cpu", "--devices", "2"],
    ["--backend", "torch", "--device", "cpu", "--devices", "0"],
    ["--backend", "torch", "--device", "cuda:1", "--devices", "2"],
    ["--multihost", "--coordinator", "127.0.0.1:9", "--num-hosts", "2", "--host-id", "0",
     "--workload", "blake2b64", "--backend", "torch", "--device", "cpu"],
    ["--multihost", "--coordinator", "127.0.0.1:9", "--num-hosts", "2", "--host-id", "0",
     "--backend", "cpu"],
])
def test_invalid_miner_configuration(argv):
    if "auto" in argv and torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: auto resolves to cuda")
    out = io.StringIO()
    with redirect_stdout(out):
        assert miner.main(["miner", "127.0.0.1:9", *argv]) == 0
    assert out.getvalue().startswith("Invalid miner configuration:")


def test_drain_answers_received_chunks_then_exits():
    """A set drain event: run_miner writes the Results of the chunks it
    already received and returns without reading more."""
    server = lsp.Server(0, PARAMS)
    drain = threading.Event()
    search = miner.make_async_search("cpu")
    mc = lsp.Client("127.0.0.1", server.port, PARAMS)
    done = {}
    mt = threading.Thread(target=lambda: done.setdefault(
        "lost", miner.run_miner(mc, search, drain=drain)), daemon=True)
    mt.start()
    try:
        conn, _join = server.read()
        server.write(conn, PortMessage.request("drain", 0, 2000).marshal())
        _cid, payload = server.read()
        first = PortMessage.unmarshal(payload)
        assert (first.hash, first.nonce) == min_hash_range("drain", 0, 2000)
        drain.set()
        mt.join(timeout=10)
        assert not mt.is_alive() and done["lost"] is True
    finally:
        server.close()
        mc.close()


def test_usage_line_matches_reference(capsys):
    """The frozen usage line (reference ``bitcoin/miner/miner.go:18-24``),
    as tests/test_cli_contracts.py pins it for the JAX package's miner."""
    assert miner.main(["miner"]) == 0
    assert capsys.readouterr().out == "Usage: ./miner <hostport>"


def test_failed_join_is_reported_not_raised(capsys):
    assert miner.main(["miner", "nocolonhere", "--backend", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("Failed to join with server:")


def test_multihost_requires_topology_flags(capsys):
    for argv in (["--multihost"], ["--multihost", "--coordinator", "127.0.0.1:9"],
                 ["--multihost", "--num-hosts", "2", "--host-id", "0"]):
        assert miner.main(["miner", "127.0.0.1:9", *argv]) == 0
        assert capsys.readouterr().out == (
            "--multihost requires --coordinator, --num-hosts, --host-id\n")


def test_devices_on_a_host_tier_names_the_device_tiers(capsys):
    assert miner.main(["miner", "127.0.0.1:9", "--backend", "cpu", "--devices", "2"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Invalid miner configuration: --devices requires a device tier")
    with pytest.raises(ValueError, match="--devices requires a device tier"):
        miner.make_tiered_search("cpu", devices=3, workload="preimage")


def test_port_miner_with_devices_serves_reference_scheduler():
    """``--devices 3`` on the CPU rung (three CPU shards through
    ``SweepPipeline(devices=)``) against the JAX package's scheduler."""
    server = ref_lsp.Server(0, REF_PARAMS)
    st = threading.Thread(
        target=ref_server.serve, args=(server, Scheduler(min_chunk=50)), daemon=True
    )
    st.start()
    search = miner.make_async_search("torch", device="cpu", host_lane_budget=0, devices=3)
    assert len(search._p._devices) == 3
    mc = lsp.Client("127.0.0.1", server.port, PARAMS)
    mt = threading.Thread(target=miner.run_miner, args=(mc, search), daemon=True)
    mt.start()
    try:
        c = ref_lsp.Client("127.0.0.1", server.port, REF_PARAMS)
        try:
            res = ref_client.request_once(c, "shards", 100_049, lower=99_950, timeout=60)
        finally:
            c.close()
        assert res == min_hash_range("shards", 99_950, 100_049)
    finally:
        server.close()
        mt.join(timeout=30)
        mc.close()
    assert not mt.is_alive()
