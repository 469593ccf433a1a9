"""The port's fleet metrics plane over the wire, against the JAX package's.

- **Loopback.** Each package's ``TelemetryExporter`` ships a seeded
  registry to each package's ``TelemetryHub`` over LSP (port → ref, ref →
  port, port → port, beside ref → ref): the hubs' merged states, their
  fleet-log lines rendered by the reference's ``tools/dash.py`` and their
  Prometheus text are equal to the reference pair's.  A dashboard
  subscriber gets the port hub's merged state.
- **Per-dispatch hooks.** The port's ``SweepPipeline`` (torch rung, CPU)
  and the reference's (XLA) on the same jobs, batch and max_k give equal
  ``hist.device_dispatch_s`` counts and equal ``kernel dispatch_done``
  sequences (rows, lanes, donated; not dt), per chunk and hot, on one
  device and on shards.
- **Miner.** The port's and the reference's miner serve the same job from
  the port's scheduler: equal ``miner.nonces`` and ``hist.miner_chunk_s``
  counts; a forced watchdog downgrade gives equal ``miner.tier_downgrades``
  and equal ``wedge_detected`` / ``tier_downgrade`` events; ``--telemetry``
  refuses a bad value as the reference does.
- **LSP.** An echo exchange counts ``lsp.delivered`` as the reference does
  and samples ``hist.lsp_rtt_s``; a raw UDP peer that withholds an ack
  makes ``lsp.retransmits`` and the ``retransmit`` event appear, and that
  seq's late ack gives no RTT sample (Karn), while a clean one does.

In-process, loopback UDP, small LSP epochs and short export intervals.
"""

import io
import json
import socket
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from bitcoin_miner_tpu import lsp as ref_lsp
from bitcoin_miner_tpu import lspnet as ref_lspnet
from bitcoin_miner_tpu.apps import miner as ref_miner
from bitcoin_miner_tpu.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu.ops import sweep as ref_sweep
from bitcoin_miner_tpu.parallel import sweep as ref_psweep
from bitcoin_miner_tpu.utils import metrics as ref_metrics
from bitcoin_miner_tpu.utils import slo as ref_slo
from bitcoin_miner_tpu.utils import telemetry as ref_telemetry
from bitcoin_miner_tpu.utils import trace as ref_trace
from bitcoin_miner_tpu_torch import lsp
from bitcoin_miner_tpu_torch.apps import Scheduler, client, miner, server
from bitcoin_miner_tpu_torch.lsp.message import Message as LspMessage
from bitcoin_miner_tpu_torch.lsp.message import MsgType as LspMsgType
from bitcoin_miner_tpu_torch.ops import sweep
from bitcoin_miner_tpu_torch.utils import metrics, slo, telemetry, trace
from tools.dash import render_frame

PARAMS = lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)
REF_PARAMS = ref_lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)
PKGS = {"port": (lsp, metrics, slo, telemetry, trace, PARAMS),
        "ref": (ref_lsp, ref_metrics, ref_slo, ref_telemetry, ref_trace, REF_PARAMS)}


@pytest.fixture(autouse=True)
def _clean_network():
    ref_lspnet.reset_faults()
    yield
    ref_lspnet.reset_faults()


@pytest.fixture
def traced():
    """Both packages' tracers armed (fresh buffers), disarmed after."""
    for t in (trace, ref_trace):
        t.TRACE.enable(capacity=100_000)
    yield
    for t in (trace, ref_trace):
        t.TRACE.disable()


def _events(pkg_trace, span, event):
    return [r.get("attrs") or {} for r in pkg_trace.TRACE.drain()
            if (r["span"], r["event"]) == (span, event)]


def _count(pkg_metrics, name) -> int:
    h = pkg_metrics.METRICS.histogram(name)
    return 0 if h is None else h.count()


def _until(cond, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not met in time")
        time.sleep(0.02)


# --------------------------------------------------------------------------
# Loopback: exporter -> hub across the packages
# --------------------------------------------------------------------------


def _seeded_registry(pkg_metrics, seed: int):
    rng = np.random.default_rng(seed)
    reg = pkg_metrics.Metrics()
    for _ in range(200):
        r = rng.random()
        if r < 0.3:
            reg.inc(str(rng.choice(["miner.nonces", "lsp.delivered", "telemetry.exports"])),
                    int(rng.integers(1, 10**6)))
        elif r < 0.4:
            reg.set_gauge("kernel.thresh_staleness", float(rng.integers(1, 33)))
        else:
            reg.observe(str(rng.choice(["hist.miner_chunk_s", "hist.device_dispatch_s",
                                        "hist.lsp_rtt_s"])), float(10 ** rng.uniform(-4, 0)))
    return reg


def _loopback(exp_pkg, hub_pkg, tmp_path):
    """One exporter of ``exp_pkg`` shipping a seeded registry to a hub of
    ``hub_pkg``; returns (the hub's tick state, its fleet-log line, its
    Prometheus text)."""
    e_lsp, e_metrics, _s, e_tel, _t, e_params = PKGS[exp_pkg]
    _l, _m, h_slo, h_tel, _t2, h_params = PKGS[hub_pkg]
    now = 5000.0
    log, prom = tmp_path / f"{exp_pkg}-{hub_pkg}.jsonl", tmp_path / f"{exp_pkg}-{hub_pkg}.prom"
    hub = h_tel.TelemetryHub(
        0, params=h_params, source=None, clock=lambda: now, publish_interval=0.0,
        slo=h_slo.SloEngine(h_slo.default_slos(), clock=lambda: now),
        fleet_log=str(log), prom_path=str(prom)).start()
    reg = _seeded_registry(e_metrics, 11)
    want = reg.export_state()
    exp = e_tel.TelemetryExporter("127.0.0.1", hub.port, "m1", interval=0.05,
                                  params=e_params, registry=reg).start()
    try:
        def landed():
            got = hub.fleet.export_sources().get("m1")
            return got is not None and all(got[k] == want[k] for k in want)

        _until(landed)
        state = hub.tick(now=now)
    finally:
        exp.stop()
        hub.close()
    state["per_source"]["m1"]["seq"] = 1  # the beat count is the only free field
    (line,) = log.read_text().splitlines()
    return state, json.loads(line), prom.read_text()


def test_exporter_to_hub_across_packages_matches_reference_pair(tmp_path):
    base_state, base_line, base_prom = _loopback("ref", "ref", tmp_path)
    assert base_state["counters"]["miner.nonces"] > 0
    for exp_pkg, hub_pkg in (("port", "ref"), ("ref", "port"), ("port", "port")):
        state, line, prom = _loopback(exp_pkg, hub_pkg, tmp_path)
        assert state == base_state, (exp_pkg, hub_pkg)
        assert prom == base_prom, (exp_pkg, hub_pkg)
        assert render_frame(line) == render_frame(base_line), (exp_pkg, hub_pkg)


def test_subscriber_gets_the_port_hubs_merged_state():
    """The ``tools.dash --connect`` path: one subscribe payload, then
    merged states as frames, read here with the reference's assembler."""
    hub = telemetry.TelemetryHub(0, params=PARAMS, publish_interval=0.0,
                                 registry=_seeded_registry(metrics, 3)).start(self_tick=0.05)
    c = ref_lsp.Client("127.0.0.1", hub.port, REF_PARAMS)
    try:
        c.write(ref_telemetry.encode_subscribe())
        asm, got = ref_telemetry.FrameAssembler(), None
        deadline = time.monotonic() + 15
        while got is None and time.monotonic() < deadline:
            done, obj = asm.feed(c.read(timeout=5))
            if done and isinstance(obj, dict):
                got = obj
        assert got is not None and got["per_source"]["server"]["stale"] is False
        assert got["counters"] == _seeded_registry(metrics, 3).export_state()["counters"]
    finally:
        c.close()
        hub.close()


# --------------------------------------------------------------------------
# Per-dispatch hooks of the sweep pipeline
# --------------------------------------------------------------------------

JOBS = [("cmu440", 1000, 2234), ("cmu440", 2235, 3499)]


def _pipeline_run(pkg, mesh: bool, hot: bool):
    """Both jobs through one package's pipeline; returns the
    ``hist.device_dispatch_s`` count it added, its ``dispatch_done`` events
    as (rows, lanes, donated), their rings and the results."""
    kw = dict(max_k=2, batch=2, host_lane_budget=0, sieve=True, hot=hot)
    if pkg == "port":
        p = sweep.SweepPipeline(backend="torch", **kw, **(
            dict(devices=["cpu"] * 8) if mesh else dict(device="cpu")))
        mod_metrics, mod_trace = metrics, trace
    else:
        p = ref_sweep.SweepPipeline(backend="xla", **kw, **(
            dict(mesh=ref_psweep.default_mesh(8)) if mesh else {}))
        mod_metrics, mod_trace = ref_metrics, ref_trace
    n0 = _count(mod_metrics, "hist.device_dispatch_s")
    mod_trace.TRACE.drain()
    try:
        got = [p.submit(*job).result(timeout=300) for job in JOBS]
    finally:
        p.close()
    events = _events(mod_trace, "kernel", "dispatch_done")
    return (_count(mod_metrics, "hist.device_dispatch_s") - n0,
            [(e["rows"], e["lanes"], e["donated"]) for e in events],
            [e["ring"] for e in events], [(r.hash, r.nonce, r.lanes_swept) for r in got])


@pytest.mark.parametrize("hot", [False, True], ids=["per-chunk", "hot"])
@pytest.mark.parametrize("mesh", [False, True], ids=["one-device", "shards"])
def test_dispatch_hooks_match_reference_pipeline(mesh, hot, traced):
    n, events, rings, got = _pipeline_run("port", mesh, hot)
    ref_n, ref_events, ref_rings, ref_got = _pipeline_run("ref", mesh, hot)
    assert got == ref_got and [g[:2] for g in got] == [min_hash_range(*j) for j in JOBS]
    assert n == ref_n == len(events) > 0
    assert events == ref_events
    assert all(e[2] is hot for e in events)
    if hot:
        assert all(r >= 0 for r in rings)
    else:
        assert rings == ref_rings == [0] * n


def test_per_chunk_pipeline_reports_threshold_staleness():
    """The sieve's operand-shipped threshold: its lag is the fetch queue's
    depth plus one, at least 1."""
    metrics.METRICS.set_gauge("kernel.thresh_staleness", 0.0)
    p = sweep.SweepPipeline(backend="torch", device="cpu", max_k=2, batch=2,
                            host_lane_budget=0, sieve=True)
    try:
        p.submit(*JOBS[0]).result(timeout=60)
    finally:
        p.close()
    assert metrics.METRICS.gauge("kernel.thresh_staleness") >= 1.0


# --------------------------------------------------------------------------
# The miner
# --------------------------------------------------------------------------

MINER_JOB = ("cmu440", 9_999)


def _serve_one_job(make_client, run_miner):
    """The port's scheduler (10 static chunks of 1000 nonces) serves
    MINER_JOB to one miner; returns the Result."""
    srv = lsp.Server(0, PARAMS)
    sched = Scheduler(min_chunk=1000, max_chunk=1000, adaptive_chunks=False,
                      steal_factor=0.0)
    st = threading.Thread(target=server.serve, args=(srv, sched),
                          kwargs=dict(tick_interval=0.1), daemon=True)
    st.start()
    mc = make_client(srv.port)
    mt = threading.Thread(target=run_miner, args=(mc, min_hash_range), daemon=True)
    mt.start()
    try:
        c = lsp.Client("127.0.0.1", srv.port, PARAMS)
        try:
            return client.request_once(c, MINER_JOB[0], MINER_JOB[1], timeout=60)
        finally:
            c.close()
    finally:
        srv.close()
        st.join(timeout=10)
        mt.join(timeout=10)
        mc.close()


def test_miner_counts_match_reference_miner():
    counts = {}
    for name, pkg_miner, pkg_lsp, params in (("port", miner, lsp, PARAMS),
                                             ("ref", ref_miner, ref_lsp, REF_PARAMS)):
        m = PKGS[name][1].METRICS
        n0, c0 = m.get("miner.nonces"), _count(PKGS[name][1], "hist.miner_chunk_s")
        res = _serve_one_job(lambda port: pkg_lsp.Client("127.0.0.1", port, params),
                             pkg_miner.run_miner)
        assert res == min_hash_range(MINER_JOB[0], 0, MINER_JOB[1])
        # The chunk histogram is fed by a done-callback that may run just
        # after the Result is written.
        _until(lambda: _count(PKGS[name][1], "hist.miner_chunk_s") - c0 >= 10, 5)
        counts[name] = (m.get("miner.nonces") - n0,
                        _count(PKGS[name][1], "hist.miner_chunk_s") - c0)
    assert counts["port"] == counts["ref"] == (MINER_JOB[1] + 1, 10)


class _Wedged:
    """A tier whose chunks never complete."""

    def submit(self, data, lower, upper):
        from concurrent.futures import Future

        return Future()

    def close(self):
        pass


def test_watchdog_downgrade_counts_and_events_match_reference(traced):
    got = {}
    for name, pkg_miner in (("port", miner), ("ref", ref_miner)):
        m, t = PKGS[name][1].METRICS, PKGS[name][4]
        d0 = m.get("miner.tier_downgrades")
        t.TRACE.drain()
        ts = pkg_miner._TieredSearch([("cpu", _Wedged), ("hashlib", lambda: min_hash_range)],
                                     wedge_seconds=0.2)
        try:
            res = ts.submit("cmu440", 100, 500).result(timeout=30)
        finally:
            ts.close()
        assert res == min_hash_range("cmu440", 100, 500)
        rows = t.TRACE.drain()
        got[name] = (m.get("miner.tier_downgrades") - d0,
                     [(r["event"], r.get("attrs")) for r in rows if r["span"] == "miner"])
    assert got["port"] == got["ref"]
    assert got["port"][0] == 1
    assert [e for e, _a in got["port"][1]] == ["wedge_detected", "tier_downgrade"]


@pytest.mark.parametrize("bad", [["--telemetry", "127.0.0.1:x"], ["--telemetry", "nohostport"],
                                 ["--telemetry", "127.0.0.1:"],
                                 ["--telemetry", "127.0.0.1:1", "--telemetry-interval", "0"]],
                         ids=["port-not-a-number", "no-colon", "empty-port", "zero-interval"])
def test_bad_telemetry_value_is_a_configuration_error(bad):
    outs = []
    for pkg_miner in (ref_miner, miner):
        with redirect_stdout(io.StringIO()) as out:
            assert pkg_miner.main(["miner", "127.0.0.1:1", "--backend", "cpu", *bad]) == 0
        outs.append(out.getvalue())
    assert outs[1] == outs[0]
    assert outs[1].startswith("Invalid miner configuration: ")


# --------------------------------------------------------------------------
# LSP transport hooks
# --------------------------------------------------------------------------


def test_echo_counts_delivered_as_the_reference_and_samples_rtt():
    deltas = {}
    for name in ("port", "ref"):
        pkg_lsp, pkg_metrics, params = PKGS[name][0], PKGS[name][1], PKGS[name][5]
        m = pkg_metrics.METRICS
        d0, r0 = m.get("lsp.delivered"), _count(pkg_metrics, "hist.lsp_rtt_s")
        srv = pkg_lsp.Server(0, params)

        def echo(srv=srv, pkg_lsp=pkg_lsp):
            while True:
                try:
                    cid, payload = srv.read()
                except pkg_lsp.LspError:
                    return
                srv.write(cid, payload)

        t = threading.Thread(target=echo, daemon=True)
        t.start()
        c = pkg_lsp.Client("127.0.0.1", srv.port, params)
        try:
            for i in range(20):
                c.write(f"echo {i}".encode())
            assert [c.read(timeout=10) for _ in range(20)] == [f"echo {i}".encode()
                                                               for i in range(20)]
        finally:
            c.close()
            srv.close()
            t.join(timeout=10)
        deltas[name] = (m.get("lsp.delivered") - d0, _count(pkg_metrics, "hist.lsp_rtt_s") - r0)
    assert deltas["port"][0] == deltas["ref"][0] == 40
    assert deltas["port"][1] > 0 and deltas["ref"][1] > 0


def test_withheld_ack_retransmits_and_karn_drops_its_rtt_sample(traced):
    """A raw UDP peer: accepts the handshake, keeps the conn alive with
    seq-0 acks, withholds the ack of data seq 1 for several epochs, then
    acks it; acks seq 2 at once."""
    raw = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    raw.bind(("127.0.0.1", 0))
    raw.settimeout(0.05)
    conn_id, state = 7, {"peer": None, "ack1": False, "seen": []}
    stop = threading.Event()

    def peer():
        while not stop.is_set():
            try:
                data, addr = raw.recvfrom(2048)
            except socket.timeout:
                data = None
            if data is not None:
                msg = LspMessage.unmarshal(data)
                if msg is not None and msg.type == LspMsgType.CONNECT:
                    state["peer"] = addr
                    raw.sendto(LspMessage.ack(conn_id, 0).marshal(), addr)
                elif msg is not None and msg.type == LspMsgType.DATA:
                    state["seen"].append(msg.seq_num)
                    if msg.seq_num == 2 or (msg.seq_num == 1 and state["ack1"]):
                        raw.sendto(LspMessage.ack(conn_id, msg.seq_num).marshal(), addr)
            if state["peer"] is not None:
                raw.sendto(LspMessage.ack(conn_id, 0).marshal(), state["peer"])

    t = threading.Thread(target=peer, daemon=True)
    t.start()
    m = metrics.METRICS
    retx0 = m.get("lsp.retransmits")
    c = lsp.Client("127.0.0.1", raw.getsockname()[1], PARAMS)
    try:
        c.write(b"first")
        _until(lambda: state["seen"].count(1) >= 3, 5)  # sent, then resent twice
        assert m.get("lsp.retransmits") - retx0 >= 2
        rtt0 = _count(metrics, "hist.lsp_rtt_s")
        state["ack1"] = True
        _until(lambda: c._c._conn.outstanding() == 0, 5)
        assert _count(metrics, "hist.lsp_rtt_s") == rtt0, "Karn: no sample for a resent seq"
        c.write(b"second")
        _until(lambda: _count(metrics, "hist.lsp_rtt_s") == rtt0 + 1, 5)
    finally:
        c.close()  # nothing outstanding: returns at once
        stop.set()
        t.join(timeout=5)
        raw.close()
    retx = _events(trace, "lsp", "retransmit")
    assert retx and all(e["conn"] == conn_id and e["seq"] == 1 for e in retx)
