"""The port's server (both shells) and client, held to the JAX package's.

- Over the wire, in-process on loopback with small LSP epochs: the port
  server with the port client and port CPU miners; with the reference's
  miner and client; the reference server with the port's client; a
  non-default workload.  Each on the blocking ``serve`` shell and on
  ``AsyncIngress``, every Result equal to the oracle.
- Checkpoints across packages: a state file one package's server writes is
  staged by the other's ``main``, in both directions; a file of another
  workload stages nothing, in both; a resubmitted job resumes from it.
- The CLI contracts: each package's ``server.main`` and ``client.main``
  print the same stdout for the same argv (the chaos layer's switch,
  ``BMT_CHAOS_SCENARIO``, is held in ``test_torch_chaos.py``), every
  spelling of the fleet metrics plane's flags arms a hub with the sink it
  names (a bad ``--slo=`` value or a busy telemetry port stops ``main``
  with one line before the serving port binds), every spelling of the
  gateway's and the autoscaler's flags arms a ``Gateway`` or the
  controller in both shells, and a bad number or autoscale spec stops
  ``main`` before it binds.
- The three CLIs as processes: a job runs from the port client through the
  port server to a port miner with no module of JAX or of the JAX package
  loaded in any of them.
"""

import io
import os
import re
import signal
import socket
import subprocess
import sys
import threading
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from bitcoin_miner_tpu import lsp as ref_lsp
from bitcoin_miner_tpu import lspnet as ref_lspnet
from bitcoin_miner_tpu import workloads as ref_workloads
from bitcoin_miner_tpu.apps import client as ref_client
from bitcoin_miner_tpu.apps import miner as ref_miner
from bitcoin_miner_tpu.apps import server as ref_server
from bitcoin_miner_tpu.apps.scheduler import Scheduler as RefScheduler
from bitcoin_miner_tpu_torch import lsp, workloads
from bitcoin_miner_tpu_torch.apps import Scheduler, client, miner, server
from bitcoin_miner_tpu_torch.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu_torch.utils import METRICS

ROOT = Path(__file__).resolve().parent.parent
PARAMS = lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)
REF_PARAMS = ref_lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)
# (package name) -> (lsp, server module, client module, miner module, Scheduler,
# workloads, LSP params)
PKG = {
    "port": (lsp, server, client, miner, Scheduler, workloads, PARAMS),
    "ref": (ref_lsp, ref_server, ref_client, ref_miner, RefScheduler, ref_workloads,
            REF_PARAMS),
}
JOB = ("cmu440", 9_999)


@pytest.fixture(autouse=True)
def _clean_network():
    ref_lspnet.reset_faults()
    yield
    ref_lspnet.reset_faults()


def _start_server(pkg, shell, sched):
    """``pkg``'s server on an ephemeral port, on the ``shell`` shell;
    returns (port, stop)."""
    lsp_mod, srv, _c, _m, _S, _w, params = PKG[pkg]
    if shell == "async":
        ing = srv.AsyncIngress(0, scheduler=sched, params=params, tick_interval=0.1).start()
        return ing.port, ing.close
    s = lsp_mod.Server(0, params)
    t = threading.Thread(target=srv.serve, args=(s, sched),
                         kwargs=dict(tick_interval=0.1), daemon=True)
    t.start()

    def stop():
        s.close()
        t.join(timeout=10)
        assert not t.is_alive()

    return s.port, stop


def _start_miner(pkg, port, workload=None):
    lsp_mod, _s, _c, m, _S, wl_mod, params = PKG[pkg]
    wl = wl_mod.get(workload) if workload else None
    search = m.make_async_search("cpu", workload=wl)
    mc = lsp_mod.Client("127.0.0.1", port, params)
    t = threading.Thread(target=m.run_miner, args=(mc, search), daemon=True)
    t.start()

    def stop():
        t.join(timeout=10)
        mc.close()
        assert not t.is_alive()

    return stop


def _request(pkg, port, data, max_nonce):
    lsp_mod, _s, c, _m, _S, _w, params = PKG[pkg]
    conn = lsp_mod.Client("127.0.0.1", port, params)
    try:
        return c.request_once(conn, data, max_nonce, timeout=60)
    finally:
        conn.close()


# (server, miners, client, workload)
WIRE = {
    "port_only": ("port", ("port", "port"), "port", None),
    "port_server_ref_miner_client": ("port", ("ref",), "ref", None),
    "ref_server_port_client": ("ref", ("ref",), "port", None),
    "port_only_preimage": ("port", ("port",), "port", "preimage"),
}


@pytest.mark.parametrize("shell", ["serve", "async"])
@pytest.mark.parametrize("case", list(WIRE))
def test_wire_result_is_exact(case, shell):
    srv_pkg, miner_pkgs, client_pkg, wl = WIRE[case]
    _l, _s, _c, _m, sched_cls, wl_mod, _p = PKG[srv_pkg]
    sched = sched_cls(min_chunk=2_000, workload=wl_mod.get(wl) if wl else None)
    port, stop_server = _start_server(srv_pkg, shell, sched)
    stops = []
    try:
        stops = [_start_miner(p, port, wl) for p in miner_pkgs]
        got = _request(client_pkg, port, *JOB)
    finally:
        stop_server()
        for stop in stops:
            stop()
    want = (workloads.get(wl).min_range(JOB[0], 0, JOB[1]) if wl
            else min_hash_range(JOB[0], 0, JOB[1]))
    assert got == want


# ----------------------------------------------------------------- checkpoints


def _progress_state(sched_cls, wl_mod, workload):
    """A scheduler's checkpoint after one miner answered part of a job."""
    wl = wl_mod.get(workload) if workload else None
    s = sched_cls(min_chunk=1_000, workload=wl)
    s.miner_joined(1)
    s.client_request(2, JOB[0], 0, JOB[1])
    oracle = wl.min_range if wl else min_hash_range
    s.result(1, *oracle(JOB[0], 0, 999))
    return s.checkpoint()


def _main_stages(pkg, argv, monkeypatch):
    """Run ``pkg``'s server ``main`` with ``argv`` up to the serve loop;
    returns the scheduler it built (its checkpoint shows what it staged)."""
    srv = PKG[pkg][1]
    got = {}

    def capture(s, scheduler=None, **_kw):
        got["sched"] = scheduler
        s.close()

    monkeypatch.setattr(srv, "serve", capture)
    with redirect_stdout(io.StringIO()) as out:
        assert srv.main(["server", "0", *argv]) == 0
    assert out.getvalue() == "Server listening on port 0\n"
    return got["sched"]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("workload", [None, "blake2b64"])
def test_checkpoint_file_resumes_across_packages(writer, reader, workload, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    _l, w_srv, _c, _m, w_sched, w_wl, _p = PKG[writer]
    state = _progress_state(w_sched, w_wl, workload)
    assert (state.get("state") or state)["jobs"]
    path = tmp_path / "ckpt.json"
    w_srv.save_checkpoint(str(path), state)
    flag = [f"--workload={workload}"] if workload else []
    sched = _main_stages(reader, [f"--checkpoint={path}", *flag], monkeypatch)
    assert sched.checkpoint() == state
    # A server of the other workload stages nothing from the same file.
    other = [] if workload else ["--workload=blake2b64"]
    sched = _main_stages(reader, [f"--checkpoint={path}", *other], monkeypatch)
    payload = sched.checkpoint()
    assert (payload.get("state") or payload)["jobs"] == []


def test_resubmitted_job_resumes_from_reference_checkpoint(tmp_path):
    state = _progress_state(RefScheduler, ref_workloads, None)
    path = tmp_path / "ckpt.json"
    ref_server.save_checkpoint(str(path), state)
    sched = Scheduler(min_chunk=1_000, resume_state=server.load_checkpoint(str(path)))
    resumed0 = METRICS.get("sched.jobs_resumed")
    swept0 = METRICS.get("sched.nonces_swept")
    port, stop_server = _start_server("port", "serve", sched)
    stop_miner = None
    try:
        stop_miner = _start_miner("port", port)
        got = _request("port", port, *JOB)
    finally:
        stop_server()
        if stop_miner:
            stop_miner()
    assert got == min_hash_range(JOB[0], 0, JOB[1])
    assert METRICS.get("sched.jobs_resumed") == resumed0 + 1
    assert METRICS.get("sched.nonces_swept") - swept0 == JOB[1] + 1 - 1_000


# --------------------------------------------------------------- CLI contracts

SERVER_ARGV = [
    ["server"],
    ["server", "1", "2"],
    ["server", "abc"],
    ["server", "0", "--workload=nope"],
    ["server", "0", "--static-chunks=x"],
    ["server", "0", "--chunk-target-s=fast", "--async-ingress"],
    ["server", "0", "--prefill=x"],
    ["server", "0", "--gateway", "--rate=x"],
    ["server", "0", "--max-queued=1.5", "--async-ingress"],
    ["server", "0", "--autoscale=nope"],
    ["server", "0", "--autoscale=min=2,max=1", "--async-ingress"],
]
CLIENT_ARGV = [
    ["client"],
    ["client", "127.0.0.1:1", "msg"],
    ["client", "127.0.0.1:1", "msg", "abc"],
    ["client", "127.0.0.1:1", "msg", "-1"],
    ["client", "127.0.0.1:1", "msg", str(2**64)],
    ["client", "127.0.0.1:x", "msg", "5"],
    ["client", "--retries=z", "127.0.0.1:1", "msg", "5"],
]


@pytest.mark.parametrize("argv", SERVER_ARGV, ids=" ".join)
def test_server_cli_matches_reference(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    outs = []
    for srv in (ref_server, server):
        with redirect_stdout(io.StringIO()) as out:
            assert srv.main(list(argv)) == 0
        outs.append(out.getvalue())
    assert outs[1] == outs[0]
    assert outs[1]


@pytest.mark.parametrize("argv", CLIENT_ARGV, ids=" ".join)
def test_client_cli_matches_reference(argv):
    outs = []
    for c in (ref_client, client):
        out = io.StringIO()
        assert c.main(list(argv), out=out) == 0
        outs.append(out.getvalue())
    assert outs[1] == outs[0]
    assert outs[1]


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# (spelling, what the hub must carry): "port" the telemetry port asked for,
# "log"/"prom" the sink's file name, "slo" the SLO names armed.
DEFAULT_SLOS = ["request-p95", "chunk-rtt-p95", "orphan-rate", "miner-liveness"]
HUB_SPELLINGS = [
    ("--telemetry-port=", "port"), ("--fleet-log=f.jsonl", "log"), ("--prom=p.txt", "prom"),
    ("--slo", "slo"), ("--slo=chunk_p95=3,burn=2", "slo"), ("BMT_TELEMETRY_PORT", "port"),
    ("BMT_FLEET_LOG=f.jsonl", "log"), ("BMT_PROM=p.txt", "prom"), ("BMT_SLO=1", "slo"),
]


def _apply_spelling(spelling, argv, monkeypatch, value=""):
    """Put ``spelling`` (a flag, or ``NAME[=value]`` for the environment)
    into ``argv`` or the environment; ``value`` completes a bare
    ``--telemetry-port=`` / ``BMT_TELEMETRY_PORT``."""
    if spelling.startswith("BMT_"):
        name, _, val = spelling.partition("=")
        monkeypatch.setenv(name, val or value)
    else:
        argv.append(spelling + (value if spelling.endswith("=") else ""))


@pytest.mark.parametrize("shell", [[], ["--async-ingress"]], ids=["serve", "async"])
@pytest.mark.parametrize("spelling,sink", HUB_SPELLINGS, ids=[s for s, _ in HUB_SPELLINGS])
def test_fleet_plane_flag_arms_hub(spelling, sink, shell, tmp_path, monkeypatch):
    """Every spelling arms one started hub, hands it to the shell's engine
    and closes it when ``main`` returns."""
    from bitcoin_miner_tpu_torch.utils.slo import SloEngine

    monkeypatch.chdir(tmp_path)
    handed = []

    def fake_serve(srv, **kw):
        handed.append(kw["telemetry"])

    class FakeIngress:
        def __init__(self, port, **kw):
            handed.append(kw["telemetry"])
            self.port, self._thread, self.error = port, None, None

        def start(self):
            return self

        def close(self):
            pass

    monkeypatch.setattr(server, "serve", fake_serve)
    monkeypatch.setattr(server, "AsyncIngress", FakeIngress)
    tport = _free_udp_port()
    argv = ["server", "0", *shell]
    _apply_spelling(spelling, argv, monkeypatch, str(tport))
    with redirect_stdout(io.StringIO()) as out:
        assert server.main(argv) == 0
    assert "Traceback" not in out.getvalue()
    (hub,) = handed
    assert hub._stop.is_set(), "main returned with the hub still open"
    if sink == "port":
        assert hub.port == tport
    else:
        assert hub.port != 0  # an ephemeral listener all the same
    assert hub._fleet_log == ("f.jsonl" if sink == "log" else None)
    assert hub._prom_path == ("p.txt" if sink == "prom" else None)
    if sink == "slo":
        assert isinstance(hub._slo, SloEngine)
        assert [s.name for s in hub._slo.specs] == DEFAULT_SLOS
    else:
        assert hub._slo is None


# (spelling, the one line main prints): a bad --slo= value (the reference's
# message), a busy telemetry port.
BUSY = "busy"
HUB_REFUSALS = [("--slo=x", "--slo entry 'x' is not key=value"),
                ("BMT_SLO=x", "--slo entry 'x' is not key=value"),
                ("--slo=burn=fast", "bad --slo entry 'burn=fast': could not convert string "
                                    "to float: 'fast'"),
                ("--telemetry-port=", BUSY), ("BMT_TELEMETRY_PORT", BUSY)]


@pytest.mark.parametrize("shell", [[], ["--async-ingress"]], ids=["serve", "async"])
@pytest.mark.parametrize("spelling,line", HUB_REFUSALS, ids=[s for s, _ in HUB_REFUSALS])
def test_fleet_plane_flag_fails_before_binding(spelling, line, shell, tmp_path, monkeypatch):
    """A bad ``--slo=`` and a busy telemetry port print one line and
    return 0 before the serving port binds (the reference's friendly
    contract: no traceback)."""
    monkeypatch.chdir(tmp_path)
    real_server = lsp.Server

    def guarded(port, params=None, host="127.0.0.1", label=None):
        if label != "telemetry-hub":
            raise AssertionError("the server bound its serving port")
        return real_server(port, params, host, label=label)

    def bound(*_a, **_k):
        raise AssertionError("the server bound its serving port")

    squatter = lsp.Server(0, PARAMS)
    try:
        monkeypatch.setattr(server.lsp, "Server", guarded)
        monkeypatch.setattr(server, "AsyncIngress", bound)
        argv = ["server", "6060", *shell]
        _apply_spelling(spelling, argv, monkeypatch, str(squatter.port))
        with redirect_stdout(io.StringIO()) as out:
            assert server.main(argv) == 0
    finally:
        squatter.close()
    text = out.getvalue()
    assert text.count("\n") == 1 and text.endswith("\n"), text
    if line is BUSY:
        assert "Traceback" not in text and "Server listening" not in text
        assert "in use" in text, text
    else:
        assert text == line + "\n"


# ------------------------------------------------------- gateway and autoscale


class _Handed:
    """``serve`` / ``AsyncIngress`` stand-ins: each records the engine
    ``main`` hands its shell (the scheduler, the lock, the hub)."""

    def __init__(self, monkeypatch):
        self.kw = []
        handed = self.kw

        class FakeIngress:
            def __init__(self, port, **kw):
                handed.append({**kw, "port": 6061})
                self.port, self._thread, self.error = 6061, None, None

            def start(self):
                return self

            def close(self):
                pass

        monkeypatch.setattr(server, "serve",
                            lambda srv, **kw: handed.append({**kw, "port": srv.port}))
        monkeypatch.setattr(server, "AsyncIngress", FakeIngress)


def _main(argv, shell):
    with redirect_stdout(io.StringIO()) as out:
        assert server.main(["server", "0", *shell, *argv]) == 0
    assert "Traceback" not in out.getvalue()
    return out.getvalue()


# (spelling, the Gateway's knobs it sets): ("cache"/"spans", file name) or
# (attribute, value).
GATEWAY_SPELLINGS = [
    ("--gateway", None), ("--cache=c.json", ("cache", "c.json")),
    ("--spans=s.json", ("spans", "s.json")), ("--rate=2.5", ("rate", 2.5)),
    ("--rate=0", ("rate", None)), ("--burst=3", ("burst", 3.0)),
    ("--max-queued=9", ("max_queued", 9)), ("--prefill=100", ("prefill", 100)),
    ("BMT_PREFILL=100", ("prefill", 100)),
]


@pytest.mark.parametrize("shell", [[], ["--async-ingress"]], ids=["serve", "async"])
@pytest.mark.parametrize("spelling,knob", GATEWAY_SPELLINGS,
                         ids=[s for s, _ in GATEWAY_SPELLINGS])
def test_gateway_flag_arms_gateway(spelling, knob, shell, tmp_path, monkeypatch):
    """Every spelling hands the shell a ``Gateway`` over the port's
    scheduler with the reference's defaults and the knob it names."""
    from bitcoin_miner_tpu_torch.gateway import Gateway

    monkeypatch.chdir(tmp_path)
    handed = _Handed(monkeypatch)
    argv = []
    _apply_spelling(spelling, argv, monkeypatch)
    _main(argv, shell)
    (kw,) = handed.kw
    gw = kw["scheduler"]
    assert isinstance(gw, Gateway) and isinstance(gw.sched, Scheduler)
    assert kw["lock"] is None  # no autoscaler: the plane's own lock
    want = dict(rate=5.0, burst=10.0, max_queued=256, prefill=0, prefill_idle_s=1.0,
                cache=None, spans=None)
    if knob is not None:
        want[knob[0]] = knob[1]
    got = {k: getattr(gw, k) for k in want if k not in ("cache", "spans")}
    got.update(cache=gw.cache.path, spans=gw.spans.path)
    assert got == want
    assert gw.sched.record_spans and gw.cache.workload_name == "sha256d"


class _FakeWorkers:
    made = []

    def __init__(self, port, **kw):
        self.port, self.kw, self.stopped = port, kw, False
        _FakeWorkers.made.append(self)

    def live(self):
        return 0

    def stop_all(self):
        self.stopped = True


class _FakePump:
    made = []

    def __init__(self, controller, interval=1.0):
        self.controller, self.interval, self.stopped = controller, interval, False
        _FakePump.made.append(self)

    def start(self):
        return self

    def stop(self):
        self.stopped = True


# (spelling, extra argv, the AutoscaleConfig fields and driver it must carry)
AUTOSCALE_SPELLINGS = [
    ("--autoscale", [], dict(max_workers=4), dict(interval=1.0, backend="auto")),
    ("--autoscale=min=1,max=2,hold=2,interval=0.5", [], dict(max_workers=2, hold_ticks=2),
     dict(interval=0.5, backend="auto")),
    ("BMT_AUTOSCALE=1", [], dict(max_workers=4), dict(interval=1.0, backend="auto")),
    ("BMT_AUTOSCALE=max=3,backend=cpu", [], dict(max_workers=3),
     dict(interval=1.0, backend="cpu")),
    ("--autoscale=weights=gold:4", ["--gateway", "--slo"],
     dict(overload_weights={"gold": 4.0}), dict(interval=1.0, backend="auto")),
]


@pytest.mark.parametrize("shell", [[], ["--async-ingress"]], ids=["serve", "async"])
@pytest.mark.parametrize("spelling,extra,cfg,driver", AUTOSCALE_SPELLINGS,
                         ids=[s for s, *_ in AUTOSCALE_SPELLINGS])
def test_autoscale_flag_arms_controller(spelling, extra, cfg, driver, shell, tmp_path,
                                        monkeypatch):
    """Every spelling arms one controller against the live serving port,
    with the spec's policy, its pump beat and its workers' backend; the
    event lock it shares with the shell; weights only with the gateway
    on; its status on the hub; the pump stopped and the workers stopped
    when ``main`` returns."""
    from bitcoin_miner_tpu_torch import autoscale as port_autoscale

    monkeypatch.chdir(tmp_path)
    handed = _Handed(monkeypatch)
    _FakeWorkers.made, _FakePump.made = [], []
    monkeypatch.setattr(port_autoscale, "ProcessActuator", _FakeWorkers)
    monkeypatch.setattr(port_autoscale, "ControllerPump", _FakePump)
    argv = list(extra)
    _apply_spelling(spelling, argv, monkeypatch)
    _main(argv, shell)
    (kw,) = handed.kw
    (workers,), (pump,) = _FakeWorkers.made, _FakePump.made
    ctl = pump.controller
    assert isinstance(ctl, port_autoscale.AutoscaleController) and ctl._workers is workers
    assert workers.port == kw["port"] > 0  # the live serving port
    assert workers.kw == dict(backend=driver["backend"], telemetry=None)
    assert pump.interval == driver["interval"] and pump.stopped and workers.stopped
    assert {k: getattr(ctl.cfg, k) for k in cfg} == cfg
    assert kw["lock"] is not None
    if "--gateway" in extra:
        assert isinstance(ctl._weights, port_autoscale.GatewayWeightActuator)
        assert ctl._weights._lock is kw["lock"] and ctl._weights._gw is kw["scheduler"]
        hub = kw["telemetry"]
        assert hub._extras["autoscale"] == ctl.status
        assert ctl._burn() is None  # the hub has published no state yet
    else:
        assert ctl._weights is None and ctl._burn() is None


# (spelling, the one line main prints): the reference's messages.
GW_REFUSALS = [
    ("--rate=x", "--rate=x is not a number."),
    ("--burst=fast", "--burst=fast is not a number."),
    ("--max-queued=1.5", "--max-queued=1.5 is not a number."),
    ("--autoscale=bogus", "autoscale spec needs key=value pairs, got 'bogus'"),
    ("--autoscale=warp=9", "bad autoscale spec 'warp=9': unknown autoscale key 'warp'"),
    ("BMT_AUTOSCALE=min=3,max=1", "autoscale needs 0 <= min <= max, got min=3 max=1"),
]


@pytest.mark.parametrize("shell", [[], ["--async-ingress"]], ids=["serve", "async"])
@pytest.mark.parametrize("spelling,line", GW_REFUSALS, ids=[s for s, _ in GW_REFUSALS])
def test_gateway_or_autoscale_refusal_before_binding(spelling, line, shell, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)

    def bound(*_a, **_k):
        raise AssertionError("the server bound a port")

    monkeypatch.setattr(server.lsp, "Server", bound)
    monkeypatch.setattr(server, "AsyncIngress", bound)
    argv = []
    _apply_spelling(spelling, argv, monkeypatch)
    assert _main(argv, shell) == line + "\n"


# ------------------------------------------------------------- the three CLIs

# Runs a module as __main__ and reports, on exit or on SIGUSR1 (which also
# ends the process), every loaded module of JAX or of the JAX package.
WRAP = """
import atexit, os, runpy, signal, sys
def report(*_):
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "bitcoin_miner_tpu"))
    print("FORBIDDEN", bad, file=sys.stderr, flush=True)
def stop(*_):
    report()
    os._exit(0)
atexit.register(report)
signal.signal(signal.SIGUSR1, stop)
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def test_three_port_clis_run_a_job_without_jax(tmp_path):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)}

    def start(*args):
        return subprocess.Popen([sys.executable, "-c", WRAP, *args], cwd=tmp_path, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    srv = start("bitcoin_miner_tpu_torch.apps.server", str(port))
    procs = [srv]
    try:
        assert srv.stdout.readline() == f"Server listening on port {port}\n"
        mnr = start("bitcoin_miner_tpu_torch.apps.miner", f"127.0.0.1:{port}",
                    "--backend", "cpu", "--reconnect", "0")
        procs.append(mnr)
        cli = start("bitcoin_miner_tpu_torch.apps.client", f"127.0.0.1:{port}", *JOB[:1],
                    str(JOB[1]))
        procs.append(cli)
        out, cli_err = cli.communicate(timeout=60)
        mnr.send_signal(signal.SIGTERM)  # the miner drains and exits 0
        _o, mnr_err = mnr.communicate(timeout=30)
        srv.send_signal(signal.SIGUSR1)
        _o, srv_err = srv.communicate(timeout=30)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    h, n = min_hash_range(JOB[0], 0, JOB[1])
    assert out == f"Result {h} {n}\n"
    assert (cli.returncode, mnr.returncode, srv.returncode) == (0, 0, 0)
    for err in (cli_err, mnr_err, srv_err):
        assert "FORBIDDEN []" in err, err
    assert (tmp_path / "log.txt").exists()
    # The miner's stderr ends with its lifetime line (then the wrapper's
    # exit report): one chunk of JOB[1] + 1 nonces.
    *_rest, lifetime, _report = mnr_err.splitlines()
    assert re.fullmatch(rf"miner: {JOB[1] + 1} nonces swept \([\d,]+/s lifetime\)",
                        lifetime), mnr_err
