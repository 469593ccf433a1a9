"""The port's autoscaler, held to the JAX package's.

- ``parse_autoscale_config`` over a table of specs and of bad specs: the
  same config and the same error text as the reference.  The one
  deliberate difference: the driver's ``backend`` defaults to ``"auto"``
  (the port miner's own default, the cuda rung on the card), where the
  reference's defaults to ``"cpu"``.
- ``AutoscaleController`` driven by seeded burn / utilization sequences
  and one hand-cranked clock, with recording fake actuators that now and
  then fail: every tick's decision record, ``status()``, the actuators'
  calls, the ``autoscale.*`` counters and gauge and the ``autoscale``
  trace events equal the reference's.
- ``GatewayWeightActuator`` on the port's ``Gateway`` under a lock,
  ``ControllerPump`` start / stop, ``CellActuator``.
- ``ProcessActuator``: the argv it spawns names the port's miner (a fake
  ``Popen``); one real worker with ``--backend cpu`` against a live port
  server sweeps a job, then drains with exit code 0.
- The port miner's ``BMT_MINER_THROTTLE_NPS``, the env spelling of
  ``--throttle-nps`` that the spawned workers inherit.
"""

import dataclasses
import io
import signal
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from bitcoin_miner_tpu import autoscale as ref_autoscale
from bitcoin_miner_tpu.utils.metrics import METRICS as REF_METRICS
from bitcoin_miner_tpu.utils.trace import TRACE as REF_TRACE
from bitcoin_miner_tpu_torch import autoscale, gateway, lsp
from bitcoin_miner_tpu_torch.apps import Scheduler, client, miner, server
from bitcoin_miner_tpu_torch.autoscale import actuator
from bitcoin_miner_tpu_torch.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu_torch.utils.metrics import METRICS
from bitcoin_miner_tpu_torch.utils.trace import TRACE

PKG = {"ref": (ref_autoscale, REF_METRICS, REF_TRACE), "port": (autoscale, METRICS, TRACE)}

# ---------------------------------------------------------------- the spec

SPECS = [
    "", "1", " 1 ", "max=2", "min=0,max=0", " hold=5 , min=2,max=9,", "backend=cpu",
    "backend=cuda,interval=0.25", "weights=gold:4", "weights=gold:4;free:0.25, util_low=0.1",
    "min=1,max=3,step=2,hold=2,up_cooldown=4,down_cooldown=6,util_low=0.4,cell_drain=5,"
    "interval=0.5,backend=xla,weights=gold:4;free:0.25",
]
BAD_SPECS = [
    "mni=2", "min=3,max=1", "min", "min=", "hold=0", "step=0", "min=-1", "min=x",
    "max=2.5", "interval=fast", "weights=gold", "weights=gold:x", "up_cooldown=soon",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_autoscale_config_matches_reference(spec):
    ref_cfg, ref_driver = ref_autoscale.parse_autoscale_config(spec)
    cfg, driver = autoscale.parse_autoscale_config(spec)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    if "backend=" not in spec:
        # The one deliberate difference: the port's workers run on the
        # card unless the spec asks for the CPU.
        assert (driver["backend"], ref_driver["backend"]) == ("auto", "cpu")
        ref_driver["backend"] = "auto"
    assert driver == ref_driver


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_autoscale_spec_matches_reference(spec):
    with pytest.raises(ValueError) as ref_err:
        ref_autoscale.parse_autoscale_config(spec)
    with pytest.raises(ValueError) as err:
        autoscale.parse_autoscale_config(spec)
    assert str(err.value) == str(ref_err.value)


# -------------------------------------------------------------- the policy


class _Workers:
    """Axis a, recording: the live count moves at once; ``fail`` is the
    set of call numbers that raise (a transient exec failure)."""

    def __init__(self, live, fail):
        self._live, self.fail, self.calls = live, fail, []

    def live(self):
        return self._live

    def _call(self, kind, n):
        self.calls.append((kind, n))
        if len(self.calls) in self.fail:
            raise OSError("exec failed")
        self._live += n if kind == "spawn" else -n

    def spawn(self, n):
        self._call("spawn", n)

    def drain(self, n):
        self._call("drain", n)


class _Weights:
    def __init__(self):
        self.calls = []

    def reweight(self, weights):
        self.calls.append(("reweight", dict(weights)))

    def restore(self):
        self.calls.append(("restore", None))


class _Cell:
    def __init__(self):
        self.calls = 0

    def drain_cell(self):
        self.calls += 1


# name -> (config kwargs, with weights, with cell, live at start)
POLICIES = {
    "defaults": (dict(), False, False, 1),
    "fast": (dict(min_workers=1, max_workers=3, hold_ticks=2, up_cooldown_s=1.5,
                  down_cooldown_s=3.0, util_low=0.4), False, False, 2),
    "weights": (dict(max_workers=2, hold_ticks=1, up_cooldown_s=0.0,
                     overload_weights={"gold": 4.0, "free": 0.25}), True, False, 1),
    "cell": (dict(min_workers=1, max_workers=2, hold_ticks=1, step=2, cell_drain_ticks=3),
             False, True, 1),
}


def _autoscale_state(metrics):
    return ({k: v for k, v in metrics.snapshot().items() if k.startswith("autoscale.")},
            metrics.gauges().get("autoscale.target_workers"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_controller_matches_reference(policy, seed):
    kw, with_weights, with_cell, live = POLICIES[policy]
    rng = np.random.default_rng([seed, sum(map(ord, policy))])
    ev = {"now": 0.0, "alerts": [], "util": None}
    made = {}
    for p, (mod, _m, _t) in PKG.items():
        made[p] = (_Workers(live, fail={3, 7}), _Weights() if with_weights else None,
                   _Cell() if with_cell else None)
        workers, weights, cell = made[p]
        made[p] += (mod.AutoscaleController(
            workers, burn=lambda: ev["alerts"], utilization=lambda: ev["util"],
            weights=weights, cell=cell, config=mod.AutoscaleConfig(**kw),
            clock=lambda: ev["now"]),)
    before = {p: _autoscale_state(m)[0] for p, (_a, m, _t) in PKG.items()}
    TRACE.enable(capacity=10**5)
    REF_TRACE.enable(capacity=10**5)
    phase = 0  # runs of burn, of quiet, of in-band evidence, of flaps
    try:
        for i in range(160):
            if i % 20 == 0:
                phase = int(rng.integers(4))
            ev["now"] += float(rng.choice([0.2, 1.0, 2.5]))
            burn = phase == 0 or (phase == 3 and rng.random() < 0.5)
            ev["alerts"] = ["request-p95"] if burn else []
            ev["util"] = (None if rng.random() < 0.1 else
                          float(rng.uniform(0.0, 0.45)) if phase == 1 else
                          float(rng.uniform(0.5, 1.0)))
            got = {p: made[p][3].tick() for p in PKG}
            assert got["port"] == got["ref"], i
            assert made["port"][3].status() == made["ref"][3].status()
            assert made["port"][0].calls == made["ref"][0].calls
            if with_weights:
                assert made["port"][1].calls == made["ref"][1].calls
            if with_cell:
                assert made["port"][2].calls == made["ref"][2].calls
            rows = {p: [(r["trace"], r["span"], r["event"], r.get("attrs"))
                        for r in t.drain()] for p, (_a, _m, t) in PKG.items()}
            assert rows["port"] == rows["ref"], i
            assert _autoscale_state(METRICS)[1] == _autoscale_state(REF_METRICS)[1]
    finally:
        TRACE.disable()
        REF_TRACE.disable()
    moved = {p: {k: v - before[p].get(k, 0) for k, v in _autoscale_state(m)[0].items()
                 if v != before[p].get(k, 0)} for p, (_a, m, _t) in PKG.items()}
    assert moved["port"] == moved["ref"]
    assert moved["port"].get("autoscale.scale_ups", 0) > 0
    assert moved["port"].get("autoscale.actions_suppressed", 0) > 0
    assert made["port"][0].calls


# -------------------------------------------------------------- actuators


class _TrackedLock:
    def __init__(self):
        self._lock = threading.Lock()
        self.held = False

    def __enter__(self):
        self._lock.acquire()
        self.held = True

    def __exit__(self, *exc):
        self.held = False
        self._lock.release()


def test_gateway_weight_actuator_on_the_port_gateway():
    gw = gateway.Gateway(Scheduler(), rate=None)
    lock = _TrackedLock()
    seen = []
    for name in ("set_tenant_weights", "clear_tenant_weights"):
        real = getattr(gw, name)

        def wrapped(*a, _real=real):
            seen.append(lock.held)
            return _real(*a)

        setattr(gw, name, wrapped)
    act = autoscale.GatewayWeightActuator(gw, lock)
    act.reweight({"gold": 4.0, "free": 0.25, "bogus": 0.0})
    assert gw.tenant_weights() == {"gold": 4.0, "free": 0.25}
    # The next submission under a re-weighted key carries its weight into
    # the scheduler's tenant WFQ.
    gw.miner_joined(1)
    gw.client_request(2, "cmu440", 0, 999, 0.0, client_key="gold")
    assert gw.sched._tenants._principals["gold"].weight == 4.0
    act.restore()
    assert gw.tenant_weights() == {} and seen == [True, True]


def test_controller_pump_ticks_survive_a_raise_and_stop():
    done = threading.Event()

    class Ctl:
        def __init__(self):
            self.ticks = 0

        def tick(self, now=None):
            self.ticks += 1
            if self.ticks == 1:
                raise RuntimeError("evidence provider down")
            if self.ticks >= 3:
                done.set()

    ctl = Ctl()
    pump = autoscale.ControllerPump(ctl, interval=0.01).start()
    assert done.wait(5.0)
    pump.stop()
    n = ctl.ticks
    time.sleep(0.05)
    assert ctl.ticks == n and not pump._thread.is_alive()


def test_cell_actuator_forwards_reason_and_latch():
    class Replica:
        def __init__(self):
            self.reasons = []

        def drain(self, reason="drain"):
            self.reasons.append(reason)

    fired, rep = [], Replica()
    autoscale.CellActuator(rep, reason="autoscale", on_drained=lambda: fired.append(1)).drain_cell()
    assert rep.reasons == ["autoscale"] and fired == [1]


def test_process_actuator_spawns_the_port_miner(monkeypatch, tmp_path):
    spawned = []

    class FakeProc:
        def __init__(self, argv, env=None, stdout=None, stderr=None):
            spawned.append((argv, env))
            self.pid, self.code, self.signals = 1000 + len(spawned), None, []

        def poll(self):
            return self.code

        def send_signal(self, sig):
            self.signals.append(sig)
            self.code = 0

    monkeypatch.setattr(actuator.subprocess, "Popen", FakeProc)
    act = autoscale.ProcessActuator(6060, telemetry="127.0.0.1:7070", log_dir=str(tmp_path),
                                    extra_env={"BMT_MINER_THROTTLE_NPS": "5000"})
    assert act.spawn(2) == 2
    for i, (argv, env) in enumerate(spawned):
        assert argv[1:] == ["-m", "bitcoin_miner_tpu_torch.apps.miner", "127.0.0.1:6060",
                            "--backend", "auto", "--telemetry", "127.0.0.1:7070",
                            "--telemetry-interval", "1.0", "--source", f"as-worker-{i}"]
        assert env["BMT_MINER_THROTTLE_NPS"] == "5000"
    assert act.drain(1) == 1  # LIFO: the newest worker goes first
    assert act.exit_codes() == [0]
    assert act._procs[0].signals == [] and act._retired[0].pid == 1002
    assert act._retired[0].signals == [signal.SIGTERM]
    assert (tmp_path / "worker.0.log").exists() and (tmp_path / "worker.1.log").exists()


def test_process_actuator_worker_sweeps_then_drains_clean():
    """One real port miner process (``--backend cpu``) against a live port
    server: it joins, sweeps a job exactly, and a drain ends it with 0."""
    params = lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)
    sched = Scheduler(min_chunk=2_000)
    srv = lsp.Server(0, params)
    t = threading.Thread(target=server.serve, args=(srv, sched), kwargs=dict(tick_interval=0.1),
                         daemon=True)
    t.start()
    act = autoscale.ProcessActuator(srv.port, backend="cpu",
                                    extra_env={"BMT_MINER_THROTTLE_NPS": "100000"})
    try:
        act.spawn(1)
        deadline = time.monotonic() + 60
        while sched.stats()["miners"] < 1:
            assert time.monotonic() < deadline and act.live() == 1, "the worker never joined"
            time.sleep(0.05)
        conn = lsp.Client("127.0.0.1", srv.port, params)
        try:
            t0 = time.monotonic()
            got = client.request_once(conn, "cmu440", 9_999, timeout=60)
            took = time.monotonic() - t0
        finally:
            conn.close()
        assert got == min_hash_range("cmu440", 0, 9_999)
        assert took >= 10_000 / 100_000  # the inherited pace
        assert act.drain(1) == 0 and act.live() == 0
        deadline = time.monotonic() + 30
        while None in act.exit_codes():  # the drain's harvest is asynchronous
            assert time.monotonic() < deadline, "the worker did not drain"
            time.sleep(0.05)
        assert act.exit_codes() == [0]
    finally:
        act.stop_all(timeout=10)
        srv.close()
        t.join(timeout=10)


def test_miner_reads_throttle_from_the_environment(monkeypatch):
    paced = []

    class Paced:
        def __init__(self, search, rate):
            paced.append(rate)
            self._search = search

        def close(self):
            self._search.close()

    def no_server(*_a, **_k):
        raise OSError("no server")

    monkeypatch.setattr(miner, "_PacedSearch", Paced)
    monkeypatch.setattr(miner.lsp, "Client", no_server)
    monkeypatch.setenv("BMT_MINER_THROTTLE_NPS", "2500")
    with redirect_stdout(io.StringIO()) as out:
        assert miner.main(["miner", "127.0.0.1:1", "--backend", "cpu"]) == 0
        # The flag wins over the environment, as in the reference.
        assert miner.main(["miner", "127.0.0.1:1", "--backend", "cpu",
                           "--throttle-nps", "7"]) == 0
    monkeypatch.delenv("BMT_MINER_THROTTLE_NPS")
    with redirect_stdout(io.StringIO()):
        assert miner.main(["miner", "127.0.0.1:1", "--backend", "cpu"]) == 0
    assert paced == [2500.0, 7.0]
    assert out.getvalue().count("Failed to join with server: no server") == 2
