"""The port's chaos layer (``lspnet/{faults,chaos}.py``), its drill and the
server's ``BMT_CHAOS_SCENARIO`` switch, held to the JAX package's.

- **Engine parity.** The same seed and the same packet sequence give the
  same decision trace and counters in both packages' ``NetSim``: the
  scripted schedule of the reference's soak suite at four seeds, with and
  without ``loop_every``, and every standard scenario (names, descriptions,
  step times, pumped traces).
- **The model's properties in the port**: Gilbert–Elliott loss is bursty,
  a directional partition cuts one side only, ``heal`` does not pin ambient
  conditions, the bandwidth cap queues and never drops, steps apply in time
  order, ``loop_every`` replays and a plain run disarms.
- **Faults parity**: the same ``sometimes`` sequence from one seed, the
  clamped setters, ``_mutate_datagram`` byte for byte, the stderr line of a
  non-integer ``LSPNET_CHAOS_SEED`` (in subprocesses).
- **Drills on the CPU**: ``run_drill(..., backend="cpu")`` per registered
  workload against the reference's ``run_drill`` with the same arguments,
  and a kill drill.
- **The server's switch**: ``BMT_CHAOS_SCENARIO`` arms ``CHAOS`` in both
  shells, ``BMT_CHAOS_LOOP`` replays, an unknown name prints the
  reference's line and serves on.

Each package's globals (``FAULTS``, ``CHAOS``) are reset around every case.
"""

import base64
import io
import json
import os
import random
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from bitcoin_miner_tpu import lspnet as ref_lspnet
from bitcoin_miner_tpu import workloads as ref_workloads
from bitcoin_miner_tpu.apps import server as ref_server
from bitcoin_miner_tpu.apps.drill import run_drill as ref_run_drill
from bitcoin_miner_tpu.lspnet import chaos as ref_chaos
from bitcoin_miner_tpu.lspnet import faults as ref_faults
from bitcoin_miner_tpu.lspnet import udp as ref_udp
from bitcoin_miner_tpu_torch import lsp, lspnet, workloads
from bitcoin_miner_tpu_torch.apps import server
from bitcoin_miner_tpu_torch.apps.drill import run_drill
from bitcoin_miner_tpu_torch.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu_torch.lspnet import chaos, faults, udp

ROOT = Path(__file__).resolve().parent.parent
PKG = {"port": (chaos, faults, udp), "ref": (ref_chaos, ref_faults, ref_udp)}
SCENARIOS = ["burst-loss", "reorder-dup-delay", "flaky-then-partition", "miner-partition"]


@pytest.fixture(autouse=True)
def _clean_network():
    for net in (lspnet, ref_lspnet):
        net.reset_faults()
        net.CHAOS.reset()
    yield
    for net in (lspnet, ref_lspnet):
        net.CHAOS.reset()
        net.reset_faults()


# --------------------------------------------------------------------------
# Engine parity
# --------------------------------------------------------------------------


def _pump(sim, clock: list, n: int = 600):
    """The reference soak suite's synthetic packet sequence."""
    sim.record_trace(True)
    for i in range(n):
        clock[0] = i * 0.01
        sim.on_send("miner-1", False)
        sim.on_send("server", True)
        sim.on_recv("miner-1", False)
    return sim.trace, sim.counters()


def _scripted(pkg: str, seed: int, loop_every=None):
    """The reference soak suite's scripted schedule, built from one spec
    through ``pkg``'s public ``conditions`` / ``partition`` / ``heal``."""
    c = PKG[pkg][0]
    sim = c.NetSim()
    sim.seed(seed)
    clock = [0.0]
    sched = (
        c.Schedule()
        .at(0.0, c.conditions(drop=15, duplicate=10, reorder=10, delay_ms=2, jitter_ms=3))
        .at(2.0, c.conditions(ge=c.GEParams(p_enter_bad=3, p_exit_bad=12, loss_bad=90)))
        .at(4.0, c.partition("miner-1", "both"))
        .at(5.0, c.heal())
    )
    sim.run(sched, clock=lambda: clock[0], loop_every=loop_every)
    return sim, clock


@pytest.mark.parametrize("seed", [1, 7, 42, 43])
def test_scripted_trace_equals_reference(seed):
    port_trace, port_counters = _pump(*_scripted("port", seed))
    ref_trace, ref_counters = _pump(*_scripted("ref", seed))
    assert port_trace == ref_trace
    assert port_counters == ref_counters
    for key in ("dropped", "duplicated", "reordered", "delayed", "partitioned"):
        assert port_counters.get(key, 0) > 0, (key, port_counters)


@pytest.mark.parametrize("seed", [1, 42])
def test_scripted_trace_with_loop_every_equals_reference(seed):
    """15 s of packets over a 6 s period (two wraps): the per-link streams
    keep advancing across them."""
    port_trace, port_counters = _pump(*_scripted("port", seed, loop_every=6.0), n=1500)
    ref_trace, ref_counters = _pump(*_scripted("ref", seed, loop_every=6.0), n=1500)
    assert port_trace == ref_trace
    assert port_counters == ref_counters
    # Without the loop the network stays in the burst-loss state after 5 s;
    # looped, the i.i.d. loss and the partition come back after each wrap.
    plain_trace, plain_counters = _pump(*_scripted("port", seed), n=1500)
    assert port_trace != plain_trace
    assert port_counters["partitioned"] == 2 * plain_counters["partitioned"]  # 4-5 s, 10-11 s


def test_seed_changes_the_trace():
    assert _pump(*_scripted("port", 42))[0] != _pump(*_scripted("port", 43))[0]


def _steps(schedule):
    return [(t, len(steps)) for t, steps in schedule.sorted_steps()]


@pytest.mark.parametrize("epoch", [0.1, 0.05])
def test_standard_scenarios_match_reference(epoch):
    port, ref = chaos.standard_scenarios(epoch), ref_chaos.standard_scenarios(epoch)
    assert list(port) == list(ref) == SCENARIOS
    for name in SCENARIOS:
        assert port[name].desc == ref[name].desc
        assert _steps(port[name]) == _steps(ref[name])


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("seed", [3, 11])
def test_standard_scenario_trace_equals_reference(name, seed):
    """Each scenario pumped through both engines, with every label the
    scenarios target on both directions."""
    out = []
    for c in (chaos, ref_chaos):
        sim = c.NetSim()
        sim.seed(seed)
        clock = [0.0]
        sim.run(c.standard_scenarios()[name], clock=lambda: clock[0])
        sim.record_trace(True)
        for i in range(400):
            clock[0] = i * 0.005
            for label, is_server in (("server", True), ("miner-0", False),
                                     ("miner-1", False), ("client-0", False)):
                sim.on_send(label, is_server, 120)
                sim.on_recv(label, is_server)
        out.append((sim.trace, sim.counters()))
    assert out[0] == out[1]
    want = {"burst-loss": ["dropped"], "reorder-dup-delay": ["reordered", "duplicated", "delayed"],
            "flaky-then-partition": ["dropped", "partitioned"],
            "miner-partition": ["partitioned", "delayed"]}[name]
    for key in want:
        assert out[0][1].get(key, 0) > 0, (name, key, out[0][1])


# --------------------------------------------------------------------------
# The model's properties in the port
# --------------------------------------------------------------------------


def test_gilbert_elliott_loss_is_bursty():
    sim = chaos.NetSim()
    sim.seed(7)
    sim.set_conditions(ge=chaos.GEParams(p_enter_bad=2, p_exit_bad=10, loss_bad=100))
    dropped = [sim.on_send(None, False)[0] for _ in range(5000)]
    rate = sum(dropped) / len(dropped)
    assert 0.05 < rate < 0.40, rate  # stationary ~1/6 at these params
    runs, cur = [], 0
    for d in dropped:
        if d:
            cur += 1
        elif cur:
            runs.append(cur)
            cur = 0
    assert sum(runs) / len(runs) > 3.0  # i.i.d. at this rate would be ~1.2


def test_directional_partition_cuts_only_one_side():
    sim = chaos.NetSim()
    sim.seed(3)
    sim.partition("miner-1", "rx")
    assert sim.on_recv("miner-1", False) is True
    assert sim.on_send("miner-1", False)[0] is False  # tx still flows
    assert sim.on_recv("miner-2", False) is False  # peers unaffected
    sim.heal("miner-1")
    assert sim.on_recv("miner-1", False) is False


def test_heal_does_not_pin_ambient_conditions():
    sim = chaos.NetSim()
    sim.seed(5)
    sim.set_conditions(drop=40)
    sim.partition("server", "tx")
    sim.set_conditions()  # heal the ambient loss
    sim.heal("server")  # lift the partition
    assert all(not sim.on_send(None, True)[0] for _ in range(200))
    assert all(not sim.on_send("server", True)[0] for _ in range(200))


def test_bandwidth_cap_queues_and_never_drops():
    sim = chaos.NetSim()
    clock = [0.0]
    sim.run(chaos.Schedule().at(0.0, chaos.conditions(rate_bps=1000, burst_bytes=1000)),
            clock=lambda: clock[0])
    d1 = sim.on_send(None, False, 600)  # within the burst credit
    d2 = sim.on_send(None, False, 600)  # 200 bytes over: 0.2 s queue
    d3 = sim.on_send(None, False, 1000)  # behind d2: 1.2 s backlog
    assert d1 == (False, False, 0.0, False)
    assert d2[0] is False and abs(d2[2] - 0.2) < 1e-9
    assert d3[0] is False and abs(d3[2] - 1.2) < 1e-9
    clock[0] = 10.0  # long idle: the credit refills, capped at the burst
    assert sim.on_send(None, False, 1000)[2] == 0.0
    assert abs(sim.on_send(None, False, 400)[2] - 0.4) < 1e-9
    assert sim.counters() == {"throttled": 3, "delayed": 3}


def test_schedule_steps_apply_in_time_order():
    sim = chaos.NetSim()
    sim.seed(1)
    clock = [0.0]
    sim.run(chaos.Schedule().at(0.0, chaos.conditions(drop=100)).at(5.0, chaos.conditions())
            .at(10.0, chaos.partition("server", "tx")).at(15.0, chaos.heal()),
            clock=lambda: clock[0])
    assert sim.on_send(None, False)[0] is True
    clock[0] = 6.0
    assert sim.on_send(None, False)[0] is False
    clock[0] = 11.0
    assert sim.on_send(None, True)[0] is True  # server tx partitioned
    assert sim.on_send(None, False)[0] is False  # clients unaffected
    clock[0] = 16.0
    assert sim.on_send(None, True)[0] is False


@pytest.mark.parametrize("loop_every", [None, 2.0])
def test_loop_every_replays_and_a_plain_run_disarms(loop_every):
    sim = chaos.NetSim()
    sim.seed(1)
    clock = [0.0]
    sim.run(chaos.Schedule().at(0.0, chaos.conditions(drop=100)).at(1.0, chaos.conditions()),
            clock=lambda: clock[0], loop_every=loop_every)
    assert sim.on_send(None, False)[0] is True
    clock[0] = 1.5
    assert sim.on_send(None, False)[0] is False
    clock[0] = 8.1  # several periods later: mid-loss again when looped
    assert sim.on_send(None, False)[0] is (loop_every is not None)
    assert sim._enabled is (loop_every is not None)


def test_chaos_counters_feed_the_port_registry():
    from bitcoin_miner_tpu_torch.utils.metrics import METRICS

    before = METRICS.get("chaos.partitioned")
    sim = chaos.NetSim()
    sim.partition("x", "both")
    sim.on_send("x", False)
    sim.on_recv("x", False)
    assert METRICS.get("chaos.partitioned") - before == 2


def test_unarmed_engine_passes_every_packet():
    sim = chaos.NetSim()
    assert sim._enabled is False
    assert sim.on_send("miner-0", False, 500) == (False, False, 0.0, False)
    assert sim.on_recv("miner-0", False) is False
    assert sim.counters() == {}


# --------------------------------------------------------------------------
# Faults parity
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, 2024])
def test_sometimes_sequence_equals_reference(seed):
    port, ref = faults._Faults(), ref_faults._Faults()
    port.seed(seed)
    ref.seed(seed)
    pcts = [random.Random(seed).randrange(-5, 106) for _ in range(2000)]
    assert [port.sometimes(p) for p in pcts] == [ref.sometimes(p) for p in pcts]


SETTERS = ["set_read_drop_percent", "set_write_drop_percent", "set_client_read_drop_percent",
           "set_server_read_drop_percent", "set_client_write_drop_percent",
           "set_server_write_drop_percent", "set_msg_shortening_percent",
           "set_msg_lengthening_percent"]
KNOBS = ("client_read_drop", "server_read_drop", "client_write_drop", "server_write_drop",
         "msg_shorten", "msg_lengthen")


@pytest.mark.parametrize("setter", SETTERS)
def test_setters_clamp_like_reference(setter):
    for value in (-20, 0, 37, 100, 250):
        states = []
        for f in (faults._Faults(), ref_faults._Faults()):
            getattr(f, setter)(value)
            states.append({k: getattr(f, k) for k in KNOBS})
        assert states[0] == states[1]
        assert all(0 <= v <= 100 for v in states[0].values())
    f = faults._Faults()
    getattr(f, setter)(60)
    f.reset()
    assert all(getattr(f, k) == 0 for k in KNOBS)


def _datagrams(seed: int):
    """Seeded Data datagrams (empty, short, long payloads) and non-Data
    ones (Connect, Ack, CAck, bytes that are not JSON)."""
    rng = random.Random(seed)
    out = []
    for i in range(120):
        kind = rng.randrange(6)
        if kind < 3:
            payload = bytes(rng.randrange(256) for _ in range(rng.choice([0, 1, 7, 40])))
            out.append(lsp.Message.data(rng.randrange(1, 9), i, len(payload), payload).marshal())
        elif kind == 3:
            out.append(lsp.Message.ack(rng.randrange(1, 9), i).marshal())
        elif kind == 4:
            out.append(lsp.Message.connect().marshal())
        else:
            out.append(b"\xff not json" + bytes([i % 256]))
    return out


@pytest.mark.parametrize("shorten,lengthen", [(100, 0), (0, 100), (50, 50), (30, 70)])
def test_mutate_datagram_equals_reference(shorten, lengthen):
    got = []
    for net, mod in ((lspnet, udp), (ref_lspnet, ref_udp)):
        net.FAULTS.seed(99)
        net.set_msg_shortening_percent(shorten)
        net.set_msg_lengthening_percent(lengthen)
        got.append([mod._mutate_datagram(d) for d in _datagrams(shorten + lengthen)])
    assert got[0] == got[1]
    changed = [(a, b) for a, b in zip(_datagrams(shorten + lengthen), got[0]) if a != b]
    assert changed, "nothing was mutated"
    for before, after in changed:
        b, a = json.loads(before), json.loads(after)
        assert b["Type"] == a["Type"] == 1 and b["Size"] == a["Size"]
        assert len(base64.b64decode(a["Payload"] or "")) != b["Size"] or b["Size"] == 0


def test_mutate_datagram_is_identity_when_off():
    for d in _datagrams(4):
        assert udp._mutate_datagram(d) is d


@pytest.mark.parametrize("value", ["abc", "12x", "7"])
def test_chaos_seed_env_matches_reference(value):
    """A non-integer ``LSPNET_CHAOS_SEED`` gives the same stderr line in
    both packages (once from the faults knobs, once from the engine) and
    an integer one the same first draws."""
    code = ("import sys; from {p}.lspnet import FAULTS, CHAOS; "
            "print([FAULTS.sometimes(50) for _ in range(16)], CHAOS._seed)")
    outs = []
    for pkg in ("bitcoin_miner_tpu_torch", "bitcoin_miner_tpu"):
        r = subprocess.run([sys.executable, "-c", code.format(p=pkg)], cwd=ROOT,
                           env={**os.environ, "LSPNET_CHAOS_SEED": value},
                           capture_output=True, text=True, timeout=60)
        assert r.returncode == 0, r.stderr
        lines = [ln for ln in r.stderr.splitlines() if ln.startswith("lspnet:")]
        outs.append((lines, r.stdout if value == "7" else r.stdout.split("]")[1]))
    assert outs[0] == outs[1]
    if value == "7":
        assert outs[0][0] == [] and outs[0][1].strip().endswith("] 7")
    else:
        assert outs[0][0] == [f"lspnet: ignoring non-integer LSPNET_CHAOS_SEED={value!r}"] * 2


# --------------------------------------------------------------------------
# Drills on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("wname", workloads.names())
def test_drill_matches_reference_per_workload(wname):
    """The reference soak suite's tier-1 drill, per registered workload:
    ok, the loss really happened, and the same Result as the reference's
    drill with the same arguments.  The burst window is 6 epochs and a
    2,500-nonce job on the host tier may send only a few datagrams in it,
    so the seed is one whose server link enters the Gilbert–Elliott bad
    state on its first packet (seed 92; with the suite's seed 11 a warm
    run could finish with nothing dropped)."""
    default = wname == workloads.DEFAULT_WORKLOAD
    kw = dict(seed=92, data="fastchaos" if default else f"wlchaos-{wname}", max_nonce=2500,
              n_miners=2, timeout=60.0)
    report = run_drill("burst-loss", backend="cpu",
                       workload=None if default else workloads.get(wname), **kw)
    assert report.ok, report.as_dict()
    assert report.counters.get("chaos.dropped", 0) > 0, report.as_dict()
    assert report.errors == [] and report.result_s is not None
    assert {m["tier"] for m in report.miners.values()} == {"cpu"}
    ref = ref_run_drill("burst-loss", workload=None if default else ref_workloads.get(wname), **kw)
    assert ref.ok, ref.as_dict()
    assert report.got == ref.got == report.expected == ref.expected


def test_burst_seed_drops_the_servers_first_packet():
    """What the drill tests above rely on: under ``burst-loss`` with seed
    92 the server's first datagram is dropped, in both packages."""
    for c in (chaos, ref_chaos):
        sim = c.NetSim()
        sim.seed(92)
        sim.run(c.standard_scenarios()["burst-loss"], clock=lambda: 0.0)
        assert sim.on_send("server", True, 100)[0] is True


def test_kill_drill_reassigns_the_dead_miners_work(monkeypatch):
    """``miner-partition`` with miner-0 killed mid-job: the Result is
    still the oracle's, through reassignment and miner-1's re-Join.  Each
    miner is paced to 100,000 nonces/s, so the job outlasts the kill and
    the partition (at 0.15 s and 0.2 s) on any host."""
    import time

    from bitcoin_miner_tpu_torch.apps import drill

    real = drill.miner_mod.make_search

    def paced(backend, workload=None):
        search = real(backend, workload=workload)

        def run(data, lo, hi):
            time.sleep((hi - lo + 1) / 100_000)
            return search(data, lo, hi)

        return run

    monkeypatch.setattr(drill.miner_mod, "make_search", paced)
    report = run_drill("miner-partition", seed=404, data="killdrill", max_nonce=200_000,
                       n_miners=3, kill_miner_at=0.15, backend="cpu", timeout=60.0)
    assert report.ok, report.as_dict()
    assert report.expected == min_hash_range("killdrill", 0, 200_000)
    c = report.counters
    assert c.get("chaos.partitioned", 0) > 0, c
    assert c.get("sched.chunks_reassigned", 0) + c.get("miner.reconnects", 0) > 0, c


def test_drill_ends_at_once_when_a_search_raises(monkeypatch):
    """No host tier hides a failing rung: the first error ends the drill."""
    from bitcoin_miner_tpu_torch.apps import drill

    real = drill.miner_mod.make_search

    def broken(backend, workload=None):
        search = real(backend, workload=workload)

        def fail(data, lo, hi):
            raise RuntimeError("kernel launch failed")

        return fail if backend == "cpu" else search

    monkeypatch.setattr(drill.miner_mod, "make_search", broken)
    report = run_drill("burst-loss", seed=1, max_nonce=2000, backend="cpu", timeout=60.0)
    assert not report.ok and report.got is None
    assert report.errors and "kernel launch failed" in report.errors[0]
    assert report.elapsed < 10.0


def test_drill_rejects_an_unknown_scenario():
    with pytest.raises(ValueError, match="unknown scenario 'nope'"):
        run_drill("nope", backend="cpu")


# --------------------------------------------------------------------------
# The server's switch
# --------------------------------------------------------------------------


def _serve_main(pkg, argv, monkeypatch):
    """``pkg``'s ``server.main(argv)`` with its shells stubbed; returns
    (what CHAOS held when the shell started, stdout, stderr)."""
    srv = {"port": server, "ref": ref_server}[pkg]
    engine = {"port": lspnet.CHAOS, "ref": ref_lspnet.CHAOS}[pkg]
    seen = []

    def snapshot():
        seen.append(dict(enabled=engine._enabled, steps=[t for t, _ in engine._schedule],
                         loop=engine._loop_every))

    class FakeIngress:
        def __init__(self, port, **kw):
            self.port, self._thread, self.error = port, None, None

        def start(self):
            snapshot()
            return self

        def close(self):
            pass

    monkeypatch.setattr(srv, "serve", lambda *a, **k: snapshot())
    monkeypatch.setattr(srv, "AsyncIngress", FakeIngress)
    with redirect_stdout(io.StringIO()) as out, redirect_stderr(io.StringIO()) as err:
        assert srv.main(argv) == 0
    return seen, out.getvalue(), err.getvalue()


SHELLS = pytest.mark.parametrize("shell", [[], ["--async-ingress"]], ids=["serve", "async"])


@SHELLS
@pytest.mark.parametrize("name", SCENARIOS)
def test_chaos_scenario_env_arms_chaos(name, shell, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BMT_CHAOS_SCENARIO", name)
    seen, out, err = _serve_main("port", ["server", "0", *shell], monkeypatch)
    want = [t for t, _ in chaos.standard_scenarios()[name].sorted_steps()]
    assert len(seen) == 1, (out, err)
    assert seen[0]["enabled"] and seen[0]["loop"] is None
    # Steps at t <= 0 applied at arming; the rest wait on packets.
    assert seen[0]["steps"] in (want, [])
    assert lspnet.CHAOS._per_key or not lspnet.CHAOS._default.quiet \
        or lspnet.CHAOS._schedule, "nothing of the scenario was installed"
    assert err == ""


@SHELLS
def test_chaos_loop_env_replays(shell, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BMT_CHAOS_SCENARIO", "flaky-then-partition")
    monkeypatch.setenv("BMT_CHAOS_LOOP", "1")
    seen, _out, _err = _serve_main("port", ["server", "0", *shell], monkeypatch)
    steps = [t for t, _ in chaos.standard_scenarios()["flaky-then-partition"].sorted_steps()]
    assert steps == pytest.approx([0.0, 0.4, 0.6, 0.8])
    assert seen == [dict(enabled=True, steps=steps, loop=1.0)]
    sim = lspnet.CHAOS
    t0 = sim._t0
    sim._advance(t0 + 0.7)  # inside the server's tx cut
    assert sim.on_recv("server", True) is False and "server" in sim._part_tx
    sim._advance(t0 + 1.05)  # wrapped: 40% loss again, the cut healed
    assert sim._part_tx == set() and sim._default.drop == 40.0
    sim._advance(t0 + 25.0)  # never disarms
    assert sim._enabled and sim._schedule


@SHELLS
def test_unknown_chaos_scenario_warns_and_serves_on(shell, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("BMT_CHAOS_SCENARIO", "nope")
    got = {pkg: _serve_main(pkg, ["server", "0", *shell], monkeypatch)
           for pkg in ("port", "ref")}
    assert got["port"][2] == got["ref"][2] == "unknown BMT_CHAOS_SCENARIO 'nope'; ignoring\n"
    for pkg in ("port", "ref"):
        seen, _out, _err = got[pkg]
        assert seen == [dict(enabled=False, steps=[], loop=None)]  # and it served
