"""The port's operator tools (``bitcoin_miner_tpu_torch/tools/``) held to
the reference tools (``tools/``) on the CPU, their miners on the host tier
(``--backend cpu``).

- ``loadgen``: the seeded job lists equal the reference's; the default
  mode and ``--overlap`` at ``--fast`` scale, every Result held by the
  tool to its oracle, whose answers equal the reference package's
  ``min_range``; the gateway's hits, the zero-chunk probes; without a
  card and without ``--backend cpu`` it exits 2 and names the card.
- ``chaos_replay``: ``--list`` prints what the reference's prints; a
  replayed drill gives the reference tool's Result; a federation drill
  replays; no card, no host backend: exit 2.
- ``autoscale``: ``_FleetLogEvidence`` answers as the reference's on the
  same rows and clock (torn tails, staleness); the supervisor under
  ``--ticks`` makes the reference's decisions and spawns the port's
  miner with the spec's backend.
- The reference's ``tools.dash`` and ``tools.trace`` read the fleet log
  and the trace that the port's ``loadgen`` writes, which is why those two
  tools are not ported.
"""

import json
from types import SimpleNamespace

import pytest

from bitcoin_miner_tpu import workloads as ref_workloads
from bitcoin_miner_tpu_torch import workloads
from bitcoin_miner_tpu_torch.autoscale import actuator
from bitcoin_miner_tpu_torch.tools import autoscale as port_autoscale
from bitcoin_miner_tpu_torch.tools import card_available
from bitcoin_miner_tpu_torch.tools import chaos_replay as port_chaos
from bitcoin_miner_tpu_torch.tools import loadgen as port_loadgen
from tools import autoscale as ref_autoscale
from tools import chaos_replay as ref_chaos
from tools import dash
from tools import loadgen as ref_loadgen
from tools.trace.__main__ import main as trace_main

ARGSETS = [dict(jobs=30, dup=0.5, max_nonce=10_000), dict(jobs=64, dup=0.3, max_nonce=1_999_999_999)]


def _json_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _no_card() -> None:
    if card_available():
        pytest.skip("a CUDA card is present: the no-card refusal cannot show here")


# ---------------------------------------------------------------- loadgen


@pytest.mark.parametrize("seed", [7, 11, 2024])
@pytest.mark.parametrize("argset", range(len(ARGSETS)))
@pytest.mark.parametrize("builder", ["build_workload", "build_overlap_workload"])
def test_workloads_equal_the_reference(builder, argset, seed):
    args = SimpleNamespace(seed=seed, **ARGSETS[argset])
    kw = {"n_datas": 4} if builder == "build_overlap_workload" and argset else {}
    got = getattr(port_loadgen, builder)(args, **kw)
    assert got == getattr(ref_loadgen, builder)(args, **kw)
    assert len(got) == args.jobs


@pytest.mark.parametrize("mode", [[], ["--overlap"], ["--federation", "2"]])
def test_jobs_of_each_mode_equal_the_reference(mode):
    args = port_loadgen.parse_args(["--fast", "--seed", "5", *mode])
    if args.federation:
        want = ref_loadgen.build_overlap_workload(args, n_datas=4)
    elif args.overlap:
        want = ref_loadgen.build_overlap_workload(args)
    else:
        want = ref_loadgen.build_workload(args)
    assert port_loadgen.jobs_of(args) == want


def _hold_oracle_to_reference(argv) -> int:
    """Every distinct signature of ``argv``'s run: the port's hashlib
    oracle (what the tool held each Result to) equals the reference
    package's ``min_range``.  Returns the number of signatures."""
    args = port_loadgen.parse_args(argv)
    sigs = set(port_loadgen.jobs_of(args))
    port_wl, ref_wl = workloads.get(args.wl_name), ref_workloads.get(args.wl_name)
    for data, lo, hi in sigs:
        assert port_wl.min_range(data, lo, hi) == ref_wl.min_range(data, lo, hi)
    return len(sigs)


ZERO = {"minhash": 0, "minhash_factored": 0, "blake2b_minhash": 0, "hot_merge": 0}


def test_loadgen_default_mode_on_the_host(capsys):
    argv = ["--fast", "--backend", "cpu", "--clients", "8", "--dup", "0.5"]
    assert port_loadgen.main(argv) == 0
    out = _json_line(capsys)
    assert out["distinct_signatures"] == _hold_oracle_to_reference(argv) < out["jobs"]
    assert (out["tier"], out["device"], out["oracle"]) == ("cpu", "host", "hashlib")
    gw = out["gateway_counters"]
    # Every duplicate deduplicated (+1: the repeat probe is a cache hit).
    hits = gw.get("gateway.coalesced", 0) + gw.get("gateway.cache_hits", 0)
    assert hits == out["jobs"] - out["distinct_signatures"] + 1
    assert out["repeat_zero_chunks"] is True
    assert out["swept_nonces"] <= out["baseline_swept_nonces"]
    # The host tier launches no kernel; the counts are the legs' own.
    assert out["launches"] == out["baseline_launches"] == out["oracle_launches"] == ZERO


def test_loadgen_overlap_on_the_host(capsys):
    argv = ["--overlap", "--fast", "--clients", "4", "--backend", "cpu"]
    assert port_loadgen.main(argv) == 0
    out = _json_line(capsys)
    assert out["distinct_signatures"] == _hold_oracle_to_reference(argv)
    assert out["mode"] == "overlap" and out["tier"] == "cpu"
    gw = out["span_counters"]
    assert gw.get("gateway.span_hits", 0) + gw.get("gateway.span_partial", 0) > 0
    assert out["swept_nonces"] < out["exact_swept_nonces"]
    assert out["repeat_zero_chunks"] is True and out["subrange_zero_chunks"] is True
    assert out["launches"] == out["exact_launches"] == ZERO


def test_loadgen_open_loop_at_a_low_rate(capsys):
    """At 2 arrivals/s for 2 s not every listed job is asked: the async
    sub-range probe cuts from the widest SOLVED signature (the reference
    tool takes the widest listed one, which may never have been asked)."""
    assert port_loadgen.main(["--fast", "--backend", "cpu", "--open-loop", "2",
                              "--duration", "2"]) == 0
    out = _json_line(capsys)
    ol = out["open_loop"]
    assert ol["offered"] == ol["completed"] + ol["failed"] + ol["undrained"]
    assert ol["completed"] > 0 and ol["wrong"] == 0
    assert out["repeat_zero_chunks"] is True and out["subrange_zero_chunks"] is True
    assert out["launches"] == ZERO


@pytest.mark.parametrize("argv,what", [
    (["--fast"], "--backend auto mines on a CUDA card"),
    (["--fast", "--overlap", "--backend", "cuda"], "--backend cuda mines on a CUDA card"),
    (["--fast", "--backend", "cpu", "--oracle", "card"], "--oracle card sweeps on a CUDA card"),
])
def test_loadgen_without_a_card_exits_and_names_it(argv, what, capsys):
    _no_card()
    assert port_loadgen.main(argv) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and what in captured.err


def test_reference_dash_and_trace_read_the_ports_output(tmp_path, capsys):
    fleet, trace = tmp_path / "fleet.jsonl", tmp_path / "trace.jsonl"
    assert port_loadgen.main(["--fast", "--backend", "cpu", "--no-baseline", "--telemetry",
                              f"--fleet-log={fleet}", f"--trace={trace}"]) == 0
    out = _json_line(capsys)
    assert out["fleet"]["sources"] >= 1
    assert dash.main(["--once", str(fleet)]) == 0
    frame = capsys.readouterr().out
    assert "miner-pool" in frame and "hist.request_s" in frame
    assert trace_main(["--json", "--strict", str(trace)]) == 0
    report = json.loads(capsys.readouterr().out)
    # Every job and the repeat probe, each a complete request tree.
    assert report["requests"] == report["complete"] >= out["jobs"] + 1
    assert report["orphans"] == [] and report["open"] == []


# ------------------------------------------------------------ chaos_replay


def test_chaos_replay_list_equals_the_reference(capsys):
    assert ref_chaos.main(["--list"]) == 0
    want = capsys.readouterr().out
    assert port_chaos.main(["--list"]) == 0
    assert capsys.readouterr().out == want


def test_chaos_replay_gives_the_reference_tools_result(capsys):
    argv = ["--scenario", "burst-loss", "--seed", "5", "--max-nonce", "1500"]
    assert ref_chaos.main(argv) == 0
    ref = _json_line(capsys)
    assert port_chaos.main([*argv, "--backend", "cpu"]) == 0
    out = _json_line(capsys)
    assert out["ok"] is ref["ok"] is True
    assert out["got"] == ref["got"] == out["expected"] == ref["expected"]
    assert (out["seed"], out["scenario"]) == (5, "burst-loss")
    assert {m["tier"] for m in out["miners"].values()} == {"cpu"}
    assert out["launches"] == ZERO and out["oracle"] == "hashlib"


def test_chaos_replay_runs_a_federation_drill_at_its_size(capsys):
    assert port_chaos.main(["--fed-drill", "death-detect", "--max-nonce", "2500",
                            "--backend", "cpu"]) == 0
    out = _json_line(capsys)
    assert out["name"] == "death-detect" and out["ok"] is True and out["bit_exact"] is True
    assert {m["tier"] for m in out["miners"].values()} == {"cpu"}
    assert port_chaos.main(["--fed-drill", "no-such-drill", "--backend", "cpu"]) == 2


@pytest.mark.parametrize("argv", [[], ["--fed-drill", "death-detect"],
                                  ["--backend", "cpu", "--oracle", "card"]])
def test_chaos_replay_without_a_card_exits_and_names_it(argv, capsys):
    _no_card()
    assert port_chaos.main(argv) == 2
    assert "CUDA card" in capsys.readouterr().err


# --------------------------------------------------------------- autoscale

BURN = {"slo": {"alerts": ["request-p95"]}, "gauges": {"fleet.utilization": 0.9}}
QUIET = {"slo": {"alerts": []}, "gauges": {"fleet.utilization": 0.1}}
# Each step: (rows appended, a torn tail appended, clock) -> both providers.
EVIDENCE = {
    "missing-then-rows": [(None, None, 0.0), ([BURN], None, 1.0), ([QUIET], None, 2.0)],
    "torn-tail": [([BURN], '{"slo": {"al', 0.0), ([], None, 0.5), ([QUIET], None, 1.0),
                  ([QUIET], None, 1.5)],
    "stale": [([BURN], None, 0.0), ([], None, 4.9), ([], None, 5.1), ([QUIET], None, 6.0)],
    "partial-rows": [([{"gauges": {}}], None, 0.0), ([{"slo": None, "gauges": None}], None, 1.0),
                     (["not json"], None, 2.0), ([{"gauges": {"fleet.utilization": 1}}], None, 3.0)],
}


@pytest.mark.parametrize("name", list(EVIDENCE))
def test_fleet_log_evidence_equals_the_reference(name, tmp_path):
    now = [0.0]
    path = tmp_path / "fleet.jsonl"
    pair = [cls(str(path), stale_after=5.0, clock=lambda: now[0])
            for cls in (port_autoscale._FleetLogEvidence, ref_autoscale._FleetLogEvidence)]
    seen = []
    for rows, tail, clock in EVIDENCE[name]:
        if rows is not None:
            # A row after a torn tail completes the torn line, which then
            # does not decode: both readers skip it.
            with open(path, "a") as f:
                for row in rows:
                    f.write((row if isinstance(row, str) else json.dumps(row)) + "\n")
                f.write(tail or "")
        now[0] = clock
        answers = []
        for ev in pair:
            ev.poll()
            answers.append((ev.alerts(), ev.utilization()))
        assert answers[0] == answers[1]
        seen.append(answers[0])
    assert len(set(map(repr, seen))) > 1  # the sequence moved the evidence


class _FakeWorker:
    """A ``Popen`` stand-in: live until signalled, then exit 0."""

    spawned: list = []

    def __init__(self, argv, env=None, stdout=None, stderr=None):
        self.argv, self.pid, self.code, self.signals = argv, 4000 + len(self.spawned), None, []
        self.spawned.append(self)

    def poll(self):
        return self.code

    def send_signal(self, sig):
        self.signals.append(sig)
        self.code = 0

    def wait(self, timeout=None):
        return self.code

    def kill(self):
        self.code = -9


def test_supervisor_under_ticks_decides_as_the_reference(tmp_path, monkeypatch, capsys):
    from bitcoin_miner_tpu.autoscale import actuator as ref_actuator

    log = tmp_path / "fleet.jsonl"
    log.write_text(json.dumps(BURN) + "\n")
    argv = ["127.0.0.1:6060", "--fleet-log", str(log), "--ticks", "4",
            "--spec", "min=0,max=2,hold=1,up_cooldown=0,interval=0.01,backend=cpu"]
    lines, workers = {}, {}
    for name, mod, act in (("ref", ref_autoscale, ref_actuator),
                           ("port", port_autoscale, actuator)):
        monkeypatch.setattr(_FakeWorker, "spawned", [])
        monkeypatch.setattr(act.subprocess, "Popen", _FakeWorker)
        assert mod.main(argv) == 0
        lines[name] = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
        workers[name] = list(_FakeWorker.spawned)
    assert lines["port"] == lines["ref"]
    assert [d["last_action"] for d in lines["port"] if d["acted"]] == ["spawn 1", "spawn 1"]
    assert len(workers["port"]) == 2
    for w in workers["port"]:
        assert w.argv[1:] == ["-m", "bitcoin_miner_tpu_torch.apps.miner", "127.0.0.1:6060",
                              "--backend", "cpu"]
        assert w.code == 0 and len(w.signals) == 1  # drained at the end of the ticks
    assert [w.argv[2] for w in workers["ref"]] == ["bitcoin_miner_tpu.apps.miner"] * 2


@pytest.mark.parametrize("spec", ["1", "max=2", "backend=cuda"])
def test_supervisor_without_a_card_exits_and_names_it(spec, tmp_path, monkeypatch, capsys):
    _no_card()
    monkeypatch.setattr(actuator.subprocess, "Popen", _FakeWorker)
    monkeypatch.setattr(_FakeWorker, "spawned", [])
    argv = ["127.0.0.1:6060", "--fleet-log", str(tmp_path / "f.jsonl"), "--spec", spec]
    assert port_autoscale.main(argv) == 2
    assert "CUDA card" in capsys.readouterr().err and _FakeWorker.spawned == []
