"""The port's fleet metrics plane against the JAX package's, without a wire.

- **Registry drift.** Every literal name the port's source passes to
  ``METRICS.inc/observe/set_gauge`` is in the port's registry block with the
  kind its prefix names, every registry name is emitted somewhere, and every
  one is spelled as in the reference's registry (the reference's ``metrics``
  analyzer pass, applied to the port).
- **State.** ``Histogram`` states, ``count_above`` and
  ``Metrics.export_state`` round-trip across the packages.
- **Frames.** ``encode_frames`` / ``encode_snapshot`` give the reference's
  bytes; seeded streams of either package's frames (reordered, torn,
  truncated, garbage, hostile) give both ``FrameAssembler`` s the same
  ``(done, obj)`` sequence.
- **FleetView, render_prometheus.** Seeded ingest / drop / reset /
  reconnect / replay sequences on a fake clock give equal views after
  every step, with snapshots from either package's registry.
- **SloEngine, parse_slo_config.** Seeded evidence gives equal ticks,
  ``state()`` and ``verdicts()``; the same strings are accepted and
  refused with the same messages.
- **The hub's tick.** The local registry as its own source, stragglers,
  SLOs, the ``fleet.*`` gauges and one ``fleet straggler`` event per newly
  flagged source, equal to the reference hub's on a fake clock.

Inputs come from numpy with fixed seeds.  Equality is exact.
"""

import ast
import dataclasses
import json
import re
import zlib
from pathlib import Path

import numpy as np
import pytest

from bitcoin_miner_tpu.utils import fleetview as ref_fleetview
from bitcoin_miner_tpu.utils import metrics as ref_metrics
from bitcoin_miner_tpu.utils import slo as ref_slo
from bitcoin_miner_tpu.utils import telemetry as ref_telemetry
from bitcoin_miner_tpu.utils import trace as ref_trace
from bitcoin_miner_tpu_torch.utils import fleetview, metrics, slo, telemetry, trace

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "bitcoin_miner_tpu_torch"
PKGS = {"port": (metrics, fleetview, slo, telemetry, trace),
        "ref": (ref_metrics, ref_fleetview, ref_slo, ref_telemetry, ref_trace)}


# --------------------------------------------------------------------------
# Registry drift
# --------------------------------------------------------------------------

_REGISTRY_LINE = re.compile(r"^#:\s{2,}([a-z][a-z0-9_]*(?:\.[a-z0-9_]+)+)\s+\S")
_METRIC_OK = re.compile(r"metric-ok:\s*([A-Za-z0-9_.*,\s]+)")
_GAUGES = ("gauge.", "fleet.", "fed.conns_live", "fed.peer_state", "gw.conns_live",
           "kernel.thresh_staleness", "autoscale.target_workers")
_KIND = {"inc": "counter", "observe": "hist", "set_gauge": "gauge"}


def _registry(path: Path) -> set:
    """The names of the ``#:`` block directly above ``METRICS = ...``."""
    lines = path.read_text().splitlines()
    at = next(i for i, line in enumerate(lines) if re.match(r"^METRICS\s*=", line))
    names = set()
    while at > 0 and lines[at - 1].startswith("#:"):
        at -= 1
        m = _REGISTRY_LINE.match(lines[at])
        if m:
            names.add(m.group(1))
    return names


def _emits(root: Path) -> dict:
    """name -> {emitter kinds} over every ``METRICS.<emitter>("literal")``
    call under ``root``; a ``# metric-ok: prefix.*`` comment on a dynamic
    emit counts for every registry name under the prefix."""
    reg = _registry(root / "utils" / "metrics.py")
    out: dict = {}
    for path in sorted(root.rglob("*.py")):
        src = path.read_text()
        lines = src.splitlines()
        for node in ast.walk(ast.parse(src)):
            f = getattr(node, "func", None)
            if not (isinstance(node, ast.Call) and isinstance(f, ast.Attribute)
                    and f.attr in _KIND and isinstance(f.value, ast.Name)
                    and f.value.id == "METRICS"):
                continue
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.setdefault(arg.value, set()).add(_KIND[f.attr])
                continue
            ok = _METRIC_OK.search(lines[node.lineno - 1])
            assert ok, f"{path}:{node.lineno}: a dynamic metric name with no metric-ok"
            for token in ok.group(1).split():
                prefix = token[:-1] if token.endswith(".*") else token
                for name in reg:
                    if name == token or (token.endswith(".*") and name.startswith(prefix)):
                        out.setdefault(name, set()).add(_KIND[f.attr])
    return out


def _kind(name: str) -> str:
    if name.startswith("hist."):
        return "hist"
    return "gauge" if name.startswith(_GAUGES) else "counter"


PORT_REGISTRY = _registry(PORT / "utils" / "metrics.py")
PORT_EMITS = _emits(PORT)
REF_REGISTRY = _registry(ROOT / "bitcoin_miner_tpu" / "utils" / "metrics.py")


@pytest.mark.parametrize("name", sorted(PORT_REGISTRY | set(PORT_EMITS)))
def test_metric_registry_has_no_drift(name):
    assert name in PORT_REGISTRY, f"{name} is emitted but not in the registry block"
    assert name in PORT_EMITS, f"{name} is in the registry block but nothing emits it"
    assert PORT_EMITS[name] == {_kind(name)}, (name, PORT_EMITS[name])
    assert name in REF_REGISTRY, f"{name} is not the reference's spelling"


def test_slice_names_are_registered():
    """The names the fleet metrics plane emits, each in the registry."""
    slice_names = {
        "lsp.retransmits", "lsp.delivered", "lsp.dropped_bad_size", "lsp.dropped_horizon",
        "hist.lsp_rtt_s", "miner.nonces", "miner.reconnects", "miner.tier_downgrades",
        "hist.miner_chunk_s", "hist.device_dispatch_s", "kernel.thresh_staleness",
        "fleet.sources", "fleet.sources_stale", "fleet.stragglers", "telemetry.exports",
        "telemetry.export_errors", "telemetry.snapshots_merged", "telemetry.decode_errors",
        "slo.alerts_fired", "slo.alerts_resolved",
    }
    assert slice_names <= PORT_REGISTRY


def test_gateway_and_autoscale_names_are_registered():
    """Every ``gateway.*`` and ``autoscale.*`` name of the reference's
    registry, and the two histograms the gateway feeds, in the port's."""
    names = {n for n in REF_REGISTRY if n.startswith(("gateway.", "autoscale."))}
    assert len(names) == 23
    assert names | {"hist.request_s", "hist.admission_wait_s"} <= PORT_REGISTRY
    assert _kind("autoscale.target_workers") == "gauge"


# --------------------------------------------------------------------------
# Seeded registries
# --------------------------------------------------------------------------

COUNTERS = ["miner.nonces", "sched.jobs_completed", "sched.jobs_orphaned", "lsp.delivered",
            "telemetry.exports"]
GAUGES = ["gauge.miners_live", "fleet.utilization", "fleet.sources", "kernel.thresh_staleness"]
HISTS = ["hist.miner_chunk_s", "hist.chunk_rtt_s", "hist.request_s", "hist.device_dispatch_s",
         "hist.lsp_rtt_s"]


def _ops(rng, n: int, scale: float = 1.0):
    """``n`` registry operations: counter adds, gauge sets, observations
    (a few zeros, a log-uniform spread of latencies)."""
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.3:
            out.append(("inc", str(rng.choice(COUNTERS)), int(rng.integers(1, 10**6))))
        elif r < 0.45:
            out.append(("set_gauge", str(rng.choice(GAUGES)), float(rng.random() * 8)))
        else:
            v = 0.0 if rng.random() < 0.05 else float(scale * 10 ** rng.uniform(-4, 1))
            out.append(("observe", str(rng.choice(HISTS)), v))
    return out


def _registries(ops):
    """One registry of each package with ``ops`` applied in order."""
    regs = {name: mod[0].Metrics() for name, mod in PKGS.items()}
    for reg in regs.values():
        for method, name, value in ops:
            getattr(reg, method)(name, value)
    return regs


# --------------------------------------------------------------------------
# State across the packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_histogram_and_export_state_match_reference(seed):
    rng = np.random.default_rng(seed)
    regs = _registries(_ops(rng, 300))
    port_state, ref_state = regs["port"].export_state(), regs["ref"].export_state()
    assert json.dumps(port_state) == json.dumps(ref_state)
    thresholds = [0.0, 1e-4, 0.01, 0.1, 0.5, 1.0, 3.0, 20.0]
    for name, st in port_state["hists"].items():
        for src, dst in ((metrics, ref_metrics), (ref_metrics, metrics)):
            a = src.Histogram.from_state(st)
            b = dst.Histogram.from_state(a.state())
            assert b.state() == st == a.state()
            assert [b.count_above(t) for t in thresholds] == [a.count_above(t)
                                                             for t in thresholds]
            assert [b.quantile(q) for q in (0.5, 0.95, 0.99)] == [
                a.quantile(q) for q in (0.5, 0.95, 0.99)]
    for garbage in (None, {"buckets": "x"}, {"count": "n"}, [1, 2]):
        assert (metrics.Histogram.from_state(garbage).state()
                == ref_metrics.Histogram.from_state(garbage).state())


# --------------------------------------------------------------------------
# Frames
# --------------------------------------------------------------------------


def _snapshot(seed: int, n_ops: int) -> dict:
    return _registries(_ops(np.random.default_rng(seed), n_ops))["ref"].export_state()


@pytest.mark.parametrize("seed", range(6))
def test_frames_match_reference_bytes(seed):
    rng = np.random.default_rng(100 + seed)
    state = _snapshot(seed, int(rng.integers(1, 2000)))
    source, seq, t = f"miner-{seed}", int(rng.integers(1, 10**6)), float(rng.random() * 1e9)
    frames = telemetry.encode_snapshot(source, seq, state, t)
    assert frames == ref_telemetry.encode_snapshot(source, seq, state, t)
    assert all(len(f) <= len(f"T1|{seq}|{len(frames)}|{len(frames)}|") + telemetry._FRAG_MAX
               for f in frames)
    blob = {"v": 1, "source": "x", "blob": rng.bytes(int(rng.integers(0, 6000))).hex()}
    mid = int(rng.integers(0, 2**40))
    assert telemetry.encode_frames(blob, mid) == ref_telemetry.encode_frames(blob, mid)
    assert telemetry.encode_subscribe() == ref_telemetry.encode_subscribe()
    for obj in (None, [], {"v": 2, "source": "a"}, {"v": 1}, {"v": 1, "source": 3},
                {"v": 1, "subscribe": True}, {"v": 1, "source": "m", "x": 1}):
        assert telemetry.validate_snapshot(obj) == ref_telemetry.validate_snapshot(obj)
    assert (telemetry._FRAG_MAX, telemetry._FRAG_LIMIT, telemetry._MAX_MSG_BYTES) == (
        ref_telemetry._FRAG_MAX, ref_telemetry._FRAG_LIMIT, ref_telemetry._MAX_MSG_BYTES)


#: A zlib bomb: a few KB that inflate past the ingest cap.
BOMB = zlib.compress(b"\x00" * (telemetry._MAX_MSG_BYTES + 1024), 9)


def _hostile(rng):
    """One hostile or malformed payload."""
    bomb = BOMB
    return [
        b"T1|x|y|z|junk",
        b"T1|7|0|1000000000|" + b"x" * 50,
        b"T1|7|5|3|" + b"x",
        b"T1|7|-1|3|" + b"x",
        b"T1|7|0|0|",
        b"T1|",
        b"\xff\xfe raw",
        json.dumps({"v": 1, "source": "plain"}).encode(),
        zlib.compress(json.dumps({"v": 1, "source": "z"}).encode()),
        b"[1, 2]",
        bomb,
        b"T1|9|0|1|" + bomb,
    ][int(rng.integers(0, 12))]


def _stream(seed: int, pkg) -> list:
    """A seeded payload stream of ``pkg``'s frames of a few messages, each
    message possibly reordered, torn, truncated, duplicated or
    interleaved with hostile payloads."""
    rng = np.random.default_rng(seed)
    out = []
    for mid in range(1, 9):
        obj = {"v": 1, "source": f"s{mid}", "blob": rng.bytes(int(rng.integers(0, 3000))).hex()}
        frames = list(pkg.encode_frames(obj, int(rng.choice([mid, mid, 1]))))
        r = rng.random()
        if r < 0.15 and len(frames) > 1:
            i = int(rng.integers(0, len(frames) - 1))
            frames[i], frames[i + 1] = frames[i + 1], frames[i]
        elif r < 0.3 and len(frames) > 1:
            del frames[int(rng.integers(0, len(frames)))]
        elif r < 0.45:
            i = int(rng.integers(0, len(frames)))
            frames[i] = frames[i][: int(rng.integers(0, len(frames[i]) + 1))]
        elif r < 0.55:
            frames = frames[int(rng.integers(1, len(frames) + 1)):]
        elif r < 0.65:
            frames = frames + frames[:1]
        for f in frames:
            if rng.random() < 0.1:
                out.append(_hostile(rng))
            out.append(f)
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("made_by", ["port", "ref"])
def test_frame_assembler_matches_reference(made_by, seed):
    payloads = _stream(seed, PKGS[made_by][3])
    port_asm, ref_asm = telemetry.FrameAssembler(), ref_telemetry.FrameAssembler()
    got = [port_asm.feed(p) for p in payloads]
    want = [ref_asm.feed(p) for p in payloads]
    assert got == want
    assert any(obj is not None for _d, obj in got)


# --------------------------------------------------------------------------
# FleetView and render_prometheus
# --------------------------------------------------------------------------


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _views(pkg_fleetview, view, now, ratio=3.0, min_samples=4, exclude=()):
    """Every read surface of one FleetView at ``now``, JSON-comparable."""
    merged = view.merged(now=now)
    merged_all = view.merged(now=now, include_stale=True)

    def plain(m):
        return {**m, "hists": {k: h.state() for k, h in sorted(m["hists"].items())}}

    return {
        "sources": view.sources(now=now),
        "merged": plain(merged),
        "merged_all": plain(merged_all),
        "per_source": {n: h.state() for n, h in
                       view.per_source_hist("hist.miner_chunk_s", now=now).items()},
        "stragglers": view.stragglers(now=now, ratio=ratio, min_samples=min_samples,
                                      exclude=exclude),
        "state": view.merged_state(now=now),
        "export": view.export_sources(now=now),
        "prom": pkg_fleetview.render_prometheus(merged),
    }


@pytest.mark.parametrize("seed", range(5))
def test_fleetview_and_prometheus_match_reference(seed):
    rng = np.random.default_rng(200 + seed)
    clock = FakeClock()
    views = {name: mod[1].FleetView(staleness_s=5.0, clock=clock) for name, mod in PKGS.items()}
    sources = ["m0", "m1", "m2", "m3", "server"]
    seqs = {s: 0 for s in sources}
    regs = {s: _registries([]) for s in sources}
    for _step in range(60):
        r = rng.random()
        src = str(rng.choice(sources))
        now = None if rng.random() < 0.5 else clock.t
        if r < 0.55:
            scale = 5.0 if src == "m3" else 1.0  # m3 straggles
            for method, name, value in _ops(rng, int(rng.integers(1, 30)), scale):
                for reg in regs[src].values():
                    getattr(reg, method)(name, value)
            seqs[src] += 1
            made_by = str(rng.choice(["port", "ref"]))
            state = {**regs[src][made_by].export_state(), "seq": seqs[src]}
            got = [v.ingest(src, json.loads(json.dumps(state)), now=now) for v in views.values()]
            assert got[0] == got[1]
        elif r < 0.62:
            seqs[src] = 1  # an exporter reconnecting restarts at seq 1
            state = {**regs[src]["port"].export_state(), "seq": 1}
            assert len({v.ingest(src, state, now=now) for v in views.values()}) == 1
        elif r < 0.68:
            state = {**regs[src]["ref"].export_state(), "seq": max(seqs[src] - 1, 2)}
            assert len({v.ingest(src, state, now=now) for v in views.values()}) == 1
        elif r < 0.72:
            bad = {"counters": [1], "seq": "x"}
            assert len({v.ingest(src, bad, now=now) for v in views.values()}) == 1
        elif r < 0.76:
            for v in views.values():
                v.drop(src)
        elif r < 0.78:
            for v in views.values():
                v.reset()
        elif r < 0.85:
            export = views["ref"].export_sources(now=clock.t)
            cell = str(rng.choice(["c1", "c2"]))
            assert len({v.ingest_cell(cell, export, now=now) for v in views.values()}) == 1
        else:
            clock.t += float(rng.uniform(0.1, 4.0))
        at = clock.t + float(rng.choice([0.0, 0.5]))
        got = _views(fleetview, views["port"], at, exclude=("server",))
        want = _views(ref_fleetview, views["ref"], at, exclude=("server",))
        assert got == want


def test_render_prometheus_matches_reference_on_a_merged_view_of_each_package():
    regs = _registries(_ops(np.random.default_rng(7), 400))
    for made_by in ("port", "ref"):
        view = PKGS[made_by][1].FleetView()
        view.ingest("m", {**regs[made_by].export_state(), "seq": 1})
        merged = view.merged()
        assert fleetview.render_prometheus(merged) == ref_fleetview.render_prometheus(merged)
        assert (fleetview.render_prometheus(merged, prefix="x")
                == ref_fleetview.render_prometheus(merged, prefix="x"))


# --------------------------------------------------------------------------
# SloEngine and parse_slo_config
# --------------------------------------------------------------------------


def _specs(pkg_slo):
    win = dict(fast_window_s=3.0, slow_window_s=8.0, burn_threshold=2.0, min_events=3)
    return pkg_slo.default_slos(chunk_threshold_s=0.75, request_threshold_s=0.5, **win) + [
        pkg_slo.SloSpec("chunk-p50", "latency", 0.5, hist="hist.miner_chunk_s",
                        threshold_s=0.2, **win),
        pkg_slo.SloSpec("lsp-delivered", "ratio", 0.9, bad=("telemetry.exports",),
                        total=("lsp.delivered", "telemetry.exports"), **win),
        pkg_slo.SloSpec("live", "liveness", 0.5, fast_window_s=1.0, slow_window_s=2.0,
                        burn_threshold=1.0, min_events=1),
    ]


@pytest.mark.parametrize("seed", range(4))
def test_slo_engine_matches_reference(seed):
    rng = np.random.default_rng(300 + seed)
    clock = FakeClock()
    views = {name: mod[1].FleetView(staleness_s=2.0, clock=clock) for name, mod in PKGS.items()}
    engines = {name: mod[2].SloEngine(_specs(mod[2]), clock=clock) for name, mod in PKGS.items()}
    regs = {s: _registries([]) for s in ("m0", "m1", "m2", "server")}
    seqs = dict.fromkeys(regs, 0)
    fired = set()
    for _tick in range(50):
        # An outage phase makes the latency and ratio SLOs burn.
        bad_phase = 15 <= _tick < 30
        for src in regs:
            if src == "m2" and 20 <= _tick < 35:
                continue  # m2 goes silent: stale
            ops = []
            for _ in range(int(rng.integers(0, 6))):
                lat = float(10 ** rng.uniform(-2, 0.3)) * (4 if bad_phase else 1)
                ops.append(("observe", str(rng.choice(HISTS)), lat))
                ops.append(("inc", str(rng.choice(COUNTERS)), int(rng.integers(1, 4))))
            for method, name, value in ops:
                for reg in regs[src].values():
                    getattr(reg, method)(name, value)
            seqs[src] += 1
            for made_by, view in views.items():
                view.ingest(src, {**regs[src][made_by].export_state(), "seq": seqs[src]})
        clock.t += float(rng.uniform(0.2, 0.8))
        now = None if _tick % 3 else clock.t
        got = engines["port"].tick(views["port"], now=now, exclude=("server",))
        want = engines["ref"].tick(views["ref"], now=now, exclude=("server",))
        assert got == want
        assert engines["port"].state() == engines["ref"].state()
        assert engines["port"].verdicts() == engines["ref"].verdicts()
        fired.update(got["alerts"])
    assert fired, "the seeded outage fired no alert: the comparison saw no transition"


SLO_TEXTS = ["", "1", "default", "  ", "req_p95=0.5,window=30/120,burn=2", "chunk_p95=3",
             "objective=0.9,orphan=0.02,offline=0.2", "window=10", " , req_p95=1 ,",
             "min_events=7", "x", "foo=1", "burn=abc", "min_events=2.5", "objective=1.5",
             "window=100/10", "req_p95", "window=/5", "orphan=1.2", "burn=2,,x"]


@pytest.mark.parametrize("text", SLO_TEXTS)
def test_parse_slo_config_matches_reference(text):
    def run(parse):
        try:
            return [dataclasses.asdict(s) for s in parse(text)]
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(slo.parse_slo_config) == run(ref_slo.parse_slo_config)


@pytest.mark.parametrize("kw", [dict(kind="nope"), dict(objective=1.0),
                                dict(fast_window_s=10.0, slow_window_s=5.0),
                                dict(kind="latency"), dict(kind="ratio", bad=("a",))])
def test_slo_spec_refusals_match_reference(kw):
    args = {"name": "s", "kind": "liveness", **kw}
    msgs = []
    for mod in (slo, ref_slo):
        with pytest.raises(ValueError) as e:
            mod.SloSpec(**args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for mod in (slo, ref_slo):
        with pytest.raises(ValueError, match="duplicate SLO names"):
            mod.SloEngine(mod.default_slos() + mod.default_slos()[:1])


# --------------------------------------------------------------------------
# The hub's tick
# --------------------------------------------------------------------------


def _straggler_events(pkg_trace):
    return [r["attrs"] for r in pkg_trace.TRACE.drain()
            if (r["span"], r["event"]) == ("fleet", "straggler")]


def test_hub_tick_matches_reference(tmp_path):
    rng = np.random.default_rng(400)
    clock = FakeClock()
    hubs, local = {}, _registries([])
    for name, mod in PKGS.items():
        win = dict(fast_window_s=3.0, slow_window_s=8.0, burn_threshold=2.0, min_events=3)
        hubs[name] = mod[3].TelemetryHub(
            0, source="server", registry=local[name], clock=clock,
            slo=mod[2].SloEngine(mod[2].default_slos(chunk_threshold_s=0.3, **win), clock=clock),
            fleet_log=str(tmp_path / f"{name}.jsonl"), prom_path=str(tmp_path / f"{name}.prom"),
            publish_interval=1.0, straggler_min_samples=4)
    for pkg_trace in (trace, ref_trace):
        pkg_trace.TRACE.enable()
    flagged = []
    try:
        regs = {s: _registries([]) for s in ("m0", "m1", "m2")}
        for tick in range(24):
            for src, reg in regs.items():
                slow = src == "m2" and tick >= 6 and tick < 18  # straggles, then recovers
                for _ in range(3):
                    v = float(10 ** rng.uniform(-2, -1.3)) * (20 if slow else 1)
                    for r in reg.values():
                        r.observe("hist.miner_chunk_s", v)
                        r.inc("miner.nonces", 1000)
                for name, hub in hubs.items():
                    hub.fleet.ingest(src, {**reg[name].export_state(), "seq": tick + 1})
            rtt = float(10 ** rng.uniform(-2, 0))
            for r in local.values():
                r.observe("hist.chunk_rtt_s", rtt)
                r.inc("sched.jobs_completed")
            clock.t += 0.5
            got = hubs["port"].tick(now=None if tick % 2 else clock.t)
            want = hubs["ref"].tick(now=None if tick % 2 else clock.t)
            assert got == want
            assert hubs["port"].last_state() == hubs["ref"].last_state()
            events = _straggler_events(trace)
            assert events == _straggler_events(ref_trace)
            flagged += [e["source"] for e in events]
            for g in ("fleet.sources", "fleet.sources_stale", "fleet.stragglers"):
                assert metrics.METRICS.gauge(g) == ref_metrics.METRICS.gauge(g)
        assert flagged == ["m2"], "one straggler event, for m2 alone"
        assert got["stragglers"] == []  # m2 recovered
    finally:
        for pkg_trace in (trace, ref_trace):
            pkg_trace.TRACE.disable()
        for hub in hubs.values():
            hub.close()
    port_log = (tmp_path / "port.jsonl").read_text().splitlines()
    ref_log = (tmp_path / "ref.jsonl").read_text().splitlines()
    assert port_log == ref_log and len(port_log) >= 10
    assert (tmp_path / "port.prom").read_text() == (tmp_path / "ref.prom").read_text()
