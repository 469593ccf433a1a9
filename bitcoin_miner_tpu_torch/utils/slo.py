"""Declarative SLOs + multi-window burn-rate alerts over the fleet view.

The port's copy of the reference package's ``utils/slo.py``: the same
specs, the same ``--slo=`` vocabulary and the same error messages.

Vocabulary (README "Observability" documents the operator view):

- An :class:`SloSpec` names an **objective** — the target good-event
  fraction — over one of three kinds of evidence stream:

  * ``latency``: samples of histogram ``hist`` above ``threshold_s`` are
    bad ("p95 <= T" is exactly "no more than 5% of samples above T", so
    ``objective=0.95, threshold_s=T``; bad counts come from the
    mergeable buckets via ``Histogram.count_above``);
  * ``ratio``: bad/total cumulative counter sums (e.g. orphan rate:
    ``bad=sched.jobs_orphaned`` over completed+orphaned);
  * ``liveness``: each evaluation contributes one event per telemetry
    source, stale ones bad — "no more than (1-objective) of the fleet
    out of contact".

- The **error budget** is ``1 - objective``; the **burn rate** over a
  window is (bad fraction in window) / budget.  Burn 1.0 spends the
  budget exactly at the objective's edge; burn N spends it N× too fast.
- An alert **fires** when burn > ``burn_threshold`` in BOTH the fast and
  the slow window (the classic multi-window rule: the fast window
  catches the spike, the slow window keeps one transient blip from
  paging) and **resolves** once either window recovers.  Transitions
  bump ``slo.alerts_fired`` / ``slo.alerts_resolved`` and emit ``slo``
  trace events, and the firing set rides the server health line.

The engine samples CUMULATIVE (bad, total) pairs each evaluation and
diffs them at window edges, so it needs no per-event hooks — one
``tick()`` per serve-ticker beat, entirely off the hot path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from . import trace
from .metrics import METRICS


@dataclass(frozen=True)
class SloSpec:
    """One declarative objective + its alert policy.  Frozen: specs are
    config, shared freely across threads."""

    name: str
    kind: str  # "latency" | "ratio" | "liveness"
    objective: float = 0.95
    hist: str = ""  # latency: histogram name
    threshold_s: float = 0.0  # latency: samples above this are bad
    bad: Tuple[str, ...] = ()  # ratio: counter names summed as bad
    total: Tuple[str, ...] = ()  # ratio: counter names summed as total
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_threshold: float = 6.0
    min_events: int = 4  # windows with fewer total events never alert

    def __post_init__(self) -> None:
        if self.kind not in ("latency", "ratio", "liveness"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0,1), got {self.objective}")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast window must not exceed the slow window")
        if self.kind == "latency" and not self.hist:
            raise ValueError(f"latency SLO {self.name!r} needs hist=")
        if self.kind == "ratio" and not (self.bad and self.total):
            raise ValueError(f"ratio SLO {self.name!r} needs bad= and total=")


class SloEngine:
    """Evaluates a set of specs against a FleetView; owns the alert
    state machine.  Thread-safe (one lock), but the intended shape is
    one caller — the serve ticker (or the hub's self-tick thread)."""

    def __init__(self, specs: Sequence[SloSpec], clock=time.monotonic) -> None:
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self._specs = tuple(specs)  # immutable after construction
        self._clock = clock  # immutable after construction
        self._lock = threading.Lock()
        #: per-spec cumulative (t, bad, total) samples, oldest first
        self._samples: Dict[str, Deque[Tuple[float, float, float]]] = {
            s.name: deque() for s in specs
        }  # guarded-by: _lock
        #: liveness accumulators: evaluation-integrated (bad, total)
        self._live_accum: Dict[str, Tuple[float, float]] = {
            s.name: (0.0, 0.0) for s in specs if s.kind == "liveness"
        }  # guarded-by: _lock
        self._firing: Dict[str, bool] = {s.name: False for s in specs}  # guarded-by: _lock

    @property
    def specs(self) -> Tuple[SloSpec, ...]:
        return self._specs

    # ------------------------------------------------------------------ tick

    def tick(
        self,
        fleet,
        now: Optional[float] = None,
        exclude: Tuple[str, ...] = (),
        sources: Optional[dict] = None,
    ) -> dict:
        """Sample cumulative evidence from the fleet view, evaluate burn
        rates, run alert transitions.  Returns :meth:`state`.

        Evidence comes from the ``include_stale`` merge: cumulative
        (bad, total) pairs must be monotone over time, and a source
        aging out of a fresh-only view (then reconnecting) would step
        the totals down and back up — firing alerts with zero new
        events.  ``exclude`` drops non-fleet sources from the LIVENESS
        head-count (the hub passes its own local source: the server
        reporting itself alive must not dilute a dead miner's stale
        fraction below the alert threshold)."""
        now = self._clock() if now is None else now
        merged = fleet.merged(now=now, include_stale=True)
        sources = fleet.sources(now=now) if sources is None else sources
        if exclude:
            sources = {k: v for k, v in sources.items() if k not in exclude}
        fired: List[dict] = []
        resolved: List[dict] = []
        slos: List[dict] = []
        with self._lock:
            for spec in self._specs:
                bad, total = self._cumulative_locked(spec, merged, sources)
                dq = self._samples[spec.name]
                dq.append((now, bad, total))
                self._prune_locked(dq, now, spec.slow_window_s)
                burn_fast, n_fast = self._burn_locked(dq, now, spec)
                burn_slow, n_slow = self._burn_locked(
                    dq, now, spec, slow=True
                )
                firing = (
                    burn_fast > spec.burn_threshold
                    and burn_slow > spec.burn_threshold
                )
                was = self._firing[spec.name]
                st = {
                    "name": spec.name,
                    "kind": spec.kind,
                    "objective": spec.objective,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "window_events": n_slow,
                    "firing": firing,
                    "ok": not firing,
                }
                slos.append(st)
                if firing != was:
                    self._firing[spec.name] = firing
                    (fired if firing else resolved).append(st)
        # Transition side effects outside our lock (METRICS/trace have
        # their own): counters + trace events.
        for st in fired:
            METRICS.inc("slo.alerts_fired")
            trace.emit(
                None, "slo", "alert_fired",
                slo=st["name"], burn_fast=st["burn_fast"],
                burn_slow=st["burn_slow"],
            )
        for st in resolved:
            METRICS.inc("slo.alerts_resolved")
            trace.emit(
                None, "slo", "alert_resolved",
                slo=st["name"], burn_fast=st["burn_fast"],
                burn_slow=st["burn_slow"],
            )
        return {
            "slos": slos,
            "alerts": [s["name"] for s in slos if s["firing"]],
        }

    def state(self) -> dict:
        """Last-evaluated firing set without re-sampling (health line)."""
        with self._lock:
            alerts = [n for n, f in self._firing.items() if f]
        return {"alerts": alerts}

    def verdicts(self) -> Dict[str, bool]:
        """{slo name: quiet?} — the BENCH JSON stamp: True when the SLO
        is not currently firing."""
        with self._lock:
            return {s.name: not self._firing[s.name] for s in self._specs}

    # ------------------------------------------------------------- internals

    def _cumulative_locked(self, spec, merged, sources):
        """Cumulative (bad, total) evidence for one spec."""
        if spec.kind == "latency":
            h = merged["hists"].get(spec.hist)
            if h is None:
                return 0.0, 0.0
            return float(h.count_above(spec.threshold_s)), float(h.count())
        if spec.kind == "ratio":
            counters = merged["counters"]
            bad = float(sum(counters.get(n, 0) for n in spec.bad))
            total = float(sum(counters.get(n, 0) for n in spec.total))
            return bad, total
        # liveness: integrate one event per source per evaluation.
        stale = sum(1 for s in sources.values() if s["stale"])
        b, t = self._live_accum[spec.name]
        b, t = b + stale, t + len(sources)
        self._live_accum[spec.name] = (b, t)
        return b, t

    @staticmethod
    def _prune_locked(dq, now, slow_window):
        """Drop samples older than the slow window, keeping ONE sample at
        or beyond the edge — it is the diff baseline for the full window."""
        horizon = now - slow_window
        while len(dq) >= 2 and dq[1][0] <= horizon:
            dq.popleft()

    def _burn_locked(self, dq, now, spec, slow: bool = False):
        """Burn rate over one window: (bad fraction in window) / budget.
        Windows with fewer than ``min_events`` total events report 0 —
        no evidence is not an outage."""
        window = spec.slow_window_s if slow else spec.fast_window_s
        horizon = now - window
        base = None
        for t, bad, total in dq:
            if t > horizon:
                break
            base = (bad, total)
        if base is None:
            # Every retained sample is inside the window: the oldest one
            # is the best available baseline (cold start).
            base = (dq[0][1], dq[0][2]) if dq else (0.0, 0.0)
        _, bad_now, total_now = dq[-1] if dq else (now, 0.0, 0.0)
        d_bad = max(0.0, bad_now - base[0])
        d_total = max(0.0, total_now - base[1])
        if d_total < spec.min_events or d_total <= 0:
            return 0.0, int(d_total)
        budget = max(1.0 - spec.objective, 1e-9)
        return (d_bad / d_total) / budget, int(d_total)


def default_slos(
    request_threshold_s: float = 2.0,
    chunk_threshold_s: float = 10.0,
    objective: float = 0.95,
    orphan_objective: float = 0.95,
    liveness_objective: float = 0.90,
    fast_window_s: float = 60.0,
    slow_window_s: float = 300.0,
    burn_threshold: float = 6.0,
    min_events: int = 4,
) -> List[SloSpec]:
    """The stock SLO set the server arms with ``--slo``: request and
    chunk-RTT latency objectives, orphan rate, miner liveness."""
    win = dict(
        fast_window_s=fast_window_s,
        slow_window_s=slow_window_s,
        burn_threshold=burn_threshold,
        min_events=min_events,
    )
    return [
        SloSpec(
            "request-p95", "latency", objective,
            hist="hist.request_s", threshold_s=request_threshold_s, **win,
        ),
        SloSpec(
            "chunk-rtt-p95", "latency", objective,
            hist="hist.chunk_rtt_s", threshold_s=chunk_threshold_s, **win,
        ),
        SloSpec(
            "orphan-rate", "ratio", orphan_objective,
            bad=("sched.jobs_orphaned",),
            total=("sched.jobs_completed", "sched.jobs_orphaned"), **win,
        ),
        SloSpec("miner-liveness", "liveness", liveness_objective, **win),
    ]


def parse_slo_config(text: str) -> List[SloSpec]:
    """The ``--slo=`` CLI vocabulary: comma-separated ``key=value``
    overrides of :func:`default_slos` knobs; bare/empty/"1" arms the
    defaults.  Keys: ``req_p95`` / ``chunk_p95`` (latency thresholds,
    seconds), ``objective``, ``orphan`` / ``offline`` (allowed BAD
    fractions — ``orphan=0.02`` means objective 0.98), ``window=F/S``
    (fast/slow seconds), ``burn``, ``min_events``.

        --slo=req_p95=0.5,window=30/120,burn=2
    """
    kwargs: Dict[str, float] = {}
    text = (text or "").strip()
    if text in ("", "1", "default"):
        return default_slos()
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, val = part.partition("=")
        if not sep:
            raise ValueError(f"--slo entry {part!r} is not key=value")
        try:
            if key == "req_p95":
                kwargs["request_threshold_s"] = float(val)
            elif key == "chunk_p95":
                kwargs["chunk_threshold_s"] = float(val)
            elif key == "objective":
                kwargs["objective"] = float(val)
            elif key == "orphan":
                kwargs["orphan_objective"] = 1.0 - float(val)
            elif key == "offline":
                kwargs["liveness_objective"] = 1.0 - float(val)
            elif key == "window":
                fast, _, slow = val.partition("/")
                kwargs["fast_window_s"] = float(fast)
                kwargs["slow_window_s"] = float(slow or fast)
            elif key == "burn":
                kwargs["burn_threshold"] = float(val)
            elif key == "min_events":
                kwargs["min_events"] = int(val)
            else:
                raise ValueError(f"unknown --slo key {key!r}")
        except ValueError as e:
            raise ValueError(f"bad --slo entry {part!r}: {e}") from None
    return default_slos(**kwargs)  # type: ignore[arg-type]
