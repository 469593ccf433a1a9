"""Merged fleet view over per-process metric snapshots.

The port's copy of the reference package's ``utils/fleetview.py``: the
same merge, the same straggler rule and the same Prometheus text, so a
fleet may mix both packages' miners and servers.

``utils/metrics.py`` is ONE process's registry; a fleet has many.  Each
miner ships ``Metrics.export_state()`` snapshots over the telemetry
sidecar channel (utils/telemetry.py); this module is the server-side
merge those snapshots land in:

- **counters** sum across every source ever seen — they are cumulative
  totals, so a source going stale does not make fleet totals go
  backwards (its last-known contribution stands);
- **gauges** are last-write-wins per name, taken only from *fresh*
  sources: a gauge from a source that has not reported within
  ``staleness_s`` describes a fleet that may no longer exist, so stale
  sources age out of the merged gauge/histogram view and are counted in
  ``stale_sources`` instead;
- **histograms** merge bucket-wise (mergeable by construction — the
  log-bucket boundaries are module-level constants in utils/metrics.py).

On top of the merge sit the two consumers the ROADMAP's next items need:
the **straggler detector** (:meth:`FleetView.stragglers`) compares each
source's chunk-latency distribution against its peers — exactly the
per-miner rate signal adaptive chunking wants — and
:func:`render_prometheus` writes the merged view in the Prometheus text
exposition format so any scraper can consume it.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from .metrics import _GROWTH_LOG2, Histogram


class _Source:
    """One telemetry source's latest snapshot (plain record, mutated only
    under the owning FleetView's lock)."""

    __slots__ = ("counters", "gauges", "hist_states", "seq", "last_seen")

    def __init__(self) -> None:
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self.hist_states: Dict[str, dict] = {}
        self.seq = -1
        self.last_seen = 0.0


class FleetView:
    """Thread-safe per-source snapshot store + merge.  The telemetry
    ingest thread writes, the serve ticker and the dashboard read."""

    def __init__(
        self, staleness_s: float = 15.0, clock=time.monotonic
    ) -> None:
        if staleness_s <= 0:
            raise ValueError(f"staleness_s must be positive, got {staleness_s}")
        self._staleness = float(staleness_s)  # immutable after construction
        self._clock = clock  # immutable after construction
        self._lock = threading.Lock()
        self._sources: Dict[str, _Source] = {}  # guarded-by: _lock

    # ----------------------------------------------------------------- ingest

    def ingest(self, source: str, state: dict, now: Optional[float] = None) -> bool:
        """Fold one snapshot in; False if it was dropped (stale ``seq`` —
        a reconnecting exporter restarting its sequence is accepted via
        the explicit reset rule: seq 1 always lands)."""
        now = self._clock() if now is None else now
        counters = state.get("counters") or {}
        gauges = state.get("gauges") or {}
        hists = state.get("hists") or {}
        if not isinstance(counters, dict) or not isinstance(gauges, dict) \
                or not isinstance(hists, dict):
            return False
        seq = state.get("seq")
        seq = -1 if not isinstance(seq, int) else seq
        with self._lock:
            src = self._sources.get(source)
            if src is None:
                src = self._sources[source] = _Source()
            if 1 < seq <= src.seq:
                return False  # replayed/out-of-order snapshot
            src.seq = seq
            src.last_seen = now
            src.counters = dict(counters)
            src.gauges = dict(gauges)
            src.hist_states = dict(hists)
        return True

    def drop(self, source: str) -> None:
        with self._lock:
            self._sources.pop(source, None)

    def reset(self) -> None:
        with self._lock:
            self._sources.clear()

    # ------------------------------------------------------------------ views

    def sources(self, now: Optional[float] = None) -> Dict[str, dict]:
        """{source: {age_s, stale, seq}} — the staleness surface."""
        now = self._clock() if now is None else now
        with self._lock:
            items = [(name, s.last_seen, s.seq) for name, s in self._sources.items()]
        out = {}
        for name, last_seen, seq in items:
            age = max(0.0, now - last_seen)
            out[name] = {"age_s": age, "stale": age > self._staleness, "seq": seq}
        return out

    def _fresh_and_all(self, now: float) -> Tuple[List[str], List[str]]:  # guarded-by: _lock
        names = list(self._sources)
        fresh = [
            n for n in names
            if now - self._sources[n].last_seen <= self._staleness
        ]
        return fresh, names

    def merged(
        self, now: Optional[float] = None, include_stale: bool = False
    ) -> dict:
        """The fleet view: summed counters (all sources), LWW gauges and
        merged :class:`Histogram` objects — from fresh sources only by
        default (the operator/display view).  ``include_stale=True``
        keeps every source's contribution: the SLO engine diffs
        CUMULATIVE evidence over time, and a source aging out (then
        back in) of a fresh-only view would make that evidence jump
        down and up, firing alerts with no new events."""
        now = self._clock() if now is None else now
        with self._lock:
            fresh, names = self._fresh_and_all(now)
            pool = names if include_stale else fresh
            counters_per = [dict(self._sources[n].counters) for n in names]
            # Freshest-last so later updates win the gauge merge.
            pool_sorted = sorted(
                pool, key=lambda n: self._sources[n].last_seen
            )
            gauges_per = [dict(self._sources[n].gauges) for n in pool_sorted]
            hists_per = [dict(self._sources[n].hist_states) for n in pool]
        counters: Dict[str, int] = {}
        for per in counters_per:
            for k, v in per.items():
                if isinstance(v, (int, float)):
                    counters[k] = counters.get(k, 0) + int(v)
        gauges: Dict[str, float] = {}
        for per in gauges_per:
            for k, v in per.items():
                if isinstance(v, (int, float)):
                    gauges[k] = float(v)
        hists: Dict[str, Histogram] = {}
        for per in hists_per:
            for k, st in per.items():
                h = hists.get(k)
                if h is None:
                    h = hists[k] = Histogram()
                h.merge(Histogram.from_state(st))
        return {
            "sources": len(fresh),
            "stale_sources": len(names) - len(fresh),
            "counters": counters,
            "gauges": gauges,
            "hists": hists,
        }

    def per_source_hist(
        self, name: str, now: Optional[float] = None
    ) -> Dict[str, Histogram]:
        """Fresh sources' own copies of one histogram — the straggler
        detector's comparison surface."""
        now = self._clock() if now is None else now
        with self._lock:
            fresh, _ = self._fresh_and_all(now)
            states = {
                n: self._sources[n].hist_states.get(name)
                for n in fresh
            }
        return {
            n: Histogram.from_state(st)
            for n, st in states.items()
            if st is not None
        }

    def stragglers(
        self,
        hist_name: str = "hist.miner_chunk_s",
        now: Optional[float] = None,
        ratio: float = 3.0,
        min_samples: int = 8,
        exclude: Tuple[str, ...] = (),
    ) -> List[dict]:
        """Sources whose ``hist_name`` p50 is >= ``ratio``× the median of
        their PEERS' p50s (leave-one-out, so one slow miner cannot drag
        the reference up past itself).  ``min_samples`` gates noise;
        ``exclude`` drops non-miner sources (the server's own snapshot).
        The default ratio sits far above the one-bucket (~19%) quantile
        slack, so bucket-edge effects cannot flag a healthy miner."""
        per = {
            n: h
            for n, h in self.per_source_hist(hist_name, now=now).items()
            if n not in exclude and h.count() >= min_samples
        }
        if len(per) < 2:
            return []
        p50s = {n: h.quantile(0.5) for n, h in per.items()}
        out = []
        for name, own in p50s.items():
            others = sorted(v for n, v in p50s.items() if n != name)
            mid = others[len(others) // 2] if len(others) % 2 else (
                (others[len(others) // 2 - 1] + others[len(others) // 2]) / 2.0
            )
            floor = max(mid, 1e-6)  # a 0 peer median must not blow the ratio up
            if own >= ratio * floor and own > 0.0:
                out.append(
                    {
                        "source": name,
                        "p50_s": own,
                        "fleet_p50_s": mid,
                        "ratio": own / floor,
                        "samples": per[name].count(),
                    }
                )
        out.sort(key=lambda d: -d["ratio"])
        return out

    # ------------------------------------------------------- federation

    def export_sources(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Every source's latest raw snapshot + its age — the per-CELL
        export a federation-level view ingests.  Unlike ``merged_state``
        this keeps per-source resolution, so the federation straggler
        detector still names the right miner."""
        now = self._clock() if now is None else now
        with self._lock:
            items = [
                (
                    name,
                    dict(s.counters),
                    dict(s.gauges),
                    dict(s.hist_states),
                    s.seq,
                    max(0.0, now - s.last_seen),
                )
                for name, s in self._sources.items()
            ]
        return {
            name: {
                "counters": counters,
                "gauges": gauges,
                "hists": hists,
                "seq": seq,
                "age_s": age,
            }
            for name, counters, gauges, hists, seq, age in items
        }

    def ingest_cell(
        self, cell: str, export: dict, now: Optional[float] = None
    ) -> int:
        """Fold one cell's :meth:`export_sources` into this (federation)
        view as ``cell/source`` entries; returns sources accepted.

        No double counting by construction: snapshots are ABSOLUTE
        per-source states, so re-ingesting the same export replaces
        rather than adds, and the cell prefix keeps a name that happens
        to exist in two cells as two distinct sources.  Ages carry over
        (``last_seen = now - age_s``), so a source stale in its cell is
        stale in the federation view too."""
        if not isinstance(export, dict):
            return 0
        now = self._clock() if now is None else now
        merged = 0
        for name, st in export.items():
            if not isinstance(name, str) or not isinstance(st, dict):
                continue
            age = st.get("age_s", 0.0)
            if not isinstance(age, (int, float)) or age < 0:
                age = 0.0
            if self.ingest(
                f"{cell}/{name}",
                {
                    "counters": st.get("counters") or {},
                    "gauges": st.get("gauges") or {},
                    "hists": st.get("hists") or {},
                    "seq": st.get("seq"),
                },
                now=now - age,
            ):
                merged += 1
        return merged

    def merged_state(
        self,
        now: Optional[float] = None,
        merged: Optional[dict] = None,
        sources: Optional[dict] = None,
    ) -> dict:
        """The fully JSON-able fleet view: what the server appends to the
        fleet log, publishes to dashboard subscribers, and stamps into
        BENCH JSON.  Histograms become their ``snapshot()`` dicts.
        ``merged``/``sources`` accept already-computed views so a caller
        running several consumers per tick (the hub) merges once."""
        now = self._clock() if now is None else now
        m = self.merged(now=now) if merged is None else merged
        return {
            "sources": m["sources"],
            "stale_sources": m["stale_sources"],
            "per_source": (
                self.sources(now=now) if sources is None else sources
            ),
            "counters": m["counters"],
            "gauges": m["gauges"],
            "hists": {k: h.snapshot() for k, h in sorted(m["hists"].items())},
        }


# ------------------------------------------------------------- prometheus

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(prefix: str, name: str) -> str:
    return f"{prefix}_{_PROM_BAD.sub('_', name)}"


def render_prometheus(merged: dict, prefix: str = "bmt") -> str:
    """The merged view (:meth:`FleetView.merged` output) in the
    Prometheus text exposition format: counters and gauges one sample
    each, histograms as cumulative ``_bucket{le=...}`` series with the
    log-bucket upper edges, plus ``_sum``/``_count``.  Point any scraper
    at the file the server's ``--prom=FILE`` flag maintains."""
    lines: List[str] = []
    lines.append(f"# TYPE {prefix}_fleet_sources gauge")
    lines.append(f"{prefix}_fleet_sources {merged.get('sources', 0)}")
    lines.append(f"# TYPE {prefix}_fleet_sources_stale gauge")
    lines.append(f"{prefix}_fleet_sources_stale {merged.get('stale_sources', 0)}")
    for name, value in sorted(merged.get("counters", {}).items()):
        pn = _prom_name(prefix, name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {value}")
    for name, value in sorted(merged.get("gauges", {}).items()):
        if name in ("fleet.sources", "fleet.sources_stale"):
            # The hub republishes the view's own source counts as gauges;
            # the authoritative meta lines above already cover them — a
            # second series under the same name is invalid exposition.
            continue
        pn = _prom_name(prefix, name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {value:g}")
    for name, h in sorted(merged.get("hists", {}).items()):
        pn = _prom_name(prefix, name)
        lines.append(f"# TYPE {pn} histogram")
        cum = h.zero_count()
        for i, c in sorted(h.buckets().items()):
            cum += c
            edge = 2.0 ** ((i + 1) * _GROWTH_LOG2)
            lines.append(f'{pn}_bucket{{le="{edge:.6g}"}} {cum}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h.count()}')
        lines.append(f"{pn}_sum {h.count() and h.mean() * h.count():g}")
        lines.append(f"{pn}_count {h.count()}")
    return "\n".join(lines) + "\n"
