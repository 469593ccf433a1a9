"""Process-wide counters, histograms and gauges — the observability layer.

A copy of the reference package's ``utils/metrics.py``: the server's health
line prints these names, so they are the same byte for byte.  Three kinds:

- **counters** — the original lock-protected registry every layer
  increments and anything (server log, runner stderr, tests) snapshots;
- **histograms** (:class:`Histogram`) — fixed log-bucket latency
  distributions (mergeable, p50/p95/p99) for request→result latency,
  chunk round-trips, admission queue wait and per-dispatch kernel time,
  so a bench artifact finally has a latency axis next to jobs/s;
- **gauges** — point-in-time levels (live miners, in-flight chunks,
  admission backlog, WFQ virtual clocks) set by the serve ticker.

Structured per-request *event* tracing lives in utils/trace.py; this
module stays the aggregate view.  Every name the port uses is listed in
the registry block above ``METRICS`` below.
"""

from __future__ import annotations

import math
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Optional, Tuple

#: Histogram bucket growth factor: 4 buckets per octave (~19% wide), so a
#: quantile estimate is within one bucket (×1.19) of the true sample
#: quantile.  Module-level constant — every histogram shares the same
#: boundaries, which is what makes them mergeable.
_GROWTH_LOG2 = 0.25  # bucket i covers [2**(i/4), 2**((i+1)/4))


class Histogram:
    """Fixed log-bucket histogram of non-negative samples (latencies).

    Buckets are powers of ``2**0.25`` keyed by integer index, so two
    histograms built anywhere merge by adding counts (associative and
    commutative by construction).  ``quantile(q)`` returns the upper edge
    of the bucket holding the q-th sample: the true sample quantile lies
    within one bucket width below it.  Thread-safe (own lock) — miners,
    gateway and LSP loops all observe into the shared registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = defaultdict(int)  # guarded-by: _lock
        self._zero = 0  # samples <= 0 (instant answers)  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock

    @staticmethod
    def _index(value: float) -> int:
        return math.floor(math.log2(value) / _GROWTH_LOG2)

    @staticmethod
    def _upper_edge(index: int) -> float:
        return 2.0 ** ((index + 1) * _GROWTH_LOG2)

    def observe(self, value: float, n: int = 1) -> None:
        with self._lock:
            self._count += n
            if value <= 0.0:
                self._zero += n
            else:
                self._sum += value * n
                self._buckets[self._index(value)] += n

    def merge(self, other: "Histogram") -> None:
        """Fold ``other``'s samples into self (other is snapshotted under
        its own lock first, so cross-thread merges are safe)."""
        with other._lock:
            buckets = dict(other._buckets)
            zero, count, total = other._zero, other._count, other._sum
        with self._lock:
            for i, c in buckets.items():
                self._buckets[i] += c
            self._zero += zero
            self._count += count
            self._sum += total

    def count(self) -> int:
        with self._lock:
            return self._count

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Upper bucket edge of the q-th sample (0 for an empty histogram
        or a quantile landing in the zero bucket)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return 0.0
            # Rank of the q-th sample, 1-based, clamped to the population.
            rank = min(self._count, max(1, math.ceil(q * self._count)))
            if rank <= self._zero:
                return 0.0
            seen = self._zero
            for i in sorted(self._buckets):
                seen += self._buckets[i]
                if seen >= rank:
                    return self._upper_edge(i)
            return self._upper_edge(max(self._buckets))  # float-slack guard

    def snapshot(self) -> Dict[str, float]:
        """The health-line / bench-JSON view: count, mean, p50/p95/p99."""
        return {
            "count": float(self.count()),
            "mean": self.mean(),
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    def count_above(self, threshold: float) -> int:
        """Samples definitively >= ``threshold``: the cumulative count of
        every bucket whose LOWER edge clears it (within-one-bucket slack,
        like :meth:`quantile`).  The SLO engine's bad-event source — a
        latency objective "p95 <= T" is exactly "no more than 5% of
        samples above T", which this answers from the mergeable buckets."""
        if threshold <= 0.0:
            return self.count()
        # First bucket whose lower edge 2**(i/4) clears the threshold
        # (epsilon guards the exact-edge case against float drift).
        first = math.ceil(math.log2(threshold) / _GROWTH_LOG2 - 1e-9)
        with self._lock:
            return sum(c for i, c in self._buckets.items() if i >= first)

    def buckets(self) -> Dict[int, int]:
        """Bucket-index -> count (the merge/property-test surface); the
        zero bucket is exposed separately via :meth:`zero_count`."""
        with self._lock:
            return dict(self._buckets)

    def zero_count(self) -> int:
        with self._lock:
            return self._zero

    # ------------------------------------------------- telemetry

    def state(self) -> Dict:
        """The JSON-able mergeable state the telemetry sidecar ships:
        bucket counts keyed by stringified index (JSON object keys are
        strings), the zero bucket, count and sum.  ``from_state`` on any
        process rebuilds an equivalent histogram — the fleet view merges
        these without ever seeing raw samples."""
        with self._lock:
            return {
                "buckets": {str(i): c for i, c in self._buckets.items()},
                "zero": self._zero,
                "count": self._count,
                "sum": self._sum,
            }

    @classmethod
    def from_state(cls, state) -> "Histogram":
        """Rebuild a histogram from :meth:`state` output.  Telemetry is
        best-effort: torn or garbage state decodes to an EMPTY histogram
        instead of raising mid-merge."""
        h = cls()
        try:
            buckets = {
                int(i): int(c)
                for i, c in dict(state.get("buckets", {})).items()
            }
            zero = int(state.get("zero", 0))
            count = int(state.get("count", 0))
            total = float(state.get("sum", 0.0))
        except (TypeError, ValueError, AttributeError):
            return h
        with h._lock:
            h._buckets.update(buckets)
            h._zero = zero
            h._count = count
            h._sum = total
        return h


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)  # guarded-by: _lock
        self._hists: Dict[str, Histogram] = {}  # guarded-by: _lock
        self._gauges: Dict[str, float] = {}  # guarded-by: _lock

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)  # no defaultdict insert on read

    # ------------------------------------------------------------ histograms

    def observe(self, name: str, value: float) -> None:
        """Record one sample into the named histogram (created on first
        use).  The histogram has its own lock, so the registry lock is
        held only for the dict lookup."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
        h.observe(value)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return dict(self._hists)

    # ---------------------------------------------------------------- gauges

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)

    # -------------------------------------------------------------- snapshot

    def snapshot(self, dists: bool = False) -> Dict:
        """Counters by default (the delta-friendly view every bench and
        drill diffs).  ``dists=True`` adds the distributions: gauges under
        their own names and each histogram's ``snapshot()`` dict — the
        operator/bench view."""
        with self._lock:
            out: Dict = dict(self._counters)
            if not dists:
                return out
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        out.update(gauges)
        for name, h in hists.items():
            out[name] = h.snapshot()
        return out

    def export_state(self) -> Dict:
        """The telemetry-sidecar snapshot: counters, gauges and
        every histogram's mergeable :meth:`Histogram.state`, all
        JSON-able.  ``utils/telemetry.py`` ships this over the sidecar
        channel; ``utils/fleetview.py`` merges it per source.  Cost is
        O(#metrics) under short per-object locks — safe from a timer
        thread, never from a hot loop."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {
            "counters": counters,
            "gauges": gauges,
            "hists": {name: h.state() for name, h in hists.items()},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()
            self._gauges.clear()


def format_quantiles(h) -> str:
    """Render p50/p95/p99 for a health line or dashboard cell.

    Accepts a :class:`Histogram`, a :meth:`Histogram.snapshot` dict, or
    None.  An empty (or absent) histogram renders ``-/-/-``: its
    ``snapshot()`` quantiles are numerically 0, and printing those reads
    as "instant" when the truth is "no data" (every quantile render
    site shares this helper so the rule cannot drift)."""
    if h is None:
        return "-/-/-"
    s = h.snapshot() if isinstance(h, Histogram) else h
    if not s or not s.get("count"):
        return "-/-/-"
    return f"{s['p50']:.3g}/{s['p95']:.3g}/{s['p99']:.3g}"


#: The process-wide registry: every name the port emits (a subset of the
#: reference package's registry, same spellings), and no name the port
#: does not emit (``tests/test_torch_telemetry.py`` scans the source for
#: drift in either direction).  Kinds by prefix: ``hist.*`` are histograms
#: (observe), ``gauge.*`` AND ``fleet.*`` are gauges (set_gauge — the
#: merged fleet-view levels published by utils/telemetry.py), and so are
#: the names marked (gauge) below; everything else is a counter (inc).
#:
#:   lsp.retransmits       data messages resent on epoch ticks
#:   lsp.delivered         in-order payloads handed to the application
#:   lsp.dropped_bad_size  datagrams rejected by Size validation
#:   lsp.dropped_horizon   datagrams beyond the reorder horizon (DoS guard)
#:   sched.chunks_assigned     chunks handed to miners
#:   sched.chunks_reassigned   chunks returned by dead miners
#:   sched.chunks_straggler_requeued  chunks reclaimed from hung miners
#:   sched.results_rejected    Results that failed hashlib validation
#:   sched.miners_evicted      miners dropped after max_rejects strikes
#:   sched.jobs_completed      Results sent back to clients
#:   sched.jobs_resumed        jobs resumed from a checkpoint
#:   sched.jobs_orphaned       dead clients' progress stashed for resubmit
#:   sched.nonces_swept        nonces in accepted chunk Results (rate source)
#:   sched.chunk_size_adapt    miner chunk-size rung moves on the 10^k ladder
#:   sched.steals              straggler chunk tails re-dispatched to idle miners
#:   sched.prefill_chunks      chunks dispatched for speculative prefill jobs
#:   sched.depth_adapt         adaptive pipeline-depth window re-sizes
#:   gateway.requests          client Requests that reached the gateway
#:   gateway.cache_hits        answered from the content-addressed cache
#:   gateway.cache_evictions   cache entries dropped by the LRU bound
#:   gateway.coalesced         Requests that joined an in-flight twin sweep
#:   gateway.admitted          signatures dispatched into the scheduler
#:   gateway.completed         shared sweeps finished (one per signature)
#:   gateway.fanout            extra conns served by a coalesced Result
#:   gateway.throttled         Requests queued by admission control
#:   gateway.shed              Requests dropped on backlog overflow (conn closed)
#:   gateway.span_hits         requests answered whole from solved spans
#:   gateway.span_partial      requests that swept only their uncovered gaps
#:   gateway.nonces_saved      nonces answered from spans instead of swept
#:   gateway.span_evictions    span-store data keys dropped by the LRU bound
#:   gateway.inflight_span_waits  sub-range requests parked on a covering running sweep
#:   gateway.prefill_jobs      speculative gap-sweep jobs submitted while idle
#:   gateway.prefill_preempted prefill jobs cancelled by an arriving real request
#:   gateway.coalesce_lost     nonces whose sub-range answerability span coalescing erased
#:   federation.forwarded      requests routed to their home replica's federation port
#:   federation.local_answers  non-home requests answered from local cache/gossiped spans
#:   federation.forward_failovers  forward attempts re-routed past a dead replica
#:   federation.forward_timeouts   forwards abandoned at the per-forward deadline
#:   federation.local_fallbacks    forwards served locally (every peer unreachable)
#:   federation.remote_results     forwarded requests answered by a peer's Result
#:   federation.gossip_beats   span-gossip messages sent to a peer
#:   federation.gossip_frames  span-gossip datagrams written (each under the wire ceiling)
#:   federation.gossip_rx      span-gossip messages received and decoded
#:   federation.gossip_spans_merged  peer spans folded into the local span store
#:   federation.gossip_errors  gossip sends/decodes/beats that failed
#:   federation.gossip_full_syncs  full-state anti-entropy beats sent (cycle or lag escalation)
#:   federation.shed_skips     forwards refused by a peer whose heartbeats prove it alive
#:   federation.drain_refused  requests turned away by a DRAINING cell
#:   federation.handoffs_sent  drain handoffs shipped to the ring successor
#:   fed.heartbeats            gossip heartbeats received from peers
#:   fed.suspected             peers marked SUSPECT by the failure detector
#:   fed.false_suspicions      suspects that heartbeat again before the confirmation window
#:   fed.handoff_jobs          resumable identities imported from a draining peer
#:   fed.shed_holds            heartbeats held SHEDDING by flap-damping hysteresis
#:   fed.peer_state            per-peer membership gauge (fed.peer_state.<peer>: 0 OK .. 4 DEAD)
#:   gossip.retransmits        unacked delta spans resent by the ack-gap recovery
#:   fed.conns_live            live peer conns at the federation transport (gauge)
#:   ingress.events            payloads dispatched on the asyncio ingress loop
#:   ingress.conns_lost        conns the async ingress reaped after epoch loss
#:   ingress.cross_thread_writes  off-loop writes hopped onto the ingress loop
#:   gw.conns_live             live conns at the public serving transport (gauge)
#:   autoscale.scale_ups       worker spawn actions taken by the autoscaler
#:   autoscale.scale_downs     clean-drain retire actions (incl. cell drains)
#:   autoscale.actions_suppressed  ticks an action was wanted but held (hysteresis/cooldown)
#:   autoscale.reweights       tenant WFQ weight override apply/restore actions
#:   autoscale.actuator_failures   actuator calls that raised (queued for retry)
#:   autoscale.target_workers  the controller's current worker target (gauge)
#:   client.resubmits          jobs resubmitted after a lost client conn
#:   miner.nonces              nonces swept by this process's miner loop
#:   miner.reconnects          successful re-Joins after a lost server conn
#:   miner.tier_downgrades     kernel tiers abandoned by the sweep watchdog
#:   sweep.ring_refills        chunk descriptors the hot plane uploads (one per dispatch)
#:   sweep.donated_dispatches  dispatches merged into a hot plane's device carry
#:   kernel.thresh_staleness   sieve-threshold lag in dispatches (gauge; 1 = device-resident)
#:   chaos.dropped             packets dropped by the network simulator
#:   chaos.partitioned         packets blackholed by a directional partition
#:   chaos.duplicated          packets the simulator emitted twice
#:   chaos.reordered           packets given the reorder extra delay
#:   chaos.delayed             packets delivered late (delay/jitter/reorder)
#:   chaos.throttled           packets queued by a token-bucket bandwidth cap
#:   telemetry.exports         metric snapshots shipped over the sidecar channel
#:   telemetry.export_errors   snapshot sends/connects that failed (channel down)
#:   telemetry.snapshots_merged  snapshots folded into the server's fleet view
#:   telemetry.decode_errors   telemetry payloads that failed to decode
#:   slo.alerts_fired          SLO burn-rate alerts that transitioned to firing
#:   slo.alerts_resolved       firing SLO alerts that cleared
#:   sanitize.loop_blocked     blocking-on-loop trips raised by the sanitizer
#:   sanitize.threads_leaked   threads found beyond a census baseline at reap time
#:   hist.request_s            request→result latency at the gateway (s)
#:   hist.chunk_rtt_s          chunk dispatch→Result round-trip (s)
#:   hist.admission_wait_s     admission-queue wait before dispatch (s)
#:   hist.device_dispatch_s    per-dispatch device enqueue→fetch time (s)
#:   hist.miner_chunk_s        miner-side chunk submit→solve time (s)
#:   hist.lsp_rtt_s            LSP data→ack round-trip, Karn-filtered (s)
#:   gauge.miners_live         miners currently joined to the scheduler
#:   gauge.inflight_chunks     chunks outstanding at miners right now
#:   gauge.admission_backlog   requests parked in the admission queue
#:   gauge.sched_vt_floor      scheduler tenant WFQ leading virtual time
#:   gauge.gw_vt_floor         gateway admission WFQ leading virtual time
#:   fleet.sources             fresh telemetry sources in the fleet view
#:   fleet.sources_stale       sources aged past the staleness window
#:   fleet.stragglers          sources flagged by the straggler detector
#:   fleet.utilization         fraction of live miners currently holding work
METRICS = Metrics()


class RateMeter:
    """Events/second — lifetime by default, recent with a ``window``.

    The lifetime average (``window=None``, and always via :meth:`lifetime`)
    is the bench-artifact number: total work over total wall time.  But on
    a health line it goes stale — after a reconnect or a kernel-tier
    downgrade the fleet's *current* rate can be far from the average since
    process start — so ``window=N`` seconds makes :meth:`rate` a sliding-
    window rate over the last N seconds of ``add``s instead (bucketed at
    sub-window granularity, O(buckets) memory)."""

    def __init__(
        self, clock=time.monotonic, window: Optional[float] = None
    ) -> None:
        if window is not None and window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self._clock = clock  # immutable after construction
        self._window = window  # immutable after construction
        self._t0 = clock()  # immutable after construction
        self._n = 0  # guarded-by: _lock
        self._events: Deque[Tuple[float, int]] = deque()  # guarded-by: _lock
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        with self._lock:
            self._n += n
            if self._window is not None:
                now = self._clock()
                # Bucket adds landing close together so a hot loop cannot
                # grow the deque unboundedly within one window.
                grain = self._window / 64
                if self._events and now - self._events[-1][0] < grain:
                    t, old = self._events[-1]
                    self._events[-1] = (t, old + n)
                else:
                    self._events.append((now, n))
                self._prune(now)

    def _prune(self, now: float) -> None:  # guarded-by: _lock
        horizon = now - self._window
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def rate(self) -> float:
        """Recent events/sec over the window, or the lifetime average when
        no window was configured."""
        if self._window is None:
            return self.lifetime()
        with self._lock:
            now = self._clock()
            self._prune(now)
            n = sum(c for _, c in self._events)
            # Until a full window has elapsed, normalize by the elapsed
            # time, not the window — a meter 2 s old with 100 events is
            # doing 50/s, not 100/window.
            dt = min(self._window, now - self._t0)
            return n / dt if dt > 0 else 0.0

    def lifetime(self) -> float:
        """Lifetime events/second since construction (bench JSON number)."""
        with self._lock:
            dt = self._clock() - self._t0
            return self._n / dt if dt > 0 else 0.0
