"""The serving gateway: admission control + coalescing + result cache.

Sits between the LSP server loop and the :class:`Scheduler` and speaks the
scheduler's exact event interface (``miner_joined`` / ``client_request`` /
``result`` / ``lost`` / ``tick`` / ``checkpoint`` / ``stats`` /
``drain_evictions`` / ``revision``), so ``apps.server.serve`` runs either
one unchanged — the gateway is a drop-in decorator of the scheduler, and
like it is pure event-driven policy: ids + ``now`` in, ``(conn_id,
Message)`` actions out, no sockets, no clocks, no threads.

What it adds, in the order a request meets it:

1. **Content-addressed result cache** (:class:`ResultCache`): the argmin
   over ``(data, lower, upper)`` is pure, so a solved signature answers in
   one round-trip with zero device work (``gateway.cache_hits``).
   Behind it sits the **interval-algebra result store**
   (:class:`SpanStore`): every completed *chunk* is recorded as
   a solved span, and a coverage planner intersects each new request with
   the solved spans — a fully covered range answers by folding span
   minima, zero device work (``gateway.span_hits``); a partially covered
   range submits only the uncovered gaps as a remainder job, seeding the
   scheduler with the covered portions' fold so the single Result (and
   the checkpoint identity) stays whole-range-correct
   (``gateway.span_partial``; nonces skipped either way count into
   ``gateway.nonces_saved``).
2. **Request coalescing**: concurrent Requests with the same signature
   share ONE underlying sweep.  The gateway submits each distinct
   signature to the scheduler under a *virtual* client id (negative, so it
   can never collide with a real LSP conn id) and keeps the waiter list;
   the single Result fans out to every waiting conn (``gateway.coalesced``).
   A waiter dying just leaves the list; only when the LAST waiter is gone
   does the underlying job get cancelled — through ``Scheduler.lost``, so
   partial progress lands in the existing checkpoint-identity orphan stash
   and a later resubmission *resumes* rather than restarts.
2b. **Speculative span prefill**: when the fleet is fully
   idle, the gateway feeds the scheduler low-priority synthetic
   gap-sweeps adjacent to hot spans (``SpanStore.prefill_target``), so
   future overlapping queries hit fully-covered even more often.  The
   work rides a dedicated near-zero-weight WFQ tenant and is cancelled
   outright when any real signature needs the scheduler; its chunk
   results enter the span store exactly like real ones
   (``gateway.prefill_jobs`` / ``gateway.prefill_preempted``).
3. **Admission control**: at most ``max_active`` signatures run
   concurrently, and each client key has a token bucket (``rate``/
   ``burst``).  Over-limit requests queue in a weighted fair queue
   (backpressure: ``gateway.throttled``) instead of dispatching; when the
   global backlog exceeds ``max_queued``, the request is shed and the shell
   closes the conn exactly like a dead client (``gateway.shed``, via
   ``drain_evictions``).  Admitted jobs carry their client key into the
   scheduler's tenant WFQ, so one client flooding distinct signatures
   cannot starve another tenant's nonce throughput either.

This is the port's copy of the reference package's ``gateway/core.py``:
on the same events it returns the same actions as wire bytes, the same
``stats()`` and ``checkpoint()``, and moves the same ``gateway.*``
counters.  Cache and span answers reach no kernel: that is the gateway's
function, and every chunk it does let through is swept by the port's
miners.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..apps.scheduler import Action, Interval, JobKey, Scheduler
from ..bitcoin.message import Message, MsgType
from ..utils import trace as _trace
from ..utils.intervals import interval_total
from ..utils.metrics import METRICS
from .admission import FairQueue, TokenBucket
from .cache import ResultCache, SpanStore


@dataclass
class _Inflight:
    """One signature's shared sweep: the virtual id the scheduler knows it
    by, plus every real conn waiting on the answer (arrival order).
    ``trace`` is the primary waiter's event-log id (the one the scheduler
    threads through its dispatch events); ``meta`` keeps every waiter's
    own ``(trace id, arrival time)`` so the fan-out emits one result event
    and one latency sample per original request."""

    vid: int
    key: JobKey
    client_key: str
    waiters: List[int] = field(default_factory=list)
    trace: Optional[int] = None
    meta: Dict[int, Tuple[Optional[int], float]] = field(default_factory=dict)
    #: Span-aware in-flight coalescing: requests for
    #: a SUB-range of this sweep's range (same data, different key) park
    #: here instead of re-sweeping the overlap; when the sweep completes,
    #: its chunk spans are in the store and each parked request replans —
    #: usually answering whole, at worst sweeping only uncovered slivers.
    sub_waiters: List["_Queued"] = field(default_factory=list)


#: A request parked in the admission queue:
#: (conn_id, signature, client key, trace id, enqueue time).
_Queued = Tuple[int, JobKey, str, Optional[int], float]


class Gateway:
    """Event-in, actions-out serving layer (see module docstring)."""

    def __init__(
        self,
        scheduler: Optional[Scheduler] = None,
        *,
        cache: Optional[ResultCache] = None,
        spans: Optional[SpanStore] = None,
        rate: Optional[float] = 5.0,
        burst: float = 10.0,
        max_active: int = 64,
        max_queued: int = 256,
        max_buckets: int = 4096,
        prefill: int = 0,
        prefill_max_per_data: Optional[int] = None,
        prefill_idle_s: float = 0.0,
    ) -> None:
        self.sched = scheduler if scheduler is not None else Scheduler()
        self.cache = cache if cache is not None else ResultCache()
        # The interval store is on by default (pass SpanStore(capacity=0)
        # for an exact-match-cache-only gateway, e.g. the loadgen
        # comparison leg); arming it turns on the scheduler's span export.
        self.spans = spans if spans is not None else SpanStore()
        if self.spans.enabled:
            self.sched.record_spans = True
        self.rate = rate  # per-client requests/sec; None = unlimited
        self.burst = burst
        self.max_active = max(1, max_active)
        self.max_queued = max(0, max_queued)
        self.max_buckets = max(1, max_buckets)
        self._by_key: Dict[JobKey, _Inflight] = {}
        self._by_vid: Dict[int, _Inflight] = {}
        self._conn_key: Dict[int, JobKey] = {}  # waiting conn -> signature
        self._sub_conn: Dict[int, JobKey] = {}  # sub-range waiter -> covering flight's key
        self._sub_release: List[_Queued] = []  # parked waiters whose sweep just completed
        self._queued_conns: set = set()
        self._queue = FairQueue()
        self._buckets: Dict[str, TokenBucket] = {}
        # Tenant weight overrides (autoscale axis c): the
        # controller re-weights WFQ tenants under SLO burn so paying
        # traffic starves last, and clears the overrides on recovery.
        # Applied wherever a client key meets a virtual clock — the
        # admission FairQueue push and the scheduler tenant WFQ submit —
        # so the next enqueue under a principal carries the new weight
        # (utils/wfq: the latest submission's weight wins).
        self._tenant_weights: Dict[str, float] = {}
        self._shed: List[int] = []
        #: Monotone per-GATEWAY shed count (the process METRICS counter is
        #: shared by every in-process cell): the federation heartbeat's
        #: SHEDDING evidence — backpressure HERE, not somewhere else.
        self.shed_count = 0
        self._next_vid = -1  # virtual ids count down; real conn ids are > 0
        # Speculative span prefill: when the fleet is fully
        # idle, feed the scheduler ``prefill``-nonce synthetic gap-sweeps
        # adjacent to hot spans (SpanStore.prefill_target), charged to a
        # dedicated near-zero-weight WFQ tenant and cancelled outright the
        # moment any real signature needs the scheduler.  0 disables.
        self.prefill = max(0, int(prefill))
        self.prefill_max_per_data = prefill_max_per_data
        # Idle dwell: the fleet must have been CONTINUOUSLY idle this long
        # before speculating.  Sub-tick gaps between back-to-back requests
        # are not idleness — speculating into one hands a miner a chunk
        # the very next real request orphans (and a wedged miner then
        # burns its next real slot sweeping dead work).
        self.prefill_idle_s = prefill_idle_s
        self._idle_since: Optional[float] = None
        self._prefill_jobs: Dict[int, JobKey] = {}  # vid -> synthetic key

    # ------------------------------------------------------------------ events

    def miner_joined(self, conn_id: int, now: float = 0.0) -> List[Action]:
        if (
            conn_id in self._conn_key
            or conn_id in self._queued_conns
            or conn_id in self._sub_conn
        ):
            # Request-then-Join role confusion: the scheduler's own guard
            # (conn in jobs) cannot see it — the job runs under a virtual
            # id — and accepting would leave a phantom miner behind when
            # Gateway.lost later takes the waiter branch.  Refuse, exactly
            # as the scheduler refuses Join-after-Request without a gateway.
            return []
        return self._translate(self.sched.miner_joined(conn_id, now), now)

    def result(
        self, conn_id: int, hash_: int, nonce: int, now: float = 0.0
    ) -> List[Action]:
        out = self._translate(self.sched.result(conn_id, hash_, nonce, now), now)
        # Record freshly solved chunk spans BEFORE draining the backlog:
        # a queued request admitted by this very completion should already
        # see them (it may now be fully covered).
        for data, lo, hi, h, n in self.sched.drain_spans():
            self.spans.add(data, lo, hi, h, n)
        # Sub-range waiters parked on a sweep _translate just completed
        # replan HERE — after the span drain, so the finished sweep's own
        # chunks are visible to their coverage plan.
        if self._sub_release:
            pend, self._sub_release = self._sub_release, []
            for item in pend:
                self._release_sub(item, out, now)
        out.extend(self._admit(now))  # a completion may have freed capacity
        return out

    def tick(self, now: float) -> List[Action]:
        out = self._translate(self.sched.tick(now), now)
        out.extend(self._admit(now))  # token buckets refill with time
        out.extend(self._maybe_prefill(now))  # idle fleet: speculate
        return out

    def client_request(
        self,
        conn_id: int,
        data: str,
        lower: int,
        upper: int,
        now: float = 0.0,
        client_key: Optional[str] = None,
    ) -> List[Action]:
        """``client_key`` is the admission/fairness principal — the shell
        passes a stable per-client identity (endpoint label, remote addr);
        default is the conn itself."""
        if (
            conn_id in self._conn_key
            or conn_id in self._queued_conns
            or conn_id in self._sub_conn
            or conn_id in self.sched.miners
        ):
            return []  # one job per conn; miner/role confusion: ignore
        if lower < 0 or upper >= 1 << 64:
            # Mirror the scheduler's guard BEFORE creating gateway state: a
            # poison request must not leave a never-completing inflight.
            return []
        key: JobKey = (data, lower, upper)
        ckey = client_key or f"conn:{conn_id}"
        METRICS.inc("gateway.requests")
        # Trace root: ids are minted HERE, where a request
        # enters the system, and threaded through every layer below —
        # admission, coalescing, span planning, scheduler WFQ dispatch —
        # so ``python -m tools.trace`` rebuilds one tree per request.
        # new_id() returns None when tracing is off; emit is then a no-op.
        tid = _trace.new_id()
        _trace.emit(
            tid, "gw", "request",
            # data truncated: trace attrs are labels, not payload storage
            # (same 64-char bound as the scheduler's job_start).
            conn=conn_id, data=data[:64], lower=lower, upper=upper,
            client=ckey,
        )
        # 1. Solved before: answer from the cache, zero scheduler work.
        hit = self.cache.get(key)
        if hit is not None:
            METRICS.inc("gateway.cache_hits")
            METRICS.observe("hist.request_s", 0.0)
            _trace.emit(tid, "gw", "cache_hit")
            _trace.emit(tid, "gw", "result", conn=conn_id, latency=0.0)
            return [(conn_id, Message.result(hit[0], hit[1]))]
        # 1b. Never seen this exact signature, but the solved spans may
        # cover it whole (a sub-range of swept work) — answer by folding
        # span minima, before admission: a zero-work answer should cost
        # neither a token nor an active slot.  The plan is computed once
        # and threaded into _submit for the partial-coverage case; a
        # request that ends up QUEUED instead replans at admit time.
        plan = None
        if lower <= upper:
            plan = self.spans.cover(data, lower, upper)
            answer = self._span_answer(conn_id, key, plan, trace=tid)
            if answer is not None:
                METRICS.observe("hist.request_s", 0.0)
                return [answer]
        # 2. Already sweeping: join the waiter list, share the one sweep.
        flight = self._by_key.get(key)
        if flight is not None:
            METRICS.inc("gateway.coalesced")
            flight.waiters.append(conn_id)
            flight.meta[conn_id] = (tid, now)
            self._conn_key[conn_id] = key
            _trace.emit(tid, "gw", "coalesce", into=flight.trace)
            return []
        # 2b. Span-aware in-flight coalescing: a
        # request fully inside a RUNNING sweep's range (same data) parks
        # on that sweep's completion instead of re-sweeping the overlap —
        # by then the sweep's chunks are solved spans and the replan
        # usually answers whole.  Only with the interval store armed:
        # without spans the wait would end in a full re-sweep anyway.
        # The park is CAPPED at max_queued per sweep — the admission
        # queue's own bound (beyond it a request falls through to normal
        # admission below), and a released waiter whose remainder still
        # needs device work re-enters admission like any fresh request.
        if self.spans.enabled and lower <= upper:
            sup = self._covering_flight(data, lower, upper, key)
            if sup is not None and len(sup.sub_waiters) < self.max_queued:
                METRICS.inc("gateway.inflight_span_waits")
                sup.sub_waiters.append((conn_id, key, ckey, tid, now))
                self._sub_conn[conn_id] = sup.key
                _trace.emit(tid, "gw", "span_wait", into=sup.trace)
                return []
        # 3. Fresh signature: admit, queue, or shed.
        if len(self._by_key) >= self.max_active or not self._take_token(ckey, now):
            self._enqueue_or_shed((conn_id, key, ckey, tid, now))
            return []
        return self._submit(conn_id, key, ckey, now, plan=plan, trace=tid)

    def lost(self, conn_id: int, now: float = 0.0) -> List[Action]:
        skey = self._sub_conn.pop(conn_id, None)
        if skey is not None:
            # A parked sub-range waiter died: just leave its covering
            # sweep alone (primary waiters keep it alive).
            flight = self._by_key.get(skey)
            if flight is not None:
                for item in flight.sub_waiters:
                    if item[0] == conn_id:
                        flight.sub_waiters.remove(item)
                        _trace.emit(item[3], "gw", "waiter_lost", conn=conn_id)
                        break
            return []
        key = self._conn_key.pop(conn_id, None)
        if key is not None:
            flight = self._by_key.get(key)
            if flight is not None and conn_id in flight.waiters:
                flight.waiters.remove(conn_id)
                wtid, _t0 = flight.meta.pop(conn_id, (None, 0.0))
                _trace.emit(wtid, "gw", "waiter_lost", conn=conn_id)
                if not flight.waiters:
                    # Last waiter gone: cancel the shared sweep.  Through
                    # Scheduler.lost, so partial progress is stashed under
                    # the signature and a resubmission resumes it.
                    del self._by_key[flight.key]
                    del self._by_vid[flight.vid]
                    out = self._translate(self.sched.lost(flight.vid, now), now)
                    # Parked sub-range waiters lost their ride: each is an
                    # independent request — replan it now (the cancelled
                    # sweep's completed chunks are already solved spans).
                    for item in flight.sub_waiters:
                        self._release_sub(item, out, now)
                    flight.sub_waiters = []
                    out.extend(self._admit(now))
                    return out
            return []
        if conn_id in self._queued_conns:
            self._queued_conns.discard(conn_id)

            def _dead(item: _Queued) -> bool:
                if item[0] != conn_id:
                    return False
                _trace.emit(item[3], "gw", "waiter_lost", conn=conn_id)
                return True

            self._queue.remove_where(_dead)
            return []
        # A miner (or a conn we never admitted): the scheduler sorts it out.
        out = self._translate(self.sched.lost(conn_id, now), now)
        out.extend(self._admit(now))
        return out

    # ------------------------------------------------------------ pass-through

    @property
    def revision(self) -> int:
        return self.sched.revision

    def checkpoint(self) -> dict:
        return self.sched.checkpoint()

    def load_checkpoint(self, state: dict) -> None:
        self.sched.load_checkpoint(state)

    def drain_evictions(self) -> List[int]:
        """Evicted miners (scheduler) plus shed clients (admission): every
        conn the transport shell should close."""
        out = self.sched.drain_evictions()
        out += self._shed
        self._shed = []
        return out

    def vt_floor(self) -> float:
        """Scheduler tenant WFQ leading virtual time (gauge passthrough)."""
        return self.sched.vt_floor()

    def mark_straggler(self, conn_id: int) -> None:
        """Steal-scan passthrough: external straggler naming."""
        self.sched.mark_straggler(conn_id)

    def queue_vt_floor(self) -> float:
        """Admission fair-queue leading virtual time (the serve ticker
        publishes it as ``gauge.gw_vt_floor``)."""
        return self._queue.vt_floor()

    def set_tenant_weights(self, weights: Dict[str, float]) -> None:
        """Install the autoscaler's WFQ weight overrides (client key →
        weight, replacing any previous override map).  Takes effect on
        each principal's NEXT enqueue — queue push or scheduler submit —
        via the WFQ latest-submission-wins rule; under the overload that
        triggers a re-weight that is immediate in practice."""
        self._tenant_weights = {
            k: float(w) for k, w in weights.items() if w > 0.0
        }

    def clear_tenant_weights(self) -> None:
        """Drop every override (recovery): tenants return to unit weight
        on their next enqueue."""
        self._tenant_weights = {}

    def tenant_weights(self) -> Dict[str, float]:
        """The live override map (dash/status surface; copy, not view)."""
        return dict(self._tenant_weights)

    def _weight_of(self, client_key: str) -> float:
        return self._tenant_weights.get(client_key, 1.0)

    def stats(self) -> Dict[str, int]:
        st = self.sched.stats()
        st.update(
            gw_inflight=len(self._by_key),
            gw_waiters=len(self._conn_key),
            gw_queued=len(self._queue),
            gw_span_waits=len(self._sub_conn),
            gw_cached=len(self.cache),
            gw_spans=len(self.spans),
            gw_prefill=len(self._prefill_jobs),
        )
        return st

    # ------------------------------------------------------------------ internals

    def _take_token(self, client_key: str, now: float) -> bool:
        if self.rate is None:
            return True
        bucket = self._buckets.get(client_key)
        if bucket is None:
            if len(self._buckets) >= self.max_buckets:
                # Bounded per-client state (with per-conn default keys
                # every conn would otherwise leak a bucket for the server's
                # lifetime).  Prefer dropping refilled-to-burst buckets — a
                # full bucket is behaviorally identical to a fresh one — but
                # the cap is HARD: if everyone is mid-drain, evict oldest
                # (the worst that costs a flooder is a fresh burst allowance).
                self._buckets = {
                    k: b for k, b in self._buckets.items()
                    if not b.is_full(now)
                }
                while len(self._buckets) >= self.max_buckets:
                    self._buckets.pop(next(iter(self._buckets)))
            bucket = self._buckets[client_key] = TokenBucket(
                self.rate, self.burst, now
            )
        return bucket.try_take(now)

    def _submit(
        self,
        conn_id: int,
        key: JobKey,
        client_key: str,
        now: float,
        plan: Optional[Tuple[Optional[Tuple[int, int]], List[Interval]]] = None,
        trace: Optional[int] = None,
        t_req: Optional[float] = None,
    ) -> List[Action]:
        """Dispatch a fresh signature into the scheduler under a virtual id
        (tenant = the client key, so the scheduler's WFQ shares nonce
        throughput per client, not per job).

        ``plan`` is the caller's already-computed ``cover()`` result
        (client_request threads it so the hot path plans once); without
        one — the admit-from-queue path — coverage is planned here, so a
        request that waited sees every span solved while it was parked.
        Partial coverage submits only the uncovered gaps, seeding the
        scheduler with the covered portions' fold so its Result — and its
        checkpoint identity under ``(data, lower, upper)`` — is the whole
        range's answer.  Full coverage never normally reaches here
        (client_request answers it pre-admission, _resolve_twin catches
        queued twins); if it ever did, the empty gap list makes the
        scheduler's job done at birth and the seed fans out through the
        normal path — correct either way."""
        # A real signature needs the scheduler: speculative prefill jobs
        # are preempted NOW, not merely outscheduled.  Every completed
        # chunk is already a solved span (the remainder is simply dropped
        # — never stashed or checkpointed under the synthetic key), so a
        # later idle period re-plans the remaining gap from the span
        # store and resumes the speculation where it stopped.
        pre = self._cancel_prefill(now) if self._prefill_jobs else []
        data, lower, upper = key
        gaps: Optional[List[Interval]] = None
        seed: Optional[Tuple[int, int]] = None
        if lower <= upper:
            seed, gaps = (
                plan if plan is not None else self.spans.cover(data, lower, upper)
            )
            saved = (upper - lower + 1) - interval_total(gaps)
            if saved > 0:
                METRICS.inc("gateway.span_partial")
                METRICS.inc("gateway.nonces_saved", saved)
            else:
                gaps, seed = None, None  # no coverage: plain full-range job
        vid = self._next_vid
        self._next_vid -= 1
        flight = _Inflight(vid=vid, key=key, client_key=client_key,
                           waiters=[conn_id], trace=trace)
        flight.meta[conn_id] = (trace, t_req if t_req is not None else now)
        self._by_key[key] = flight
        self._by_vid[vid] = flight
        self._conn_key[conn_id] = key
        METRICS.inc("gateway.admitted")
        _trace.emit(
            trace, "gw", "submit",
            vid=vid, gaps=len(gaps) if gaps is not None else None,
        )
        return pre + self._translate(
            self.sched.client_request(
                vid, data, lower, upper, now, tenant=client_key,
                weight=self._weight_of(client_key),
                gaps=gaps, seed_best=seed, trace=trace,
            ),
            now,
        )

    def _translate(self, actions: List[Action], now: float) -> List[Action]:
        """Rewrite scheduler actions for the wire: a Result addressed to a
        virtual id becomes a fan-out to every waiting conn (and lands in
        the cache); everything else (chunk Requests to miners) passes
        through untouched."""
        out: List[Action] = []
        for cid, msg in actions:
            if msg.type == MsgType.RESULT and cid in self._prefill_jobs:
                # A speculative gap-sweep finished: no waiter to serve —
                # its chunk spans were recorded as they completed, and the
                # whole-range fold is a free exact-cache entry.
                key = self._prefill_jobs.pop(cid)
                self.cache.put(key, msg.hash, msg.nonce)
                continue
            flight = self._by_vid.get(cid)
            if flight is None or msg.type != MsgType.RESULT:
                out.append((cid, msg))
                continue
            del self._by_vid[flight.vid]
            del self._by_key[flight.key]
            self.cache.put(flight.key, msg.hash, msg.nonce)
            METRICS.inc("gateway.completed")
            for waiter in flight.waiters:
                self._conn_key.pop(waiter, None)
                out.append((waiter, msg))
                # One request→result latency sample and one trace terminal
                # PER ORIGINAL REQUEST — coalesced waiters measured from
                # their own arrival, not the primary's.
                wtid, wt0 = flight.meta.get(waiter, (None, now))
                latency = max(0.0, now - wt0)
                METRICS.observe("hist.request_s", latency)
                _trace.emit(
                    wtid, "gw", "result",
                    conn=waiter, latency=round(latency, 6),
                )
            if len(flight.waiters) > 1:
                METRICS.inc("gateway.fanout", len(flight.waiters) - 1)
                _trace.emit(
                    flight.trace, "gw", "fanout", waiters=len(flight.waiters)
                )
            if flight.sub_waiters:
                # Parked sub-range waiters replan AFTER the caller drains
                # this completion's chunk spans (result() releases them);
                # the completed Result itself covers a WIDER range, so it
                # is never their answer.
                self._sub_release.extend(flight.sub_waiters)
                flight.sub_waiters = []
        return out

    def _admit(self, now: float) -> List[Action]:
        """Drain the backlog into freed capacity: coalesce/cache-check each
        queued request again (its signature may have started or finished
        while it waited), then dispatch if its bucket has a token.  Requests
        still lacking tokens go back in the queue for a later event/tick."""
        if not len(self._queue):
            return []
        out: List[Action] = []
        deferred: List[Tuple[str, _Queued]] = []
        while len(self._by_key) < self.max_active and len(self._queue):
            popped = self._queue.pop()
            if popped is None:
                break
            ckey, item = popped
            conn_id, key, _, tid, t_enq = item
            if self._resolve_twin(item, out, now):
                continue  # solved or started while it queued
            if not self._take_token(ckey, now):
                deferred.append((ckey, item))
                continue
            self._queued_conns.discard(conn_id)
            wait = max(0.0, now - t_enq)
            METRICS.observe("hist.admission_wait_s", wait)
            _trace.emit(tid, "gw", "admitted", wait=round(wait, 6))
            out.extend(
                self._submit(conn_id, key, ckey, now, trace=tid, t_req=t_enq)
            )
        for ckey, item in deferred:
            self._queue.push(ckey, item, self._weight_of(ckey))
        # Even with every slot full, queued twins of an in-flight or solved
        # signature need no slot of their own — resolve them now instead of
        # leaving them parked a full completion cycle (the pred coalesces /
        # answers as a side effect; True removes the item from the queue).
        if len(self._queue):
            self._queue.remove_where(
                lambda item: self._resolve_twin(item, out, now)
            )
        return out

    def _span_answer(
        self,
        conn_id: int,
        key: JobKey,
        plan: Optional[Tuple[Optional[Tuple[int, int]], List[Interval]]] = None,
        trace: Optional[int] = None,
        latency: float = 0.0,
    ) -> Optional[Action]:
        """A full-coverage interval-store answer for ``key``, or None.
        With no gaps, the fold of the overlapping spans' minima IS the
        range's argmin (utils/intervals: every answerable portion's
        minimum equals its span's fold, and the portions tile the query);
        the answer also lands in the exact cache so later repeats cost
        one dict hit even after span eviction.  ``plan`` reuses a
        ``cover()`` the caller already paid for."""
        data, lower, upper = key
        if lower > upper:
            return None  # empty range: the scheduler's (0, 0) contract
        best, gaps = (
            plan if plan is not None else self.spans.cover(data, lower, upper)
        )
        if gaps or best is None:
            return None
        METRICS.inc("gateway.span_hits")
        METRICS.inc("gateway.nonces_saved", upper - lower + 1)
        _trace.emit(trace, "gw", "span_hit")
        _trace.emit(
            trace, "gw", "result", conn=conn_id, latency=round(latency, 6)
        )
        self.cache.put(key, best[0], best[1])
        return (conn_id, Message.result(best[0], best[1]))

    def answer_local(
        self, conn_id: int, data: str, lower: int, upper: int
    ) -> Optional[Action]:
        """A zero-work answer from the exact cache or fully-covering
        solved spans, creating NO gateway state — for shells (the
        federation router) that must decide locally-answerable vs
        route-elsewhere before any event reaches the gateway.  Valid
        non-empty ranges only: empty/poison ranges must flow through
        ``client_request`` so its guards see them."""
        if lower > upper or lower < 0 or upper >= 1 << 64:
            return None
        key: JobKey = (data, lower, upper)
        hit = self.cache.get(key)
        if hit is not None:
            METRICS.inc("gateway.cache_hits")
            METRICS.observe("hist.request_s", 0.0)
            return (conn_id, Message.result(hit[0], hit[1]))
        answer = self._span_answer(conn_id, key)
        if answer is not None:
            METRICS.observe("hist.request_s", 0.0)
        return answer

    def _maybe_prefill(self, now: float) -> List[Action]:
        """Submit one speculative gap-sweep when the fleet is fully idle
        no in-flight or queued signatures, no live scheduler
        work beyond earlier prefill, and at least one idle miner.  The
        job runs under a dedicated WFQ tenant with near-zero weight, so
        even before :meth:`_submit`'s outright cancellation, one carved
        chunk charges its virtual clock so far ahead that any real tenant
        dispatches first."""
        if not self.prefill or not self.spans.enabled:
            return []
        if self._by_key or self._sub_conn or len(self._queue):
            self._idle_since = None  # real work live: the dwell restarts
            return []
        if len(self._prefill_jobs) >= 1:
            return []  # one speculation in flight at a time
        st = self.sched.stats()
        if st["jobs"]:  # _prefill_jobs is empty past the guard above
            self._idle_since = None  # direct (non-gateway) work is live
            return []
        if st["miners"] == 0 or st["idle_miners"] == 0:
            return []
        # Continuous-idleness dwell (constructor comment): a sub-tick gap
        # between back-to-back requests must not trigger speculation.
        if self._idle_since is None:
            self._idle_since = now
        if now - self._idle_since < self.prefill_idle_s:
            return []
        target = self.spans.prefill_target(
            self.prefill, self.prefill_max_per_data
        )
        if target is None:
            return []
        data, lower, upper = target
        vid = self._next_vid
        self._next_vid -= 1
        self._prefill_jobs[vid] = (data, lower, upper)
        METRICS.inc("gateway.prefill_jobs")
        tid = _trace.new_id()
        _trace.emit(
            tid, "gw", "prefill",
            data=data[:64], lower=lower, upper=upper, vid=vid,
        )
        return self._translate(
            self.sched.client_request(
                vid, data, lower, upper, now,
                tenant="~prefill", weight=1e-6, prefill=True, trace=tid,
            ),
            now,
        )

    def _cancel_prefill(self, now: float) -> List[Action]:
        """Preempt every speculative job (a real request arrived): through
        ``Scheduler.lost``, so completed chunks stay solved spans; the
        remainder is dropped (never stashed — ``lost`` skips prefill jobs)
        and a later idle period re-plans it from the span store."""
        out: List[Action] = []
        for vid in list(self._prefill_jobs):
            data, lo, hi = self._prefill_jobs.pop(vid)
            METRICS.inc("gateway.prefill_preempted")
            out.extend(self._translate(self.sched.lost(vid, now), now))
            # Chunks that completed before the preemption are solved
            # spans by now (result() drains before this); give the
            # UNSWEPT remainder of an extension target its budget back.
            self.spans.prefill_refund(data, lo, hi)
        return out

    def _covering_flight(
        self, data: str, lower: int, upper: int, key: JobKey
    ) -> Optional[_Inflight]:
        """A running sweep whose range contains ``[lower, upper]`` on the
        same data (a different signature — exact twins coalesce earlier).
        O(in-flight) scan, bounded by ``max_active``."""
        for fkey, flight in self._by_key.items():
            fdata, flo, fhi = fkey
            if fdata == data and fkey != key and flo <= lower and upper <= fhi:
                return flight
        return None

    def _enqueue_or_shed(self, item: _Queued) -> None:
        """Park ``item`` in the admission queue, shedding on overflow:
        make the over-represented key pay, not the arrival — shedding the
        newcomer would let one flooder filling the queue get QUIET
        clients' conns closed.  Only when no key is over-represented (or
        the queue is disabled) does the arrival itself get shed."""
        conn_id, key, ckey, tid, t_enq = item
        if len(self._queue) >= self.max_queued:
            victim = self._queue.shed_from_largest()
            METRICS.inc("gateway.shed")
            self.shed_count += 1
            if victim is None:
                self._shed.append(conn_id)
                _trace.emit(tid, "gw", "shed", conn=conn_id)
                return
            self._queued_conns.discard(victim[0])
            self._shed.append(victim[0])
            _trace.emit(victim[3], "gw", "shed", conn=victim[0])
        METRICS.inc("gateway.throttled")
        self._queue.push(ckey, item, self._weight_of(ckey))
        self._queued_conns.add(conn_id)
        _trace.emit(tid, "gw", "queued", backlog=len(self._queue))

    def _release_sub(
        self, item: _Queued, out: List[Action], now: float
    ) -> None:
        """Replan one parked sub-range waiter: its covering sweep is gone
        (completed or cancelled), so answer from the cache/spans, coalesce
        into a live twin, or sweep the remainder — through NORMAL
        admission.  The free ride ended with the covering sweep: a
        remainder that still needs device work pays a token and an active
        slot like any fresh request (a cancelled sweep releasing
        max_queued parked waiters must not fan out past max_active), and
        when capacity is tight it queues with its ORIGINAL request time so
        latency accounting stays honest."""
        conn_id = item[0]
        self._sub_conn.pop(conn_id, None)
        if self._resolve_twin(item, out, now):
            return
        _cid, key, ckey, tid, t_enq = item
        if len(self._by_key) >= self.max_active or not self._take_token(ckey, now):
            self._enqueue_or_shed(item)
            return
        out.extend(
            self._submit(conn_id, key, ckey, now, trace=tid, t_req=t_enq)
        )

    def _resolve_twin(
        self, item: _Queued, out: List[Action], now: float = 0.0
    ) -> bool:
        conn_id, key, _, tid, t_enq = item
        hit = self.cache.get(key)
        if hit is not None:
            self._queued_conns.discard(conn_id)
            METRICS.inc("gateway.cache_hits")
            METRICS.observe("hist.request_s", max(0.0, now - t_enq))
            _trace.emit(tid, "gw", "cache_hit")
            _trace.emit(
                tid, "gw", "result",
                conn=conn_id, latency=round(max(0.0, now - t_enq), 6),
            )
            out.append((conn_id, Message.result(hit[0], hit[1])))
            return True
        answer = self._span_answer(
            conn_id, key, trace=tid, latency=max(0.0, now - t_enq)
        )
        if answer is not None:
            self._queued_conns.discard(conn_id)
            METRICS.observe("hist.request_s", max(0.0, now - t_enq))
            out.append(answer)
            return True
        flight = self._by_key.get(key)
        if flight is not None:
            self._queued_conns.discard(conn_id)
            METRICS.inc("gateway.coalesced")
            flight.waiters.append(conn_id)
            flight.meta[conn_id] = (tid, t_enq)
            self._conn_key[conn_id] = key
            _trace.emit(tid, "gw", "coalesce", into=flight.trace)
            return True
        return False
