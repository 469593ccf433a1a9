"""Deterministic network-condition simulator (the chaos layer of L1).

The port's copy of the JAX package's ``lspnet/chaos.py``: the same engine,
scenarios, metric names and decision-trace tuples, so the same seed and the
same packet sequence give the same trace in both packages.

The legacy ``faults`` knobs model only uniform i.i.d. drops and payload
mutation; real fleets also see bursty loss, reordering, duplication,
latency spikes and partitions.  This module grows the lspnet seam into a
full simulator while keeping every random decision **replayable**:

- All randomness flows from one seed (``NetSim.seed`` / ``LSPNET_CHAOS_SEED``)
  through per-link streams — one :class:`random.Random` per (endpoint key,
  direction), derived stably from the seed and the key string.  Feeding the
  same packet sequence through the same seeded engine reproduces the
  identical decision trace bit-for-bit (see ``record_trace``).  Replay
  granularity is honest: single-threaded drives (the determinism tests)
  are bit-exact; a live multi-threaded fleet re-run from the same seed
  replays the same *seeded fault distribution* (per-link streams and
  schedule), but packet interleaving across event-loop threads — and
  therefore the exact trace — can differ.
- **Burst loss** uses a two-state Gilbert–Elliott Markov model
  (:class:`GEParams`): per-packet transitions between a good and a bad
  state with independent loss rates, producing the correlated loss runs
  that defeat naive retry logic where i.i.d. loss would not.
- **Delay + jitter, reordering, duplication** act on the send path
  (scheduled via the owning asyncio loop); reordering is realised
  netem-style as an extra delay on selected packets, which lands them
  behind later sends and exercises the LSP reorder buffer.
- **Directional partitions** cut an endpoint's tx and/or rx side.  Any
  A→B direction can be severed at A's tx or B's rx, so "server→miners"
  style one-way partitions need only each endpoint's own label.
- **Time-scheduled scenarios** (:class:`Schedule`): ordered steps like
  "40% loss for 5 s, heal, partition the server's tx for 2 epochs, heal",
  advanced lazily on packet events against a pluggable clock — no hook in
  the lsp loops is needed, because a fully partitioned link still *sends*
  (and the decision engine is what drops it).

Endpoints opt in by carrying a ``label`` (threaded through
``lsp.Client(..., label=...)`` / ``lsp.Server(..., label=...)``);
unlabeled endpoints fall back to their role key (``"client"`` /
``"server"``).  Conditions resolve label → role → default, so one call can
shape a single miner, all clients, or the whole network.

The simulator is globally off (``_enabled`` fast path) until conditions,
a partition, or a schedule are installed — zero per-packet overhead for
every non-chaos test and production run.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple
from zlib import crc32

from ..utils.metrics import METRICS


def _clamp_pct(v: float) -> float:
    return max(0.0, min(100.0, float(v)))


@dataclass(frozen=True)
class GEParams:
    """Gilbert–Elliott two-state burst-loss model (per-packet transitions).

    ``p_enter_bad``/``p_exit_bad`` are percent probabilities of switching
    state before each packet; ``loss_good``/``loss_bad`` are the percent
    loss rates inside each state.  Mean loss = loss weighted by the
    stationary state occupancy; burst length ~ 100/p_exit_bad packets.
    """

    p_enter_bad: float
    p_exit_bad: float
    loss_good: float = 0.0
    loss_bad: float = 100.0

    def __post_init__(self) -> None:
        # Same hygiene as faults._Faults._clamp: out-of-range percentages
        # must not silently skew the seeded experiment being replayed.
        for f in ("p_enter_bad", "p_exit_bad", "loss_good", "loss_bad"):
            object.__setattr__(self, f, _clamp_pct(getattr(self, f)))


@dataclass(frozen=True)
class LinkConditions:
    """Everything the simulator may do to one endpoint's traffic.
    Partitions are deliberately NOT conditions — they are tracked as
    separate key sets in :class:`NetSim`, so partitioning an endpoint
    never snapshots (and healing never resurrects) ambient loss/delay."""

    drop: float = 0.0  # percent, i.i.d. (on top of any GE model)
    duplicate: float = 0.0  # percent of sends emitted twice
    reorder: float = 0.0  # percent of sends given reorder_delay_ms extra
    delay_ms: float = 0.0  # base one-way delay added to every send
    jitter_ms: float = 0.0  # uniform ±jitter around delay_ms
    reorder_delay_ms: float = 30.0  # how far a reordered packet lags
    ge: Optional[GEParams] = None  # burst-loss model
    #: Bandwidth cap: a token-bucket shaper in BYTES/sec per link.  A
    #: packet that finds insufficient credit is not dropped — it queues,
    #: i.e. it is delivered with the delay the backlog implies (classic
    #: shaping: credit may go negative, successive packets see a growing
    #: queue).  0 = unlimited; ``burst_bytes`` is the bucket depth.
    rate_bps: float = 0.0
    burst_bytes: float = 4096.0

    def __post_init__(self) -> None:
        for f in ("drop", "duplicate", "reorder"):
            object.__setattr__(self, f, _clamp_pct(getattr(self, f)))
        for f in ("delay_ms", "jitter_ms", "reorder_delay_ms",
                  "rate_bps", "burst_bytes"):
            object.__setattr__(self, f, max(0.0, float(getattr(self, f))))

    @property
    def quiet(self) -> bool:
        return self == _CLEAN


_CLEAN = LinkConditions()

#: (drop, duplicate, delay_seconds, reordered) — what the UDP seam applies.
Decision = Tuple[bool, bool, float, bool]
_PASS: Decision = (False, False, 0.0, False)


class _LinkState:
    """Per-(key, direction) mutable state: one RNG stream + GE state +
    the bandwidth shaper's token bucket (``tokens`` may run negative =
    queued backlog; ``t_last`` is the last refill observation)."""

    __slots__ = ("rng", "ge_bad", "tokens", "t_last")

    def __init__(self, seed: int, key: str, direction: str) -> None:
        # Stable stream derivation: same seed + same key → same stream,
        # independent of creation order or how many other links exist.
        self.rng = random.Random((seed << 32) ^ crc32(f"{key}/{direction}".encode()))
        self.ge_bad = False
        self.tokens: Optional[float] = None  # None until the shaper first runs
        self.t_last = 0.0


class Schedule:
    """A time-ordered chaos scenario: ``at(t, step, ...)`` where each step
    is a ``callable(NetSim)`` built by :func:`conditions`, :func:`partition`
    or :func:`heal`.  Times are seconds from ``NetSim.run``'s start."""

    def __init__(self, desc: str = "") -> None:
        self.desc = desc
        self._steps: List[Tuple[float, Tuple[Callable, ...]]] = []

    def at(self, t: float, *steps: Callable) -> "Schedule":
        self._steps.append((float(t), steps))
        return self

    def sorted_steps(self) -> List[Tuple[float, Tuple[Callable, ...]]]:
        return sorted(self._steps, key=lambda s: s[0])


def conditions(key: Optional[str] = None, **kw) -> Callable:
    """Schedule step: set (or with no kwargs, clear) link conditions.
    The LinkConditions is built HERE, so a typo'd kwarg fails fast at
    schedule-construction time, not mid-run on an event-loop thread."""
    cond = LinkConditions(**kw)
    return lambda sim: sim.install_conditions(key, cond)


def partition(key: Optional[str] = None, direction: str = "both") -> Callable:
    """Schedule step: blackhole an endpoint's tx/rx/both directions."""
    return lambda sim: sim.partition(key, direction)


def heal(key: Optional[str] = None) -> Callable:
    """Schedule step: lift partitions (and only partitions)."""
    return lambda sim: sim.heal(key)


class NetSim:
    """The process-global chaos decision engine (see module docstring).

    The UDP seam asks ``on_send``/``on_recv`` for every packet; both are
    no-ops (``_enabled`` fast path, no lock) until something is installed.
    All mutation and decisions serialize on one lock, so decision traces
    are well-defined even with several event-loop threads in flight.
    """

    def __init__(self) -> None:
        from .faults import env_chaos_seed

        self._lock = threading.Lock()
        # Serializes schedule-step application so overdue steps always
        # apply in time order even when several event-loop threads race
        # through _advance (replayability depends on it).
        self._sched_lock = threading.Lock()
        self._seed = env_chaos_seed() or 0  # guarded-by: _lock
        self._default: LinkConditions = _CLEAN  # guarded-by: _lock
        self._per_key: Dict[str, LinkConditions] = {}  # guarded-by: _lock
        # Partitioned endpoint keys per direction; None = everyone.
        self._part_tx: set = set()  # guarded-by: _lock
        self._part_rx: set = set()  # guarded-by: _lock
        self._states: Dict[Tuple[str, str], _LinkState] = {}  # guarded-by: _lock
        self._counters: Dict[str, int] = {}  # guarded-by: _lock
        self._trace: Optional[List[Tuple]] = None  # guarded-by: _lock
        self._schedule: List[Tuple[float, Tuple[Callable, ...]]] = []  # guarded-by: _lock
        self._sched_idx = 0  # guarded-by: _lock
        self._loop_every: Optional[float] = None  # guarded-by: _lock
        self._t0 = 0.0  # guarded-by: _lock
        self._clock: Callable[[], float] = time.monotonic  # guarded-by: _lock
        self._enabled = False  # guarded-by: _lock

    # ------------------------------------------------------------- lifecycle

    def seed(self, s: int) -> None:
        """Re-seed every link stream (existing states are discarded so the
        streams re-derive deterministically from the new seed)."""
        with self._lock:
            self._seed = int(s)
            self._states.clear()

    def reset(self) -> None:
        """Back to a clean, disabled network.  The seed survives (a replay
        wants reset-then-run with the same seed)."""
        with self._lock:
            self._default = _CLEAN
            self._per_key.clear()
            self._part_tx.clear()
            self._part_rx.clear()
            self._states.clear()
            self._counters.clear()
            self._trace = None
            self._schedule = []
            self._sched_idx = 0
            self._loop_every = None
            self._enabled = False

    def record_trace(self, enable: bool = True) -> None:
        with self._lock:
            self._trace = [] if enable else None

    @property
    def trace(self) -> List[Tuple]:
        with self._lock:
            return list(self._trace or ())

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # ------------------------------------------------------------ conditions

    def set_conditions(self, key: Optional[str] = None, **kw) -> None:
        """Install :class:`LinkConditions` fields for ``key`` (an endpoint
        label, a role ``"client"``/``"server"``, or None = the default for
        everyone).  Partitions are orthogonal (:meth:`partition` /
        :meth:`heal`) and unaffected; no kwargs means "clean link"."""
        self.install_conditions(key, LinkConditions(**kw))

    def install_conditions(
        self, key: Optional[str], cond: LinkConditions
    ) -> None:
        with self._lock:
            if key is None:
                self._default = cond
            elif cond.quiet:
                self._per_key.pop(key, None)
            else:
                self._per_key[key] = cond
            self._refresh_enabled()

    def partition(self, key: Optional[str] = None, direction: str = "both") -> None:
        if direction not in ("tx", "rx", "both"):
            raise ValueError(f"direction must be tx/rx/both, got {direction!r}")
        with self._lock:
            if direction in ("tx", "both"):
                self._part_tx.add(key)
            if direction in ("rx", "both"):
                self._part_rx.add(key)
            self._refresh_enabled()

    def heal(self, key: Optional[str] = None) -> None:
        """Lift partitions for ``key`` (None = every partition, global and
        per-endpoint); other installed conditions (loss, delay, ...) stay."""
        with self._lock:
            if key is None:
                self._part_tx.clear()
                self._part_rx.clear()
            else:
                self._part_tx.discard(key)
                self._part_rx.discard(key)
            self._refresh_enabled()

    def _conditions_locked(self, key: Optional[str], role: Optional[str] = None):
        if key is not None and key in self._per_key:
            return self._per_key[key]
        if role is not None and role in self._per_key:
            return self._per_key[role]
        return self._default

    def _partitioned_locked(self, parts: set, key: str, role: str) -> bool:
        return None in parts or key in parts or role in parts

    def _refresh_enabled(self) -> None:  # guarded-by: _lock
        self._enabled = bool(
            self._per_key
            or not self._default.quiet
            or self._part_tx
            or self._part_rx
            or self._schedule
        )

    # -------------------------------------------------------------- schedule

    def run(
        self,
        schedule: Schedule,
        clock: Callable[[], float] = time.monotonic,
        loop_every: Optional[float] = None,
    ) -> None:
        """Arm a scenario: steps apply lazily as packet events observe the
        clock passing their times (steps at t<=0 apply immediately).

        ``loop_every=N`` replays the scenario every N seconds instead of
        disarming after the last step — sustained chaos for long runs
        (the server's ``BMT_CHAOS_LOOP``), still fully deterministic: the
        per-link RNG streams keep advancing across wraps."""
        if loop_every is not None and loop_every <= 0:
            raise ValueError(f"loop_every must be positive, got {loop_every}")
        with self._lock:
            self._schedule = schedule.sorted_steps()
            self._sched_idx = 0
            self._loop_every = loop_every
            self._clock = clock
            # Local alias: _advance below runs off-lock and must not read
            # the field back (the lock pass flagged exactly that).
            self._t0 = t0 = clock()
            self._enabled = True
        self._advance(t0)

    def _advance(self, now: float) -> None:
        """Apply every scheduled step whose time has come.  Steps call the
        public mutators, which take the state lock — so the pop/apply loop
        holds only ``_sched_lock``, which also serializes racing threads:
        overdue steps always apply in time order, whichever packet event
        observes them."""
        with self._sched_lock:
            while True:
                with self._lock:
                    if self._sched_idx >= len(self._schedule):
                        if not self._schedule:
                            return
                        if self._loop_every is not None:
                            if now - self._t0 < self._loop_every:
                                return  # wrap point not reached yet
                            # Replay: shift the scenario origin one period
                            # forward and fall through to re-apply steps.
                            self._t0 += self._loop_every
                            self._sched_idx = 0
                            continue
                        # Scenario over: drop it so a fully-healed
                        # network re-disarms the per-packet fast path.
                        self._schedule = []
                        self._sched_idx = 0
                        self._refresh_enabled()
                        return
                    t, steps = self._schedule[self._sched_idx]
                    if now - self._t0 < t:
                        return
                    self._sched_idx += 1
                for step in steps:
                    step(self)

    # ------------------------------------------------------------- decisions

    def on_send(
        self, label: Optional[str], is_server: bool, size: int = 0
    ) -> Decision:
        """Decide one outbound packet's fate.  Called by UDPEndpoint.send;
        ``size`` is the datagram's byte length (the bandwidth shaper's
        charge — 0 from legacy callers means shaping never engages)."""
        if not self._enabled:  # unguarded: benign racy fast path — a stale False costs one clean packet, never a wrong decision
            return _PASS
        if self._schedule:  # unguarded: racy peek; _advance re-checks under _lock
            self._advance(self._clock())  # unguarded: _clock is set once per run()
        role = "server" if is_server else "client"
        key = label or role
        with self._lock:
            if self._partitioned_locked(self._part_tx, key, role):
                return self._note(key, "tx", "partitioned", (True, False, 0.0, False))
            cond = self._conditions_locked(key if label else None, role)
            if cond.quiet:
                return _PASS
            st = self._state_locked(key, "tx")
            rng = st.rng
            drop = False
            if cond.ge is not None:
                ge = cond.ge
                if st.ge_bad:
                    if rng.random() * 100.0 < ge.p_exit_bad:
                        st.ge_bad = False
                else:
                    if rng.random() * 100.0 < ge.p_enter_bad:
                        st.ge_bad = True
                loss = ge.loss_bad if st.ge_bad else ge.loss_good
                drop = loss > 0 and rng.random() * 100.0 < loss
            if not drop and cond.drop > 0:
                drop = rng.random() * 100.0 < cond.drop
            if drop:
                return self._note(key, "tx", "dropped", (True, False, 0.0, False))
            dup = cond.duplicate > 0 and rng.random() * 100.0 < cond.duplicate
            delay = 0.0
            if cond.delay_ms > 0 or cond.jitter_ms > 0:
                delay = max(
                    0.0,
                    (cond.delay_ms + rng.uniform(-1.0, 1.0) * cond.jitter_ms)
                    / 1000.0,
                )
            reordered = cond.reorder > 0 and rng.random() * 100.0 < cond.reorder
            if reordered:
                delay += cond.reorder_delay_ms / 1000.0
            if cond.rate_bps > 0 and size > 0:
                # Token-bucket shaping: refill since the last packet (to
                # the burst cap), charge this one; a negative balance is
                # the queue, and the time to pay it back is the queueing
                # delay — so a gossip or telemetry link capped at N bytes/s
                # degrades to lag, not loss.
                now_s = self._clock()
                if st.tokens is None:
                    st.tokens = cond.burst_bytes
                else:
                    st.tokens = min(
                        cond.burst_bytes,
                        st.tokens + (now_s - st.t_last) * cond.rate_bps,
                    )
                st.t_last = now_s
                st.tokens -= size
                if st.tokens < 0:
                    delay += -st.tokens / cond.rate_bps
                    self._count("throttled")
            if dup:
                self._count("duplicated")
            if reordered:
                self._count("reordered")
            if delay > 0:
                self._count("delayed")
            decision = (False, dup, delay, reordered)
            if self._trace is not None:
                self._trace.append((key, "tx", decision))
            return decision

    def on_recv(self, label: Optional[str], is_server: bool) -> bool:
        """True if this inbound packet should be discarded — rx partitions
        only; loss/delay/reorder/dup are all modeled on the tx side (any
        A→B link is shaped at A's tx, severed at either end)."""
        if not self._enabled:  # unguarded: benign racy fast path (see on_send)
            return False
        if self._schedule:  # unguarded: racy peek; _advance re-checks under _lock
            self._advance(self._clock())  # unguarded: _clock is set once per run()
        role = "server" if is_server else "client"
        key = label or role
        with self._lock:
            if self._partitioned_locked(self._part_rx, key, role):
                self._note(key, "rx", "partitioned", None)
                return True
            return False

    def _state_locked(self, key: str, direction: str) -> _LinkState:
        st = self._states.get((key, direction))
        if st is None:
            st = self._states[(key, direction)] = _LinkState(
                self._seed, key, direction
            )
        return st

    def _count(self, what: str) -> None:  # guarded-by: _lock
        self._counters[what] = self._counters.get(what, 0) + 1
        METRICS.inc(f"chaos.{what}")  # metric-ok: chaos.*

    def _note(self, key, direction, what, decision):  # guarded-by: _lock
        self._count(what)
        if self._trace is not None:
            self._trace.append((key, direction, what))
        return decision


#: The process-global simulator the UDP seam consults.
CHAOS = NetSim()


def standard_scenarios(epoch_seconds: float = 0.1) -> Dict[str, Schedule]:
    """The named chaos schedules of the drill (``apps.drill``) and the
    server's ``BMT_CHAOS_SCENARIO``.  Each combines several failure modes;
    times are scaled off the fleet's epoch so the scenarios stress the
    retransmit machinery rather than just waiting it out."""
    e = epoch_seconds
    return {
        # Correlated loss: ~18% average in bursts ~10 packets long, for 6
        # epochs, then heal — the regime where i.i.d.-loss assumptions die.
        "burst-loss": Schedule("Gilbert–Elliott burst loss, then heal")
        .at(0.0, conditions(ge=GEParams(p_enter_bad=2, p_exit_bad=10, loss_bad=90)))
        .at(6 * e, conditions()),
        # A jittery, reordering, duplicating link for the whole run.
        "reorder-dup-delay": Schedule("delay+jitter, 20% reorder, 15% dup")
        .at(0.0, conditions(delay_ms=5, jitter_ms=8, reorder=20, duplicate=15,
                            reorder_delay_ms=25)),
        # Heavy loss, heal, one-way server blackout for 2 epochs, heal.
        "flaky-then-partition": Schedule("40% loss, heal; server tx cut 2 epochs")
        .at(0.0, conditions(drop=40))
        .at(4 * e, conditions())
        .at(6 * e, partition("server", "tx"))
        .at(8 * e, heal("server")),
        # One miner fully isolated long enough to be declared lost, then
        # healed — exercises reassignment + (with a resilient miner) re-Join.
        "miner-partition": Schedule("miner-1 isolated past epoch limit, heals")
        .at(0.0, conditions(delay_ms=2, jitter_ms=3))
        .at(2 * e, partition("miner-1", "both"))
        .at(16 * e, heal("miner-1")),
    }
