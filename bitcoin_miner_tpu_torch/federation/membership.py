"""Membership + failure detection for the federation tier.

With liveness left to the forwarder's connect timeout alone, a peer that
SHED a forwarded request (admission backpressure) would be
indistinguishable from a dead peer, so a healthy-but-busy home would be
marked down for the whole ``peer_down_ttl`` and its keys sprayed along
the ring.  This module is the membership plane:

- Every gossip beat piggybacks a **heartbeat** — ``(incarnation,
  load_state, journal high-water)`` — and the gossip daemon sends a
  cheap standalone beat even when there are no spans to ship, so a
  quiet cell still proves liveness every interval.
- :class:`Membership` is a **suspicion-based failure detector**: a peer
  whose heartbeats stop is first SUSPECT (``suspect_misses`` missed
  intervals), and only DEAD after a further confirmation window
  (``confirm_misses`` more) — one lost datagram never declares a death,
  and a suspect that beats again before confirmation counts a
  ``fed.false_suspicions`` (the shed-storm acceptance number: zero).
- **Load states** travel with the heartbeat: ``OK`` / ``SHEDDING``
  (admission backpressure — alive, deprioritize) / ``DRAINING``
  (graceful shutdown in progress — alive, stop sending new work).
  :meth:`Membership.order` re-ranks a ring preference order by load so
  a SHEDDING peer is *last resort*, not a death sentence, and a
  DRAINING peer gets no new forwards at all.

Incarnations disambiguate restarts: a peer that comes back with a higher
incarnation restarted — its gossip journal sequence space is fresh, so
the caller must reset per-peer ack bookkeeping (:class:`Membership`
reports the reset; the gossip store owns the bookkeeping).

Thread-safe (own lock): the gossip daemon ticks it, the federation
ingest thread feeds it heartbeats, and the forwarder pool reads it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..utils.metrics import METRICS

#: Load states a cell advertises in its heartbeat.
LOAD_OK = "OK"
LOAD_SHEDDING = "SHEDDING"
LOAD_DRAINING = "DRAINING"
_LOAD_STATES = (LOAD_OK, LOAD_SHEDDING, LOAD_DRAINING)

#: Liveness verdicts the failure detector assigns.
ALIVE = "ALIVE"
SUSPECT = "SUSPECT"
DEAD = "DEAD"

#: Numeric codes for the ``fed.peer_state.<peer>`` gauges (dash/health
#: line): higher is worse.
STATE_CODES = {
    (ALIVE, LOAD_OK): 0,
    (ALIVE, LOAD_SHEDDING): 1,
    (ALIVE, LOAD_DRAINING): 2,
    (SUSPECT, None): 3,
    (DEAD, None): 4,
}


def state_code(liveness: str, load: str) -> int:
    if liveness == ALIVE:
        return STATE_CODES.get((ALIVE, load), 0)
    return STATE_CODES[(liveness, None)]


class _Peer:
    __slots__ = ("last_heard", "load", "incarnation", "liveness")

    def __init__(self, now: float) -> None:
        self.last_heard = now
        self.load = LOAD_OK
        self.incarnation = -1  # nothing heard yet
        self.liveness = ALIVE


class Membership:
    """The per-replica membership table (see module docstring).

    ``interval`` is the heartbeat cadence peers promise (the gossip
    interval every cell of one federation shares); suspicion windows are
    multiples of it, so retuning the gossip cadence retunes detection.
    """

    def __init__(
        self,
        cell: str,
        peers: Sequence[str],
        interval: float = 1.0,
        suspect_misses: float = 3.0,
        confirm_misses: float = 3.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self.cell = cell
        self.interval = interval
        self.suspect_after = suspect_misses * interval
        self.confirm_after = confirm_misses * interval
        self._clock = clock
        self._lock = threading.Lock()
        now = clock()
        # Grace at birth: a peer still booting is given the full suspect
        # window before its silence counts against it.
        self._peers: Dict[str, _Peer] = {  # guarded-by: _lock
            name: _Peer(now) for name in peers
        }

    # ------------------------------------------------------------------ inputs

    def heard(
        self, peer: str, load: str, incarnation: int, now: Optional[float] = None
    ) -> bool:
        """Record one heartbeat from ``peer``.  Returns True when the
        peer RESTARTED (incarnation advanced) — the caller must reset its
        per-peer gossip ack bookkeeping, because the peer's journal
        sequence space started over."""
        now = self._clock() if now is None else now
        if load not in _LOAD_STATES:
            load = LOAD_OK  # skew-tolerant: an unknown state is "alive"
        with self._lock:
            p = self._peers.get(peer)
            if p is None:
                return False  # not a configured peer: ignore
            restarted = p.incarnation >= 0 and incarnation > p.incarnation
            p.incarnation = max(p.incarnation, incarnation)
            p.last_heard = now
            p.load = load
            if p.liveness == SUSPECT:
                # It was alive all along: the suspicion was wrong.  The
                # shed-storm acceptance pins this counter at zero — a
                # peer beating on time must never reach SUSPECT at all.
                METRICS.inc("fed.false_suspicions")
            p.liveness = ALIVE
        METRICS.inc("fed.heartbeats")
        return restarted

    def tick(self, now: Optional[float] = None) -> None:
        """Advance the failure detector: silence past the suspect window
        marks SUSPECT; a further confirmation window marks DEAD."""
        now = self._clock() if now is None else now
        with self._lock:
            for name, p in self._peers.items():
                silent = now - p.last_heard
                if p.liveness == ALIVE and silent > self.suspect_after:
                    p.liveness = SUSPECT
                    METRICS.inc("fed.suspected")
                if (
                    p.liveness == SUSPECT
                    and silent > self.suspect_after + self.confirm_after
                ):
                    p.liveness = DEAD
        self.publish_gauges()

    # ----------------------------------------------------------------- queries

    def liveness(self, peer: str) -> str:
        with self._lock:
            p = self._peers.get(peer)
            return p.liveness if p is not None else DEAD

    def load(self, peer: str) -> str:
        with self._lock:
            p = self._peers.get(peer)
            return p.load if p is not None else LOAD_OK

    def fresh(self, peer: str) -> bool:
        """True when ``peer`` has PROVEN liveness recently: at least one
        heartbeat ever, the latest inside the suspect window, and not
        under suspicion.  The forwarder's shed-vs-death discriminator —
        a refused forward from a fresh peer is backpressure, not death,
        so the peer must not be marked down."""
        now = self._clock()
        with self._lock:
            p = self._peers.get(peer)
            return (
                p is not None
                and p.liveness == ALIVE
                and p.incarnation >= 0
                and now - p.last_heard <= self.suspect_after
            )

    def is_alive(self, peer: str) -> bool:
        """Alive-for-routing: ALIVE or SUSPECT (a suspect may yet beat;
        only a confirmed death drops it from the ring's alive view)."""
        return self.liveness(peer) != DEAD

    def routable(self) -> List[str]:
        """Names ``Ring.route(alive=)`` should keep: every configured
        peer not confirmed DEAD, plus this cell itself (the ring view
        must include self or local keys would re-home)."""
        with self._lock:
            names = [
                n for n, p in self._peers.items() if p.liveness != DEAD
            ]
        names.append(self.cell)
        return names

    def order(self, names: Sequence[str]) -> List[str]:
        """Re-rank a ring preference order by membership: healthy ALIVE
        peers first (ring order preserved within a rank), SHEDDING peers
        after them (deprioritized, never dead), SUSPECT last resort;
        DRAINING and DEAD peers are dropped — a draining cell stopped
        admitting and a dead one cannot answer."""
        ranked: List[tuple] = []
        with self._lock:
            for i, name in enumerate(names):
                p = self._peers.get(name)
                if p is None:
                    continue
                if p.liveness == DEAD or (
                    p.liveness == ALIVE and p.load == LOAD_DRAINING
                ):
                    continue
                rank = 0
                if p.liveness == ALIVE and p.load == LOAD_SHEDDING:
                    rank = 1
                elif p.liveness == SUSPECT:
                    rank = 2
                ranked.append((rank, i, name))
        ranked.sort()
        return [name for _, _, name in ranked]

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-peer ``{liveness, load, incarnation, silent_s}`` — the
        health-line / drill surface."""
        now = self._clock()
        with self._lock:
            return {
                name: {
                    "liveness": p.liveness,
                    "load": p.load,
                    "incarnation": p.incarnation,
                    "silent_s": max(0.0, now - p.last_heard),
                }
                for name, p in self._peers.items()
            }

    def publish_gauges(self) -> None:
        """``fed.peer_state.<peer>`` gauges for the health line, the
        fleet view and the dashboard's cell view."""
        with self._lock:
            codes = {
                name: state_code(p.liveness, p.load)
                for name, p in self._peers.items()
            }
        for name, code in codes.items():
            METRICS.set_gauge(f"fed.peer_state.{name}", code)  # metric-ok: fed.peer_state
