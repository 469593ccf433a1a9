"""Result stores — solved work answers without device work.

Two stores, two granularities:

- :class:`ResultCache` — exact-signature LRU: the argmin over a fixed
  ``(data, lower, upper)`` range is a pure function, so a completed job's
  ``(hash, nonce)`` is cacheable forever under that signature — the same
  identity the scheduler's checkpoint/orphan resume machinery keys on.
- :class:`SpanStore` — the interval-algebra result store: as
  *chunks* complete, their ``[lo, hi] -> (min_hash, nonce)`` folds land
  in a per-data :class:`~bitcoin_miner_tpu_torch.utils.intervals.IntervalMap`.
  A new request is planned against the solved spans (``cover``): fully
  covered ranges answer by folding span minima with zero device work
  (``gateway.span_hits``); partially covered ranges sweep only the
  uncovered gaps as a remainder job.  LRU over data keys bounds memory;
  each map's span budget coalesces adjacent spans under pressure.

The gateway consults both before anything touches the scheduler: a repeat
of a solved job — or any sub-range the fleet has already hashed — costs
dictionary lookups and one Result send, zero chunks assigned.

In-memory LRU with optional disk persistence through the shared atomic
temp-write + rename path (utils/persist.py — the same torn-write contract
as the scheduler checkpoint).  Persistence is dirty-flagged, not
write-through: mutations mark the cache dirty and the server shell's
ticker snapshots+writes at most once per tick (``flush()`` under the
event lock, ``save_json_atomic`` outside it — the same cadence as the
scheduler checkpoint), so completing a job costs O(1) disk work instead
of rewriting an up-to-capacity file on the hot path.  A restarted
gateway reloads the file, so solved-job answers survive fleet restarts
alongside the scheduler's partial-progress checkpoint.  Evictions bump
``gateway.cache_evictions``; hit/miss accounting lives in the gateway
(it knows why it asked).

Both files are the reference package's formats byte for byte (the same
``stamp_state`` envelope and row layout), so either package's gateway
reloads what the other wrote.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..utils.intervals import Interval, IntervalMap
from ..utils.metrics import METRICS
from ..utils.persist import load_json, save_json_atomic
from ..workloads import DEFAULT_WORKLOAD, stamp_state, unwrap_state

JobKey = Tuple[str, int, int]  # (data, lower, upper) — the job signature


class ResultCache:
    """LRU of job signature -> ``(hash, nonce)``.  ``capacity=0`` disables
    storage (every ``get`` misses); ``path`` arms write-through persistence.
    Not thread-safe by itself — the gateway serializes access under the
    server shell's event lock, like every other policy structure."""

    def __init__(
        self,
        capacity: int = 1024,
        path: Optional[str] = None,
        workload: Optional[str] = None,
    ) -> None:
        self.capacity = max(0, int(capacity))
        self.path = path
        # Cached (hash, nonce) pairs are facts about ONE hash function:
        # the file is stamped with its workload name and a store serving
        # a different workload starts empty instead of answering with
        # another function's minima.  None = frozen default,
        # which also owns pre-registry (unstamped) files.
        self.workload_name = workload or DEFAULT_WORKLOAD
        self._entries: "OrderedDict[JobKey, Tuple[int, int]]" = OrderedDict()
        self._dirty = False
        if path is not None:
            self._load(path)

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: JobKey) -> Optional[Tuple[int, int]]:
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)  # LRU freshness
        return hit

    def put(self, key: JobKey, hash_: int, nonce: int) -> None:
        if self.capacity == 0:
            return
        self._entries[key] = (hash_, nonce)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            METRICS.inc("gateway.cache_evictions")
        self._dirty = True

    # ------------------------------------------------------------ persistence

    def _serialize(self) -> dict:
        return stamp_state(
            {
                # LRU order (oldest first) so a reload evicts the same way.
                "entries": [
                    [k[0], k[1], k[2], h, n]
                    for k, (h, n) in self._entries.items()
                ],
            },
            self.workload_name,
        )

    def flush(self) -> Optional[dict]:
        """The serializable state if dirty (clears the flag), else None.
        The shell snapshots this under its event lock and hands the dict
        to ``save_json_atomic`` outside it — write amortized to its tick,
        never on the per-job hot path.  If that write FAILS, the shell
        must call :meth:`mark_dirty` so the next tick retries (the same
        only-advance-on-success contract as the checkpoint's saved_rev)."""
        if not self._dirty:
            return None
        self._dirty = False
        return self._serialize()

    def mark_dirty(self) -> None:
        self._dirty = True

    def save(self, path: str) -> None:
        self._dirty = False
        save_json_atomic(path, self._serialize())

    def _load(self, path: str) -> None:
        # Missing/torn file OR another workload's minima: start empty
        # (non-default payloads are nested — see workloads.stamp_state).
        state = unwrap_state(load_json(path), self.workload_name)
        if state is None:
            return
        for entry in state.get("entries", ()):
            try:
                data, lower, upper, h, n = entry
            except (TypeError, ValueError):
                continue  # one bad row must not poison the rest
            if not (isinstance(data, str) and all(
                isinstance(v, int) and not isinstance(v, bool)
                for v in (lower, upper, h, n)
            )):
                continue
            self._entries[(data, lower, upper)] = (h, n)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)


class SpanStore:
    """Per-data interval maps of solved spans (see module docstring).

    ``capacity`` bounds the number of *data keys* (LRU eviction,
    ``gateway.span_evictions``); ``max_spans_per_data`` is each map's
    span budget (adjacent-coalesce under pressure).  ``capacity=0``
    disables the store entirely (every ``cover`` reports the whole query
    as a gap) — the exact-match-cache-only comparison leg.  ``path`` arms
    disk persistence through the same dirty-flag + atomic-write contract
    as :class:`ResultCache` (flushed by ``serve()``'s ticker).  Not
    thread-safe by itself — the gateway serializes access under the
    server shell's event lock, like every other policy structure."""

    #: Decayed hotness below this is cold again: the key stops competing
    #: for idle prefill capacity (one fresh hit sits at 1.0, so a single
    #: half-life idles a one-hit key out).
    HOT_MIN = 0.5

    def __init__(
        self,
        capacity: int = 512,
        max_spans_per_data: int = 64,
        path: Optional[str] = None,
        workload: Optional[str] = None,
        hot_half_life_s: Optional[float] = 600.0,
        clock=time.monotonic,
    ) -> None:
        self.capacity = max(0, int(capacity))
        self.max_spans_per_data = max(1, int(max_spans_per_data))
        self.path = path
        # Same per-workload stamp contract as ResultCache.
        self.workload_name = workload or DEFAULT_WORKLOAD
        self._maps: "OrderedDict[str, IntervalMap]" = OrderedDict()
        # Hotness: per-data cover()-reuse score — the
        # speculative-prefill planner sweeps gaps adjacent to the HOTTEST
        # keys first.  Recency-weighted: scores
        # decay with ``hot_half_life_s`` (None disables), so a
        # formerly-hot key stops hogging idle prefill capacity and a
        # newly-hot one overtakes it.  Ephemeral (not persisted):
        # hotness is a property of the query stream, not of solved work.
        self.hot_half_life_s = hot_half_life_s
        self._clock = clock
        self._hits: Dict[str, Tuple[float, float]] = {}  # data -> (score, t)
        self._prefilled: dict = {}  # data -> nonces speculatively extended
        self._ext_live: dict = {}  # data -> charged-but-unswept extension
        self._dirty = False
        if path is not None:
            self._load(path)

    def _hot(self, data: str, now: Optional[float] = None) -> float:
        """The decayed hotness score (0.0 for a never-hit key)."""
        ent = self._hits.get(data)
        if ent is None:
            return 0.0
        score, t = ent
        if not self.hot_half_life_s:
            return score
        now = self._clock() if now is None else now
        return score * 0.5 ** (max(0.0, now - t) / self.hot_half_life_s)

    def _mark_hot(self, data: str) -> None:
        now = self._clock()
        self._hits[data] = (self._hot(data, now) + 1.0, now)

    def __len__(self) -> int:
        """Total solved spans across every data key."""
        return sum(len(m) for m in self._maps.values())

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    def data_count(self) -> int:
        return len(self._maps)

    def add(self, data: str, lo: int, hi: int, hash_: int, nonce: int) -> None:
        if self.capacity == 0:
            return
        m = self._maps.get(data)
        if m is None:
            m = self._maps[data] = IntervalMap(self.max_spans_per_data)
        self._maps.move_to_end(data)  # LRU freshness
        lost_before = m.lost_answerability
        m.add(lo, hi, hash_, nonce)
        if m.lost_answerability > lost_before:
            # Budget shrinking erased sub-range resolution: make the
            # coalescing policy observable.
            METRICS.inc(
                "gateway.coalesce_lost", m.lost_answerability - lost_before
            )
        while len(self._maps) > self.capacity:
            gone, _ = self._maps.popitem(last=False)
            self._hits.pop(gone, None)
            self._prefilled.pop(gone, None)
            self._ext_live.pop(gone, None)
            METRICS.inc("gateway.span_evictions")
        self._dirty = True

    def cover(
        self, data: str, lo: int, hi: int
    ) -> Tuple[Optional[Tuple[int, int]], List[Interval]]:
        """Plan ``[lo, hi]`` against ``data``'s solved spans:
        ``(folded best over answerable portions, uncovered gaps)`` — see
        :meth:`IntervalMap.cover` for the answerability rule."""
        m = self._maps.get(data)
        if m is None:
            return None, ([(lo, hi)] if lo <= hi else [])
        self._maps.move_to_end(data)
        best, gaps = m.cover(lo, hi)
        if best is not None:
            # A plan that reused solved spans marks the key hot — the
            # speculative-prefill planner's ranking signal.
            self._mark_hot(data)
        return best, gaps

    def prefill_target(
        self, size: int, max_extend: Optional[int] = None
    ) -> Optional[Tuple[str, int, int]]:
        """The next speculative gap worth sweeping while the fleet idles
        for the hottest data keys (span-hit counters, hottest
        first), internal gaps between solved spans come first — they are
        what keeps overlapping queries from answering whole — then an
        extension of ``size`` nonces past the top span, bounded per key
        by ``max_extend`` (default ``8 × size``) so an idle fleet never
        sweeps a key toward u64 forever.  Cold keys (no span reuse
        observed) are never speculated on."""
        if self.capacity == 0 or size <= 0:
            return None
        cap = max_extend if max_extend is not None else 8 * size
        now = self._clock()
        hot = {d: self._hot(d, now) for d in self._hits}
        for data in sorted(hot, key=lambda d: -hot[d]):
            m = self._maps.get(data)
            if m is None or hot[data] < self.HOT_MIN:
                # Decayed cold: a key nobody reuses anymore must not hog
                # idle prefill capacity.
                continue
            spans = m.spans()
            if not spans:
                continue
            for i in range(len(spans) - 1):
                g_lo, g_hi = spans[i][1] + 1, spans[i + 1][0] - 1
                if g_lo <= g_hi:
                    return (data, g_lo, min(g_hi, g_lo + size - 1))
            ext = self._prefilled.get(data, 0)
            if ext >= cap:
                continue
            lo = spans[-1][1] + 1
            if lo >= 1 << 64:
                continue
            hi = min(lo + size - 1, (1 << 64) - 1)
            self._prefilled[data] = ext + (hi - lo + 1)
            self._ext_live[data] = (lo, hi)
            return (data, lo, hi)
        return None

    def prefill_refund(self, data: str, lo: int, hi: int) -> None:
        """Return the UNSWEPT portion of a preempted extension target to
        the per-key budget.  :meth:`prefill_target` charges the whole
        planned range up front (so one in-flight speculation can't be
        re-planned past the cap); without the refund, a request cadence
        that keeps preempting speculation before its first chunk lands
        burns the entire extension cap without sweeping anything —
        permanently disabling prefill for exactly the hot keys it
        targets.  Gap targets were never charged, so only the recorded
        live extension refunds (anything else is a no-op)."""
        if self._ext_live.get(data) != (lo, hi):
            return  # gap target (never charged) or stale record: no-op
        del self._ext_live[data]
        covered = 0
        m = self._maps.get(data)
        if m is not None:
            for s in m.spans():
                s_lo, s_hi = s[0], s[1]
                if s_hi < lo:
                    continue
                if s_lo > hi:
                    break
                covered += min(hi, s_hi) - max(lo, s_lo) + 1
        ext = self._prefilled.get(data, 0) - ((hi - lo + 1) - covered)
        if ext > 0:
            self._prefilled[data] = ext
        else:
            self._prefilled.pop(data, None)

    # ------------------------------------------------------------ persistence

    def _serialize(self) -> dict:
        return stamp_state(
            {
                # LRU order (oldest first) so a reload evicts the same way.
                "data": [
                    [data, [list(s) for s in m.spans()]]
                    for data, m in self._maps.items()
                ],
            },
            self.workload_name,
        )

    def flush(self) -> Optional[dict]:
        """Same contract as :meth:`ResultCache.flush`: the serializable
        state if dirty (clears the flag), else None; the shell writes it
        outside the event lock and re-arms the flag on failure."""
        if not self._dirty:
            return None
        self._dirty = False
        return self._serialize()

    def mark_dirty(self) -> None:
        self._dirty = True

    def save(self, path: str) -> None:
        self._dirty = False
        save_json_atomic(path, self._serialize())

    def _load(self, path: str) -> None:
        # Missing/torn file OR another workload's minima: start empty
        # (non-default payloads are nested — see workloads.stamp_state).
        state = unwrap_state(load_json(path), self.workload_name)
        if state is None:
            return
        for entry in state.get("data", ()):
            try:
                data, rows = entry
            except (TypeError, ValueError):
                continue  # one bad row must not poison the rest
            if not (isinstance(data, str) and isinstance(rows, list)):
                continue
            for row in rows:
                try:
                    lo, hi, h, n = row
                except (TypeError, ValueError):
                    continue
                if not all(
                    isinstance(v, int) and not isinstance(v, bool)
                    for v in (lo, hi, h, n)
                ):
                    continue
                # add() re-validates span shape and restores disjointness.
                self.add(data, lo, hi, h, n)
        self._dirty = False  # a fresh load is already on disk
