"""The one start-time virtual-clock WFQ primitive.

A copy of the reference package's ``utils/wfq.py``: the scheduler's tenant
fair queue (``Scheduler._tenant_add``/``_next_job``: nonce granularity,
variable charge per carved chunk) runs on it.  The floor-init and
tie-break rules are the correctness surface (a tenant arriving at vt=0
starves incumbents; a tenant inheriting the max vt is itself starved), so
they live here and nowhere else.

The discipline, in full:

- Each **principal** (tenant / client key) owns a deque of opaque items
  and a virtual time ``vt``; serving charges ``cost / weight``.
- **Selection** takes the lowest ``(vt, seq)`` among principals with
  items — ``seq`` is creation order, so ties break deterministically.
- **Floor init**: a newly active principal starts at the minimum ``vt``
  of the active principals (0.0 when none): it can neither starve
  incumbents by arriving with zero debt nor inherit charges it never
  incurred.
- A principal whose deque empties is dropped; re-adding re-applies the
  floor rule (no starvation debt survives an idle period).

Not thread-safe: callers serialize, like every policy structure (the
serve-loop event lock).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, Iterator, Optional, Tuple

#: Weights are clamped to this floor so a zero/negative weight cannot make
#: a charge divide by zero or run time backwards.
MIN_WEIGHT = 1e-9


class Principal:
    """One fair-queue principal: the unit the clock shares service across."""

    __slots__ = ("key", "weight", "vt", "seq", "items")

    def __init__(self, key: str, weight: float, vt: float, seq: int) -> None:
        self.key = key
        self.weight = weight
        self.vt = vt  # virtual time: sum of charged cost / weight
        self.seq = seq  # creation order (deterministic vt tie-break)
        self.items: Deque[Any] = deque()


class VirtualClockWFQ:
    """Weighted fair queue of opaque items across string keys.

    ``__len__`` is the total item backlog across every key (the gateway's
    overflow bound); ``key_count()`` is the number of active principals
    (the scheduler's ``tenants`` stat).
    """

    def __init__(self) -> None:
        self._principals: Dict[str, Principal] = {}
        self._seq = 0
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def key_count(self) -> int:
        return len(self._principals)

    def vt_floor(self) -> float:
        """The minimum active virtual time — the clock's leading edge
        (0.0 when idle).  Telemetry only (the WFQ virtual-clock gauges);
        selection never reads it."""
        return min(
            (p.vt for p in self._principals.values() if p.items),
            default=0.0,
        )

    def principals(self) -> Iterator[Principal]:
        return iter(self._principals.values())

    # ---------------------------------------------------------------- mutate

    def add(self, key: str, item: Any, weight: float = 1.0) -> Principal:
        """Append ``item`` to ``key``'s deque, creating the principal at the
        active-vt floor; an existing principal's weight is updated (latest
        submission's weight wins)."""
        p = self._principals.get(key)
        if p is None:
            floor = min(
                (x.vt for x in self._principals.values() if x.items),
                default=0.0,
            )
            p = self._principals[key] = Principal(
                key, max(weight, MIN_WEIGHT), floor, self._seq
            )
            self._seq += 1
        else:
            p.weight = max(weight, MIN_WEIGHT)
        p.items.append(item)
        self._len += 1
        return p

    def charge(self, key: str, cost: float) -> None:
        """Advance ``key``'s virtual time by ``cost / weight`` (the caller
        served that much work on its behalf).  Unknown keys are ignored —
        the principal may have completed and been dropped meanwhile."""
        p = self._principals.get(key)
        if p is not None:
            p.vt += cost / p.weight

    def remove(self, key: str, item: Any) -> bool:
        """Remove the first occurrence of ``item`` from ``key``'s deque
        (dropping the principal if emptied); False if absent."""
        p = self._principals.get(key)
        if p is None or item not in p.items:
            return False
        p.items.remove(item)
        self._len -= 1
        if not p.items:
            del self._principals[key]
        return True

    # ---------------------------------------------------------------- select

    def select(
        self, eligible: Optional[Callable[[Principal], bool]] = None
    ) -> Optional[Principal]:
        """The lowest-``(vt, seq)`` principal holding items (and passing
        ``eligible``, when given) — the one whose turn it is.  The caller
        decides what serving means (pop an item, carve a chunk) and calls
        :meth:`charge` with the cost."""
        best: Optional[Principal] = None
        for p in self._principals.values():
            if best is not None and (p.vt, p.seq) >= (best.vt, best.seq):
                continue
            if p.items and (eligible is None or eligible(p)):
                best = p
        return best

    def pop(self) -> Optional[Tuple[str, Any]]:
        """Serve one item at unit cost: pop the selected principal's oldest
        item, charge ``1 / weight``, drop the principal if emptied."""
        p = self.select()
        if p is None:
            return None
        item = p.items.popleft()
        p.vt += 1.0 / p.weight
        self._len -= 1
        if not p.items:
            del self._principals[p.key]
        return p.key, item

    # ------------------------------------------------------------- overflow

    def shed_from_largest(self) -> Optional[Any]:
        """Backlog-overflow victim selection: remove and return the NEWEST
        item of the key holding the most queued items — the flood pays for
        the overflow it caused, not whoever arrives next.  Returns None
        when no key is over-represented (max backlog 1 per key, e.g.
        per-conn keys): the caller falls back to shedding the arrival,
        since every key then has an equal, minimal claim."""
        victim: Optional[Principal] = None
        for p in self._principals.values():
            if len(p.items) >= 2 and (
                victim is None or len(p.items) > len(victim.items)
            ):
                victim = p
        if victim is None:
            return None
        item = victim.items.pop()
        self._len -= 1
        if not victim.items:
            del self._principals[victim.key]
        return item

    def remove_where(self, pred: Callable[[Any], bool]) -> int:
        """Drop every queued item matching ``pred`` (e.g. a dead conn's
        requests); returns how many were removed."""
        removed = 0
        for key in list(self._principals):
            p = self._principals[key]
            kept: Deque[Any] = deque(i for i in p.items if not pred(i))
            removed += len(p.items) - len(kept)
            p.items = kept
            if not kept:
                del self._principals[key]
        self._len -= removed
        return removed
