"""Consistent-hash ring: which replica is *home* for a data key.

Routing hashes only the job signature's ``data`` — not the range — so
every sub-range, extension and exact repeat of one data key lands on the
same home replica, where the gateway's coalescing, exact-match cache and
interval-store planning keep collapsing the duplicates (the whole point
of routing by content rather than round-robin).

Standard construction: each replica name owns ``vnodes`` points on a
64-bit ring (stable SHA-256 placement — independent of insertion order,
so every replica configured with the same peer set derives the same
ring); a key routes to the first point clockwise from its own hash.
:meth:`Ring.route` returns the full preference order (home first, then
each DISTINCT next replica walking clockwise), which is also the
failover order: when the home is dead the caller just tries the next
name, and because every replica walks the same ring, any two survivors
agree on who inherits a dead replica's keys.

Pure data — no clocks, threads or I/O; liveness is the caller's problem
(the forwarder knows which peer refused its connection, the ring does
not).
"""

from __future__ import annotations

import hashlib
from bisect import bisect_right
from typing import Iterable, List, Optional, Sequence, Tuple


def _point(token: str) -> int:
    """Stable 64-bit ring position for a token."""
    return int.from_bytes(
        hashlib.sha256(token.encode("utf-8")).digest()[:8], "big"
    )


class Ring:
    """An immutable consistent-hash ring over replica names."""

    def __init__(self, names: Iterable[str], vnodes: int = 64) -> None:
        self.names: Tuple[str, ...] = tuple(sorted(set(names)))
        if not self.names:
            raise ValueError("a ring needs at least one replica name")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        points: List[Tuple[int, str]] = []
        for name in self.names:
            for i in range(vnodes):
                points.append((_point(f"{name}#{i}"), name))
        points.sort()
        self._points = points
        self._keys = [p for p, _ in points]

    def home(self, data: str) -> str:
        """The home replica for a data key."""
        return self.route(data)[0]

    def route(
        self, data: str, alive: Optional[Sequence[str]] = None
    ) -> List[str]:
        """Preference order for ``data``: home first, then each distinct
        replica walking clockwise — the failover order.  ``alive``
        filters the order to the given names (preserving it); an empty
        filtered order falls back to the unfiltered one, so a caller with
        a stale liveness view still gets a deterministic answer."""
        h = _point(data)
        start = bisect_right(self._keys, h) % len(self._points)
        order: List[str] = []
        for i in range(len(self._points)):
            name = self._points[(start + i) % len(self._points)][1]
            if name not in order:
                order.append(name)
                if len(order) == len(self.names):
                    break
        if alive is not None:
            kept = [n for n in order if n in alive]
            if kept:
                return kept
        return order

    def successor(
        self, name: str, alive: Optional[Sequence[str]] = None
    ) -> Optional[str]:
        """The next DISTINCT replica clockwise from ``name``'s first
        vnode — the deterministic heir a draining cell hands its orphan
        stash to.  Every replica derives the same ring, so
        survivors agree on who inherited.  ``alive`` filters candidates;
        None when the ring has no other (living) member."""
        if name not in self.names or len(self.names) == 1:
            return None
        h = _point(f"{name}#0")
        start = bisect_right(self._keys, h) % len(self._points)
        for i in range(len(self._points)):
            cand = self._points[(start + i) % len(self._points)][1]
            if cand != name and (alive is None or cand in alive):
                return cand
        return None
