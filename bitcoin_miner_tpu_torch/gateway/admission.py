"""Admission control primitives: token buckets and a request fair queue.

Pure policy, like the scheduler: every decision takes an explicit ``now``
and mutates only its own counters, so the whole admission path unit-tests
without clocks or sockets and stays deterministic under the chaos layer.

- :class:`TokenBucket` — classic continuous-refill bucket, one per client
  key.  A request costs one token; an empty bucket means "queue, don't
  dispatch" (backpressure), never "busy-wait".
- :class:`FairQueue` — weighted fair queue of *queued requests* across
  client keys (request granularity; the scheduler's WFQ handles nonce
  granularity once jobs are admitted).  The virtual-clock discipline
  itself (floor init, ``(vt, seq)`` tie-break, ``cost / weight`` charges)
  lives in the shared :mod:`bitcoin_miner_tpu_torch.utils.wfq` primitive —
  the scheduler's tenant queue runs the same one — so this class is just
  the request-shaped facade.
"""

from __future__ import annotations

from ..utils.wfq import VirtualClockWFQ


class TokenBucket:
    """``rate`` tokens/sec up to ``burst``; starts full (a fresh client can
    burst immediately — that is what the burst allowance is for)."""

    def __init__(self, rate: float, burst: float, now: float = 0.0) -> None:
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._last = now

    def _refill(self, now: float) -> None:
        if now > self._last:
            self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = max(self._last, now)

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def is_full(self, now: float) -> bool:
        """True once refilled to burst — behaviorally identical to a fresh
        bucket, so the owner may drop it (bounded per-client state)."""
        self._refill(now)
        return self.tokens >= self.burst


class FairQueue(VirtualClockWFQ):
    """Weighted fair queue of queued requests across client keys (see
    module docstring).  Items are anything; the gateway queues
    pending-request tuples.  ``push``/``pop`` serve at unit cost — one
    request, one charge — and ``__len__`` is the total backlog across
    every key (the overflow bound).  Selection, floor init, tie-breaks,
    and overflow victim choice are all the shared primitive's."""

    def push(self, key: str, item: tuple, weight: float = 1.0) -> None:
        self.add(key, item, weight)
