"""The one retry-backoff policy every self-healing path shares.

Miner reconnects (apps/miner.py) ride this ladder; keeping it single-sourced
means jitter or cap semantics change in exactly one place.
"""

from __future__ import annotations


def backoff_delay(failures: int, base: float, cap: float) -> float:
    """Exponential backoff for the ``failures``-th consecutive failure
    (1-indexed): base, 2*base, 4*base, ... clamped to ``cap``."""
    return min(cap, base * (2 ** (max(1, failures) - 1)))
