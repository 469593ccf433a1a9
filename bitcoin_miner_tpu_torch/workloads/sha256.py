"""SHA-256-template workloads: the frozen mining default and the
preimage/password-search variant.

Counterpart of ``bitcoin_miner_tpu/workloads/sha256.py``.  Both hash the
ASCII string ``"<data><sep><nonce>"`` with one SHA-256 and read the first 8
digest bytes big-endian.  The separator is the only degree of freedom, so
every tier (cuda → torch → cpu → hashlib) serves any workload of this
family: the layout function takes ``sep`` and the kernels never see it
(digit positions depend on the prefix length only).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

from .base import GoldenVector, Workload


class Sha256Workload(Workload):
    """Single SHA-256 over ``"<data><sep><nonce>"``, first 8 bytes BE.

    ``native_ok`` marks the one instance whose message format the compiled
    C++ sweep (native/) computes — the frozen default.
    """

    tiers = ("cuda", "torch", "cpu", "hashlib")

    def __init__(
        self,
        name: str,
        *,
        sep: str = " ",
        native_ok: bool = False,
        description: str = "",
        golden: Tuple[GoldenVector, ...] = (),
    ) -> None:
        self.name = name
        self.sep_str = sep
        self.sep = sep.encode("utf-8")
        self.native_ok = native_ok
        self.description = description
        self.golden = tuple(golden)

    def hash_nonce(self, data: str, nonce: int) -> int:
        digest = hashlib.sha256(
            f"{data}{self.sep_str}{nonce}".encode("utf-8")
        ).digest()
        return int.from_bytes(digest[:8], "big")

    def _cpu_search(self):
        """cpu tier: the native C++ sweep for the frozen default's message
        format, else a prefix-folded hashlib loop (one encode per call, a
        faster engine than the :meth:`min_range` oracle of the ``hashlib``
        rung)."""
        native = self._native_search()
        return native if native is not None else self._cpu_range

    def _cpu_range(self, data: str, lower: int, upper: int) -> Tuple[int, int]:
        if lower > upper:
            raise ValueError(f"empty nonce range [{lower}, {upper}]")
        prefix = f"{data}{self.sep_str}".encode("utf-8")
        sha256 = hashlib.sha256
        best: Optional[bytes] = None  # big-endian digest[:8] compares as int
        best_nonce = lower
        for n in range(lower, upper + 1):
            d = sha256(prefix + str(n).encode("ascii")).digest()[:8]
            if best is None or d < best:
                best, best_nonce = d, n
        return int.from_bytes(best, "big"), best_nonce
