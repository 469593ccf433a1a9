"""BLAKE2b-64 workload: the second hash family behind the same stack.

Counterpart of ``bitcoin_miner_tpu/workloads/blake2b.py``.
``f(data, nonce) = BLAKE2b(digest_size=8)("<data> <nonce>")`` read
big-endian (the digest size keys the parameter block, so this is
BLAKE2b-64 proper, not a truncation).  Its ladder is cuda → torch → cpu →
hashlib: the cuda rung is the hand-written Hopper kernel
``csrc/blake2b_minhash.cu``, the torch rung its plain PyTorch version
(``ops/blake2b.py``), the cpu rung a prefix-folded hashlib loop and the
hashlib rung the naive oracle.  The reference's only device rung is its
xla kernel; the kernel and its plain version take that place here.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

from .base import GoldenVector, Workload


class Blake2bWorkload(Workload):
    """BLAKE2b-64 over ``"<data> <nonce>"`` (see the module docstring)."""

    tiers = ("cuda", "torch", "cpu", "hashlib")
    sep = b" "
    kernel_family = "blake2b"
    native_ok = False

    def __init__(
        self,
        name: str,
        *,
        description: str = "",
        golden: Tuple[GoldenVector, ...] = (),
    ) -> None:
        self.name = name
        self.description = description
        self.golden = tuple(golden)

    def hash_nonce(self, data: str, nonce: int) -> int:
        digest = hashlib.blake2b(
            f"{data} {nonce}".encode("utf-8"), digest_size=8
        ).digest()
        return int.from_bytes(digest, "big")

    def _cpu_search(self):
        """cpu tier: the prefix-folded loop (one encode per call, digest-
        bytes compares), a faster engine than the :meth:`min_range` oracle
        of the ``hashlib`` rung."""
        return self._cpu_range

    def _cpu_range(self, data: str, lower: int, upper: int) -> Tuple[int, int]:
        if lower > upper:
            raise ValueError(f"empty nonce range [{lower}, {upper}]")
        prefix = f"{data} ".encode("utf-8")
        blake2b = hashlib.blake2b
        best: Optional[bytes] = None  # 8-byte BE digest compares as the int
        best_nonce = lower
        for n in range(lower, upper + 1):
            d = blake2b(prefix + str(n).encode("ascii"), digest_size=8).digest()
            if best is None or d < best:
                best, best_nonce = d, n
        return int.from_bytes(best, "big"), best_nonce
