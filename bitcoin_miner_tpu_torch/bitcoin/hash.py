"""The hash-search correctness contract, CPU oracle tier.

Parity: reference ``bitcoin/hash.go:13-17``::

    Hash(msg, nonce) = BigEndian.Uint64( SHA256("<msg> <nonce>")[:8] )

i.e. a **single** SHA-256 over the ASCII concatenation of the job data, one
space, and the nonce in decimal.  This is the slow-but-trusted oracle the
port's kernel and plain version must match bit-exactly.  Ties resolve as
lowest-nonce-wins everywhere.
"""

from __future__ import annotations

import hashlib
from typing import Tuple


def hash_nonce(msg: str, nonce: int) -> int:
    """Go-identical Hash(msg, nonce) -> uint64."""
    digest = hashlib.sha256(f"{msg} {nonce}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


def min_hash_range(msg: str, lower: int, upper: int) -> Tuple[int, int]:
    """Scan [lower, upper] inclusive (the reference Request range contract,
    bitcoin/message.go:21) and return (min_hash, nonce), lowest-nonce ties."""
    if lower > upper:
        raise ValueError(f"empty nonce range [{lower}, {upper}]")
    best_hash = (1 << 64)
    best_nonce = lower
    for n in range(lower, upper + 1):
        h = hash_nonce(msg, n)
        if h < best_hash:
            best_hash, best_nonce = h, n
    return best_hash, best_nonce
