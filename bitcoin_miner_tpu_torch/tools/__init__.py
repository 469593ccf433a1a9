"""The port's operator tools that start miners.

Each runs as ``python -m bitcoin_miner_tpu_torch.tools.<name>`` and is
the counterpart of the repository's ``tools/<name>.py``:

- :mod:`.loadgen` — duplicate-heavy, overlap-heavy, federated and
  open-loop traffic through in-process serving fleets;
- :mod:`.chaos_replay` — one chaos or federation drill replayed from its
  ``(scenario, seed)``;
- :mod:`.autoscale` — the out-of-process autoscale supervisor.

Their miners run on ``--backend`` (default ``auto``: the cuda rung on a
card, ``cpu`` the native host tier).  With no card and no request for
the host a tool exits non-zero and names the missing card; nothing falls
back to the host.  This module holds what the tools share: that check,
the kernels' launch counts and the :class:`Oracle`.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Tuple

from ..workloads import resolve
from ..workloads.base import DEVICE_TIERS

#: ``--oracle`` values: the workload's hashlib ``min_range``, or the
#: port's own sweep on the card.
ORACLES = ("hashlib", "card")


def card_available() -> bool:
    import torch

    return torch.cuda.is_available()


def resolve_tier(backend: str, workload=None) -> str:
    """The tier ``backend`` names for ``workload`` (the miner's rule:
    ``auto`` is the cuda rung on a card).  The tools pass no ``device``,
    so a device tier is the card: asking for one where torch finds no
    card raises ValueError, naming the card and ``--backend cpu``."""
    from ..apps.miner import _resolve_tier

    if backend in ("auto", *DEVICE_TIERS) and not card_available():
        raise ValueError(
            f"--backend {backend} mines on a CUDA card and torch finds none; "
            "--backend cpu mines on the host"
        )
    return _resolve_tier(backend, resolve(workload))


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far, by wrapper name."""
    from ..ops.blake2b_minhash import blake2b_minhash
    from ..ops.hot import hot_merge
    from ..ops.sha256_minhash import minhash
    from ..ops.sha256_minhash_factored import minhash_factored

    return {k.__name__: k.launches
            for k in (minhash, minhash_factored, blake2b_minhash, hot_merge)}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Launches per wrapper since the :func:`kernel_launches` ``before``."""
    return {k: n - before[k] for k, n in kernel_launches().items()}


def miner_launches(oracle: "Oracle") -> Callable[[], Dict[str, int]]:
    """A function reading the kernels' launches since this call, less
    those of ``oracle``'s own sweeps in between: the miners' launches."""
    k0, o0 = kernel_launches(), dict(oracle.launches)

    def read() -> Dict[str, int]:
        return {k: n - (oracle.launches[k] - o0[k])
                for k, n in launches_since(k0).items()}

    return read


class Oracle:
    """The expected Result ``(hash, nonce)`` of a signature ``(data, lo,
    hi)``, each computed once.  ``hashlib`` is the workload's
    ``min_range``; ``card`` is the port's ``sweep_min_hash`` on the cuda
    rung, the oracle that reaches ranges of 1e9 nonces and more.  Every
    answer is also held to the workload's ``hash_nonce``.  ``launches``
    counts the kernel launches of the card's own sweeps, so a caller can
    count its miners' launches apart from them."""

    def __init__(self, kind: str, workload=None) -> None:
        if kind not in ORACLES:
            raise ValueError(f"unknown oracle {kind!r} ({'|'.join(ORACLES)})")
        if kind == "card" and not card_available():
            raise ValueError(
                "--oracle card sweeps on a CUDA card and torch finds none; "
                "--oracle hashlib runs on the host"
            )
        self.kind = kind
        self.workload = resolve(workload)
        self.launches = dict.fromkeys(kernel_launches(), 0)
        self._memo: Dict[Tuple[str, int, int], Tuple[int, int]] = {}
        self._lock = threading.Lock()

    def __call__(self, data: str, lo: int, hi: int) -> Tuple[int, int]:
        with self._lock:
            got = self._memo.get((data, lo, hi))
            if got is None:
                got = self._memo[(data, lo, hi)] = self._compute(data, lo, hi)
        return got

    def _compute(self, data: str, lo: int, hi: int) -> Tuple[int, int]:
        if self.kind == "card":
            from ..ops.sweep import sweep_min_hash

            before = kernel_launches()
            r = sweep_min_hash(data, lo, hi, backend="cuda", workload=self.workload)
            for k, n in launches_since(before).items():
                self.launches[k] += n
            got = (r.hash, r.nonce)
        else:
            got = self.workload.min_range(data, lo, hi)
        h, n = got
        if not lo <= n <= hi or self.workload.hash_nonce(data, n) != h:
            raise RuntimeError(
                f"the {self.kind} oracle answered {got} for ({data!r}, {lo}, {hi}), "
                f"which {self.workload.name}'s hash_nonce does not hold"
            )
        return got


def run_stamp(args, oracle: Oracle) -> dict:
    """The keys every tool's JSON line carries: the miners' rung as asked
    and as resolved, the device it ran on, and the oracle with its
    launches."""
    device = "host"
    if args.tier in DEVICE_TIERS:
        import torch

        device = torch.cuda.get_device_name(0)
    return {"backend": args.backend, "tier": args.tier, "device": device,
            "oracle": oracle.kind, "oracle_launches": dict(oracle.launches)}
