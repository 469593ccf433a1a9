"""The range-fold workload contract of the port.

Counterpart of ``bitcoin_miner_tpu/workloads/base.py``.  Every sweep
consumer is generic over one shape of problem:

    associatively fold ``f(data, nonce)`` over the inclusive nonce range
    ``[lower, upper]`` and return the argmin, lowest-nonce ties.

A :class:`Workload` names one concrete ``f`` and bundles:

- the **bit-exact Python oracle** (:meth:`hash_nonce` / :meth:`min_range`),
  which every faster tier is held to;
- the **per-tier search factories** (:meth:`make_search` /
  :meth:`make_async_search`) over the tier ladder in :attr:`tiers`,
  strongest first: the watchdog's downgrade chain is built from this list
  (the requested tier, then the host tiers below it: cuda → cpu →
  hashlib);
- the **frozen golden vectors** (:attr:`golden`): literal ``(data, nonce,
  hash)`` triples pinned in source.

The reference's tiers map onto the port's as ``pallas`` → ``cuda`` (the
hand-written Hopper kernels) and ``xla`` → ``torch`` (their plain PyTorch
versions, on the card by default or on the CPU when asked).  Workload
objects are stateless policy shared read-only by every thread; device
machinery is imported lazily, so importing the registry costs hashlib only.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: (data, nonce, expected 64-bit hash) — the frozen-vector row shape.
GoldenVector = Tuple[str, int, int]

#: The full tier ladder, strongest first.  A workload's :attr:`tiers` is an
#: ordered subset; "hashlib" (the pure-Python oracle) must be last — it is
#: the one tier that cannot wedge.
TIER_LADDER = ("cuda", "torch", "cpu", "hashlib")

#: The tiers that run the sweep pipeline on a device (``device=`` and
#: ``devices=`` apply).
DEVICE_TIERS = ("cuda", "torch")


def _sharded(devices) -> bool:
    """Whether ``devices`` asks for the multi-device sweep: anything but
    None or 1 (a device list always does, even of one device)."""
    return devices is not None and devices != 1


class Workload:
    """One registered range-fold workload (see the module docstring).

    Subclasses implement :meth:`hash_nonce`; the base class provides the
    oracle sweep and the tier factories.
    """

    #: Registry key; sweep consumers resolve workloads by this name.
    name: str = ""
    #: One-line description for ``--workload`` listings.
    description: str = ""
    #: Ordered strongest-first subset of :data:`TIER_LADDER`.
    tiers: Tuple[str, ...] = ("hashlib",)
    #: Frozen golden vectors, pinned literal in source.
    golden: Tuple[GoldenVector, ...] = ()
    #: ASCII byte(s) between ``data`` and the decimal nonce, for workloads
    #: the device message-template kernels serve; None = no device tier.
    sep: Optional[bytes] = None
    #: Which device kernel family serves this workload's message format
    #: ("sha256" or "blake2b"): picks the layout function and the kernel.
    kernel_family: str = "sha256"
    #: Whether the compiled C++ sweep (native/) computes this workload —
    #: true only for the frozen default's message format.
    native_ok: bool = False

    # ------------------------------------------------------------- oracle

    def hash_nonce(self, data: str, nonce: int) -> int:
        """The workload's ``f(data, nonce) -> uint64``."""
        raise NotImplementedError

    def min_range(self, data: str, lower: int, upper: int) -> Tuple[int, int]:
        """Oracle sweep of inclusive ``[lower, upper]``: ``(min hash,
        argmin nonce)``, lowest-nonce ties."""
        if lower > upper:
            raise ValueError(f"empty nonce range [{lower}, {upper}]")
        best_hash = 1 << 64
        best_nonce = lower
        hash_nonce = self.hash_nonce
        for n in range(lower, upper + 1):
            h = hash_nonce(data, n)
            if h < best_hash:
                best_hash, best_nonce = h, n
        return best_hash, best_nonce

    # ------------------------------------------------------ tier factories

    def _check_tier(self, tier: str, devices: Optional[int]) -> None:
        if tier not in self.tiers:
            raise ValueError(
                f"workload {self.name!r} has no {tier!r} tier "
                f"(ladder: {'->'.join(self.tiers)})"
            )
        if _sharded(devices) and tier not in DEVICE_TIERS:
            raise ValueError(
                "--devices requires a device tier (cuda/torch); "
                f"the {tier!r} tier is a single-process host loop"
            )
        if tier in DEVICE_TIERS and self.sep is None:
            raise ValueError(
                f"workload {self.name!r} declares device tier {tier!r} "
                "but no message template (sep)"
            )

    def make_search(self, tier: str, device=None, *, devices: Optional[int] = None):
        """A synchronous ``(data, lower, upper) -> (hash, nonce)`` search on
        ``tier``.  ``device`` (device tiers only): None is the CUDA card,
        ``"cpu"`` the explicit request for the CPU.  ``devices`` (device
        tiers only): N shards, or a list of shard devices
        (``parallel.mesh.resolve_devices``), swept by
        ``sweep_min_hash_sharded``; None or 1 is one device."""
        self._check_tier(tier, devices)
        if tier == "hashlib":
            return self.min_range
        if tier == "cpu":
            return self._cpu_search()
        if _sharded(devices):
            from ..parallel import resolve_devices, sweep_min_hash_sharded

            shards = resolve_devices(devices, device)

            def sharded(data: str, lower: int, upper: int) -> Tuple[int, int]:
                r = sweep_min_hash_sharded(data, lower, upper, devices=shards,
                                           backend=tier, workload=self)
                return r.hash, r.nonce

            return sharded
        from ..ops.sweep import sweep_min_hash

        def search(data: str, lower: int, upper: int) -> Tuple[int, int]:
            r = sweep_min_hash(data, lower, upper, backend=tier, device=device, workload=self)
            return r.hash, r.nonce

        return search

    def make_async_search(self, tier: str, device=None, *,
                          devices: Optional[int] = None,
                          host_lane_budget: Optional[int] = None,
                          hot: Optional[bool] = None):
        """An async search (``submit(data, lo, hi) -> Future``) on ``tier``,
        the shape ``apps.miner.run_miner`` serves Requests with: device
        tiers ride the cross-request ``SweepPipeline``, host tiers a
        one-worker FIFO pool.  ``host_lane_budget`` and ``hot``: see
        ``SweepPipeline`` (None = auto).  ``devices``: as for
        :meth:`make_search`, through ``SweepPipeline(devices=)``."""
        self._check_tier(tier, devices)
        from ..apps import miner as miner_mod

        if tier in DEVICE_TIERS:
            return miner_mod._PipelineSearch(
                tier, device=device, host_lane_budget=host_lane_budget, workload=self,
                devices=devices if _sharded(devices) else None, hot=hot,
            )
        return miner_mod._PoolSearch(self.make_search(tier))

    def _cpu_search(self):
        """The cpu-tier search: the compiled native sweep when this
        workload's format is the one it computes, else the oracle loop
        (subclasses override with faster prefix-folded host loops)."""
        native = self._native_search()
        return native if native is not None else self.min_range

    def _native_search(self):
        """The compiled C++ sweep if it computes this workload and builds
        here, else None."""
        if not self.native_ok:
            return None
        from .. import native

        return native.min_hash_range_native if native.available() else None

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<Workload {self.name!r} tiers={'->'.join(self.tiers)}>"
