"""Multi-device nonce sweep: per-device shards + the min cascade.

Counterpart of ``bitcoin_miner_tpu/parallel/sweep.py``.  The reference
wraps its kernels in ``shard_map`` and reduces the per-device ``(h0, h1,
flat_idx)`` with three ``lax.pmin`` collectives.  Here a dispatch's rows are
split contiguously, ``per_dev_batch`` rows per shard; each shard's slice is
uploaded to its device and the single-device kernel of the family
(``ops.sweep._build_kernel``: one binary per family serves every digit
class and every card) runs there on that device's stream.  The per-shard
triples come back to the host (3 words each) and :func:`_collective_min`
folds them in the reference's order.  Across processes
(``parallel/multihost.py``) the same cascade runs again over the ranks,
each step a ``torch.distributed`` min.

Tie-break: rows are sharded *contiguously* in ascending-nonce order, so
``(device, flat_idx)`` lexicographic order equals nonce order and the
cascade keeps lowest-nonce-wins.  The device index is never folded into
one global flat index: ``per_dev_batch * 10^k`` fits the kernels' int32
index, N times that need not.

The sieve threshold is the host's running-min h0, handed to every shard;
each shard's kernel lowers its own device word.  A shard with no survivor
returns the sentinel ``(U32_MAX, U32_MAX, I32_MAX)``, which the cascade
orders last: no survivor means every lane there exceeds the threshold,
and any other shard's survivor is at or below it.

With ``hot=True`` (``ops.sweep._HotLoop`` over the shards) the shard
outputs never come back to the host: they reach ``ops.hot.hot_merge`` on
the first shard's card, which runs the same cascade there and merges it
into the job's carry; the threshold is the carried h0, one word per card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.sweep import (
    I32_MAX,
    U32_MAX,
    HostFold,
    SweepResult,
    _build_kernel,
    _fold,
    _HotLoop,
    _HotToken,
    _on,
    _to_device,
    _workload_knobs,
    auto_hot,
    auto_tune,
    run_sweep_dispatches,
)
from .mesh import default_devices, resolve_devices


def _cascade(h0, h1, dev, flat, pmin: Callable):
    """The reference's cascade over one axis, ``pmin`` its min: min h0,
    then min h1 among the h0 winners, then the lowest device among the
    (h0, h1) winners whose ``flat`` is not the sentinel, then that
    device's flat."""
    g_h0 = pmin(h0)
    h1m = np.where(h0 == g_h0, h1, U32_MAX)
    g_h1 = pmin(h1m)
    mine = (h0 == g_h0) & (h1m == g_h1) & (flat != I32_MAX)
    g_dev = pmin(np.where(mine, dev, I32_MAX))
    g_flat = pmin(np.where(mine & (dev == g_dev), flat, I32_MAX))
    return int(g_h0), int(g_h1), int(g_dev), int(g_flat)


def _collective_min(triples: Sequence[Sequence[int]]) -> Tuple[int, int, int, int]:
    """Fold per-shard ``(h0, h1, flat)`` triples, in shard order, to the
    global ``(g_h0, g_h1, g_dev, g_flat)`` with lowest-(device, flat) —
    lowest-nonce — ties; ``g_dev = g_flat = I32_MAX`` when no shard has a
    candidate."""
    a = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
    return _cascade(a[:, 0], a[:, 1], np.arange(len(a)), a[:, 2], np.min)


@dataclass(frozen=True)
class World:
    """Where this process's shards sit among the shards of every process
    in one logical miner: ``offset`` is the global index of its first
    shard, ``n_shards`` the count over all processes, ``pmin`` the
    cross-process min of one integer (None: one process)."""

    offset: int
    n_shards: int
    pmin: Optional[Callable[[int], int]] = None


def _candidate(shard_vals, bases, n_lanes: int, per_dev_batch: int,
               world: World) -> Optional[Tuple[int, int]]:
    """``(hash, nonce)`` of one sharded dispatch from its local shards'
    triples, or None when no shard of any process has a candidate.  Every
    process of a logical miner calls this for every dispatch in the same
    order (its cross-process steps are collectives)."""
    h0, h1, dev, flat = _collective_min(shard_vals)
    if world.pmin is not None:
        dev = world.offset + dev if dev != I32_MAX else I32_MAX
        h0, h1, dev, flat = _cascade(h0, h1, dev, flat, world.pmin)
    if flat == I32_MAX:
        return None
    row = dev * per_dev_batch + flat // n_lanes
    return ((h0 << 32) | h1, bases[row] + flat % n_lanes)


def shard_operands(tail_const: np.ndarray, bounds: np.ndarray, n_local: int,
                   per_dev_batch: int, first: int = 0):
    """The row slices of this process's shards: shard ``first + i`` takes
    rows ``[(first + i) * per_dev_batch, (first + i + 1) * per_dev_batch)``
    of the dispatch (padding rows keep their empty bounds)."""
    out = []
    for i in range(first, first + n_local):
        rows = slice(i * per_dev_batch, (i + 1) * per_dev_batch)
        out.append((tail_const[rows], bounds[rows]))
    return out


def sharded_invoke(kern, midstate, tail_const, bounds, devices, per_dev_batch: int,
                   thresh: Optional[int] = None, streams=None, first: int = 0) -> List:
    """Queue one sharded dispatch: each local shard's rows go to its
    device and the kernel runs there, on ``streams[i]`` when given (else
    the device's current stream).  ``thresh`` (sieve): the host's
    running-min h0, the same for every shard.  Returns each shard's (3,)
    output on its device; with ``streams``, each output is also copied into
    pinned host memory behind its kernel, and the entry is ``(host buffer,
    event recorded after the copy)``."""
    outs = []
    parts = shard_operands(tail_const, bounds, len(devices), per_dev_batch, first)
    for i, (dev, (tail_rows, bound_rows)) in enumerate(zip(devices, parts)):
        stream = None if streams is None else streams[i]
        with _on(dev, stream):
            out = kern(_to_device(midstate, dev), _to_device(tail_rows, dev),
                       _to_device(bound_rows, dev), thresh=thresh)
            if stream is not None:
                host = torch.empty(3, dtype=torch.int64, pin_memory=True)
                host.copy_(out, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
                out = (host, ev)
        outs.append(out)
    return outs


def sweep_min_hash_sharded(
    data: str,
    lower: int,
    upper: int,
    *,
    devices=None,
    max_k: Optional[int] = None,
    batch_per_device: Optional[int] = None,
    backend: Optional[str] = None,
    stats: Optional[dict] = None,
    workload=None,
    sieve: Optional[bool] = None,
    factored: Optional[bool] = None,
    hot: Optional[bool] = None,
    host_lane_budget: int = 0,
    world: Optional[World] = None,
) -> SweepResult:
    """Multi-device ``(min Hash(data, n), argmin n)`` over inclusive
    ``[lower, upper]``; bit-exact against the oracle, lowest-nonce ties.

    ``devices``: the shards (see ``parallel.mesh.resolve_devices``); None
    is every visible card (raises without one).  Dispatch rows pad up to
    ``n_shards * batch_per_device`` (padded rows have empty bounds and are
    masked in the kernel).  ``backend``/``batch_per_device``/``max_k``/
    ``sieve``/``factored``: the single-device rungs (``ops.sweep.auto_tune``),
    resolved from the first shard's device; every shard runs the
    single-device kernel of the class (``ops.sweep._build_kernel``).
    ``factored`` is honoured on the cuda rung, unlike the reference's
    sharded pallas branch, which ignores it because the TPU's factored
    kernel is compiled per class; the port's is one binary for every class.
    ``hot``: the hot plane (``ops.sweep.auto_hot``; None is OFF): one
    carry on the first shard's card, merged after every dispatch by
    ``ops.hot.hot_merge`` from the shards' outputs; with a multi-process
    ``world`` it raises (the multihost miner runs per-chunk only, as the
    reference's does).  ``host_lane_budget``: see
    ``ops.sweep.run_sweep_dispatches`` (0, the default, sends every class to
    the devices, as the reference's sharded sweep does).  ``world``: this
    process's place in a multi-process miner (``parallel.multihost``); None
    is one process.

    ``stats``, if given, is filled with ``dispatches`` (count) and
    ``fetch_wait_seconds`` (host time blocked on result fetches).
    """
    if hot and world is not None and world.pmin is not None:
        raise ValueError("hot=True is not available with a multi-process world (the "
                         "multihost miner): its carry would need a cross-process merge")
    devs = default_devices() if devices is None else resolve_devices(devices)
    sep, host_min, family = _workload_knobs(workload)
    backend, per_dev, max_k, sieve, factored = auto_tune(
        backend, batch_per_device, max_k, sieve, devs[0], factored, family)
    if world is None:
        world = World(offset=0, n_shards=len(devs))
    hotloop = (_HotLoop(backend, sieve, devs, per_dev_batch=per_dev)
               if auto_hot(hot, backend, family) else None)
    best: List[Tuple[int, int]] = []
    if stats is not None:
        stats.update(dispatches=0, fetch_wait_seconds=0.0)

    def get_kernel(layout, group):
        return _build_kernel(backend, layout, group, factored)

    def run_kernel(kern, midstate, tail_const, bounds):
        if stats is not None:
            stats["dispatches"] += 1
        if hotloop is not None:
            return hotloop.dispatch(kern, midstate, tail_const, bounds)
        th = None
        if sieve:
            # The running-min h0 at enqueue time; a stale (looser) read is
            # conservative-correct, as in the single-device sweep.
            th = (best[0][0] >> 32) if best else U32_MAX
        return sharded_invoke(kern, midstate, tail_const, bounds, devs, per_dev,
                              thresh=th, first=world.offset)

    def consume(out, bases, n_lanes):
        if isinstance(out, HostFold):
            _fold(best, (out.hash, out.nonce))
            return
        t0 = time.perf_counter()
        if isinstance(out, _HotToken):
            hotloop.drain(out, bases, n_lanes)  # blocks until the probe lands
            vals = None
        else:
            vals = [o.tolist() for o in out]  # blocks until each shard lands
        if stats is not None:
            stats["fetch_wait_seconds"] += time.perf_counter() - t0
        if vals is None:
            return
        cand = _candidate(vals, bases, n_lanes, per_dev, world)
        if cand is not None:
            _fold(best, cand)

    lanes = run_sweep_dispatches(
        data, lower, upper, max_k, world.n_shards * per_dev, get_kernel, run_kernel,
        consume, host_lane_budget=host_lane_budget, sep=sep, host_min=host_min,
        family=family,
    )
    if hotloop is not None:
        cand = hotloop.finish()
        if cand is not None:
            _fold(best, cand)
    if not best:
        raise RuntimeError("sharded sweep produced no candidates")
    return SweepResult(hash=best[0][0], nonce=best[0][1], lanes_swept=lanes)
