"""Blockwise nonce-range sweep: decomposition + min-hash dispatches.

Port of ``bitcoin_miner_tpu/ops/sweep.py`` for both kernel families
(sha256 and blake2b) on one device.  Decomposition invariants (unchanged
from the reference):

- Nonces are grouped by decimal **digit count** ``d`` (the hashed string's
  length depends on it), then into **10^k-aligned chunks** so the high
  ``d-k`` digits are constant per chunk and are folded into the message
  template on the host; only the low ``k`` digits vary per lane.
- A dispatch processes B chunks at once (``(B, 10^k)`` lanes) and returns
  the lexicographic min of the big-endian ``(h0, h1)`` hash pair and the
  flat argmin lane, lowest-nonce tie-break.

Workloads: ``workload=`` (a ``workloads`` registration; None is the
default ``sha256d``) picks the message separator, the host fold of tiny
digit classes and the kernel family (``_workload_knobs``).  Layouts carry
their family, and ``_build_kernel`` dispatches on it.

Rungs: ``cuda`` runs the hand-written kernels (ops/sha256_minhash.py and,
with ``factored=True``, ops/sha256_minhash_factored.py; for the blake2b
family ops/blake2b_minhash.py) on a CUDA device; ``torch`` runs their plain
PyTorch versions on the given device (the CPU rung of the tests).  The
factored rung splits a chunk's ``10^k`` lanes into ``10^(k - k_in)`` outer
digit groups of ``10^k_in`` inner lanes and computes each (row, group)'s
round prefix once (``default_factor_k_in``).  Tiny digit classes fold on
the host: the native C++ sweep for ``sha256d`` (hashlib where it does not
build), the workload's cpu-tier loop otherwise.  ``SweepPipeline(devices=)``
shards each dispatch over several devices (``parallel/sweep.py`` holds the
shards and the cascade).

The hot plane (``hot=True``, OFF by default: :func:`auto_hot`): each job
keeps its running ``(best, threshold)`` on the device, and every dispatch
is the kernel launch(es) followed by ``ops/hot.py``'s merge into that
carry on the same stream (:class:`_HotLoop`); the host reads a 2-word probe
per dispatch and the carry once, at the job's end.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os as _os
import time as _time
from dataclasses import dataclass
from typing import Deque, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import trace as _trace
from ..utils.metrics import METRICS
from ..utils.platform import resolve_device
from .blake2b import blake2b_minhash_plain
from .blake2b import build_layout as build_blake2b_layout
from .blake2b_minhash import blake2b_minhash
from .hot import hot_merge, hot_merge_plain, new_carry
from .sha256 import MsgLayout, build_layout
from .sha256_minhash import minhash, minhash_plain
from .sha256_minhash_factored import minhash_factored, minhash_factored_plain

U32_MAX = 0xFFFFFFFF
I32_MAX = 0x7FFFFFFF


# --------------------------------------------------------------------------
# Range decomposition (host)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Chunk:
    """A 10^k-aligned slice of a digit bucket: nonces ``base + [lo_off,
    hi_off)`` all share the same decimal digit count and high digits."""

    base: int
    lo_off: int
    hi_off: int  # exclusive


@dataclass(frozen=True)
class ChunkGroup:
    """Chunks sharing digit count ``d`` and low-digit count ``k`` (and hence
    one message layout)."""

    d: int
    k: int
    chunks: Tuple[Chunk, ...]


def decompose_range(lower: int, upper: int, max_k: int = 6) -> Iterator[ChunkGroup]:
    """Split inclusive ``[lower, upper]`` into digit-bucketed aligned chunks.

    ``max_k`` caps lanes-per-chunk at 10^max_k; larger buckets become many
    chunks.  Yields groups in ascending nonce order.
    """
    if lower > upper:
        raise ValueError(f"empty nonce range [{lower}, {upper}]")
    if lower < 0:
        raise ValueError(f"negative nonce {lower}")
    d_lo = len(str(lower))
    d_hi = len(str(upper))
    for d in range(d_lo, d_hi + 1):
        bucket_lo = 0 if d == 1 else 10 ** (d - 1)
        bucket_hi = 10**d - 1
        lo = max(lower, bucket_lo)
        hi = min(upper, bucket_hi)
        if lo > hi:
            continue
        k = 1 if d == 1 else min(d - 1, max_k)
        span = 10**k
        chunks = []
        for c in range(lo // span, hi // span + 1):
            base = c * span
            chunks.append(
                Chunk(base=base, lo_off=max(lo - base, 0), hi_off=min(hi - base + 1, span))
            )
        yield ChunkGroup(d=d, k=k, chunks=tuple(chunks))


@functools.lru_cache(maxsize=256)
def _layout_cache(data: bytes, d: int, sep: bytes = b" ", family: str = "sha256"):
    """The layout of one digit class, keyed on everything it depends on:
    the separator and the family as well as the data and the digit count,
    so two workloads' sweeps of one job never share a layout."""
    if family == "blake2b":
        return build_blake2b_layout(data, d, sep=sep)
    return build_layout(data, d, sep=sep)


def _workload_knobs(workload) -> Tuple[bytes, object, str]:
    """``(separator, host fold, kernel family)`` of a workload (duck-typed:
    ``.sep``, ``._cpu_search``, ``.native_ok``, ``.kernel_family``).  None
    is the default ``sha256d``.  A workload with no message template cannot
    run these sweeps: a configuration error, not a silent wrong answer."""
    if workload is None:
        from ..workloads import resolve

        workload = resolve(None)
    if getattr(workload, "sep", None) is None:
        raise ValueError(
            f"workload {getattr(workload, 'name', workload)!r} has no "
            "device message template; its tier ladder has no device tier"
        )
    family = getattr(workload, "kernel_family", "sha256")
    if getattr(workload, "native_ok", False):
        return workload.sep, _host_min, family
    # The workload's cpu-tier loop (prefix-folded), not its per-nonce
    # oracle: host lanes sit on the hot path.
    return workload.sep, workload._cpu_search(), family


def _fill_templates(
    layout: MsgLayout, group: ChunkGroup, chunk_rows: Sequence[Chunk], batch: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: fold each chunk's constant high digits into the word
    template; build the (B, 2) lane-bound array, padding unused rows empty."""
    tail_const = np.tile(
        np.array(layout.tail_template, dtype=np.uint64), (batch, 1)
    )  # u64 scratch to avoid overflow warnings, cast at the end
    bounds = np.zeros((batch, 2), dtype=np.int32)
    span = 10**group.k
    n_high = layout.digit_count - group.k
    for r, ch in enumerate(chunk_rows):
        if n_high > 0:
            high = str(ch.base // span)
            if len(high) != n_high:
                raise AssertionError((high, n_high, ch))
            for j, ch_digit in enumerate(high):
                dp = layout.digit_pos[j]
                tail_const[r, dp.word] |= ord(ch_digit) << dp.shift
        bounds[r] = (ch.lo_off, ch.hi_off)
    return tail_const.astype(np.uint32), bounds


# --------------------------------------------------------------------------
# Host sweep loop
# --------------------------------------------------------------------------


def default_factor_k_in(k: int) -> int:
    """The factored kernel's inner digit count for a ``k``-digit lane
    axis: at most 1000 outer groups, the inner lanes as wide as that
    allows.  k = 6 -> 3 (1000 groups x 1000 lanes), k = 5 -> 3, k = 2 -> 1."""
    return min(3, max(1, k - 2))


@dataclass
class SweepResult:
    hash: int  # the 64-bit big-endian hash value
    nonce: int
    lanes_swept: int  # valid nonces hashed (for throughput accounting)


def auto_tune(
    backend: Optional[str],
    batch: Optional[int],
    max_k: Optional[int],
    sieve: Optional[bool],
    device: torch.device,
    factored: Optional[bool] = None,
    family: str = "sha256",
) -> Tuple[str, int, int, bool, bool]:
    """Resolve ``(backend, rows-per-dispatch, max_k, sieve, factored)`` for
    a device.

    ``backend=None`` is ``cuda`` on a CUDA device and ``torch`` elsewhere.
    The ``cuda`` defaults (batch 1024, max_k 6: ~1e9 lanes per dispatch,
    sieve on) are the TPU tier's shape, kept provisionally until an H100
    measurement prices them.  The ``torch`` rung keeps the reference xla
    tier's small defaults (batch 4, max_k 5, sieve off) so a CPU sweep stays
    small.  ``batch * 10^max_k`` must fit the kernel's int32 flat index.

    ``factored=None`` is OFF on both rungs.  On ``cuda`` as on the
    reference's accelerator tier: the main path keeps its kernel until a
    benchmark's repeated pairs decide (PERF.md has single pairs only).  On
    ``torch`` because that rung is the tests' CPU rung, not a speed tier
    (the reference's xla tier defaults it ON for its own schedule-buffer
    reason, which the plain version does not have).

    ``family="blake2b"`` (the ``blake2b64`` workload): the same rung shapes
    (cuda batch 1024, max_k 6; torch batch 4, max_k 5), kept provisionally,
    with the sieve OFF by default on both (h0 and h1 come out of one
    output word, so there is no cheaper first pass).  ``factored=True``
    on the cuda rung raises: the reference's grouped form exists for
    XLA:CPU cache residency, and the kernel computes the same function in
    one form; on the torch rung it runs the plain version's grouped form."""
    if family not in ("sha256", "blake2b"):
        raise ValueError(f"unknown kernel family {family!r} (sha256 or blake2b)")
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown sweep backend {backend!r} (cuda or torch)")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"the cuda backend needs a CUDA device, got {device}")
    if batch is None:
        batch = 1024 if backend == "cuda" else 4
    if max_k is None:
        max_k = 6 if backend == "cuda" else 5
    if sieve is None:
        sieve = backend == "cuda" and family == "sha256"
    factored = bool(factored)
    if factored and family == "blake2b" and backend == "cuda":
        raise ValueError(
            "the blake2b kernel has one form; factored=True exists only on "
            "the torch rung (the plain version's grouped form)"
        )
    if batch < 1 or max_k < 1:
        raise ValueError(f"batch ({batch}) and max_k ({max_k}) must be >= 1")
    if batch * 10**max_k > I32_MAX:
        raise ValueError(
            f"batch ({batch}) * 10^max_k ({10**max_k}) lanes overflow the "
            "int32 argmin index; lower batch or max_k"
        )
    return backend, batch, max_k, sieve, factored


def auto_hot(hot: Optional[bool], backend: str, family: str = "sha256") -> bool:
    """Resolve the hot rung for a resolved ``backend`` and kernel ``family``.

    ``hot=None`` is OFF on both rungs and both families, as in the
    reference (its one recorded same-seed pair, on XLA:CPU, read 1.02):
    the per-chunk path stays the default until a benchmark's repeated
    pairs on the card decide, per rung and family.  Until then neither
    argument changes the answer (``auto_tune`` has checked both)."""
    return bool(hot)


@dataclass(frozen=True)
class HostFold:
    """A ``(hash, nonce)`` candidate computed on the host for a tiny digit
    class, passed through a sweep's ``consume`` in place of a device
    output, so a one-off ``10^d`` bucket costs no device dispatch."""

    hash: int
    nonce: int


def _host_min(data: str, lo: int, hi: int) -> Tuple[int, int]:
    """Host-tier ``(min hash, argmin nonce)`` of the default workload over
    inclusive ``[lo, hi]``: the native C++ sweep when it builds, else the
    hashlib oracle."""
    from .. import native
    from ..bitcoin.hash import min_hash_range

    return native.host_min_fn(min_hash_range)(data, lo, hi)


def auto_host_lane_budget() -> int:
    """Largest digit-class size worth computing on the host instead of on
    the device: ~0.1 s of hashlib work.  The reference raises it to 10^7
    with its native tier to skip compiling a device kernel per class; one
    binary per family serves every class here, so that reason does not
    apply."""
    return 10**5


def run_sweep_dispatches(
    data: str,
    lower: int,
    upper: int,
    max_k: int,
    batch: int,
    get_kernel,
    run_kernel,
    consume,
    max_inflight: int = 32,
    host_lane_budget: int = 0,
    sep: bytes = b" ",
    host_min=None,
    family: str = "sha256",
) -> int:
    """The decompose → template-fill → dispatch skeleton.

    ``sep``/``host_min``/``family`` are the workload knobs
    (:func:`_workload_knobs`; the defaults are ``sha256d``'s): the
    separator in each digit class's layout, the host fold of host-routed
    classes and the kernel family whose layout function runs.

    ``get_kernel(layout, group)`` returns the kernel for a shape class;
    ``run_kernel(kern, midstate, tail_const, bounds)`` queues one dispatch
    and returns its (not-yet-fetched) output handle;
    ``consume(out, chunk_bases, 10^k)`` fetches and folds one result — it
    must also accept a :class:`HostFold` as ``out`` (with None bases):
    digit classes with ``10^d <= host_lane_budget`` are min-folded on the
    host.  0 (the default) disables routing so library callers and kernel
    tests always exercise the device path; the miner's pipeline passes
    :func:`auto_host_lane_budget`.  At most ``max_inflight`` dispatches stay
    queued.  Returns the number of lanes swept.
    """
    data_bytes = data.encode("utf-8")
    if host_min is None:
        host_min = _host_min
    pending: Deque[Tuple] = collections.deque()
    lanes = 0
    for group in decompose_range(lower, upper, max_k=max_k):
        if 10**group.d <= host_lane_budget:
            g_lo = group.chunks[0].base + group.chunks[0].lo_off
            g_hi = group.chunks[-1].base + group.chunks[-1].hi_off - 1
            h, n = host_min(data, g_lo, g_hi)
            pending.append((HostFold(h, n), None, None))
            lanes += sum(c.hi_off - c.lo_off for c in group.chunks)
            continue
        layout = _layout_cache(data_bytes, group.d, sep, family)
        kern = get_kernel(layout, group)
        midstate = np.array(layout.midstate, dtype=np.uint32)
        for s in range(0, len(group.chunks), batch):
            rows = group.chunks[s : s + batch]
            tail_const, bounds = _fill_templates(layout, group, rows, batch)
            out = run_kernel(kern, midstate, tail_const, bounds)
            pending.append((out, [c.base for c in rows], 10**group.k))
            lanes += sum(c.hi_off - c.lo_off for c in rows)
            if len(pending) > max_inflight:
                consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    return lanes


def _build_kernel(backend: str, layout, group: ChunkGroup, factored: bool = False):
    """The kernel for one digit class: the CUDA wrapper or the plain
    version of the layout's family, bound to the class's k low digit
    positions.  ``factored`` takes the factored kernel (the plain version's
    grouped form for blake2b) for classes with ``k >= 2`` (a 1-digit lane
    axis has nothing to factor).  One binary per family serves every
    class, so nothing is compiled per class."""
    low_pos = layout.digit_pos[layout.digit_count - group.k :]
    cuda = backend == "cuda"
    if layout.family == "blake2b":
        counters = dict(msg_len=layout.msg_len, tail_off=layout.tail_off)
        if cuda:
            return functools.partial(blake2b_minhash, low_pos=low_pos, **counters)
        k_in = default_factor_k_in(group.k) if factored and group.k >= 2 else 0
        return functools.partial(blake2b_minhash_plain, low_pos=low_pos, k=group.k,
                                 k_in=k_in, **counters)
    if factored and group.k >= 2:
        fn = minhash_factored if cuda else minhash_factored_plain
        return functools.partial(fn, low_pos=low_pos,
                                 k_in=default_factor_k_in(group.k))
    fn = minhash if cuda else minhash_plain
    return functools.partial(fn, low_pos=low_pos)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        # Pinned staging so the upload is asynchronous on the caller's
        # stream; the caching host allocator keeps the block until the
        # copy has run.
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _invoke_kernel(kern, device, midstate, tail_const, bounds, thresh=None):
    """One dispatch: upload the operands and call the kernel.  ``thresh``
    (sieve only) is the host's running-min h0 as a plain int in
    ``[0, U32_MAX]`` — U32_MAX (everything survives) until the first
    candidate lands."""
    return kern(
        _to_device(midstate, device),
        _to_device(tail_const, device),
        _to_device(bounds, device),
        thresh=thresh,
    )


def _fold(best: List[Tuple[int, int]], cand: Tuple[int, int]) -> None:
    if not best or cand < best[0]:
        best[:] = [cand]


def _candidate(vals, bases, n_lanes) -> Optional[Tuple[int, int]]:
    """``(hash, nonce)`` of one dispatch's ``(h0, h1, flat_idx)``, or None
    for a fully-masked dispatch or (sieve) one where no lane beat the
    threshold."""
    h0, h1, fi = (int(v) for v in vals)
    if fi == I32_MAX:
        return None
    return ((h0 << 32) | h1, bases[fi // n_lanes] + fi % n_lanes)


def _on(device: torch.device, stream=None):
    """Make ``device`` the thread's current device and ``stream`` its
    current stream (no-op on the CPU): operand uploads, scratch and the
    launch of one shard then all go to that shard's device."""
    stack = contextlib.ExitStack()
    if device.type == "cuda":
        stack.enter_context(torch.cuda.device(device))
        if stream is not None:
            stack.enter_context(torch.cuda.stream(stream))
    return stack


# --------------------------------------------------------------------------
# The hot plane
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class _HotToken:
    """One hot dispatch's handle through a sweep's ``consume``: its
    sequence number, its probe ``(best_h0, best_seq)`` (on a card, a pinned
    host copy and the event recorded after the copy; on the CPU, the probe
    itself and None) and the enqueue stamp."""

    seq: int
    probe: torch.Tensor
    event: Optional[object]
    t_enq: float


class _HotLoop:
    """One job's hot dispatch plane, on one device or over shards.

    Carried-state contract (the reference's ``make_hot_step``):

    - The carry is a (5,) int64 device tensor ``(best_h0, best_h1,
      best_seq, best_dev, best_flat)``, made vacant
      (``ops.hot.new_carry``) and merged in place after every dispatch by
      ``ops.hot.hot_merge`` (``hot_merge_plain`` on the torch rung) on the
      stream of the first shard.  ``best_seq`` names the dispatch whose
      ``(bases, 10^k)`` descriptor resolves ``best_flat`` to a nonce;
      ``best_dev`` the shard, whose rows start at ``best_dev *
      per_dev_batch``.  The host reads the carry once, in :meth:`finish`.
    - With the sieve, each card has one (1,) int32 threshold word that its
      shards' kernels take as ``th_word`` and lower in place; the merge
      lowers the carry card's word to the carried h0, and another card's
      word is copied from it on that card's stream.  Every other shard's
      stream waits on the merge before its next launch, so a dispatch
      sieves against the min through the previous dispatch at the
      loosest (``kernel.thresh_staleness`` 1).  Pass 1 keeps ``h0 <=
      thresh``, so an exact tie still reaches the merge.
    - An exact ``(h0, h1)`` tie keeps the carried candidate: dispatches go
      out in ascending nonce order (``run_sweep_dispatches``), so the
      carried one has the lower nonce; within a dispatch the kernel keeps
      the lowest flat index and the cascade the lowest shard.
    - Each dispatch uploads its operands as the per-chunk path does
      (``_to_device``: pinned staging that the caching host allocator
      recycles once the copy has run, so nothing here waits on an upload)
      and returns a 2-word probe copied into pinned memory behind the
      merge: the host blocks on probes for backpressure, the dispatch
      latency and pruning the descriptors.

    ``devices``: the shards' devices (one entry on one device); ``streams``:
    one per shard, or None for each device's current stream at dispatch.
    Called from one dispatcher thread (``dispatch``) and one fetcher
    thread (``drain``, ``finish``), in dispatch order."""

    def __init__(self, backend: str, sieve: bool, devices: Sequence[torch.device], *,
                 per_dev_batch: int, streams=None) -> None:
        self._merge = hot_merge if backend == "cuda" else hot_merge_plain
        self._sieve = sieve
        self._devices = list(devices)
        self._per_dev_batch = per_dev_batch
        self._streams = streams
        self._cuda = self._devices[0].type == "cuda"
        self._carry: Optional[torch.Tensor] = None
        self._merge_stream = None
        #: device -> its (1,) int32 sieve threshold word (uint32 bits)
        self._words: dict = {}
        self._seq = 0
        self._drained = 0
        #: seq -> (bases, 10^k): resolves the carried winner's flat lane to
        #: a nonce at the job's end; pruned by probe drains to O(in flight).
        self._bases: dict = {}

    @property
    def carry(self) -> Optional[torch.Tensor]:
        """The carry tensor itself (for identity checks; reading its values
        is :meth:`finish`'s alone)."""
        return self._carry

    def _start(self, streams) -> None:
        """Make the carry (on the first shard's stream) and, with the sieve,
        each card's threshold word at U32_MAX on the stream of the card's
        first shard; every other shard stream on that card waits on it."""
        made = {}
        for i, dev in enumerate(self._devices):
            if dev in made:
                if self._cuda and streams[i] != streams[made[dev][0]]:
                    streams[i].wait_event(made[dev][1])
                continue
            with _on(dev, streams[i]):
                if i == 0:
                    self._carry = new_carry(dev)
                if self._sieve:
                    self._words[dev] = torch.full((1,), -1, dtype=torch.int32, device=dev)
                ev = None
                if self._cuda:
                    ev = torch.cuda.Event()
                    ev.record(streams[i])
            made[dev] = (i, ev)

    def dispatch(self, kern, midstate, tail_const, bounds) -> _HotToken:
        """Queue one dispatch: the uploads and the kernel on each shard's
        stream, then the merge and the probe's copy on the first shard's.
        Nothing waits on the device."""
        seq = self._seq
        if seq > I32_MAX:
            raise OverflowError(f"hot sweep dispatch {seq} overflows the carry's int32 seq")
        self._seq = seq + 1
        streams = [None] * len(self._devices)
        if self._cuda:
            streams = list(self._streams) if self._streams is not None else [
                torch.cuda.current_stream(dev) for dev in self._devices]
        if self._carry is None:
            self._start(streams)
        METRICS.inc("sweep.ring_refills")
        pdb = self._per_dev_batch
        carry_dev = self._devices[0]
        outs, ready = [], []
        for i, (dev, stream) in enumerate(zip(self._devices, streams)):
            with _on(dev, stream):
                ops = [midstate] + [a[i * pdb:(i + 1) * pdb] for a in (tail_const, bounds)]
                out = kern(*(_to_device(a, dev) for a in ops), th_word=self._words.get(dev))
                if dev != carry_dev:
                    # The output goes to the merge's card, behind the kernel.
                    with _on(carry_dev, streams[0]):
                        out = out.to(carry_dev, non_blocking=True)
                if stream != streams[0]:
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    ready.append((out, ev))
            outs.append(out)
        self._merge_stream = streams[0]
        with _on(carry_dev, streams[0]):
            for out, ev in ready:
                streams[0].wait_event(ev)
                out.record_stream(streams[0])
            words = [self._words[carry_dev]] if self._sieve else []
            probe = self._merge(outs, seq, self._carry, words)
            event = None
            if self._cuda:
                host_probe = torch.empty(2, dtype=torch.int64, pin_memory=True)
                host_probe.copy_(probe, non_blocking=True)
                probe, event = host_probe, torch.cuda.Event()
                event.record(streams[0])
                self._after_merge(streams, event)
        METRICS.inc("sweep.donated_dispatches")
        if self._sieve:
            METRICS.set_gauge("kernel.thresh_staleness", 1.0)
        return _HotToken(seq=seq, probe=probe, event=event, t_enq=_time.monotonic())

    def _after_merge(self, streams, event) -> None:
        """Order every other shard stream's next launch after the merge
        (``event``, recorded on ``streams[0]``).  On another card the first
        such stream also copies the merged threshold word into that card's
        word, and the card's other streams wait on that copy.  Called
        inside the merge stream's context, so a copy across cards is
        ordered on both cards' streams."""
        carry_dev = self._devices[0]
        after = {carry_dev: event}
        for i, dev in enumerate(self._devices):
            if streams[i] == streams[0]:
                continue
            if dev in after:
                streams[i].wait_event(after[dev])
                continue
            streams[i].wait_event(event)
            if self._sieve:
                with _on(dev, streams[i]):
                    self._words[dev].copy_(self._words[carry_dev], non_blocking=True)
            after[dev] = torch.cuda.Event()
            after[dev].record(streams[i])

    def drain(self, token: _HotToken, bases, n_lanes: int) -> float:
        """Block on one dispatch's probe: register its descriptor, prune
        every descriptor the carry can no longer name, and report the
        dispatch's enqueue-to-probe time.  Tokens drain in dispatch
        order."""
        self._bases[token.seq] = (bases, n_lanes)
        if token.event is not None:
            token.event.synchronize()  # blocks until the merge's probe lands
        _best_h0, best_seq = token.probe.tolist()
        self._drained += 1
        # The final winner is this probe's best_seq or a later dispatch
        # (the carry moves only to strictly better, later candidates).
        for s in [s for s in self._bases if s <= token.seq and s != best_seq]:
            del self._bases[s]
        dt = _time.monotonic() - token.t_enq
        METRICS.observe("hist.device_dispatch_s", dt)
        if _trace.enabled():
            _trace.emit(
                None, "kernel", "dispatch_done",
                rows=len(bases), lanes=n_lanes, dt=round(dt, 6),
                ring=self._seq - self._drained, donated=True,
            )
        return dt

    def finish(self) -> Optional[Tuple[int, int]]:
        """The job's one read of the carry, resolved to ``(hash, nonce)``;
        None when no dispatch ran or none produced a valid lane.  Call it
        after every token has drained."""
        if self._carry is None:
            return None
        with _on(self._devices[0], self._merge_stream):
            bh0, bh1, bseq, bdev, bflat = self._carry.tolist()  # the one carry read
        if bflat == I32_MAX:
            return None
        entry = self._bases.get(bseq)
        if entry is None:
            # Reachable only when a drain was dropped (the injected wedge,
            # a close mid-job): the winning dispatch's descriptor is gone.
            raise RuntimeError("hot sweep winner's descriptor was never drained")
        bases, n_lanes = entry
        row = bdev * self._per_dev_batch + bflat // n_lanes
        return ((bh0 << 32) | bh1, bases[row] + bflat % n_lanes)


#: Device-runtime fault injection: ``BMT_WEDGE_DISPATCH=N`` makes the N-th
#: result fetched by the FIRST armed pipeline in this process hang until
#: that pipeline is closed — what a wedged device looks like from outside.
#: One-shot per process, like the reference's.
_WEDGE_STATE = {"fired": False}


class SweepPipeline:
    """Cross-request sweep pipeline: the device never idles between jobs.

    One dispatcher thread enqueues every job's dispatches, FIFO, on a
    dedicated CUDA stream (entered inside that thread: torch's current
    stream is per thread); each dispatch's 3-word output is copied into a
    pinned host buffer and an event is recorded behind it.  A fetcher
    thread waits on those events in the same order and resolves each job's
    future when its last dispatch lands.  ``max_inflight`` bounds the
    unfetched dispatches (backpressure); the sieve threshold is the job's
    running min known at enqueue time.

    Mesh mode (``devices=``, a list of devices, repeats allowed; see
    ``parallel.mesh.resolve_devices``): ``batch`` stays per device and a
    dispatch's rows, ``len(devices) * batch``, are split contiguously over
    the shards.  Each shard has its own CUDA stream; a dispatch makes one
    launch, one 3-word copy into pinned host memory and one event per
    shard, and the fetcher waits on every shard's event before it runs the
    lowest-(device, flat) cascade and folds.  ``devices=None`` is the
    single-device pipeline on ``device``.

    ``hot=True`` (see :func:`auto_hot`): each job gets a :class:`_HotLoop`
    on the same streams; its tokens go through the same fetch queue (so the
    backpressure and the ``BMT_WEDGE_DISPATCH`` drill are unchanged), and
    the job's ``finish`` runs at its ``_DONE``, failing that job alone if
    it raises.

    The reference warms each digit class's kernel ahead of time; here one
    binary serves every class and builds on the first dispatch, so there is
    nothing to prewarm.  ``submit`` is thread-safe.
    """

    _DONE = object()

    def __init__(
        self,
        *,
        max_k: Optional[int] = None,
        batch: Optional[int] = None,
        backend: Optional[str] = None,
        device=None,
        max_inflight: int = 32,
        host_lane_budget: Optional[int] = None,
        sieve: Optional[bool] = None,
        factored: Optional[bool] = None,
        workload=None,
        devices=None,
        hot: Optional[bool] = None,
    ) -> None:
        import queue as _queue
        import threading
        from concurrent.futures import Future

        self._Future = Future
        self._sep, self._host_min, self._family = _workload_knobs(workload)
        self._devices = None
        if devices is not None:
            from ..parallel.mesh import resolve_devices

            self._devices = resolve_devices(devices)
            device = self._devices[0]
        self._device = resolve_device(device)
        (self._backend, self._batch, self._max_k, self._sieve,
         self._factored) = auto_tune(
            backend, batch, max_k, sieve, self._device, factored, self._family
        )
        self._hot = auto_hot(hot, self._backend, self._family)
        self._per_dev_batch = self._batch
        self._streams = None
        if self._devices is not None:
            self._batch = len(self._devices) * self._per_dev_batch
            if self._device.type == "cuda":
                self._streams = [torch.cuda.Stream(d) for d in self._devices]
        self._host_lane_budget = (
            auto_host_lane_budget() if host_lane_budget is None
            else host_lane_budget
        )
        self._stream = (
            torch.cuda.Stream(self._device)
            if self._device.type == "cuda" and self._devices is None else None
        )
        try:
            self._wedge_after = int(_os.environ.get("BMT_WEDGE_DISPATCH", "0") or 0)
        except ValueError:
            self._wedge_after = 0
        self._fetched_count = 0
        self._jobs: "_queue.Queue" = _queue.Queue()
        self._fetches: "_queue.Queue" = _queue.Queue(maxsize=max_inflight)
        self._closed = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="sweep-dispatch", daemon=True
        )
        self._fetcher = threading.Thread(
            target=self._fetch_loop, name="sweep-fetch", daemon=True
        )
        self._dispatcher.start()
        self._fetcher.start()

    def submit(self, data: str, lower: int, upper: int):
        """Queue one sweep; returns a Future of :class:`SweepResult`."""
        if self._closed:
            raise RuntimeError("pipeline closed")
        fut = self._Future()
        self._jobs.put((data, lower, upper, fut))
        return fut

    def close(self) -> None:
        """Stop both worker threads and reap them: the sentinel flows jobs
        -> dispatcher -> fetches -> fetcher, so both exit once work queued
        ahead of it drains.  The joins are timed — a wedged fetch must not
        turn close() into a hang."""
        self._closed = True
        self._jobs.put(None)
        self._dispatcher.join(timeout=1)
        self._fetcher.join(timeout=1)

    # ------------------------------------------------------------- threads

    @staticmethod
    def _fail(fut, e: BaseException) -> None:
        """Resolve a Future to an error, tolerating the dispatcher/fetcher
        race where both observe the same failure."""
        try:
            fut.set_exception(e)
        except Exception:
            pass  # already resolved by the other thread

    def _get_kernel(self, layout, group):
        return _build_kernel(self._backend, layout, group, self._factored)

    def _sharded_candidate(self, shards, bases, n_lanes):
        """The candidate of one mesh-mode dispatch: each shard's output
        (a CPU tensor, or a pinned buffer and its event), then the
        cascade."""
        from ..parallel.sweep import World, _candidate as sharded_candidate

        vals = []
        for out in shards:
            if isinstance(out, tuple):
                host, ev = out
                ev.synchronize()  # blocks until this shard's copy lands
                out = host
            vals.append(out.tolist())
        world = World(offset=0, n_shards=len(self._devices))
        return sharded_candidate(vals, bases, n_lanes, self._per_dev_batch, world)

    def _dispatch_loop(self) -> None:
        ctx = (
            torch.cuda.stream(self._stream) if self._stream is not None
            else contextlib.nullcontext()
        )
        with ctx:
            self._dispatch_jobs()

    def _dispatch_jobs(self) -> None:
        while True:
            item = self._jobs.get()
            if item is None:
                self._fetches.put(None)
                return
            data, lower, upper, fut = item
            state = {"best": [], "lanes": 0, "fut": fut}
            if self._hot:
                state["hot"] = _HotLoop(
                    self._backend, self._sieve, self._devices or [self._device],
                    per_dev_batch=self._per_dev_batch,
                    streams=self._streams if self._stream is None else [self._stream],
                )

            def run_kernel(kern, midstate, tail_const, bounds):
                if self._hot:
                    return state["hot"].dispatch(kern, midstate, tail_const, bounds)
                th = None
                if self._sieve:
                    # The running-min h0 at ENQUEUE time (the fetcher
                    # updates state["best"]; a stale, looser read is
                    # conservative-correct, so no lock).
                    b = state["best"]
                    th = (b[0][0] >> 32) if b else U32_MAX
                    # The contrast number for the hot plane's zero-lag
                    # carry: an operand-shipped threshold is as stale as
                    # the whole in-flight window.
                    METRICS.set_gauge(
                        "kernel.thresh_staleness",
                        float(self._fetches.qsize() + 1),
                    )
                # The enqueue stamp rides with the handle, so the fetcher
                # can report each dispatch's enqueue→fetch time.
                t_enq = _time.monotonic()
                if self._devices is not None:
                    from ..parallel.sweep import sharded_invoke

                    return (sharded_invoke(
                        kern, midstate, tail_const, bounds, self._devices,
                        self._per_dev_batch, thresh=th, streams=self._streams,
                    ), None, t_enq)
                out = _invoke_kernel(
                    kern, self._device, midstate, tail_const, bounds, thresh=th
                )
                if self._stream is None:
                    return (out, None, t_enq)
                host = torch.empty(3, dtype=torch.int64, pin_memory=True)
                host.copy_(out, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._stream)
                return (host, ev, t_enq)

            def consume(out, bases, n_lanes) -> None:
                # Blocks when max_inflight results are unfetched — that's
                # the backpressure; the device queue stays deep meanwhile.
                self._fetches.put((state, out, bases, n_lanes))

            try:
                state["lanes"] = run_sweep_dispatches(
                    data,
                    lower,
                    upper,
                    self._max_k,
                    self._batch,
                    self._get_kernel,
                    run_kernel,
                    consume,
                    host_lane_budget=self._host_lane_budget,
                    sep=self._sep,
                    host_min=self._host_min,
                    family=self._family,
                )
            except BaseException as e:  # resolve, don't kill the pipeline
                self._fail(fut, e)
                continue
            self._fetches.put((state, self._DONE, None, None))

    def _fetch_loop(self) -> None:
        while True:
            item = self._fetches.get()
            if item is None:
                return
            state, out, bases, n_lanes = item
            fut = state["fut"]
            if (
                self._wedge_after
                and out is not self._DONE
                and not _WEDGE_STATE["fired"]
            ):
                self._fetched_count += 1
                if self._fetched_count >= self._wedge_after:
                    # Injected wedge: this fetch never completes until
                    # close().
                    _WEDGE_STATE["fired"] = True
                    while not self._closed:
                        _time.sleep(0.02)
                    continue  # closing: drop the fetch, future stays open
            if out is self._DONE:
                if not fut.done():  # not already failed by the dispatcher
                    best = state["best"]
                    try:
                        if self._hot:
                            cand = state["hot"].finish()
                            if cand is not None:
                                _fold(best, cand)
                    except BaseException as e:
                        self._fail(fut, e)
                        continue
                    if not best:
                        self._fail(
                            fut, RuntimeError("sweep produced no candidates")
                        )
                    else:
                        fut.set_result(
                            SweepResult(
                                hash=best[0][0],
                                nonce=best[0][1],
                                lanes_swept=state["lanes"],
                            )
                        )
                continue
            if fut.done():
                continue  # job already failed; drain its remaining fetches
            if isinstance(out, HostFold):
                _fold(state["best"], (out.hash, out.nonce))
                continue
            try:
                if isinstance(out, _HotToken):
                    state["hot"].drain(out, bases, n_lanes)
                    continue
                vals, ev, t_enq = out
                if self._devices is not None:
                    cand = self._sharded_candidate(vals, bases, n_lanes)
                else:
                    if ev is not None:
                        ev.synchronize()  # blocks until the dispatch lands
                    cand = _candidate(vals.tolist(), bases, n_lanes)
                # Per-dispatch device time: enqueue→fetched.  The fetch
                # above blocked until every shard's 3-word copy landed, so
                # the delta is queue + kernel time, one sample per dispatch
                # (not per shard).
                dt = _time.monotonic() - t_enq
                METRICS.observe("hist.device_dispatch_s", dt)
                if _trace.enabled():
                    # The per-chunk path has no descriptor ring and donates
                    # no carry; the hot plane's drain says the opposite.
                    _trace.emit(
                        None, "kernel", "dispatch_done",
                        rows=len(bases), lanes=n_lanes, dt=round(dt, 6),
                        ring=0, donated=False,
                    )
                if cand is not None:
                    _fold(state["best"], cand)
            except BaseException as e:
                self._fail(fut, e)


def sweep_min_hash(
    data: str,
    lower: int,
    upper: int,
    *,
    max_k: Optional[int] = None,
    batch: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    host_lane_budget: int = 0,
    sieve: Optional[bool] = None,
    factored: Optional[bool] = None,
    workload=None,
    hot: Optional[bool] = None,
) -> SweepResult:
    """Find ``(min Hash(data, n), argmin n)`` over inclusive ``[lower,
    upper]``.  Bit-exact vs the hashlib oracle
    (``bitcoin_miner_tpu_torch.bitcoin.hash_nonce`` for the default,
    ``workload.hash_nonce`` for a registered workload); ties -> lowest
    nonce.

    ``device``: None is the CUDA card (raises without one); ``"cpu"`` runs
    the plain version.  ``backend``/``batch``/``max_k``/``sieve``/
    ``factored``: see :func:`auto_tune`.  ``workload``: see
    :func:`_workload_knobs`.  ``hot``: see :func:`auto_hot`; host-folded
    classes fold on the host, and the carry's candidate joins them at the
    end.
    """
    sep, host_min, family = _workload_knobs(workload)
    dev = resolve_device(device)
    backend, batch, max_k, sieve, factored = auto_tune(
        backend, batch, max_k, sieve, dev, factored, family)
    best: List[Tuple[int, int]] = []  # [(hash, nonce)] — current minimum
    hotloop = (_HotLoop(backend, sieve, [dev], per_dev_batch=batch)
               if auto_hot(hot, backend, family) else None)

    def get_kernel(layout, group):
        return _build_kernel(backend, layout, group, factored)

    def run_kernel(kern, midstate, tail_const, bounds):
        if hotloop is not None:
            return hotloop.dispatch(kern, midstate, tail_const, bounds)
        th = None
        if sieve:
            # The running-min h0 at enqueue time; queued dispatches may
            # carry a stale (looser) bound — conservative-correct.
            th = (best[0][0] >> 32) if best else U32_MAX
        return _invoke_kernel(kern, dev, midstate, tail_const, bounds, thresh=th)

    def consume(out, bases, n_lanes):
        if isinstance(out, HostFold):
            _fold(best, (out.hash, out.nonce))
            return
        if isinstance(out, _HotToken):
            hotloop.drain(out, bases, n_lanes)
            return
        cand = _candidate(out.tolist(), bases, n_lanes)
        if cand is not None:
            _fold(best, cand)

    lanes = run_sweep_dispatches(
        data, lower, upper, max_k, batch, get_kernel, run_kernel, consume,
        host_lane_budget=host_lane_budget, sep=sep, host_min=host_min, family=family,
    )
    if hotloop is not None:
        cand = hotloop.finish()
        if cand is not None:
            _fold(best, cand)
    if not best:
        raise RuntimeError("sweep produced no candidates")
    return SweepResult(hash=best[0][0], nonce=best[0][1], lanes_swept=lanes)
