"""The miner worker binary: Join, then Request→sweep→Result forever.

CLI parity with the reference stub (``bitcoin/miner/miner.go:18-24``):
``miner <hostport>``, with the hash search on one of these backends (the
tiers of the workload's ladder):

- ``cuda``  — the hand-written Hopper kernels through the sweep pipeline
- ``torch`` — their plain PyTorch versions (``--device cpu`` for the CPU;
  by default on the card)
- ``cpu``   — the host loop: the native C++ sweep for ``sha256d`` (the
  hashlib loop where it does not build), a prefix-folded hashlib loop for
  the other workloads
- ``auto``  — ``cuda`` when a CUDA card is visible; without one it is a
  configuration error, never a silent CPU sweep

``--workload sha256d|preimage|blake2b64`` (env ``BMT_WORKLOAD``) picks the
hash family; it must match the server's.  ``--watchdog SECONDS`` wraps the
search in a chain of the requested tier and the workload's host tiers below
it (cuda → cpu → hashlib): a chunk that exceeds the tier's budget re-runs
on the next tier, and every downgrade is counted and logged on stderr.  A
``cuda`` tier that fails to build or launch fails the chunk; it is never
replaced by the plain version.  ``--throttle-nps`` (env
``BMT_MINER_THROTTLE_NPS``) paces the sweep, ``BMT_MINER_LOG`` logs each
chunk's submit and completion, and SIGTERM
drains: the chunks already received are finished and answered before the
miner exits.

``--devices N`` shards each dispatch of a device tier over ``cuda:0`` …
``cuda:N-1`` (``SweepPipeline(devices=)``); with ``--backend torch
--device cpu`` it runs N CPU shards.  ``--multihost --coordinator HOST:PORT
--num-hosts N --host-id I`` makes N processes one logical miner over
``torch.distributed`` (gloo): host 0 talks LSP and broadcasts each Request,
every host sweeps its devices' shards of it (``parallel/multihost.py``).

``--telemetry HOSTPORT`` (env ``BMT_TELEMETRY``) ships this process's
metric snapshots every ``--telemetry-interval`` seconds (default 2.0) to a
server's ``--telemetry-port`` over a second LSP connection, as source
``--source`` (default ``miner-<pid>``); see ``utils/telemetry.py``.  The
miner feeds ``miner.nonces``, ``hist.miner_chunk_s`` and, through the sweep
pipeline and LSP, ``hist.device_dispatch_s`` and ``hist.lsp_rtt_s``, and
prints its lifetime nonce count on stderr when it exits.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from typing import Callable, Optional, Tuple

from .. import lsp
from ..bitcoin.message import Message, MsgType
from ..utils import trace
from ..utils.metrics import METRICS
from ..utils.platform import NoDeviceError

SearchFn = Callable[[str, int, int], Tuple[int, int]]  # -> (hash, nonce)
BACKENDS = ("auto", "cuda", "torch", "cpu")


def _resolve_backend(backend: str, device) -> str:
    """Map ``auto`` onto a rung: ``cuda`` on a card, ``torch`` when the
    caller asked for the CPU; no card and no such request raises."""
    import torch

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} ({'|'.join(BACKENDS)})")
    if backend != "auto":
        return backend
    if device is not None and torch.device(device).type == "cpu":
        return "torch"
    if not torch.cuda.is_available():
        raise ValueError(
            "--backend auto found no CUDA device; pass --backend torch "
            "--device cpu (or --backend cpu) to sweep on the CPU"
        )
    return "cuda"


def _resolve_tier(backend: str, workload, device=None) -> str:
    """Map ``--backend`` onto a workload's tier ladder: ``auto`` as
    :func:`_resolve_backend` resolves it (cuda on a card, torch when the
    CPU was asked for, an error otherwise); a named tier must be on the
    ladder."""
    tier = _resolve_backend(backend, device) if backend in BACKENDS else backend
    if tier in workload.tiers:
        return tier
    raise ValueError(
        f"workload {workload.name!r} has no {backend!r} tier "
        f"(ladder: {'->'.join(workload.tiers)})"
    )


def _time_chunk(fut, lo: int, hi: int, t0: float) -> None:
    """Attach miner-side chunk timing to a search future: submit→solve
    wall time into ``hist.miner_chunk_s`` plus a trace event when armed —
    the miner half of the per-request timeline (the scheduler only sees
    the round trip including the wire).  ``t0`` is taken before the
    submit call, so a ``--throttle-nps`` pace (which sleeps in submit)
    counts as the slower miner it models; the reference stamps after the
    call, which is the same for every search that does not pace."""

    def _done(f) -> None:
        if f.cancelled() or f.exception() is not None:
            return
        dt = time.monotonic() - t0
        METRICS.observe("hist.miner_chunk_s", dt)
        if trace.enabled():
            trace.emit(None, "miner", "chunk_done", lo=lo, hi=hi, dt=round(dt, 6))

    fut.add_done_callback(_done)


def make_search(backend: str = "auto", device=None, workload=None,
                devices=None) -> SearchFn:
    """Build the blocking (data, lower, upper) -> (min_hash, nonce) search.
    ``workload``: a registered workload (or its name); None is the
    default ``sha256d``.  ``devices``: N shards (or a list of shard
    devices) for a device tier; None or 1 is one device."""
    from ..workloads import resolve

    wl = resolve(workload)
    return wl.make_search(_resolve_tier(backend, wl, device), device, devices=devices)


class _PoolSearch:
    """Async facade over a blocking search fn: one worker thread, so
    completion order == submission order (the scheduler matches FIFO)."""

    def __init__(self, fn: SearchFn) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self._fn = fn
        self._pool = ThreadPoolExecutor(max_workers=1)

    def submit(self, data: str, lower: int, upper: int):
        return self._pool.submit(self._fn, data, lower, upper)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class _PipelineSearch:
    """Async facade over :class:`ops.sweep.SweepPipeline`: dispatches of the
    NEXT chunk enqueue on the device while the current chunk computes, so
    back-to-back Requests cost zero device idle."""

    def __init__(
        self, backend: str, device=None, host_lane_budget: Optional[int] = None,
        workload=None, devices=None, hot: Optional[bool] = None,
    ) -> None:
        from concurrent.futures import Future

        from ..ops.sweep import SweepPipeline

        shards = None
        if devices is not None:
            from ..parallel import resolve_devices

            shards, device = resolve_devices(devices, device), None
        self._Future = Future
        self._p = SweepPipeline(
            backend=backend, device=device, host_lane_budget=host_lane_budget,
            workload=workload, devices=shards, hot=hot,
        )

    def submit(self, data: str, lower: int, upper: int):
        out = self._Future()

        def _done(src) -> None:
            e = src.exception()
            if e is not None:
                out.set_exception(e)
            else:
                r = src.result()
                out.set_result((r.hash, r.nonce))

        self._p.submit(data, lower, upper).add_done_callback(_done)
        return out

    def close(self) -> None:
        self._p.close()


def make_async_search(
    backend: str = "auto", device=None, host_lane_budget: Optional[int] = None,
    workload=None, devices=None, hot: Optional[bool] = None,
):
    """Build the async (submit -> Future of (hash, nonce)) search the miner
    serves Requests with: the cross-request SweepPipeline for the ``cuda``
    and ``torch`` rungs (sharded over ``devices`` unless that is None or
    1), a single-worker pool for the host tiers.  ``host_lane_budget``:
    see ``SweepPipeline`` (None = auto).  ``workload``/``devices``: see
    :func:`make_search`.  ``hot``: the default workload's pipeline takes
    it (``ops.sweep.auto_hot``; None is the rung's default, False the
    per-chunk path); other workloads go through their own factory without
    it, as in the reference."""
    from ..workloads import resolve, resolve_nondefault

    wl = resolve(workload)
    return wl.make_async_search(_resolve_tier(backend, wl, device), device,
                                host_lane_budget=host_lane_budget, devices=devices,
                                hot=None if resolve_nondefault(wl) else hot)


def run_miner(
    client: "lsp.Client",
    search,
    close_search: bool = True,
    drain: Optional[threading.Event] = None,
) -> bool:
    """Join and serve Requests until the server connection dies (the
    reference miner's intended lifetime: exit on server loss).
    ``close_search=False`` keeps an externally-owned async search alive
    across calls.  Returns True if the exit was a (reconnect-worthy)
    connection loss, False if the search backend itself failed.

    ``drain`` (the clean scale-down): once set, the loop finishes every
    chunk already received, writes their Results and returns, so the only
    chunks the scheduler re-assigns are ones this miner never answered.
    The miner binary sets it from its SIGTERM handler.

    ``search`` is either a plain ``(data, lo, hi) -> (hash, nonce)``
    callable (wrapped in a one-worker pool) or an async object with
    ``submit(data, lo, hi) -> Future`` (see :func:`make_async_search`).
    Requests are read by a dedicated thread and submitted immediately;
    Results are written in submission (FIFO) order, matching the
    scheduler's pipelined FIFO accounting, so the next chunk's dispatches
    enqueue while the current chunk computes.
    """
    import queue as _queue

    owned = not hasattr(search, "submit")
    asearch = _PoolSearch(search) if owned else search
    client.write(Message.join().marshal())
    inflight: "_queue.Queue" = _queue.Queue()
    _SEARCH_FAILED = object()  # dispatch-time backend failure sentinel

    def reader() -> None:
        while True:
            try:
                payload = client.read()
            except lsp.LspError:
                inflight.put(None)  # server lost/closed → drain and exit
                return
            msg = Message.unmarshal(payload)
            if msg is None or msg.type != MsgType.REQUEST:
                continue
            try:
                t0 = time.monotonic()
                fut = asearch.submit(msg.data, msg.lower, msg.upper)
                _time_chunk(fut, msg.lower, msg.upper, t0)
                inflight.put((fut, msg))
            except Exception as e:
                # Dispatch-time backend failure: a SEARCH failure, not a
                # conn loss.
                inflight.put((_SEARCH_FAILED, e))
                return

    t = threading.Thread(target=reader, name="miner-reader", daemon=True)
    t.start()
    try:
        while True:
            if drain is None:
                item = inflight.get()
            elif drain.is_set():
                try:
                    # Draining: serve out what the reader already queued;
                    # an empty queue means every received chunk is answered.
                    item = inflight.get_nowait()
                except _queue.Empty:
                    trace.emit(None, "miner", "drained")
                    return True
            else:
                try:
                    # Armed but not set: poll, so a SIGTERM between chunks
                    # is noticed without a Request arriving.
                    item = inflight.get(timeout=0.25)
                except _queue.Empty:
                    continue
            if item is None:
                return True
            fut, msg = item
            if fut is _SEARCH_FAILED:
                print(f"miner: search failed: {msg!r}", file=sys.stderr)
                return False
            try:
                h, n = fut.result()
            except Exception as e:
                # A broken backend must not dump a traceback mid-protocol;
                # exit cleanly so the server reassigns.
                print(f"miner: search failed: {e!r}", file=sys.stderr)
                return False
            METRICS.inc("miner.nonces", msg.upper - msg.lower + 1)
            try:
                client.write(Message.result(h, n).marshal())
            except lsp.LspError:
                return True
    finally:
        # Don't block on an in-flight sweep (it may be wedged — that's why
        # we're exiting); daemon threads are reaped with the process.
        if owned or close_search:
            asearch.close()


def run_miner_resilient(
    host: str,
    port: int,
    search,
    params: Optional["lsp.Params"] = None,
    *,
    max_retries: int = 5,
    backoff_base: float = 0.25,
    backoff_cap: float = 8.0,
    label: Optional[str] = None,
    first_client: Optional["lsp.Client"] = None,
    stop: Optional[threading.Event] = None,
    drain: Optional[threading.Event] = None,
    sleep=None,
) -> None:
    """Self-healing miner lifetime: Join/serve until the server connection
    dies, then reconnect with exponential backoff and re-Join on a fresh
    conn, abandoning any stale in-flight chunk (the scheduler re-queues it).

    ``max_retries`` bounds *consecutive* failed connect attempts — any
    successful reconnect resets the budget.  ``stop`` (an Event) ends the
    lifetime at the next reconnect decision.  ``drain`` is forwarded to
    :func:`run_miner`: once set, the current connection answers the chunks
    it received and the lifetime ends (no reconnect).  One async
    ``search`` is reused across connections; plain callables are wrapped
    once.  ``label`` names each conn (``lsp.Client(label=)``) and rides
    the ``reconnect`` / ``gave_up`` trace events.
    """
    from ..utils.retry import backoff_delay

    sleep = time.sleep if sleep is None else sleep
    asearch = _async(search)
    client = first_client
    connected_before = client is not None
    failures = 0

    def pause(delay: float) -> bool:
        """Back off; True if a stop was requested meanwhile."""
        if stop is not None:
            return stop.wait(delay)
        sleep(delay)
        return False

    try:
        while not (stop is not None and stop.is_set()):
            if client is None:
                try:
                    client = lsp.Client(host, port, params, label=label)
                except (lsp.LspError, OSError):
                    failures += 1
                    if failures > max_retries:
                        trace.emit(None, "miner", "gave_up", label=label, attempts=failures)
                        print(
                            f"miner: giving up after {max_retries} reconnect "
                            "attempts", file=sys.stderr,
                        )
                        return
                    if pause(backoff_delay(failures, backoff_base, backoff_cap)):
                        return
                    continue
                if connected_before:
                    METRICS.inc("miner.reconnects")
                    trace.emit(None, "miner", "reconnect", label=label, attempts=failures)
                failures = 0
            connected_before = True
            conn_lost = False
            try:
                conn_lost = run_miner(client, asearch, close_search=False, drain=drain)
            finally:
                try:
                    client.close()
                except lsp.LspError:
                    pass
                client = None
            if drain is not None and drain.is_set():
                return  # clean drain: received work answered; no rejoin
            if not conn_lost:
                # The search backend failed, not the network: reconnecting
                # would just churn join/fail forever against a live server.
                return
            failures += 1
            if failures > max_retries:
                return
            if pause(backoff_delay(failures, backoff_base, backoff_cap)):
                return
    finally:
        asearch.close()


class _TieredSearch:
    """Watchdog-guarded fallback chain over the workload's tiers.

    A wedged device runtime hangs the miner's search future forever; this
    wrapper notices from the inside — a chunk exceeding the tier's wedge
    budget — abandons that tier and re-runs the chunk on the next one, so
    the miner degrades instead of stalling.  The chain holds one device
    tier, the one asked for, then host tiers only (cpu → hashlib): no
    fallback touches the card, except that a hot ``cuda`` tier is followed
    by its per-chunk form (``cuda-perchunk``, the same kernels).  A host or
    ``torch`` tier that raises is downgraded too; the ``cuda`` tiers'
    errors (a kernel that fails to build or launch) fail the chunk instead,
    so their kernels are never silently replaced.  The first tier is built
    here, so a configuration error raises at once.  The budget grows
    ``wedge_growth``× per downgrade: a chunk sized for the card honestly
    takes far longer on a fallback, and a flat budget would read
    slow-but-healthy as wedged.  Every downgrade is
    counted (:attr:`downgrades`) and printed on stderr with the tier, the
    reason and the count.  Chunks are served FIFO by one dispatcher thread
    (which serialises the tiers' sweeps: the price of wedge detection; a
    miner that wants the pipeline's overlap runs without ``--watchdog``).
    """

    #: Tiers whose errors fail the chunk rather than downgrade it.
    _STRICT = ("cuda", "cuda-perchunk")
    _SHUTDOWN = object()

    def __init__(self, tiers, wedge_seconds: float = 30.0,
                 wedge_growth: float = 8.0) -> None:
        import queue as _queue
        from concurrent.futures import Future

        self._Future = Future
        self._chain = list(tiers)  # [(name, factory returning a search)]
        self._idx = 0
        self._wedge = wedge_seconds
        self._growth = wedge_growth
        self._downgrades = 0  # real downgrades only, not build-time skips
        self._closing = False
        self._jobs: "_queue.Queue" = _queue.Queue()
        name, factory = self._chain[0]
        self._active = _async(factory())
        self._active_name: Optional[str] = name
        # A daemon: close() must not block behind a wedged tier's job.
        self._thread = threading.Thread(target=self._loop, name="tiered-search",
                                        daemon=True)
        self._thread.start()

    def submit(self, data: str, lower: int, upper: int):
        out = self._Future()
        self._jobs.put((data, lower, upper, out))
        return out

    def close(self) -> None:
        # Flag first: the dispatcher must see closing before the active
        # tier's futures start failing, or it would "downgrade".
        self._closing = True
        self._jobs.put(self._SHUTDOWN)
        if self._active is not None:
            _swallow(self._active.close)

    @property
    def active_tier(self) -> Optional[str]:
        return self._active_name

    @property
    def downgrades(self) -> int:
        return self._downgrades

    def _tier(self):
        while self._active is None and self._idx < len(self._chain):
            name, factory = self._chain[self._idx]
            try:
                self._active, self._active_name = _async(factory()), name
            except Exception as e:
                print(f"miner: tier {name!r} unavailable ({e!r}); skipping",
                      file=sys.stderr, flush=True)
                self._idx += 1
        return self._active

    def _downgrade(self, why: str) -> None:
        METRICS.inc("miner.tier_downgrades")
        self._downgrades += 1
        # Trace the why: a trace shows which tier was abandoned and for
        # what reason, not just a counter bump.
        trace.emit(None, "miner", "tier_downgrade", tier=self._active_name, why=why,
                   downgrades=self._downgrades)
        nxt = self._chain[self._idx + 1][0] if self._idx + 1 < len(self._chain) else None
        print(f"miner: tier {self._active_name!r} {why}; downgrading to {nxt!r} "
              f"(downgrade {self._downgrades})", file=sys.stderr, flush=True)
        dead = self._active
        self._active, self._active_name = None, None
        self._idx += 1
        if dead is not None:
            # close() may block on the wedged runtime: do it off to the side.
            threading.Thread(target=_swallow, args=(dead.close,), daemon=True).start()

    def _loop(self) -> None:
        from concurrent.futures import TimeoutError as _FutTimeout

        while True:
            item = self._jobs.get()
            if item is self._SHUTDOWN:
                return
            data, lo, hi, out = item
            while True:
                if self._closing:
                    out.set_exception(RuntimeError("search closed"))
                    break
                tier = self._tier()
                if tier is None:
                    out.set_exception(RuntimeError("all search tiers wedged or failed"))
                    break
                budget = self._wedge * (self._growth ** self._downgrades)
                try:
                    out.set_result(tier.submit(data, lo, hi).result(timeout=budget))
                    break
                except _FutTimeout:
                    if self._closing:
                        out.set_exception(RuntimeError("search closed"))
                        break
                    trace.emit(None, "miner", "wedge_detected", tier=self._active_name,
                               budget_s=budget, lo=lo, hi=hi)
                    self._downgrade(f"wedged (> {budget:g}s/chunk)")
                except Exception as e:
                    if self._closing:
                        out.set_exception(RuntimeError("search closed"))
                        break
                    if self._active_name in self._STRICT:
                        out.set_exception(e)
                        break
                    self._downgrade(f"failed ({e!r})")


def _async(search):
    """``search`` as an async search: plain callables get a one-worker pool."""
    return search if hasattr(search, "submit") else _PoolSearch(search)


def _swallow(fn) -> None:
    try:
        fn()
    except Exception:
        pass


def make_tiered_search(backend: str = "auto", device=None,
                       wedge_seconds: float = 30.0, workload=None,
                       devices=None) -> _TieredSearch:
    """The self-healing search: the requested tier, then the host tiers of
    the workload's ladder below it (cpu, hashlib last: pure Python cannot
    wedge).  The one device tier runs on ``device`` (sharded over
    ``devices``, see :func:`make_search`); a wedged card leaves the chain
    for the host, never for another rung on the same card.  ``backend``
    resolves as in :func:`make_async_search`; an unknown workload or tier,
    or a first tier that cannot be built, raises.

    When the hot rung resolves ON for a ``cuda`` first tier of the default
    workload (``ops.sweep.auto_hot``; OFF by default, so this is inert
    until then), a ``cuda-perchunk`` rung (``hot=False``) comes before the
    host tiers, as in the reference: a wedged hot loop need not cost the
    card when the per-chunk form of the same kernels is healthy."""
    from ..ops.sweep import auto_hot
    from ..workloads import resolve, resolve_nondefault
    from ..workloads.base import DEVICE_TIERS

    wl = resolve(workload)
    first = _resolve_tier(backend, wl, device)
    below = wl.tiers[wl.tiers.index(first) + 1:]
    tiers = [first, *(t for t in below if t not in DEVICE_TIERS)]
    if (first == "cuda" and resolve_nondefault(wl) is None
            and auto_hot(None, first, wl.kernel_family)):
        tiers.insert(1, "cuda-perchunk")

    def factory(tier: str):
        if tier == "hashlib":
            return lambda: _PoolSearch(wl.min_range)
        if tier == first:
            return lambda: make_async_search(tier, device, workload=wl, devices=devices)
        if tier == "cuda-perchunk":
            return lambda: make_async_search("cuda", device, workload=wl, devices=devices,
                                             hot=False)
        return lambda: make_async_search(tier, workload=wl)

    return _TieredSearch([(t, factory(t)) for t in tiers], wedge_seconds=wedge_seconds)


def serve_multihost(client, sweep: SearchFn, broadcast) -> None:
    """The primary/secondary Request loop of a multi-host logical miner.

    ``client`` is the primary host's LSP connection (None on secondaries);
    ``sweep(data, lower, upper) -> (hash, nonce)`` is the collective sweep
    every host executes in lockstep; ``broadcast(buf) -> buf`` is the
    host-0-to-all collective.  Factored out of :func:`run_miner_multihost`
    (which supplies the ``torch.distributed`` wiring) so the protocol logic
    is unit-testable on one host.
    """
    from ..parallel.multihost import decode_request, encode_request, encode_shutdown

    while True:
        # host 0 reads the next Request; everyone gets it via broadcast.
        buf = encode_shutdown()
        if client is not None:
            msg = None
            while msg is None or msg.type != MsgType.REQUEST:
                try:
                    msg = Message.unmarshal(client.read())
                except lsp.LspError:
                    msg = None
                    break
            if msg is not None:
                try:
                    buf = encode_request(msg.data, msg.lower, msg.upper)
                except ValueError as e:
                    # Un-broadcastable Request (e.g. oversize data): refuse
                    # loudly — a truncated sweep would return a plausible
                    # but WRONG Result.  Shut the whole logical miner down;
                    # the dropped conn makes the scheduler reassign.
                    print(f"miner: rejecting request: {e}", file=sys.stderr)
        req = decode_request(broadcast(buf))
        if req is None:
            return  # scheduler gone / fatal request: all hosts exit together
        data, lower, upper = req
        h, n = sweep(data, lower, upper)
        if client is not None:
            METRICS.inc("miner.nonces", upper - lower + 1)
            try:
                client.write(Message.result(h, n).marshal())
            except lsp.LspError:
                return


def _multihost_shards(backend: str, device, devices):
    """``(tier, local shard devices)`` of one host of a multi-host miner:
    ``devices`` as in :func:`make_search`, else ``device``, else every
    visible card.  Raises before any host joins the job on a
    configuration it cannot run (a host tier, no card)."""
    import torch

    from ..parallel import default_devices, resolve_devices
    from ..workloads.base import DEVICE_TIERS

    tier = _resolve_backend(backend, device)
    if tier not in DEVICE_TIERS:
        raise ValueError(f"--multihost requires a device tier (cuda/torch), got {tier!r}")
    if devices is not None:
        return tier, resolve_devices(devices, device)
    if device is not None:
        return tier, resolve_devices([torch.device(device)])
    return tier, default_devices()


def run_miner_multihost(hostport: str, coordinator: str, num_hosts: int, host_id: int,
                        *, backend: str = "auto", device=None, devices=None) -> None:
    """One logical miner spanning ``num_hosts`` processes.

    Every process runs the same sharded sweep over the global shard list
    (its own devices' slice of each dispatch; see ``parallel/multihost.py``);
    only host 0 talks LSP to the scheduler and broadcasts each Request's
    parameters to the others.  The default workload only, as in the
    reference.  ``backend``/``device``/``devices``: this host's shards
    (:func:`_multihost_shards`).  The host lane budget is fixed here, the
    same on every host, so every host routes the same digit classes to its
    host fold and calls the same collectives.
    """
    from ..ops.sweep import auto_host_lane_budget
    from ..parallel import multihost, sweep_min_hash_sharded

    tier, local = _multihost_shards(backend, device, devices)
    budget = auto_host_lane_budget()
    multihost.initialize(coordinator, num_hosts, host_id)
    try:
        world = multihost.global_world(local)
        requests = multihost.request_group()

        def broadcast(buf):
            return multihost.broadcast(buf, requests)

        client = None
        if multihost.is_primary():
            host, _, port = hostport.rpartition(":")
            try:
                client = lsp.Client(host or "127.0.0.1", int(port))
            except (lsp.LspError, OSError, ValueError) as e:
                print("Failed to join with server:", e)
                broadcast(multihost.encode_shutdown())
                return
            client.write(Message.join().marshal())

        def sweep(data: str, lower: int, upper: int) -> Tuple[int, int]:
            r = sweep_min_hash_sharded(data, lower, upper, devices=local, backend=tier,
                                       host_lane_budget=budget, world=world)
            return r.hash, r.nonce

        try:
            serve_multihost(client, sweep, broadcast)
        finally:
            if client is not None:
                try:
                    client.close()
                except lsp.LspError:
                    pass
    finally:
        multihost.shutdown()


class _PacedSearch:
    """``--throttle-nps``: sweep at a fixed nonces/s.  The sleep rides the
    reader thread's submit, pacing the whole pipeline without a core."""

    def __init__(self, inner, rate: float) -> None:
        self._inner, self._rate = inner, rate

    def submit(self, data: str, lower: int, upper: int):
        time.sleep((upper - lower + 1) / self._rate)
        return self._inner.submit(data, lower, upper)

    def close(self) -> None:
        self._inner.close()


class _LoggedSearch:
    """``BMT_MINER_LOG``: each chunk's submit and completion on stderr."""

    def __init__(self, inner) -> None:
        self._inner, self._t0 = inner, time.monotonic()

    def submit(self, data: str, lower: int, upper: int):
        t = time.monotonic() - self._t0
        print(f"{t:9.3f} submit [{lower},{upper}] size={upper - lower + 1:.3e}",
              file=sys.stderr, flush=True)
        fut = self._inner.submit(data, lower, upper)

        def done(_f) -> None:
            now = time.monotonic() - self._t0
            print(f"{now:9.3f} done   [{lower},{upper}] dt={now - t:.3f}",
                  file=sys.stderr, flush=True)

        fut.add_done_callback(done)
        return fut

    def close(self) -> None:
        self._inner.close()


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        print(f"Usage: ./{argv[0]} <hostport>", end="")
        return 0
    parser = argparse.ArgumentParser(prog=argv[0], add_help=False)
    parser.add_argument("hostport")
    # Checked by the search factories, so an unknown tier is a
    # configuration error like an unknown workload.
    parser.add_argument("--backend", default="auto")
    # None = the CUDA card; "cpu" is the explicit request for the CPU.
    parser.add_argument("--device", default=None)
    # --reconnect N bounds consecutive failed re-Join attempts after a lost
    # server conn (0 restores the reference's exit-on-loss lifetime).
    parser.add_argument("--reconnect", type=int, default=5)
    # --watchdog SECONDS wraps the search in the workload's tier ladder
    # with a per-chunk wedge budget.
    parser.add_argument("--watchdog", type=float, default=None)
    # Paced capacity: sweep at a fixed nonces/s (sleep-dominated), so N
    # workers on one card model N units of capacity.  BMT_MINER_THROTTLE_NPS
    # is the env spelling, which the autoscaler's spawned workers inherit.
    parser.add_argument(
        "--throttle-nps", type=float,
        default=float(os.environ.get("BMT_MINER_THROTTLE_NPS", "0") or 0),
    )
    # The hash family; must match the server's (the wire never names it).
    parser.add_argument("--workload", default=os.environ.get("BMT_WORKLOAD") or None)
    # Shards of a device tier: cuda:0..N-1, or N CPU shards with --device cpu.
    parser.add_argument("--devices", type=int, default=None)
    # One logical miner over several processes (torch.distributed, gloo).
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--num-hosts", type=int, default=None)
    parser.add_argument("--host-id", type=int, default=None)
    # The telemetry sidecar: periodic metric snapshots to the server's
    # --telemetry-port over a second LSP connection, off the sweep path.
    parser.add_argument("--telemetry", metavar="HOSTPORT",
                        default=os.environ.get("BMT_TELEMETRY") or None)
    parser.add_argument("--telemetry-interval", type=float, default=2.0)
    parser.add_argument("--source", default=None,
                        help="telemetry source name (default miner-<pid>)")
    args = parser.parse_args(argv[1:])
    if args.multihost:
        return _main_multihost(args)
    exporter = None
    try:
        if args.telemetry:
            from ..utils.telemetry import TelemetryExporter

            thost, _, tport = args.telemetry.rpartition(":")
            exporter = TelemetryExporter(
                thost or "127.0.0.1", int(tport),
                args.source or f"miner-{os.getpid()}",
                interval=args.telemetry_interval,
            )
        from ..workloads import resolve as resolve_workload

        workload = resolve_workload(args.workload)
        if args.watchdog is not None:
            search = make_tiered_search(args.backend, args.device,
                                        wedge_seconds=args.watchdog, workload=workload,
                                        devices=args.devices)
        else:
            search = make_async_search(args.backend, args.device, workload=workload,
                                       devices=args.devices)
    except (ValueError, NoDeviceError) as e:
        print("Invalid miner configuration:", e)
        return 0
    if args.throttle_nps > 0:
        search = _PacedSearch(search, args.throttle_nps)
    if os.environ.get("BMT_MINER_LOG"):
        search = _LoggedSearch(search)
    host, _, port = args.hostport.rpartition(":")
    if exporter is not None:
        exporter.start()
    try:
        client = lsp.Client(host or "127.0.0.1", int(port))
    except (lsp.LspError, OSError, ValueError) as e:
        if exporter is not None:
            exporter.stop()
        search.close()
        print("Failed to join with server:", e)
        return 0
    import signal

    # Clean drain: SIGTERM only sets the event; the serve loop answers
    # every chunk already received and returns.  Installing a handler needs
    # the main thread (a caller running main() elsewhere keeps the default).
    drain = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda _s, _f: drain.set())
    except ValueError:
        pass
    t0 = time.monotonic()
    try:
        if args.reconnect > 0:
            run_miner_resilient(
                host or "127.0.0.1", int(port), search,
                max_retries=args.reconnect, first_client=client,
                stop=drain, drain=drain,
            )
        else:
            run_miner(client, search, drain=drain)
    finally:
        if exporter is not None:
            exporter.stop()
        try:
            client.close()
        except lsp.LspError:
            pass
        swept = METRICS.get("miner.nonces")
        dt = max(time.monotonic() - t0, 1e-9)
        print(f"miner: {swept} nonces swept ({swept / dt:,.0f}/s lifetime)",
              file=sys.stderr)
    return 0

def _main_multihost(args) -> int:
    """``main``'s ``--multihost`` branch: the reference's refusals, then
    :func:`run_miner_multihost`."""
    if None in (args.coordinator, args.num_hosts, args.host_id):
        print("--multihost requires --coordinator, --num-hosts, --host-id")
        return 0
    from ..workloads import resolve_nondefault

    try:
        nondefault = resolve_nondefault(args.workload)
        if nondefault is not None:
            # Lockstep sweep over every host: the frozen default only.
            raise ValueError("--multihost supports the default workload only")
        _multihost_shards(args.backend, args.device, args.devices)
    except (ValueError, NoDeviceError) as e:
        print("Invalid miner configuration:", e)
        return 0
    run_miner_multihost(args.hostport, args.coordinator, args.num_hosts, args.host_id,
                        backend=args.backend, device=args.device, devices=args.devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
