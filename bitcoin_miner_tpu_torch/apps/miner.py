"""The miner worker binary: Join, then Request→sweep→Result forever.

CLI parity with the reference stub (``bitcoin/miner/miner.go:18-24``):
``miner <hostport>``, with the hash search on one of these backends:

- ``cuda``  — the hand-written Hopper kernel through the sweep pipeline
- ``torch`` — the kernel's plain PyTorch version (``--device cpu`` for the
  CPU; by default on the card)
- ``cpu``   — the hashlib loop, bit-identical to the Go reference miner
- ``auto``  — ``cuda`` when a CUDA card is visible; without one it is a
  configuration error, never a silent CPU sweep

Not ported yet: the watchdog tier ladder, ``--devices``, multihost,
telemetry, throttling and workloads other than the default.
"""

from __future__ import annotations

import argparse
import sys
import threading
from typing import Callable, Optional, Tuple

from .. import lsp
from ..bitcoin.hash import min_hash_range
from ..bitcoin.message import Message, MsgType
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


def make_search(backend: str = "auto", device=None) -> SearchFn:
    """Build the blocking (data, lower, upper) -> (min_hash, nonce) search."""
    backend = _resolve_backend(backend, device)
    if backend == "cpu":
        return min_hash_range
    from ..ops.sweep import sweep_min_hash

    def search(data: str, lower: int, upper: int) -> Tuple[int, int]:
        r = sweep_min_hash(data, lower, upper, backend=backend, device=device)
        return r.hash, r.nonce

    return search


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
        self, backend: str, device=None, host_lane_budget: Optional[int] = None
    ) -> None:
        from concurrent.futures import Future

        from ..ops.sweep import SweepPipeline

        self._Future = Future
        self._p = SweepPipeline(
            backend=backend, device=device, host_lane_budget=host_lane_budget
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
    backend: str = "auto", device=None, host_lane_budget: Optional[int] = None
):
    """Build the async (submit -> Future of (hash, nonce)) search the miner
    serves Requests with: the cross-request SweepPipeline for the ``cuda``
    and ``torch`` rungs, a single-worker pool for the hashlib ``cpu`` loop.
    ``host_lane_budget``: see ``SweepPipeline`` (None = auto)."""
    backend = _resolve_backend(backend, device)
    if backend == "cpu":
        return _PoolSearch(min_hash_range)
    return _PipelineSearch(backend, device=device, host_lane_budget=host_lane_budget)


def run_miner(client: "lsp.Client", search, close_search: bool = True) -> bool:
    """Join and serve Requests until the server connection dies (the
    reference miner's intended lifetime: exit on server loss).
    ``close_search=False`` keeps an externally-owned async search alive
    across calls.  Returns True if the exit was a (reconnect-worthy)
    connection loss, False if the search backend itself failed.

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
                inflight.put((asearch.submit(msg.data, msg.lower, msg.upper), msg))
            except Exception as e:
                # Dispatch-time backend failure: a SEARCH failure, not a
                # conn loss.
                inflight.put((_SEARCH_FAILED, e))
                return

    t = threading.Thread(target=reader, name="miner-reader", daemon=True)
    t.start()
    try:
        while True:
            item = inflight.get()
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
    first_client: Optional["lsp.Client"] = None,
    stop: Optional[threading.Event] = None,
    sleep=None,
) -> None:
    """Self-healing miner lifetime: Join/serve until the server connection
    dies, then reconnect with exponential backoff and re-Join on a fresh
    conn, abandoning any stale in-flight chunk (the scheduler re-queues it).

    ``max_retries`` bounds *consecutive* failed connect attempts — any
    successful reconnect resets the budget.  ``stop`` (an Event) ends the
    lifetime at the next reconnect decision.  One async ``search`` is
    reused across connections; plain callables are wrapped once.
    """
    import time as _time

    from ..utils.retry import backoff_delay

    sleep = _time.sleep if sleep is None else sleep
    asearch = _PoolSearch(search) if not hasattr(search, "submit") else search
    client = first_client
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
                    client = lsp.Client(host, port, params)
                except (lsp.LspError, OSError):
                    failures += 1
                    if failures > max_retries:
                        print(
                            f"miner: giving up after {max_retries} reconnect "
                            "attempts", file=sys.stderr,
                        )
                        return
                    if pause(backoff_delay(failures, backoff_base, backoff_cap)):
                        return
                    continue
                failures = 0
            conn_lost = False
            try:
                conn_lost = run_miner(client, asearch, close_search=False)
            finally:
                try:
                    client.close()
                except lsp.LspError:
                    pass
                client = None
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


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        print(f"Usage: ./{argv[0]} <hostport>", end="")
        return 0
    parser = argparse.ArgumentParser(prog=argv[0], add_help=False)
    parser.add_argument("hostport")
    parser.add_argument("--backend", choices=list(BACKENDS), default="auto")
    # None = the CUDA card; "cpu" is the explicit request for the CPU.
    parser.add_argument("--device", default=None)
    # --reconnect N bounds consecutive failed re-Join attempts after a lost
    # server conn (0 restores the reference's exit-on-loss lifetime).
    parser.add_argument("--reconnect", type=int, default=5)
    args = parser.parse_args(argv[1:])
    try:
        search = make_async_search(args.backend, args.device)
    except (ValueError, NoDeviceError) as e:
        print("Invalid miner configuration:", e)
        return 0
    host, _, port = args.hostport.rpartition(":")
    try:
        client = lsp.Client(host or "127.0.0.1", int(port))
    except (lsp.LspError, OSError, ValueError) as e:
        search.close()
        print("Failed to join with server:", e)
        return 0
    try:
        if args.reconnect > 0:
            run_miner_resilient(
                host or "127.0.0.1", int(port), search,
                max_retries=args.reconnect, first_client=client,
            )
        else:
            run_miner(client, search)
    finally:
        try:
            client.close()
        except lsp.LspError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
