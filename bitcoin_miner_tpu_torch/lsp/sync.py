"""Blocking facades over the asyncio LSP core.

The reference's frozen APIs are goroutine-blocking (``lsp/client_api.go``,
``lsp/server_api.go``); Python callers (the miner binary, test and smoke
harness threads) get the same shape here: each facade owns a dedicated
event-loop thread and proxies calls with ``run_coroutine_threadsafe``.
Applications that are already async (the server's ``AsyncIngress``) use
:class:`AsyncServer` directly.
"""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import CancelledError as FutureCancelledError
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Coroutine, Optional, Tuple

from ..utils import sanitize, trace
from .aio import AsyncClient, AsyncServer
from .errors import ConnClosedError
from .params import Params


class _LoopThread:
    """A daemon thread running a private asyncio loop.

    Under ``BMT_SANITIZE=1`` the loop joins the sanitizer's
    acquisition-order graph as a lock-shaped resource: blocking proxy
    calls record ``held-locks -> loop`` edges, the loop thread itself
    "holds" its loop name so callbacks taking tracked locks record
    ``loop -> lock``, and a cycle — the Future-spelled ABBA deadlock
    between the serve event lock and an LSP loop — raises
    deterministically.  Calling ``run``/``call`` FROM the owning loop
    thread (a guaranteed self-deadlock: the Future can never resolve while
    its own loop blocks on it) raises RaceError outright."""

    def __init__(self, name: str) -> None:
        self.loop = asyncio.new_event_loop()
        self._stopping = False
        self._san = sanitize.enabled()  # captured once: per-call env reads are hot-path cost
        self._san_name = f"lsp.loop.{name}"

        def _run() -> None:
            if self._san:
                sanitize.loop_thread_enter(self._san_name)
            try:
                self.loop.run_forever()
            finally:
                # Resolve anything scheduled in the stop window: a
                # run_coroutine_threadsafe that raced loop.stop() would
                # otherwise leave its caller blocked forever.
                pending = asyncio.all_tasks(self.loop)
                for t in pending:
                    t.cancel()
                if pending:
                    self.loop.run_until_complete(
                        asyncio.gather(*pending, return_exceptions=True)
                    )
                self.loop.close()

        self._thread = threading.Thread(target=_run, name=name, daemon=True)
        self._thread.start()

    def run(self, coro: "Coroutine", timeout: Optional[float] = None) -> Any:
        if self._san:
            self._observe_entry("run")
        if self._stopping:
            coro.close()
            raise ConnClosedError()
        try:
            fut: Future = asyncio.run_coroutine_threadsafe(coro, self.loop)
        except RuntimeError:  # loop already shut down by close()
            coro.close()
            raise ConnClosedError()
        try:
            return fut.result(timeout)
        except (asyncio.CancelledError, FutureCancelledError):
            # Both spellings: run_coroutine_threadsafe's Future raises the
            # concurrent.futures class when stop() cancels it before the
            # coroutine ran, which is NOT asyncio.CancelledError here.
            raise ConnClosedError()
        except FutureTimeoutError:
            # Deadline expired with the coroutine still pending: cancel it
            # on the loop and surface the builtin TimeoutError.  After a
            # timeout the conn's read stream is undefined; close the conn.
            fut.cancel()
            raise TimeoutError(f"no result within {timeout:g}s")

    def _observe_entry(self, what: str) -> None:
        """Sanitizer coverage for a blocking proxy call (see class
        docstring): refuse self-deadlocks, refuse blocking any OTHER
        registered loop (a loop thread parked on a Future stalls every
        conn riding it, whichever loop resolves it), and record lock-order
        edges."""
        if threading.current_thread() is self._thread:
            raise sanitize.RaceError(
                f"{self._san_name}.{what}() called from its own loop "
                f"thread — the blocking Future can never resolve while "
                f"the loop waits on it (guaranteed deadlock)"
            )
        sanitize.blocking(f"{self._san_name}.{what}")
        sanitize.loop_wait(self._san_name)

    def call(self, fn: Callable, *args: Any) -> Any:
        """Run a plain callable on the loop thread (for non-async mutations
        that must happen on the owning loop)."""
        if self._san:
            self._observe_entry("call")
        done: Future = Future()

        def _invoke() -> None:  # on-loop: runs via call_soon_threadsafe
            try:
                done.set_result(fn(*args))
            except BaseException as e:  # propagate to caller
                done.set_exception(e)

        try:
            self.loop.call_soon_threadsafe(_invoke)
        except RuntimeError:  # loop already shut down by close()
            raise ConnClosedError()
        return done.result()

    def stop(self) -> None:
        self._stopping = True
        try:
            self.loop.call_soon_threadsafe(self.loop.stop)
        except RuntimeError:
            return  # already stopped
        self._thread.join(timeout=5)


def shared_loop(name: str) -> _LoopThread:
    """A caller-owned loop thread many sync facades can share: pass it as
    ``Client(..., loop=...)`` or ``Server(..., loop=...)`` so N conns cost
    ONE thread instead of N (the federation's forwarder pool and its
    federation port ride one).  The caller owns the lifetime: ``stop()`` it
    after closing every facade that rides it (a facade on a borrowed loop
    never stops the loop itself).  The thread keeps ``name``; a facade's
    ``label`` does not rename it."""
    return _LoopThread(name)


class Client:
    """Blocking LSP client (API parity: lsp/client_api.go:6-30).

    ``Client(host, port, params)`` performs the handshake and raises
    CannotEstablishConnectionError after EpochLimit silent epochs.

    ``label`` names the endpoint to the chaos layer (``lspnet.CHAOS``), as
    in the reference; it also names the conn's loop (its thread and its
    sanitizer resource) and rides the ``lsp connect`` trace event.

    ``loop`` borrows a :func:`shared_loop` instead of spawning a private
    loop thread: the conn's coroutines run on the shared loop and
    ``close()`` leaves the loop alive for its owner to stop.
    """

    def __init__(
        self, host: str, port: int, params: Optional[Params] = None,
        label: Optional[str] = None, loop: Optional[_LoopThread] = None,
    ) -> None:
        self._owns_loop = loop is None
        self._lt = loop if loop is not None else _LoopThread(
            f"lsp-client-{label or f'{host}:{port}'}"
        )
        try:
            self._c: AsyncClient = self._lt.run(
                AsyncClient.connect(host, port, params, label=label)
            )
        except BaseException:
            if self._owns_loop:
                self._lt.stop()
            raise
        # Conn-lifecycle trace events: the connect/close pairs bracket each
        # reconnect epoch, so a reader can attribute retransmit bursts to a
        # conn.
        trace.emit(
            None, "lsp", "connect",
            conn=self._c.conn_id, label=label, host=host, port=port,
        )

    def conn_id(self) -> int:
        return self._c.conn_id

    def read(self, timeout: Optional[float] = None) -> bytes:
        """Block until the next in-order message; raises after loss/close.
        ``timeout`` (seconds) raises the builtin ``TimeoutError`` instead
        of blocking forever."""
        return self._lt.run(self._c.read(), timeout)

    def write(self, payload: bytes) -> None:
        self._lt.call(self._c.write, payload)

    def close(self) -> None:
        """Block until pending sends are acked (or the conn is lost).
        Idempotent: a second close is a no-op.  A borrowed shared loop
        stays running for its owner."""
        trace.emit(None, "lsp", "close", conn=self._c.conn_id)
        try:
            self._lt.run(self._c.close())
        except ConnClosedError:
            return  # already closed
        finally:
            if self._owns_loop:
                self._lt.stop()


class Server:
    """Blocking LSP server (API parity: lsp/server_api.go:6-39).
    ``label`` names its endpoint to the chaos layer and its loop, as
    :class:`Client`'s does.  ``loop`` borrows a :func:`shared_loop`, as
    :class:`Client`'s does: the federation port rides its cell's one
    forwarder loop so a cell's thread count is O(1) in peers."""

    def __init__(
        self, port: int, params: Optional[Params] = None, host: str = "127.0.0.1",
        label: Optional[str] = None, loop: Optional[_LoopThread] = None,
    ) -> None:
        self._owns_loop = loop is None
        self._lt = loop if loop is not None else _LoopThread(
            f"lsp-server-{label or f':{port}'}"
        )
        try:
            self._s: AsyncServer = self._lt.run(
                AsyncServer.create(port, params, host, label=label)
            )
        except BaseException:
            if self._owns_loop:
                self._lt.stop()
            raise

    @property
    def port(self) -> int:
        return self._s.port

    def conns_live(self) -> int:
        """Live conns right now (the ``gw.conns_live`` gauge source).
        Same benign snapshot read as :meth:`AsyncServer.conns_live` — a
        dict ``len`` is atomic under the GIL, so no loop hop."""
        return self._s.conns_live()

    def peer_host(self, conn_id: int) -> Optional[str]:
        """The remote host of a live conn (a client identity stable across
        reconnects, unlike the conn id), or None if the conn is already
        gone or the server is closed."""
        try:
            return self._lt.call(self._s.peer_host, conn_id)
        except ConnClosedError:
            return None

    def read(self) -> Tuple[int, bytes]:
        """Block for the next message from any client.  Raises ConnLostError
        (with .conn_id) when a client dies, ConnClosedError once closed."""
        return self._lt.run(self._s.read())

    def write(self, conn_id: int, payload: bytes) -> None:
        self._lt.call(self._s.write, conn_id, payload)

    def close_conn(self, conn_id: int) -> None:
        self._lt.call(self._s.close_conn, conn_id)

    def close(self) -> None:
        """Idempotent graceful shutdown.  A borrowed shared loop stays
        running for its owner."""
        try:
            self._lt.run(self._s.close())
        except ConnClosedError:
            return  # already closed
        finally:
            if self._owns_loop:
                self._lt.stop()
