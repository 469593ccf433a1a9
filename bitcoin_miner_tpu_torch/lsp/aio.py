"""Asyncio-native LSP endpoints (L2).

The reference's goroutine trio (connect loop / network reader / event loop,
``lsp/client_impl.go:105-140,196-275``) becomes asyncio tasks owned by one
event loop; per-connection state is a :class:`ConnCore`.  The server fixes
the reference quirks (SURVEY §8): per-conn epoch timers instead of one
shared ticker, a complete close/drain path, duplicate-Connect dedupe by
remote address, and loss errors that carry the dead conn_id.

Sync facades with the frozen Go-style blocking API live in sync.py.
"""

from __future__ import annotations

import asyncio
import socket
from typing import Dict, Optional, Tuple

from .. import lspnet
from .conn import ConnCore
from .errors import (
    CannotEstablishConnectionError,
    ConnClosedError,
    ConnLostError,
    MAX_MESSAGE_SIZE,
)
from .message import Message, MsgType
from .params import Params

Addr = Tuple[str, int]


def _decode(data: bytes) -> Optional[Message]:
    """Wire -> Message with the reference's 1000-byte read buffer semantics:
    oversized datagrams are truncated (=> junk JSON => dropped)
    (lsp/util.go:16, client_impl.go:393-405)."""
    if len(data) > MAX_MESSAGE_SIZE:
        data = data[:MAX_MESSAGE_SIZE]
    return Message.unmarshal(data)


class AsyncClient:
    """Client endpoint: ``connect`` / ``read`` / ``write`` / ``close``
    (API parity: lsp/client_api.go:6-30)."""

    def __init__(self, endpoint: lspnet.UDPEndpoint, params: Params) -> None:
        self._endpoint = endpoint
        self._params = params
        self._conn: Optional[ConnCore] = None
        self._read_q: asyncio.Queue = asyncio.Queue()
        self._tasks: list = []
        self._closed = False  # close() completed
        self._done = asyncio.Event()  # drain finished or conn lost

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    async def connect(
        cls, host: str, port: int, params: Optional[Params] = None,
        label: Optional[str] = None,
    ) -> "AsyncClient":
        """Handshake: send Connect, resend every epoch, give up after
        EpochLimit epochs (client_impl.go:105-139; rule 1 of SURVEY §2.2).
        ``label`` names this endpoint to the chaos layer (lspnet.CHAOS)."""
        params = params or Params()
        endpoint = await lspnet.create_client_endpoint(host, port, label=label)
        self = cls(endpoint, params)
        # Datagrams from any other source must be ignored (the socket is
        # deliberately unconnected at the OS level — see lspnet.udp).
        # Resolve via the loop: gethostbyname would block the event loop —
        # and every other connection on it — for the resolver timeout.
        infos = await asyncio.get_running_loop().getaddrinfo(
            host, port, family=socket.AF_INET, type=socket.SOCK_DGRAM
        )
        self._peer = infos[0][4][:2]
        connect_wire = Message.connect()
        self._endpoint.send(connect_wire.marshal())
        epochs = 0
        while True:
            try:
                data, addr = await asyncio.wait_for(
                    endpoint.recv(), timeout=params.epoch_seconds
                )
            except asyncio.TimeoutError:
                epochs += 1
                if epochs > params.epoch_limit:
                    endpoint.close()
                    raise CannotEstablishConnectionError()
                self._endpoint.send(connect_wire.marshal())
                continue
            if addr[:2] != self._peer:
                continue
            msg = _decode(data)
            if msg is not None and msg.type == MsgType.ACK and msg.seq_num == 0:
                conn = ConnCore(
                    msg.conn_id, params, self._send_msg, self._read_q.put_nowait
                )
                self._conn = conn
                break
            # anything else pre-handshake: ignore
        self._tasks = [
            asyncio.ensure_future(self._reader_loop()),
            asyncio.ensure_future(self._epoch_loop()),
        ]
        return self

    def _send_msg(self, msg: Message) -> None:
        self._endpoint.send(msg.marshal())

    # -- API -----------------------------------------------------------------

    @property
    def conn_id(self) -> int:
        assert self._conn is not None
        return self._conn.conn_id

    async def read(self) -> bytes:
        """Blocking ordered read; raises ConnLostError / ConnClosedError
        after buffered messages are drained (client_api.go:12-16)."""
        item = await self._read_q.get()
        if isinstance(item, Exception):
            self._read_q.put_nowait(item)  # subsequent reads keep failing
            raise item
        return item

    def write(self, payload: bytes) -> None:
        """Non-blocking send (client_api.go:18-21)."""
        conn = self._conn
        assert conn is not None
        if self._closed or conn.closing:
            raise ConnClosedError()
        if conn.lost:
            raise ConnLostError(conn.conn_id)
        conn.write(payload)

    async def close(self) -> None:
        """Block until all pending sends are acked, then shut down
        (client_api.go:23-29; fixes SURVEY §8.2's broken drain)."""
        conn = self._conn
        if conn is None or self._closed:
            return
        conn.begin_close()
        if conn.lost or conn.drained:
            self._done.set()
        await self._done.wait()
        await self._shutdown(ConnClosedError())

    async def _shutdown(self, read_err: Exception) -> None:
        self._closed = True
        for t in self._tasks:
            t.cancel()
        self._endpoint.close()
        self._read_q.put_nowait(read_err)

    # -- internal loops ------------------------------------------------------

    async def _reader_loop(self) -> None:
        conn = self._conn
        assert conn is not None
        try:
            while True:
                data, addr = await self._endpoint.recv()
                if addr[:2] != self._peer:
                    continue  # not our server: ignore strays/spoofs
                msg = _decode(data)
                if msg is None:
                    continue
                conn.heard_from_peer()
                if msg.type == MsgType.DATA:
                    conn.on_data(msg)
                elif msg.type == MsgType.ACK:
                    conn.on_ack(msg.seq_num)
                    if conn.closing and conn.drained:
                        self._done.set()
        except (asyncio.CancelledError, ConnectionError):
            pass

    async def _epoch_loop(self) -> None:
        conn = self._conn
        assert conn is not None
        try:
            while True:
                await asyncio.sleep(self._params.epoch_seconds)
                if conn.on_epoch():  # lost
                    # Stop the reader first so no late retransmits can land
                    # in the read queue *after* the loss error — reads must
                    # drain buffered data, then fail persistently.
                    self._tasks[0].cancel()
                    self._endpoint.close()
                    self._read_q.put_nowait(ConnLostError(conn.conn_id))
                    self._done.set()
                    return
        except asyncio.CancelledError:
            pass


class _ServerConn:
    """Server-side bookkeeping for one connection."""

    def __init__(self, core: ConnCore, addr: Addr) -> None:
        self.core = core
        self.addr = addr
        self.epoch_task: Optional[asyncio.Task] = None
        self.server_initiated_close = False


class AsyncServer:
    """Multiplexed server endpoint: ``read`` / ``write`` / ``close_conn`` /
    ``close`` (API parity: lsp/server_api.go:6-39)."""

    def __init__(self, endpoint: lspnet.UDPEndpoint, params: Params) -> None:
        self._endpoint = endpoint
        self._params = params
        self._conns: Dict[int, _ServerConn] = {}
        self._by_addr: Dict[Addr, int] = {}
        self._next_id = 1  # conn ids assigned from a counter (server_impl.go:117,145)
        self._read_q: asyncio.Queue = asyncio.Queue()
        self._reader_task: Optional[asyncio.Task] = None
        self._closing = False  # close() in progress: no new connections
        self._closed = False
        self._drained = asyncio.Event()  # set when closing and no conns left

    @classmethod
    async def create(
        cls, port: int, params: Optional[Params] = None, host: str = "127.0.0.1",
        label: Optional[str] = None,
    ) -> "AsyncServer":
        params = params or Params()
        endpoint = await lspnet.create_server_endpoint(host, port, label=label)
        self = cls(endpoint, params)
        self._reader_task = asyncio.ensure_future(self._reader_loop())
        return self

    @property
    def port(self) -> int:
        return self._endpoint.local_addr[1]

    def conns_live(self) -> int:
        """Live (handshaken, not yet finished) conns right now — the
        ``gw.conns_live`` gauge source.  A plain ``len`` of the conn table:
        atomic under the GIL, so the serve ticker may read it from its own
        thread without a loop hop."""
        return len(self._conns)

    def peer_host(self, conn_id: int) -> Optional[str]:
        """The remote host of a live connection, or None once it is gone:
        a client identity that is stable across reconnects, unlike the
        conn id and the UDP source port."""
        sc = self._conns.get(conn_id)
        return sc.addr[0] if sc is not None else None

    # -- API -----------------------------------------------------------------

    async def read(self) -> Tuple[int, bytes]:
        """Blocking multiplexed read.  Raises ConnLostError carrying the
        dead conn_id (fixing SURVEY §8.3), ConnClosedError once the server
        is closed."""
        item = await self._read_q.get()
        if isinstance(item, Exception):
            if isinstance(item, ConnClosedError):
                self._read_q.put_nowait(item)
            raise item
        return item

    def write(self, conn_id: int, payload: bytes) -> None:
        """Non-blocking send to one connection (server_api.go:18-22)."""
        sc = self._conns.get(conn_id)
        if sc is None or sc.core.closing or self._closed:
            raise ConnClosedError(f"connection {conn_id} does not exist or is closed")
        if sc.core.lost:
            raise ConnLostError(conn_id)
        sc.core.write(payload)

    def close_conn(self, conn_id: int) -> None:
        """Begin a non-blocking graceful drain of one connection
        (server_api.go:24-28)."""
        sc = self._conns.get(conn_id)
        if sc is None:
            raise ConnClosedError(f"connection {conn_id} does not exist")
        sc.server_initiated_close = True
        sc.core.begin_close()
        if sc.core.drained:
            self._finish_conn(sc)

    async def close(self) -> None:
        """Drain every connection, then shut the socket down
        (server_api.go:30-38; fixes the reference's deadlock-prone path,
        SURVEY §8.2)."""
        if self._closed:
            return
        self._closing = True  # reader stops minting conns for new Connects
        for sc in list(self._conns.values()):
            sc.server_initiated_close = True
            sc.core.begin_close()
            if sc.core.drained:
                self._finish_conn(sc)
        if not self._conns:
            self._drained.set()
        # Event-driven: _finish_conn fires the event when the last conn
        # drains (final ack) or is declared lost — no polling tick.
        await self._drained.wait()
        self._closed = True
        if self._reader_task:
            self._reader_task.cancel()
        self._endpoint.close()
        self._read_q.put_nowait(ConnClosedError())

    # -- internals -----------------------------------------------------------

    def _finish_conn(self, sc: _ServerConn) -> None:
        """Remove a fully-drained (or lost) connection."""
        sc.core.finished = True
        if sc.epoch_task:
            sc.epoch_task.cancel()
        self._conns.pop(sc.core.conn_id, None)
        self._by_addr.pop(sc.addr, None)
        if self._closing and not self._conns:
            self._drained.set()

    def _new_conn(self, addr: Addr) -> _ServerConn:
        conn_id = self._next_id
        self._next_id += 1
        core = ConnCore(
            conn_id,
            self._params,
            lambda msg, a=addr: self._endpoint.send(msg.marshal(), a),
            lambda payload, cid=conn_id: self._read_q.put_nowait((cid, payload)),
        )
        sc = _ServerConn(core, addr)
        self._conns[conn_id] = sc
        self._by_addr[addr] = conn_id
        sc.epoch_task = asyncio.ensure_future(self._epoch_loop(sc))
        return sc

    async def _reader_loop(self) -> None:
        try:
            while True:
                data, addr = await self._endpoint.recv()
                msg = _decode(data)
                if msg is None:
                    continue
                if msg.type == MsgType.CONNECT:
                    # Dedupe retried Connects by remote address: re-ack the
                    # existing conn instead of minting a duplicate (fixes a
                    # reference quirk; required for slow-start, lsp3).
                    cid = self._by_addr.get(addr)
                    if cid is None:
                        if self._closing:
                            continue  # draining: refuse new connections
                        sc = self._new_conn(addr)
                    else:
                        sc = self._conns[cid]
                    sc.core.heard_from_peer()
                    self._endpoint.send(
                        Message.ack(sc.core.conn_id, 0).marshal(), addr
                    )
                    continue
                sc = self._conns.get(msg.conn_id)
                if sc is None or sc.addr != addr:
                    continue
                sc.core.heard_from_peer()
                if msg.type == MsgType.DATA:
                    sc.core.on_data(msg)
                elif msg.type == MsgType.ACK:
                    sc.core.on_ack(msg.seq_num)
                    if sc.core.closing and sc.core.drained:
                        self._finish_conn(sc)
        except (asyncio.CancelledError, ConnectionError):
            pass

    async def _epoch_loop(self, sc: _ServerConn) -> None:
        """Per-connection epoch ticker (fixes the shared-ticker quirk,
        SURVEY §8.1)."""
        try:
            while True:
                await asyncio.sleep(self._params.epoch_seconds)
                if sc.core.on_epoch():  # lost
                    if not sc.server_initiated_close:
                        self._read_q.put_nowait(ConnLostError(sc.core.conn_id))
                    self._finish_conn(sc)
                    return
        except asyncio.CancelledError:
            pass
