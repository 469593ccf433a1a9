"""asyncio-UDP endpoints (L1).

Parity: reference ``lspnet/conn.go`` + ``lspnet/net.go`` — a thin wrapper
over real datagram sockets.  The JAX package's copy adds drop/mutation
fault knobs and a chaos layer for its test suites; the port's slice carries
the plain endpoint only.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Tuple

Addr = Tuple[str, int]


class _QueueProtocol(asyncio.DatagramProtocol):
    def __init__(self) -> None:
        self.queue: asyncio.Queue = asyncio.Queue()
        self.transport: Optional[asyncio.DatagramTransport] = None

    def connection_made(self, transport) -> None:  # pragma: no cover - trivial
        self.transport = transport

    def datagram_received(self, data: bytes, addr: Addr) -> None:
        self.queue.put_nowait((data, addr))

    def error_received(self, exc) -> None:  # ICMP errors etc: ignore like UDP
        pass


class UDPEndpoint:
    """A datagram endpoint with an awaitable ``recv`` and fire-and-forget
    ``send``."""

    def __init__(
        self, transport: asyncio.DatagramTransport, protocol: _QueueProtocol,
        remote: Optional[Addr] = None,
    ) -> None:
        self._transport = transport
        self._protocol = protocol
        self._remote = remote
        self._closed = False

    @property
    def local_addr(self) -> Addr:
        return self._transport.get_extra_info("sockname")[:2]

    async def recv(self) -> Tuple[bytes, Addr]:
        """Await the next datagram."""
        data, addr = await self._protocol.queue.get()
        if data is None:  # close sentinel
            raise ConnectionError("endpoint closed")
        return data, addr

    def send(self, data: bytes, addr: Optional[Addr] = None) -> None:
        """Fire-and-forget datagram send (UDP semantics: no delivery
        guarantee)."""
        if self._closed:
            return
        if addr is None:
            addr = self._remote
        if addr is None:
            raise ValueError("no destination address")
        self._transport.sendto(data, addr)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._protocol.queue.put_nowait((None, ("", 0)))
            self._transport.close()


async def create_server_endpoint(
    host: str = "127.0.0.1", port: int = 0
) -> UDPEndpoint:
    """Bind a server-side endpoint (port 0 -> ephemeral)."""
    loop = asyncio.get_running_loop()
    transport, protocol = await loop.create_datagram_endpoint(
        _QueueProtocol, local_addr=(host, port)
    )
    return UDPEndpoint(transport, protocol)


async def create_client_endpoint(host: str, port: int) -> UDPEndpoint:
    """Create a client-side endpoint targeting ``host:port``.

    Not connect()ed at the OS level: we record the remote address instead,
    so the endpoint keeps receiving even across server socket rebinds, and
    reply-address checks stay in the LSP layer (like the Go client's use of
    DialUDP, net.go:60-79, but without kernel-level filtering).
    """
    loop = asyncio.get_running_loop()
    transport, protocol = await loop.create_datagram_endpoint(
        _QueueProtocol,
        local_addr=(
            "127.0.0.1" if host in ("127.0.0.1", "localhost") else "0.0.0.0", 0
        ),
    )
    return UDPEndpoint(transport, protocol, remote=(host, port))
