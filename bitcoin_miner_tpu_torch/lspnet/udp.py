"""Instrumented asyncio-UDP endpoints (L1).

The port's copy of the JAX package's ``lspnet/udp.py``: the same drop
knobs, payload mutator and chaos hooks, so the port's LSP can be driven
over a lossy loopback network exactly as the reference's is.

Parity: reference ``lspnet/conn.go`` + ``lspnet/net.go`` — a thin wrapper
over real datagram sockets whose reads/writes can probabilistically drop
packets (writes *report success* while dropping, conn.go:102-108) and
mutate Data-message payloads to be shorter/longer than their ``Size`` field
(conn.go:119-146).  The LSP layer is required to go through this seam so
tests can fake lossy networks over loopback (lspnet/net.go:5-7); the
conn-origin registry (net.go:16-22) is realised as the ``is_server`` flag so
client/server drop rates can differ.

Like the reference (conn.go:17-24, a deliberate abstraction break), the
mutator peeks into the JSON wire format rather than importing the lsp
package: it edits the base64 ``Payload`` field in place.  Divergence from
the reference's quirky int-vs-bytes mutation branches (conn.go:123-141):
we always halve / extend the payload bytes — the observable property the
lsp5 suite depends on (len(payload) != Size in the right direction) is
identical.
"""

from __future__ import annotations

import asyncio
import base64
import json
from typing import Optional, Tuple

from .chaos import CHAOS
from .faults import FAULTS

Addr = Tuple[str, int]


def _mutate_datagram(data: bytes) -> bytes:
    """Apply shorten/lengthen mutation to a Data-message datagram."""
    if FAULTS.msg_shorten == 0 and FAULTS.msg_lengthen == 0:
        return data
    try:
        obj = json.loads(data.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return data
    if not isinstance(obj, dict) or obj.get("Type") != 1:
        return data
    raw = obj.get("Payload")
    payload = b"" if raw is None else base64.standard_b64decode(raw)
    shorten = FAULTS.sometimes(FAULTS.msg_shorten)
    lengthen = FAULTS.sometimes(FAULTS.msg_lengthen)
    if shorten:
        payload = payload[: len(payload) // 2]
    elif lengthen:
        payload = payload + b"\x02\x03\x04"
    else:
        return data
    obj["Payload"] = base64.standard_b64encode(payload).decode("ascii")
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


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
    """A fault-injected datagram endpoint.

    ``recv`` applies the read-drop knob (dropped packets are consumed and
    discarded, like conn.go:48-59's retry loop); ``send`` applies the
    write-drop knob (silently succeeding, conn.go:102-108) and the payload
    mutation knobs.
    """

    def __init__(
        self, transport: asyncio.DatagramTransport, protocol: _QueueProtocol,
        is_server: bool, remote: Optional[Addr] = None,
        label: Optional[str] = None,
    ) -> None:
        self._transport = transport
        self._protocol = protocol
        self.is_server = is_server
        #: Chaos identity: lets the NetSim target this endpoint by name
        #: (per-miner partitions etc.); None falls back to the role key.
        self.label = label
        self._remote = remote
        self._closed = False

    @property
    def local_addr(self) -> Addr:
        return self._transport.get_extra_info("sockname")[:2]

    async def recv(self) -> Tuple[bytes, Addr]:
        """Await the next non-dropped datagram."""
        while True:
            data, addr = await self._protocol.queue.get()
            if data is None:  # close sentinel
                raise ConnectionError("endpoint closed")
            if FAULTS.sometimes(FAULTS.read_drop_percent(self.is_server)):
                if FAULTS.debug:
                    print(f"lspnet: DROPPING read packet of length {len(data)}")
                continue
            if CHAOS.on_recv(self.label, self.is_server):
                continue  # rx-partitioned: consumed and discarded
            return data, addr

    def send(self, data: bytes, addr: Optional[Addr] = None) -> None:
        """Fire-and-forget datagram send (UDP semantics: no delivery
        guarantee either way, so a dropped write still 'succeeds').

        The chaos layer may drop, duplicate or delay the datagram; delays
        are scheduled on the owning event loop (every LSP send happens on
        its loop thread), so a delayed copy can land *after* packets sent
        later — which is exactly how reordering reaches the wire."""
        if self._closed:
            return
        if FAULTS.sometimes(FAULTS.write_drop_percent(self.is_server)):
            if FAULTS.debug:
                print(f"lspnet: DROPPING written packet of length {len(data)}")
            return
        drop, dup, delay, _reordered = CHAOS.on_send(
            self.label, self.is_server, len(data)
        )
        if drop:
            if FAULTS.debug:
                print(f"lspnet: CHAOS dropped packet of length {len(data)}")
            return
        data = _mutate_datagram(data)
        if addr is None:
            addr = self._remote
        if addr is None:
            raise ValueError("no destination address")
        copies = 2 if dup else 1
        if delay > 0.0:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None  # not on a loop (shouldn't happen): send now
            if loop is not None:
                for _ in range(copies):
                    loop.call_later(delay, self._send_late, data, addr)
                return
        for _ in range(copies):
            self._transport.sendto(data, addr)

    def _send_late(self, data: bytes, addr: Addr) -> None:
        """Deliver a chaos-delayed datagram, unless we closed meanwhile."""
        if self._closed:
            return
        try:
            self._transport.sendto(data, addr)
        except Exception:
            pass  # transport torn down mid-delay: the packet is just lost

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._protocol.queue.put_nowait((None, ("", 0)))
            self._transport.close()


async def create_server_endpoint(
    host: str = "127.0.0.1", port: int = 0, label: Optional[str] = None
) -> UDPEndpoint:
    """Bind a server-side endpoint (port 0 -> ephemeral)."""
    loop = asyncio.get_running_loop()
    transport, protocol = await loop.create_datagram_endpoint(
        _QueueProtocol, local_addr=(host, port)
    )
    return UDPEndpoint(transport, protocol, is_server=True, label=label)


async def create_client_endpoint(
    host: str, port: int, label: Optional[str] = None
) -> UDPEndpoint:
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
    return UDPEndpoint(
        transport, protocol, is_server=False, remote=(host, port), label=label
    )
