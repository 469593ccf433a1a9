"""LSP wire message — Go-JSON-compatible codec.

Parity: reference ``lsp/message.go:11-23`` defines ``MsgType``
(Connect=0, Data=1, Ack=2) and ``Message{Type, ConnID, SeqNum, Size,
Payload}``.  Go's ``encoding/json`` marshals a ``[]byte`` payload as a
standard-base64 string (``null`` when nil), and field names are the exported
struct names verbatim — this codec is byte-compatible with that format so a
rebuilt endpoint interoperates with packets captured from the Go reference
(``lsp/util.go:19-33``).
"""

from __future__ import annotations

import base64
import binascii
import json
from dataclasses import dataclass
from enum import IntEnum
from typing import Optional


class MsgType(IntEnum):
    CONNECT = 0
    DATA = 1
    ACK = 2


@dataclass
class Message:
    type: MsgType = MsgType.CONNECT
    conn_id: int = 0
    seq_num: int = 0
    size: int = 0
    payload: Optional[bytes] = None

    # -- constructors mirroring lsp/message.go:26-49 -------------------------

    @staticmethod
    def connect() -> "Message":
        return Message(type=MsgType.CONNECT)

    @staticmethod
    def data(conn_id: int, seq_num: int, size: int, payload: bytes) -> "Message":
        return Message(
            type=MsgType.DATA,
            conn_id=conn_id,
            seq_num=seq_num,
            size=size,
            payload=payload,
        )

    @staticmethod
    def ack(conn_id: int, seq_num: int) -> "Message":
        return Message(type=MsgType.ACK, conn_id=conn_id, seq_num=seq_num)

    # -- codec ---------------------------------------------------------------

    def marshal(self) -> bytes:
        """Serialise exactly like Go ``json.Marshal`` on the reference struct."""
        payload: Optional[str]
        if self.payload is None:
            payload = None
        else:
            payload = base64.standard_b64encode(self.payload).decode("ascii")
        obj = {
            "Type": int(self.type),
            "ConnID": self.conn_id,
            "SeqNum": self.seq_num,
            "Size": self.size,
            "Payload": payload,
        }
        return json.dumps(obj, separators=(",", ":")).encode("utf-8")

    @staticmethod
    def unmarshal(buf: bytes) -> Optional["Message"]:
        """Best-effort decode; returns None on junk (Go's version ignores
        the error and yields a zero Message — we surface None so the caller
        can drop the datagram instead of misreading it as Connect)."""
        try:
            obj = json.loads(buf.decode("utf-8"))
            if not isinstance(obj, dict):
                return None
            raw = obj.get("Payload")
            # validate=True: Go's decoder errors on non-alphabet bytes;
            # the permissive default would silently strip them and misread
            # a corrupted datagram as a shorter payload (tools/analyze
            # contracts pass, codec-poison rule).
            payload = None if raw is None else base64.b64decode(raw, validate=True)
            return Message(
                type=MsgType(int(obj.get("Type", 0))),
                conn_id=int(obj.get("ConnID", 0)),
                seq_num=int(obj.get("SeqNum", 0)),
                size=int(obj.get("Size", 0)),
                payload=payload,
            )
        except (ValueError, KeyError, TypeError, UnicodeDecodeError, binascii.Error):
            return None

    def __str__(self) -> str:  # pretty-printer parity: lsp/message.go:55-68
        name = {MsgType.CONNECT: "Connect", MsgType.DATA: "Data", MsgType.ACK: "Ack"}[
            self.type
        ]
        payload = ""
        if self.type == MsgType.DATA and self.payload is not None:
            payload = " " + self.payload.decode("utf-8", errors="replace")
        return f"[{name} {self.conn_id} {self.seq_num}{payload}]"
