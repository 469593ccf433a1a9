"""Mining application wire protocol — Go-JSON-compatible.

Parity: reference ``bitcoin/message.go:9-49`` — ``MsgType`` (Join=0,
Request=1, Result=2) and ``Message{Type, Data, Lower, Upper, Hash, Nonce}``.
``Lower/Upper/Hash/Nonce`` are uint64 in Go; Python ints round-trip them
exactly through JSON.  Messages are marshalled to bytes before being handed
to the LSP transport (bitcoin/message.go:16-17).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from enum import IntEnum
from typing import Optional

U64_MASK = (1 << 64) - 1


class MsgType(IntEnum):
    JOIN = 0
    REQUEST = 1
    RESULT = 2


@dataclass
class Message:
    type: MsgType = MsgType.JOIN
    data: str = ""
    lower: int = 0
    upper: int = 0
    hash: int = 0
    nonce: int = 0

    # -- constructors mirroring bitcoin/message.go:27-49 ---------------------

    @staticmethod
    def request(data: str, lower: int, upper: int) -> "Message":
        return Message(type=MsgType.REQUEST, data=data, lower=lower, upper=upper)

    @staticmethod
    def result(hash_: int, nonce: int) -> "Message":
        return Message(type=MsgType.RESULT, hash=hash_, nonce=nonce)

    @staticmethod
    def join() -> "Message":
        return Message(type=MsgType.JOIN)

    # -- codec ---------------------------------------------------------------

    def marshal(self) -> bytes:
        obj = {
            "Type": int(self.type),
            "Data": self.data,
            "Lower": self.lower & U64_MASK,
            "Upper": self.upper & U64_MASK,
            "Hash": self.hash & U64_MASK,
            "Nonce": self.nonce & U64_MASK,
        }
        return json.dumps(obj, separators=(",", ":")).encode("utf-8")

    @staticmethod
    def unmarshal(buf: bytes) -> Optional["Message"]:
        try:
            obj = json.loads(buf.decode("utf-8"))
            if not isinstance(obj, dict):
                return None
            u64s = []
            for field in ("Lower", "Upper", "Hash", "Nonce"):
                v = obj.get(field, 0)
                # Go json.Unmarshal rejects non-integer or out-of-range
                # values for uint64 struct fields; a poison Request must not
                # reach the sweep.
                if isinstance(v, bool) or not isinstance(v, int):
                    return None
                if v < 0 or v > U64_MASK:
                    return None
                u64s.append(v)
            type_ = obj.get("Type", 0)
            if isinstance(type_, bool) or not isinstance(type_, int):
                return None
            data = obj.get("Data", "")
            if not isinstance(data, str):
                return None  # Go rejects non-string JSON for a string field
            return Message(
                type=MsgType(type_),
                data=data,
                lower=u64s[0],
                upper=u64s[1],
                hash=u64s[2],
                nonce=u64s[3],
            )
        except (ValueError, TypeError, UnicodeDecodeError):
            return None

    def __str__(self) -> str:  # bitcoin/message.go:51-62
        if self.type == MsgType.REQUEST:
            return f"[Request {self.data} {self.lower} {self.upper}]"
        if self.type == MsgType.RESULT:
            return f"[Result {self.hash} {self.nonce}]"
        return "[Join]"
