"""Mining application protocol (L3): wire messages + hash contract."""

from .hash import hash_nonce, min_hash_range
from .message import Message, MsgType, U64_MASK

__all__ = ["Message", "MsgType", "U64_MASK", "hash_nonce", "min_hash_range"]
