"""LSP — the Live Sequence Protocol reliable-UDP transport (L2).

Public surface mirrors the reference's frozen APIs
(``lsp/client_api.go``, ``lsp/server_api.go``):

- :class:`Client` — ``conn_id() / read() / write() / close()`` (sync facade)
- :class:`Server` — ``read() / write() / close_conn() / close()`` (sync facade)
- :class:`AsyncClient` / :class:`AsyncServer` — the asyncio-native core
- :class:`Params`, :class:`Message`, errors
"""

from .aio import AsyncClient, AsyncServer
from .errors import (
    CannotEstablishConnectionError,
    ConnClosedError,
    ConnLostError,
    LspError,
    MAX_MESSAGE_SIZE,
)
from .message import Message, MsgType
from .params import Params
from .sync import Client, Server, shared_loop

__all__ = [
    "AsyncClient",
    "AsyncServer",
    "Client",
    "Server",
    "Message",
    "MsgType",
    "Params",
    "LspError",
    "ConnClosedError",
    "ConnLostError",
    "CannotEstablishConnectionError",
    "MAX_MESSAGE_SIZE",
    "shared_loop",
]
