"""LSP sentinel errors and limits.

Parity: reference ``lsp/util.go:8-16``.
"""


class LspError(Exception):
    """Base class for LSP transport errors."""


class ConnClosedError(LspError):
    """The connection has been closed (locally or by drain completion)."""

    def __init__(self, msg: str = "connection closed") -> None:
        super().__init__(msg)


class ConnLostError(LspError):
    """The connection was declared lost after EpochLimit silent epochs.

    Carries the conn_id so a multiplexed server Read can surface *which*
    connection died (fixes reference quirk SURVEY §8.3 where server.Read
    returned (-1, nil, nil))."""

    def __init__(self, conn_id: int = -1, msg: str = "connection lost") -> None:
        super().__init__(f"{msg} (conn_id={conn_id})")
        self.conn_id = conn_id


class CannotEstablishConnectionError(LspError):
    """Client handshake gave up after EpochLimit epochs (lsp/util.go:12)."""

    def __init__(self, msg: str = "can not establish connection") -> None:
        super().__init__(msg)


# Max size of a single LSP datagram's recv buffer (lsp/util.go:16).
MAX_MESSAGE_SIZE = 1000
