"""The request client binary.

CLI + stdout parity with the reference (``bitcoin/client/client.go:12-48``,
frozen contract): ``client <hostport> <message> <maxNonce>`` prints exactly
``Result <hash> <nonce>`` on success or ``Disconnected`` if the server
connection is lost before the result arrives.

The port's copy of the reference package's ``apps/client.py``;
``request_with_retry(label=)`` names each of its conns to the chaos layer.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, TextIO, Tuple

from .. import lsp
from ..bitcoin.message import Message, MsgType
from ..utils import trace
from ..utils.metrics import METRICS


def request_once(
    client: "lsp.Client",
    message: str,
    max_nonce: int,
    lower: int = 0,
    timeout: Optional[float] = None,
) -> Optional[Tuple[int, int]]:
    """Send the job and block for its Result; None if the conn is lost.
    The CLI's frozen shape is ``[lower=0, max_nonce]``; in-process callers
    may sweep an interior range.

    ``timeout`` (seconds, whole-request deadline) raises the builtin
    ``TimeoutError`` instead of blocking forever.  After a timeout the
    conn's read stream is undefined; the caller should close it."""
    import time as _time

    deadline = None if timeout is None else _time.monotonic() + timeout
    try:
        client.write(Message.request(message, lower, max_nonce).marshal())
    except lsp.LspError:
        # A cached conn whose peer died raises at write time; that is
        # "conn lost" under this function's contract, not an exception —
        # the federation forwarder relies on this to survive the worker.
        return None
    while True:
        remaining = None
        if deadline is not None:
            remaining = max(0.0, deadline - _time.monotonic())
        try:
            payload = client.read(timeout=remaining)
        except lsp.LspError:
            return None
        msg = Message.unmarshal(payload)
        if msg is not None and msg.type == MsgType.RESULT:
            return msg.hash, msg.nonce


def request_with_retry(
    host: str,
    port: int,
    message: str,
    max_nonce: int,
    *,
    retries: int = 3,
    backoff_base: float = 0.25,
    backoff_cap: float = 4.0,
    params: Optional["lsp.Params"] = None,
    label: Optional[str] = None,
    first_client: Optional["lsp.Client"] = None,
    sleep: Optional[Callable[[float], None]] = None,
) -> Optional[Tuple[int, int]]:
    """Bounded retry-with-resubmit: one initial attempt plus up to
    ``retries`` resubmissions.  On a lost connection, reconnect (with
    exponential backoff) and resubmit the *identical* ``(data, 0, max_nonce)``
    Request.  Because that triple is the scheduler's checkpoint identity,
    a server that stashed the orphaned job's progress (Scheduler.lost) or
    restarted from a checkpoint resumes the sweep instead of restarting it.
    ``first_client`` supplies an already-connected conn for the initial
    attempt (the CLI's, so its connect-failure reporting stays in main).
    Returns None once every attempt has failed."""
    import time as _time

    from ..utils.retry import backoff_delay

    sleep = _time.sleep if sleep is None else sleep
    for attempt in range(retries + 1):
        if attempt:
            sleep(backoff_delay(attempt, backoff_base, backoff_cap))
        if attempt == 0 and first_client is not None:
            client = first_client
        else:
            try:
                client = lsp.Client(host, port, params, label=label)
            except (lsp.LspError, OSError):
                continue  # server unreachable this attempt: back off, retry
        if attempt:
            # Counted only once a Request will actually be resubmitted —
            # failed reconnect attempts are not resubmissions.
            METRICS.inc("client.resubmits")
            # The resubmission mints a FRESH trace at the server; this
            # fleet event ties the new tree back to the retry (same
            # (data, 0, max_nonce) identity).
            trace.emit(
                None, "client", "resubmit",
                data=message[:64], max_nonce=max_nonce, attempt=attempt,
            )
        try:
            result = request_once(client, message, max_nonce)
        finally:
            try:
                client.close()
            except lsp.LspError:
                pass
        if result is not None:
            return result
    return None


def main(argv: Optional[List[str]] = None, out: TextIO = sys.stdout) -> int:
    argv = sys.argv if argv is None else argv
    # Beyond-parity flag (same idiom as the server's --checkpoint=FILE):
    # --retries=N resubmits after a lost conn instead of printing
    # Disconnected.  Default 0 preserves the frozen stdout contract.
    retries = 0
    pos = [argv[0]]
    for a in argv[1:]:
        if a.startswith("--retries="):
            try:
                retries = max(0, int(a.split("=", 1)[1]))
            except ValueError:
                print(f"{a} is not a number.", file=out)
                return 0
        else:
            pos.append(a)
    argv = pos
    if len(argv) != 4:
        print(f"Usage: ./{argv[0]} <hostport> <message> <maxNonce>", end="", file=out)
        return 0
    hostport, message = argv[1], argv[2]
    try:
        max_nonce = int(argv[3])
        if max_nonce < 0 or max_nonce >= 1 << 64:
            raise ValueError
    except ValueError:
        print(f"{argv[3]} is not a number.", file=out)
        return 0
    host, _, port = hostport.rpartition(":")
    try:
        client = lsp.Client(host or "127.0.0.1", int(port))
    except (lsp.LspError, OSError, ValueError) as e:
        print("Failed to connect to server:", e, file=out)
        return 0
    if retries > 0:
        # The initial attempt rides the conn we just opened; each of the N
        # resubmissions is counted (client.resubmits) and backed off.
        result = request_with_retry(
            host or "127.0.0.1", int(port), message, max_nonce,
            retries=retries, first_client=client,
        )
    else:
        try:
            result = request_once(client, message, max_nonce)
        finally:
            client.close()
    if result is None:
        print("Disconnected", file=out)  # client.go:46-48
    else:
        print("Result", result[0], result[1], file=out)  # client.go:41-43
    return 0


if __name__ == "__main__":
    sys.exit(main())
