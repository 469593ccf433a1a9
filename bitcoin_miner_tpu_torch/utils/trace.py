"""Process-wide structured event log — end-to-end request tracing.

A copy of the reference package's ``utils/trace.py``, with the same record
shape, so one reader takes either package's trace file.  The counter
registry (utils/metrics.py) answers "how many"; this module answers "where
did this request's time go".  One :class:`Tracer` holds a lock-protected
ring buffer of ``(t, trace, span, event, attrs)`` records.  Trace ids are
minted where a request enters the system (the scheduler mints its own)
and threaded through every event of that request — dispatch, chunk
results, steals, completion — so one id reconstructs the request's
timeline.

Off by default, and OFF-HOT-PATH when off: :func:`emit` checks one module
global before touching anything, so a disabled fleet pays a single
attribute load + truthiness test per call site (hot sites additionally
guard with :func:`enabled` before even building their attrs).  Enabled,
records append to a bounded deque (overflow drops oldest, counted) and
the owner — ``apps/server.serve``'s ticker, a drill, a bench — drains
them to a JSONL file off the event path (``--trace=FILE``).

Record shape (one JSON object per line)::

    {"t": 12.345678, "trace": 7, "span": "gw", "event": "request",
     "attrs": {"conn": 3, "data": "x", "lower": 0, "upper": 4999}}

``trace`` is null for fleet-infrastructure events that serve no single
request (a depth change, a client's resubmission).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, List, Optional

__all__ = ["Tracer", "TRACE", "emit", "enabled", "new_id", "tracing"]

#: Module-level fast path: flipped only by Tracer.enable/disable.  Every
#: emit site checks this first, so disabled tracing costs one global load.
_ON = False


class Tracer:
    """Bounded, lock-protected event ring with optional JSONL sink."""

    def __init__(self, capacity: int = 65536, clock=time.monotonic) -> None:
        self._clock = clock  # immutable after construction
        self._default_capacity = capacity  # immutable after construction
        self._ids = itertools.count(1)  # next() is atomic under the GIL
        self._lock = threading.Lock()
        # Serializes sink writes, held ACROSS drain+write (always acquired
        # before _lock): without it, disable()'s final flush can return
        # while another thread's in-flight flush has drained the buffer
        # but not yet written — the reader would see an empty file.
        self._io_lock = threading.Lock()
        self._capacity = capacity  # guarded-by: _lock
        self._buf: Deque[dict] = deque()  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._path: Optional[str] = None  # guarded-by: _lock
        # A failed append may leave a torn final line in the sink; the
        # next successful write starts with "\n" so the fragment parses
        # as one skipped malformed line instead of corrupting a row.
        self._torn = False  # guarded-by: _lock

    # ------------------------------------------------------------- lifecycle

    def enable(
        self, path: Optional[str] = None, capacity: Optional[int] = None
    ) -> None:
        """Arm tracing (fresh buffer).  ``path`` is the JSONL sink that
        :meth:`flush` appends to; without one, records accumulate for
        :meth:`drain` (in-process tests).  ``capacity`` overrides the
        ring bound for THIS arming only — the next enable() without one
        restores the construction default."""
        global _ON
        with self._lock:
            self._buf.clear()
            self._dropped = 0
            self._path = path
            self._capacity = (
                max(1, capacity)
                if capacity is not None
                else self._default_capacity
            )
        _ON = True

    def disable(self) -> None:
        """Disarm (flushing any remaining records to the sink first).
        The sink is detached even if that final flush fails — the next
        enable() starts clean either way."""
        global _ON
        _ON = False
        try:
            self.flush()
        finally:
            with self._lock:
                self._path = None

    # --------------------------------------------------------------- record

    def new_id(self) -> int:
        """Mint a process-unique trace id (monotone, JSON-friendly)."""
        return next(self._ids)

    def record(
        self,
        trace_id: Optional[int],
        span: str,
        event: str,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Append one event.  Callers normally go through :func:`emit`
        (which applies the module-level fast path)."""
        row: Dict[str, Any] = {
            "t": round(self._clock(), 6),
            "trace": trace_id,
            "span": span,
            "event": event,
        }
        if attrs:
            row["attrs"] = attrs
        with self._lock:
            self._buf.append(row)
            if len(self._buf) > self._capacity:
                self._buf.popleft()
                self._dropped += 1

    # ---------------------------------------------------------------- drain

    def drain(self) -> List[dict]:
        """Return and clear the buffered records (oldest first)."""
        with self._lock:
            rows = list(self._buf)
            self._buf.clear()
        return rows

    def flush(self) -> int:
        """Append buffered records to the armed ``path``; no-op without a
        sink.  Returns the number of rows written.  The server shell
        calls this from its ticker and once at shutdown — never on the
        per-event path.  The io lock is held across drain+write so a
        flush that returns guarantees every PREVIOUSLY drained batch is
        on disk too (disable()'s final flush rides that guarantee);
        emitters never block on it — they only touch ``_lock``."""
        with self._io_lock:
            with self._lock:
                path = self._path
                if path is None or not self._buf:
                    return 0
                rows = list(self._buf)
                self._buf.clear()
                torn = self._torn
            # Unbuffered O_APPEND writes with exact accounting: on a
            # failure we know how many BYTES landed, so only the rows not
            # fully on disk are restored — a retry can never duplicate an
            # already-written event (the cache/span flushes get this for
            # free from save_json_atomic; an append log has to track it).
            lines = [
                json.dumps(row, separators=(",", ":")) + "\n" for row in rows
            ]
            data = ("\n" if torn else "") + "".join(lines)
            payload = data.encode("utf-8")
            ends = []  # cumulative byte offset at which each row is durable
            off = 1 if torn else 0
            for line in lines:
                off += len(line.encode("utf-8"))
                ends.append(off)
            written = 0
            try:
                fd = os.open(
                    path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
                )
            except OSError:
                self._restore(rows, torn)
                raise
            try:
                while written < len(payload):
                    written += os.write(fd, payload[written:])
            except OSError:
                # Restore exactly the rows whose bytes are not fully on
                # disk; if the failure split a row, the sink now ends in
                # a torn fragment — flag it so the next write terminates
                # the fragment instead of corrupting the next row.
                survivors = [r for r, e in zip(rows, ends) if e > written]
                if written == 0:
                    new_torn = torn  # nothing landed: prior state holds
                else:
                    # Torn unless the write stopped exactly on a row
                    # boundary (or wrote only the terminating newline).
                    new_torn = written not in {1 if torn else 0, *ends}
                self._restore(survivors, new_torn)
                raise
            finally:
                os.close(fd)
            with self._lock:
                self._torn = False
            return len(rows)

    def _restore(self, rows: List[dict], torn: bool) -> None:
        """Put unwritten rows back at the ring's front (oldest first) so
        the next flush retries them; overflow drops oldest, counted."""
        with self._lock:
            self._torn = torn
            self._buf.extendleft(reversed(rows))
            while len(self._buf) > self._capacity:
                self._buf.popleft()
                self._dropped += 1

    def dropped(self) -> int:
        """Records lost to ring overflow since enable() — non-zero means
        the drain cadence is too slow for the event rate."""
        with self._lock:
            return self._dropped


#: The process-wide tracer (one per process, like METRICS).
TRACE = Tracer()


def enabled() -> bool:
    """Hot-path guard: sites that would build attrs (or loop) check this
    before calling :func:`emit`."""
    return _ON


def new_id() -> Optional[int]:
    """Mint a trace id, or None when tracing is off (callers thread the
    None through unchanged — emit on a None id is still a no-op record
    only if they guard; the convention is mint-iff-enabled)."""
    if not _ON:
        return None
    return TRACE.new_id()


def emit(
    trace_id: Optional[int], span: str, event: str, **attrs: Any
) -> None:
    """Record one event iff tracing is armed (module-global fast path)."""
    if not _ON:
        return
    TRACE.record(trace_id, span, event, attrs or None)


@contextmanager
def tracing(path: Optional[str] = None) -> Iterator[Tracer]:
    """Scoped enable/disable (drills, benches, tests): flushes to ``path``
    on exit."""
    TRACE.enable(path=path)
    try:
        yield TRACE
    finally:
        TRACE.disable()
