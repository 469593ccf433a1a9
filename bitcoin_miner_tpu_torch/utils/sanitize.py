"""Opt-in runtime race sanitizer — the ``go test -race`` analogue.

A copy of the reference package's ``utils/sanitize.py``, so that
``BMT_SANITIZE`` means the same in both packages.  The server's thread
discipline (the serve-loop event lock serializing the read loop and the
ticker, the externally-serialized scheduler) is otherwise enforced only by
convention.  With ``BMT_SANITIZE=1`` the dynamic half arms:

- :class:`TrackedLock` (via :func:`make_lock`) is a drop-in
  ``threading.Lock`` that records its owner thread and every thread's
  held-lock stack, and maintains a process-global **acquisition-order
  graph**: acquiring B while holding A adds the edge A→B, and any edge
  that closes a cycle raises :class:`LockOrderError` at the acquisition
  that would deadlock — deterministically, not only on the unlucky
  interleaving.
- :func:`guard` wraps a policy object (the Scheduler) in a
  :class:`Monitor` proxy.  Every attribute read and method call checks the discipline:
  once a second thread has touched the object, every access must hold the
  object's lock; a violation raises :class:`RaceError` naming the object,
  attribute and both threads.  Method entries are additionally tracked so
  two threads truly interleaving inside the same object are caught even
  before the thread-set heuristic trips.

- The concurrency-plane teeth: :func:`loop_thread_enter`
  registers event-loop threads, :func:`blocking` raises
  :class:`LoopBlockedError` when a declared-blocking call runs ON one,
  and :class:`TrackedLock` raises the same when a loop thread takes a
  lock some other thread is known to hold while blocking on that loop —
  the deterministic spelling of "one blocked loop iteration stalls every
  conn on the cell".  :func:`thread_census` / :func:`threads_leaked` are
  the always-on thread-lifecycle census.

Disabled (the default), :func:`make_lock` returns a plain
``threading.Lock`` and :func:`guard` returns the object unchanged — zero
overhead on the hot path.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Set, Tuple

__all__ = [
    "RaceError",
    "LockOrderError",
    "LoopBlockedError",
    "TrackedLock",
    "Monitor",
    "enabled",
    "force",
    "make_lock",
    "guard",
    "loop_thread_enter",
    "loop_wait",
    "blocking",
    "current_loop",
    "reset_order_graph",
    "thread_census",
    "threads_leaked",
]


class RaceError(AssertionError):
    """Unsynchronized concurrent access to a guarded object."""


class LockOrderError(AssertionError):
    """A lock acquisition that closes a cycle in the acquisition-order
    graph — the interleaving-dependent deadlock, caught deterministically."""


class LoopBlockedError(AssertionError):
    """A blocking primitive ran ON a registered event-loop thread — a
    declared-blocking call (a sync facade proxy, ``blocking()``) or a
    TrackedLock acquisition some other thread is known to hold while it
    blocks on this very loop.  One blocked loop iteration stalls every
    conn on the cell, so the sanitizer raises deterministically instead
    of letting the stall surface as tail latency."""


#: Test override: force(True/False) beats the environment; force(None)
#: restores env control.
_FORCED: Optional[bool] = None


def enabled() -> bool:
    if _FORCED is not None:
        return _FORCED
    return os.environ.get("BMT_SANITIZE", "") not in ("", "0")


def force(on: Optional[bool]) -> None:
    """Override BMT_SANITIZE for in-process tests (None = back to env)."""
    global _FORCED
    _FORCED = on


# --------------------------------------------------------------------------
# Lock-order graph (process-global, like the locks it observes)
# --------------------------------------------------------------------------


class _OrderGraph:
    """Directed acquisition-order edges between lock names.  ``observe``
    raises the moment an acquisition would add an edge that closes a
    cycle — i.e. some thread has ever taken the locks in the opposite
    order, the classic ABBA deadlock whether or not it bit this run."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._edges: Dict[str, Set[str]] = {}  # guarded-by: _mu

    def observe(self, held: Tuple[str, ...], acquiring: str) -> None:
        with self._mu:
            for h in held:
                if h == acquiring:
                    continue  # re-entrant same-name acquisition
                self._edges.setdefault(h, set()).add(acquiring)
            # A cycle exists iff the new lock can reach any held one.
            for h in held:
                if h != acquiring and self._reaches(acquiring, h):
                    raise LockOrderError(
                        f"lock-order inversion: acquiring {acquiring!r} while "
                        f"holding {h!r}, but {acquiring!r} -> ... -> {h!r} "
                        f"already exists in the acquisition graph "
                        f"(thread {threading.current_thread().name})"
                    )

    def _reaches(self, src: str, dst: str) -> bool:  # guarded-by: _mu
        seen: Set[str] = set()
        stack = [src]
        while stack:
            node = stack.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            stack.extend(self._edges.get(node, ()))
        return False

    def reaches(self, src: str, dst: str) -> bool:
        """Public query: does an edge path ``src -> ... -> dst`` exist?
        (The blocking-on-loop detector asks whether some thread is known
        to block on a loop while holding the lock a loop thread is about
        to take.)"""
        with self._mu:
            return self._reaches(src, dst)

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()


_ORDER = _OrderGraph()
_HELD = threading.local()  # per-thread stack of held TrackedLock names

#: Registered event-loop threads: ident -> (thread object, loop name).
#: The thread object disambiguates ident reuse after a loop dies (OS
#: thread ids recycle); entries are validated against it on lookup.
_LOOP_IDENTS: Dict[int, Tuple[Any, str]] = {}


def current_loop() -> Optional[str]:
    """The loop name the CURRENT thread registered via
    :func:`loop_thread_enter`, or None when this is not a live registered
    loop thread."""
    entry = _LOOP_IDENTS.get(threading.get_ident())
    if entry is None:
        return None
    thread, name = entry
    if thread is not threading.current_thread():
        return None  # a recycled ident: the old loop thread is gone
    return name


def _inc_metric(name: str, n: int = 1) -> None:
    """Lazy registry import: sanitize must stay importable from metrics'
    own dependency cone, so the counter hop resolves at trip time."""
    try:
        from .metrics import METRICS

        METRICS.inc(name, n)  # metric-ok: sanitize.*
    except Exception:
        pass  # never let accounting mask the sanitizer error itself


def _held_stack() -> list:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


def reset_order_graph() -> None:
    """Forget past acquisition orders (test isolation between scenarios)."""
    _ORDER.reset()


class TrackedLock:
    """``threading.Lock`` plus ownership + acquisition-order tracking.

    Non-reentrant, like the lock it replaces.  ``held()`` answers "does
    the *current thread* hold this lock" — the question a plain Lock
    cannot answer and the Monitor discipline check needs."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._owner: Optional[int] = None  # thread ident; _lock serializes

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Blocking-on-loop detector: taking a lock ON a
        # registered loop thread is fine by itself (the event plane's
        # handlers do it on every request) — but if some OTHER thread is
        # known to block on this loop WHILE HOLDING this lock (a
        # ``lock -> loop`` edge recorded by loop_wait), this acquisition
        # is a deterministic deadlock-in-waiting that would stall every
        # conn on the cell.  Raise the loop-specific error here, before
        # the generic cycle check, so the report names the loop.
        loop = current_loop()
        if loop is not None and _ORDER.reaches(self.name, loop):
            _inc_metric("sanitize.loop_blocked")
            raise LoopBlockedError(
                f"lock {self.name!r} acquired on loop thread {loop!r}, "
                f"but another thread blocks on that loop while holding "
                f"it — one loop iteration away from a full-cell stall "
                f"(thread {threading.current_thread().name})"
            )
        _ORDER.observe(tuple(_held_stack()), self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        self._owner = None
        stack = _held_stack()
        if self.name in stack:
            stack.remove(self.name)
        self._lock.release()

    def held(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


def make_lock(name: str) -> Any:
    """The serve loop's lock factory: tracked when sanitizing, plain
    ``threading.Lock`` (zero overhead) otherwise."""
    return TrackedLock(name) if enabled() else threading.Lock()


# --------------------------------------------------------------------------
# Event-loop thread coverage
#
# The LSP sync facades (lsp/sync.py) proxy every call onto a private
# asyncio loop thread and BLOCK on the result — which makes each loop a
# lock-shaped resource the acquisition-order graph could not see: a
# thread holding the serve event lock that blocks on a loop whose
# callbacks ever take that event lock is the classic ABBA deadlock, just
# spelled with a Future instead of a second ``with``.  Under
# BMT_SANITIZE=1 the loop joins the graph:
#
# - the loop thread marks itself as permanently "holding" its own loop
#   name (``loop_thread_enter``), so any TrackedLock acquired by code
#   running ON the loop thread records the edge ``loop -> lock``;
# - every cross-thread blocking proxy call records ``held -> loop``
#   (``loop_wait``), so blocking on the loop while holding a lock its
#   callbacks acquire closes the cycle and raises LockOrderError
#   deterministically — whether or not this run interleaved badly.
# --------------------------------------------------------------------------


def loop_thread_enter(name: str) -> None:
    """Mark the CURRENT thread as an event-loop thread that permanently
    holds the loop resource ``name`` (called once, from the loop thread
    itself, before the loop runs).  Also registers the thread in the
    loop-thread registry so :func:`blocking` and the TrackedLock
    blocking-on-loop detector can answer "is this a loop thread"."""
    if enabled():
        _held_stack().append(name)
        _LOOP_IDENTS[threading.get_ident()] = (threading.current_thread(), name)


def loop_wait(name: str) -> None:
    """A cross-thread call is about to BLOCK on loop ``name``: record the
    acquisition-order edges from every lock the caller holds, exactly as
    if the loop were a lock being acquired."""
    if enabled():
        _ORDER.observe(tuple(_held_stack()), name)


def blocking(what: str) -> None:
    """Declare the statement that follows BLOCKS the calling thread
    (a sync facade proxy wait, a bare ``Future.result()``, file I/O on a
    shared path).  On a plain thread this is free; on a registered
    event-loop thread it raises :class:`LoopBlockedError` outright —
    a blocked loop iteration stalls every conn riding that loop, and no
    interleaving makes it safe."""
    if not enabled():
        return
    loop = current_loop()
    if loop is not None:
        _inc_metric("sanitize.loop_blocked")
        raise LoopBlockedError(
            f"declared-blocking call {what!r} on loop thread {loop!r} "
            f"(thread {threading.current_thread().name}) — every conn on "
            f"this loop stalls until it returns"
        )


# --------------------------------------------------------------------------
# Thread-lifecycle census.  Always available (not gated on enabled()).
# --------------------------------------------------------------------------


def thread_census(settle_s: float = 0.0) -> Dict[str, int]:
    """Live threads right now, as a ``name -> count`` census.  With
    ``settle_s`` the census waits (up to that long) for the live count to
    stop shrinking first, so stragglers from an earlier fleet don't
    inflate a baseline."""
    import time as _time

    if settle_s > 0.0:
        deadline = _time.monotonic() + settle_s
        prev = threading.active_count()
        while _time.monotonic() < deadline:
            _time.sleep(0.05)
            now = threading.active_count()
            if now >= prev:
                break  # stopped shrinking
            prev = now
    out: Dict[str, int] = {}
    for t in threading.enumerate():
        out[t.name] = out.get(t.name, 0) + 1
    return out


def threads_leaked(
    baseline: Dict[str, int], settle_s: float = 0.0
) -> list:
    """Thread names live now beyond their ``baseline`` census counts
    (with multiplicity).  With ``settle_s`` the check polls until the
    leak set drains or the deadline passes — close() paths joining with
    timeouts need a beat.  A non-empty result increments the
    ``sanitize.threads_leaked`` counter, so a soak that asserts flat
    threads also feeds the metrics plane."""
    import time as _time

    def _leaked() -> list:
        out = []
        for name, count in thread_census().items():
            extra = count - baseline.get(name, 0)
            out.extend([name] * extra if extra > 0 else [])
        return sorted(out)

    leaked = _leaked()
    deadline = _time.monotonic() + settle_s
    while leaked and _time.monotonic() < deadline:
        _time.sleep(0.05)
        leaked = _leaked()
    if leaked:
        _inc_metric("sanitize.threads_leaked", len(leaked))
    return leaked


# --------------------------------------------------------------------------
# Guarded-object monitor
# --------------------------------------------------------------------------


class Monitor:
    """Attribute-level discipline proxy around one guarded object.

    The rule: an object may be thread-confined (only one thread has ever
    touched it — the single-threaded setup window before the ticker
    starts), but once a second thread appears, EVERY access must hold the
    guarding lock.  Lock-held accesses are always legal and enroll the
    accessing thread.  Method calls additionally mark the object
    "entered", so two threads interleaving inside methods are reported
    even on the first offense.
    """

    __slots__ = ("_obj", "_lock", "_name", "_mu", "_threads", "_inside")

    def __init__(self, obj: Any, lock: TrackedLock, name: str) -> None:
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_lock", lock)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_mu", threading.Lock())
        object.__setattr__(self, "_threads", set())
        object.__setattr__(self, "_inside", None)  # (ident, attr) mid-call

    def __check(self, attr: str) -> None:
        lock: TrackedLock = self._lock
        me = threading.get_ident()
        if isinstance(lock, TrackedLock) and lock.held():
            with self._mu:
                self._threads.add(me)
            return
        with self._mu:
            self._threads.add(me)
            if len(self._threads) > 1:
                raise RaceError(
                    f"unsynchronized access to {self._name}.{attr} from "
                    f"thread {threading.current_thread().name} without "
                    f"holding {getattr(lock, 'name', 'the lock')!r} "
                    f"(object already shared by {len(self._threads)} threads)"
                )

    def __getattr__(self, attr: str) -> Any:
        self._Monitor__check(attr)
        val = getattr(self._obj, attr)
        if not callable(val):
            return val
        monitor = self

        def guarded_call(*args: Any, **kw: Any) -> Any:
            monitor._Monitor__check(attr)
            me = threading.get_ident()
            locked = isinstance(monitor._lock, TrackedLock) and monitor._lock.held()
            with monitor._mu:
                inside = monitor._inside
                if inside is not None and inside[0] != me and not locked:
                    raise RaceError(
                        f"concurrent method entry on {monitor._name}: "
                        f"{attr} from {threading.current_thread().name} "
                        f"while {inside[1]} is running in another thread"
                    )
                outer = inside is None and not locked
                if outer:
                    object.__setattr__(monitor, "_inside", (me, attr))
            try:
                return val(*args, **kw)
            finally:
                if outer:
                    with monitor._mu:
                        object.__setattr__(monitor, "_inside", None)

        return guarded_call

    def __setattr__(self, attr: str, value: Any) -> None:
        self._Monitor__check(attr)
        setattr(self._obj, attr, value)

    def __len__(self) -> int:
        self._Monitor__check("__len__")
        return len(self._obj)


def guard(obj: Any, lock: Any, name: str) -> Any:
    """Wrap ``obj`` in a :class:`Monitor` bound to ``lock`` when the
    sanitizer is armed; return it unchanged otherwise (or when the lock is
    a plain ``threading.Lock`` — ownership is unknowable there)."""
    if not enabled() or not isinstance(lock, TrackedLock):
        return obj
    return Monitor(obj, lock, name)
