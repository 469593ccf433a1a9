"""The mining server binary: LSP shell around the Scheduler.

CLI parity with the reference stub (``bitcoin/server/server.go:41-51``):
``server <port>``, prints ``Server listening on port <port>``, logs to
``log.txt``.  The reference left the body as ``TODO``; the implemented
behavior follows its frozen contracts (SURVEY §3.6).

Two transport shells drive ONE engine:

- :func:`serve` — the frozen blocking shell: LSP's multiplexed ``read()``
  yields ``(conn_id, payload)`` or raises ``ConnLostError`` with the dead
  conn's id (our fix of reference quirk §8.3 is what makes clean
  miner/client death handling possible at all).
- :class:`AsyncIngress` — the event-loop shell: the public
  :class:`~bitcoin_miner_tpu_torch.lsp.AsyncServer` lives directly on one
  asyncio loop (no per-read facade hop) and the same handlers run as that
  loop's read-loop body, so thread count is O(1) in live conns instead of
  O(n).

Both hand every event to the pure
:class:`~bitcoin_miner_tpu_torch.apps.scheduler.Scheduler` through
:class:`_EventPlane` — the scheduler event plane (WFQ, tracing, the
checkpoint ticker) serialized under one event lock — whose returned
actions are put on the wire.

This is the port's copy of the reference package's ``apps/server.py``.
The fleet metrics plane is ported: ``--telemetry-port=P`` (miners'
snapshot sidecars), ``--fleet-log=FILE`` (the merged view as JSONL;
``python -m tools.dash FILE`` renders it), ``--prom=FILE`` (Prometheus
text) and ``--slo[=CONF]`` (burn-rate alerts), env ``BMT_TELEMETRY_PORT``,
``BMT_FLEET_LOG``, ``BMT_PROM``, ``BMT_SLO``; any of them arms a
:class:`~bitcoin_miner_tpu_torch.utils.telemetry.TelemetryHub`, which the
engine ticks.  A bad ``--slo=`` value or a busy telemetry port prints one
line and returns 0 before the serving port binds (the reference binds the
serving port first on the blocking shell).

The serving gateway is ported: ``--gateway`` puts a
:class:`~bitcoin_miner_tpu_torch.gateway.Gateway` (coalescing, the result
cache, the span store, admission control) in front of the scheduler in
both shells; ``--cache=FILE`` / ``--spans=FILE`` persist its stores,
``--rate=`` / ``--burst=`` / ``--max-queued=`` tune admission (defaults
5.0, 10.0, 256; ``--rate=0`` is unlimited) and ``--prefill=N`` (env
``BMT_PREFILL``) arms N-nonce speculative gap-sweeps after a second of
idleness.  Each of these implies ``--gateway``; a bad number prints
``<flag> is not a number.`` and returns 0 before binding.  So is the
autoscaler: ``--autoscale[=SPEC]`` (env ``BMT_AUTOSCALE``; grammar in
:func:`~bitcoin_miner_tpu_torch.autoscale.parse_autoscale_config`) spawns
and drains port miner workers against the live serving port off the hub's
burn alerts and ``fleet.utilization``, re-weights the gateway's tenants
when ``weights=`` is given, and publishes its ``status()`` through the
hub; a bad spec prints one line and returns 0 before binding.  Its
workers' backend defaults to ``"auto"`` (the cuda rung on the card),
where the reference's defaults to ``"cpu"``.  So is the chaos layer:
``BMT_CHAOS_SCENARIO=<name>`` arms one of ``lspnet.standard_scenarios()``
on this process's endpoints in both shells (``BMT_CHAOS_LOOP=<s>`` replays
it every ``s`` seconds); an unknown name prints ``unknown
BMT_CHAOS_SCENARIO '<name>'; ignoring`` on stderr and serves on.
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

from .. import lsp
from ..bitcoin.message import Message, MsgType
from ..utils import sanitize
from ..utils import trace as trace_mod
from ..utils.metrics import METRICS, RateMeter, format_quantiles
from ..utils.persist import load_json, save_json_atomic
from .scheduler import Scheduler

# The atomic temp-write + rename path lives in utils/persist.py; these
# names are the checkpoint API, as in the reference package.
save_checkpoint = save_json_atomic
load_checkpoint = load_json


class _EventPlane:
    """The transport-independent serving engine: the gateway/scheduler
    event plane plus its ticker (straggler reclamation, checkpoint /
    result-cache / span-store flushes, health lines, fleet gauges),
    serialized by ONE event lock.

    Shells call :meth:`handle` / :meth:`conn_lost` for inbound transport
    events and :meth:`shutdown` on the way out; the plane never blocks on
    the transport — every outbound write goes through ``server.write``,
    which each shell guarantees is safe from BOTH the handler context and
    the ticker thread (the sync facade proxies onto its loop thread; the
    async shell's :class:`_LoopBridge` hops off-loop writes with a
    fire-and-forget ``call_soon_threadsafe``, so a thread holding the
    event lock can never block on the ingress loop — the Future-spelled
    ABBA deadlock the sanitizer's loop-shaped-resource graph exists to
    catch).

    ``lock`` lets a caller that shares the engine with threads of its
    own (the reference's federation replica) supply the event lock those
    threads already hold their accesses under; default is a private lock.
    """

    def __init__(
        self,
        server,
        scheduler: Optional[Scheduler],
        log: Optional[logging.Logger],
        clock: Callable[[], float],
        tick_interval: float,
        checkpoint_path: Optional[str],
        health_interval: float,
        telemetry,
        lock,
    ) -> None:
        self.server = server  # transport facade/bridge: internally threadsafe
        self.log = log or logging.getLogger("bitcoin_miner_tpu_torch.server")
        self.clock = clock
        self.tick_interval = tick_interval
        self.checkpoint_path = checkpoint_path
        self.telemetry = telemetry
        # Serializes scheduler access with the ticker (tracked under
        # BMT_SANITIZE=1, a plain threading.Lock otherwise).
        if lock is None:
            lock = sanitize.make_lock("serve.event")
        self.lock = lock
        sched = scheduler if scheduler is not None else Scheduler()
        # A gateway-wrapped scheduler carries a result cache; its disk
        # flushes ride the ticker (snapshot under the lock, write outside)
        # just like the checkpoint — never on the per-job event path.
        cache = getattr(sched, "cache", None)
        self.cache_path = getattr(cache, "path", None)  # immutable
        # A gateway engine accepts a per-request client identity: bind its
        # token buckets / fair-queue keys to the LSP peer address, which
        # is stable across reconnects (the conn id / UDP port are not).
        self.accepts_client_key = cache is not None  # only Gateway has a cache
        self.peer_host = getattr(server, "peer_host", None)
        # Telemetry shape resolved at setup (before the Monitor wrap):
        # only a Gateway carries an admission fair queue whose virtual
        # clock the ticker publishes as a gauge.
        self.has_gw_queue = hasattr(sched, "queue_vt_floor")
        # The interval-algebra span store rides the same dirty-flag flush
        # cadence as the result cache.
        spans = getattr(sched, "spans", None)
        self.spans_path = getattr(spans, "path", None)  # immutable
        if self.cache_path is None:
            cache = None  # in-memory only: nothing to flush
        if self.spans_path is None:
            spans = None  # in-memory only: nothing to flush
        # Race sanitizer (BMT_SANITIZE=1): every access to the policy
        # objects off this lock raises once the ticker shares them.
        self.sched = sanitize.guard(sched, lock, "scheduler")  # guarded-by: lock
        self.cache = (  # guarded-by: lock
            sanitize.guard(cache, lock, "result-cache") if cache is not None else None
        )
        self.spans = (  # guarded-by: lock
            sanitize.guard(spans, lock, "span-store") if spans is not None else None
        )
        # Operator health surface (the reference's LOGF scaffold,
        # bitcoin/server/server.go:26-39, implies exactly this): periodic
        # scheduler stats + recovery counters in log.txt, so reassignment/
        # validation/straggler machinery is visible without a debugger.
        self.health_every = max(1, int(round(health_interval / tick_interval)))
        # Recent delivered nonces/sec for the health line: a sliding
        # window, so the number tracks the fleet's CURRENT rate after
        # reconnects and tier downgrades instead of a lifetime average
        # that goes stale (bench JSON keeps using lifetime numbers).
        self.recent_nps = RateMeter(
            clock=clock, window=max(3 * health_interval, 10.0)
        )
        self._swept_seen = None  # last sched.nonces_swept sample; ticker-thread only
        # Last fleet-plane state (merged view + SLO verdicts) for the
        # health line.  Written and read on the ticker thread only.
        self._fleet_state = None  # ticker-thread only
        # Live-conn gauge source: transports that can count
        # their conns feed ``gw.conns_live`` each tick.
        self._conns_live = getattr(server, "conns_live", None)
        self._stop = threading.Event()
        self._tick_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- health line

    def health_line(self) -> str:  # guarded-by: lock
        counters = {
            k: METRICS.get(f"sched.{k}")
            for k in (
                "chunks_assigned",
                "chunks_reassigned",
                "chunks_straggler_requeued",
                "results_rejected",
                "miners_evicted",
                "jobs_completed",
                "jobs_resumed",
                "jobs_orphaned",
            )
        }
        # Chaos + self-healing + gateway counters (packets dropped, miner
        # reconnects, tier downgrades, client resubmits, coalesce/cache/
        # shed decisions) ride the same line so a soak's fault trace and
        # the serving layer's traffic shape are visible in log.txt without
        # a debugger.  Only non-zero ones print — a healthy, gateway-less
        # fleet's line stays short.
        extra = {
            k: v
            for k, v in sorted(METRICS.snapshot().items())
            if v and k.startswith(("chaos.", "gateway.", "miner.reconnects",
                                   "miner.tier_downgrades", "client.resubmits",
                                   "federation.", "fed.", "gossip.",
                                   "ingress."))
        }
        line = f"health {self.sched.stats()} {counters} nps={self.recent_nps.rate():.3g}"
        # Membership plane: per-peer state codes (0 OK,
        # 1 SHEDDING, 2 DRAINING, 3 SUSPECT, 4 DEAD) — empty outside a
        # federation cell, so a plain server's line is unchanged.
        peer_states = {
            k.rsplit(".", 1)[1]: int(v)
            for k, v in sorted(METRICS.gauges().items())
            if k.startswith("fed.peer_state.")
        }
        if peer_states:
            line += " fed_peers=" + ",".join(
                f"{name}:{code}" for name, code in peer_states.items()
            )
        # Latency distributions: request→result and chunk RTT
        # p50/p95/p99 ride the line, so "where does a request's time go"
        # is visible in log.txt without a trace file.  format_quantiles
        # renders a sample-less histogram as -/-/- — a 0 here would read
        # as "instant", not "no data".
        for label, name in (("req", "hist.request_s"), ("chunk", "hist.chunk_rtt_s")):
            line += f" {label}_lat_s={format_quantiles(METRICS.histogram(name))}"
        # Fleet plane: live/total telemetry sources, flagged
        # stragglers, and the SLO firing set, from the hub's last tick.
        fs = self._fleet_state
        if fs is not None:
            total = fs["sources"] + fs["stale_sources"]
            line += f" fleet={fs['sources']}/{total}"
            if fs.get("stragglers"):
                names = ",".join(s["source"] for s in fs["stragglers"])
                line += f" stragglers={names}"
            slo_state = fs.get("slo")
            if slo_state is not None:
                alerts = slo_state["alerts"]
                line += " slo=" + (
                    "ALERT[" + ",".join(alerts) + "]" if alerts else "ok"
                )
        return f"{line} extra {extra}" if extra else line

    # ------------------------------------------------------------------- wire

    def emit(self, actions: List[Tuple[int, Message]]) -> None:
        for conn_id, msg in actions:
            try:
                self.server.write(conn_id, msg.marshal())
            except lsp.LspError:
                # Connection died between scheduling and sending; the loss
                # event will arrive via read() and trigger reassignment.
                self.log.info("write to %d failed (conn dead)", conn_id)

    # ------------------------------------------------------------------ ticker

    def start(self) -> "_EventPlane":
        self._tick_thread = threading.Thread(
            target=self._ticker, daemon=True, name="sched-tick"
        )
        self._tick_thread.start()
        return self

    def _ticker(self) -> None:
        saved_rev = None
        ticks = 0
        last_health = None
        while not self._stop.wait(self.tick_interval):
            try:
                ticks += 1
                swept = METRICS.get("sched.nonces_swept")
                if self._swept_seen is not None and swept > self._swept_seen:
                    self.recent_nps.add(swept - self._swept_seen)
                self._swept_seen = swept
                with self.lock:
                    actions = self.sched.tick(self.clock())
                    rev = self.sched.revision
                    state = (
                        self.sched.checkpoint()
                        if self.checkpoint_path and rev != saved_rev
                        else None
                    )
                    cache_state = (
                        self.cache.flush() if self.cache is not None else None
                    )
                    spans_state = (
                        self.spans.flush() if self.spans is not None else None
                    )
                    st = self.sched.stats()
                    vt = (
                        self.sched.vt_floor()
                        if hasattr(self.sched, "vt_floor")
                        else 0.0
                    )
                    qvt = (
                        self.sched.queue_vt_floor() if self.has_gw_queue else None
                    )
                    line = (
                        self.health_line()
                        if ticks % self.health_every == 0
                        else None
                    )
                # Fleet-level gauges, published off the event
                # lock — METRICS has its own.
                METRICS.set_gauge("gauge.miners_live", st["miners"])
                METRICS.set_gauge("gauge.inflight_chunks", st["outstanding_chunks"])
                METRICS.set_gauge("gauge.admission_backlog", st.get("gw_queued", 0))
                # Saturation surface: the dispatch-plane
                # acceptance number — a straggling fleet under static
                # chunking idles its healthy miners; adaptive sizing +
                # tail stealing must keep this high.
                METRICS.set_gauge(
                    "fleet.utilization",
                    (st["miners"] - st["idle_miners"]) / st["miners"]
                    if st["miners"] else 0.0,
                )
                METRICS.set_gauge("gauge.sched_vt_floor", vt)
                if qvt is not None:
                    METRICS.set_gauge("gauge.gw_vt_floor", qvt)
                # Conn-scale surface: live conns at the public
                # transport — the number the async ingress exists to grow
                # 10x+ per replica at O(1) threads.
                if self._conns_live is not None:
                    METRICS.set_gauge("gw.conns_live", float(self._conns_live()))
                # Federation transport surface: fed-port +
                # gossip conns ride the cell's one shared loop, so this
                # conn count is the thing that grows with peers while
                # the thread count stays flat.
                if "fed_conns" in st:
                    METRICS.set_gauge("fed.conns_live", float(st["fed_conns"]))
                # Fleet metrics plane: merge this process's
                # registry into the fleet view, evaluate SLO burn rates,
                # run the straggler detector, feed the publish sinks.
                # Off the event lock — the hub owns its own locks — and
                # failure-isolated like every other ticker artifact.
                if self.telemetry is not None:
                    try:
                        self._fleet_state = self.telemetry.tick()
                    except Exception:
                        self.log.exception("telemetry tick failed; will retry")
                # Structured-event drain (--trace=FILE): append buffered
                # records as JSONL, file I/O outside the event lock; a
                # no-op when tracing is off or has no sink.  Guarded like
                # every other artifact write: a full trace disk restores
                # its rows (Tracer.flush) and retries next tick — it must
                # not abort the saves/sends below.
                try:
                    trace_mod.TRACE.flush()
                except OSError:
                    self.log.exception("trace flush failed; will retry")
                if line is not None and line != last_health:
                    self.log.info("%s", line)  # skip repeats on an idle server
                    last_health = line
                if actions:
                    self.log.info("straggler tick reclaimed work")
                    self.emit(actions)
                # Each artifact's save is independent: one failing disk
                # write must not discard another's already-flushed state
                # (flush() cleared its dirty flag — dropping the snapshot
                # here would lose it until some future mutation re-dirties
                # the store).  Failures re-arm their own retry and nothing
                # else: checkpoint by not advancing saved_rev, the stores
                # by mark_dirty (the only-advance-on-success contract).
                if state is not None:
                    try:
                        save_checkpoint(self.checkpoint_path, state)
                        saved_rev = rev
                    except Exception:
                        self.log.exception("checkpoint save failed; will retry")
                if cache_state is not None:
                    try:
                        save_checkpoint(self.cache_path, cache_state)
                    except Exception:
                        with self.lock:
                            self.cache.mark_dirty()
                        self.log.exception("result-cache flush failed; will retry")
                if spans_state is not None:
                    try:
                        save_checkpoint(self.spans_path, spans_state)
                    except Exception:
                        with self.lock:
                            self.spans.mark_dirty()
                        self.log.exception("span-store flush failed; will retry")
            except Exception:
                # A transient failure (e.g. checkpoint disk full) must not
                # silently kill straggler recovery for the server's lifetime.
                self.log.exception("scheduler tick failed; will retry")

    # ------------------------------------------------------------------ events

    def handle(self, conn_id: int, payload: bytes) -> None:
        """One inbound transport payload → scheduler events → wire."""
        msg = Message.unmarshal(payload)
        if msg is None:
            self.log.warning("undecodable payload from %d", conn_id)
            return
        now = self.clock()
        # Resolve the admission identity BEFORE taking the event lock
        # (peer_host may cross into the transport's loop thread).  Keyed
        # by remote host, not conn id: a client that reconnects keeps
        # draining the same token bucket instead of minting a fresh
        # burst allowance per conn.
        peer_key = None
        if (
            self.accepts_client_key
            and msg.type == MsgType.REQUEST
            and self.peer_host is not None
        ):
            host = self.peer_host(conn_id)
            peer_key = f"addr:{host}" if host else None
        with self.lock:
            if msg.type == MsgType.JOIN:
                self.log.info("miner %d joined; %s", conn_id, self.sched.stats())
                actions = self.sched.miner_joined(conn_id, now)
            elif msg.type == MsgType.REQUEST:
                self.log.info(
                    "request from %d: data=%r range=[%d,%d]",
                    conn_id, msg.data, msg.lower, msg.upper,
                )
                if peer_key is not None:
                    actions = self.sched.client_request(
                        conn_id, msg.data, msg.lower, msg.upper, now,
                        client_key=peer_key,
                    )
                else:
                    actions = self.sched.client_request(
                        conn_id, msg.data, msg.lower, msg.upper, now
                    )
            elif msg.type == MsgType.RESULT:
                actions = self.sched.result(conn_id, msg.hash, msg.nonce, now)
            else:
                actions = []
            evicted = self.sched.drain_evictions()
        self.emit(actions)
        for cid in evicted:
            self.log.info("closing evicted miner conn %d", cid)
            try:
                self.server.close_conn(cid)
            except lsp.LspError:
                pass  # already gone

    def conn_lost(self, conn_id: int) -> None:
        with self.lock:  # stats() reads dicts the ticker may mutate
            self.log.info("connection %d lost; %s", conn_id, self.sched.stats())
            actions = self.sched.lost(conn_id, self.clock())
        self.emit(actions)

    # ---------------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        self._stop.set()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=2 * self.tick_interval + 1)
        if self.cache is not None:  # unguarded: reads the binding, not the object
            # Final flush: a Result delivered just before shutdown must not
            # miss the file because no tick fired after it.  Still under
            # the lock — the ticker join above can time out and leave it
            # live (the lock-discipline checker flagged the bare access).
            with self.lock:
                cache_state = self.cache.flush()
            if cache_state is not None:
                try:
                    save_checkpoint(self.cache_path, cache_state)
                except OSError:
                    self.log.exception("final result-cache flush failed")
        if self.spans is not None:  # unguarded: reads the binding, not the object
            with self.lock:  # same shutdown contract as the result cache
                spans_state = self.spans.flush()
            if spans_state is not None:
                try:
                    save_checkpoint(self.spans_path, spans_state)
                except OSError:
                    self.log.exception("final span-store flush failed")
        # Final trace drain: events logged after the last tick must not
        # miss the file (same contract as the cache/span final flushes).
        try:
            trace_mod.TRACE.flush()
        except OSError:
            self.log.exception("final trace flush failed")


def serve(
    server: "lsp.Server",
    scheduler: Optional[Scheduler] = None,
    log: Optional[logging.Logger] = None,
    clock: Callable[[], float] = time.monotonic,
    tick_interval: float = 1.0,
    checkpoint_path: Optional[str] = None,
    health_interval: float = 10.0,
    telemetry=None,
    lock=None,
) -> None:
    """Run the scheduler loop over an already-listening LSP server until the
    server is closed.  Factored out of main() so tests drive it in-process.

    This is the frozen BLOCKING shell over :class:`_EventPlane` (see its
    docstring for the ticker/lock/telemetry contracts); the asyncio shell
    with the same engine is :class:`AsyncIngress`.

    ``telemetry`` is an optional already-started telemetry hub (the
    reference's ``TelemetryHub``; none is ported yet):
    the ticker drives its :meth:`tick` each beat — fleet-view merge, SLO
    burn-rate evaluation, straggler detection, publish sinks — OFF the
    event lock (the hub carries its own locks), so a full fleet-log disk
    or a dead dashboard can never stall the serve loop.
    """
    plane = _EventPlane(
        server, scheduler, log, clock, tick_interval, checkpoint_path,
        health_interval, telemetry, lock,
    ).start()
    try:
        while True:
            try:
                conn_id, payload = server.read()
            except lsp.ConnLostError as e:
                plane.conn_lost(e.conn_id)
                continue
            except lsp.ConnClosedError:
                return
            plane.handle(conn_id, payload)
    finally:
        plane.shutdown()


class _LoopBridge:
    """The thin transport bridge between the event plane and an
    :class:`~bitcoin_miner_tpu_torch.lsp.AsyncServer` owned by the ingress
    loop.  Calls FROM the loop thread (the read-loop handlers) go
    straight through — no facade hop; calls from any other thread (the
    plane's ticker, a federation ingest/forwarder thread) hop onto the
    loop with a fire-and-forget ``call_soon_threadsafe``, so a thread
    holding the event lock never BLOCKS on the loop (that Future-spelled
    wait is exactly the ABBA deadlock the sanitizer's loop-shaped
    resource graph catches in the sync facades)."""

    def __init__(self, server: "lsp.AsyncServer", loop) -> None:
        self._server = server  # on-loop: _loop — writers must hop (loopcheck)
        self._loop = loop
        self._thread = threading.current_thread()  # the ingress loop thread

    def write(self, conn_id: int, payload: bytes) -> None:
        if threading.current_thread() is self._thread:
            self._server.write(conn_id, payload)
            return
        METRICS.inc("ingress.cross_thread_writes")
        try:
            self._loop.call_soon_threadsafe(self._write_on_loop, conn_id, payload)
        except RuntimeError:
            # Loop already shut down: same contract as the sync facade's
            # write-after-close (callers catch LspError).
            raise lsp.ConnClosedError() from None

    def _write_on_loop(self, conn_id: int, payload: bytes) -> None:  # on-loop:
        try:
            self._server.write(conn_id, payload)
        except lsp.LspError:
            pass  # conn died inside the hop window; the loss event follows

    def close_conn(self, conn_id: int) -> None:
        if threading.current_thread() is self._thread:
            self._server.close_conn(conn_id)
            return
        try:
            self._loop.call_soon_threadsafe(self._close_on_loop, conn_id)
        except RuntimeError:
            raise lsp.ConnClosedError() from None

    def _close_on_loop(self, conn_id: int) -> None:  # on-loop:
        try:
            self._server.close_conn(conn_id)
        except lsp.LspError:
            pass  # already gone

    def peer_host(self, conn_id: int) -> Optional[str]:
        # Handler context only (the plane resolves identities before it
        # takes the event lock, ON the loop thread).
        return self._server.peer_host(conn_id)  # loop-ok: handler context

    def conns_live(self) -> int:
        # len() of the conn dict is one atomic bytecode under the GIL: a
        # benign snapshot read from the ticker thread, not worth a hop.
        return self._server.conns_live()  # loop-ok: GIL-atomic snapshot


class AsyncIngress:
    """Event-loop ingress: ONE asyncio loop owns the public
    :class:`~bitcoin_miner_tpu_torch.lsp.AsyncServer`, and the unchanged
    scheduler event plane runs in that loop's read-loop body
    under the usual event lock.  Thread cost: the ingress loop thread +
    the plane's ticker — O(1) in live conns, where the sync-facade shell
    plus per-conn blocking clients is O(n).

    ``start()`` spawns the loop thread, binds the server (bind failures
    raise here, like ``lsp.Server``), and returns self; ``close()`` is
    idempotent.  ``write``/``close_conn`` are safe from any thread (the
    federation replica's ingest/forwarder threads deliver results through
    them), making a started ingress a drop-in for the sync ``lsp.Server``
    facade everywhere the serve plane's contracts apply.
    """

    def __init__(
        self,
        port: int = 0,
        *,
        scheduler: Optional[Scheduler] = None,
        params: Optional["lsp.Params"] = None,
        host: str = "127.0.0.1",
        label: Optional[str] = None,
        log: Optional[logging.Logger] = None,
        clock: Callable[[], float] = time.monotonic,
        tick_interval: float = 1.0,
        checkpoint_path: Optional[str] = None,
        health_interval: float = 10.0,
        telemetry=None,
        lock=None,
    ) -> None:
        self._port_arg = port
        self._scheduler = scheduler
        self._params = params
        self._host = host
        self._log = log
        self._clock = clock
        self._tick_interval = tick_interval
        self._checkpoint_path = checkpoint_path
        self._health_interval = health_interval
        self._telemetry = telemetry
        self._lock = lock
        self._loop = asyncio.new_event_loop()
        self._server: Optional["lsp.AsyncServer"] = None
        self._plane: Optional[_EventPlane] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._start_err: Optional[BaseException] = None
        #: An exception that escaped the read-loop handlers and killed
        #: the ingress thread — the async spelling of serve() raising.
        #: Owners that supervise the ingress (main()) must check it so a
        #: crashed server exits non-zero, exactly like the blocking shell.
        self.error: Optional[BaseException] = None
        self._closed = False
        self._san = sanitize.enabled()  # captured once, like the sync facades
        self._label = label
        self._san_name = f"ingress.loop.{label or id(self)}"

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "AsyncIngress":
        self._thread = threading.Thread(
            target=self._run, name="lsp-ingress", daemon=True
        )
        self._thread.start()
        self._started.wait()
        if self._start_err is not None:
            err, self._start_err = self._start_err, None
            self._thread.join(timeout=5)
            raise err
        return self

    def _run(self) -> None:
        if self._san:
            # The ingress loop joins the sanitizer's acquisition-order
            # graph as a lock-shaped resource, exactly like the sync
            # facades' loop threads: handlers running here record
            # ``loop -> event lock`` edges, and any thread that BLOCKS on
            # this loop while holding a tracked lock records the reverse.
            sanitize.loop_thread_enter(self._san_name)
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._main())
        except BaseException as e:  # a handler crash, not a clean close
            self.error = e
            raise
        finally:
            # Resolve anything scheduled in the stop window (same
            # contract as the sync facades' loop teardown).
            pending = asyncio.all_tasks(self._loop)
            for t in pending:
                t.cancel()
            if pending:
                self._loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            self._loop.close()

    async def _main(self) -> None:
        try:
            # The WHOLE setup is the start() handshake: a plane/bridge
            # construction failure must release the starter too, or
            # start() would block on _started forever.
            self._server = await lsp.AsyncServer.create(
                self._port_arg, self._params, self._host, label=self._label
            )
            bridge = _LoopBridge(self._server, self._loop)
            plane = self._plane = _EventPlane(
                bridge, self._scheduler, self._log, self._clock,
                self._tick_interval, self._checkpoint_path,
                self._health_interval, self._telemetry, self._lock,
            )
        except BaseException as e:
            self._start_err = e
            if self._server is not None:
                # Bound but never served: release the port (no conns yet,
                # so the drain is immediate).
                try:
                    await self._server.close()
                except Exception:
                    pass
            self._started.set()
            return
        self._started.set()
        plane.start()
        try:
            while True:
                try:
                    conn_id, payload = await self._server.read()
                except lsp.ConnLostError as e:
                    METRICS.inc("ingress.conns_lost")
                    plane.conn_lost(e.conn_id)
                    continue
                except lsp.ConnClosedError:
                    return
                METRICS.inc("ingress.events")
                plane.handle(conn_id, payload)
        finally:
            plane.shutdown()

    def close(self) -> None:
        """Idempotent shutdown: drain the AsyncServer on its loop (the
        read loop then returns and the plane shuts down on the way out)
        and join the ingress thread."""
        if self._thread is None or self._closed:
            return
        self._closed = True
        if self._server is not None:
            if self._san:
                # We are about to BLOCK on the ingress loop: record the
                # lock-order edges exactly like a sync facade's proxy call.
                sanitize.loop_wait(self._san_name)
            try:
                fut = asyncio.run_coroutine_threadsafe(
                    self._server.close(), self._loop
                )
                fut.result(timeout=30)
            except Exception:
                pass  # loop already gone / drain timed out: join below
        self._thread.join(timeout=30)

    # ----------------------------------------------------------- facade API

    @property
    def port(self) -> int:
        assert self._server is not None, "start() first"
        return self._server.port

    @property
    def lock(self):
        """The plane's event lock (callers that share the engine — the
        federation replica — hold their accesses under it)."""
        assert self._plane is not None, "start() first"
        return self._plane.lock

    def write(self, conn_id: int, payload: bytes) -> None:
        """Threadsafe write to one conn (raises LspError only when called
        from the loop thread itself; off-loop writes are fire-and-forget
        — a conn that died in the hop window surfaces as a loss event)."""
        assert self._plane is not None, "start() first"
        self._plane.server.write(conn_id, payload)

    def close_conn(self, conn_id: int) -> None:
        assert self._plane is not None, "start() first"
        self._plane.server.close_conn(conn_id)

    def peer_host(self, conn_id: int) -> Optional[str]:
        assert self._server is not None, "start() first"
        return self._server.peer_host(conn_id)

    def conns_live(self) -> int:
        if self._server is None:
            return 0
        return self._server.conns_live()


def _start_hub(tport: Optional[int], fleet_log, prom_path, slo_conf):
    """The fleet metrics plane's hub for ``main``, started; None when no
    flag arms it.  Raises ValueError for a bad ``--slo=`` value and
    OSError for a busy telemetry port, before anything else binds."""
    if tport is None and not (fleet_log or prom_path or slo_conf):
        return None
    from ..utils.slo import SloEngine, parse_slo_config
    from ..utils.telemetry import TelemetryHub

    engine = SloEngine(parse_slo_config(slo_conf)) if slo_conf else None
    return TelemetryHub(
        tport or 0, slo=engine, fleet_log=fleet_log, prom_path=prom_path,
    ).start()


def _start_autoscale(live_port: int, cfg, driver, gateway, lock, hub, tport):
    """The autoscale plane for ``main``, started against the live serving
    port: the controller reads the hub's burn verdicts (none without a
    hub: the up axis stays quiet) and the ``fleet.utilization`` gauge each
    beat, spawns and drains port miner workers, and re-weights the
    ``gateway``'s tenants under ``lock`` when ``weights=`` is given.
    Returns ``(pump, workers)``."""
    from ..autoscale import (
        AutoscaleController,
        ControllerPump,
        GatewayWeightActuator,
        ProcessActuator,
    )

    workers = ProcessActuator(
        live_port,
        backend=driver["backend"],
        telemetry=f"127.0.0.1:{tport}" if tport else None,
    )
    weights = None
    if gateway is not None and cfg.overload_weights:
        weights = GatewayWeightActuator(gateway, lock)

    def burn():
        if hub is None:
            return None
        return ((hub.last_state() or {}).get("slo") or {}).get("alerts")

    controller = AutoscaleController(
        workers,
        burn=burn,
        utilization=lambda: METRICS.gauges().get("fleet.utilization"),
        weights=weights,
        config=cfg,
    )
    if hub is not None:
        # The controller's state rides the fleet log.
        hub.add_extra("autoscale", controller.status)
    return ControllerPump(controller, interval=driver["interval"]).start(), workers


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv if argv is None else argv
    # Parity: reference logs to ./log.txt (bitcoin/server/server.go:26-39).
    logging.basicConfig(
        filename="log.txt",
        level=logging.INFO,
        format="%(asctime)s %(filename)s:%(lineno)d %(message)s",
    )
    checkpoint_path = None
    # --trace=FILE arms the structured event log (utils/trace.py), drained
    # to the file by the event plane's ticker; BMT_TRACE is the env
    # spelling for subprocess fleets.
    trace_path = os.environ.get("BMT_TRACE") or None
    # Fleet metrics plane, env spellings for subprocess fleets:
    # --telemetry-port=P listens for miner snapshot sidecars there;
    # --fleet-log=FILE appends the merged view as JSONL (tools.dash reads
    # it); --prom=FILE maintains a Prometheus text exposition;
    # --slo[=CONF] arms burn-rate alerting (utils/slo.parse_slo_config).
    telemetry_port = os.environ.get("BMT_TELEMETRY_PORT") or None
    fleet_log = os.environ.get("BMT_FLEET_LOG") or None
    prom_path = os.environ.get("BMT_PROM") or None
    slo_conf = os.environ.get("BMT_SLO") or None
    # The range-fold workload this server schedules and validates.  The
    # wire protocol never names workloads, so server and miners must agree
    # on the flag; BMT_WORKLOAD is the env spelling.
    workload_name = os.environ.get("BMT_WORKLOAD") or None
    # Adaptive dispatch plane.  --chunk-target-s tunes the per-chunk
    # service-time target the 10^k size ladder aims at; --static-chunks=N
    # pins fixed N-nonce chunks with the ladder and the steal scan OFF;
    # --steal-factor tunes the fleet-p50 multiple past which a straggler's
    # tail is re-dispatched (0 disables).  Env spellings as in the
    # reference.
    chunk_target_s = os.environ.get("BMT_CHUNK_TARGET_S") or None
    static_chunks = os.environ.get("BMT_STATIC_CHUNKS") or None
    steal_factor = os.environ.get("BMT_STEAL_FACTOR") or None
    # --adaptive-depth (default ON): re-size the per-miner pipelined
    # assignment window each tick off the observed dispatch latency
    # (hist.device_dispatch_s p50, this process's registry: miners in other
    # processes feed their own, so a subprocess fleet keeps the static depth).
    # --no-adaptive-depth (or BMT_ADAPTIVE_DEPTH=0 — "" and "0" mean OFF,
    # the BMT_SANITIZE convention) restores the static window outright.
    _ad_env = os.environ.get("BMT_ADAPTIVE_DEPTH")
    adaptive_depth = _ad_env not in ("", "0") if _ad_env is not None else True
    # --async-ingress: serve the public port on the asyncio event-loop
    # front end (AsyncIngress) instead of the blocking facade — O(1)
    # threads in live conns.  Same engine, same contracts.
    async_ingress = os.environ.get("BMT_ASYNC_INGRESS", "") not in ("", "0")
    # The serving gateway: --gateway arms coalescing + the result cache +
    # the interval span store + admission control; --cache=FILE /
    # --spans=FILE persist the stores, --rate / --burst / --max-queued tune
    # admission, --prefill=N (env BMT_PREFILL) arms N-nonce speculative
    # gap-sweeps while idle.  Every one of them implies --gateway.
    gateway_on = False
    cache_path = None
    spans_path = None
    rate: Optional[float] = 5.0
    burst = 10.0
    max_queued = 256
    prefill = os.environ.get("BMT_PREFILL") or None
    # --autoscale[=SPEC] arms the SLO-burn-driven controller against THIS
    # serving port (env BMT_AUTOSCALE; grammar in
    # autoscale.parse_autoscale_config).
    autoscale_conf = os.environ.get("BMT_AUTOSCALE") or None
    pos = []
    for a in argv[1:]:
        if a.startswith("--checkpoint="):
            checkpoint_path = a.split("=", 1)[1]
        elif a.startswith("--chunk-target-s="):
            chunk_target_s = a.split("=", 1)[1]
        elif a.startswith("--static-chunks="):
            static_chunks = a.split("=", 1)[1]
        elif a.startswith("--steal-factor="):
            steal_factor = a.split("=", 1)[1]
        elif a == "--adaptive-depth":
            adaptive_depth = True
        elif a == "--no-adaptive-depth":
            adaptive_depth = False
        elif a == "--async-ingress":
            async_ingress = True
        elif a.startswith("--trace="):
            trace_path = a.split("=", 1)[1]
        elif a.startswith("--workload="):
            workload_name = a.split("=", 1)[1]
        elif a.startswith("--telemetry-port="):
            telemetry_port = a.split("=", 1)[1]
        elif a.startswith("--fleet-log="):
            fleet_log = a.split("=", 1)[1]
        elif a.startswith("--prom="):
            prom_path = a.split("=", 1)[1]
        elif a == "--slo":
            slo_conf = "1"
        elif a.startswith("--slo="):
            slo_conf = a.split("=", 1)[1]
        elif a.startswith("--prefill="):
            prefill = a.split("=", 1)[1]
        elif a == "--autoscale":
            autoscale_conf = "1"
        elif a.startswith("--autoscale="):
            autoscale_conf = a.split("=", 1)[1]
        elif a == "--gateway":
            gateway_on = True
        elif a.startswith("--cache="):
            gateway_on = True
            cache_path = a.split("=", 1)[1]
        elif a.startswith("--spans="):
            gateway_on = True
            spans_path = a.split("=", 1)[1]
        elif a.startswith(("--rate=", "--burst=", "--max-queued=")):
            gateway_on = True  # admission knobs imply the gateway, like --cache
            name, _, val = a.partition("=")
            try:
                if name == "--rate":
                    rate = float(val) or None  # 0 = unlimited
                elif name == "--burst":
                    burst = float(val)
                else:
                    max_queued = int(val)
            except ValueError:
                print(f"{a} is not a number.")
                return 0
        else:
            pos.append(a)
    if len(pos) != 1:
        print(f"Usage: ./{argv[0]} <port> [--checkpoint=FILE]", end="")
        return 0
    try:
        port = int(pos[0])
        tport = int(telemetry_port) if telemetry_port is not None else None
    except ValueError as e:
        print("Port must be a number:", e)
        return 0
    # Parse the autoscale policy up front: a spec typo must fail fast,
    # before anything binds a port or spawns a thread.
    as_cfg = as_driver = None
    if autoscale_conf:
        from ..autoscale import parse_autoscale_config

        try:
            as_cfg, as_driver = parse_autoscale_config(autoscale_conf)
        except ValueError as e:
            print(str(e))
            return 0
    # Any fleet-plane knob arms the hub: the sidecar listener needs a
    # port, but the SLO engine and the publish sinks are useful even on a
    # single-process server (the local registry is its own source).
    try:
        hub = _start_hub(tport, fleet_log, prom_path, slo_conf)
    except (ValueError, OSError) as e:
        # Same friendly contract as a busy serving port — no traceback.
        print(str(e))
        return 0
    try:
        server = None
        if not async_ingress:
            try:
                server = lsp.Server(port)
            except OSError as e:
                print(str(e))
                return 0
            print("Server listening on port", port)
        # Degraded-network runs: arm a named seeded scenario in THIS
        # process — the server's tx shapes both the chunk stream to miners
        # and the Result stream to clients.
        scenario = os.environ.get("BMT_CHAOS_SCENARIO")
        if scenario:
            from ..lspnet.chaos import CHAOS, standard_scenarios

            library = standard_scenarios()
            if scenario in library:
                loop = float(os.environ.get("BMT_CHAOS_LOOP", "0") or 0)
                CHAOS.run(library[scenario], loop_every=loop or None)
            else:
                print(f"unknown BMT_CHAOS_SCENARIO {scenario!r}; ignoring",
                      file=sys.stderr)
        if trace_path:
            from ..utils.trace import TRACE

            TRACE.enable(path=trace_path)
        from ..workloads import resolve as resolve_workload
        from ..workloads import resolve_nondefault

        try:
            workload = resolve_workload(workload_name)
        except ValueError as e:
            print(str(e))
            if server is not None:
                server.close()
            return 0
        resume = load_checkpoint(checkpoint_path) if checkpoint_path else None
        # Scheduler(workload=None) is the default's path; only a non-default
        # selection threads the registry object in (resolve_nondefault).
        wl = resolve_nondefault(workload)
        sched_kw: dict = {}
        try:
            if chunk_target_s is not None:
                sched_kw["target_chunk_seconds"] = float(chunk_target_s)
            if steal_factor is not None:
                sched_kw["steal_factor"] = float(steal_factor)
            if static_chunks is not None:
                n = int(static_chunks)
                sched_kw.update(
                    min_chunk=n, max_chunk=n,
                    adaptive_chunks=False, steal_factor=0.0,
                )
            if adaptive_depth:
                sched_kw["adaptive_depth"] = True
            prefill_n = int(prefill) if prefill is not None else 0
        except ValueError as e:
            print("Invalid scheduler configuration:", e)
            if server is not None:
                server.close()
            return 0
        if prefill_n > 0:
            # Prefill is a gateway feature: both spellings (--prefill= and
            # BMT_PREFILL) imply --gateway, or the knob would silently no-op.
            gateway_on = True
        sched = Scheduler(resume_state=resume, workload=wl, **sched_kw)
        if gateway_on:
            from ..gateway import Gateway, ResultCache, SpanStore

            sched = Gateway(
                sched,
                cache=ResultCache(path=cache_path, workload=workload.name),
                spans=SpanStore(path=spans_path, workload=workload.name),
                rate=rate,
                burst=burst,
                max_queued=max_queued,
                prefill=prefill_n,
                # Speculate only after a full second of continuous idleness:
                # a tick landing in the gap between back-to-back requests
                # must not hand a miner soon-to-be-orphaned work.
                prefill_idle_s=1.0,
            )
        # The event lock is made HERE when autoscale is on and handed to the
        # shell, so the weight actuator and the serve plane hold the SAME
        # lock.  Arming waits for the live port (the ingress binds in
        # start()).
        pump = workers = None
        ev_lock = threading.Lock() if as_cfg is not None else None

        def _arm_autoscale(live_port: int) -> None:
            nonlocal pump, workers
            pump, workers = _start_autoscale(
                live_port, as_cfg, as_driver, sched if gateway_on else None, ev_lock,
                hub, tport)

        try:
            if async_ingress:
                try:
                    ingress = AsyncIngress(
                        port, scheduler=sched, checkpoint_path=checkpoint_path,
                        telemetry=hub, lock=ev_lock,
                    ).start()
                except OSError as e:
                    print(str(e))
                    return 0
                print("Server listening on port", ingress.port)
                if as_cfg is not None:
                    _arm_autoscale(ingress.port)
                try:
                    # The engine runs on the ingress loop + ticker; this
                    # thread just waits for shutdown (Ctrl-C / SIGTERM).
                    while ingress._thread is not None and ingress._thread.is_alive():
                        ingress._thread.join(timeout=1.0)
                finally:
                    ingress.close()
                if ingress.error is not None:
                    # A handler crash killed the ingress thread: re-raise so
                    # the process exits non-zero, exactly like the blocking
                    # shell where the same exception propagates out of serve().
                    raise ingress.error
            else:
                if as_cfg is not None:
                    _arm_autoscale(server.port)
                serve(server, scheduler=sched, checkpoint_path=checkpoint_path,
                      telemetry=hub, lock=ev_lock)
        finally:
            if pump is not None:
                pump.stop()
            if workers is not None:
                workers.stop_all()
            if server is not None:
                server.close()
        return 0
    finally:
        if hub is not None:
            hub.close()


if __name__ == "__main__":
    sys.exit(main())
