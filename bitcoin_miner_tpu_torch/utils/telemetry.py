"""The sidecar telemetry channel: miner → server metric snapshots.

The port's copy of the reference package's ``utils/telemetry.py``: the
same frames, payloads and sinks, so either package's exporter feeds
either package's hub.

The frozen ``bitcoin/message`` + ``lsp/message`` contracts stay
byte-identical: telemetry rides a SECOND LSP connection to the server's
``--telemetry-port`` and speaks its own versioned JSON payload format
(skew-tolerant — unknown fields are ignored, undecodable payloads are
dropped and counted, a v2 server still reads v1 miners' ``v`` field).

Export is off-hot-path by construction: the exporter is a daemon timer
thread that snapshots the process registry (``Metrics.export_state`` —
O(#metrics) under short per-object locks) and writes one LSP payload.
LSP writes enqueue without blocking, so the sweep loop and the serve
loop never wait on telemetry; a dead channel costs the exporter thread a
bounded reconnect backoff and everyone else nothing.

Server side, the :class:`TelemetryHub` owns the telemetry LSP server, a
:class:`~bitcoin_miner_tpu_torch.utils.fleetview.FleetView` the ingest thread
merges snapshots into, the optional SLO engine, and the publish sinks:
a fleet-log JSONL file (``python -m tools.dash FILE`` renders it), a
Prometheus exposition file, and live dashboard subscribers (a
``tools.dash --connect`` client sends one subscribe payload and then
receives merged-view states).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
import zlib
from typing import List, Optional, Set, Tuple

from .. import lsp
from . import trace
from .fleetview import FleetView, render_prometheus
from .metrics import METRICS, Metrics

TELEMETRY_V = 1

#: Raw bytes per telemetry fragment.  The LSP wire inherits the
#: reference's frozen 1000-byte read-buffer semantics
#: (``lsp.MAX_MESSAGE_SIZE``): a marshaled datagram beyond it is
#: truncated on receive and dropped by Size validation, so it would
#: retransmit forever.  480 raw bytes base64-expand to 640 inside the
#: JSON envelope — comfortably under the ceiling with id headroom.
_FRAG_MAX = 480

#: Abuse bounds for the UNAUTHENTICATED ingest side: a peer on the
#: telemetry port must not be able to make the hub hold unbounded
#: fragment buffers or inflate a zlib bomb.  4096 fragments ≈ 2 MB
#: compressed per message (a fleet state is a few hundred KB at most);
#: 16 MB decompressed is far above any real snapshot.
_FRAG_LIMIT = 4096
_MAX_MSG_BYTES = 16 << 20


# ------------------------------------------------------------------ payloads

def _pack(obj: dict) -> bytes:
    """Compact JSON + zlib: metric names repeat heavily, so snapshots
    compress ~4×, which usually keeps a beat to a couple of fragments."""
    return zlib.compress(
        json.dumps(obj, separators=(",", ":")).encode("utf-8")
    )


def _unpack(blob: bytes) -> Optional[dict]:
    try:
        try:
            # Bounded inflate: a zlib bomb (MBs of compressed zeros) must
            # not balloon in the ingest thread — anything that wants more
            # than the cap is dropped, not served.
            d = zlib.decompressobj()
            raw = d.decompress(blob, _MAX_MSG_BYTES)
            if d.unconsumed_tail:
                return None  # truncated at the cap: hostile or garbage
        except zlib.error:
            raw = blob  # uncompressed peer: still speak
        obj = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None
    return obj if isinstance(obj, dict) else None


def encode_frames(obj: dict, msg_id: int) -> List[bytes]:
    """One logical telemetry message as ``T1|id|i|n|<chunk>`` fragments,
    each sized so its LSP datagram stays under the frozen 1000-byte wire
    ceiling.  LSP delivers in-order per conn, so reassembly is a plain
    accumulate — no retransmit logic lives at this layer."""
    blob = _pack(obj)
    n = max(1, math.ceil(len(blob) / _FRAG_MAX))
    return [
        b"T1|" + f"{msg_id}|{i}|{n}|".encode("ascii")
        + blob[i * _FRAG_MAX:(i + 1) * _FRAG_MAX]
        for i in range(n)
    ]


class FrameAssembler:
    """Per-connection reassembly of the ``T1`` fragment stream.  Not
    thread-safe — each conn's frames are fed by the one thread reading
    that conn.  ``feed`` returns ``(done, obj)``: ``(False, None)``
    mid-assembly (or while silently skipping the rest of an
    already-reported lost message), ``(True, None)`` for ONE lost or
    undecodable message (callers count these — one loss, one count,
    however many fragments it had), ``(True, obj)`` for a complete one.
    A fresh msg_id mid-assembly resets — the torn message is simply
    lost (best-effort channel).  Fragment counts are capped
    (``_FRAG_LIMIT``): the ingest side is unauthenticated, so a peer
    declaring a billion fragments must be dropped, not buffered."""

    def __init__(self) -> None:
        self._id: Optional[int] = None
        self._parts: List[bytes] = []
        self._expect = 0
        self._skip_id: Optional[int] = None  # lost msg already reported

    def _reset(self) -> None:
        self._id, self._parts, self._expect = None, [], 0

    def _lose(self, mid: Optional[int]) -> Tuple[bool, Optional[dict]]:
        """Drop a message: report it once, swallow its other fragments."""
        self._reset()
        if mid is not None and mid == self._skip_id:
            return False, None  # already counted this message's loss
        self._skip_id = mid
        return True, None

    def feed(self, payload: bytes) -> Tuple[bool, Optional[dict]]:
        if not payload.startswith(b"T1|"):
            return True, _unpack(payload)  # unframed single message
        try:
            _tag, mid_b, idx_b, n_b, chunk = payload.split(b"|", 4)
            mid, idx, n = int(mid_b), int(idx_b), int(n_b)
        except ValueError:
            return self._lose(None)
        if n < 1 or not 0 <= idx < n or n > _FRAG_LIMIT:
            return self._lose(mid)
        if idx == 0 or mid != self._id:
            if idx != 0:
                return self._lose(mid)  # joined mid-message
            self._reset()
            self._id, self._expect = mid, n
        if idx != len(self._parts) or n != self._expect:
            return self._lose(mid)
        self._parts.append(chunk)
        if len(self._parts) < self._expect:
            return False, None
        blob = b"".join(self._parts)
        self._reset()
        return True, _unpack(blob)


def encode_snapshot(
    source: str, seq: int, state: dict, t: float
) -> List[bytes]:
    """One exporter beat as ready-to-write LSP payloads: the registry
    state stamped with source identity, a per-conn-monotonic sequence
    number, and wall time."""
    return encode_frames(
        {"v": TELEMETRY_V, "source": source, "seq": seq, "t": t, **state},
        seq,
    )


def encode_subscribe() -> bytes:
    """A dashboard's opening payload: deliver merged states to me."""
    return json.dumps({"v": TELEMETRY_V, "subscribe": True}).encode("utf-8")


def validate_snapshot(obj: Optional[dict]) -> Optional[dict]:
    """Version/shape gate on an assembled message; None for anything
    alien (best-effort channel: drop, count, carry on)."""
    if not isinstance(obj, dict) or obj.get("v") != TELEMETRY_V:
        return None
    if obj.get("subscribe") is True:
        return obj
    if not isinstance(obj.get("source"), str):
        return None
    return obj


# ------------------------------------------------------------------ exporter

class TelemetryExporter:
    """Miner-side sidecar: a daemon timer thread shipping registry
    snapshots.  Own connection, own backoff — the serving connection and
    the sweep loop never block on it.  All mutable state lives on the
    exporter thread; ``stop()`` only sets an Event."""

    def __init__(
        self,
        host: str,
        port: int,
        source: str,
        interval: float = 2.0,
        params: Optional["lsp.Params"] = None,
        registry: Optional[Metrics] = None,
        label: Optional[str] = None,
        backoff_cap: float = 8.0,
    ) -> None:
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self._host, self._port, self._source = host, port, source
        self._interval = interval
        self._params = params
        self._registry = registry if registry is not None else METRICS
        #: chaos endpoint label — ``tele-<source>`` by default, so a
        #: partition of the sidecar (``CHAOS.partition("tele-<source>")``)
        #: never touches the miner's serving conn.
        self._label = label or f"tele-{source}"
        self._backoff_cap = backoff_cap
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TelemetryExporter":
        self._thread = threading.Thread(
            target=self._loop, name=f"telemetry-{self._source}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # ------------------------------------------------------------- internals

    def _loop(self) -> None:
        client: Optional["lsp.Client"] = None
        failures = 0
        seq = 0
        try:
            while not self._stop.wait(self._interval):
                if client is None:
                    try:
                        client = lsp.Client(
                            self._host, self._port, self._params,
                            label=self._label,
                        )
                    except (lsp.LspError, OSError):
                        METRICS.inc("telemetry.export_errors")
                        failures += 1
                        # Extra beats of capped backoff on top of the
                        # interval; a stop request ends the wait early.
                        if self._stop.wait(
                            min(self._interval * failures, self._backoff_cap)
                        ):
                            return
                        continue
                    failures = 0
                    # seq restarts at 1 per conn; FleetView accepts seq 1
                    # unconditionally, so reconnects never wedge a source.
                    seq = 0
                seq += 1
                frames = encode_snapshot(
                    self._source, seq, self._registry.export_state(),
                    time.time(),
                )
                try:
                    for frame in frames:
                        client.write(frame)
                    METRICS.inc("telemetry.exports")
                except lsp.LspError:
                    METRICS.inc("telemetry.export_errors")
                    try:
                        client.close()
                    except lsp.LspError:
                        pass
                    client = None
        finally:
            if client is not None:
                try:
                    client.close()
                except lsp.LspError:
                    pass


# ----------------------------------------------------------------------- hub

def _write_text_atomic(path: str, text: str) -> None:
    """Temp-write + rename, so a scraper never reads a torn exposition."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class TelemetryHub:
    """Server-side anchor of the metrics plane: the telemetry LSP server,
    the fleet view the ingest thread merges into, the SLO engine, and the
    publish sinks.  ``tick()`` is driven by apps/server.serve's ticker
    (or by :meth:`start`'s optional ``self_tick`` thread in benches and
    tests that have no serve loop) — always OFF the serve event lock;
    every structure here carries its own lock."""

    def __init__(
        self,
        port: int = 0,
        fleet: Optional[FleetView] = None,
        params: Optional["lsp.Params"] = None,
        source: Optional[str] = "server",
        registry: Optional[Metrics] = None,
        slo=None,
        fleet_log: Optional[str] = None,
        prom_path: Optional[str] = None,
        publish_interval: float = 2.0,
        straggler_ratio: float = 3.0,
        straggler_min_samples: int = 8,
        clock=time.monotonic,
        log: Optional[logging.Logger] = None,
    ) -> None:
        self.fleet = fleet if fleet is not None else FleetView(clock=clock)
        self._server = lsp.Server(port, params, label="telemetry-hub")
        self.port = self._server.port
        self._source = source  # None disables the local-registry ingest
        self._registry = registry if registry is not None else METRICS
        self._slo = slo
        self._fleet_log = fleet_log
        self._prom_path = prom_path
        self._publish_interval = publish_interval
        self._straggler_ratio = straggler_ratio
        self._straggler_min_samples = straggler_min_samples
        self._clock = clock
        self._log = log or logging.getLogger("bitcoin_miner_tpu_torch.telemetry")
        self._lock = threading.Lock()
        self._subscribers: Set[int] = set()  # guarded-by: _lock
        self._flagged: Set[str] = set()  # stragglers already traced  # guarded-by: _lock
        self._last_state: Optional[dict] = None  # guarded-by: _lock
        self._last_publish = 0.0  # guarded-by: _lock
        self._pub_id = 0  # subscriber-stream message ids  # guarded-by: _lock
        #: Extra state providers: key -> zero-arg callable whose
        #: dict return is published under ``state[key]`` each tick, exactly
        #: like the SLO block — the autoscale controller's status() rides
        #: this into the fleet log / dashboard.  # guarded-by: _lock
        self._extras: dict = {}
        self._threads: list = []
        self._stop = threading.Event()

    def add_extra(self, key: str, fn) -> None:
        """Publish ``fn()`` (a JSON-able dict) under ``state[key]`` on
        every tick.  Best-effort like every sink: a raising provider is
        logged and retried next beat, never fatal to the tick."""
        with self._lock:
            self._extras[key] = fn

    def start(self, self_tick: Optional[float] = None) -> "TelemetryHub":
        t = threading.Thread(
            target=self._ingest_loop, name="telemetry-ingest", daemon=True
        )
        t.start()
        self._threads.append(t)
        if self_tick is not None:
            tt = threading.Thread(
                target=self._tick_loop, args=(self_tick,),
                name="telemetry-tick", daemon=True,
            )
            tt.start()
            self._threads.append(tt)
        return self

    def close(self) -> None:
        self._stop.set()
        self._server.close()  # unblocks the ingest loop's read()
        for t in self._threads:
            t.join(timeout=2.0)

    def last_state(self) -> Optional[dict]:
        with self._lock:
            return self._last_state

    # ----------------------------------------------------------------- ticks

    def tick(self, now: Optional[float] = None) -> dict:
        """One metrics-plane beat: fold the local registry in as its own
        source, evaluate SLOs, run the straggler detector, publish fleet
        gauges, and (rate-limited) the fleet log / prom file /
        subscriber stream.  Returns the merged JSON-able state."""
        now = self._clock() if now is None else now
        if self._source is not None:
            self.fleet.ingest(
                self._source, self._registry.export_state(), now=now
            )
        # One merge + one source scan per beat, shared across the display
        # state, the straggler detector and the SLO engine (which builds
        # its own include_stale merge — different semantics, see slo.py).
        merged = self.fleet.merged(now=now)
        sources = self.fleet.sources(now=now)
        state = self.fleet.merged_state(now=now, merged=merged,
                                        sources=sources)
        exclude = (self._source,) if self._source is not None else ()
        strag = self.fleet.stragglers(
            now=now, ratio=self._straggler_ratio,
            min_samples=self._straggler_min_samples, exclude=exclude,
        )
        state["stragglers"] = strag
        if self._slo is not None:
            state["slo"] = self._slo.tick(
                self.fleet, now=now, exclude=exclude, sources=sources,
            )
        with self._lock:
            extras = list(self._extras.items())
        for key, fn in extras:
            try:
                state[key] = fn()
            except Exception:
                self._log.exception(
                    "telemetry extra %r failed; will retry", key
                )
        # Newly flagged stragglers get ONE trace event each (the fleet
        # event stream must not repeat the same verdict every tick).
        names = {s["source"] for s in strag}
        with self._lock:
            fresh_flags = names - self._flagged
            self._flagged = names
        for s in strag:
            if s["source"] in fresh_flags:
                trace.emit(
                    None, "fleet", "straggler",
                    source=s["source"], p50_s=round(s["p50_s"], 6),
                    fleet_p50_s=round(s["fleet_p50_s"], 6),
                    ratio=round(s["ratio"], 2),
                )
        METRICS.set_gauge("fleet.sources", state["sources"])
        METRICS.set_gauge("fleet.sources_stale", state["stale_sources"])
        METRICS.set_gauge("fleet.stragglers", len(strag))
        with self._lock:
            self._last_state = state
            due = now - self._last_publish >= self._publish_interval
            if due:
                self._last_publish = now
            subs = list(self._subscribers) if due else []
        if due:
            self._publish(state, merged, subs)
        return state

    # ------------------------------------------------------------- internals

    def _tick_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.tick()
            except Exception:
                self._log.exception("telemetry self-tick failed; will retry")

    def _ingest_loop(self) -> None:
        assemblers: dict = {}  # conn_id -> FrameAssembler (this thread only)
        while True:
            try:
                conn_id, payload = self._server.read()
            except lsp.ConnLostError as e:
                assemblers.pop(e.conn_id, None)
                with self._lock:
                    self._subscribers.discard(e.conn_id)
                continue
            except lsp.LspError:
                return  # hub closed
            asm = assemblers.get(conn_id)
            if asm is None:
                asm = assemblers[conn_id] = FrameAssembler()
            done, obj = asm.feed(payload)
            if not done:
                continue
            snap = validate_snapshot(obj)
            if snap is None:
                METRICS.inc("telemetry.decode_errors")
                continue
            if snap.get("subscribe") is True:
                with self._lock:
                    self._subscribers.add(conn_id)
                continue
            if self.fleet.ingest(snap["source"], snap):
                METRICS.inc("telemetry.snapshots_merged")

    def _publish(self, state: dict, merged: dict, subs: list) -> None:
        """File + subscriber sinks, all best-effort and all outside every
        lock: a full disk or a dead dashboard must not stall the tick.
        ``merged`` is tick()'s already-computed raw merge — the prom sink
        must not pay a second O(sources × metrics) merge per beat."""
        if self._fleet_log:
            try:
                with open(self._fleet_log, "a") as f:
                    f.write(json.dumps(state) + "\n")
            except OSError:
                self._log.exception("fleet-log append failed; will retry")
        if self._prom_path:
            try:
                _write_text_atomic(
                    self._prom_path, render_prometheus(merged)
                )
            except OSError:
                self._log.exception("prom write failed; will retry")
        if subs:
            with self._lock:
                self._pub_id += 1
                pub_id = self._pub_id
            frames = encode_frames(state, pub_id)
            for conn_id in subs:
                try:
                    for frame in frames:
                        self._server.write(conn_id, frame)
                except lsp.LspError:
                    with self._lock:
                        self._subscribers.discard(conn_id)
