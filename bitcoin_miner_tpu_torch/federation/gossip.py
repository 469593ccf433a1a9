"""Span-store gossip between replicas, with per-peer acked deltas.

A range solved anywhere should answer everywhere.  Each replica
journals the spans IT solved (:class:`GossipSpanStore`) and a daemon
(:class:`SpanGossip`) periodically ships them to every peer's federation
port: **delta** beats carry the journal entries the peer has not yet
acknowledged, and every ``full_every``-th beat carries the **full** span
state instead — the anti-entropy pass of last resort.

**Per-peer acks**: every journaled span carries a sequence
number; a beat to peer P carries the high-water seq it includes
(``jseq``) plus an ack of the high-water seq received FROM P, and P acks
symmetrically on its reverse beats.  Unacked entries are *retained* and
resent on the next beat, so a delta lost with a dead conn (an LSP write
enqueues locally and a partition can swallow it) converges on the next
successful beat instead of waiting for the periodic full sync
(``gossip.retransmits`` counts resent spans).  The journal stays
bounded: when a lagging peer's unacked entries age out of the journal,
that peer is escalated to a full sync (``federation.gossip_full_syncs``)
— overflow costs one bigger message, never correctness.

**Heartbeats**: every beat piggybacks the sender's
``(incarnation, load_state)`` — and a beat is sent even with nothing to
ship, so a quiet cell still proves liveness every interval.  The
receiving cell's :class:`~bitcoin_miner_tpu_torch.federation.membership.Membership`
failure detector runs on these, not on connect timeouts.

Wire format: the telemetry fragmentation machinery
(:func:`~bitcoin_miner_tpu_torch.utils.telemetry.encode_frames` — compact JSON
+ zlib, split into ``T1|id|i|n|chunk`` fragments) so every datagram
respects the frozen 1000-byte LSP wire ceiling however many spans a full
sync carries.  Gossip rides reliable LSP conns labeled
``gossip-<cell>``, so the chaos layer can partition or throttle one
replica's gossip channel without touching its serving or forwarding
links.

Merging a peer's span is sound anywhere: a span ``[lo, hi] ->
(min_hash, nonce)`` is a fact about a pure function, and the interval
store's argmin-inside-query answerability rule keeps every answer built
from it bit-exact — gossip changes WHERE a fact is known, never what it
says.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .. import lsp
from ..gateway.cache import SpanStore
from ..utils.metrics import METRICS
from ..utils.telemetry import encode_frames

GOSSIP_V = 1

#: (data, lo, hi, min_hash, nonce) — one solved span on the wire.
WireSpan = Tuple[str, int, int, int, int]


def encode_gossip(
    cell: str,
    seq: int,
    spans: List[WireSpan],
    full: bool,
    *,
    jseq: int = 0,
    ack: int = 0,
    hb: Optional[dict] = None,
) -> List[bytes]:
    """One gossip message as ready-to-write LSP payloads (every frame's
    datagram stays under the frozen wire ceiling).  ``jseq`` is the
    journal high-water this message covers, ``ack`` the high-water the
    sender has received from the DESTINATION, ``hb`` the piggybacked
    heartbeat."""
    msg = {
        "v": GOSSIP_V,
        "kind": "spans",
        "from": cell,
        "seq": seq,
        "full": bool(full),
        "spans": [list(s) for s in spans],
        "jseq": int(jseq),
        "ack": int(ack),
    }
    if hb is not None:
        msg["hb"] = hb
    return encode_frames(msg, seq)


def encode_handoff(cell: str, seq: int, state: dict) -> List[bytes]:
    """A draining cell's work handoff: the scheduler's
    workload-stamped orphan export, framed like every other federation
    message so each datagram stays under the frozen wire ceiling."""
    return encode_frames(
        {"v": GOSSIP_V, "kind": "handoff", "from": cell, "state": state},
        seq,
    )


def decode_fed(obj: Optional[dict]) -> Optional[dict]:
    """Version/shape gate on an assembled federation-port message —
    span gossip or a drain handoff; None for anything alien
    (best-effort channel: drop, count, carry on)."""
    if not isinstance(obj, dict) or obj.get("v") != GOSSIP_V:
        return None
    if not isinstance(obj.get("from"), str):
        return None
    kind = obj.get("kind")
    if kind == "spans":
        if not isinstance(obj.get("spans"), list):
            return None
        return obj
    if kind == "handoff":
        if not isinstance(obj.get("state"), dict):
            return None
        return obj
    return None


def decode_gossip(obj: Optional[dict]) -> Optional[dict]:
    """The span-gossip gate (the pre-handoff API surface): exactly
    :func:`decode_fed` restricted to ``kind == "spans"``."""
    msg = decode_fed(obj)
    if msg is None or msg.get("kind") != "spans":
        return None
    return msg


def apply_gossip(store: SpanStore, msg: dict) -> int:
    """Fold a decoded gossip message into ``store``; returns the rows
    that passed the gate (a len() delta would undercount — merges
    coalesce).  Caller serializes (the replica's event lock).  Row
    validation mirrors the span-store's disk loader: one bad row must
    not poison the rest."""
    merged = 0
    for row in msg["spans"]:
        try:
            data, lo, hi, h, n = row
        except (TypeError, ValueError):
            continue
        if not isinstance(data, str) or not all(
            isinstance(v, int) and not isinstance(v, bool)
            for v in (lo, hi, h, n)
        ):
            continue
        store.add_remote(data, lo, hi, h, n)
        merged += 1
    return merged


class GossipSpanStore(SpanStore):
    """A :class:`SpanStore` that journals locally-solved spans for the
    gossip daemon.  ``add`` (the gateway's path for chunks this cell
    swept, and the disk loader's — a restart's reloaded spans are state
    peers may lack) journals; ``add_remote`` (gossip ingest) does not,
    so full-mesh gossip never echoes a peer's spans back at it.

    Journal entries carry monotone sequence numbers and are RETAINED
    until every peer acks them: :meth:`pending_for` is the
    per-peer unacked delta the gossip daemon ships, :meth:`record_ack`
    advances a peer's high-water (pruning entries everyone has), and
    :meth:`needs_full` reports a peer so far behind that the bounded
    journal aged its entries out — the full-sync escalation.  The
    bound still holds: overflow drops oldest — a lagging peer costs one
    full sync, never correctness.  Not thread-safe by itself —
    serialized under the replica's event lock like every other policy
    structure."""

    def __init__(
        self,
        capacity: int = 512,
        max_spans_per_data: int = 64,
        path: Optional[str] = None,
        journal_max: int = 4096,
        workload: Optional[str] = None,
    ) -> None:
        self.journal_max = max(1, int(journal_max))
        self._journal: Deque[Tuple[int, WireSpan]] = deque()
        self._jseq = 0  # seq of the newest journaled span
        self._jdropped = 0  # highest seq ever aged out unpruned (overflow)
        #: Per-peer high-water seq the peer has ACKED of OUR journal.
        self._acked: Dict[str, int] = {}
        #: The gossip audience (set by SpanGossip): pruning may only drop
        #: entries EVERY configured peer acked — a peer that never acked
        #: anything still counts.  None (bare store) disables ack-floor
        #: pruning; journal_max stays the bound either way.
        self._gossip_peers: Optional[set] = None
        #: Per-peer high-water seq WE have received of THEIR journal
        #: (the value we ack back on our next beat to them).
        self._seen: Dict[str, int] = {}
        super().__init__(capacity, max_spans_per_data, path, workload=workload)

    def add(self, data: str, lo: int, hi: int, hash_: int, nonce: int) -> None:
        if self.capacity == 0 or lo > hi or not (lo <= nonce <= hi):
            return  # mirror the store's refusal: refused spans don't gossip
        super().add(data, lo, hi, hash_, nonce)
        self._jseq += 1
        self._journal.append((self._jseq, (data, lo, hi, hash_, nonce)))
        while len(self._journal) > self.journal_max:
            seq, _ = self._journal.popleft()
            # Aged out while possibly unacked: any peer still behind this
            # seq can no longer be served by deltas (needs_full fires).
            self._jdropped = max(self._jdropped, seq)

    def add_remote(
        self, data: str, lo: int, hi: int, hash_: int, nonce: int
    ) -> None:
        """A peer's span: merged, never re-journaled."""
        super().add(data, lo, hi, hash_, nonce)

    # -------------------------------------------------------- ack bookkeeping

    def jseq(self) -> int:
        """The journal's high-water sequence (what a full sync covers)."""
        return self._jseq

    def pending_for(self, peer: str) -> List[Tuple[int, WireSpan]]:
        """Journal entries ``peer`` has not acked — the delta payload of
        the next beat to it (oldest first)."""
        acked = self._acked.get(peer, 0)
        return [(seq, span) for seq, span in self._journal if seq > acked]

    def set_peers(self, names) -> None:
        """Declare the gossip audience (every configured peer) — the
        denominator of the ack-floor prune."""
        self._gossip_peers = set(names)

    def record_ack(self, peer: str, seq: int) -> None:
        """``peer`` has received our journal through ``seq``; prune
        entries EVERY configured peer has acked (a never-acking peer
        holds the floor at 0 — its entries age out via journal_max and
        escalate it to a full sync, they are never silently dropped)."""
        if seq > self._acked.get(peer, 0):
            self._acked[peer] = seq
        if self._gossip_peers is None:
            return  # audience unknown: journal_max is the only bound
        floor = (
            min(self._acked.get(p, 0) for p in self._gossip_peers)
            if self._gossip_peers
            else self._jseq
        )
        while self._journal and self._journal[0][0] <= floor:
            self._journal.popleft()

    def acked_seq(self, peer: str) -> int:
        return self._acked.get(peer, 0)

    def needs_full(self, peer: str) -> bool:
        """True when deltas can no longer converge ``peer``: entries it
        never acked were aged out of the bounded journal."""
        return self._acked.get(peer, 0) < self._jdropped

    def record_seen(self, peer: str, seq: int) -> None:
        """We applied ``peer``'s journal through ``seq`` (acked back on
        our next beat to it)."""
        if seq > self._seen.get(peer, 0):
            self._seen[peer] = seq

    def seen_seq(self, peer: str) -> int:
        return self._seen.get(peer, 0)

    def reset_peer(self, peer: str) -> None:
        """``peer`` restarted (incarnation advanced): its journal seq
        space is fresh, so our high-water of THEIR journal resets, and
        their ack of OURS is void — retained entries resend."""
        self._seen.pop(peer, None)
        self._acked.pop(peer, None)

    # ----------------------------------------------------------- legacy API

    def drain_journal(self) -> List[WireSpan]:
        """Drain every retained entry (the pre-ack API surface; the
        acked-delta daemon uses :meth:`pending_for` instead)."""
        out = [span for _, span in self._journal]
        self._journal.clear()
        if out:
            self._acked.clear()
        return out

    def export_spans(self) -> List[WireSpan]:
        """Every solved span (the full-sync payload)."""
        return [
            (data, s[0], s[1], s[2], s[3])
            for data, m in self._maps.items()
            for s in m.spans()
        ]


class SpanGossip:
    """The per-replica gossip daemon: one timer thread shipping span
    deltas/full syncs — each carrying a heartbeat and per-peer acks — to
    every peer's federation port.  Store access is serialized under the
    replica's event lock (held only for the snapshot — sends happen
    outside it); conn state lives on the gossip thread alone.

    ``membership`` (optional) is ticked once per beat and supplies the
    piggybacked heartbeat via ``hb_fn`` — the replica wires both; a bare
    daemon (tests, tools) runs without them exactly as before.
    """

    def __init__(
        self,
        cell: str,
        store: GossipSpanStore,
        peers: Dict[str, Tuple[str, int]],
        lock,
        interval: float = 1.0,
        full_every: int = 4,
        params: Optional["lsp.Params"] = None,
        membership=None,
        hb_fn=None,
        loop=None,
    ) -> None:
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self.cell = cell
        self.store = store
        self.peers = dict(peers)
        if isinstance(store, GossipSpanStore):
            store.set_peers(self.peers)  # the ack-floor prune denominator
        self.lock = lock
        self.interval = interval
        self.full_every = max(1, int(full_every))
        self.params = params
        self.membership = membership
        self.hb_fn = hb_fn  # () -> {"inc": int, "load": str} | None
        #: Shared loop thread for the peer conns: the replica
        #: passes its forwarder loop so N gossip conns cost state, not N
        #: private loop threads — the last O(peers) thread cost in a
        #: cell.  None (bare daemons, tests) keeps one loop per conn.
        self.loop = loop
        #: Largest gossip datagram written so far (the wire-ceiling
        #: acceptance surface — benches and tests assert it stays under
        #: the frozen 1000-byte limit with envelope headroom).
        self.max_frame_bytes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._clients: Dict[str, "lsp.Client"] = {}  # gossip thread only
        self._seq = 0  # message id; serialized by the beat() caller
        self._beat = 0  # serialized by the beat() caller
        #: Per-peer (journal high-water shipped on the CURRENT conn, beat
        #: it was shipped on).  LSP conns are reliable and in-order, so
        #: entries at or below this high-water WILL arrive unless the
        #: conn dies — they get ``ack_grace_beats`` of grace before a
        #: resend (a healthy ack needs one reverse-beat round trip;
        #: resending inside that window would read every ordinary delta
        #: as a loss).  A send failure pops the entry: the conn is gone,
        #: its in-flight tail with it, and the next beat resends
        #: everything unacked from scratch.
        self._sent: Dict[str, Tuple[int, int]] = {}  # serialized by the beat() caller
        #: Per-peer high-water EVER put on any wire: survives conn death,
        #: so a post-reconnect resend of entries the old conn swallowed
        #: is correctly counted as ``gossip.retransmits``.
        self._ever_sent: Dict[str, int] = {}  # serialized by the beat() caller
        self.ack_grace_beats = 2

    def start(self) -> "SpanGossip":
        self._thread = threading.Thread(
            target=self._loop, name=f"gossip-{self.cell}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        for c in self._clients.values():
            try:
                c.close()
            except lsp.LspError:
                pass
        self._clients.clear()
        # Closed conns take their in-flight tails with them: void the
        # current-conn send windows, exactly like the send-failure path,
        # so a post-stop beat (the drain flush) resends every unacked
        # entry instead of grace-filtering recently-shipped ones away.
        self._sent.clear()

    # ------------------------------------------------------------- internals

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except Exception:
                METRICS.inc("federation.gossip_errors")

    def beat(self) -> None:
        """One gossip round (public so tests, benches and the drain path
        can drive beats deterministically instead of sleeping).  Builds a
        PER-PEER message — each peer's unacked delta plus its ack — and
        sends a standalone heartbeat beat even when there is nothing to
        ship."""
        if self.membership is not None:
            self.membership.tick()
        if not self.peers:
            return
        self._beat += 1
        cycle_full = self._beat % self.full_every == 0
        hb = self.hb_fn() if self.hb_fn is not None else None
        plans: Dict[str, Tuple[bool, List[WireSpan], int, int, int]] = {}
        with self.lock:
            full_spans: Optional[List[WireSpan]] = None  # exported once per beat
            for name in self.peers:
                full = cycle_full or self.store.needs_full(name)
                if full:
                    if full_spans is None:
                        full_spans = self.store.export_spans()
                    spans = full_spans
                    jseq = self.store.jseq()
                    retrans = 0
                else:
                    pending = self.store.pending_for(name)
                    wire, wire_beat = self._sent.get(name, (0, -(10**9)))
                    if self._beat - wire_beat < self.ack_grace_beats:
                        # Inside the ack round-trip window: ship only
                        # entries the current conn has not carried yet
                        # (its in-flight tail is ordered and reliable —
                        # it will arrive unless the conn dies, and a
                        # dead conn pops the window below).
                        pending = [
                            (seq, span) for seq, span in pending
                            if seq > wire
                        ]
                    ever = self._ever_sent.get(name, 0)
                    retrans = sum(1 for seq, _ in pending if seq <= ever)
                    spans = [span for _, span in pending]
                    jseq = max(
                        (seq for seq, _ in pending),
                        default=self.store.acked_seq(name),
                    )
                plans[name] = (
                    full, spans, jseq, self.store.seen_seq(name), retrans
                )
        for name in sorted(plans):
            full, spans, jseq, ack, retrans = plans[name]
            self._seq += 1
            frames = encode_gossip(
                self.cell, self._seq, spans, full,
                jseq=jseq, ack=ack, hb=hb,
            )
            for f in frames:
                if len(f) > self.max_frame_bytes:
                    self.max_frame_bytes = len(f)
            if self._send(name, frames):
                METRICS.inc("federation.gossip_beats")
                METRICS.inc("federation.gossip_frames", len(frames))
                if full:
                    METRICS.inc("federation.gossip_full_syncs")
                elif retrans:
                    # Entries that went on a wire before and stayed
                    # unacked past the grace window (or whose conn died):
                    # a loss swallowed them, and the ack gap just
                    # recovered them without any anti-entropy pass.
                    METRICS.inc("gossip.retransmits", retrans)
                if spans or full:
                    prev = self._sent.get(name, (0, 0))[0]
                    self._sent[name] = (max(prev, jseq), self._beat)
                    self._ever_sent[name] = max(
                        self._ever_sent.get(name, 0), jseq
                    )
            else:
                METRICS.inc("federation.gossip_errors")
                # The conn (and any in-flight tail) is gone: drop the
                # current-conn window so the next beat resends everything
                # unacked on the fresh conn — the cumulative high-water
                # ack is only sound over contiguous in-order delivery.
                self._sent.pop(name, None)

    def send_to(self, name: str, frames: List[bytes]) -> bool:
        """Ship pre-encoded frames to one peer over the gossip conn (the
        drain handoff path; call only with the daemon stopped or from
        the gossip thread — conn state is single-threaded)."""
        return self._send(name, frames)

    def _send(self, name: str, frames: List[bytes]) -> bool:
        client = self._clients.get(name)
        if client is None:
            host, port = self.peers[name]
            try:
                client = lsp.Client(
                    host, port, self.params, label=f"gossip-{self.cell}",
                    loop=self.loop,
                )
            except (lsp.LspError, OSError):
                return False
            self._clients[name] = client
        try:
            for f in frames:
                client.write(f)
            return True
        except lsp.LspError:
            try:
                client.close()
            except lsp.LspError:
                pass
            self._clients.pop(name, None)
            return False
