"""One federation cell: public serving port + federation port + router.

A :class:`Replica` owns a whole scheduler cell — gateway (coalescing,
exact cache, interval store, admission), scheduler, miners' serving port
— plus the federation machinery that makes N such cells one service:

- The **public port** speaks the frozen client/miner protocol through
  the existing :func:`~bitcoin_miner_tpu_torch.apps.server.serve` loop; the
  engine it drives is this replica's :class:`_Router`.
- The **router** consistent-hashes each Request's ``data`` on the ring.
  Home requests flow into the local gateway unchanged.  Non-home
  requests are handed to a forwarder pool that relays them to the home
  replica's *federation port* and fans the Result back; a dead home
  fails over to the next replica on the ring, and when every peer is
  unreachable the request is served locally (correct everywhere beats
  routed nowhere).
- The **federation port** receives peer traffic: forwarded Requests
  (always served LOCALLY — a request arriving here never re-forwards,
  which is what makes routing loop-free even when ring views disagree
  mid-failover) and ``T1``-framed span gossip.  Its conns are mapped
  into the engine under ``FED_BASE + conn_id`` so one gateway serves
  both ports without id collisions.

Locking: ONE event lock serializes the gateway/scheduler across the
serve loop, the federation ingest thread, the forwarder pool and the
gossip daemon — the same discipline (and the same
``BMT_SANITIZE=1``-trackable lock) as a standalone server.

This is the port's copy of the reference package's ``federation/replica.py``:
the same router, ``FED_BASE`` id space, ``FK1|`` preamble, drain handoff and
SHEDDING hold, so a port cell and a reference cell forward to, gossip with
and hand off to each other.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import lsp
from ..apps import server as server_mod
from ..apps.client import request_once
from ..apps.scheduler import Action, Scheduler
from ..bitcoin.message import Message, MsgType
from ..gateway import Gateway, ResultCache
from ..utils import sanitize
from ..utils import trace as _trace
from ..utils.metrics import METRICS
from ..utils.telemetry import FrameAssembler
from .gossip import (
    GossipSpanStore,
    SpanGossip,
    apply_gossip,
    decode_fed,
    encode_handoff,
)
from .membership import (
    LOAD_DRAINING,
    LOAD_OK,
    LOAD_SHEDDING,
    Membership,
)
from .ring import Ring

#: Federation-port conns are offset into this id space before they meet
#: the engine: public LSP conn ids and federation LSP conn ids are two
#: independent counters, and the scheduler/gateway key everything on the
#: conn id.  Gateway virtual ids are negative, real conns small positive
#: ints — 2**40 is unreachable by either.
FED_BASE = 1 << 40

#: One forward task: (public conn, data, lower, upper, originating
#: admission identity — propagated to the home cell so one noisy tenant
#: behind a peer cannot starve that peer's other tenants — request time).
_Forward = Tuple[int, str, int, int, Optional[str], float]

#: Identity preamble on the federation conn: ``FK1|<client key>`` sent
#: immediately before each forwarded Request.  LSP delivers in order, so
#: the home cell reads the origin key, then the Request it applies to.
#: Not a frozen-protocol change: the federation port is the replicated
#: tier's internal channel (like ``T1|`` gossip frames), the public
#: client/miner wire is untouched.
_FK_PREFIX = b"FK1|"
#: Origin keys are labels, not payload storage — bound them well under
#: the frozen 1000-byte datagram ceiling.
_FK_MAX_KEY = 200


class _Router:
    """The engine ``serve`` drives: the local gateway, plus routing.
    Speaks the scheduler's exact event interface; every method is called
    under the replica's event lock (by serve, the federation ingest, or
    a forwarder's fallback path)."""

    def __init__(self, replica: "Replica") -> None:
        self._r = replica
        self.gw = replica.gateway

    # ------------------------------------------------------------------ events

    def miner_joined(self, conn_id: int, now: float = 0.0) -> List[Action]:
        if self._r._draining:
            # No new workers for a cell that is shipping its work away.
            self._r._refused.append(conn_id)
            return []
        if conn_id in self._r._fwd_conns:
            # Request-then-Join role confusion on a conn whose Request is
            # being forwarded: the gateway's own guard cannot see it (no
            # gateway state exists for a forwarded conn), so refuse here
            # — same contract as Gateway.miner_joined's guard.
            return []
        return self._split(self.gw.miner_joined(conn_id, now))

    def client_request(
        self,
        conn_id: int,
        data: str,
        lower: int,
        upper: int,
        now: float = 0.0,
        client_key: Optional[str] = None,
    ) -> List[Action]:
        r = self._r
        if r._draining:
            # DRAINING stops admitting: close the conn so the
            # client's retry lands on a peer — the broadcast DRAINING
            # heartbeat already steered new forwards away.
            r._refused.append(conn_id)
            METRICS.inc("federation.drain_refused")
            return []
        if conn_id in r._fwd_conns:
            return []  # one job per conn, forwarded or not
        if r.peers and lower <= upper and 0 <= lower and upper < 1 << 64:
            home = r.ring.home(data)
            if home != r.cell:
                # Answer from LOCAL state first: forwarded Results are
                # exact-cached here and gossip fills the span store, so a
                # repeat (or a sub-range gossip already covers) costs no
                # peer round trip — the home cell never hears about it.
                ans = self.gw.answer_local(conn_id, data, lower, upper)
                if ans is not None:
                    METRICS.inc("federation.local_answers")
                    return [ans]
                # Not ours: relay to the home replica off the event loop
                # (the forwarder blocks on the peer's Result).  Empty and
                # poison ranges stay local — trivially answerable, and the
                # gateway's guards must see poison before any state forms.
                # The relay queue is BOUNDED: when the forwarder pool is
                # drowning, serving locally through normal admission
                # (queue/shed) beats buffering requests without limit.
                try:
                    r._fwd_q.put_nowait(
                        (conn_id, data, lower, upper, client_key, now)
                    )
                except queue.Full:
                    METRICS.inc("federation.local_fallbacks")
                else:
                    r._fwd_conns.add(conn_id)
                    METRICS.inc("federation.forwarded")
                    _trace.emit(
                        None, "fed", "forward",
                        cell=r.cell, home=home, data=data[:64],
                        lower=lower, upper=upper,
                    )
                    return []
        return self._split(
            self.gw.client_request(
                conn_id, data, lower, upper, now, client_key=client_key
            )
        )

    def result(
        self, conn_id: int, hash_: int, nonce: int, now: float = 0.0
    ) -> List[Action]:
        return self._split(self.gw.result(conn_id, hash_, nonce, now))

    def lost(self, conn_id: int, now: float = 0.0) -> List[Action]:
        # A dead forwarded conn has no gateway state to clean; the
        # forwarder's eventual Result write just fails harmlessly.
        self._r._fwd_conns.discard(conn_id)
        return self._split(self.gw.lost(conn_id, now))

    def tick(self, now: float) -> List[Action]:
        return self._split(self.gw.tick(now))

    # ------------------------------------------------------------ pass-through

    @property
    def revision(self) -> int:
        return self.gw.revision

    @property
    def cache(self) -> ResultCache:
        return self.gw.cache

    @property
    def spans(self) -> GossipSpanStore:
        return self._r.spans

    def checkpoint(self) -> dict:
        return self.gw.checkpoint()

    def load_checkpoint(self, state: dict) -> None:
        self.gw.load_checkpoint(state)

    def vt_floor(self) -> float:
        return self.gw.vt_floor()

    def queue_vt_floor(self) -> float:
        return self.gw.queue_vt_floor()

    def stats(self) -> Dict[str, int]:
        st = self.gw.stats()
        st.update(
            fed_peers=len(self._r.peers),
            fed_queue=self._r._fwd_q.qsize(),
            # Live peer conns at the federation transport:
            # the ``fed.conns_live`` gauge source, published by the
            # serve ticker — the shared-loop refactor made conns cost
            # state instead of threads, so the health surface must count
            # conns, not threads.
            fed_conns=self._r.fed.conns_live(),
        )
        return st

    def drain_evictions(self) -> List[int]:
        """Public evictions are returned for the serve shell to close;
        federation-port evictions (a shed forwarded request) are closed
        here on the federation server.  Drain-refused public conns ride
        along — DRAINING means every new arrival is turned away."""
        out: List[int] = list(self._r._refused)
        self._r._refused = []
        for cid in self.gw.drain_evictions():
            if cid >= FED_BASE:
                self._r._close_fed(cid - FED_BASE)
            else:
                out.append(cid)
        return out

    # ------------------------------------------------------------------ helpers

    def _split(self, actions: List[Action]) -> List[Action]:
        """Deliver federation-port actions (Results for forwarded
        requests) on the federation server; return the rest (miner chunk
        Requests, local client Results) for the caller's transport."""
        out: List[Action] = []
        for cid, msg in actions:
            if cid >= FED_BASE:
                self._r._write_fed(cid - FED_BASE, msg)
            else:
                out.append((cid, msg))
        return out


class Replica:
    """One federation cell (see module docstring).  ``peers`` maps the
    OTHER replicas' names to their federation ``(host, port)``; every
    replica must be configured with the same name set or ring views
    diverge (routing stays correct — the federation port serves locally
    — but duplicates stop collapsing)."""

    def __init__(
        self,
        cell: str,
        peers: Optional[Dict[str, Tuple[str, int]]] = None,
        *,
        port: int = 0,
        fed_port: int = 0,
        host: str = "127.0.0.1",
        async_public: bool = False,
        params: Optional["lsp.Params"] = None,
        scheduler: Optional[Scheduler] = None,
        cache: Optional[ResultCache] = None,
        spans: Optional[GossipSpanStore] = None,
        rate: Optional[float] = None,
        max_queued: int = 256,
        gossip_interval: float = 1.0,
        gossip_full_every: int = 4,
        forward_workers: int = 4,
        forward_timeout: float = 15.0,
        peer_down_ttl: float = 2.0,
        suspect_misses: float = 3.0,
        confirm_misses: float = 3.0,
        shed_hold_beats: int = 3,
        incarnation: Optional[int] = None,
        workload=None,
        tick_interval: float = 0.25,
        checkpoint_path: Optional[str] = None,
        telemetry=None,
        clock=time.monotonic,
        log: Optional[logging.Logger] = None,
    ) -> None:
        self.cell = cell
        self.peers: Dict[str, Tuple[str, int]] = dict(peers or {})
        if cell in self.peers:
            raise ValueError(f"peers must not include the cell itself ({cell!r})")
        self.ring = Ring([cell, *self.peers])
        self.params = params
        self._clock = clock
        self._log = log or logging.getLogger("bitcoin_miner_tpu_torch.federation")
        # Chaos identities: the public port is the cell name (partition a
        # whole cell), the federation port fed-<cell> (cut peer traffic),
        # gossip clients gossip-<cell>, forward clients fwd-<cell>.
        #
        # ``async_public`` serves the public port on the
        # asyncio event-loop front end (apps.server.AsyncIngress) instead
        # of the blocking facade + serve thread: binding then happens in
        # :meth:`start` on the ingress loop, and thread count stays O(1)
        # in live public conns.
        self._async_public = bool(async_public)
        self._host = host
        self._public_port_arg = port
        self.public = (
            None if self._async_public
            else lsp.Server(port, params, host=host, label=cell)
        )
        # ONE shared loop thread carries the federation port, every
        # forwarder worker's peer conns AND the gossip daemon's peer
        # conns: a loop thread per gossip conn plus one for the fed
        # server would multiply thread counts instead of capacity as
        # cells were added — so a cell's thread count is O(1) in peers.
        self._fwd_loop = lsp.shared_loop(f"fwd-loop-{cell}")
        self.fed = lsp.Server(
            fed_port, params, host=host, label=f"fed-{cell}",
            loop=self._fwd_loop,
        )
        # The cell's range-fold workload stamps every state
        # file below; every cell of one federation must agree.
        wname = getattr(workload, "name", None)
        self.spans = (
            spans if spans is not None else GossipSpanStore(workload=wname)
        )
        self.gateway = Gateway(
            scheduler if scheduler is not None else Scheduler(workload=workload),
            cache=cache if cache is not None else ResultCache(workload=wname),
            spans=self.spans,
            rate=rate,
            max_queued=max_queued,
        )
        self.lock = sanitize.make_lock(f"fed.{cell}.event")
        self.router = _Router(self)
        # Membership plane: the suspicion-based failure
        # detector every gossip heartbeat feeds; the gossip daemon ticks
        # it once per interval.  Incarnations disambiguate restarts —
        # wall-clock seconds are monotone enough across process lives.
        self.membership = Membership(
            cell, list(self.peers), interval=gossip_interval,
            suspect_misses=suspect_misses, confirm_misses=confirm_misses,
        )
        self.incarnation = (
            incarnation if incarnation is not None else int(time.time())
        )
        self._draining = False  # guarded-by: lock
        self._refused: List[int] = []  # guarded-by: lock
        self._last_shed = 0  # heartbeat-to-heartbeat shed delta base  # guarded-by: lock
        # Flap damping: once
        # SHEDDING, the state holds for ``shed_hold_beats`` consecutive
        # evidence-free beats before reverting to OK — a storm whose
        # sheds land between alternate beats no longer oscillates the
        # peer-side ``fed.peer_state`` gauge OK↔SHEDDING every round.
        self._shed_hold_beats = max(0, int(shed_hold_beats))
        self._shedding = False  # guarded-by: lock
        self._shed_quiet = 0  # evidence-free beats while held  # guarded-by: lock
        self.gossip = SpanGossip(
            cell, self.spans, self.peers, self.lock,
            interval=gossip_interval, full_every=gossip_full_every,
            params=params, membership=self.membership,
            hb_fn=self._heartbeat, loop=self._fwd_loop,
        )
        self._tick_interval = tick_interval
        self._checkpoint_path = checkpoint_path
        self._telemetry = telemetry
        self._forward_workers = max(1, int(forward_workers))
        # Per-forward deadline: a wedged peer conn — transport alive,
        # scheduler starved — would block its worker in request_once
        # forever, head-of-line-blocking ALL forwarding on this replica;
        # instead the forward times out, counts
        # federation.forward_timeouts, and fails over / falls back local.
        self._forward_timeout = forward_timeout
        self._peer_down_ttl = peer_down_ttl
        # Bounded relay backlog (overflow serves locally through normal
        # admission); conns with a forward in flight, so the router can
        # enforce one-job-per-conn and refuse role confusion for conns
        # the gateway has no state for.
        self._fwd_q: "queue.Queue[Optional[_Forward]]" = queue.Queue(
            maxsize=4 * max_queued if max_queued > 0 else 1024
        )
        self._fwd_conns: set = set()  # guarded-by: lock
        self._down_lock = threading.Lock()
        self._down: Dict[str, float] = {}  # guarded-by: _down_lock
        self._threads: List[threading.Thread] = []
        self._started = False

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "Replica":
        """Spawn the serve loop, federation ingest, gossip daemon and
        forwarder pool as daemon threads; returns self."""
        self._started = True
        if self._async_public:
            self.public = server_mod.AsyncIngress(
                self._public_port_arg,
                scheduler=self.router,
                params=self.params,
                host=self._host,
                label=self.cell,
                lock=self.lock,
                tick_interval=self._tick_interval,
                checkpoint_path=self._checkpoint_path,
                telemetry=self._telemetry,
                log=self._log,
                clock=self._clock,
            ).start()
        else:
            t = threading.Thread(
                target=server_mod.serve,
                args=(self.public, self.router),
                kwargs=dict(
                    lock=self.lock,
                    tick_interval=self._tick_interval,
                    checkpoint_path=self._checkpoint_path,
                    telemetry=self._telemetry,
                    log=self._log,
                    clock=self._clock,
                ),
                name=f"fed-serve-{self.cell}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        ti = threading.Thread(
            target=self._fed_ingest, name=f"fed-ingest-{self.cell}", daemon=True
        )
        ti.start()
        self._threads.append(ti)
        for i in range(self._forward_workers):
            tw = threading.Thread(
                target=self._forward_loop,
                name=f"fed-fwd-{self.cell}-{i}",
                daemon=True,
            )
            tw.start()
            self._threads.append(tw)
        if self.peers:
            self.gossip.start()
        return self

    def close(self) -> None:
        """Tear the cell down: closing the servers unblocks the serve
        and ingest loops; sentinels drain the forwarder pool.  The queue
        is bounded, so sentinel delivery must never block: shutdown beats
        backlog — drop queued forwards to make room (their conns die with
        the public server below)."""
        for _ in range(self._forward_workers):
            while True:
                try:
                    self._fwd_q.put_nowait(None)
                    break
                except queue.Full:
                    try:
                        self._fwd_q.get_nowait()
                    except queue.Empty:
                        continue
        self.gossip.stop()
        try:
            if self.public is not None:
                self.public.close()
        except lsp.LspError:
            pass
        try:
            self.fed.close()
        except lsp.LspError:
            pass
        for t in self._threads:
            t.join(timeout=3.0)
        self._threads = []
        if self._fwd_loop is not None:
            # After the forwarder workers have drained and closed their
            # conns: the shared loop's owner stops it last.
            self._fwd_loop.stop()
            self._fwd_loop = None

    @property
    def port(self) -> int:
        return self.public.port

    @property
    def fed_port(self) -> int:
        return self.fed.port

    # ------------------------------------------------------------ membership

    def load_state(self) -> str:
        """The load state this cell's heartbeat advertises: DRAINING once
        :meth:`drain` started; SHEDDING while admission backpressure is
        biting (sheds since the last heartbeat, or a deep backlog); OK
        otherwise.  SHEDDING tells peers "alive, deprioritize" — the
        whole point of the membership plane is that backpressure stops
        reading as death.

        Flap damping: the point-in-time shed delta flips on alternate beats
        under a bursty storm (sheds land between one beat pair, not the
        next), which would oscillate every peer's ``fed.peer_state`` gauge
        OK↔SHEDDING each gossip round.  SHEDDING therefore enters on evidence immediately but exits only after
        ``shed_hold_beats`` consecutive evidence-free beats; each held
        beat counts ``fed.shed_holds``."""
        held = False
        with self.lock:
            if self._draining:
                return LOAD_DRAINING
            shed = self.gateway.shed_count
            backlog = len(self.gateway._queue)
            evidence = (
                shed > self._last_shed
                or backlog >= max(1, self.gateway.max_queued) // 2
            )
            self._last_shed = shed
            if evidence:
                self._shedding = True
                self._shed_quiet = 0
            elif self._shedding:
                self._shed_quiet += 1
                if self._shed_quiet > self._shed_hold_beats:
                    self._shedding = False  # hysteresis satisfied: back to OK
                else:
                    held = True
            shedding = self._shedding
        if held:
            METRICS.inc("fed.shed_holds")
        return LOAD_SHEDDING if shedding else LOAD_OK

    def _heartbeat(self) -> dict:
        """The per-beat piggyback (gossip ``hb`` field)."""
        return {"inc": self.incarnation, "load": self.load_state()}

    def drain(self, reason: str = "drain") -> None:
        """Graceful drain: stop admitting, broadcast DRAINING,
        flush pending span deltas, and ship the scheduler's orphan stash
        + in-flight job identities to the ring successor — so a client
        resubmitting a mid-batch job at a survivor RESUMES from stashed
        progress instead of restarting.  The caller still owns
        :meth:`close` (the SIGTERM handler calls both)."""
        with self.lock:
            if self._draining:
                return
            self._draining = True
        self._log.info("drain (%s): admitting stopped", reason)
        _trace.emit(None, "fed", "drain", cell=self.cell, reason=reason)
        # The gossip daemon owns the peer conns; stop it so this thread
        # can use them (conn state is strictly single-threaded), then
        # push one final beat: the DRAINING heartbeat plus any unacked
        # span deltas — the flush peers would otherwise wait a beat for.
        self.gossip.stop()
        if self.peers:
            try:
                self.gossip.beat()
            except Exception:
                METRICS.inc("federation.gossip_errors")
            succ = self.ring.successor(
                self.cell, alive=self.membership.routable()
            )
            if succ is not None:
                with self.lock:
                    state = self.gateway.sched.export_orphans()
                payload = state.get("state") if state.get("version") == 2 else state
                jobs = len((payload or {}).get("jobs") or [])
                frames = encode_handoff(self.cell, self.incarnation, state)
                if self.gossip.send_to(succ, frames):
                    METRICS.inc("federation.handoffs_sent")
                    self._log.info(
                        "drain: handed %d resumable identities to %s",
                        jobs, succ,
                    )
                    _trace.emit(
                        None, "fed", "handoff",
                        cell=self.cell, successor=succ, jobs=jobs,
                    )
                else:
                    METRICS.inc("federation.gossip_errors")
                    self._log.info("drain: handoff to %s failed", succ)

    # ------------------------------------------------------------- transport

    def _emit_public(self, actions: List[Action]) -> None:
        for cid, msg in actions:
            try:
                self.public.write(cid, msg.marshal())
            except lsp.LspError:
                self._log.info("public write to %d failed (conn dead)", cid)

    def _write_fed(self, conn_id: int, msg: Message) -> None:
        try:
            self.fed.write(conn_id, msg.marshal())
        except lsp.LspError:
            self._log.info("fed write to %d failed (conn dead)", conn_id)

    def _close_fed(self, conn_id: int) -> None:
        try:
            self.fed.close_conn(conn_id)
        except lsp.LspError:
            pass

    # ------------------------------------------------------- federation port

    def _fed_ingest(self) -> None:
        """Read loop for the federation port: peer-forwarded Requests
        (served locally under the shared event lock) and framed span
        gossip.  Frame reassembly is per-conn and this-thread-only."""
        assemblers: Dict[int, FrameAssembler] = {}
        # Originating admission identities, per conn:
        # a forwarder sends ``FK1|<key>`` right before each Request, so
        # the home cell charges the ORIGINATING client's bucket/tenant
        # instead of pooling a whole peer under one "fed:peer" key.
        fed_keys: Dict[int, str] = {}
        while True:
            try:
                conn_id, payload = self.fed.read()
            except lsp.ConnLostError as e:
                assemblers.pop(e.conn_id, None)
                fed_keys.pop(e.conn_id, None)
                with self.lock:
                    actions = self.router._split(
                        self.gateway.lost(FED_BASE + e.conn_id, self._clock())
                    )
                self._emit_public(actions)
                continue
            except lsp.LspError:
                return  # replica closed
            if payload.startswith(_FK_PREFIX):
                fed_keys[conn_id] = payload[len(_FK_PREFIX):].decode(
                    "utf-8", "replace"
                )[:_FK_MAX_KEY]
                continue
            if payload.startswith(b"T1|"):
                asm = assemblers.get(conn_id)
                if asm is None:
                    asm = assemblers[conn_id] = FrameAssembler()
                done, obj = asm.feed(payload)
                if not done:
                    continue
                msg = decode_fed(obj)
                if msg is None:
                    METRICS.inc("federation.gossip_errors")
                    continue
                sender = msg["from"]
                if msg["kind"] == "handoff":
                    # A draining peer shipped its orphan stash + in-flight
                    # identities: merge into the local resume
                    # stash so resubmitted jobs RESUME here.
                    with self.lock:
                        accepted = self.gateway.sched.import_orphans(
                            msg["state"]
                        )
                    self._log.info(
                        "handoff from %s: %d resumable identities",
                        sender, accepted,
                    )
                    _trace.emit(
                        None, "fed", "handoff_rx",
                        cell=self.cell, peer=sender, jobs=accepted,
                    )
                    continue
                METRICS.inc("federation.gossip_rx")
                # Heartbeat first (outside the event lock — membership has
                # its own): liveness + load state feed the failure
                # detector; a restarted incarnation voids the peer's seq
                # bookkeeping (its journal numbering started over).
                hb = msg.get("hb")
                restarted = False
                if isinstance(hb, dict):
                    inc = hb.get("inc", 0)
                    if not isinstance(inc, int) or isinstance(inc, bool):
                        inc = 0  # garbage incarnation: still a heartbeat
                    restarted = self.membership.heard(
                        sender, str(hb.get("load", LOAD_OK)), inc,
                    )
                with self.lock:
                    if restarted:
                        self.spans.reset_peer(sender)
                    merged = apply_gossip(self.spans, msg)
                    # Ack bookkeeping: the message covers the
                    # sender's journal through jseq (ours to ack back);
                    # its ack field covers OUR journal (prune retention).
                    jseq = msg.get("jseq")
                    if isinstance(jseq, int) and not isinstance(jseq, bool):
                        self.spans.record_seen(sender, jseq)
                    ack = msg.get("ack")
                    if isinstance(ack, int) and not isinstance(ack, bool):
                        self.spans.record_ack(sender, ack)
                if merged:
                    METRICS.inc("federation.gossip_spans_merged", merged)
                continue
            m = Message.unmarshal(payload)
            if m is None or m.type != MsgType.REQUEST:
                continue  # peers only forward Requests here
            with self.lock:
                draining = self._draining
            if draining:
                # Stopped admitting: refuse the forwarded request so the
                # peer fails over (its membership view is about to agree).
                fed_keys.pop(conn_id, None)
                self._close_fed(conn_id)
                continue
            now = self._clock()
            # End-to-end admission identity: the preamble's origin key if
            # one preceded this Request (consumed — the next Request on
            # this conn brings its own), else the legacy pooled key.
            origin = fed_keys.pop(conn_id, None)
            fwd_key = f"fed:{origin}" if origin else "fed:peer"
            with self.lock:
                actions = self.router._split(
                    self.gateway.client_request(
                        FED_BASE + conn_id, m.data, m.lower, m.upper, now,
                        client_key=fwd_key,
                    )
                )
                evicted = self.router.drain_evictions()
            self._emit_public(actions)
            for cid in evicted:
                try:
                    self.public.close_conn(cid)
                except lsp.LspError:
                    pass

    # ------------------------------------------------------------ forwarding

    def _peer_is_down(self, name: str) -> bool:
        with self._down_lock:
            t = self._down.get(name)
            return t is not None and self._clock() - t < self._peer_down_ttl

    def _mark_peer(self, name: str, down: bool) -> None:
        with self._down_lock:
            if down:
                self._down[name] = self._clock()
            else:
                self._down.pop(name, None)

    def _forward_loop(self) -> None:
        """One forwarder worker: relay queued non-home requests to the
        home replica's federation port, failing over along the ring; if
        every peer is unreachable, serve locally.  Each worker keeps one
        cached conn per peer (a conn carries ONE outstanding request at
        a time — the scheduler's one-job-per-conn rule)."""
        clients: Dict[str, "lsp.Client"] = {}
        try:
            while True:
                task = self._fwd_q.get()
                if task is None:
                    return
                conn_id, data, lower, upper, ckey, t0 = task
                result = None
                # Membership drives routing: confirmed-DEAD
                # peers leave the alive view, then the load ranking puts
                # SHEDDING peers last-resort and drops DRAINING ones —
                # the per-forward connect timeout is now the LAST liveness
                # signal, not the only one.
                route = self.ring.route(
                    data, alive=self.membership.routable()
                )
                order = self.membership.order(
                    [n for n in route if n != self.cell]
                )
                candidates = [n for n in order if not self._peer_is_down(n)]
                for name in candidates:
                    try:
                        result = self._forward_once(
                            clients, name, data, lower, upper, ckey
                        )
                    except TimeoutError:
                        # Wedged-but-alive peer (forward_timeouts already
                        # counted): skip it for the down-TTL so queued
                        # tasks don't each burn a full deadline on it,
                        # but do NOT count a dead-replica failover.
                        self._mark_peer(name, down=True)
                        continue
                    if result is not None:
                        self._mark_peer(name, down=False)
                        break
                    if self.membership.fresh(name):
                        # The conn died but heartbeats prove the peer
                        # alive: that is backpressure (it shed us) or a
                        # transport hiccup — deprioritize by moving on,
                        # WITHOUT the death marking that would blind
                        # this cell to a healthy home for the down-TTL.
                        METRICS.inc("federation.shed_skips")
                        _trace.emit(
                            None, "fed", "shed_skip",
                            cell=self.cell, peer=name, data=data[:64],
                        )
                        continue
                    self._mark_peer(name, down=True)
                    METRICS.inc("federation.forward_failovers")
                    _trace.emit(
                        None, "fed", "failover",
                        cell=self.cell, dead=name, data=data[:64],
                    )
                if result is not None:
                    METRICS.inc("federation.remote_results")
                    latency = max(0.0, self._clock() - t0)
                    METRICS.observe("hist.request_s", latency)
                    with self.lock:
                        # A peer's Result is the argmin over exactly this
                        # signature: exact-cache it so the next local twin
                        # answers without a round trip.  Deregister the
                        # conn BEFORE the write: a well-behaved client
                        # only sends its next Request after reading this
                        # Result, by which time the conn is free again.
                        self._fwd_conns.discard(conn_id)
                        self.gateway.cache.put(
                            (data, lower, upper), result[0], result[1]
                        )
                    try:
                        self.public.write(
                            conn_id, Message.result(*result).marshal()
                        )
                    except lsp.LspError:
                        self._log.info(
                            "forward result to %d failed (conn dead)", conn_id
                        )
                    continue
                # Every routable peer refused: the survivors' answer is a
                # local sweep (correct everywhere beats routed nowhere).
                METRICS.inc("federation.local_fallbacks")
                _trace.emit(
                    None, "fed", "local_fallback", cell=self.cell,
                    data=data[:64],
                )
                with self.lock:
                    self._fwd_conns.discard(conn_id)  # conn state is the gateway's now
                    actions = self.router._split(
                        self.gateway.client_request(
                            conn_id, data, lower, upper, self._clock(),
                            # Fallback serves the ORIGINATING client:
                            # charge its own admission identity.
                            client_key=ckey or "fed:fallback",
                        )
                    )
                self._emit_public(actions)
        finally:
            for c in clients.values():
                try:
                    c.close()
                except lsp.LspError:
                    pass

    def _forward_once(
        self,
        clients: Dict[str, "lsp.Client"],
        name: str,
        data: str,
        lower: int,
        upper: int,
        ckey: Optional[str] = None,
    ) -> Optional[Tuple[int, int]]:
        client = clients.get(name)
        if client is None:
            host, fport = self.peers[name]
            try:
                # All workers' peer conns ride the ONE shared forwarder
                # loop: a cached conn costs state, not a thread.
                client = lsp.Client(
                    host, fport, self.params, label=f"fwd-{self.cell}",
                    loop=self._fwd_loop,
                )
            except (lsp.LspError, OSError):
                return None
            clients[name] = client

        def _drop_conn() -> None:
            clients.pop(name, None)
            try:
                client.close()
            except lsp.LspError:
                pass

        if ckey:
            # Identity preamble (see _FK_PREFIX): in-order LSP delivery
            # binds it to the Request that follows.
            try:
                client.write(
                    _FK_PREFIX + ckey.encode("utf-8")[:_FK_MAX_KEY]
                )
            except lsp.LspError:
                _drop_conn()
                return None
        try:
            got = request_once(
                client, data, upper, lower=lower,
                timeout=self._forward_timeout,
            )
        except TimeoutError:
            # The peer's transport is alive but its answer never came
            # (wedged cell, starved scheduler): without this deadline the
            # worker blocked here forever and a few such forwards
            # head-of-line-blocked ALL forwarding on this replica.  The
            # conn's read stream is now ambiguous — drop it; the caller
            # fails over along the ring (or serves locally).
            METRICS.inc("federation.forward_timeouts")
            _trace.emit(
                None, "fed", "forward_timeout",
                cell=self.cell, peer=name, data=data[:64],
                budget_s=self._forward_timeout,
            )
            _drop_conn()
            raise
        if got is None:
            # Conn died mid-request (peer killed, or shed us): drop the
            # cached conn so the next task reconnects fresh.
            _drop_conn()
        return got
