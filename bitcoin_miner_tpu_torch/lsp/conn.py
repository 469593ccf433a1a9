"""The per-connection LSP state machine (L2 core).

One class implements the eight protocol rules of SURVEY §2.2 for *both*
endpoint roles — mirroring how the reference reuses its ``client`` struct
for server-side connection state (``lsp/server_impl.go:117-140``) — but
with the reference's defects fixed (SURVEY §8): per-connection epoch
timers, a complete close/drain path, ``Size`` validation (truncate long
payloads, drop short ones — the behavior the lsp5 suite demands), and
single-owner mutation (the owning asyncio loop) instead of racy shared
memory.

Rules implemented here:
  2. data sequence numbers start at 1 per direction (client_impl.go:167)
  3. sliding window: <= WindowSize unacked in flight; overflow queued and
     released as the cumulative ack prefix advances (client_impl.go:343-358)
  4. ordered delivery via a reorder buffer (client_impl.go:277-289)
  5. every Data is acked immediately on receipt (client_impl.go:211)
  6. epoch events: miss-counting to declare loss, retransmit of unacked
     data, re-ack of the last WindowSize received (client_impl.go:245-251,
     360-380); any received packet resets the miss counter
  7. close drains: no new writes, finish when pending+unacked are empty
     (client_impl.go:291-305)
The handshake (rule 1) and wire codec (rule 8) live in the owners
(aio.py) and message.py respectively.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Dict

from ..utils import trace
from ..utils.metrics import METRICS
from .message import Message
from .params import Params


class ConnCore:
    """Single-connection sliding-window reliability state.

    The owner (AsyncClient / AsyncServer) must call every method from one
    event loop.  Outbound raw messages go through ``send_fn`` (which hits
    the lspnet endpoint); in-order payloads are handed to ``deliver_fn``.
    """

    def __init__(
        self,
        conn_id: int,
        params: Params,
        send_fn: Callable[[Message], None],
        deliver_fn: Callable[[bytes], None],
    ) -> None:
        self.conn_id = conn_id
        self.params = params
        self._send = send_fn
        self._deliver = deliver_fn

        # -- send side --
        self._next_seq = 0  # last assigned outbound seq
        self._pending: Deque[Message] = deque()  # waiting for window room
        self._unacked: Dict[int, Message] = {}  # in flight
        self._acked: set = set()  # acked but above the contiguous prefix
        self._ack_base = 0  # highest contiguously-acked outbound seq
        # RTT telemetry: first-send stamp per in-flight seq,
        # Karn-filtered — a seq that was ever retransmitted yields no
        # sample (its ack is ambiguous between transmissions).  Bounded by
        # the window like _unacked; entries leave on ack.
        self._sent_at: Dict[int, float] = {}
        self._retx: set = set()  # seqs retransmitted at least once

        # -- receive side --
        self._expected = 1  # next in-order inbound seq to deliver
        self._reorder: Dict[int, bytes] = {}
        self._recent_recv: Deque[int] = deque()  # last W distinct data seqs
        self.received_any_data = False

        # -- liveness / lifecycle --
        self.epochs_silent = 0  # epochs since we last heard anything
        self.closing = False  # drain requested
        self.lost = False
        self.finished = False  # drained (or lost) and done

    # ------------------------------------------------------------------ send

    def write(self, payload: bytes) -> None:
        """Queue an outbound Data message (non-blocking, rule 3)."""
        self._next_seq += 1
        msg = Message.data(self.conn_id, self._next_seq, len(payload), payload)
        self._pending.append(msg)
        self._pump()

    def _pump(self) -> None:
        """Release queued sends that now fit in the window
        (client_impl.go:343-358; gate at :349)."""
        w = self.params.window_size
        while self._pending and self._pending[0].seq_num <= self._ack_base + w:
            msg = self._pending.popleft()
            self._unacked[msg.seq_num] = msg
            self._sent_at[msg.seq_num] = time.monotonic()
            self._send(msg)

    def on_ack(self, seq: int) -> None:
        """Process an inbound Ack (client_impl.go:323-341)."""
        if seq == 0:
            return  # handshake/keepalive ack: liveness only
        t0 = self._sent_at.pop(seq, None)
        if t0 is not None and seq not in self._retx:
            # Clean (never-retransmitted) sample only — Karn's rule.
            METRICS.observe("hist.lsp_rtt_s", time.monotonic() - t0)
        self._retx.discard(seq)
        self._unacked.pop(seq, None)
        if seq > self._ack_base:
            self._acked.add(seq)
            while (self._ack_base + 1) in self._acked:
                self._ack_base += 1
                self._acked.remove(self._ack_base)
        self._pump()

    # --------------------------------------------------------------- receive

    def on_data(self, msg: Message) -> None:
        """Process an inbound Data message: Size validation, immediate ack,
        in-order delivery with reorder buffering (rules 4, 5 and the lsp5
        Size contract the reference never implemented, SURVEY §8.5)."""
        payload = msg.payload or b""
        if msg.size < 0:
            METRICS.inc("lsp.dropped_bad_size")
            return  # nonsense Size (never produced by a real sender): drop
        if len(payload) < msg.size:
            METRICS.inc("lsp.dropped_bad_size")
            return  # truncated in flight: drop silently, no ack
        if len(payload) > msg.size:
            payload = payload[: msg.size]
        seq = msg.seq_num
        if seq > self._expected + 2 * self.params.window_size:
            # Reorder horizon: a compliant sender can't exceed
            # expected + WindowSize - 1 (its window gate is ack_base + W and
            # a contiguously-acked prefix was necessarily received here, so
            # ack_base < expected).  Anything far beyond is a hostile or
            # broken peer trying to balloon the reorder buffer — drop it
            # unacked (the ref shares this DoS hole, client_impl.go:277-289;
            # 2x is slack, not protocol headroom).
            METRICS.inc("lsp.dropped_horizon")
            return
        self._send(Message.ack(self.conn_id, msg.seq_num))
        if seq < self._expected:
            return  # duplicate of already-delivered data
        self.received_any_data = True
        if seq in self._recent_recv:
            pass
        else:
            self._recent_recv.append(seq)
            while len(self._recent_recv) > self.params.window_size:
                self._recent_recv.popleft()
        if seq == self._expected:
            self._deliver(payload)
            self._expected += 1
            METRICS.inc("lsp.delivered")
            while self._expected in self._reorder:
                self._deliver(self._reorder.pop(self._expected))
                self._expected += 1
                METRICS.inc("lsp.delivered")
        else:
            self._reorder[seq] = payload

    # ----------------------------------------------------------------- epoch

    def on_epoch(self) -> bool:
        """One epoch tick (rule 6).  Returns True if the connection was
        declared lost this tick (EpochLimit silent epochs)."""
        self.epochs_silent += 1
        if self.epochs_silent > self.params.epoch_limit:
            self.lost = True
            return True
        # Retransmit all unacked in-window data (client_impl.go:360-368).
        for seq in sorted(self._unacked):
            METRICS.inc("lsp.retransmits")
            self._retx.add(seq)  # Karn: this seq's ack is now ambiguous
            if trace.enabled():
                trace.emit(
                    None, "lsp", "retransmit",
                    conn=self.conn_id, seq=seq,
                    epochs_silent=self.epochs_silent,
                )
            self._send(self._unacked[seq])
        # Re-ack: seq 0 keepalive if no data yet, else last W received
        # (client_impl.go:370-380).
        if not self.received_any_data:
            self._send(Message.ack(self.conn_id, 0))
        else:
            for seq in self._recent_recv:
                self._send(Message.ack(self.conn_id, seq))
        return False

    def heard_from_peer(self) -> None:
        """Any packet from the peer resets the epoch miss counter
        (client_impl.go:208, server_impl.go:110)."""
        self.epochs_silent = 0

    # ----------------------------------------------------------------- close

    def begin_close(self) -> None:
        """Request a graceful drain (rule 7).  No further writes."""
        self.closing = True

    @property
    def drained(self) -> bool:
        return not self._pending and not self._unacked

    @property
    def read_buffer_empty(self) -> bool:
        return not self._reorder

    def outstanding(self) -> int:
        return len(self._pending) + len(self._unacked)
