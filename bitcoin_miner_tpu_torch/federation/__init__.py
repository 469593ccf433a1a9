"""federation — the replicated serving tier.

One scheduler process owning the whole fleet is both a single point of
failure and a single-process throughput ceiling.  This package is the
layer above everything built so far: N gateway **replicas** in front of
M scheduler cells, where

- :class:`~bitcoin_miner_tpu_torch.federation.ring.Ring` consistent-hashes the
  job signature's ``data`` onto a home replica, so overlapping sub-ranges
  of the same data land on the same cell and the existing coalescing,
  exact-match cache and interval-store planning keep collapsing
  duplicates;
- :class:`~bitcoin_miner_tpu_torch.federation.replica.Replica` is one cell's
  shell: the public serving port (clients + miners), the federation port
  (peer-forwarded requests + span gossip, always served locally — which
  is what makes forwarding loop-free), the router that forwards non-home
  requests and fails over to the next replica on the ring when the home
  is dead;
- :class:`~bitcoin_miner_tpu_torch.federation.gossip.SpanGossip` periodically
  exchanges solved-span deltas and full-state syncs between replicas
  over LSP, framed with the telemetry fragmentation machinery
  (zlib + ``T1|id|i|n|chunk``) so every datagram respects the frozen
  1000-byte wire ceiling — a range solved anywhere answers everywhere,
  bit-exact under the interval store's argmin-inside-query rule;
- :class:`~bitcoin_miner_tpu_torch.federation.membership.Membership`
  is the resilience plane: gossip-piggybacked heartbeats carrying
  ``(incarnation, load_state)``, a suspicion-based failure detector
  (miss-count + confirmation window — a SHEDDING peer is deprioritized,
  never declared dead), per-peer gossip acks with delta retransmit, and
  graceful drain with work handoff to the ring successor.

``python -m bitcoin_miner_tpu_torch.apps.federation`` runs one replica;
:mod:`~bitcoin_miner_tpu_torch.federation.drill` runs the membership
plane's four drills in process.

This is the port's copy of the reference package's ``federation/``: the
same ring homes, heartbeats, ``T1|`` gossip and handoff frames and
``FK1|`` forward preamble, so port cells and reference cells form one
federation.  Nothing here touches a kernel: every chunk a cell lets
through is swept by the miners on its public port (the cuda rung on the
card).
"""

from .gossip import (
    GossipSpanStore,
    SpanGossip,
    decode_fed,
    decode_gossip,
    encode_gossip,
    encode_handoff,
)
from .membership import Membership
from .replica import Replica
from .ring import Ring

__all__ = [
    "GossipSpanStore",
    "Membership",
    "Replica",
    "Ring",
    "SpanGossip",
    "decode_fed",
    "decode_gossip",
    "encode_gossip",
    "encode_handoff",
]
