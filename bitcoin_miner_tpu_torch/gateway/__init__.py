"""Serving gateway (L4.5): the traffic layer between transport and scheduler.

The scheduler answers "how do I split this job across miners"; the gateway
answers "which of the requests hammering the door should become jobs at
all" — request coalescing, a content-addressed result cache plus the
interval-algebra span store (sub-range answers from solved spans), and
admission control (token buckets + fair queueing + load shedding).  See
:mod:`.core` for the full design notes.

This is the port's copy of the reference package's ``gateway/``: the same
names, metric spellings, trace events, file formats and wire bytes, so a
cache or span file one package writes, the other reads.  It is pure policy
over the port's :class:`~bitcoin_miner_tpu_torch.apps.scheduler.Scheduler`;
every chunk it lets through is swept by the port's miners, on the card at
their defaults.
"""

from .admission import FairQueue, TokenBucket
from .cache import ResultCache, SpanStore
from .core import Gateway

__all__ = ["FairQueue", "Gateway", "ResultCache", "SpanStore", "TokenBucket"]
