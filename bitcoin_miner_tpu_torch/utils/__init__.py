"""Shared utilities: metrics counters, rate meters, tracing, the race
sanitizer, interval algebra, WFQ, atomic persistence, the device probe, and
the fleet metrics plane (``telemetry``, ``fleetview``, ``slo``; imported
from their modules, as in the reference package).

``utils.platform`` is deliberately NOT re-exported here: it imports torch,
and the pure-protocol processes (the server, the client) that pull
``METRICS`` from this package must not pay for a torch import.  Import it
directly: ``from bitcoin_miner_tpu_torch.utils.platform import default_device``.
"""

from .metrics import METRICS, Metrics, RateMeter

__all__ = ["METRICS", "Metrics", "RateMeter"]
