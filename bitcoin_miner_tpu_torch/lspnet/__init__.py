"""lspnet — instrumented UDP with fault-injection knobs (L1).

The LSP transport (L2) goes through these endpoints exclusively, so tests
can dial packet loss, payload corruption and seeded network weather (the
:class:`NetSim` chaos layer) on a real loopback network (reference
lspnet/net.go:3-8).  The port's copy of the JAX package's ``lspnet``.
"""

from .chaos import (
    CHAOS,
    GEParams,
    LinkConditions,
    NetSim,
    Schedule,
    conditions,
    heal,
    partition,
    standard_scenarios,
)
from .faults import (
    FAULTS,
    enable_debug_logs,
    reset_faults,
    set_client_read_drop_percent,
    set_client_write_drop_percent,
    set_msg_lengthening_percent,
    set_msg_shortening_percent,
    set_read_drop_percent,
    set_server_read_drop_percent,
    set_server_write_drop_percent,
    set_write_drop_percent,
)
from .udp import UDPEndpoint, create_client_endpoint, create_server_endpoint

__all__ = [
    "CHAOS",
    "FAULTS",
    "GEParams",
    "LinkConditions",
    "NetSim",
    "Schedule",
    "conditions",
    "heal",
    "partition",
    "standard_scenarios",
    "UDPEndpoint",
    "create_client_endpoint",
    "create_server_endpoint",
    "enable_debug_logs",
    "reset_faults",
    "set_read_drop_percent",
    "set_write_drop_percent",
    "set_client_read_drop_percent",
    "set_server_read_drop_percent",
    "set_client_write_drop_percent",
    "set_server_write_drop_percent",
    "set_msg_shortening_percent",
    "set_msg_lengthening_percent",
]
