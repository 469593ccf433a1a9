"""lspnet — asyncio-UDP endpoints (L1).

The LSP transport (L2) goes through these endpoints.  The JAX package's
fault-injection and chaos knobs are not part of the port's slice.
"""

from .udp import UDPEndpoint, create_client_endpoint, create_server_endpoint

__all__ = ["UDPEndpoint", "create_client_endpoint", "create_server_endpoint"]
