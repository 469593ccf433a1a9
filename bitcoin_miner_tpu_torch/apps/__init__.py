"""Application binaries: mining server, miner and client.

Run as modules::

    python -m bitcoin_miner_tpu_torch.apps.server <port>
    python -m bitcoin_miner_tpu_torch.apps.miner  <host:port> [--backend ...] [--devices N]
    python -m bitcoin_miner_tpu_torch.apps.client <host:port> <message> <maxNonce>
    python -m bitcoin_miner_tpu_torch.apps.srunner -port P [-rdrop N -wdrop N ...]
    python -m bitcoin_miner_tpu_torch.apps.crunner -port P [-rdrop N -wdrop N ...]

CLI + stdout contracts mirror the reference binaries
(``bitcoin/{server,miner,client}``) and the JAX package's.
"""

from .scheduler import Scheduler

__all__ = ["Scheduler"]
