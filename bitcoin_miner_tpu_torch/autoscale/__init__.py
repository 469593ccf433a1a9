"""Self-scaling capacity plane: the SLO-burn-driven autoscaler closing
the loop from burn-rate alerts (utils/slo) and ``fleet.utilization`` to
fleet actions — worker spawn/clean-drain, federation-cell early handoff,
and WFQ tenant re-weighting.

- :mod:`.controller` — the pure-policy state machine (hold/cooldown/
  retry semantics; externally serialized, deterministic under test).
- :mod:`.actuator` — the world-touching axes + the wall-clock pump.

This is the port's copy of the reference package's ``autoscale/``: the
same policy, counters, gauge and trace events.  Its workers are the
port's miners (``python -m bitcoin_miner_tpu_torch.apps.miner``), and
their backend defaults to ``"auto"``, the port miner's own default: the
cuda rung on the card.  The reference's default is ``"cpu"``.  The
server's ``--autoscale[=SPEC]`` arms it; nothing wires
:class:`CellActuator` until the federation is ported.
"""

from .actuator import (  # noqa: F401
    CellActuator,
    ControllerPump,
    GatewayWeightActuator,
    ProcessActuator,
)
from .controller import (  # noqa: F401
    AutoscaleConfig,
    AutoscaleController,
    parse_autoscale_config,
)
