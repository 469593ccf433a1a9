"""The autoscale policy state machine.

The sensors for elasticity all exist — the SLO engine fires burn-rate
alerts, the serve ticker publishes ``fleet.utilization``, membership
knows OK/SHEDDING/DRAINING — but nothing *acted* on them: a burning
fleet paged and kept shedding.  This controller closes the loop: each
tick it reads the burn evidence and the utilization level and reacts
along three actuation axes:

- **workers** (axis a): spawn miner worker processes under sustained
  burn, retire them by CLEAN DRAIN (SIGTERM → finish in-flight chunks →
  exit, apps/miner) once the fleet is quiet — a drained worker's
  swept ranges all land as Results, so resumed jobs sweep strictly fewer
  nonces than after a SIGKILL.
- **tenant weights** (axis c): under overload, re-weight WFQ tenants
  through the gateway's override surface (the one ``utils/wfq.py``
  virtual-clock primitive underneath) so paying traffic starves last;
  restored on recovery.
- **cell** (axis b): a cell that stays cold at its worker floor is
  excess capacity — signal the federation replica to hand off early
  through the membership/handoff drain path.

Policy vocabulary (README "Self-scaling capacity plane"):

- **hold** (hysteresis): evidence must persist ``hold_ticks``
  CONSECUTIVE ticks before any action — a single alert flap or one idle
  sample never moves capacity.
- **cooldown**: after an action, no same-direction action for
  ``up_cooldown_s`` / ``down_cooldown_s`` — and no scale-down within
  ``down_cooldown_s`` of a scale-UP either, so the controller never
  retires the worker it just spawned.  Every tick evidence is present
  but held/cooled counts in ``autoscale.actions_suppressed``.
- **retry**: a failed actuation (spawn exec error, drain on a dead
  proc) is recorded and retried next tick, outside the cooldown gate —
  a cooldown must not convert one transient failure into a minute of
  lost capacity.

This class is PURE POLICY: externally serialized, no locks, no threads,
no sleeps.  Drivers inject the clock and the evidence providers, which is
what makes it deterministic under test; the production driver is
:class:`~bitcoin_miner_tpu_torch.autoscale.actuator.ControllerPump` (the
server's wall-clock thread).

The decision → action → settled timeline lands in the trace stream
(``autoscale.*`` events, ``python -m tools.trace``) and the counters/
gauge land in the registry (``autoscale.scale_ups`` /
``autoscale.scale_downs`` / ``autoscale.actions_suppressed`` /
``autoscale.reweights`` / ``autoscale.actuator_failures`` /
``autoscale.target_workers``).

This is the port's copy of the reference package's controller: on the
same evidence and clock it takes the same actions, reports the same
``status()`` and moves the same counters.  One deliberate difference:
:func:`parse_autoscale_config`'s driver ``backend`` defaults to
``"auto"``, the port miner's own default (the cuda rung on the card),
where the reference's defaults to ``"cpu"``: the port's entry points run
on the card unless the caller asks for the CPU (``backend=cpu``).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from ..utils import trace
from ..utils.metrics import METRICS

#: Controller states (the dash panel vocabulary).
STEADY = "steady"
HOLD_UP = "hold-up"
HOLD_DOWN = "hold-down"
COOLDOWN_UP = "cooldown-up"
COOLDOWN_DOWN = "cooldown-down"
CELL_DRAINED = "cell-drained"


@dataclass(frozen=True)
class AutoscaleConfig:
    """The policy knobs, all in evidence units (ticks) or seconds."""

    min_workers: int = 1
    max_workers: int = 4
    #: Workers added / retired per action (one action per tick at most).
    step: int = 1
    #: Consecutive evidence ticks before the FIRST action fires
    #: (hysteresis — alert flap never thrashes capacity).
    hold_ticks: int = 3
    up_cooldown_s: float = 10.0
    down_cooldown_s: float = 30.0
    #: Scale-down eligibility: utilization below this with no burn alert.
    util_low: float = 0.5
    #: Tenant → WFQ weight overrides applied while burning (axis c);
    #: cleared on recovery.  Empty disables the axis.
    overload_weights: Mapping[str, float] = field(default_factory=dict)
    #: Consecutive cold-at-the-floor ticks before the cell axis signals
    #: an early membership handoff (0 disables the axis).
    cell_drain_ticks: int = 0


#: ``--autoscale=SPEC`` key → AutoscaleConfig field (int-valued).
_INT_KEYS = {
    "min": "min_workers",
    "max": "max_workers",
    "step": "step",
    "hold": "hold_ticks",
    "cell_drain": "cell_drain_ticks",
}
#: Float-valued spec keys.
_FLOAT_KEYS = {
    "up_cooldown": "up_cooldown_s",
    "down_cooldown": "down_cooldown_s",
    "util_low": "util_low",
}


def parse_autoscale_config(spec: str) -> "tuple[AutoscaleConfig, Dict[str, Any]]":
    """Parse an ``--autoscale=SPEC`` string into ``(AutoscaleConfig,
    driver)``, where ``driver`` holds the knobs the wall-clock shells
    (not the policy) consume: ``interval`` (pump beat seconds) and
    ``backend`` (spawned workers' search backend).

    SPEC is comma-separated ``key=value`` pairs — ``min``/``max``/
    ``step``/``hold``/``cell_drain`` (ints), ``up_cooldown``/
    ``down_cooldown``/``util_low``/``interval`` (floats), ``backend``
    (string; default ``"auto"``, see the module docstring), and
    ``weights`` as semicolon-separated ``tenant:weight``
    pairs (e.g. ``weights=gold:4;free:0.25``).  The bare-flag spelling
    (``"1"`` or empty) means all defaults.  Unknown keys raise
    ValueError — a typo must not silently become default policy.
    """
    driver: Dict[str, Any] = {"interval": 1.0, "backend": "auto"}
    kw: Dict[str, Any] = {}
    text = (spec or "").strip()
    if text in ("", "1"):
        return AutoscaleConfig(), driver
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if not sep or not val:
            raise ValueError(
                f"autoscale spec needs key=value pairs, got {part!r}"
            )
        try:
            if key in _INT_KEYS:
                kw[_INT_KEYS[key]] = int(val)
            elif key in _FLOAT_KEYS:
                kw[_FLOAT_KEYS[key]] = float(val)
            elif key == "interval":
                driver["interval"] = float(val)
            elif key == "backend":
                driver["backend"] = val
            elif key == "weights":
                weights: Dict[str, float] = {}
                for pair in val.split(";"):
                    name, wsep, w = pair.partition(":")
                    if not wsep:
                        raise ValueError(
                            f"weights need tenant:weight pairs, got {pair!r}"
                        )
                    weights[name.strip()] = float(w)
                kw["overload_weights"] = weights
            else:
                raise ValueError(f"unknown autoscale key {key!r}")
        except ValueError as e:
            raise ValueError(f"bad autoscale spec {part!r}: {e}") from None
    cfg = AutoscaleConfig(**kw)
    if cfg.min_workers < 0 or cfg.max_workers < cfg.min_workers:
        raise ValueError(
            f"autoscale needs 0 <= min <= max, got "
            f"min={cfg.min_workers} max={cfg.max_workers}"
        )
    if cfg.step < 1 or cfg.hold_ticks < 1:
        raise ValueError("autoscale needs step >= 1 and hold >= 1")
    return cfg, driver


class AutoscaleController:
    """SLO-burn-driven capacity policy: evidence in, fleet actions out.

    ``workers`` is the axis-a actuator (``live()`` / ``spawn(n)`` /
    ``drain(n)``); ``weights`` (axis c: ``reweight(mapping)`` /
    ``restore()``) and ``cell`` (axis b: ``drain_cell()``) are optional.
    ``burn`` returns the firing alert names (any false value means
    quiet); ``utilization`` returns the ``fleet.utilization`` level or
    None while unknown.  All four are plain callables/objects the caller
    already serializes — this object owns no locks and no threads.
    """

    def __init__(
        self,
        workers: Any,
        *,
        burn: Callable[[], Optional[Sequence[str]]],
        utilization: Callable[[], Optional[float]],
        weights: Optional[Any] = None,
        cell: Optional[Any] = None,
        config: Optional[AutoscaleConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        log: Optional[logging.Logger] = None,
    ) -> None:
        self.cfg = config or AutoscaleConfig()
        self._workers = workers
        self._burn = burn
        self._util = utilization
        self._weights = weights
        self._cell = cell
        self._clock = clock
        self._log = log or logging.getLogger("bitcoin_miner_tpu_torch.autoscale")
        self.state = STEADY
        self.target: Optional[int] = None  # set from live() on first tick
        self.last_action = ""
        self.suppress_reason = ""
        self._up_streak = 0
        self._down_streak = 0
        self._cell_streak = 0
        self._last_up_at: Optional[float] = None
        self._last_down_at: Optional[float] = None
        self._reweighted = False
        self._cell_drained = False
        #: A failed actuation to retry next tick: (kind, arg) — retried
        #: OUTSIDE the cooldown gate.
        self._pending: Optional[tuple] = None
        self._settled = True  # no action outstanding

    # ------------------------------------------------------------- actuation

    def _act(self, kind: str, arg: Any = None) -> bool:
        """One actuation attempt; False (and a queued retry) on failure."""
        try:
            if kind == "spawn":
                self._workers.spawn(arg)
            elif kind == "drain":
                self._workers.drain(arg)
            elif kind == "reweight":
                self._weights.reweight(arg)
            elif kind == "restore":
                self._weights.restore()
            elif kind == "drain-cell":
                self._cell.drain_cell()
            else:  # pragma: no cover - spelled-out kinds only
                raise ValueError(kind)
        except Exception as e:
            METRICS.inc("autoscale.actuator_failures")
            self._pending = (kind, arg)
            self.last_action = f"{kind} FAILED ({e}); will retry"
            self._log.warning("autoscale %s failed; will retry: %s", kind, e)
            return False
        self._pending = None
        self.last_action = kind if arg is None else f"{kind} {arg}"
        self._settled = False
        trace.emit(None, "autoscale", "action", kind=kind,
                   arg=arg if isinstance(arg, int) else None)
        return True

    # ------------------------------------------------------------------ tick

    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One policy beat; returns the decision record (the bench and
        the unit suite read it, the dash panel reads :meth:`status`)."""
        cfg = self.cfg
        now = self._clock() if now is None else now
        alerts = list(self._burn() or ())
        util = self._util()
        live = int(self._workers.live())
        if self.target is None:
            self.target = live
        burning = bool(alerts)
        quiet = (
            not burning
            and util is not None
            and util < cfg.util_low
        )
        acted = False
        suppressed = False
        self.suppress_reason = ""

        # Retry a failed actuation FIRST, outside every gate: cooldown
        # exists to stop flap, not to stretch a transient exec failure.
        if self._pending is not None:
            kind, arg = self._pending
            acted = self._act(kind, arg)

        if burning:
            self._down_streak = 0
            self._cell_streak = 0
            self._up_streak += 1
            if (
                self._weights is not None
                and cfg.overload_weights
                and not self._reweighted
                and not acted
            ):
                trace.emit(None, "autoscale", "decision", verdict="reweight",
                           alerts=",".join(alerts))
                if self._act("reweight", dict(cfg.overload_weights)):
                    self._reweighted = True
                    METRICS.inc("autoscale.reweights")
                acted = True
            if not acted:
                if self._up_streak < cfg.hold_ticks:
                    suppressed = True
                    self.state = HOLD_UP
                    self.suppress_reason = (
                        f"hold-up {self._up_streak}/{cfg.hold_ticks}"
                    )
                elif live >= cfg.max_workers:
                    suppressed = True
                    self.suppress_reason = f"at-max ({cfg.max_workers})"
                elif (
                    self._last_up_at is not None
                    and now - self._last_up_at < cfg.up_cooldown_s
                ):
                    suppressed = True
                    self.state = COOLDOWN_UP
                    self.suppress_reason = (
                        f"up-cooldown {now - self._last_up_at:.1f}s/"
                        f"{cfg.up_cooldown_s:g}s"
                    )
                else:
                    n = min(cfg.step, cfg.max_workers - live)
                    trace.emit(None, "autoscale", "decision",
                               verdict="scale-up", alerts=",".join(alerts),
                               live=live, add=n)
                    if self._act("spawn", n):
                        METRICS.inc("autoscale.scale_ups")
                        self._last_up_at = now
                        self.target = live + n
                        self.state = COOLDOWN_UP
                    acted = True
        elif quiet:
            self._up_streak = 0
            if self._reweighted and not acted:
                # Recovery: the overload weight overrides come off as soon
                # as the burn clears, independent of any capacity action.
                if self._act("restore", None):
                    self._reweighted = False
                acted = True
            if not acted and live > cfg.min_workers:
                self._down_streak += 1
                if self._down_streak < cfg.hold_ticks:
                    suppressed = True
                    self.state = HOLD_DOWN
                    self.suppress_reason = (
                        f"hold-down {self._down_streak}/{cfg.hold_ticks}"
                    )
                else:
                    ref = max(
                        (t for t in (self._last_up_at, self._last_down_at)
                         if t is not None),
                        default=None,
                    )
                    if ref is not None and now - ref < cfg.down_cooldown_s:
                        suppressed = True
                        self.state = COOLDOWN_DOWN
                        self.suppress_reason = (
                            f"down-cooldown {now - ref:.1f}s/"
                            f"{cfg.down_cooldown_s:g}s"
                        )
                    else:
                        n = min(cfg.step, live - cfg.min_workers)
                        trace.emit(None, "autoscale", "decision",
                                   verdict="scale-down", util=util,
                                   live=live, remove=n)
                        if self._act("drain", n):
                            METRICS.inc("autoscale.scale_downs")
                            self._last_down_at = now
                            self.target = live - n
                            self.state = COOLDOWN_DOWN
                        acted = True
            elif not acted:
                # Cold at the floor: axis b — a federation cell holding
                # spare capacity the mesh no longer needs hands off early.
                if (
                    self._cell is not None
                    and cfg.cell_drain_ticks > 0
                    and not self._cell_drained
                ):
                    self._cell_streak += 1
                    if self._cell_streak >= cfg.cell_drain_ticks:
                        trace.emit(None, "autoscale", "decision",
                                   verdict="drain-cell", util=util)
                        if self._act("drain-cell", None):
                            METRICS.inc("autoscale.scale_downs")
                            self._cell_drained = True
                            self.state = CELL_DRAINED
                        acted = True
        else:
            # In band: evidence streaks reset; weight overrides restore.
            self._up_streak = 0
            self._down_streak = 0
            self._cell_streak = 0
            if self._reweighted and not acted:
                if self._act("restore", None):
                    self._reweighted = False
                acted = True

        if suppressed:
            METRICS.inc("autoscale.actions_suppressed")
        if not burning and not suppressed and not acted:
            if self.state != CELL_DRAINED:
                self.state = STEADY
            if not self._settled and self._pending is None:
                # The loop closed: an action landed and the evidence went
                # quiet — the third beat of the decision→action→settled
                # timeline.
                self._settled = True
                trace.emit(None, "autoscale", "settled",
                           live=live, util=util)
        if self.target is not None:
            self.target = max(cfg.min_workers,
                              min(cfg.max_workers, self.target))
        METRICS.set_gauge(
            "autoscale.target_workers", float(self.target or live)
        )
        return {
            "state": self.state,
            "live": live,
            "target": self.target,
            "burning": burning,
            "alerts": alerts,
            "utilization": util,
            "acted": acted,
            "suppressed": suppressed,
            "suppress_reason": self.suppress_reason,
            "last_action": self.last_action,
        }

    # ---------------------------------------------------------------- status

    def status(self) -> Dict[str, Any]:
        """The dash panel's view (also published through the telemetry
        hub's extras hook, so the fleet log carries it)."""
        weights: Dict[str, float] = {}
        if self._reweighted:
            weights = dict(self.cfg.overload_weights)
        return {
            "state": self.state,
            "target": self.target,
            "last_action": self.last_action,
            "suppress_reason": self.suppress_reason,
            "weights": weights,
            "pending": self._pending[0] if self._pending else None,
        }
