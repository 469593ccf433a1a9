"""Out-of-process autoscale supervisor.

The port's counterpart of the repository's ``tools/autoscale.py``.  The
in-process spelling is ``apps.server --autoscale[=SPEC]`` (and the
federation cell's flag); this CLI is the same controller driven from
OUTSIDE the serving process, consuming the burn evidence the server
already publishes — the fleet-log JSONL (``--fleet-log=FILE`` on the
server) carries the merged SLO verdicts and the ``fleet.utilization``
gauge every publish beat:

    python -m bitcoin_miner_tpu_torch.tools.autoscale HOST:PORT --fleet-log fleet.jsonl
    python -m bitcoin_miner_tpu_torch.tools.autoscale HOST:PORT --fleet-log fleet.jsonl \\
        --spec min=1,max=3,hold=2,weights=gold:4;free:1 \\
        --telemetry 127.0.0.1:7001

Each beat (``interval`` in the spec, default 1s) the supervisor tails
the fleet log, feeds the last row's ``slo.alerts`` + ``fleet.utilization``
to the policy state machine (autoscale/controller.py — the same
hold/cooldown/retry semantics as in-process), and actuates miner worker
subprocesses against HOST:PORT.  A fleet log that stops growing for
``--stale-after`` seconds means the evidence is UNKNOWN — both providers
return None, which parks the controller in-band (no scale-up on stale
alerts, no scale-down on stale idleness).

One JSONL decision line lands on stdout whenever the controller acts or
changes state — the operator's timeline, same vocabulary as the dash
panel.  SIGINT drains every spawned worker cleanly before exit.

Deliberate differences from the reference tool: the workers are the
port's miners (``python -m bitcoin_miner_tpu_torch.apps.miner``, from
:class:`ProcessActuator`) on the spec's ``backend``, whose default is
``auto``: the cuda rung on a card.  With no card and no ``backend=cpu``
in the spec the supervisor exits 2 naming the missing card, before it
spawns anything.  SIGTERM drains the workers as SIGINT does.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from typing import List, Optional

from ..autoscale import AutoscaleController, ProcessActuator, parse_autoscale_config
from . import resolve_tier


class _FleetLogEvidence:
    """Burn/utilization providers tailing a fleet-log JSONL file.

    ``poll()`` (the supervisor beat) reads newly appended COMPLETE lines
    and keeps the last decodable row; torn tails (a concurrent append)
    are re-read next beat, exactly like tools/dash.py's tailer.  A file
    that has not produced a new row within ``stale_after`` seconds makes
    both providers return None — stale evidence must park the policy,
    not drive it.
    """

    def __init__(
        self, path: str, stale_after: float = 10.0, clock=time.monotonic,
    ) -> None:
        self._path = path
        self._stale_after = stale_after
        self._clock = clock
        self._pos = 0
        self._row: Optional[dict] = None
        self._fresh_at: Optional[float] = None

    def poll(self) -> None:
        last = None
        try:
            with open(self._path) as f:
                f.seek(self._pos)
                for line in f:
                    if not line.endswith("\n"):
                        break  # torn tail: reread from _pos next beat
                    self._pos += len(line)
                    try:
                        last = json.loads(line)
                    except ValueError:
                        continue
        except OSError:
            return  # not created yet / transient: evidence just goes stale
        if isinstance(last, dict):
            self._row = last
            self._fresh_at = self._clock()

    def _live_row(self) -> Optional[dict]:
        if self._row is None or self._fresh_at is None:
            return None
        if self._clock() - self._fresh_at > self._stale_after:
            return None
        return self._row

    def alerts(self) -> Optional[list]:
        row = self._live_row()
        if row is None:
            return None
        return (row.get("slo") or {}).get("alerts") or None

    def utilization(self) -> Optional[float]:
        row = self._live_row()
        if row is None:
            return None
        util = (row.get("gauges") or {}).get("fleet.utilization")
        return float(util) if util is not None else None


def _interrupt(signum, frame) -> None:
    raise KeyboardInterrupt


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch.tools.autoscale",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("server", metavar="HOST:PORT",
                    help="the serving port spawned workers mine against")
    ap.add_argument("--fleet-log", required=True, metavar="FILE",
                    help="the server's fleet-log JSONL (its burn evidence)")
    ap.add_argument("--spec", default="1", metavar="SPEC",
                    help="policy spec (autoscale.parse_autoscale_config "
                         "grammar; default: all defaults)")
    ap.add_argument("--telemetry", metavar="HOST:PORT", default=None,
                    help="server telemetry sidecar port for spawned "
                         "workers' exporters")
    ap.add_argument("--stale-after", type=float, default=10.0,
                    help="seconds without a new fleet-log row before the "
                         "evidence is treated as unknown (default 10)")
    ap.add_argument("--ticks", type=int, default=0,
                    help="stop after N controller beats (0 = run forever; "
                         "tests and scripted drains use this)")
    args = ap.parse_args(argv)
    try:
        cfg, driver = parse_autoscale_config(args.spec)
    except ValueError as e:
        ap.error(str(e))
    host, _, port_s = args.server.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        ap.error(f"{args.server!r} is not HOST:PORT")
    try:
        resolve_tier(driver["backend"])
    except ValueError as e:
        print(f"autoscale: {e}", file=sys.stderr, flush=True)
        return 2
    workers = ProcessActuator(
        port,
        host=host or "127.0.0.1",
        backend=driver["backend"],
        telemetry=args.telemetry,
    )
    evidence = _FleetLogEvidence(args.fleet_log, stale_after=args.stale_after)
    # No weight/cell actuators out of process: the WFQ override surface
    # and the membership drain live inside the serving process (use its
    # --autoscale flag for those axes).  This supervisor is axis a only.
    controller = AutoscaleController(
        workers,
        burn=evidence.alerts,
        utilization=evidence.utilization,
        config=cfg,
    )
    previous = {}
    if threading.current_thread() is threading.main_thread():
        # Both stop signals drain the workers, also where the supervisor
        # was started with SIGINT ignored (a shell's background job).
        for sig in (signal.SIGINT, signal.SIGTERM):
            previous[sig] = signal.signal(sig, _interrupt)
    ticks = 0
    last_printed = None
    try:
        while args.ticks <= 0 or ticks < args.ticks:
            evidence.poll()
            decision = controller.tick()
            ticks += 1
            key = (decision["state"], decision["live"],
                   decision["last_action"])
            if decision["acted"] or key != last_printed:
                last_printed = key
                print(json.dumps(decision), flush=True)
            time.sleep(driver["interval"])
    except KeyboardInterrupt:
        pass
    finally:
        workers.stop_all()
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
