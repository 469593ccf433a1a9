"""The federation replica binary: one scheduler cell of a replicated tier.

Beyond-parity entrypoint (the frozen server/client/miner CLI
contracts are untouched).  Each replica serves the frozen client/miner
protocol on ``<port>``, peer traffic (forwarded requests + span gossip)
on ``--fed-port``, and routes by consistent-hashing the request's
``data`` across ``--peers``.  A two-replica fleet on one machine:

    python -m bitcoin_miner_tpu_torch.apps.federation 5001 --cell=r1 \
        --fed-port=6001 --peers=r2=127.0.0.1:6002
    python -m bitcoin_miner_tpu_torch.apps.federation 5002 --cell=r2 \
        --fed-port=6002 --peers=r1=127.0.0.1:6001

then point miners and clients at EITHER port — duplicates collapse on
the home replica, spans gossip both ways, and killing one replica leaves
the other serving every data key (failover + local fallback).

This is the port's copy of the reference package's ``apps/federation.py``:
the same flags, environment (``BMT_CELL``, ``BMT_PEERS``,
``BMT_ASYNC_INGRESS``, ``BMT_AUTOSCALE``, ``BMT_WORKLOAD``, ``BMT_TRACE``),
usage and error strings, and the same wire, so port and reference replicas
serve one federation.  Its miners are ``python -m
bitcoin_miner_tpu_torch.apps.miner`` (the cuda rung on a card), and so are
the workers ``--autoscale`` spawns, whose backend defaults to ``"auto"``
where the reference's defaults to ``"cpu"``.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading
from typing import Dict, List, Optional, Tuple

from ..federation import GossipSpanStore, Replica
from ..gateway import ResultCache


def parse_peers(spec: str) -> Dict[str, Tuple[str, int]]:
    """``name=host:port[,name=host:port...]`` -> peer map."""
    peers: Dict[str, Tuple[str, int]] = {}
    for part in spec.split(","):
        if not part:
            continue
        name, sep, hostport = part.partition("=")
        host, hsep, port = hostport.rpartition(":")
        if not sep or not name or not hsep:
            raise ValueError(f"peer {part!r} is not name=host:port")
        peers[name] = (host or "127.0.0.1", int(port))
    return peers


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv if argv is None else argv
    cell = os.environ.get("BMT_CELL") or "r1"
    fed_port = 0
    peers_spec = os.environ.get("BMT_PEERS") or ""
    checkpoint_path = None
    cache_path = None
    spans_path = None
    trace_path = os.environ.get("BMT_TRACE") or None
    workload_name = os.environ.get("BMT_WORKLOAD") or None
    rate: Optional[float] = None
    gossip_interval = 1.0
    forward_timeout = 15.0
    # --async-ingress: serve the public port on the asyncio
    # event-loop front end — O(1) threads in live conns (env spelling
    # BMT_ASYNC_INGRESS, like apps.server; "" and "0" mean OFF).
    async_public = os.environ.get("BMT_ASYNC_INGRESS", "") not in ("", "0")
    # Self-scaling capacity plane: --autoscale[=SPEC] arms the
    # in-cell controller — axis a spawns/clean-drains miner workers
    # against this cell's public port; ``cell_drain=N`` in the spec arms
    # axis b (a cell cold at its worker floor hands off early through
    # the membership drain and exits, same path as SIGTERM).
    autoscale_conf = os.environ.get("BMT_AUTOSCALE") or None
    pos = []
    for a in argv[1:]:
        if a == "--async-ingress":
            async_public = True
        elif a == "--autoscale":
            autoscale_conf = "1"
        elif a.startswith("--autoscale="):
            autoscale_conf = a.split("=", 1)[1]
        elif a.startswith("--cell="):
            cell = a.split("=", 1)[1]
        elif a.startswith("--fed-port="):
            fed_port = int(a.split("=", 1)[1])
        elif a.startswith("--peers="):
            peers_spec = a.split("=", 1)[1]
        elif a.startswith("--checkpoint="):
            checkpoint_path = a.split("=", 1)[1]
        elif a.startswith("--cache="):
            cache_path = a.split("=", 1)[1]
        elif a.startswith("--spans="):
            spans_path = a.split("=", 1)[1]
        elif a.startswith("--trace="):
            trace_path = a.split("=", 1)[1]
        elif a.startswith("--rate="):
            rate = float(a.split("=", 1)[1]) or None
        elif a.startswith("--gossip-interval="):
            gossip_interval = float(a.split("=", 1)[1])
        elif a.startswith("--forward-timeout="):
            forward_timeout = float(a.split("=", 1)[1])
        elif a.startswith("--workload="):
            workload_name = a.split("=", 1)[1]
        else:
            pos.append(a)
    if len(pos) != 1:
        print(
            f"Usage: ./{argv[0]} <port> --cell=NAME [--fed-port=P] "
            "[--peers=name=host:port,...]",
            end="",
        )
        return 0
    try:
        port = int(pos[0])
        peers = parse_peers(peers_spec)
    except ValueError as e:
        print("Bad argument:", e)
        return 0
    as_cfg = as_driver = None
    if autoscale_conf:
        from ..autoscale import parse_autoscale_config

        try:
            as_cfg, as_driver = parse_autoscale_config(autoscale_conf)
        except ValueError as e:
            print("Bad argument:", e)
            return 0
    # One log file per cell — two replicas in one cwd must not interleave.
    logging.basicConfig(
        filename=f"log.{cell}.txt",
        level=logging.INFO,
        format="%(asctime)s %(filename)s:%(lineno)d %(message)s",
    )
    if trace_path:
        from ..utils.trace import TRACE

        TRACE.enable(path=trace_path)
    from ..workloads import resolve as resolve_workload
    from ..workloads import resolve_nondefault

    try:
        workload = resolve_workload(workload_name)
    except ValueError as e:
        print(str(e))
        return 0
    wl = resolve_nondefault(workload)
    try:
        replica = Replica(
            cell,
            peers,
            port=port,
            fed_port=fed_port,
            cache=ResultCache(path=cache_path, workload=workload.name),
            spans=GossipSpanStore(path=spans_path, workload=workload.name),
            rate=rate,
            gossip_interval=gossip_interval,
            forward_timeout=forward_timeout,
            checkpoint_path=checkpoint_path,
            tick_interval=1.0,
            workload=wl,
            async_public=async_public,
        )
        # With the async ingress the public bind happens in start() (on
        # the ingress loop); a busy port gets the same friendly message.
        replica.start()
    except OSError as e:
        print(str(e))
        return 0
    print(
        f"Replica {cell} listening on port {replica.port} "
        f"(federation port {replica.fed_port})",
        flush=True,
    )
    # Graceful drain on SIGTERM: stop admitting, broadcast
    # DRAINING, flush span deltas, hand the orphan stash + in-flight job
    # identities to the ring successor, THEN exit — a SIGTERM'd cell
    # loses no resumable progress.  SIGKILL remains the crash drill.
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    # In-cell autoscale controller.  The cell has no telemetry
    # hub here, so there is no burn evidence — the up axis stays quiet
    # (burn None = unknown) and the controller works the quiet side:
    # clean-draining spare workers down to the floor, then (cell_drain=N)
    # handing the whole cell off.  The drain latch sets ``stop`` so the
    # binary exits through the same path as SIGTERM — replica.drain() is
    # idempotent, so the second call below is harmless.
    pump = None
    workers = None
    if as_cfg is not None:
        from ..autoscale import (
            AutoscaleController,
            CellActuator,
            ControllerPump,
            GatewayWeightActuator,
            ProcessActuator,
        )
        from ..utils.metrics import METRICS

        workers = ProcessActuator(
            replica.port, backend=as_driver["backend"]
        )
        controller = AutoscaleController(
            workers,
            burn=lambda: None,
            utilization=lambda: METRICS.gauges().get("fleet.utilization"),
            weights=GatewayWeightActuator(replica.gateway, replica.lock),
            cell=CellActuator(replica, on_drained=stop.set),
            config=as_cfg,
        )
        pump = ControllerPump(
            controller, interval=as_driver["interval"]
        ).start()
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        if pump is not None:
            pump.stop()
        if workers is not None:
            workers.stop_all()
        if stop.is_set():
            print(f"Replica {cell} draining", flush=True)
            replica.drain(reason="SIGTERM")
        replica.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
