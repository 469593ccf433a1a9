"""Serving-layer load generator: duplicate-heavy traffic against the gateway.

The port's counterpart of the repository's ``tools/loadgen.py``; run it
as ``python -m bitcoin_miner_tpu_torch.tools.loadgen``.  Where
``fleet_bench`` measures one big job's delivered nonces/s, this tool
measures the SERVING layer: many jobs from many concurrent clients, half
of them duplicates, which is the regime the gateway exists for.
Coalescing folds concurrent twin sweeps into one, the content-addressed
cache answers solved signatures with zero device work, and admission
keeps the inflow bounded.

The fleet is fully in-process (real loopback LSP: an ``apps.server.serve``
thread, ``--miners`` miner threads and ``--clients`` client threads), so
one run gives apples-to-apples legs:

- **gateway leg**: ``serve`` runs a :class:`Gateway`-wrapped scheduler;
- **baseline leg** (unless ``--no-baseline``): the bare scheduler, where
  every duplicate burns the fleet again.

Every job's Result is validated bit-exact against the oracle (cached
answers included: a wrong cache hit fails the run), and the gateway leg
ends with a repeat-submission probe asserting a solved job answers with
ZERO new chunks assigned.  Prints one JSON line.

``--overlap`` switches to the interval-store regime: a nested and
overlapping range workload over a few shared data keys, run twice (an
interval-store leg with ``SpanStore`` armed against an exact-match-cache
leg with ``SpanStore(capacity=0)``), bit-exact both, plus a probe
asserting a never-issued, fully covered SUB-RANGE of solved work answers
with zero chunks assigned.

``--federation N`` sprays overlap-heavy load across N in-process
federation replicas against the same load on one replica, with the
repeat and cross-replica zero-chunk probes.

``--open-loop RATE`` replaces the closed-loop client threads with
open-loop load: Poisson arrivals at RATE requests/s for ``--duration``
seconds, each an independent conn + request + close on one shared
asyncio loop against the event-loop ingress (``AsyncIngress``).  Shed
rate, p99 under saturation and the failed fraction are measurable only
this way.  ``--conn-scale`` is the ingress pair on the same seeded
workload: a threaded-facade leg against an async-ingress leg, each
ramping live conns and then taking open-loop load.

Deliberate differences from the reference tool:

- The miners run on ``--backend`` (default ``auto``: the cuda rung on a
  card; ``cpu`` is the native host tier).  With no card and no
  ``--backend cpu`` the tool exits 2 and names the missing card.  Each
  miner thread serves through its own async search
  (``apps.miner.make_async_search``: its own ``SweepPipeline`` on a
  device tier), so several cuda miners share the card and one context.
  A search that fails ends the leg at once.
- ``--oracle card`` computes each distinct signature once with the
  port's ``sweep_min_hash`` on the card, before the first leg: hashlib
  cannot check jobs of 1e9 nonces and more.  Every oracle answer is also
  held to the workload's ``hash_nonce``.  The JSON line stamps the
  oracle, the rung and each leg's kernel launches (``launches``), the
  oracle's own launches counted apart.
- ``--fleet-log FILE`` has the ``--telemetry`` hub append its merged view
  there, as the server's ``--fleet-log=`` does, for ``tools.dash``.
- The async sub-range probe (``--open-loop``, ``--conn-scale``) cuts its
  sub-range from the widest SOLVED signature: at a low ``--open-loop``
  rate the arrivals may not reach every job of the list, and the
  reference's widest listed one may never have been asked.
- At the default sizes every job is folded on the host: a digit class
  reaches the kernel only where a chunk holds more of its nonces than
  the host lane budget (1e5).  ``chip_smoke.py`` runs ``--max-nonce
  1999999999``, whose d = 10 class the kernel sweeps.

Usage: python -m bitcoin_miner_tpu_torch.tools.loadgen [--fast]
       [--overlap] [--clients N] [--jobs N] [--dup F] [--max-nonce N]
       [--miners N] [--no-baseline] [--seed N] [--open-loop RATE]
       [--duration S] [--conn-scale] [--backend auto|cuda|cpu]
       [--oracle hashlib|card]
"""

from __future__ import annotations

import argparse
import asyncio as _aio
import json
import os
import random
import sys
import tempfile
import threading
import time
from contextlib import ExitStack

from .. import lsp
from .. import workloads as workloads_mod
from ..apps import client as client_mod
from ..apps import miner as miner_mod
from ..apps import server as server_mod
from ..apps.scheduler import Scheduler
from ..bitcoin.message import Message, MsgType
from ..federation import Replica, Ring
from ..gateway import Gateway, ResultCache, SpanStore
from ..utils.metrics import METRICS, Histogram
from ..utils.slo import SloEngine, default_slos
from ..utils.telemetry import TelemetryExporter, TelemetryHub
from ..utils.trace import tracing
from . import ORACLES, Oracle, miner_launches, resolve_tier, run_stamp


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class _Miners:
    """``--miners`` miner threads per serving port.  Each serves Requests
    through its own async search on ``args.tier``
    (``apps.miner.make_async_search``: its own ``SweepPipeline`` on a
    device tier), so several cuda miners share the card and its context.
    A search that fails sets :attr:`failed`, which ends the leg.
    :meth:`stop` drains every miner (each answers what it holds), joins
    it and closes its conn, so the kernels' launch counts read after it
    hold all of the leg's work."""

    def __init__(self, args, params, ports) -> None:
        self.failed = threading.Event()
        self._drain = threading.Event()
        self._conns: list = []
        self._threads: list = []
        for port in ports:
            for _ in range(args.miners):
                search = miner_mod.make_async_search(args.tier, workload=args.wl)
                mc = lsp.Client("127.0.0.1", port, params)
                t = threading.Thread(target=self._serve, args=(mc, search), daemon=True)
                t.start()
                self._conns.append(mc)
                self._threads.append(t)

    def _serve(self, mc, search) -> None:
        if not miner_mod.run_miner(mc, search, drain=self._drain):
            self.failed.set()  # run_miner printed the search's error

    def stop(self) -> None:
        self._drain.set()
        deadline = time.monotonic() + 30.0  # a miner's last chunk is well under it
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        for mc in self._conns:
            try:
                mc.close()
            except lsp.LspError:
                pass  # the server already dropped it


def _join_clients(threads, args, miners: _Miners, errors: list) -> None:
    """Wait for the client threads, at most ``--timeout`` in all; a miner
    whose search failed ends the wait at once."""
    deadline = time.monotonic() + args.timeout
    for t in threads:
        while t.is_alive() and not miners.failed.is_set() and time.monotonic() < deadline:
            t.join(timeout=0.05)
        if miners.failed.is_set():
            errors.append("a miner's search failed (its error is on stderr)")
            return
        if t.is_alive():
            errors.append(f"worker timed out after {args.timeout:.0f}s")


def build_workload(args) -> list:
    """A duplicate-heavy job list: each entry is a ``(data, lower, upper)``
    signature; with probability ``--dup`` a job repeats an earlier
    signature — biased toward RECENT ones, so some duplicates land while
    their twin is still sweeping (coalesce) and some after it solved
    (cache hit)."""
    rng = random.Random(args.seed)
    issued: list = []
    jobs: list = []
    for i in range(args.jobs):
        if issued and rng.random() < args.dup:
            if rng.random() < 0.5:
                sig = rng.choice(issued[-4:])  # recent: likely in flight
            else:
                sig = rng.choice(issued)  # any: likely already solved
        else:
            lo = 0
            hi = rng.randint(args.max_nonce // 2, args.max_nonce)
            sig = (f"load{len(issued)}", lo, hi)
            issued.append(sig)
        jobs.append(sig)
    return jobs


def build_overlap_workload(args, n_datas: int = 3) -> list:
    """Overlap-heavy jobs for the interval store: a few shared
    data keys, each hit by growing prefixes ``[0, hi]`` (extensions sweep
    only the new tail), interior sub-ranges ``[lo, hi]`` (answered from
    chunk spans), and exact repeats (both stores should catch those) —
    the many-clients regime where ranges nest and overlap but rarely
    repeat exactly.  ``n_datas`` widens the key family (the federation
    bench uses more keys so the ring has something to spread)."""
    rng = random.Random(args.seed)
    datas = [f"ov{i}" for i in range(n_datas)]
    issued: list = []
    jobs: list = []
    for _ in range(args.jobs):
        r = rng.random()
        if issued and r < 0.15:
            sig = rng.choice(issued)  # exact repeat
        elif r < 0.55:
            # growing prefix: nested [0, hi] family on one data key
            data = rng.choice(datas)
            hi = rng.randint(args.max_nonce // 4, args.max_nonce)
            sig = (data, 0, hi)
        else:
            # interior sub-range of the same families
            data = rng.choice(datas)
            lo = rng.randint(0, args.max_nonce // 2)
            hi = rng.randint(lo, args.max_nonce)
            sig = (data, lo, hi)
        issued.append(sig)
        jobs.append(sig)
    return jobs


def run_leg(
    gateway_on: bool, jobs: list, args, oracle: dict, spans_on: bool = True
) -> dict:
    """Stand up one in-process fleet, push the whole workload through it
    with ``--clients`` concurrent client threads, tear it down.  Returns
    the leg's timing + METRICS deltas.  ``spans_on=False`` runs the
    gateway with the interval store disabled — the exact-match-cache
    comparison leg of the --overlap bench."""
    params = lsp.Params(epoch_limit=5, epoch_millis=200, window_size=5)
    server = lsp.Server(0, params)
    sched = Scheduler(min_chunk=args.min_chunk, workload=args.wl)
    engine = (
        Gateway(
            sched,
            cache=ResultCache(capacity=args.cache_size),
            spans=SpanStore() if spans_on else SpanStore(capacity=0),
            # All loopback clients share one peer addr, so a real rate
            # limit would throttle the whole bench as ONE client.
            rate=None,
            max_active=args.max_active,
        )
        if gateway_on
        else sched
    )
    threading.Thread(
        target=server_mod.serve,
        args=(server, engine),
        kwargs={"tick_interval": 0.05},
        daemon=True,
    ).start()
    launches = miner_launches(args.oracle_fn)
    miners = _Miners(args, params, [server.port])

    before = METRICS.snapshot()
    errors: list = []
    cursor = [0]
    cursor_lock = threading.Lock()
    # Client-observed request→result latency: one mergeable log-bucket
    # histogram per leg, p50/p95/p99 into the JSON line
    # so the perf trajectory has a latency axis next to jobs/s.
    latency = Histogram()

    def worker(idx: int) -> None:
        while True:
            with cursor_lock:
                if cursor[0] >= len(jobs):
                    return
                job_i = cursor[0]
                cursor[0] += 1
            data, lo, hi = jobs[job_i]
            c = lsp.Client("127.0.0.1", server.port, params)
            t_req = time.monotonic()
            try:
                got = client_mod.request_once(c, data, hi, lower=lo)
            finally:
                c.close()
            latency.observe(time.monotonic() - t_req)
            want = oracle[(data, lo, hi)]
            if got != want:
                errors.append(
                    f"job {job_i} ({data},{lo},{hi}): got {got}, want {want}"
                )
                return

    t0 = time.monotonic()
    threads = [
        threading.Thread(target=worker, args=(i,), daemon=True)
        for i in range(args.clients)
    ]
    for t in threads:
        t.start()
    _join_clients(threads, args, miners, errors)
    wall = time.monotonic() - t0

    repeat_zero_chunks = None
    subrange_zero_chunks = None
    if gateway_on and not errors:
        # Acceptance probe: a repeat of a SOLVED signature must answer
        # from the cache with zero new chunks assigned.
        assigned_before = METRICS.get("sched.chunks_assigned")
        data, lo, hi = jobs[0]
        c = lsp.Client("127.0.0.1", server.port, params)
        try:
            got = client_mod.request_once(c, data, hi, lower=lo)
        finally:
            c.close()
        if got != oracle[(data, lo, hi)]:
            errors.append(f"repeat probe wrong result: {got}")
        repeat_zero_chunks = (
            METRICS.get("sched.chunks_assigned") == assigned_before
        )
        if not repeat_zero_chunks:
            errors.append("repeat probe assigned chunks (cache missed)")
    if gateway_on and spans_on and not errors:
        subrange_zero_chunks = _subrange_probe(
            engine, server, params, jobs, errors, args.oracle_fn
        )

    miners.stop()
    launches = launches()
    server.close()
    after = METRICS.snapshot()
    deltas = {
        k: after[k] - before.get(k, 0)
        for k in sorted(after)
        if k.startswith(("gateway.", "sched."))
        and after[k] != before.get(k, 0)
    }
    if errors:
        raise RuntimeError(
            f"{'gateway' if gateway_on else 'baseline'} leg failed: "
            + "; ".join(errors[:5])
        )
    lat = latency.snapshot()
    return {
        "wall_s": wall,
        "jobs_per_sec": len(jobs) / wall if wall > 0 else 0.0,
        "counters": deltas,
        "repeat_zero_chunks": repeat_zero_chunks,
        "subrange_zero_chunks": subrange_zero_chunks,
        "launches": launches,
        "latency_s": {
            "p50": round(lat["p50"], 6),
            "p95": round(lat["p95"], 6),
            "p99": round(lat["p99"], 6),
            "count": int(lat["count"]),
        },
    }


def _covered_subrange(spans_store, jobs, errors):
    """A NEVER-ISSUED strict sub-range of the widest issued signature
    that the interval store fully covers, or None (with the reason
    appended to ``errors``).  Candidates are built from the solved-span
    geometry: prefixes ending at a span boundary are covered whenever
    the spans are contiguous; prefixes/suffixes cut AT a recorded argmin
    keep the boundary span answerable by construction.  Each candidate
    is re-verified through the planner itself before use."""
    issued = set(jobs)
    data, lo, hi = max(jobs, key=lambda s: s[2] - s[1])
    span_map = spans_store._maps.get(data)
    if span_map is None:
        errors.append(f"no solved spans recorded for {data!r}")
        return None
    for s_lo, s_hi, _h, n in span_map.spans():
        for cand in ((lo, s_hi), (lo, n), (n, hi)):
            qlo, qhi = cand
            if not (lo <= qlo <= qhi <= hi) or (qlo, qhi) == (lo, hi):
                continue
            if (data, qlo, qhi) in issued:
                continue
            best, gaps = spans_store.cover(data, qlo, qhi)
            if not gaps and best is not None:
                return (data, qlo, qhi)
    errors.append("no fully covered strict sub-range found to probe")
    return None


def _subrange_probe(engine, server, params, jobs, errors, oracle_fn):
    """The sub-range probe: find a NEVER-ISSUED strict sub-range
    of the widest solved signature that the interval store fully covers,
    request it over the wire, and assert it answers bit-exact with zero
    chunks assigned (mirroring the exact-repeat `repeat_zero_chunks`
    probe).  ``oracle_fn`` is the run's :class:`Oracle`."""
    cand = _covered_subrange(engine.spans, jobs, errors)
    if cand is None:
        return False
    data, qlo, qhi = cand
    assigned_before = METRICS.get("sched.chunks_assigned")
    c = lsp.Client("127.0.0.1", server.port, params)
    try:
        got = client_mod.request_once(c, data, qhi, lower=qlo)
    finally:
        c.close()
    want = oracle_fn(data, qlo, qhi)
    if got != want:
        errors.append(
            f"subrange probe ({data},{qlo},{qhi}): got {got}, want {want}"
        )
    ok = METRICS.get("sched.chunks_assigned") == assigned_before
    if not ok:
        errors.append("subrange probe assigned chunks (interval store missed)")
    return ok


def _free_udp_port() -> int:
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_federation_leg(n_replicas: int, jobs: list, args, oracle: dict) -> dict:
    """Stand up ``n_replicas`` in-process federation cells (each with its
    own scheduler + miners), spray the workload round-robin across the
    replicas' PUBLIC ports — the load-balancer-spray regime consistent-
    hash routing exists for — and fail a client over to the next replica
    if its conn dies.  Returns timing + METRICS deltas + the federation
    probes:

    - ``repeat_zero_chunks``: a repeat of a solved signature submitted at
      EVERY replica answers with zero new chunks anywhere (routing lands
      it on the home's cache);
    - ``cross_replica_zero_chunks``: after gossip, a never-issued
      fully-covered sub-range queried at a NON-home replica's federation
      port (the local-serve path) answers bit-exact with zero chunks —
      a range solved anywhere answers everywhere;
    - ``gossip_max_frame_bytes``: the largest gossip datagram written
      (must respect the frozen 1000-byte wire ceiling with envelope
      headroom)."""
    params = lsp.Params(epoch_limit=5, epoch_millis=200, window_size=5)
    names = [f"r{i}" for i in range(n_replicas)]
    fed_ports = {name: _free_udp_port() for name in names}
    replicas = []
    for name in names:
        peers = {
            other: ("127.0.0.1", fed_ports[other])
            for other in names
            if other != name
        }
        replicas.append(
            Replica(
                name,
                peers,
                fed_port=fed_ports[name],
                params=params,
                scheduler=Scheduler(min_chunk=args.min_chunk, workload=args.wl),
                gossip_interval=0.2,
                tick_interval=0.05,
                workload=args.wl,
            ).start()
        )
    launches = miner_launches(args.oracle_fn)
    miners = _Miners(args, params, [rep.port for rep in replicas])

    ports = [rep.port for rep in replicas]
    before = METRICS.snapshot()
    errors: list = []
    cursor = [0]
    cursor_lock = threading.Lock()
    latency = Histogram()

    def one_request(start_idx: int, data: str, lo: int, hi: int):
        """Request with load-balancer failover: try each replica once."""
        for k in range(len(ports)):
            port = ports[(start_idx + k) % len(ports)]
            try:
                c = lsp.Client("127.0.0.1", port, params)
            except (lsp.LspError, OSError):
                continue
            try:
                got = client_mod.request_once(c, data, hi, lower=lo)
            finally:
                try:
                    c.close()
                except lsp.LspError:
                    pass
            if got is not None:
                return got
        return None

    def worker(idx: int) -> None:
        while True:
            with cursor_lock:
                if cursor[0] >= len(jobs):
                    return
                job_i = cursor[0]
                cursor[0] += 1
            data, lo, hi = jobs[job_i]
            t_req = time.monotonic()
            got = one_request(job_i, data, lo, hi)
            latency.observe(time.monotonic() - t_req)
            want = oracle[(data, lo, hi)]
            if got != want:
                errors.append(
                    f"job {job_i} ({data},{lo},{hi}): got {got}, want {want}"
                )
                return

    t0 = time.monotonic()
    threads = [
        threading.Thread(target=worker, args=(i,), daemon=True)
        for i in range(args.clients)
    ]
    for t in threads:
        t.start()
    _join_clients(threads, args, miners, errors)
    wall = time.monotonic() - t0

    repeat_zero = cross_zero = None
    if not errors:
        # Repeat probe at EVERY replica: routing must land each repeat on
        # the home cell's cache/spans — zero chunks assigned anywhere.
        assigned = METRICS.get("sched.chunks_assigned")
        data, lo, hi = jobs[0]
        repeat_zero = True
        for i in range(len(ports)):
            got = one_request(i, data, lo, hi)
            if got != oracle[(data, lo, hi)]:
                errors.append(f"repeat probe at replica {i}: got {got}")
                repeat_zero = False
        if METRICS.get("sched.chunks_assigned") != assigned:
            errors.append("repeat probe assigned chunks at some replica")
            repeat_zero = False
    if not errors and n_replicas > 1:
        cross_zero = _cross_replica_probe(
            replicas, params, jobs, oracle, errors, args.oracle_fn
        )

    gossip_max = max(rep.gossip.max_frame_bytes for rep in replicas)
    miners.stop()
    launches = launches()
    for rep in replicas:
        rep.close()
    after = METRICS.snapshot()
    deltas = {
        k: after[k] - before.get(k, 0)
        for k in sorted(after)
        if k.startswith(("gateway.", "sched.", "federation."))
        and after[k] != before.get(k, 0)
    }
    if errors:
        raise RuntimeError(
            f"federation leg ({n_replicas} replicas) failed: "
            + "; ".join(errors[:5])
        )
    lat = latency.snapshot()
    return {
        "wall_s": wall,
        "jobs_per_sec": len(jobs) / wall if wall > 0 else 0.0,
        "counters": deltas,
        "repeat_zero_chunks": repeat_zero,
        "cross_replica_zero_chunks": cross_zero,
        "gossip_max_frame_bytes": gossip_max,
        "launches": launches,
        "latency_s": {
            "p50": round(lat["p50"], 6),
            "p95": round(lat["p95"], 6),
            "p99": round(lat["p99"], 6),
            "count": int(lat["count"]),
        },
    }


def _cross_replica_probe(replicas, params, jobs, oracle, errors, oracle_fn):
    """The cross-replica probe: a never-issued sub-range of solved
    work, fully covered BY GOSSIP on a replica that is NOT the data's
    home, must answer bit-exact with zero chunks assigned — through that
    replica's federation port (the local-serve path, so the answer
    provably comes from the probed replica's own spans)."""
    issued = {tuple(j) for j in jobs}
    ring = Ring([rep.cell for rep in replicas])
    by_name = {rep.cell: rep for rep in replicas}
    # Widest signature whose home is identifiable; probe a DIFFERENT cell.
    data, lo, hi = max(jobs, key=lambda s: s[2] - s[1])
    home = ring.home(data)
    probe_rep = next(rep for rep in replicas if rep.cell != home)
    # Wait for gossip (delta beats + full syncs) to cover a candidate
    # sub-range on the probed replica, built from its own span geometry.
    deadline = time.monotonic() + 10.0
    sub = None
    while time.monotonic() < deadline and sub is None:
        with probe_rep.lock:
            span_map = probe_rep.spans._maps.get(data)
            rows = span_map.spans() if span_map is not None else []
            for s_lo, s_hi, _h, n in rows:
                for cand in ((lo, s_hi), (lo, n), (n, hi)):
                    qlo, qhi = cand
                    if not (lo <= qlo <= qhi <= hi) or (qlo, qhi) == (lo, hi):
                        continue
                    if (data, qlo, qhi) in issued:
                        continue
                    best, gaps = probe_rep.spans.cover(data, qlo, qhi)
                    if not gaps and best is not None:
                        sub = (qlo, qhi)
                        break
                if sub is not None:
                    break
        if sub is None:
            time.sleep(0.1)
    if sub is None:
        errors.append(
            f"gossip never covered a probe sub-range of {data!r} on "
            f"{probe_rep.cell} (home {home})"
        )
        return False
    assigned = METRICS.get("sched.chunks_assigned")
    c = lsp.Client("127.0.0.1", by_name[probe_rep.cell].fed_port, params)
    try:
        got = client_mod.request_once(c, data, sub[1], lower=sub[0])
    finally:
        c.close()
    want = oracle_fn(data, sub[0], sub[1])
    if got != want:
        errors.append(
            f"cross-replica probe ({data},{sub[0]},{sub[1]}) on "
            f"{probe_rep.cell}: got {got}, want {want}"
        )
    ok = METRICS.get("sched.chunks_assigned") == assigned
    if not ok:
        errors.append("cross-replica probe assigned chunks (gossip missed)")
    return ok and got == want


# --------------------------------------------------------------------------
# Event-loop ingress benches: open-loop load + conn-scale pair
# --------------------------------------------------------------------------


def _rss_kb() -> int:
    """Current resident set (kB) — per-leg, unlike ru_maxrss which only
    ever grows across a process's legs."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    import resource
    import sys as _sys

    rss = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    # Fallback is a lifetime MAX, not the current figure — and Darwin
    # reports ru_maxrss in bytes where Linux uses kB.
    return rss // 1024 if _sys.platform == "darwin" else rss


def _serving_stack(kind: str, args, tick_interval: float = 0.05):
    """One in-process serving cell for the ingress benches: gateway-
    wrapped scheduler, ``--miners`` miners on ``args.tier``, and the
    requested transport shell — ``"threaded"`` (blocking facade + serve
    thread) or ``"async"`` (the event-loop AsyncIngress).  Returns
    ``(params, port, engine, miners, close_fn)``; ``close_fn`` stops the
    miners, then the shell."""
    # Long epochs: 10k-conn keepalive traffic scales with 1/epoch, and
    # the conn-scale leg's point is holding conns, not probing loss fast.
    params = lsp.Params(epoch_limit=8, epoch_millis=500, window_size=5)
    engine = Gateway(
        Scheduler(min_chunk=args.min_chunk, workload=args.wl),
        cache=ResultCache(capacity=args.cache_size),
        spans=SpanStore(),
        # All loopback clients share one peer addr (see run_leg); the
        # overload lever here is the bounded admission queue instead.
        rate=None,
        max_active=args.max_active,
        max_queued=args.ol_queue,
    )
    if kind == "async":
        ingress = server_mod.AsyncIngress(
            0, scheduler=engine, params=params, tick_interval=tick_interval
        ).start()
        port, shell_close = ingress.port, ingress.close
    else:
        server = lsp.Server(0, params)
        threading.Thread(
            target=server_mod.serve,
            args=(server, engine),
            kwargs={"tick_interval": tick_interval},
            daemon=True,
        ).start()
        port, shell_close = server.port, server.close
    miners = _Miners(args, params, [port])

    def close_fn() -> None:
        miners.stop()
        shell_close()

    return params, port, engine, miners, close_fn


async def _request_result(c, data, lo, hi, timeout):
    """Write one Request on an open AsyncClient conn and read frames
    until its RESULT arrives; None on loss/shed/timeout.  The single
    wire-probe loop every async bench path shares."""
    try:
        c.write(Message.request(data, lo, hi).marshal())
        while True:
            payload = await _aio.wait_for(c.read(), timeout)
            m = Message.unmarshal(payload)
            if m is not None and m.type == MsgType.RESULT:
                return (m.hash, m.nonce)
    except (lsp.LspError, _aio.TimeoutError):
        return None


async def _ol_one_async(port, params, sig, oracle, hist, stats, errors, timeout):
    """One open-loop arrival on the shared client loop: fresh conn,
    one request, read the Result, close.  A conn the gateway sheds (or
    that times out under saturation) counts ``failed`` — the client-side
    view; the authoritative shed count is the gateway.shed delta."""
    data, lo, hi = sig
    t0 = time.monotonic()
    try:
        c = await _aio.wait_for(
            lsp.AsyncClient.connect("127.0.0.1", port, params), timeout
        )
    except Exception:
        stats["failed"] += 1
        return
    try:
        got = await _request_result(c, data, lo, hi, timeout)
    finally:
        try:
            await _aio.wait_for(c.close(), 2.0)
        except Exception:
            pass
    if got is None:
        stats["failed"] += 1
    elif got != oracle[sig]:
        stats["wrong"] += 1
        errors.append(f"open-loop {sig}: got {got}, want {oracle[sig]}")
    else:
        stats["completed"] += 1
        hist.observe(time.monotonic() - t0)


async def _ol_async(port, params, jobs, oracle, rate, duration, rng, hist,
                    stats, errors, timeout):
    """Poisson arrivals at ``rate``/s for ``duration``s, each an
    independent task on the one client loop — open-loop: the arrival
    process never waits for the server."""
    tasks: set = set()
    i = 0
    end = time.monotonic() + duration
    while time.monotonic() < end:
        sig = jobs[i % len(jobs)]
        i += 1
        stats["offered"] += 1
        t = _aio.ensure_future(
            _ol_one_async(port, params, sig, oracle, hist, stats, errors, timeout)
        )
        tasks.add(t)
        t.add_done_callback(tasks.discard)
        await _aio.sleep(rng.expovariate(rate))
    if tasks:
        # Drain: every in-flight request's own deadline (``timeout``) is
        # shorter than this wait, so stragglers here mean a wedged conn —
        # cancel them and let the cancellations finalize, then reconcile
        # ``undrained`` from the totals (a task finishing between wait()'s
        # snapshot and a naive len(pending) count would otherwise be
        # counted twice: once in completed/failed, once as undrained).
        _done, pending = await _aio.wait(set(tasks), timeout=timeout + 5)
        for t in pending:
            t.cancel()
        if pending:
            await _aio.gather(*pending, return_exceptions=True)
    stats["undrained"] = max(
        0,
        stats["offered"] - stats["completed"] - stats["failed"] - stats["wrong"],
    )


def _ol_threaded(port, params, jobs, oracle, rate, duration, rng, hist,
                 stats, stats_lock, errors, timeout, max_threads):
    """The threaded-facade open-loop generator: thread-per-arrival,
    capped at ``max_threads`` live request threads.  An arrival landing
    on a saturated pool is turned away at the CLIENT
    (``client_saturated``) — the thread-stack failure mode the async
    ingress exists to remove."""
    sem = threading.Semaphore(max_threads)
    threads = []

    def one(sig):
        data, lo, hi = sig
        t0 = time.monotonic()
        got = None
        try:
            try:
                c = lsp.Client("127.0.0.1", port, params)
            except (lsp.LspError, OSError):
                return
            try:
                got = client_mod.request_once(c, data, hi, lower=lo, timeout=timeout)
            except TimeoutError:
                got = None
            finally:
                try:
                    c.close()
                except lsp.LspError:
                    pass
        finally:
            with stats_lock:
                if got is None:
                    stats["failed"] += 1
                elif got != oracle[sig]:
                    stats["wrong"] += 1
                    errors.append(f"open-loop {sig}: got {got}, want {oracle[sig]}")
                else:
                    stats["completed"] += 1
                    hist.observe(time.monotonic() - t0)
            sem.release()

    i = 0
    end = time.monotonic() + duration
    while time.monotonic() < end:
        sig = jobs[i % len(jobs)]
        i += 1
        with stats_lock:
            stats["offered"] += 1
        if not sem.acquire(blocking=False):
            with stats_lock:
                stats["client_saturated"] += 1
        else:
            th = threading.Thread(target=one, args=(sig,), daemon=True)
            th.start()
            threads.append(th)
            if len(threads) >= 2 * max_threads:
                # Prune finished threads as we go: at saturation rates the
                # list (and the leg's own RSS stamp) must not grow with
                # every arrival of the whole measurement window.
                threads = [t for t in threads if t.is_alive()]
        time.sleep(rng.expovariate(rate))
    for th in threads:
        th.join(timeout=timeout + 5)


def _open_loop_phase(kind, port, params, jobs, oracle, args, errors, lt=None):
    """Run one open-loop measurement against an already-serving stack and
    return its stamp: offered/completed/failed counts, the authoritative
    gateway.shed delta and shed rate, and the completed-request latency
    quantiles (p99-under-saturation is the number closed-loop clients can
    never measure)."""
    rng = random.Random(args.seed + 1)
    hist = Histogram()
    stats = {
        "offered": 0, "completed": 0, "failed": 0, "wrong": 0,
        "client_saturated": 0, "undrained": 0,
    }
    stats_lock = threading.Lock()
    shed_before = METRICS.get("gateway.shed")
    if kind == "async":
        fut = _aio.run_coroutine_threadsafe(
            _ol_async(port, params, jobs, oracle, args.open_loop,
                      args.duration, rng, hist, stats, errors,
                      args.ol_timeout),
            lt.loop,
        )
        fut.result(timeout=args.duration + args.ol_timeout + 30)
    else:
        _ol_threaded(port, params, jobs, oracle, args.open_loop,
                     args.duration, rng, hist, stats, stats_lock, errors,
                     args.ol_timeout, args.ol_max_threads)
    if stats["wrong"]:
        errors.append(f"{stats['wrong']} open-loop result(s) failed the oracle")
    shed = METRICS.get("gateway.shed") - shed_before
    lat = hist.snapshot()
    return {
        "rate": args.open_loop,
        "duration_s": args.duration,
        **stats,
        "shed": shed,
        "shed_rate": round(shed / stats["offered"], 4) if stats["offered"] else 0.0,
        "latency_s": {
            "p50": round(lat["p50"], 6),
            "p95": round(lat["p95"], 6),
            "p99": round(lat["p99"], 6),
            "count": int(lat["count"]),
        },
    }


def _async_probes(engine, port, params, lt, jobs, oracle, args, errors):
    """The zero-chunk probes THROUGH the async path (the bridge must not
    break the serving layer's reuse machinery): an exact repeat of a solved signature and a never-issued
    fully-covered sub-range, both answering bit-exact with zero chunks
    assigned, via AsyncClient conns on the shared loop."""
    h = Histogram()  # throwaway latency sink for the probe helper

    def ask(sig):
        stats = {"offered": 0, "completed": 0, "failed": 0, "wrong": 0,
                 "client_saturated": 0}
        probe_oracle = {sig: oracle.get(sig, args.oracle_fn(*sig))}
        _aio.run_coroutine_threadsafe(
            _ol_one_async(
                port, params, sig, probe_oracle, h, stats, errors,
                args.ol_timeout,
            ),
            lt.loop,
        ).result(timeout=args.ol_timeout + 10)
        return stats["completed"] == 1

    solved = [s for s in jobs if engine.cache.get(s) is not None]
    if not solved:
        errors.append("no solved signature to repeat-probe")
        return None, None
    repeat_sig = solved[0]
    assigned = METRICS.get("sched.chunks_assigned")
    ok = ask(repeat_sig)
    repeat_zero = ok and METRICS.get("sched.chunks_assigned") == assigned
    if not repeat_zero:
        errors.append("async repeat probe missed the cache or failed")
    # The widest SOLVED signature: at a low rate the arrivals may not
    # reach every job of the list (the reference takes the widest listed).
    cand = _covered_subrange(engine.spans, solved, errors)
    if cand is None:
        return repeat_zero, None
    data, qlo, qhi = cand
    assigned = METRICS.get("sched.chunks_assigned")
    ok = ask((data, qlo, qhi))
    sub_zero = ok and METRICS.get("sched.chunks_assigned") == assigned
    if not sub_zero:
        errors.append("async subrange probe assigned chunks (spans missed)")
    return repeat_zero, sub_zero


def _open_loop_main(jobs, distinct, args, oracle) -> int:
    """The standalone --open-loop bench: Poisson arrivals against the
    async ingress, one JSON line."""
    errors: list = []
    launches = miner_launches(args.oracle_fn)
    params, port, engine, miners, close_fn = _serving_stack("async", args)
    lt = lsp.shared_loop("loadgen-aclients")
    try:
        stamp = _open_loop_phase(
            "async", port, params, jobs, oracle, args, errors, lt=lt
        )
        repeat_zero, sub_zero = _async_probes(
            engine, port, params, lt, jobs, oracle, args, errors
        )
    finally:
        close_fn()
        lt.stop()
    if miners.failed.is_set():
        errors.append("a miner's search failed (its error is on stderr)")
    if errors:
        raise RuntimeError("open-loop leg failed: " + "; ".join(errors[:5]))
    out = {
        "metric": "loadgen_open_loop_completed_per_sec",
        "value": round(stamp["completed"] / args.duration, 3),
        "unit": "jobs/s",
        "workload": args.wl_name,
        "mode": "open-loop",
        "ingress": "async",
        "jobs": len(jobs),
        "distinct_signatures": len(distinct),
        "max_nonce": args.max_nonce,
        "miners": args.miners,
        "seed": args.seed,
        "fast": bool(args.fast),
        "open_loop": stamp,
        "repeat_zero_chunks": repeat_zero,
        "subrange_zero_chunks": sub_zero,
        "launches": launches(),
        **run_stamp(args, args.oracle_fn),
    }
    print(json.dumps(out), flush=True)
    return 0


def _conn_scale_leg(kind: str, jobs, oracle, args) -> dict:
    """One conn-scale leg: stand the stack up, ramp live conns (sampling
    the process thread count mid-ramp and at full ramp), prove every conn
    live with a bit-exact round trip, take open-loop load, then (async
    leg) run the zero-chunk probes.  Returns the leg's stamp."""
    errors: list = []
    launches = miner_launches(args.oracle_fn)
    params, port, engine, miners, close_fn = _serving_stack(kind, args)
    lt = lsp.shared_loop("loadgen-aclients") if kind == "async" else None
    target = (
        args.conns if kind == "threaded" else args.conns * args.conn_multiple
    )
    conns: list = []

    async def _connect_batch(n):
        outs = await _aio.gather(
            *(
                lsp.AsyncClient.connect("127.0.0.1", port, params)
                for _ in range(n)
            ),
            return_exceptions=True,
        )
        return [c for c in outs if not isinstance(c, BaseException)]

    async def _verify_all(sig):
        data, lo, hi = sig
        out = []
        for s in range(0, len(conns), 100):
            out.extend(
                await _aio.gather(
                    *(
                        _request_result(c, data, lo, hi, args.ol_timeout)
                        for c in conns[s:s + 100]
                    )
                )
            )
        return out

    async def _close_batch(batch):
        await _aio.gather(
            *( _aio.wait_for(c.close(), 2.0) for c in batch),
            return_exceptions=True,
        )

    def ramp_to(n):
        while len(conns) < n:
            if kind == "threaded":
                try:
                    conns.append(lsp.Client("127.0.0.1", port, params))
                except (lsp.LspError, OSError) as e:
                    errors.append(f"conn ramp stalled at {len(conns)}: {e!r}")
                    return
            else:
                batch = min(50, n - len(conns))
                got = _aio.run_coroutine_threadsafe(
                    _connect_batch(batch), lt.loop
                ).result(timeout=60)
                if not got:
                    errors.append(f"conn ramp stalled at {len(conns)}")
                    return
                conns.extend(got)

    try:
        # Warm one signature so the liveness wave is pure cache hits.
        warm = jobs[0]
        wc = lsp.Client("127.0.0.1", port, params)
        try:
            got = client_mod.request_once(
                wc, warm[0], warm[2], lower=warm[1], timeout=args.ol_timeout
            )
        finally:
            wc.close()
        if got != oracle[warm]:
            errors.append(f"warm job wrong: got {got}, want {oracle[warm]}")
        ramp_to(target // 2)
        threads_half = threading.active_count()
        ramp_to(target)
        threads_full = threading.active_count()
        rss_kb = _rss_kb()
        # Liveness proof: every ramped conn completes a bit-exact round
        # trip of the warmed (cached) signature — full duplex, zero
        # device work, O(conns) only on the wire.
        if kind == "threaded":
            results = []
            for c in conns:
                try:
                    results.append(
                        client_mod.request_once(
                            c, warm[0], warm[2], lower=warm[1],
                            timeout=args.ol_timeout,
                        )
                    )
                except (lsp.LspError, TimeoutError):
                    results.append(None)
        else:
            results = _aio.run_coroutine_threadsafe(
                _verify_all(warm), lt.loop
            ).result(timeout=args.ol_timeout + 60)
        live = sum(1 for g in results if g == oracle[warm])
        # The gauge is published by the serve ticker (0.05 s cadence) —
        # a loopback ramp can finish inside one tick, so give it a few
        # beats before stamping the server-side corroboration.
        time.sleep(0.25)
        gauge_conns = METRICS.gauge("gw.conns_live")
        open_loop = _open_loop_phase(
            kind, port, params, jobs, oracle, args, errors, lt=lt
        )
        repeat_zero = sub_zero = None
        if kind == "async":
            repeat_zero, sub_zero = _async_probes(
                engine, port, params, lt, jobs, oracle, args, errors
            )
    finally:
        try:
            if kind == "threaded":
                for c in conns:
                    try:
                        c.close()
                    except lsp.LspError:
                        pass
            elif conns:
                for s in range(0, len(conns), 100):
                    _aio.run_coroutine_threadsafe(
                        _close_batch(conns[s:s + 100]), lt.loop
                    ).result(timeout=30)
        except Exception:
            pass  # teardown best-effort: the server close below reaps conns
        close_fn()
        if lt is not None:
            lt.stop()
    if miners.failed.is_set():
        errors.append("a miner's search failed (its error is on stderr)")
    if errors:
        raise RuntimeError(f"conn-scale {kind} leg failed: " + "; ".join(errors[:5]))
    stamp = {
        "ingress": kind,
        "conns_target": target,
        "conns_live": live,
        "gw_conns_live_gauge": gauge_conns,
        "threads_at_half_ramp": threads_half,
        "threads_at_full_ramp": threads_full,
        "threads_flat": threads_full <= threads_half,
        "rss_kb": rss_kb,
        "open_loop": open_loop,
        "launches": launches(),
    }
    if kind == "async":
        stamp["repeat_zero_chunks"] = repeat_zero
        stamp["subrange_zero_chunks"] = sub_zero
    return stamp


def _conn_scale_main(jobs, distinct, args, oracle) -> int:
    """The --conn-scale bench pair: threaded facade vs
    async ingress on the same seeded workload."""
    thr = _conn_scale_leg("threaded", jobs, oracle, args)
    log(f"threaded leg: {thr}")
    asy = _conn_scale_leg("async", jobs, oracle, args)
    log(f"async leg: {asy}")
    multiple = (
        round(asy["conns_live"] / thr["conns_live"], 2)
        if thr["conns_live"] else None
    )
    out = {
        "metric": "conn_scale_async_conn_multiple",
        "value": multiple,
        "unit": "x live conns vs threaded facade",
        "workload": args.wl_name,
        "mode": "conn-scale",
        "jobs": len(jobs),
        "distinct_signatures": len(distinct),
        "max_nonce": args.max_nonce,
        "miners": args.miners,
        "seed": args.seed,
        "fast": bool(args.fast),
        "open_loop_rate": args.open_loop,
        "threaded": thr,
        "async": asy,
        "repeat_zero_chunks": asy.get("repeat_zero_chunks"),
        "subrange_zero_chunks": asy.get("subrange_zero_chunks"),
        **run_stamp(args, args.oracle_fn),
    }
    print(json.dumps(out), flush=True)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, checked, with ``--fast``'s limits applied."""
    ap = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch.tools.loadgen",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=64)
    ap.add_argument("--dup", type=float, default=0.5,
                    help="fraction of jobs repeating an earlier signature")
    ap.add_argument("--max-nonce", type=int, default=60_000)
    ap.add_argument("--miners", type=int, default=2)
    ap.add_argument("--min-chunk", type=int, default=2000)
    ap.add_argument("--cache-size", type=int, default=1024)
    ap.add_argument("--max-active", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the bare-scheduler comparison leg")
    ap.add_argument("--overlap", action="store_true",
                    help="interval-store bench: nested/overlapping ranges, "
                         "SpanStore leg vs exact-match-cache leg")
    ap.add_argument("--federation", type=int, default=0, metavar="N",
                    help="federation bench: overlap-heavy load sprayed "
                         "across N in-process gateway replicas "
                         "(consistent-hash routing + span gossip) vs the "
                         "same load on 1 replica; stamps the repeat and "
                         "cross-replica zero-chunk probes")
    ap.add_argument("--trace", metavar="FILE", default=None,
                    help="arm the structured event log during the gateway "
                         "leg and write it here (python -m tools.trace)")
    ap.add_argument("--trace-overhead", action="store_true",
                    help="run the gateway leg a second time with tracing "
                         "armed and report the jobs/s overhead")
    ap.add_argument("--telemetry", action="store_true",
                    help="arm the fleet metrics plane during the gateway "
                         "leg (in-process TelemetryHub + exporter) and "
                         "stamp the fleet-merged histograms and SLO "
                         "verdicts into the JSON line")
    ap.add_argument("--telemetry-overhead", action="store_true",
                    help="also run an un-telemetered gateway leg and report "
                         "the jobs/s overhead — the telemetered leg runs "
                         "FIRST (same leg-order discipline as "
                         "--trace-overhead: warmup bias inflates, never "
                         "masks, the overhead)")
    ap.add_argument("--fleet-log", metavar="FILE", default=None,
                    help="with --telemetry/--telemetry-overhead: the hub "
                         "appends its merged view here as JSONL (the "
                         "server's --fleet-log= format; python -m tools.dash "
                         "reads it)")
    ap.add_argument("--workload", default=None, metavar="NAME",
                    help="registered range-fold workload to serve/bench "
                         "(default: the frozen sha256d contract; env "
                         "BMT_WORKLOAD)")
    ap.add_argument("--backend", default="auto",
                    help="the miners' rung: auto (the cuda rung on a card, "
                         "the default), cuda, or cpu (the native host tier); "
                         "with no card, only a host tier runs")
    ap.add_argument("--oracle", choices=ORACLES, default="hashlib",
                    help="the expected Results: hashlib (the workload's "
                         "min_range, the default) or card (the port's "
                         "sweep_min_hash on the card, each distinct "
                         "signature once before the first leg; needed past "
                         "~1e8 nonces a job)")
    ap.add_argument("--open-loop", type=float, default=None, metavar="RATE",
                    help="open-loop bench: Poisson arrivals at RATE req/s "
                         "for --duration seconds against the async "
                         "event-loop ingress — shed rate and p99 under "
                         "saturation, the way production traffic "
                         "actually arrives")
    ap.add_argument("--duration", type=float, default=8.0,
                    help="open-loop measurement window (seconds)")
    ap.add_argument("--conn-scale", action="store_true",
                    help="ingress bench pair: threaded-facade leg vs "
                         "async-ingress leg — live conns, thread counts, "
                         "RSS, open-loop shed/p99 per leg")
    ap.add_argument("--conns", type=int, default=50,
                    help="threaded-facade leg live-conn ramp target "
                         "(the async leg ramps --conn-multiple x this)")
    ap.add_argument("--conn-multiple", type=int, default=10,
                    help="async leg conn multiple over the threaded leg")
    ap.add_argument("--ol-queue", type=int, default=32,
                    help="gateway max_queued for the ingress benches (the "
                         "overload lever: beyond it requests shed)")
    ap.add_argument("--ol-timeout", type=float, default=20.0,
                    help="per-request deadline in the ingress benches")
    ap.add_argument("--ol-max-threads", type=int, default=64,
                    help="threaded-leg open-loop request-thread cap "
                         "(arrivals past it are turned away client-side)")
    ap.add_argument("--fast", action="store_true",
                    help="CPU-test preset: small jobs, done in well under 30 s")
    args = ap.parse_args(argv)
    if (args.telemetry_overhead and (args.trace or args.trace_overhead)) or (
        args.trace_overhead and args.telemetry
    ):
        # An overhead number divides the armed leg by ONE bare leg; if the
        # armed leg carries the OTHER plane too, the stamped number
        # reports their combined cost.  Measure one plane at a time
        # (plain --telemetry with --trace is fine: both armed, no
        # overhead attribution happens).
        ap.error("an overhead measurement cannot run with the other "
                 "plane armed (--trace/--trace-overhead vs --telemetry/"
                 "--telemetry-overhead): measure one plane at a time")
    if args.conn_scale and args.open_loop is None:
        args.open_loop = 40.0  # the pair always takes open-loop load
    if args.open_loop is not None and args.open_loop <= 0:
        ap.error("--open-loop RATE must be > 0 (Poisson arrivals/sec)")
    if args.open_loop is not None and (args.federation or args.overlap):
        ap.error("--open-loop/--conn-scale are their own modes — run them "
                 "without --federation/--overlap")
    if args.fast:
        args.jobs = min(args.jobs, 24)
        args.max_nonce = min(args.max_nonce, 4000)
        args.timeout = min(args.timeout, 60.0)
        args.duration = min(args.duration, 3.0)
        if args.open_loop is not None:
            args.open_loop = min(args.open_loop, 40.0)
        args.conns = min(args.conns, 20)
        args.ol_timeout = min(args.ol_timeout, 15.0)
    try:
        wl = workloads_mod.resolve(
            args.workload or os.environ.get("BMT_WORKLOAD") or None
        )
    except ValueError as e:
        ap.error(str(e))
    # None = the frozen default's byte-identical scheduler/miner paths;
    # the JSON line always stamps the resolved name so trajectories with
    # different workloads never get compared as one series.
    args.wl = workloads_mod.resolve_nondefault(wl)
    args.wl_name = wl.name
    return args


def jobs_of(args) -> list:
    """The seeded job list of ``args``'s mode."""
    if args.federation:
        # Overlap-heavy workload over a wider key family, so the ring has
        # keys to spread and the duplicates still collapse per home cell.
        return build_overlap_workload(args, n_datas=max(3, 2 * args.federation))
    if args.overlap:
        return build_overlap_workload(args)
    return build_workload(args)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        # The rung and the oracle first: with no card, and no request for
        # the host, the tool stops here and names the missing card.
        args.tier = resolve_tier(args.backend, args.wl)
        args.oracle_fn = Oracle(args.oracle, args.wl)
    except ValueError as e:
        print(f"loadgen: {e}", file=sys.stderr, flush=True)
        return 2

    jobs = jobs_of(args)
    distinct = sorted(set(jobs))
    log(f"workload: {len(jobs)} jobs, {len(distinct)} distinct signatures, "
        f"{args.clients} clients, {args.miners} miners on the {args.tier} "
        f"tier, {args.oracle} oracle")
    oracle = {sig: args.oracle_fn(*sig) for sig in distinct}

    # Throwaway warm-up leg: pay the one-time costs (the kernels' and the
    # native sweep's builds, the CUDA context, transport/module init) so
    # neither timed leg absorbs them.
    run_leg(False, jobs[: min(4, len(jobs))], args, oracle)

    if args.federation:
        return _federation_main(jobs, distinct, args, oracle)
    if args.overlap:
        return _overlap_main(jobs, distinct, args, oracle)
    if args.conn_scale:
        return _conn_scale_main(jobs, distinct, args, oracle)
    if args.open_loop is not None:
        return _open_loop_main(jobs, distinct, args, oracle)

    # Fleet metrics plane: a hub + exporter alongside the
    # gateway leg — the exporter ships the process registry at a bench-
    # aggressive cadence so the measured leg carries the real export
    # cost, and the hub's self-tick runs the merge + SLO burn evaluation
    # concurrently with serving (the overhead being measured).
    telem_on = args.telemetry or args.telemetry_overhead
    hub = exporter = None
    if telem_on:
        # Every tick publishes, the final one below included, so a fleet
        # log ends with the state this run stamps (with no log, a publish
        # has no sink and costs nothing).
        hub = TelemetryHub(
            0, source=None, slo=SloEngine(default_slos()),
            fleet_log=args.fleet_log, publish_interval=0.0,
        ).start(self_tick=0.2)
        exporter = TelemetryExporter(
            "127.0.0.1", hub.port, "miner-pool", interval=0.2
        ).start()
        log(f"telemetry: hub on :{hub.port}, exporting every 0.2s")

    traced = plain = None
    with ExitStack() as stack:
        if args.trace:
            stack.enter_context(tracing(args.trace))
        elif args.trace_overhead:
            # No sink requested: trace into a throwaway temp file so the
            # flush path is part of the measured cost too.
            tf = stack.enter_context(
                tempfile.NamedTemporaryFile(suffix=".trace.jsonl")
            )
            stack.enter_context(tracing(tf.name))
        gw = run_leg(True, jobs, args, oracle)
    log(f"gateway leg: {gw['jobs_per_sec']:.2f} jobs/s over "
        f"{gw['wall_s']:.2f}s; counters {gw['counters']}")
    fleet_stamp = slo_stamp = None
    if telem_on:
        # One final tick AFTER the leg so the stamped state includes the
        # exporter's last beats, then tear the plane down — the plain
        # comparison leg below must run un-telemetered.
        state = hub.tick()
        exporter.stop()
        hub.close()
        fleet_stamp = {
            "sources": state["sources"],
            "stale_sources": state["stale_sources"],
            "hists": state["hists"],
        }
        slo_stamp = {
            s["name"]: {
                "ok": s["ok"],
                "burn_fast": s["burn_fast"],
                "burn_slow": s["burn_slow"],
            }
            for s in state.get("slo", {}).get("slos", [])
        }
        log(f"telemetry: {state['sources']} source(s), "
            f"alerts={state.get('slo', {}).get('alerts', [])}")
    if args.trace_overhead or args.telemetry_overhead:
        # The overhead numbers (tracing, telemetry):
        # the SAME workload with the plane armed vs bare, the ARMED leg
        # always first whatever flag spelling armed it — any residual
        # leg-order warmup bias then inflates the reported overhead,
        # never masks it (conservative for a "<5%" acceptance claim).
        # One bare leg serves both comparisons.
        if args.trace_overhead:
            traced = gw
        plain = run_leg(True, jobs, args, oracle)
        log(f"bare gateway leg: {plain['jobs_per_sec']:.2f} jobs/s "
            f"over {plain['wall_s']:.2f}s")
    base = None
    if not args.no_baseline:
        base = run_leg(False, jobs, args, oracle)
        log(f"baseline leg: {base['jobs_per_sec']:.2f} jobs/s over "
            f"{base['wall_s']:.2f}s")

    out = {
        "metric": "loadgen_jobs_per_sec",
        "value": round(gw["jobs_per_sec"], 3),
        "unit": "jobs/s",
        "workload": args.wl_name,
        "clients": args.clients,
        "jobs": len(jobs),
        "distinct_signatures": len(distinct),
        "dup_fraction": args.dup,
        "max_nonce": args.max_nonce,
        "miners": args.miners,
        "seed": args.seed,
        "fast": bool(args.fast),
        "wall_s": round(gw["wall_s"], 3),
        "repeat_zero_chunks": gw["repeat_zero_chunks"],
        "latency_s": gw["latency_s"],
        "gateway_counters": {
            k: v for k, v in gw["counters"].items() if k.startswith("gateway.")
        },
        "swept_nonces": gw["counters"].get("sched.nonces_swept", 0),
        "launches": gw["launches"],
        **run_stamp(args, args.oracle_fn),
        **(
            {
                "traced_jobs_per_sec": round(traced["jobs_per_sec"], 3),
                "trace_overhead": round(
                    1.0 - traced["jobs_per_sec"] / plain["jobs_per_sec"], 4
                )
                if plain["jobs_per_sec"] > 0
                else None,
            }
            if traced is not None and plain is not None
            else {}
        ),
        **(
            {"fleet": fleet_stamp, "slo": slo_stamp}
            if fleet_stamp is not None
            else {}
        ),
        **(
            {
                "telemetry_overhead": round(
                    1.0 - gw["jobs_per_sec"] / plain["jobs_per_sec"], 4
                )
                if plain["jobs_per_sec"] > 0
                else None
            }
            if args.telemetry_overhead and plain is not None
            else {}
        ),
        **(
            {
                "baseline_jobs_per_sec": round(base["jobs_per_sec"], 3),
                "baseline_wall_s": round(base["wall_s"], 3),
                "baseline_swept_nonces": base["counters"].get(
                    "sched.nonces_swept", 0
                ),
                "baseline_launches": base["launches"],
                "speedup_vs_baseline": round(
                    gw["jobs_per_sec"] / base["jobs_per_sec"], 3
                )
                if base["jobs_per_sec"] > 0
                else None,
            }
            if base is not None
            else {}
        ),
    }
    print(json.dumps(out), flush=True)
    return 0


def _federation_main(jobs, distinct, args, oracle) -> int:
    """The --federation bench: the same duplicate/overlap-heavy workload
    through N replicas vs 1 replica (both federation shells, so the delta
    isolates the replication), plus the zero-chunk probes.  One JSON line."""
    n = max(2, args.federation)
    fed = run_federation_leg(n, jobs, args, oracle)
    log(f"federation leg ({n} replicas): {fed['jobs_per_sec']:.2f} jobs/s "
        f"over {fed['wall_s']:.2f}s; counters {fed['counters']}")
    single = run_federation_leg(1, jobs, args, oracle)
    log(f"single-replica leg: {single['jobs_per_sec']:.2f} jobs/s over "
        f"{single['wall_s']:.2f}s")

    out = {
        "metric": "loadgen_federation_jobs_per_sec",
        "value": round(fed["jobs_per_sec"], 3),
        "unit": "jobs/s",
        "workload": args.wl_name,
        "mode": "federation",
        "replicas": n,
        "clients": args.clients,
        "jobs": len(jobs),
        "distinct_signatures": len(distinct),
        "max_nonce": args.max_nonce,
        "miners_per_replica": args.miners,
        "seed": args.seed,
        "fast": bool(args.fast),
        "wall_s": round(fed["wall_s"], 3),
        "latency_s": fed["latency_s"],
        "repeat_zero_chunks": fed["repeat_zero_chunks"],
        "cross_replica_zero_chunks": fed["cross_replica_zero_chunks"],
        "gossip_max_frame_bytes": fed["gossip_max_frame_bytes"],
        "wire_ceiling_bytes": 1000,
        "federation_counters": {
            k: v for k, v in fed["counters"].items()
            if k.startswith(("federation.", "gateway."))
        },
        "swept_nonces": fed["counters"].get("sched.nonces_swept", 0),
        "launches": fed["launches"],
        "single_launches": single["launches"],
        **run_stamp(args, args.oracle_fn),
        "single_jobs_per_sec": round(single["jobs_per_sec"], 3),
        "single_wall_s": round(single["wall_s"], 3),
        "single_swept_nonces": single["counters"].get("sched.nonces_swept", 0),
        "single_repeat_zero_chunks": single["repeat_zero_chunks"],
        "scaling_vs_single": round(
            fed["jobs_per_sec"] / single["jobs_per_sec"], 3
        )
        if single["jobs_per_sec"] > 0
        else None,
    }
    print(json.dumps(out), flush=True)
    return 0


def _overlap_main(jobs, distinct, args, oracle) -> int:
    """The --overlap bench: interval-store leg vs exact-match-cache leg
    (both gateways — the delta isolates the span store), one JSON line
    with both legs' swept nonces and their reduction."""
    spans = run_leg(True, jobs, args, oracle, spans_on=True)
    log(f"interval-store leg: {spans['jobs_per_sec']:.2f} jobs/s over "
        f"{spans['wall_s']:.2f}s; counters {spans['counters']}")
    exact = run_leg(True, jobs, args, oracle, spans_on=False)
    log(f"exact-cache leg: {exact['jobs_per_sec']:.2f} jobs/s over "
        f"{exact['wall_s']:.2f}s; counters {exact['counters']}")

    spans_swept = spans["counters"].get("sched.nonces_swept", 0)
    exact_swept = exact["counters"].get("sched.nonces_swept", 0)
    out = {
        "metric": "loadgen_overlap_jobs_per_sec",
        "value": round(spans["jobs_per_sec"], 3),
        "unit": "jobs/s",
        "workload": args.wl_name,
        "mode": "overlap",
        "clients": args.clients,
        "jobs": len(jobs),
        "distinct_signatures": len(distinct),
        "max_nonce": args.max_nonce,
        "miners": args.miners,
        "seed": args.seed,
        "fast": bool(args.fast),
        "wall_s": round(spans["wall_s"], 3),
        "repeat_zero_chunks": spans["repeat_zero_chunks"],
        "subrange_zero_chunks": spans["subrange_zero_chunks"],
        "latency_s": spans["latency_s"],
        "exact_latency_s": exact["latency_s"],
        "span_counters": {
            k: v for k, v in spans["counters"].items()
            if k.startswith("gateway.")
        },
        "swept_nonces": spans_swept,
        "launches": spans["launches"],
        "exact_launches": exact["launches"],
        **run_stamp(args, args.oracle_fn),
        "exact_jobs_per_sec": round(exact["jobs_per_sec"], 3),
        "exact_wall_s": round(exact["wall_s"], 3),
        "exact_swept_nonces": exact_swept,
        "swept_reduction": round(1.0 - spans_swept / exact_swept, 3)
        if exact_swept > 0
        else None,
        "speedup_vs_exact": round(
            spans["jobs_per_sec"] / exact["jobs_per_sec"], 3
        )
        if exact["jobs_per_sec"] > 0
        else None,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
