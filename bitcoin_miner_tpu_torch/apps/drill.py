"""In-process chaos drill: one seeded fleet run under hostile network weather.

The port's copy of the JAX package's ``apps/drill.py``: assemble a real
client/server/miner fleet over loopback UDP, arm a seeded
network-condition :class:`~bitcoin_miner_tpu_torch.lspnet.chaos.Schedule`
(optionally killing a miner mid-job), and check the final Result bit-exact
against the oracle.  Every random fault decision flows from the drill's
seed, so a failing run is replayable from its ``(scenario, seed)`` pair
alone.

Fleet shape: the server is labeled ``server``, miners ``miner-0..N-1``,
the client ``client-0`` — the names the standard scenarios target.
``miner-0`` runs the plain exit-on-loss lifetime (it is the kill target);
the rest run
:func:`~bitcoin_miner_tpu_torch.apps.miner.run_miner_resilient` and
re-Join through partitions.  The client uses bounded retry-with-resubmit,
so a mid-job client conn loss resumes via the scheduler's orphan stash.

One deliberate difference from the reference: the miners' search is
``make_search(backend)`` with ``backend="auto"`` by default, the cuda rung
on a card, where the reference's drill sweeps on the host.  A search that
raises (a kernel that fails to build or launch) ends the drill at once
with ``ok`` False and the error in :attr:`DrillReport.errors`; no miner
falls back to a host tier.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

from .. import lsp, lspnet
from ..bitcoin.hash import min_hash_range
from ..lspnet.chaos import CHAOS, Schedule, standard_scenarios
from ..utils import trace
from ..utils.metrics import METRICS
from ..workloads import resolve as resolve_workload
from . import client as client_mod
from . import miner as miner_mod
from . import server as server_mod
from .scheduler import Scheduler

#: Counter prefixes whose deltas a drill reports.
_REPORT_PREFIXES = ("chaos.", "miner.", "client.", "sched.")


@dataclass
class DrillReport:
    ok: bool
    expected: Optional[Tuple[int, int]]
    got: Optional[Tuple[int, int]]
    seed: int
    scenario: str
    elapsed: float
    #: METRICS deltas over the drill (chaos./miner./client./sched. keys).
    counters: Dict[str, int] = field(default_factory=dict)
    #: Seconds from the fleet's start to the client's Result (None if none).
    result_s: Optional[float] = None
    #: Per miner label: the tier its search ran on and the chunks it swept.
    miners: Dict[str, dict] = field(default_factory=dict)
    #: Searches that raised, as ``"<label>: <error>"``.
    errors: List[str] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "expected": list(self.expected) if self.expected else None,
            "got": list(self.got) if self.got else None,
            "seed": self.seed,
            "scenario": self.scenario,
            "elapsed_s": round(self.elapsed, 3),
            "counters": self.counters,
            "result_s": self.result_s,
            "miners": self.miners,
            "errors": self.errors,
        }


class _MinerSearch:
    """One drilled miner's search: ``make_search(backend)``, counting the
    chunks it sweeps and recording (then re-raising) any error, which
    ends the drill through ``failed``."""

    def __init__(self, label: str, backend: str, workload, failed: threading.Event,
                 errors: List[str]) -> None:
        self.label = label
        self.tier = miner_mod._resolve_tier(backend, resolve_workload(workload))
        self._search = miner_mod.make_search(backend, workload=workload)
        self.chunks = 0
        self._failed, self._errors = failed, errors

    def __call__(self, data: str, lower: int, upper: int) -> Tuple[int, int]:
        try:
            out = self._search(data, lower, upper)
        except BaseException as e:
            self._errors.append(f"{self.label}: {e!r}")
            self._failed.set()
            raise
        self.chunks += 1
        return out


def run_drill(
    scenario: Union[Schedule, str, None] = None,
    *,
    seed: int = 1,
    data: str = "chaos",
    max_nonce: int = 4000,
    n_miners: int = 2,
    kill_miner_at: Optional[float] = None,
    epoch_millis: int = 100,
    epoch_limit: int = 5,
    window: int = 5,
    min_chunk: int = 400,
    straggler_min_seconds: float = 4.0,
    retries: int = 6,
    timeout: float = 120.0,
    trace_path: Optional[str] = None,
    workload=None,
    backend: str = "auto",
    oracle: Optional[Callable[[str, int, int], Tuple[int, int]]] = None,
) -> DrillReport:
    """Run one seeded fleet-under-chaos drill; see module docstring.

    ``trace_path`` arms the structured event log (utils/trace.py) for the
    drill's duration and flushes it there as JSONL on exit.

    ``workload`` runs the whole drilled fleet — scheduler validation,
    miners, oracle — on a registered range-fold workload; the chaos
    machinery itself is workload-blind.  ``backend``: the miners' rung
    (``apps.miner.make_search``); ``"auto"`` is cuda on a card, ``"cpu"``
    the host sweep.  ``oracle``: ``(data, lo, hi) -> (hash, nonce)`` for
    the expected Result; None is ``min_hash_range`` (or the workload's
    ``min_range``), hashlib over the whole range."""
    from contextlib import nullcontext

    with trace.tracing(trace_path) if trace_path is not None else nullcontext():
        return _drill(
            scenario, seed, data, max_nonce, n_miners, kill_miner_at,
            epoch_millis, epoch_limit, window, min_chunk,
            straggler_min_seconds, retries, timeout, workload, backend, oracle,
        )


def _drill(
    scenario: Union[Schedule, str, None],
    seed: int,
    data: str,
    max_nonce: int,
    n_miners: int,
    kill_miner_at: Optional[float],
    epoch_millis: int,
    epoch_limit: int,
    window: int,
    min_chunk: int,
    straggler_min_seconds: float,
    retries: int,
    timeout: float,
    workload=None,
    backend: str = "auto",
    oracle=None,
) -> DrillReport:
    params = lsp.Params(epoch_limit, epoch_millis, window)
    name = scenario if isinstance(scenario, str) else (
        getattr(scenario, "desc", "") or "custom" if scenario else "clean"
    )
    if isinstance(scenario, str):
        library = standard_scenarios(params.epoch_seconds)
        if scenario not in library:
            raise ValueError(
                f"unknown scenario {scenario!r}; valid: {sorted(library)}"
            )
        scenario = library[scenario]
    # Every miner's search is built before the clock starts: a rung that
    # cannot be resolved raises here, before any thread or socket exists.
    failed = threading.Event()
    errors: List[str] = []
    searches = [
        _MinerSearch(f"miner-{i}", backend, workload, failed, errors)
        for i in range(n_miners)
    ]

    lspnet.reset_faults()
    CHAOS.reset()
    CHAOS.seed(seed)
    before = METRICS.snapshot()
    t0 = time.monotonic()
    kill_timer: Optional[threading.Timer] = None
    stop_miners = threading.Event()  # ends resilient loops at teardown
    result_s: Optional[float] = None

    server = lsp.Server(0, params, label="server")
    sched = Scheduler(
        min_chunk=min_chunk, straggler_min_seconds=straggler_min_seconds,
        workload=workload,
    )
    threading.Thread(
        target=server_mod.serve,
        args=(server, sched),
        kwargs={"tick_interval": 0.2},
        daemon=True,
    ).start()
    try:
        # miner-0: plain exit-on-loss lifetime — the kill target we hold a
        # conn handle for; the rest: resilient reconnect-with-backoff.
        victim = lsp.Client("127.0.0.1", server.port, params, label="miner-0")
        threading.Thread(
            target=miner_mod.run_miner,
            args=(victim, searches[0]),
            daemon=True,
        ).start()
        for i in range(1, n_miners):
            threading.Thread(
                target=miner_mod.run_miner_resilient,
                args=("127.0.0.1", server.port, searches[i]),
                kwargs={
                    "params": params,
                    "max_retries": 12,
                    "backoff_base": 0.1,
                    "backoff_cap": 1.0,
                    "label": f"miner-{i}",
                    "stop": stop_miners,
                },
                daemon=True,
            ).start()
        if kill_miner_at is not None:
            kill_timer = threading.Timer(kill_miner_at, victim.close)
            kill_timer.daemon = True
            kill_timer.start()
        if scenario is not None:
            CHAOS.run(scenario)

        got_box: list = [None]

        def run_client() -> None:
            got_box[0] = client_mod.request_with_retry(
                "127.0.0.1",
                server.port,
                data,
                max_nonce,
                retries=retries,
                backoff_base=0.2,
                params=params,
                label="client-0",
            )

        ct = threading.Thread(target=run_client, daemon=True)
        ct.start()
        deadline = t0 + timeout
        while ct.is_alive() and not failed.is_set() and time.monotonic() < deadline:
            ct.join(timeout=0.02)
        got = None if ct.is_alive() or failed.is_set() else got_box[0]
        if got is not None:
            result_s = time.monotonic() - t0
    finally:
        if kill_timer is not None:
            kill_timer.cancel()
        stop_miners.set()  # before server.close(): no post-drill redialing
        CHAOS.reset()
        lspnet.reset_faults()
        server.close()

    if oracle is not None:
        expected = oracle(data, 0, max_nonce)
    elif workload is None:
        expected = min_hash_range(data, 0, max_nonce)
    else:
        expected = workload.min_range(data, 0, max_nonce)
    after = METRICS.snapshot()
    deltas = {
        k: after[k] - before.get(k, 0)
        for k in sorted(after)
        if k.startswith(_REPORT_PREFIXES) and after[k] != before.get(k, 0)
    }
    return DrillReport(
        ok=got == expected and not errors,
        expected=expected,
        got=got,
        seed=seed,
        scenario=name,
        elapsed=time.monotonic() - t0,
        counters=deltas,
        result_s=result_s,
        miners={s.label: {"tier": s.tier, "chunks": s.chunks} for s in searches},
        errors=list(errors),
    )
