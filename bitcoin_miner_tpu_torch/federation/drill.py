"""Seeded federation resilience drills.

In-process drills over real :class:`Replica` cells on loopback LSP —
the membership plane's acceptance scenarios:

- ``shed-storm`` — a cell flooded into SHEDDING via admission
  backpressure stays routable and is never suspected or marked down
  (``fed.false_suspicions == 0``: backpressure is not death);
- ``drain-handoff`` — a cell drained mid-sweep hands its orphan stash
  to the ring successor; the resubmitted job answers bit-exact with
  STRICTLY fewer nonces swept than a from-scratch control (stashed
  progress honored);
- ``death-detect`` — an abruptly-killed cell is suspected, then
  declared dead inside the confirmation window, by missed heartbeats
  alone (zero forward-path connect timeouts spent);
- ``ack-retransmit`` — a gossip partition heals and the peer converges
  via ack-gap retransmit with the anti-entropy full sync disabled
  (``full_every=10**9``): lost deltas no longer wait for it.

Every drill returns ``{"name", "ok", ...evidence..., "miners",
"errors"}``; ``run_all`` runs the lot.  Counters are process-global, so
drills snapshot deltas and run one fleet at a time.

This is the port's copy of the reference package's ``federation/drill.py``,
with deliberate differences, as in the port's ``apps/drill.py``:

- The miners' search is ``make_search(backend)`` with ``backend="auto"``
  by default, the cuda rung on a card; the reference's drill sweeps on
  the host (``make_search("cpu")``).  ``miners`` reports each miner's
  tier and the chunks it swept.
- The drain drill's slow miners are the miner binary's
  :class:`~bitcoin_miner_tpu_torch.apps.miner._PacedSearch` over that
  search (``rate`` nonces/s each), where the reference sleeps in a
  hashlib search.
- ``shed-storm`` ends with one job for an r0-homed key sent to the
  storming r1: forwarded to r0, swept by its miner, bit-exact.
- Each drill takes ``hi=`` (the job's upper nonce), ``backend=`` and
  ``oracle=`` (``(data, lo, hi) -> (hash, nonce)``, the expected Result);
  the defaults are the reference's sizes and its hashlib
  ``min_hash_range``, so on the CPU the drills are the reference's, and on
  the card they can run real ranges.
- A search that raises (a kernel that fails to build or launch) ends the
  drill at once: it returns ``ok`` False with the error in ``errors``.
  No host tier answers in the miner's place.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from .. import lsp
from ..apps import client as client_mod
from ..apps import miner as miner_mod
from ..apps.drill import _MinerSearch
from ..apps.scheduler import Scheduler
from ..bitcoin.hash import min_hash_range
from ..lspnet.chaos import CHAOS
from ..utils.metrics import METRICS
from .membership import ALIVE, DEAD, LOAD_SHEDDING
from .replica import Replica
from .ring import Ring

DRILLS = ("shed-storm", "drain-handoff", "death-detect", "ack-retransmit")

_PARAMS = lsp.Params(epoch_limit=5, epoch_millis=200, window_size=5)

Oracle = Callable[[str, int, int], Tuple[int, int]]


class _SearchFailed(Exception):
    """A drilled miner's search raised: the drill ends here."""


def _wait(pred: Callable[[], bool], timeout: float, interval: float = 0.05,
          abort: Optional[threading.Event] = None) -> bool:
    """Poll ``pred`` until it holds or ``timeout`` passes; a set ``abort``
    (a failed search) raises :class:`_SearchFailed` at once."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        if abort is not None and abort.is_set():
            raise _SearchFailed()
        time.sleep(interval)
    return pred()


def _free_port() -> int:
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Fleet:
    """Two-replica in-process federation whose miners search on
    ``backend`` (a drill may pace them slow enough to interrupt)."""

    def __init__(self, backend: str = "auto", **kw) -> None:
        names = ["r0", "r1"]
        self.backend = backend
        self.failed = threading.Event()
        self.errors: List[str] = []
        self.searches: List[_MinerSearch] = []
        fed_ports = {nm: _free_port() for nm in names}
        per_cell = kw.pop("per_cell", {})
        self.replicas: Dict[str, Replica] = {}
        for nm in names:
            peers = {o: ("127.0.0.1", fed_ports[o]) for o in names if o != nm}
            self.replicas[nm] = Replica(
                nm,
                peers,
                fed_port=fed_ports[nm],
                params=_PARAMS,
                scheduler=Scheduler(min_chunk=kw.get("min_chunk", 500)),
                gossip_interval=kw.get("gossip_interval", 0.15),
                suspect_misses=kw.get("suspect_misses", 3.0),
                confirm_misses=kw.get("confirm_misses", 3.0),
                gossip_full_every=kw.get("gossip_full_every", 4),
                tick_interval=0.05,
                peer_down_ttl=kw.get("peer_down_ttl", 2.0),
                forward_timeout=kw.get("forward_timeout", 15.0),
                **per_cell.get(nm, {}),
            ).start()
        self._miners: List["lsp.Client"] = []

    def add_miner(self, name: str, rate: Optional[float] = None) -> None:
        """One miner on ``name``'s public port, searching on the fleet's
        backend; ``rate`` paces it to that many nonces/s."""
        label = f"miner-{name}"
        found = _MinerSearch(
            f"{label}-{len(self.searches)}", self.backend, None,
            self.failed, self.errors,
        )
        self.searches.append(found)
        search = found
        if rate is not None:
            search = miner_mod._PacedSearch(miner_mod._PoolSearch(found), rate)
        c = lsp.Client("127.0.0.1", self.replicas[name].port, _PARAMS, label=label)
        threading.Thread(
            target=miner_mod.run_miner, args=(c, search), daemon=True,
        ).start()
        self._miners.append(c)

    def wait(self, pred: Callable[[], bool], timeout: float) -> bool:
        return _wait(pred, timeout, abort=self.failed)

    def request_at(
        self, name: str, data: str, hi: int, lower: int = 0,
        timeout: Optional[float] = None,
    ) -> Optional[Tuple[int, int]]:
        """One client job at ``name``'s public port; None if the conn is
        lost or ``timeout`` passes.  A failed search raises
        :class:`_SearchFailed` at once."""
        c = lsp.Client("127.0.0.1", self.replicas[name].port, _PARAMS)
        box: dict = {}

        def ask() -> None:
            try:
                box["got"] = client_mod.request_once(
                    c, data, hi, lower=lower, timeout=timeout
                )
            except (lsp.LspError, TimeoutError):
                box["got"] = None

        t = threading.Thread(target=ask, daemon=True)
        t.start()
        try:
            while t.is_alive():
                t.join(timeout=0.05)
                if self.failed.is_set():
                    raise _SearchFailed()
            return box.get("got")
        finally:
            try:
                c.close()
            except lsp.LspError:
                pass

    def home_key(self, name: str, prefix: str) -> str:
        return self.home_keys(name, prefix, 1)[0]

    def home_keys(self, name: str, prefix: str, n: int) -> List[str]:
        ring = Ring(list(self.replicas))
        out: List[str] = []
        for i in range(4096):
            key = f"{prefix}{i}"
            if ring.home(key) == name:
                out.append(key)
                if len(out) == n:
                    return out
        raise RuntimeError(f"could not find {n} keys homed on {name}")

    def report(self, out: dict) -> dict:
        """``out`` with the miners' tiers and chunks and the search
        errors; any error makes it not ``ok``."""
        out["miners"] = {
            s.label: {"tier": s.tier, "chunks": s.chunks} for s in self.searches
        }
        out["errors"] = list(self.errors)
        out["ok"] = bool(out.get("ok")) and not self.errors
        return out

    def close(self) -> None:
        for rep in self.replicas.values():
            rep.close()


# ------------------------------------------------------------------- drills


def drill_shed_storm(
    seed: int = 1, *, hi: int = 10_000, backend: str = "auto",
    oracle: Optional[Oracle] = None,
) -> dict:
    """Admission-flood one cell into SHEDDING: its peer must keep it
    ALIVE (zero false suspicions), keep it in the routing order, and
    never mark it down.  ``hi`` is each storm job's upper nonce.  Then,
    with the storm still squatting r1, one job ``[0, hi]`` for an r0-homed
    key sent to r1 is forwarded to r0 and answered bit-exact against
    ``oracle`` (the reference's drill stops at the peer's view; this job
    is what puts the miners' rung on the drill's path)."""
    oracle = oracle or min_hash_range
    before = METRICS.snapshot()
    fleet = _Fleet(backend, per_cell={
        # r1: tiny admission so the storm sheds fast; no miners, so the
        # storm jobs squat the queue instead of completing.
        "r1": dict(rate=0.5, max_queued=2),
    })
    storm_conns: List["lsp.Client"] = []
    try:
        r0, r1 = fleet.replicas["r0"], fleet.replicas["r1"]
        storm_keys = fleet.home_keys("r1", "storm", 24)
        fleet.add_miner("r0")
        # Let both sides hear a healthy heartbeat first.
        assert fleet.wait(lambda: r0.membership.fresh("r1"), 5.0), "no heartbeat"
        # The storm: distinct r1-home signatures flood r1's public port —
        # enough past the burst allowance that the tiny backlog overflows
        # into real sheds (each key must be r1-HOME or it would forward
        # out instead of loading r1's admission plane).
        from ..bitcoin.message import Message

        for skey in storm_keys:
            try:
                c = lsp.Client("127.0.0.1", r1.port, _PARAMS)
            except (lsp.LspError, OSError):
                continue
            c.write(Message.request(skey, 0, hi).marshal())
            storm_conns.append(c)
        shed_seen = fleet.wait(lambda: r1.gateway.shed_count > 0, 10.0)
        # The peer's view during the storm: SHEDDING travels on the
        # heartbeat; liveness never degrades.
        shedding_seen = fleet.wait(
            lambda: r0.membership.load("r1") == LOAD_SHEDDING, 5.0
        )
        # Several suspicion windows' worth of beats, sampling the peer's
        # point-in-time view: flap damping must hold
        # SHEDDING across evidence-free beats instead of oscillating the
        # fed.peer_state gauge OK<->SHEDDING on alternate gossip rounds.
        flaps = 0
        last = None
        t_end = time.monotonic() + 1.0
        while time.monotonic() < t_end:
            cur = r0.membership.load("r1")
            if last == LOAD_SHEDDING and cur != LOAD_SHEDDING:
                flaps += 1
            last = cur
            time.sleep(0.05)
        liveness = r0.membership.liveness("r1")
        with r0._down_lock:
            marked_down = "r1" in r0._down
        still_routable = "r1" in r0.membership.order(["r1"])
        calm = fleet.home_key("r0", "calm")
        want = oracle(calm, 0, hi)
        served = fleet.request_at("r1", calm, hi, timeout=30.0) == want
        after = METRICS.snapshot()
        false_susp = after.get("fed.false_suspicions", 0) - before.get(
            "fed.false_suspicions", 0
        )
        ok = (
            shed_seen
            and shedding_seen
            and liveness == ALIVE
            and not marked_down
            and still_routable
            and false_susp == 0
            and flaps <= 1
            and served
        )
        return fleet.report({
            "name": "shed-storm",
            "ok": bool(ok),
            "shed_seen": bool(shed_seen),
            "shedding_state_seen": bool(shedding_seen),
            "liveness_during_storm": liveness,
            "marked_down": bool(marked_down),
            "still_routable": bool(still_routable),
            "false_suspicions": int(false_susp),
            # Flap damping: one final SHEDDING->OK transition (the storm
            # ending inside the sample window) is legitimate; oscillation
            # is not.
            "shed_flaps": int(flaps),
            "forwarded_bit_exact": bool(served),
        })
    except _SearchFailed:
        return fleet.report({"name": "shed-storm", "ok": False})
    finally:
        for c in storm_conns:
            try:
                c.close()
            except lsp.LspError:
                pass
        fleet.close()


def drill_drain_handoff(
    seed: int = 1, *, hi: int = 20_000, backend: str = "auto",
    oracle: Optional[Oracle] = None, rate: float = 5_000.0,
) -> dict:
    """Drain a cell mid-sweep; the successor resumes the resubmitted job
    from the handed-off stash: bit-exact, strictly fewer nonces swept
    than a from-scratch control of the same shape.  ``rate`` paces each
    of the two miners (nonces/s): pick it so ``[0, hi]`` takes seconds."""
    oracle = oracle or min_hash_range
    handoff0 = METRICS.get("fed.handoff_jobs")
    fleet = _Fleet(backend, min_chunk=200, gossip_interval=0.15)
    try:
        r0, r1 = fleet.replicas["r0"], fleet.replicas["r1"]
        key = fleet.home_key("r1", "drain")
        want = oracle(key, 0, hi)
        # Honest-but-slow miners: the sweep takes ~hi / (2 rate) s,
        # interruptible.
        fleet.add_miner("r1", rate)
        fleet.add_miner("r0", rate)
        assert fleet.wait(lambda: r0.membership.fresh("r1"), 5.0), "no heartbeat"
        box: dict = {}

        def ask() -> None:
            try:
                box["got"] = fleet.request_at("r1", key, hi)
            except _SearchFailed:
                pass

        t = threading.Thread(target=ask, daemon=True)
        swept0 = METRICS.get("sched.nonces_swept")
        t.start()
        # Mid-sweep: some chunks done (a fiftieth of the range), job not
        # finished.
        assert fleet.wait(
            lambda: METRICS.get("sched.nonces_swept") - swept0 >= hi // 50, 30.0
        ), "sweep never started"
        r1.drain(reason="drill")
        r1.close()
        t.join(timeout=10.0)
        handed = METRICS.get("fed.handoff_jobs") - handoff0
        # The dead cell's client resubmits through the survivor.
        swept1 = METRICS.get("sched.nonces_swept")
        got = fleet.request_at("r0", key, hi, timeout=60.0)
        resumed_swept = METRICS.get("sched.nonces_swept") - swept1
        # From-scratch control: same shape, fresh key, nothing stashed.
        ckey = fleet.home_key("r0", "scratch")
        cwant = oracle(ckey, 0, hi)
        swept2 = METRICS.get("sched.nonces_swept")
        cgot = fleet.request_at("r0", ckey, hi, timeout=60.0)
        scratch_swept = METRICS.get("sched.nonces_swept") - swept2
        ok = (
            got == want
            and cgot == cwant
            and handed >= 1
            and resumed_swept < scratch_swept
        )
        return fleet.report({
            "name": "drain-handoff",
            "ok": bool(ok),
            "bit_exact": got == want,
            "handoff_jobs": int(handed),
            "resumed_nonces_swept": int(resumed_swept),
            "scratch_nonces_swept": int(scratch_swept),
            "strictly_fewer": resumed_swept < scratch_swept,
        })
    except _SearchFailed:
        return fleet.report({"name": "drain-handoff", "ok": False})
    finally:
        fleet.close()


def drill_death_detect(
    seed: int = 1, *, hi: int = 2_000, backend: str = "auto",
    oracle: Optional[Oracle] = None,
) -> dict:
    """SIGKILL-shaped death (abrupt close, no drain): the survivor
    suspects, then declares the peer dead inside the confirmation
    window — on missed heartbeats alone, with zero forward-path connect
    timeouts spent.  Then the dead cell's key, asked for ``[0, hi]`` at
    the survivor, answers locally."""
    oracle = oracle or min_hash_range
    before = METRICS.snapshot()
    fleet = _Fleet(backend, gossip_interval=0.15, suspect_misses=3,
                   confirm_misses=3)
    try:
        r0, r1 = fleet.replicas["r0"], fleet.replicas["r1"]
        fleet.add_miner("r0")
        assert fleet.wait(lambda: r0.membership.fresh("r1"), 5.0), "no heartbeat"
        key = fleet.home_key("r1", "death")
        # Abrupt death: servers vanish, heartbeats stop (the in-process
        # SIGKILL; the federation binary's process drills cover the
        # literal one).
        t_kill = time.monotonic()
        r1.close()
        window = (3 + 3) * 0.15 + 1.5  # suspect + confirm + beat slack
        dead = fleet.wait(
            lambda: r0.membership.liveness("r1") == DEAD, window + 3.0
        )
        detect_s = time.monotonic() - t_kill
        after = METRICS.snapshot()
        suspected = after.get("fed.suspected", 0) - before.get("fed.suspected", 0)
        timeouts = after.get("federation.forward_timeouts", 0) - before.get(
            "federation.forward_timeouts", 0
        )
        # A request for the dead cell's key now skips the corpse outright
        # (DEAD leaves the alive view): answered locally, no connect
        # attempt burned.
        want = oracle(key, 0, hi)
        got = fleet.request_at("r0", key, hi, timeout=30.0)
        after2 = METRICS.snapshot()
        failovers = after2.get("federation.forward_failovers", 0) - before.get(
            "federation.forward_failovers", 0
        )
        ok = (
            dead
            and suspected >= 1
            and timeouts == 0
            and failovers == 0
            and got == want
        )
        return fleet.report({
            "name": "death-detect",
            "ok": bool(ok),
            "declared_dead": bool(dead),
            "detect_s": round(detect_s, 3),
            "suspected": int(suspected),
            "forward_timeouts": int(timeouts),
            "forward_failovers": int(failovers),
            "bit_exact": got == want,
        })
    except _SearchFailed:
        return fleet.report({"name": "death-detect", "ok": False})
    finally:
        fleet.close()


def drill_ack_retransmit(
    seed: int = 1, *, hi: int = 4_000, backend: str = "auto",
    oracle: Optional[Oracle] = None,
) -> dict:
    """Partition one cell's gossip channel, solve ``[0, hi]``, heal: the
    peer converges via ack-gap retransmit with anti-entropy disabled
    (``full_every=10**9``) — no full sync may fire."""
    oracle = oracle or min_hash_range
    CHAOS.reset()
    CHAOS.seed(seed)
    before = METRICS.snapshot()
    fleet = _Fleet(
        backend, min_chunk=500, gossip_interval=0.15, gossip_full_every=10**9,
    )
    try:
        r0, r1 = fleet.replicas["r0"], fleet.replicas["r1"]
        key = fleet.home_key("r1", "ackpart")
        fleet.add_miner("r1")
        want = oracle(key, 0, hi)
        # Wait for a live gossip conn (a heartbeat got through) FIRST:
        # the drill needs the partition to swallow writes on an
        # ESTABLISHED conn — the lost-delta regime acks exist for — not
        # to block the initial connect (which would fail the send
        # locally and never count as a loss).
        assert fleet.wait(lambda: r0.membership.fresh("r1"), 5.0), "no heartbeat"
        # Cut r1's gossip tx BEFORE it solves: the delta beats for the
        # solved spans go into the void (writes enqueue locally; the
        # partition swallows the datagrams, then the conn dies).
        CHAOS.partition("gossip-r1", "both")
        assert fleet.request_at("r1", key, hi) == want

        def r0_covered() -> bool:
            with r0.lock:
                best, gaps = r0.spans.cover(key, 0, hi)
                return best is not None and not gaps

        time.sleep(1.5)  # several beats: nothing may arrive
        stale = not r0_covered()
        CHAOS.heal("gossip-r1")
        converged = fleet.wait(r0_covered, 15.0)
        after = METRICS.snapshot()
        retrans = after.get("gossip.retransmits", 0) - before.get(
            "gossip.retransmits", 0
        )
        fulls = after.get("federation.gossip_full_syncs", 0) - before.get(
            "federation.gossip_full_syncs", 0
        )
        ok = stale and converged and retrans >= 1 and fulls == 0
        return fleet.report({
            "name": "ack-retransmit",
            "ok": bool(ok),
            "stale_while_partitioned": bool(stale),
            "converged_after_heal": bool(converged),
            "retransmits": int(retrans),
            "full_syncs": int(fulls),
            "seed": seed,
        })
    except _SearchFailed:
        return fleet.report({"name": "ack-retransmit", "ok": False})
    finally:
        fleet.close()
        CHAOS.reset()


_RUNNERS = {
    "shed-storm": drill_shed_storm,
    "drain-handoff": drill_drain_handoff,
    "death-detect": drill_death_detect,
    "ack-retransmit": drill_ack_retransmit,
}


def run_fed_drill(name: str, seed: int = 1, **kw) -> dict:
    """Run one named resilience drill; raises ValueError on an unknown
    name.  ``kw`` (``hi``, ``backend``, ``oracle``; ``rate`` for
    ``drain-handoff``) goes to the drill."""
    runner = _RUNNERS.get(name)
    if runner is None:
        raise ValueError(
            f"unknown federation drill {name!r}; valid: {', '.join(DRILLS)}"
        )
    return runner(seed=seed, **kw)


def run_all(seed: int = 1, backend: str = "auto") -> List[dict]:
    """Every drill at its default size, miners on ``backend``."""
    return [run_fed_drill(name, seed=seed, backend=backend) for name in DRILLS]
