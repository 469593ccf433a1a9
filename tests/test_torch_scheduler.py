"""The port's scheduler and its utilities, held to the JAX package's.

No sockets: a seeded numpy generator drives the reference ``Scheduler`` and
the port's, built with the same keyword arguments, through the same ~200
events — miner joins, client requests, Results that the workload's oracle
computes over each assigned interval (and now and then a wrong one), ticks
of an injected clock, lost miners and clients, stragglers, and a
``checkpoint()`` → fresh scheduler → ``load_checkpoint()`` round trip.
After every event the two action lists are equal as marshalled bytes; at
the end ``stats()``, ``checkpoint()`` and the ``sched.*`` counters they
moved are equal too.  Then ``utils/intervals.py`` and ``utils/wfq.py``
against the reference's on random inputs (hypothesis).
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bitcoin_miner_tpu import workloads as ref_workloads
from bitcoin_miner_tpu.apps.scheduler import Scheduler as RefScheduler
from bitcoin_miner_tpu.utils import intervals as ref_intervals
from bitcoin_miner_tpu.utils import wfq as ref_wfq
from bitcoin_miner_tpu.utils.metrics import METRICS as REF_METRICS
from bitcoin_miner_tpu_torch import workloads
from bitcoin_miner_tpu_torch.apps import Scheduler
from bitcoin_miner_tpu_torch.utils import METRICS, intervals, wfq

DATA = ("cmu440", "Pack my box with five dozen liquor jugs", "zz")
# Chunk sizes at test scale (the default 50,000-nonce minimum would make
# every Result's oracle fold cost tens of milliseconds).
SMALL = dict(min_chunk=20, max_chunk=1000)
CONFIGS = {
    "defaults": (dict(SMALL), None),
    "static_chunks": (dict(min_chunk=100, max_chunk=100, adaptive_chunks=False,
                           steal_factor=0.0), None),
    "adaptive_depth": (dict(SMALL, adaptive_depth=True,
                            dispatch_latency=lambda: 0.7), None),
    "preimage": (dict(SMALL), "preimage"),
    "blake2b64": (dict(SMALL), "blake2b64"),
}


def _pair(kw, workload):
    ref_kw, port_kw = dict(kw), dict(kw)
    if workload is not None:
        ref_kw["workload"] = ref_workloads.get(workload)
        port_kw["workload"] = workloads.get(workload)
    return RefScheduler(**ref_kw), Scheduler(**port_kw)


def _wire(actions):
    return [(cid, m.marshal()) for cid, m in actions]


def _sched_counters(metrics):
    return {k: v for k, v in metrics.snapshot().items() if k.startswith("sched.")}


class _World:
    """The fleet both schedulers serve: live miners with the FIFO of
    (data, lo, hi) chunks each holds, live clients with their jobs."""

    def __init__(self, kw, workload, rng):
        self.kw, self.workload, self.rng = kw, workload, rng
        self.min_range = workloads.get(workload or "sha256d").min_range
        self.ref, self.port = _pair(kw, workload)
        self.now = 0.0
        self.next_conn = 1
        self.miners = {}  # conn -> [(data, lo, hi)] FIFO
        self.clients = {}  # conn -> (data, lo, hi)
        self.n_actions = 0

    def both(self, name, *args):
        """One event into both schedulers; the actions must be equal."""
        ra = _wire(getattr(self.ref, name)(*args))
        pa = _wire(getattr(self.port, name)(*args))
        assert pa == ra, (name, args)
        assert self.port.drain_evictions() == (evicted := self.ref.drain_evictions())
        assert self.port.stats() == self.ref.stats()
        assert self.port.effective_depth() == self.ref.effective_depth()
        for cid, raw in ra:
            self.n_actions += 1
            if cid in self.miners:
                msg = json.loads(raw)
                self.miners[cid].append((msg["Data"], msg["Lower"], msg["Upper"]))
            elif cid in self.clients:
                data, lo, hi = self.clients.pop(cid)
                msg = json.loads(raw)
                assert (msg["Hash"], msg["Nonce"]) == self.min_range(data, lo, hi)
        for cid in evicted:  # the shell closes the conn; its loss follows
            self.miners.pop(cid, None)
            self.both("lost", cid, self.now)

    def conn(self):
        self.next_conn += 1
        return self.next_conn

    def step(self):
        rng = self.rng
        self.now += float(rng.exponential(0.05))
        busy = [c for c, q in self.miners.items() if q]
        r = rng.random()
        if r < 0.08 or not self.miners:
            cid = self.conn()
            self.miners[cid] = []
            self.both("miner_joined", cid, self.now)
        elif r < 0.22 or (not busy and not self.clients):
            cid = self.conn()
            data = DATA[int(rng.integers(len(DATA)))]
            lo = int(rng.integers(0, 10**6))
            hi = lo + int(rng.integers(0, 3000))
            self.clients[cid] = (data, lo, hi)
            self.both("client_request", cid, data, lo, hi, self.now)
        elif r < 0.75 and busy:
            cid = busy[int(rng.integers(len(busy)))]
            data, lo, hi = self.miners[cid].pop(0)
            h, n = self.min_range(data, lo, hi)
            if rng.random() < 0.05:
                h ^= 1  # a lying miner: rejected, re-queued, struck
            self.both("result", cid, h, n, self.now)
        elif r < 0.83:
            self.both("tick", self.now)
        elif r < 0.87 and busy:
            # A straggler: it holds its chunk while the rest of the fleet
            # answers everything it holds (its tail is stolen by an idle
            # miner at ~3 s; the whole chunk re-queued past
            # straggler_min_seconds), or the fleet detector marks it.
            slow = busy[int(rng.integers(len(busy)))]
            if rng.random() < 0.3:
                self.ref.mark_straggler(slow)
                self.port.mark_straggler(slow)
            self.now += float(rng.choice([3.0, 12.0]))
            for _ in range(30):
                others = [c for c, q in self.miners.items() if q and c != slow]
                if not others:
                    break
                data, lo, hi = self.miners[others[0]].pop(0)
                self.both("result", others[0], *self.min_range(data, lo, hi), self.now)
            self.both("tick", self.now)
        elif r < 0.91 and len(self.miners) > 1:
            cid = list(self.miners)[int(rng.integers(len(self.miners)))]
            del self.miners[cid]
            self.both("lost", cid, self.now)
        elif r < 0.95 and self.clients:
            cid = list(self.clients)[int(rng.integers(len(self.clients)))]
            data, lo, hi = self.clients.pop(cid)
            self.both("lost", cid, self.now)
            if rng.random() < 0.5:  # the client retries the identical job
                cid = self.conn()
                self.clients[cid] = (data, lo, hi)
                self.both("client_request", cid, data, lo, hi, self.now)
        else:
            self.both("tick", self.now)

    def restart(self):
        """checkpoint() → fresh schedulers → load_checkpoint(): every miner
        re-Joins with an empty queue, every live client resubmits."""
        ref_state, port_state = self.ref.checkpoint(), self.port.checkpoint()
        assert json.dumps(port_state, sort_keys=True) == json.dumps(ref_state, sort_keys=True)
        self.ref, self.port = _pair(self.kw, self.workload)
        self.ref.load_checkpoint(port_state)  # each side loads the other's state
        self.port.load_checkpoint(ref_state)
        for cid in self.miners:
            self.miners[cid] = []
            self.both("miner_joined", cid, self.now)
        for cid, (data, lo, hi) in list(self.clients.items()):
            self.both("client_request", cid, data, lo, hi, self.now)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_scheduler_actions_match_reference(config):
    kw, workload = CONFIGS[config]
    rng = np.random.default_rng(sum(map(ord, config)))
    ref0, port0 = _sched_counters(REF_METRICS), _sched_counters(METRICS)
    world = _World(kw, workload, rng)
    for i in range(200):
        world.step()
        if i == 120:
            world.restart()
    assert world.n_actions > 100
    assert json.dumps(world.port.checkpoint(), sort_keys=True) == json.dumps(
        world.ref.checkpoint(), sort_keys=True)
    assert world.port.stats() == world.ref.stats()
    ref1, port1 = _sched_counters(REF_METRICS), _sched_counters(METRICS)
    moved = {k: port1.get(k, 0) - port0.get(k, 0) for k in set(port1) | set(ref1)}
    assert moved == {k: ref1.get(k, 0) - ref0.get(k, 0) for k in moved}
    assert moved.get("sched.jobs_completed", 0) > 0
    assert moved.get("sched.jobs_resumed", 0) > 0


def test_checkpoint_refuses_other_workload():
    ref, port = _pair(SMALL, "blake2b64")
    port.miner_joined(1)
    port.client_request(2, "cmu440", 0, 999)
    state = port.checkpoint()
    assert state.get("workload") == "blake2b64"
    # A sha256d scheduler of either package stages nothing from it.
    for sched in (RefScheduler(**SMALL), Scheduler(**SMALL)):
        sched.load_checkpoint(state)
        assert sched.checkpoint()["jobs"] == []
    ref.load_checkpoint(state)
    assert ref.checkpoint() == state


# ------------------------------------------------------------------ utilities

_IV = st.lists(st.tuples(st.integers(0, 200), st.integers(0, 40)).map(
    lambda t: (t[0], t[0] + t[1])), max_size=12)


@settings(max_examples=40, deadline=None)
@given(a=_IV, b=_IV)
def test_interval_algebra_matches_reference(a, b):
    assert intervals.merge_intervals(list(a)) == ref_intervals.merge_intervals(list(a))
    assert intervals.intersect_intervals(list(a), list(b)) == \
        ref_intervals.intersect_intervals(list(a), list(b))


@settings(max_examples=40, deadline=None)
@given(ops=st.lists(st.tuples(st.sampled_from(["add", "charge", "select", "remove"]),
                              st.integers(0, 3), st.integers(1, 50)), max_size=40))
def test_wfq_order_matches_reference(ops):
    ref_q, port_q = ref_wfq.VirtualClockWFQ(), wfq.VirtualClockWFQ()
    items = {}
    for op, key, n in ops:
        k = f"t{key}"
        if op == "add":
            items.setdefault(k, []).append(n)
            for q in (ref_q, port_q):
                q.add(k, n, weight=1.0 + key % 2)
        elif op == "charge" and items.get(k):
            for q in (ref_q, port_q):
                q.charge(k, n)
        elif op == "remove" and items.get(k):
            item = items[k].pop(0)
            for q in (ref_q, port_q):
                q.remove(k, item)
        got = port_q.select(lambda p: True)
        want = ref_q.select(lambda p: True)
        assert (got and (got.key, list(got.items), got.vt)) == \
            (want and (want.key, list(want.items), want.vt))
        assert port_q.vt_floor() == ref_q.vt_floor()
