"""The port's federation tier (``federation/``, ``apps/federation.py``), its
``lsp.shared_loop`` and its model entry (``models/``), held to the JAX
package's.

- **Ring.** For 10,000 keys and rings of one to five names, ``home``,
  ``route`` (with and without a liveness filter) and ``successor`` equal
  the reference's.
- **Codec.** Gossip and handoff frames from both packages are byte for
  byte the same for the same seeded spans and states; each package decodes
  the other's; every datagram is at most 1000 bytes; alien payloads are
  refused by both; ``apply_gossip`` folds the same rows.
- **Stores.** Seeded ``add`` / ``add_remote`` / ``record_ack`` /
  ``record_seen`` / ``set_peers`` / ``reset_peer`` sequences leave both
  ``GossipSpanStore``s with the same ``pending_for``, ``acked_seq``,
  ``needs_full`` and ``export_spans`` at every step.
- **Membership.** Seeded ``heard`` / ``tick`` sequences on an injected
  clock (shedding, draining, incarnation restarts) give the same
  ``liveness``, ``load``, ``order`` and ``snapshot`` at every step.
- **Mixed federation on loopback.** A port ``Replica`` and a reference
  ``Replica``, each with its own package's miner on the CPU: a request
  forwarded each way (the ``FK1|`` preamble), a span solved on one cell
  answered on the other with no chunk swept (``T1|`` gossip), and a
  draining port cell's handoff resumed by the reference successor.
- **Drills.** The port's four drills with ``backend="cpu"`` at the
  reference's seeds and sizes, and a failing search ending a drill.
- **shared_loop**, **the binary** (``parse_peers``, usage and error
  strings, the SIGTERM drain line) and **the model entry** against the
  JAX ``forward_step_example``.
"""

import io
import os
import random
import signal
import socket
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from bitcoin_miner_tpu import lsp as ref_lsp
from bitcoin_miner_tpu import lspnet as ref_lspnet
from bitcoin_miner_tpu import federation as ref_fed
from bitcoin_miner_tpu.apps import federation as ref_app
from bitcoin_miner_tpu.apps import miner as ref_miner
from bitcoin_miner_tpu.apps.scheduler import Scheduler as RefScheduler
from bitcoin_miner_tpu.federation import drill as ref_drill
from bitcoin_miner_tpu.federation import gossip as ref_gossip
from bitcoin_miner_tpu.federation import membership as ref_membership
from bitcoin_miner_tpu.utils.metrics import METRICS as REF_METRICS
from bitcoin_miner_tpu.utils.telemetry import FrameAssembler as RefAssembler
from bitcoin_miner_tpu_torch import federation as fed
from bitcoin_miner_tpu_torch import lsp, lspnet
from bitcoin_miner_tpu_torch.apps import client as client_mod
from bitcoin_miner_tpu_torch.apps import federation as app
from bitcoin_miner_tpu_torch.apps import miner as miner_mod
from bitcoin_miner_tpu_torch.apps.scheduler import Scheduler
from bitcoin_miner_tpu_torch.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu_torch.federation import drill
from bitcoin_miner_tpu_torch.federation import gossip, membership
from bitcoin_miner_tpu_torch.utils.metrics import METRICS
from bitcoin_miner_tpu_torch.utils.telemetry import FrameAssembler

PARAMS = (5, 200, 5)  # epoch_limit, epoch_millis, window_size
WIRE_CEILING = 1000


@pytest.fixture(autouse=True)
def _clean_network():
    for net in (lspnet, ref_lspnet):
        net.reset_faults()
        net.CHAOS.reset()
    yield
    for net in (lspnet, ref_lspnet):
        net.CHAOS.reset()
        net.reset_faults()


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait(pred, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


# --------------------------------------------------------------------------
# Ring
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ring_matches_reference(n):
    names = [f"cell{i}" for i in range(n)]
    ring, ref = fed.Ring(names), ref_fed.Ring(names)
    rng = random.Random(n)
    alive = names[: max(1, n - 1)]
    for i in range(10_000):
        key = f"{rng.getrandbits(48):x}-{i}"
        assert ring.home(key) == ref.home(key)
        assert ring.route(key) == ref.route(key)
        if i % 10 == 0:
            assert ring.route(key, alive=alive) == ref.route(key, alive=alive)
    for name in names + ["stranger"]:
        assert ring.successor(name) == ref.successor(name)
        assert ring.successor(name, alive=alive) == ref.successor(name, alive=alive)


# --------------------------------------------------------------------------
# Codec
# --------------------------------------------------------------------------


def _spans(rng: random.Random, n: int):
    out = []
    for _ in range(n):
        lo = rng.randrange(0, 10**12)
        hi = lo + rng.randrange(0, 10**9)
        out.append((f"data-{rng.randrange(50)}", lo, hi, rng.getrandbits(64),
                    rng.randint(lo, hi)))
    return out


def _state(rng: random.Random, n: int) -> dict:
    jobs = []
    for _ in range(n):
        lo = rng.randrange(0, 10**9)
        hi = lo + rng.randrange(1, 10**9)
        jobs.append({"data": f"job-{rng.randrange(10**6)}", "lower": lo, "upper": hi,
                     "best": [rng.getrandbits(64), rng.randint(lo, hi)],
                     "remaining": [[rng.randint(lo, hi), hi]]})
    return {"version": 1, "workload": "sha256d", "jobs": jobs}


def _assemble(asm_cls, frames):
    asm = asm_cls()
    done, obj = False, None
    for f in frames:
        done, obj = asm.feed(f)
    assert done
    return obj


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_spans", [0, 3, 400])
def test_gossip_and_handoff_frames_match_reference(seed, n_spans):
    rng = random.Random(seed * 1000 + n_spans)
    spans = _spans(rng, n_spans)
    hb = {"inc": rng.randrange(10**9), "load": rng.choice(["OK", "SHEDDING", "DRAINING"])}
    kw = dict(jseq=rng.randrange(10**6), ack=rng.randrange(10**6), hb=hb)
    for full in (False, True):
        mine = gossip.encode_gossip("p", seed + 7, spans, full, **kw)
        theirs = ref_gossip.encode_gossip("p", seed + 7, spans, full, **kw)
        assert mine == theirs
        assert max(len(f) for f in mine) <= WIRE_CEILING
        # Each package decodes the other's frames.
        for decode, asm in ((gossip.decode_gossip, FrameAssembler),
                            (ref_gossip.decode_gossip, RefAssembler)):
            msg = decode(_assemble(asm, theirs if asm is FrameAssembler else mine))
            assert msg is not None and msg["full"] is full and msg["hb"] == hb
            assert [tuple(s) for s in msg["spans"]] == spans
    state = _state(rng, max(1, n_spans // 4))
    mine = gossip.encode_handoff("p", seed, state)
    assert mine == ref_gossip.encode_handoff("p", seed, state)
    assert max(len(f) for f in mine) <= WIRE_CEILING
    obj = _assemble(RefAssembler, mine)
    assert gossip.decode_fed(obj) == ref_gossip.decode_fed(obj)
    assert gossip.decode_fed(obj)["state"] == state
    assert gossip.decode_gossip(obj) is None and ref_gossip.decode_gossip(obj) is None


ALIENS = [
    None, [], "spans", {}, {"v": 2, "from": "x", "kind": "spans", "spans": []},
    {"v": 1, "from": 3, "kind": "spans", "spans": []},
    {"v": 1, "from": "x", "kind": "spans", "spans": "no"},
    {"v": 1, "from": "x", "kind": "handoff", "state": []},
    {"v": 1, "from": "x", "kind": "tea", "spans": []},
    {"v": 1, "from": "x"},
]


@pytest.mark.parametrize("obj", ALIENS, ids=range(len(ALIENS)))
def test_alien_payloads_refused_by_both(obj):
    for mod in (gossip, ref_gossip):
        assert mod.decode_fed(obj) is None
        assert mod.decode_gossip(obj) is None


def test_apply_gossip_folds_the_same_rows():
    rows = [["a", 0, 99, 50, 10], ["b", 0, 9, 5, 3], ["bad"], ["c", 0, 9, True, 3],
            [7, 0, 9, 5, 3], ["d", 10, 20, 1, 15], ["a", 100, 199, 40, 150]]
    mine, theirs = gossip.GossipSpanStore(), ref_gossip.GossipSpanStore()
    msg = {"spans": rows}
    assert gossip.apply_gossip(mine, msg) == ref_gossip.apply_gossip(theirs, msg) == 4
    assert mine.export_spans() == theirs.export_spans()
    assert mine.pending_for("x") == theirs.pending_for("x") == []  # remote: never journaled


# --------------------------------------------------------------------------
# Stores
# --------------------------------------------------------------------------


PEERS = ["p1", "p2", "p3"]


def _store_view(store):
    return (
        {p: store.pending_for(p) for p in PEERS},
        {p: store.acked_seq(p) for p in PEERS},
        {p: store.needs_full(p) for p in PEERS},
        {p: store.seen_seq(p) for p in PEERS},
        store.jseq(),
        sorted(store.export_spans()),
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gossip_span_store_matches_reference(seed):
    rng = random.Random(seed)
    kw = dict(capacity=8, max_spans_per_data=4, journal_max=6)
    mine, theirs = gossip.GossipSpanStore(**kw), ref_gossip.GossipSpanStore(**kw)
    for _ in range(300):
        op = rng.choice(["add", "add", "add_remote", "ack", "seen", "peers", "reset"])
        if op in ("add", "add_remote"):
            lo = rng.randrange(0, 1000)
            hi = lo + rng.randrange(-5, 200)  # some refused (lo > hi)
            nonce = rng.randrange(lo - 3, hi + 3)  # some refused (outside)
            args = (f"d{rng.randrange(12)}", lo, hi, rng.getrandbits(64), nonce)
            if op == "add_remote" and not lo <= nonce <= hi:
                continue  # the store's own guard raises on those in both
            getattr(mine, op)(*args)
            getattr(theirs, op)(*args)
        elif op == "ack":
            peer, seq = rng.choice(PEERS), rng.randrange(0, mine.jseq() + 2)
            mine.record_ack(peer, seq)
            theirs.record_ack(peer, seq)
        elif op == "seen":
            peer, seq = rng.choice(PEERS), rng.randrange(0, 500)
            mine.record_seen(peer, seq)
            theirs.record_seen(peer, seq)
        elif op == "peers":
            names = rng.sample(PEERS, rng.randrange(0, 4))
            mine.set_peers(names)
            theirs.set_peers(names)
        else:
            peer = rng.choice(PEERS)
            mine.reset_peer(peer)
            theirs.reset_peer(peer)
        assert _store_view(mine) == _store_view(theirs)


# --------------------------------------------------------------------------
# Membership
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_membership_matches_reference(seed):
    rng = random.Random(seed)
    clock = [100.0]
    names = ["a", "b", "c", "d"]
    kw = dict(interval=0.5, suspect_misses=3.0, confirm_misses=2.0, clock=lambda: clock[0])
    mine = membership.Membership("self", names, **kw)
    theirs = ref_membership.Membership("self", names, **kw)
    incs = {n: rng.randrange(5) for n in names}
    loads = ["OK", "SHEDDING", "DRAINING", "bogus"]
    for _ in range(400):
        clock[0] += rng.choice([0.0, 0.1, 0.4, 0.9, 2.5])
        op = rng.random()
        if op < 0.55:
            peer = rng.choice(names + ["stranger"])
            if peer in incs and rng.random() < 0.05:
                incs[peer] += 1  # a restart
            inc = incs.get(peer, 0)
            load = rng.choice(loads)
            assert mine.heard(peer, load, inc) == theirs.heard(peer, load, inc)
        else:
            mine.tick()
            theirs.tick()
        order_in = rng.sample(names, len(names))
        for n in names + ["stranger"]:
            assert mine.liveness(n) == theirs.liveness(n)
            assert mine.load(n) == theirs.load(n)
            assert mine.fresh(n) == theirs.fresh(n)
        assert mine.order(order_in) == theirs.order(order_in)
        assert mine.routable() == theirs.routable()
        assert mine.snapshot() == theirs.snapshot()
    for liveness in (membership.ALIVE, membership.SUSPECT, membership.DEAD):
        for load in ("OK", "SHEDDING", "DRAINING"):
            assert membership.state_code(liveness, load) == ref_membership.state_code(
                liveness, load)


def test_membership_gauges_match_reference():
    clock = [0.0]
    kw = dict(interval=1.0, clock=lambda: clock[0])
    mine = membership.Membership("self", ["a", "b"], **kw)
    theirs = ref_membership.Membership("self", ["a", "b"], **kw)
    for m in (mine, theirs):
        m.heard("a", "SHEDDING", 1)
    clock[0] = 10.0
    for m in (mine, theirs):
        m.heard("a", "SHEDDING", 1)
        m.tick()
    got = {k: v for k, v in METRICS.gauges().items() if k.startswith("fed.peer_state.")}
    want = {k: v for k, v in REF_METRICS.gauges().items()
            if k.startswith("fed.peer_state.")}
    assert got == want and got["fed.peer_state.a"] == 1 and got["fed.peer_state.b"] == 4


# --------------------------------------------------------------------------
# Mixed federation on loopback
# --------------------------------------------------------------------------


class _Mixed:
    """A port cell ``p`` and a reference cell ``r`` on loopback, each with
    one miner of its own package on the CPU (``rate`` paces both)."""

    def __init__(self, rate=None) -> None:
        fp, fr = _free_port(), _free_port()
        common = dict(gossip_interval=0.15, tick_interval=0.05, forward_timeout=15.0)
        self.p = fed.Replica("p", {"r": ("127.0.0.1", fr)}, fed_port=fp,
                             params=lsp.Params(*PARAMS),
                             scheduler=Scheduler(min_chunk=200), **common).start()
        self.r = ref_fed.Replica("r", {"p": ("127.0.0.1", fp)}, fed_port=fr,
                                 params=ref_lsp.Params(*PARAMS),
                                 scheduler=RefScheduler(min_chunk=200), **common).start()
        port_search = miner_mod.make_search("cpu")
        ref_search = ref_miner.make_search("cpu")
        if rate is not None:
            port_search = miner_mod._PacedSearch(miner_mod._PoolSearch(port_search), rate)
            ref_search = ref_drill._slow_search(rate)
        self.conns = [lsp.Client("127.0.0.1", self.p.port, lsp.Params(*PARAMS)),
                      ref_lsp.Client("127.0.0.1", self.r.port, ref_lsp.Params(*PARAMS))]
        threading.Thread(target=miner_mod.run_miner, args=(self.conns[0], port_search),
                         daemon=True).start()
        threading.Thread(target=ref_miner.run_miner, args=(self.conns[1], ref_search),
                         daemon=True).start()
        assert _wait(lambda: self.p.membership.fresh("r") and self.r.membership.fresh("p"),
                     5.0), "no heartbeat across packages"

    def key(self, home: str, prefix: str) -> str:
        ring = fed.Ring(["p", "r"])
        return next(f"{prefix}{i}" for i in range(4096) if ring.home(f"{prefix}{i}") == home)

    def ask(self, cell: str, data: str, hi: int, timeout: float = 30.0):
        """One job through the port's client at a cell's public port."""
        rep = self.p if cell == "p" else self.r
        c = lsp.Client("127.0.0.1", rep.port, lsp.Params(*PARAMS))
        try:
            return client_mod.request_once(c, data, hi, timeout=timeout)
        finally:
            c.close()

    def close(self) -> None:
        for rep in (self.p, self.r):
            rep.close()


def test_mixed_federation_forwards_each_way_and_gossips_spans():
    fleet = _Mixed()
    try:
        p0 = METRICS.get("federation.forwarded")
        r0 = REF_METRICS.get("federation.forwarded")
        # Homed on the reference cell, sent to the port cell: forwarded.
        k_r = fleet.key("r", "fwd-r-")
        assert fleet.ask("p", k_r, 3000) == min_hash_range(k_r, 0, 3000)
        assert METRICS.get("federation.forwarded") == p0 + 1
        # Homed on the port cell, sent to the reference cell: forwarded.
        k_p = fleet.key("p", "fwd-p-")
        assert fleet.ask("r", k_p, 3000) == min_hash_range(k_p, 0, 3000)
        assert REF_METRICS.get("federation.forwarded") == r0 + 1
        # Solved on one cell, answered on the other from gossiped spans:
        # no chunk swept, no forward.
        for home, other, metrics in (("p", fleet.r, REF_METRICS), ("r", fleet.p, METRICS)):
            key = fleet.key(home, f"span-{home}-")
            want = min_hash_range(key, 0, 4000)
            assert fleet.ask(home, key, 4000) == want

            def covered(rep=other, key=key):
                with rep.lock:
                    best, gaps = rep.spans.cover(key, 0, 4000)
                    return best is not None and not gaps

            assert _wait(covered, 10.0), f"spans never reached {other.cell}"
            swept = (METRICS.get("sched.nonces_swept"), REF_METRICS.get("sched.nonces_swept"))
            local = metrics.get("federation.local_answers")
            assert fleet.ask(other.cell, key, 4000) == want
            assert metrics.get("federation.local_answers") == local + 1
            assert (METRICS.get("sched.nonces_swept"),
                    REF_METRICS.get("sched.nonces_swept")) == swept
    finally:
        fleet.close()


def test_port_cell_drain_hands_off_to_reference_successor():
    hi = 20_000
    fleet = _Mixed(rate=5_000.0)
    try:
        key = fleet.key("p", "drain")
        handed0 = REF_METRICS.get("fed.handoff_jobs")
        box = {}

        def first() -> None:
            try:
                box["got"] = fleet.ask("p", key, hi, timeout=20.0)
            except Exception as e:  # the draining cell closes the conn
                box["err"] = e

        swept0 = METRICS.get("sched.nonces_swept")
        t = threading.Thread(target=first, daemon=True)
        t.start()
        assert _wait(lambda: METRICS.get("sched.nonces_swept") - swept0 >= hi // 50, 30.0)
        fleet.p.drain(reason="test")
        fleet.p.close()
        t.join(timeout=10.0)
        assert REF_METRICS.get("fed.handoff_jobs") - handed0 >= 1
        swept1 = REF_METRICS.get("sched.nonces_swept")
        assert fleet.ask("r", key, hi, timeout=60.0) == min_hash_range(key, 0, hi)
        # From scratch the job sweeps all hi + 1 nonces; resumed, fewer.
        assert REF_METRICS.get("sched.nonces_swept") - swept1 < hi + 1
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# Drills
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", drill.DRILLS)
def test_port_drill_on_the_cpu(name):
    report = drill.run_fed_drill(name, seed=1, backend="cpu")
    assert report["ok"], report
    assert report["errors"] == []
    assert report["miners"] and all(m["tier"] == "cpu" for m in report["miners"].values())


def test_failing_search_ends_the_drill(monkeypatch):
    def broken(backend="auto", device=None, workload=None, devices=None):
        def search(data, lo, hi):
            raise RuntimeError("kernel failed to launch")
        return search

    monkeypatch.setattr(miner_mod, "make_search", broken)
    t0 = time.monotonic()
    report = drill.drill_death_detect(seed=1, backend="cpu")
    assert not report["ok"]
    assert any("kernel failed to launch" in e for e in report["errors"]), report
    assert time.monotonic() - t0 < 20.0


def test_run_fed_drill_refuses_unknown_names_like_reference():
    with pytest.raises(ValueError) as mine:
        drill.run_fed_drill("nope")
    with pytest.raises(ValueError) as theirs:
        ref_drill.run_fed_drill("nope")
    assert str(mine.value) == str(theirs.value)
    assert drill.DRILLS == ref_drill.DRILLS


# --------------------------------------------------------------------------
# shared_loop
# --------------------------------------------------------------------------


def test_shared_loop_keeps_threads_flat_and_outlives_its_conns():
    loop = lsp.shared_loop("fwd-loop-test")
    try:
        server = lsp.Server(0, lsp.Params(*PARAMS), loop=loop)
        clients = [lsp.Client("127.0.0.1", server.port, lsp.Params(*PARAMS), loop=loop,
                              label="c0")]
        # The first connect may start the loop's resolver thread; after it
        # the count is flat in conns.
        base = threading.active_count()
        clients += [lsp.Client("127.0.0.1", server.port, lsp.Params(*PARAMS), loop=loop,
                               label=f"c{i}") for i in range(1, 6)]
        assert threading.active_count() == base
        assert not [t for t in threading.enumerate() if t.name.startswith("lsp-client-c")]
        for i, c in enumerate(clients):
            c.write(f"m{i}".encode())
        got = sorted(server.read()[1] for _ in clients)
        assert got == sorted(f"m{i}".encode() for i in range(6))
        for c in clients:
            c.close()
        server.close()
        assert loop._thread.is_alive() and loop._thread.name == "fwd-loop-test"
        assert loop.call(lambda: 42) == 42
    finally:
        loop.stop()
    assert not loop._thread.is_alive()


# --------------------------------------------------------------------------
# The binary
# --------------------------------------------------------------------------


PEER_SPECS = ["", "r2=127.0.0.1:6002", "r2=10.0.0.2:7,r3=:8,", "a=h:1,a=k:2",
              "r2", "=h:1", "r2=h", "r2=h:x", "r2=h:-1"]


@pytest.mark.parametrize("spec", PEER_SPECS)
def test_parse_peers_matches_reference(spec):
    def run(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(app.parse_peers) == run(ref_app.parse_peers)


BAD_ARGVS = [
    ["fed"], ["fed", "1", "2"], ["fed", "x"], ["fed", "0", "--peers=r2"],
    ["fed", "0", "--peers=r2=h:q"], ["fed", "0", "--autoscale=nope=1"],
    ["fed", "0", "--workload=nope"],
]


@pytest.mark.parametrize("argv", BAD_ARGVS, ids=[" ".join(a) for a in BAD_ARGVS])
def test_usage_and_error_strings_match_reference(argv, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    outs = []
    for main in (app.main, ref_app.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(list(argv)) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0]


def test_sigterm_drains_and_exits(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    old = signal.getsignal(signal.SIGTERM)
    buf = io.StringIO()
    timer = threading.Timer(1.0, os.kill, (os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        with redirect_stdout(buf):
            assert app.main(["fed", "0", "--cell=solo"]) == 0
    finally:
        timer.cancel()
        signal.signal(signal.SIGTERM, old)
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("Replica solo listening on port ")
    assert lines[-1] == "Replica solo draining"


# --------------------------------------------------------------------------
# The model entry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [{}, dict(data=b"hello", d=5, k=2, batch=3)],
                         ids=["default", "small"])
def test_forward_step_example_matches_jax(shape):
    from bitcoin_miner_tpu.models import forward_step_example as ref_forward

    from bitcoin_miner_tpu_torch.models import forward_step_example
    from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash_plain

    fn, args = forward_step_example(device="cpu", **shape)
    assert fn is minhash_plain
    got = tuple(int(v) for v in fn(*args))
    ref_fn, ref_args = ref_forward(**shape)
    assert got == tuple(int(np.asarray(v)) for v in ref_fn(*ref_args))
    # The operands are the reference's, as torch tensors.
    for mine, theirs in zip(args[:3], ref_args):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
