"""The port's serving gateway, held to the JAX package's.

- The admission primitives, the result cache and the span store against
  the reference's on the same seeded operations (the span store's clock
  injected), and their files written by one package and read by the
  other, both ways, for every registered workload.
- Seeded event sequences, one per registered workload and gateway
  configuration: the reference ``Gateway(Scheduler(...))`` and the port's,
  built with the same keyword arguments and one fake clock, through the
  same ~200 events — miner joins, Requests from several client keys
  (fresh, duplicate, sub-range, overlapping, empty, poison), Results the
  workload's oracle computes over each assigned interval (now and then a
  wrong one), ticks, idle periods long enough for speculative prefill,
  lost miners and clients, and a restart in which each side reloads the
  other's checkpoint, cache file and span file.  After every event the
  two action lists are equal as marshalled bytes, and so are
  ``drain_evictions()``, ``stats()``, ``checkpoint()``, both virtual-time
  floors and the trace events; at the end the ``gateway.*`` and
  ``sched.*`` counter deltas and the gateway histograms' counts.
- Over the wire on loopback: the port server with a ``Gateway`` on each
  shell, port CPU miners, three duplicate clients coalesced into one
  sweep, then a cache hit and a span hit, each Result equal to
  ``min_hash_range``; and the reference's client against it.
"""

import json
import threading
import time

import numpy as np
import pytest

from bitcoin_miner_tpu import gateway as ref_gateway
from bitcoin_miner_tpu import lsp as ref_lsp
from bitcoin_miner_tpu import workloads as ref_workloads
from bitcoin_miner_tpu.apps import client as ref_client
from bitcoin_miner_tpu.apps.scheduler import Scheduler as RefScheduler
from bitcoin_miner_tpu.utils.metrics import METRICS as REF_METRICS
from bitcoin_miner_tpu.utils.trace import TRACE as REF_TRACE
from bitcoin_miner_tpu_torch import gateway, lsp, workloads
from bitcoin_miner_tpu_torch.apps import Scheduler, client, miner, server
from bitcoin_miner_tpu_torch.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu_torch.utils.metrics import METRICS
from bitcoin_miner_tpu_torch.utils.trace import TRACE

PKG = {"ref": (ref_gateway, RefScheduler, ref_workloads),
       "port": (gateway, Scheduler, workloads)}
DATA = ("cmu440", "Pack my box with five dozen liquor jugs", "zz")
KEYS = ("addr:a", "addr:b", "addr:c", None)
# Chunk sizes at test scale (the oracle folds every Result's interval).
SKW = dict(min_chunk=20, max_chunk=400)
# name -> (Gateway kwargs, ResultCache kwargs, SpanStore kwargs)
CONFIGS = {
    "tight": (dict(rate=2.0, burst=2.0, max_active=3, max_queued=4, max_buckets=3),
              dict(capacity=6), dict(capacity=2, max_spans_per_data=5)),
    "prefill": (dict(rate=40.0, burst=8.0, max_active=6, max_queued=12, prefill=150,
                     prefill_max_per_data=600, prefill_idle_s=0.5),
                dict(capacity=32), dict(capacity=4, max_spans_per_data=12,
                                        hot_half_life_s=4.0)),
}


def _wire(actions):
    return [(cid, m.marshal()) for cid, m in actions]


def _dump(state):
    return json.dumps(state, sort_keys=True)


def _counters(metrics):
    out = {k: v for k, v in metrics.snapshot().items()
           if k.startswith(("gateway.", "sched."))}
    for name in ("hist.request_s", "hist.admission_wait_s"):
        h = metrics.histogram(name)
        out[name] = h.count() if h is not None else 0
    return out


def _moved(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)
            if after.get(k, 0) != before.get(k, 0)}


class _Ids:
    """Trace ids in order of first appearance: each package mints its own,
    so rows compare on the order in which ids appear."""

    def __init__(self):
        self.seen = {}

    def __call__(self, tid):
        if tid is None:
            return None
        return self.seen.setdefault(tid, len(self.seen))


def _rows(tracer, ids):
    out = []
    for r in tracer.drain():
        attrs = dict(r.get("attrs") or {})
        if "into" in attrs:
            attrs["into"] = ids(attrs["into"])
        out.append((ids(r["trace"]), r["span"], r["event"], attrs))
    return out


# ------------------------------------------------------------------ primitives


def test_token_bucket_and_fair_queue_match_reference():
    rng = np.random.default_rng(7)
    bucket = {p: PKG[p][0].TokenBucket(3.0, 4.0, now=1.0) for p in PKG}
    queue = {p: PKG[p][0].FairQueue() for p in PKG}
    now = 1.0
    for i in range(300):
        now += float(rng.exponential(0.2))
        r = rng.random()
        if r < 0.4:
            n = float(rng.choice([0.5, 1.0, 2.0]))
            got = {p: b.try_take(now, n) for p, b in bucket.items()}
        elif r < 0.5:
            got = {p: b.is_full(now) for p, b in bucket.items()}
        elif r < 0.8:
            key, w = f"k{int(rng.integers(4))}", float(rng.choice([0.5, 1.0, 3.0]))
            got = {p: q.push(key, (i, key), w) for p, q in queue.items()}
        elif r < 0.9:
            got = {p: q.pop() for p, q in queue.items()}
        elif r < 0.95:
            got = {p: q.shed_from_largest() for p, q in queue.items()}
        else:
            odd = int(rng.integers(2))
            got = {p: q.remove_where(lambda item: item[0] % 2 == odd)
                   for p, q in queue.items()}
        assert got["port"] == got["ref"], i
        assert bucket["port"].tokens == bucket["ref"].tokens
        assert len(queue["port"]) == len(queue["ref"])
        assert queue["port"].vt_floor() == queue["ref"].vt_floor()


def test_result_cache_and_span_store_match_reference():
    rng = np.random.default_rng(11)
    now = [0.0]
    made = {p: (PKG[p][0].ResultCache(capacity=5),
                PKG[p][0].SpanStore(capacity=3, max_spans_per_data=4, hot_half_life_s=2.0,
                                    clock=lambda: now[0]))
            for p in PKG}
    moved0 = {p: _counters(m) for p, m in (("port", METRICS), ("ref", REF_METRICS))}
    for i in range(400):
        now[0] += float(rng.exponential(0.3))
        data = DATA[int(rng.integers(len(DATA)))] + str(int(rng.integers(2)))
        lo = int(rng.integers(0, 400))
        hi = lo + int(rng.integers(0, 60))
        h, n = int(rng.integers(1 << 62)), int(rng.integers(lo, hi + 1))
        r = rng.random()
        if r < 0.2:
            got = {p: c.put((data, lo, hi), h, n) for p, (c, _s) in made.items()}
        elif r < 0.35:
            got = {p: c.get((data, lo, hi)) for p, (c, _s) in made.items()}
        elif r < 0.65:
            got = {p: s.add(data, lo, hi, h, n) for p, (_c, s) in made.items()}
        elif r < 0.85:
            got = {p: s.cover(data, lo, hi + 200) for p, (_c, s) in made.items()}
        elif r < 0.95:
            size = int(rng.integers(1, 40))
            got = {p: s.prefill_target(size, 120) for p, (_c, s) in made.items()}
            if got["ref"] is not None and rng.random() < 0.5:
                for p, (_c, s) in made.items():
                    s.prefill_refund(*got["ref"])
        else:
            got = {p: (c.flush(), s.flush()) for p, (c, s) in made.items()}
        assert got["port"] == got["ref"], i
        pc, ps = made["port"]
        rc, rs = made["ref"]
        assert (len(pc), len(ps), ps.data_count()) == (len(rc), len(rs), rs.data_count())
        assert pc._serialize() == rc._serialize() and ps._serialize() == rs._serialize()
    moved = {p: _moved(moved0[p], _counters(m)) for p, m in (("port", METRICS),
                                                             ("ref", REF_METRICS))}
    assert moved["port"] == moved["ref"]
    assert {"gateway.cache_evictions", "gateway.span_evictions",
            "gateway.coalesce_lost"} <= set(moved["port"])


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("workload", workloads.names())
def test_cache_and_span_files_cross_packages(writer, reader, workload, tmp_path):
    wmod, rmod = PKG[writer][0], PKG[reader][0]
    oracle = workloads.get(workload).min_range
    cache = wmod.ResultCache(path=str(tmp_path / "c.json"), workload=workload)
    spans = wmod.SpanStore(path=str(tmp_path / "s.json"), workload=workload)
    for data, lo, hi in (("cmu440", 0, 199), ("cmu440", 200, 399), ("zz", 5, 60)):
        h, n = oracle(data, lo, hi)
        cache.put((data, lo, hi), h, n)
        spans.add(data, lo, hi, h, n)
    cache.save(cache.path)
    spans.save(spans.path)
    back_c = rmod.ResultCache(path=cache.path, workload=workload)
    back_s = rmod.SpanStore(path=spans.path, workload=workload)
    assert back_c._serialize() == cache._serialize()
    assert back_s._serialize() == spans._serialize()
    assert back_s.cover("cmu440", 0, 399) == (tuple(oracle("cmu440", 0, 399)), [])
    assert back_c.get(("zz", 5, 60)) == oracle("zz", 5, 60)
    # Another workload's store starts empty from the same files.
    other = "blake2b64" if workload != "blake2b64" else "sha256d"
    assert len(rmod.ResultCache(path=cache.path, workload=other)) == 0
    assert len(rmod.SpanStore(path=spans.path, workload=other)) == 0


# ------------------------------------------------------------- event sequences


class _World:
    """The fleet both gateways serve: live miners with the FIFO of
    ``(data, lo, hi)`` chunks each holds, and clients with their Requests
    (waiting, queued or parked: the gateway decides; the world only knows
    which conns still expect a Result)."""

    def __init__(self, config, workload, rng, tmp_path):
        self.config, self.workload, self.rng, self.tmp = config, workload, rng, tmp_path
        self.min_range = workloads.get(workload).min_range
        self.now = 0.0
        self.ref, self.port = self._pair()
        self.ids = {"ref": _Ids(), "port": _Ids()}
        self.next_conn = 1
        self.miners = {}  # conn -> [(data, lo, hi)] FIFO
        self.clients = {}  # conn -> (data, lo, hi)
        self.asked = []  # every (data, lo, hi) a client asked for
        self.answered = 0

    def _pair(self, files=None):
        gw_kw, cache_kw, span_kw = CONFIGS[self.config]
        out = []
        for p in ("ref", "port"):
            mod, sched_cls, wl_mod = PKG[p]
            wl = wl_mod.resolve_nondefault(wl_mod.get(self.workload))
            paths = (files or {}).get(p, (None, None))
            out.append(mod.Gateway(
                sched_cls(workload=wl, **SKW),
                cache=mod.ResultCache(path=paths[0], workload=self.workload, **cache_kw),
                spans=mod.SpanStore(path=paths[1], workload=self.workload,
                                    clock=lambda: self.now, **span_kw),
                **gw_kw))
        return out

    def both(self, name, *args, **kw):
        """One event into both gateways; everything observable must agree."""
        ra = _wire(getattr(self.ref, name)(*args, **kw))
        pa = _wire(getattr(self.port, name)(*args, **kw))
        assert pa == ra, (name, args)
        evicted = self.ref.drain_evictions()
        assert self.port.drain_evictions() == evicted
        assert self.port.stats() == self.ref.stats()
        assert self.port.vt_floor() == self.ref.vt_floor()
        assert self.port.queue_vt_floor() == self.ref.queue_vt_floor()
        assert self.port.revision == self.ref.revision
        assert _dump(self.port.checkpoint()) == _dump(self.ref.checkpoint())
        assert _rows(TRACE, self.ids["port"]) == _rows(REF_TRACE, self.ids["ref"])
        for cid, raw in ra:
            msg = json.loads(raw)
            if cid in self.miners:
                self.miners[cid].append((msg["Data"], msg["Lower"], msg["Upper"]))
            elif cid in self.clients:
                data, lo, hi = self.clients.pop(cid)
                if lo <= hi:
                    assert (msg["Hash"], msg["Nonce"]) == self.min_range(data, lo, hi)
                self.answered += 1
        for cid in evicted:  # the shell closes the conn; its loss follows
            self.miners.pop(cid, None)
            self.clients.pop(cid, None)
            self.both("lost", cid, self.now)

    def conn(self):
        self.next_conn += 1
        return self.next_conn

    def request(self):
        rng = self.rng
        r = rng.random()
        if r < 0.3 or not self.asked:
            data = DATA[int(rng.integers(len(DATA)))]
            lo = int(rng.integers(0, 3000))
            key = (data, lo, lo + int(rng.integers(0, 900)))
        else:
            # Mostly a key some client still waits on (coalescing, in-flight
            # span waits), else any key asked before (cache and span hits).
            pool = list(self.clients.values()) if self.clients and rng.random() < 0.6 \
                else self.asked
            data, lo, hi = pool[int(rng.integers(len(pool)))]
            if r < 0.5 or lo > hi:
                key = (data, lo, hi)  # a duplicate
            elif r < 0.75:
                a = int(rng.integers(lo, hi + 1))  # a sub-range
                key = (data, a, int(rng.integers(a, hi + 1)))
            elif r < 0.95:
                a = max(0, lo + int(rng.integers(-300, 300)))  # an overlap
                key = (data, a, max(a, hi + int(rng.integers(1, 400))))
            elif r < 0.98:
                key = (data, lo, lo - 1)  # empty
            else:
                key = (data, lo, 1 << 64)  # poison: refused before any state
        cid = self.conn()
        if key[2] < 1 << 64:
            self.clients[cid] = key
            self.asked.append(key)
        ckey = KEYS[int(rng.integers(len(KEYS)))]
        self.both("client_request", cid, *key, self.now, client_key=ckey)

    def step(self):
        rng = self.rng
        self.now += float(rng.exponential(0.08))
        busy = [c for c, q in self.miners.items() if q]
        r = rng.random()
        if r < 0.07 or not self.miners:
            cid = self.conn()
            self.miners[cid] = []
            self.both("miner_joined", cid, self.now)
        elif r < 0.32 or (not busy and not self.clients):
            self.request()
        elif r < 0.72 and busy:
            cid = busy[int(rng.integers(len(busy)))]
            data, lo, hi = self.miners[cid].pop(0)
            h, n = self.min_range(data, lo, hi)
            if rng.random() < 0.04:
                h ^= 1  # a lying miner: rejected, re-queued, struck
            self.both("result", cid, h, n, self.now)
        elif r < 0.80:
            self.both("tick", self.now)
        elif r < 0.84:
            # An idle spell: every held chunk answered, then ticks past the
            # prefill dwell (speculation, if armed, starts here).
            for _ in range(200):
                busy = [c for c, q in self.miners.items() if q]
                if not busy:
                    break
                data, lo, hi = self.miners[busy[0]].pop(0)
                self.both("result", busy[0], *self.min_range(data, lo, hi), self.now)
            for _ in range(3):
                self.now += 0.4
                self.both("tick", self.now)
        elif r < 0.88 and len(self.miners) > 1:
            cid = list(self.miners)[int(rng.integers(len(self.miners)))]
            del self.miners[cid]
            self.both("lost", cid, self.now)
        elif r < 0.93 and self.clients:
            cid = list(self.clients)[int(rng.integers(len(self.clients)))]
            del self.clients[cid]
            self.both("lost", cid, self.now)
        elif r < 0.95 and self.miners and self.clients:
            # Role confusion, refused by both: a waiting client Joins, a
            # miner sends a Request.
            self.both("miner_joined", next(iter(self.clients)), self.now)
            self.both("client_request", next(iter(self.miners)), "x", 0, 9, self.now)
        else:
            self.both("tick", self.now)

    def restart(self):
        """Each side writes its cache and span files and its checkpoint;
        fresh gateways load the OTHER package's files and state; miners
        re-Join empty, every client resubmits."""
        files = {}
        for p, gw in (("ref", self.ref), ("port", self.port)):
            c, s = self.tmp / f"{p}-cache.json", self.tmp / f"{p}-spans.json"
            gw.cache.save(str(c))
            gw.spans.save(str(s))
            files[p] = (str(c), str(s))
        states = {"ref": self.ref.checkpoint(), "port": self.port.checkpoint()}
        self.ref, self.port = self._pair({"ref": files["port"], "port": files["ref"]})
        assert self.port.cache._serialize() == self.ref.cache._serialize()
        assert self.port.spans._serialize() == self.ref.spans._serialize()
        self.ref.load_checkpoint(states["port"])
        self.port.load_checkpoint(states["ref"])
        for cid in self.miners:
            self.miners[cid] = []
            self.both("miner_joined", cid, self.now)
        for cid, key in list(self.clients.items()):
            self.both("client_request", cid, *key, self.now)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("workload", workloads.names())
def test_gateway_actions_match_reference(workload, config, tmp_path):
    rng = np.random.default_rng([sum(map(ord, workload)), sum(map(ord, config))])
    before = {"port": _counters(METRICS), "ref": _counters(REF_METRICS)}
    TRACE.enable(capacity=10**6)
    REF_TRACE.enable(capacity=10**6)
    try:
        world = _World(config, workload, rng, tmp_path)
        for i in range(220):
            world.step()
            if i == 140:
                world.restart()
    finally:
        TRACE.disable()
        REF_TRACE.disable()
    moved = {"port": _moved(before["port"], _counters(METRICS)),
             "ref": _moved(before["ref"], _counters(REF_METRICS))}
    assert moved["port"] == moved["ref"]
    assert world.answered > 20
    for name in ("gateway.coalesced", "gateway.cache_hits", "gateway.span_hits",
                 "gateway.span_partial", "gateway.completed", "sched.jobs_completed"):
        assert moved["port"].get(name, 0) > 0, (name, moved["port"])
    if config == "tight":
        assert moved["port"].get("gateway.throttled", 0) > 0
        assert moved["port"].get("gateway.shed", 0) > 0
    else:
        assert moved["port"].get("gateway.prefill_jobs", 0) > 0
        assert moved["port"].get("gateway.prefill_preempted", 0) > 0


def test_prefill_never_enters_resume_stash_or_checkpoint():
    """A preempted speculation leaves nothing to resume: the port's
    checkpoint after it equals the reference's, and holds no job."""
    out = {}
    for p in ("ref", "port"):
        mod, sched_cls, _w = PKG[p]
        now = [0.0]
        spans = mod.SpanStore(clock=lambda: now[0])
        gw = mod.Gateway(sched_cls(min_chunk=50, max_chunk=50), spans=spans,
                         prefill=200, prefill_idle_s=0.0)
        gw.miner_joined(1)
        held = [m for c, m in gw.client_request(2, "cmu440", 0, 99, 0.0) if c == 1]
        while held:  # the miner answers its chunks in order
            msg = held.pop(0)
            held += [m for c, m in gw.result(1, *min_hash_range(msg.data, msg.lower,
                                                                  msg.upper), 0.0) if c == 1]
        gw.client_request(3, "cmu440", 50, 99, 0.1)  # a span hit: the key turns hot
        acts = gw.tick(1.0) + gw.tick(2.0)
        assert gw.stats()["gw_prefill"] == 1 and acts
        gw.client_request(4, "zz", 0, 9, 2.5)  # a real Request preempts it
        out[p] = (gw.stats(), gw.checkpoint())
    assert out["port"] == out["ref"]
    assert out["port"][0]["gw_prefill"] == 0
    assert [j["data"] for j in out["port"][1]["jobs"]] == ["zz"]
    assert out["port"][1].get("orphans", []) == []


# ------------------------------------------------------------------- the wire

PARAMS = lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)
STATIC = dict(min_chunk=2000, max_chunk=2000, adaptive_chunks=False, steal_factor=0.0)
JOB = ("cmu440", 0, 9_999)
SUB = ("cmu440", 2_000, 5_999)  # whole chunks of JOB: answerable from spans


def _serve(shell, gw):
    if shell == "async":
        ing = server.AsyncIngress(0, scheduler=gw, params=PARAMS, tick_interval=0.1).start()
        return ing.port, ing.close
    s = lsp.Server(0, PARAMS)
    t = threading.Thread(target=server.serve, args=(s, gw), kwargs=dict(tick_interval=0.1),
                         daemon=True)
    t.start()

    def stop():
        s.close()
        t.join(timeout=10)
        assert not t.is_alive()

    return s.port, stop


def _ask(port, data, lo, hi, pkg="port"):
    lsp_mod, cli, params = ((lsp, client, PARAMS) if pkg == "port" else
                            (ref_lsp, ref_client,
                             ref_lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)))
    conn = lsp_mod.Client("127.0.0.1", port, params)
    try:
        return cli.request_once(conn, data, hi, lower=lo, timeout=60)
    finally:
        conn.close()


def _until(pred, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@pytest.mark.parametrize("shell", ["serve", "async"])
def test_gateway_server_over_the_wire(shell, tmp_path):
    gw = gateway.Gateway(Scheduler(**STATIC),
                         cache=gateway.ResultCache(path=str(tmp_path / "c.json")),
                         spans=gateway.SpanStore(path=str(tmp_path / "s.json")))
    before = _counters(METRICS)
    port, stop_server = _serve(shell, gw)
    got, mc, mt = {}, None, None
    try:
        # Three twins arrive before any miner: they must share one sweep.
        twins = [threading.Thread(target=lambda i=i: got.__setitem__(i, _ask(port, *JOB)),
                                  daemon=True) for i in range(3)]
        for t in twins:
            t.start()
        _until(lambda: METRICS.get("gateway.coalesced") - before.get("gateway.coalesced", 0)
               >= 2, "the twins never coalesced")
        mc = lsp.Client("127.0.0.1", port, PARAMS)
        mt = threading.Thread(target=miner.run_miner,
                              args=(mc, miner.make_async_search("cpu")), daemon=True)
        mt.start()
        for t in twins:
            t.join(timeout=60)
        want = min_hash_range(*JOB)
        assert [got[i] for i in range(3)] == [want] * 3
        assert _ask(port, *JOB) == want  # the cache
        assert _ask(port, *SUB) == min_hash_range(*SUB)  # the spans
        # The reference's client against the port's gateway server: the
        # same bytes on the wire, the same Result.
        assert _ask(port, "cmu440", 0, 3_999, pkg="ref") == min_hash_range("cmu440", 0, 3_999)
    finally:
        stop_server()
        if mt is not None:
            mt.join(timeout=10)
            mc.close()
    moved = _moved(before, _counters(METRICS))
    assert moved["gateway.coalesced"] == 2 and moved["gateway.fanout"] == 2
    assert moved["gateway.cache_hits"] == 1 and moved["gateway.span_hits"] == 2
    assert moved["gateway.completed"] == 1 and moved["sched.jobs_completed"] == 1
    assert moved["sched.nonces_swept"] == JOB[2] + 1
    assert moved["hist.request_s"] == 6
    # The engine's flushes wrote both files, in the reference's format.
    assert ref_gateway.ResultCache(path=str(tmp_path / "c.json")).get(JOB) == want
    assert len(ref_gateway.SpanStore(path=str(tmp_path / "s.json"))) == 5
