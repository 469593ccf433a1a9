#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (bitcoin_miner_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure ends the run non-zero, with no result line):

1. environment — the card's name and power limit (nvidia-smi) and
   torch.cuda.get_device_name(0);
2. build — the four kernel sources in bitcoin_miner_tpu_torch/csrc, one
   nvcc each, and the native host sweep (g++), all started together, for
   sm_90a, printing ``-Xptxas -v`` (registers, spills) and the static SASS
   mix per kernel;
3. kernel vs plain — the min-hash kernel against its plain PyTorch version
   on the card, bit-exact, over both sieve forms, 1 and 2 tail blocks, k 1
   to 6, partial-bound rows (bounds inside a run of 10 lanes too) and
   padding rows and three thresholds, with the low digits in the one tail
   block, straddling the two, or all in the second; then at the main
   path's own shape (1024 rows x 10^6 lanes, 1 and 2 tail blocks) and a
   500-row partial batch;
4. factored kernel vs plain — the factored kernel against its plain
   version, bit-exact, both forms, k 2..6 with the default k_in and one
   other, three layouts (inner digits in the one tail block; straddling
   into the second; all in the second), partial bounds, a padding row and
   the thresholds; then at the main path's shape against phase 3's plain
   folds, and for the 56-character message against its own plain run;
5. blake2b kernel vs plain — the BLAKE2b-64 kernel against its plain
   version on the card, bit-exact, k 1 to 6, one and two tail blocks (data
   of 6, 120 and 200 bytes, and 126 bytes with the low digits all in the
   second block), bounds inside rows, a partial batch with a padding row,
   the full fold and three thresholds; then at the main path's own shape
   (1024 rows x 10^6 lanes) on the 6-, 120- and 126-byte layouts, and a
   500-row partial batch;
6. main path — the port miner's ``main`` (``--backend cuda``) in a thread,
   served by this script through the port's own LSP server with Requests of
   at most 1e9 nonces; every Result is checked against hashlib, the job's
   fold against a 5e8-nonce split, a Request across 1e9 against the
   ``min_hash_range`` oracle, and the kernel's launch count;
7. workload paths — the same ``main`` with ``--workload blake2b64`` and with
   ``--workload preimage``, Requests of 1e9 nonces on ``"cmu440"`` and a
   two-block message: every Result checked against the workload's
   ``hash_nonce``, the 1e9 and 5e8 splits' folds against each other, a
   Request across 1e9 against ``min_range``, each kernel's launch count;
8. watchdog drill — ``make_tiered_search("cuda", workload=blake2b64)`` with a
   forced wedge of the first fetch: one logged, counted downgrade from cuda
   to the host's cpu tier (never to the plain version on the card) and an
   exact Result;
9. factored path — ``SweepPipeline(backend="cuda", factored=True)`` over the
   same jobs plus the 56-character one in 1e9-nonce submits: every result
   checked against hashlib, every job's fold against the unfactored one,
   the Request across 1e9 against the oracle, and the factored kernel's
   launch count;
10. mesh path — ``sweep_min_hash_sharded`` with one shard and with two
   shards on cuda:0 against ``sweep_min_hash`` bit for bit on 1e9-nonce
   Requests of the three kernels' paths (``sha256d`` on ``"cmu440"`` and the
   56-character message, ``blake2b64``, ``factored=True``), and against the
   oracle on small ranges, across 10^19 and up to 2^64 - 1, both sieve
   forms; every card when there are more; the miner with ``--devices 1`` and
   with two shards over LSP, each Result equal to the single-device
   miner's, with its launch counts; a U S S U pair of 1e9 Requests, single
   device against ``devices=[cuda:0]``, in nonces/s;
11. multihost — two miner processes on the one card, ``--multihost
   --num-hosts 2`` over gloo, against this script's LSP server: Results
   held to the single-device miner's and the oracle; both exit 0 and
   report their launch counts;
12. serving path — the port's three binaries as processes: ``apps.server``
   with two ``apps.miner`` processes (the cuda rung, on the one card) and
   three concurrent ``apps.client`` jobs ("cmu440" to 9,999,999,999, the
   56-character message to 4,999,999,999, "cmu440" to 999,999); a kill
   drill ("drill" to 19,999,999,999, one miner SIGKILLed holding work);
   one long job through ``--async-ingress``; one ``--workload=blake2b64``
   job of 2e9 nonces.  Each Result held to hashlib and to
   ``sweep_min_hash`` over the same range (the short one to
   ``min_hash_range``); each job's time to Result, nonces/s and Requests
   sent (from the server's trace), each miner's launch counts;
13. telemetry path — the fleet metrics plane on the card: ``apps.server``
   with ``--telemetry-port``, ``--fleet-log``, ``--prom``, ``--slo=`` and
   ``--trace``, three ``apps.miner`` processes at their defaults with
   ``--telemetry`` (interval 0.5 s; ``miner-c`` throttled to be the
   straggler) and two concurrent ``apps.client`` jobs, each Result held to
   hashlib and ``sweep_min_hash``; from the last fleet-log state: the four
   sources fresh, the merged ``miner.nonces`` equal to the nonces the
   server's trace dispatched, each miner's ``hist.device_dispatch_s`` count
   equal to its kernel launches and its ``hist.miner_chunk_s`` count to its
   answered Requests, ``hist.lsp_rtt_s`` sampled, ``miner-c`` the one
   straggler (one ``fleet straggler`` event), the SLO alert fired, the
   Prometheus file parsed, ``fleet=``/``slo=`` on the health lines, each
   miner's lifetime line; a clean run (two miners, bare ``--slo``) with no
   alert; each miner's per-dispatch p50/p95; an A B B A pair of 1e9
   Requests on one miner, exporter armed against bare;
14. gateway path — the serving gateway: ``apps.server --gateway
   --cache=F --spans=F`` on each shell with two plain ``apps.miner``
   processes at their defaults (the cuda rung) and port clients: (a)
   four identical Requests at once share one sweep (their chunks tile the
   range once; the miners' launches equal those chunks' launches swept here;
   ``gateway.coalesced`` 3); (b) the same Request from the cache and (c) a
   sub-range of whole solved spans, each with no launch; (d) an
   overlapping Request sweeps only its uncovered gap; then the blocking
   server restarted on the same files with ``--prefill`` and small
   ``--rate=``/``--burst=``/``--max-queued=``: (e) the cache answers again
   with no launch; (f) one host's flood of six Requests is throttled and
   three are shed (their conns closed) while a second host's Request
   (from 127.0.0.2) is served; (g) after an idle second the prefill legs
   launch on the card and a real Request preempts them.  Every Result
   held to hashlib and ``sweep_min_hash``; counters from the fleet log;
   each leg's time to Result and launches per miner;
15. autoscale path — ``apps.server --gateway --telemetry-port --slo=
   --autoscale=`` with one miner paced by ``BMT_MINER_THROTTLE_NPS`` under
   two streams of Requests: the request alert fires, the controller
   spawns two ``python -m bitcoin_miner_tpu_torch.apps.miner`` workers
   (paced by the inherited variable, the cuda rung), each miner answers
   chunks, the load stops, the alert resolves and the controller drains
   the newest worker: it exits 0 with ``drained`` in its trace; a spawned
   worker launched the min-hash kernel (each observed by a
   ``sitecustomize`` hook, see WORKER_HOOK); every Result exact; the
   controller's timeline from its trace and ``status()``;
16. chaos path — the chaos layer on the card: the port's ``run_drill``
   in this process (three miners on the cuda rung) under each standard
   scenario (``burst-loss``, ``reorder-dup-delay``,
   ``flaky-then-partition``, ``miner-partition`` with miner-0 killed at
   0.8 s) over ``[0, 19,999,999,999]``, each Result held to
   ``sweep_min_hash`` on the card and hashlib, the kernel's launches, each
   miner's rung and the scenario's fault counters checked; one job through
   an ``apps.server`` process armed by ``BMT_CHAOS_SCENARIO`` /
   ``BMT_CHAOS_LOOP`` with two miners, held as the serving path holds its
   jobs, the server's chaos counters from its health line; each leg's time
   to Result, counters and launches;
17. federation path — the federation tier and the model entry: (a) the
   port's four federation drills in this process (``shed-storm``,
   ``drain-handoff`` with its two miners paced to 2.5e9 nonces/s each,
   ``death-detect``, ``ack-retransmit``), every job to 9,999,999,999 and
   miners on the cuda rung, each job's oracle ``sweep_min_hash`` on the
   card: each drill ``ok``, its miners' rung and launches, the resumed job
   sweeping fewer nonces than the scratch one; (b) two ``apps.federation``
   replica processes (r1, r2, gossip every 0.25 s) with one ``apps.miner``
   each and ``apps.client`` jobs: a forwarded job, twins at both ports
   swept once, a range r1 solved answered by r2 from gossip with no launch,
   a job answered by r1 after r2 is SIGKILLed, then r2 restarted and r1
   SIGTERMed (``Replica r1 draining``, exit 0, the handoff logged by r2);
   every Result held to ``sweep_min_hash`` and hashlib; (c)
   ``forward_step_example`` on the card against its plain version and, at
   the main path's shape, against ``sweep_min_hash``; each leg's time to
   Result, the cells' ``federation.*`` / ``fed.*`` / ``gossip.*`` counters
   and launches per miner;
18. tools path — the port's operator tools (``bitcoin_miner_tpu_torch.tools``)
   on the card: ``loadgen`` in this process in its default mode (8 clients,
   32 jobs, half repeats, each distinct job [0, 1e9..2e9] on two cuda
   miners, ``--oracle card``: gateway hits = jobs - distinct + 1, the
   repeat probe 0 chunks, fewer launches than the baseline leg),
   ``--overlap`` (its sub-range probe 0 chunks) and ``--open-loop 2
   --duration 5`` (p50, p95); ``chaos_replay`` burst-loss on [0,
   19,999,999,999] with three cuda miners and the death-detect federation
   drill to 9,999,999,999, both ``--oracle card``; the autoscale
   supervisor as a process against an ``apps.server --fleet-log`` process,
   fed burn rows that this script appends to the log: it spawns one cuda
   worker, which alone serves a 1e10 job (held to ``sweep_min_hash`` and
   hashlib) and drains with exit 0 when the supervisor is SIGTERMed;
19. hot path — the hot plane's merge kernel against its plain version,
   bit-exact, over seeded sequences and random carries with one and two
   shard outputs (ties, sentinels, a vacant carry against h0 == U32_MAX);
   ``sweep_min_hash(hot=True)`` against the per-chunk sweep on 1e9-nonce
   Requests of the three kernels' paths, and against the oracle on small
   ranges across digit boundaries, across 10^19 and up to 2^64 - 1, both
   sieve forms; ``SweepPipeline(hot=True)`` over back-to-back jobs, one
   wholly host-folded; two shards on cuda:0 with ``hot=True`` against one
   device; the miner over LSP through ``make_async_search("cuda",
   hot=True)``, each Result equal to the per-chunk miner's, the merge
   launched once per kernel launch; a U H H U pair of 1e9 Requests
   (per-chunk, hot) in nonces/s; the merge's device time per launch (a
   CUDA Graph of launches) beside an empty kernel's timed the same way,
   the host's issue time per launch and its plain version's;
20. numbers — ms per full dispatch of the min-hash kernel ("cmu440", the
   50- and the 56-character message) and of both kernels on the same
   dispatches (CUDA events, in turns, each timed output held to the plain
   version),
   the plain versions' ms at that shape and the bound, nonces/s per 1e9
   Request on both rungs as an interleaved same-seed pair; the BLAKE2b
   kernel's ms per full dispatch (one and two tail blocks, on the operands
   phase 5 held to the plain version), its bound and the plain version's
   ms; nonces/s of the native host sweep and the host
   fold of the first Request's d <= 5 classes with it and with hashlib;
   each beside the card.

Prints the kernels' JSON line, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line.  Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
U32_MAX = 0xFFFFFFFF
I32_MAX = 0x7FFFFFFF
REPLACES = "bitcoin_miner_tpu/ops/pallas_sha256.py:93"
SOURCE = "bitcoin_miner_tpu_torch/csrc/sha256_minhash.cu"
F_REPLACES = "bitcoin_miner_tpu/ops/pallas_sha256.py:536"
F_SOURCE = "bitcoin_miner_tpu_torch/csrc/sha256_minhash_factored.cu"
B_REPLACES = "bitcoin_miner_tpu/ops/blake2b.py::make_blake2b_kernel_body"
B_SOURCE = "bitcoin_miner_tpu_torch/csrc/blake2b_minhash.cu"
H_REPLACES = "bitcoin_miner_tpu/ops/sweep.py:962"  # make_hot_step's _merge (:924)
H_SOURCE = "bitcoin_miner_tpu_torch/csrc/hot_merge.cu"
# BLAKE2b layouts at d = 10: 120 bytes + separator puts the low digits
# across the 128-byte block boundary (two tail blocks, both per lane); 126
# puts them all in the second (the first once per CUDA block); 200 folds
# one prefix block into the midstate (one tail block).
B2_TWO = ("Sphinx of black quartz, judge my vow! " * 4)[:120]
B2_FB1 = ("Five quacking zephyrs jolt my wax bed. " * 4)[:126]
B2_FOLDED = ("Jived fox nymph grabs quick waltz; " * 6)[:200]
TWO_BLOCK_DATA = "The quick brown fox jumps over the lazy dog again!"  # 50 chars
# At d = 10, k = 6, k_in = 3: the inner digits straddle tail blocks 1 and 2
# (54 chars), or all lie in block 2, so block 1 is per-group work (56 chars).
STRADDLE_DATA = "How vexingly quick daft zebras jump, said the old man."
FIB1_DATA = "Pack my box with five dozen liquor jugs, then ship it!!!"
MAIN_B, MAIN_K = 1024, 6  # the cuda rung's batch and max_k (ops/sweep.py auto_tune)
MAIN_K_IN = 3  # default_factor_k_in(MAIN_K)
# One rank of the multihost phase: the port miner's main with this
# process's argv, then its return code and the kernel's launch count.
RANK_CODE = """
import json, sys
from bitcoin_miner_tpu_torch.apps import miner
from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
rc = miner.main(["miner", *sys.argv[1:]])
print(json.dumps({"main_rc": rc, "minhash_launches": minhash.launches}), flush=True)
sys.exit(rc)
"""


# One miner of the serving phase: the port miner's main with this process's
# argv, then its return code and every kernel's launch count.
SERVE_MINER_CODE = """
import json, sys
from bitcoin_miner_tpu_torch.apps import miner
from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored
rc = miner.main(["miner", *sys.argv[1:]])
print(json.dumps({"main_rc": rc, "launches": {k.__name__: k.launches for k in
                  (minhash, minhash_factored, blake2b_minhash)}}), flush=True)
sys.exit(rc)
"""
# The serving phase's time limits (s): a miner's start-up to its Join, one
# job from its client's start to its Result, the whole phase (every wait
# ends at the phase's limit too).
SERVE_JOIN_S, SERVE_JOB_S, SERVE_PHASE_S = 90, 120, 300
# The serving phase's jobs (data, maxNonce): three concurrent ones (the last
# short enough for hashlib), the kill drill, the async-ingress repeat, the
# blake2b64 one; and the miners' arguments (none: their defaults).
SERVE_JOBS = [("cmu440", 9_999_999_999), (FIB1_DATA, 4_999_999_999), ("cmu440", 999_999)]
SERVE_DRILL = ("drill", 19_999_999_999)
SERVE_ASYNC_JOB = ("cmu440", 9_999_999_999)
SERVE_B2_JOB = ("cmu440", 1_999_999_999)
SERVE_MINER_ARGS: list = []
# One miner of the telemetry phase: the port miner's main with this
# process's argv and its tracer armed (its serving conn id rides the "lsp
# connect" event), then a report: return code, launch counts, the conn ids
# it joined with, its dispatch_done events and its registry's final state.
TELE_MINER_CODE = """
import json, sys
from bitcoin_miner_tpu_torch.apps import miner
from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored
from bitcoin_miner_tpu_torch.utils.metrics import METRICS
from bitcoin_miner_tpu_torch.utils.trace import TRACE
TRACE.enable(capacity=10**6)
rc = miner.main(["miner", *sys.argv[1:]])
rows = TRACE.drain()
print(json.dumps({
    "main_rc": rc,
    "launches": {k.__name__: k.launches for k in (minhash, minhash_factored, blake2b_minhash)},
    "conns": [r["attrs"]["conn"] for r in rows
              if (r["span"], r["event"]) == ("lsp", "connect") and r["attrs"]["label"] is None],
    "dispatch_done": sum(1 for r in rows if (r["span"], r["event"]) == ("kernel", "dispatch_done")),
    "state": METRICS.export_state()}), flush=True)
sys.exit(rc)
"""
# The telemetry phase: the miners' export interval (s), the server's SLO
# spec for the throttled run (chunk RTT over 1 s is bad; 99% good; 5 s /
# 10 s windows; burn 2), miner-c's pace (nonces/s: every chunk it gets is
# the scheduler's 50,000-nonce minimum, so 1.67 s each, several times a
# healthy miner's chunk time; the hub flags a straggler from 8 samples, so
# the run keeps it busy over 20 s), the throttled run's jobs, the clean
# run's and the phase's time limit.
TELE_INTERVAL = 0.5
TELE_SLO = "chunk_p95=1,objective=0.99,window=5/10,burn=2,min_events=4"
TELE_THROTTLE_NPS = 30_000
TELE_JOBS = [("cmu440", 249_999_999_999), (FIB1_DATA, 9_999_999_999)]
TELE_CLEAN_JOBS = [("cmu440", 9_999_999_999), (FIB1_DATA, 4_999_999_999)]
TELE_PHASE_S = 240
TELE_PAIR_REQUESTS = 9  # per leg of the overhead pair; the first is not timed
TELE_PAIR_SIZE = 10**9  # nonces per Request of the pair
LIFETIME = re.compile(r"miner: (\d+) nonces swept \([\d,]+/s lifetime\)")
# The observer of every port miner process in the gateway and autoscale
# phases, installed as ``sitecustomize`` on the PYTHONPATH of their fleets:
# in a ``python -m bitcoin_miner_tpu_torch.apps.miner`` process (the plain
# binary, as the autoscaler spawns it) it arms the tracer, publishes the
# min-hash kernel's launch count to ``launches.<pid>`` whenever it moves,
# and at exit writes ``worker.<pid>.json``: argv, launches, the code given
# to ``sys.exit`` and the miner's trace events.  Any other process only
# chains to the next ``sitecustomize`` on the path.
WORKER_HOOK = """
import os, sys


def _chain():
    import importlib.machinery, importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    for p in sys.path:
        if os.path.abspath(p or ".") == here:
            continue
        spec = importlib.machinery.PathFinder.find_spec("sitecustomize", [p])
        if spec is not None and spec.loader is not None:
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
            return


_chain()
_DIR = os.environ.get("SMOKE_WORKER_DIR")
if _DIR and "bitcoin_miner_tpu_torch.apps.miner" in getattr(sys, "orig_argv", ()):
    import atexit, json, threading, time
    from bitcoin_miner_tpu_torch.utils.trace import TRACE

    TRACE.enable(capacity=1 << 20)
    _code = []
    _sys_exit = sys.exit

    def _exit(code=None):
        _code.append(code)
        _sys_exit(code)

    sys.exit = _exit

    def _launches():
        # The module may be mid-import when this runs: no wrapper yet is 0.
        m = sys.modules.get("bitcoin_miner_tpu_torch.ops.sha256_minhash")
        return getattr(getattr(m, "minhash", None), "launches", 0)

    def _publish():
        live, last = os.path.join(_DIR, f"launches.{os.getpid()}"), None
        while True:
            n = _launches()
            if n != last:
                with open(live + ".tmp", "w") as f:
                    f.write(str(n))
                os.replace(live + ".tmp", live)
                last = n
            time.sleep(0.01)

    def _report():
        rows = TRACE.drain()
        path = os.path.join(_DIR, f"worker.{os.getpid()}.json")
        with open(path + ".tmp", "w") as f:
            json.dump({"pid": os.getpid(), "argv": sys.orig_argv, "launches": _launches(),
                       "exit": _code[-1] if _code else None,
                       "miner_events": [r["event"] for r in rows if r["span"] == "miner"]}, f)
        os.replace(path + ".tmp", path)

    threading.Thread(target=_publish, name="smoke-launches", daemon=True).start()
    atexit.register(_report)
"""
# The gateway phase: the coalesced job (GATE_TWINS identical Requests at
# once; 1e10 nonces, so every twin lands while it sweeps), the gap the
# overlapping Request adds below it, the restarted server's prefill size
# and admission knobs (a 0.5/s bucket of 1 and a backlog of 2: of
# GATE_FLOOD Requests from one host at once, 1 is admitted, 2 queue and 3
# are shed), each flood Request's size, the preempting Request and the
# phase's time limit.
GATE_JOB = ("cmu440", 2_000_000_000, 11_999_999_999)
GATE_TWINS = 4
GATE_GAP = 1_000_000_000
GATE_PREFILL = 20_000_000_000
GATE_ADMISSION = ["--rate=0.5", "--burst=1", "--max-queued=2"]
GATE_FLOOD = 6
GATE_FLOOD_SIZE = 500_000_000
GATE_PREEMPT = ("preempt", 0, 1_999_999_999)
GATE_PHASE_S = 200
# The autoscale phase: every miner's pace (nonces/s, BMT_MINER_THROTTLE_NPS;
# the kernel sweeps an order of magnitude faster, so the pace is the
# capacity), the Requests' size (2 s on one paced miner), the concurrent
# load streams, the SLO (a Request over 0.5 s is bad, 90% must be good, 4 s
# / 8 s windows, burn 2, from 2 events; the liveness budget wide, so a
# drained worker aging out of the fleet view does not read as burn), the
# autoscale spec (one to two spawned workers, 2 ticks of hold, a 0.5 s
# beat) and the phase's time limit.
AS_PACE_NPS = 1_000_000_000
AS_REQUEST = 2_000_000_000
AS_STREAMS = 2
AS_SLO = "req_p95=0.5,objective=0.9,window=4/8,burn=2,min_events=2,offline=0.5"
AS_SPEC = "min=1,max=2,hold=2,up_cooldown=4,down_cooldown=6,interval=0.5"
AS_PHASE_S = 150
# The chaos phase: each standard scenario drilled in this process through
# the port's run_drill on the card, (scenario, seed, when miner-0 is killed);
# three miners, the drill's epochs (100 ms, limit 5, window 5) and a range
# whose ~1.8 s of kernel time outlasts the longest scenario's last step
# (1.6 s).  burst-loss's Gilbert–Elliott window is 6 epochs (0.6 s), so
# its seed is one whose server link enters the bad state on its first
# packet (found by pumping the seeded NetSim): its loss lands inside that
# window whatever the timing.  CHAOS_WANT: the counters each scenario's
# faults must move.  Then one job through a server process armed by
# BMT_CHAOS_SCENARIO / BMT_CHAOS_LOOP, and the phase's time limit.  The
# replay period is 1.3 s, not a divisor of the fleet's 2 s LSP epoch: at
# 1 s every epoch of a conn falls at the same point of the scenario, so a
# conn whose epochs fall in the 0.2 s server-tx cut never hears a
# heartbeat or a handshake Ack (a miner fails to join, a client is lost),
# and one whose epochs fall in the clean part never meets the weather; at
# 1.3 s a conn's epochs step 0.7 s through the period, visiting every
# tenth of it in 13 epochs.
CHAOS_DRILLS = [("burst-loss", 92, None), ("reorder-dup-delay", 202, None),
                ("flaky-then-partition", 303, None), ("miner-partition", 404, 0.8)]
CHAOS_MINERS = 3
CHAOS_MAX_NONCE = 19_999_999_999
CHAOS_WANT = {"burst-loss": ("chaos.dropped",),
              "reorder-dup-delay": ("chaos.reordered", "chaos.duplicated", "chaos.delayed"),
              "flaky-then-partition": ("chaos.dropped", "chaos.partitioned"),
              "miner-partition": ("chaos.partitioned",)}
CHAOS_SERVE_ENV = {"BMT_CHAOS_SCENARIO": "flaky-then-partition", "BMT_CHAOS_LOOP": "1.3"}
CHAOS_SERVE_JOB = ("cmu440", 9_999_999_999)
CHAOS_DRILL_S = 60
CHAOS_PHASE_S = 150
HEALTH_CHAOS = re.compile(r"'chaos\.(\w+)': ([\d.]+)")
# The federation phase.  (a) The port's four drills in this process, miners
# on the cuda rung, every job to 9,999,999,999 (~0.9 s of kernel; a job of
# d <= 5 would be folded on the host with no launch): death-detect's key
# (homed on the dead cell), ack-retransmit's job, shed-storm's storm jobs
# (never swept: the storming cell has no miner) and its forwarded job, and
# drain-handoff's job to
# 9,999,999,999 with each of its two miners paced to 2.5e9 nonces/s, so its
# sweep takes ~2 s and the drain lands mid-flight.  (b) Two replica
# processes r1 and r2 gossiping every 0.25 s (membership declares a dead
# peer after 6 beats, 1.5 s), one miner each at its defaults, and client
# jobs to 9,999,999,999.  (c) The model entry at the main path's shape.
# Then the phase's time limit.
FED_CELLS = ("r1", "r2")
FED_DRILL_HI = 9_999_999_999
FED_DRAIN_RATE = 2_500_000_000.0
FED_GOSSIP_S = 0.25
FED_JOB_HI = 9_999_999_999
FED_DRAIN_S = 30  # SIGTERM to exit, its successor live
FED_PHASE_S = 75
HEALTH_EXTRA = re.compile(r" extra (\{.*?\})")
# The tools phase: the port's three operator tools on the card.  loadgen
# in this process: its default mode (8 clients, 32 jobs of which half
# repeat an earlier signature, each distinct job [0, 1e9..2e9] swept by
# two cuda miners, the card as the oracle), --overlap at the same size,
# and --open-loop at 2 Requests/s for 5 s; chaos_replay in this process:
# burst-loss at CHAOS_DRILLS' seed on [0, 19,999,999,999] with three
# miners, and the death-detect federation drill to 9,999,999,999; the
# autoscale supervisor as a process against a port server started with
# --fleet-log, fed burn rows that this script appends to that log (the
# server arms no SLO, so its own rows carry no alert): one cuda worker
# spawned, TOOLS_AS_JOB served by it alone, the worker drained when the
# supervisor is stopped.  Then the phase's time limit.
TOOLS_LOADGEN = ["--clients", "8", "--jobs", "32", "--dup", "0.5", "--max-nonce",
                 "1999999999", "--miners", "2", "--oracle", "card", "--timeout", "60"]
TOOLS_OPEN_LOOP = ["--open-loop", "2", "--duration", "5", "--ol-timeout", "30"]
TOOLS_CHAOS = ["--scenario", "burst-loss", "--seed", str(CHAOS_DRILLS[0][1]), "--data",
               "tools-chaos", "--max-nonce", str(CHAOS_MAX_NONCE), "--miners",
               str(CHAOS_MINERS), "--oracle", "card", "--timeout", str(CHAOS_DRILL_S)]
TOOLS_FED = ["--fed-drill", "death-detect", "--max-nonce", str(FED_DRILL_HI), "--oracle", "card"]
TOOLS_AS_SPEC = "min=0,max=1,hold=1,up_cooldown=0,down_cooldown=600,interval=0.25"
TOOLS_AS_JOB = ("tools-autoscale", 9_999_999_999)
TOOLS_PHASE_S = 90


def log(*a) -> None:
    print(*a, flush=True)


class FleetDir:
    """Processes of a fleet in one working directory (``self.dir``, with
    ``self.env``, ``self.name`` and ``self.deadline``): each process's
    output lands in ``<label>.out`` there.  Clients are ``apps.client``
    processes, labelled ``client<i>`` in order (``self.clients``)."""

    def _spawn(self, label: str, args):
        out = open(os.path.join(self.dir, f"{label}.out"), "w")
        try:
            return subprocess.Popen([sys.executable, *args], cwd=self.dir, env=self.env,
                                    stdout=out, stderr=subprocess.STDOUT)
        finally:
            out.close()

    def read(self, label: str) -> str:
        path = os.path.join(self.dir, label)
        if not os.path.exists(path):
            return ""
        with open(path) as f:
            return f.read()

    def spawn_clients(self, jobs):
        """One ``apps.client`` process per job ``(port, data, maxNonce)``,
        all at once; returns ``[(label, start time, process)]``."""
        started = []
        for port, data, hi in jobs:
            label = f"client{len(self.clients)}"
            self.clients.append(label)
            started.append((label, time.monotonic(), self._spawn(label, [
                "-m", "bitcoin_miner_tpu_torch.apps.client", f"127.0.0.1:{port}",
                data, str(hi)])))
        return started

    def finish_clients(self, started, jobs):
        """Wait for the clients :meth:`spawn_clients` started on ``jobs``;
        returns ``[(hash, nonce, seconds from the client's start to its
        exit)]``.  A client that prints anything but a Result, exits
        non-zero or runs past SERVE_JOB_S fails."""
        ended = {}  # client index -> its exit time, polled as they come
        while len(ended) < len(started):
            now = time.monotonic()
            for i, (_label, t0, p) in enumerate(started):
                if i in ended:
                    continue
                if p.poll() is not None:
                    ended[i] = now
                elif now > min(t0 + SERVE_JOB_S, self.deadline):
                    p.kill()
                    p.wait()
                    raise AssertionError(f"{self.name}: job {jobs[i]} hung past "
                                         f"{now - t0:.0f} s")
            time.sleep(0.005)
        out = []
        for i, ((label, t0, p), job) in enumerate(zip(started, jobs)):
            dt = ended[i] - t0
            text = self.read(f"{label}.out")
            m = re.fullmatch(r"Result (\d+) (\d+)\n", text)
            if p.returncode != 0 or not m:
                raise AssertionError(f"{self.name}: job {job}: client exited "
                                     f"{p.returncode}, printed {text!r}")
            out.append((int(m.group(1)), int(m.group(2)), dt))
        return out


class ServeFleet(FleetDir):
    """One port server process (``apps.server``) and its miner processes
    (``apps.miner`` through ``SERVE_MINER_CODE``) on loopback, in a working
    directory of their own: the server's ``log.txt`` and its ``--trace``
    file land there.  Clients are ``apps.client`` processes.  ``env`` adds
    variables to every process of the fleet."""

    def __init__(self, workdir: str, name: str, deadline: float, server_args=(),
                 miner_args=(), env=None) -> None:
        import socket

        self.deadline = deadline  # the phase's, on time.monotonic()
        self.dir = os.path.join(workdir, name)
        os.makedirs(self.dir)
        self.name = name
        self.trace = os.path.join(self.dir, "trace.jsonl")
        self.miner_args = list(miner_args)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.bind(("127.0.0.1", 0))
            self.port = sock.getsockname()[1]
        self.env = {**os.environ, **(env or {}), "PYTHONPATH": os.pathsep.join(
            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
        self.server = self._spawn("server", ["-m", "bitcoin_miner_tpu_torch.apps.server",
                                             str(self.port), f"--trace={self.trace}",
                                             *server_args])
        self.miners = []  # [(process, server conn id)]
        self.clients = []  # output labels of the client processes
        self.launches = []  # each drained miner's launch counts
        self.stopped = None  # the thread that stops the server

    def wait_for(self, pattern: str, count: int, timeout: float):
        """The ``count``-th match of ``pattern`` in the server's log.txt;
        fails if the server exits or the time runs out first."""
        deadline = min(time.monotonic() + timeout, self.deadline)
        while True:
            found = re.findall(pattern, self.read("log.txt"))
            if len(found) >= count:
                return found[count - 1]
            if self.server.poll() is not None:
                raise AssertionError(f"{self.name}: the server exited "
                                     f"{self.server.returncode}: {self.read('server.out')!r}")
            if time.monotonic() > deadline:
                raise AssertionError(f"{self.name}: no {pattern!r} within {timeout} s")
            time.sleep(0.05)

    def start_miners(self, n: int, serial: bool):
        """Start ``n`` miners; with ``serial``, each after the previous one
        joined, so each process's server conn id is known."""
        procs = []
        for _ in range(n):
            i = len(self.miners) + len(procs)
            procs.append(self._spawn(f"miner{i}", ["-c", SERVE_MINER_CODE,
                                                   f"127.0.0.1:{self.port}",
                                                   *self.miner_args]))
            if serial:
                conn = self.wait_for(r"miner (\d+) joined", i + 1, SERVE_JOIN_S)
                self.miners.append((procs.pop(), int(conn)))
        for p in procs:
            self.miners.append((p, None))
        if not serial:
            self.wait_for(r"miner (\d+) joined", len(self.miners), SERVE_JOIN_S)

    def jobs(self, jobs, kill=None):
        """Run one ``apps.client`` process per job ``(data, maxNonce)``, all
        at once.  With ``kill`` (a miner index), SIGKILL that miner 0.5 s
        after the server logged the first job's Request.  Returns
        ``[(hash, nonce, seconds from the client's start to its exit)]`` and
        the kill's monotonic time; a client that prints anything but a
        Result, exits non-zero or runs past SERVE_JOB_S fails."""
        started = self.spawn_clients([(self.port, data, hi) for data, hi in jobs])
        killed_at = None
        if kill is not None:
            self.wait_for(rf"request from \d+: data={re.escape(repr(jobs[0][0]))}", 1, 60)
            time.sleep(0.5)
            proc, _conn = self.miners[kill]
            proc.kill()
            killed_at = time.monotonic()
            proc.wait()
        return self.finish_clients(started, jobs), killed_at

    def stop(self) -> None:
        """SIGTERM the live miners (they answer what they hold and exit 0,
        printing their launch counts), then stop the server in the
        background: it exits once LSP has given up on every conn."""
        if self.server.poll() is not None:
            raise AssertionError(f"{self.name}: the server exited {self.server.returncode} "
                                 f"before it was stopped: {self.read('server.out')[-2000:]!r}")
        for i, (p, _conn) in enumerate(self.miners):
            if p.poll() is not None:
                continue
            p.terminate()
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                raise AssertionError(f"{self.name}: miner {i} did not drain")
            text = self.read(f"miner{i}.out")
            last = [ln for ln in text.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not last:
                raise AssertionError(f"{self.name}: miner {i} exited {p.returncode}: "
                                     f"{text[-2000:]!r}")
            self.launches.append(json.loads(last[-1])["launches"])

        def stop_server():
            self.server.send_signal(2)  # SIGINT: serve()'s shutdown, then LSP's
            try:
                self.server.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.server.kill()
                self.server.wait()

        self.stopped = threading.Thread(target=stop_server, daemon=True)
        self.stopped.start()

    def kill_all(self) -> None:
        for p in [self.server] + [p for p, _c in self.miners]:
            if p.poll() is None:
                p.kill()
                p.wait()

    def trace_events(self):
        rows = []
        for line in self.read("trace.jsonl").splitlines():
            try:
                rows.append(json.loads(line))
            except ValueError:
                pass  # a line torn by the stop
        return rows


class TeleFleet(ServeFleet):
    """A serving fleet with the fleet metrics plane armed: the server gets
    a telemetry port, a fleet log and a Prometheus file in its directory;
    each miner (``TELE_MINER_CODE``) its own arguments, its stdout (the
    report) and its stderr (the lifetime line) in files apart."""

    def __init__(self, workdir: str, name: str, deadline: float, server_args=()) -> None:
        import socket

        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.bind(("127.0.0.1", 0))
            self.tport = sock.getsockname()[1]
        super().__init__(workdir, name, deadline, [
            f"--telemetry-port={self.tport}", "--fleet-log=fleet.jsonl",
            "--prom=metrics.prom", *server_args])
        self.names = []

    def start_tele_miners(self, per_miner: dict, wait: bool = True) -> None:
        """One miner per ``{source: extra args}``, all at once; with
        ``wait``, until every one joined."""
        for source, extra in per_miner.items():
            i = len(self.miners)
            out = open(os.path.join(self.dir, f"miner{i}.out"), "w")
            err = open(os.path.join(self.dir, f"miner{i}.err"), "w")
            try:
                p = subprocess.Popen(
                    [sys.executable, "-c", TELE_MINER_CODE, f"127.0.0.1:{self.port}",
                     "--telemetry", f"127.0.0.1:{self.tport}", "--telemetry-interval",
                     str(TELE_INTERVAL), "--source", source, *extra],
                    cwd=self.dir, env=self.env, stdout=out, stderr=err)
            finally:
                out.close()
                err.close()
            self.miners.append((p, None))
            self.names.append(source)
        if wait:
            self.wait_for(r"miner (\d+) joined", len(self.miners), SERVE_JOIN_S)

    def states(self):
        """Every fleet-log state so far (a line torn by a write is skipped)."""
        out = []
        for line in self.read("fleet.jsonl").splitlines():
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
        return out

    def settle(self) -> dict:
        """Wait until the server holds no chunk at any miner (every Request
        answered), then two export intervals, a publish interval and a
        tick more, so each miner's last snapshot is in the fleet log; the
        last fleet-log state."""
        deadline = min(time.monotonic() + 30, self.deadline)
        while True:
            st = self.states()
            if st and st[-1]["gauges"].get("gauge.inflight_chunks") == 0:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{self.name}: chunks still held at miners: "
                                     f"{st[-1]['gauges'] if st else None}")
            time.sleep(0.1)
        time.sleep(2 * TELE_INTERVAL + 2.0 + 1.0)
        return self.states()[-1]

    def reports(self):
        """Each stopped miner's report, in start order."""
        out = []
        for i in range(len(self.miners)):
            last = [ln for ln in self.read(f"miner{i}.out").splitlines() if ln.startswith("{")]
            if not last:
                raise AssertionError(f"{self.name}: miner {i} printed no report")
            out.append(json.loads(last[-1]))
        return out


class WorkerObserver:
    """Launch counts and exit reports of plain port miner processes
    observed by WORKER_HOOK in ``self.workers`` (needs ``self.name`` and
    ``self.deadline`` too)."""

    def live_launches(self) -> dict:
        """pid -> the min-hash kernel's launches so far, per observed miner
        process (each publishes its count as it moves)."""
        out = {}
        for name in os.listdir(self.workers):
            if name.startswith("launches.") and not name.endswith(".tmp"):
                try:
                    with open(os.path.join(self.workers, name)) as f:
                        out[int(name.split(".")[1])] = int(f.read() or 0)
                except (OSError, ValueError):
                    pass  # mid-replace: read again
        return out

    def settled(self) -> dict:
        """:meth:`live_launches` once no count has moved for 0.15 s."""
        last, since = None, time.monotonic()
        while True:
            now = self.live_launches()
            if now != last:
                last, since = now, time.monotonic()
            elif time.monotonic() - since >= 0.15:
                return now
            if time.monotonic() > self.deadline:
                raise AssertionError(f"{self.name}: launch counts never settled")
            time.sleep(0.02)

    def reports(self) -> dict:
        """pid -> the exit report of every observed process that ended."""
        out = {}
        for name in os.listdir(self.workers):
            if name.startswith("worker.") and name.endswith(".json"):
                with open(os.path.join(self.workers, name)) as f:
                    rep = json.load(f)
                out[rep["pid"]] = rep
        return out


def write_hook(workdir: str) -> str:
    """WORKER_HOOK as ``sitecustomize`` in ``<workdir>/hook``; returns
    that directory, to lead a fleet's PYTHONPATH."""
    hook = os.path.join(workdir, "hook")
    os.makedirs(hook, exist_ok=True)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(WORKER_HOOK)
    return hook


class GateFleet(WorkerObserver, ServeFleet):
    """A serving fleet whose miners are the plain port miner binary
    (``python -m bitcoin_miner_tpu_torch.apps.miner``, at its defaults:
    the cuda rung on the card), observed by WORKER_HOOK: the fleet's
    PYTHONPATH starts with a directory holding the hook, and its processes
    report to ``<name>-workers/``.  Processes the server spawns inherit
    both."""

    def __init__(self, workdir: str, name: str, deadline: float, server_args=(),
                 env=None) -> None:
        self.workers = os.path.join(workdir, f"{name}-workers")
        hook = write_hook(workdir)
        os.makedirs(self.workers)
        self.extra_env = {"SMOKE_WORKER_DIR": self.workers, **(env or {}),
                          "PYTHONPATH": os.pathsep.join(
                              p for p in (hook, ROOT, os.environ.get("PYTHONPATH")) if p)}
        self.launches_by_miner = []  # each stopped miner's final count
        super().__init__(workdir, name, deadline, server_args)

    def _spawn(self, label: str, args):
        self.env.update(self.extra_env)
        return super()._spawn(label, args)

    def start_port_miners(self, n: int, extra=()) -> None:
        """``n`` plain port miners at their defaults, all at once, until
        every one joined."""
        for _ in range(n):
            self.miners.append((self._spawn(f"miner{len(self.miners)}", [
                "-m", "bitcoin_miner_tpu_torch.apps.miner", f"127.0.0.1:{self.port}",
                *extra]), None))
        self.wait_for(r"miner (\d+) joined", len(self.miners), SERVE_JOIN_S)

    def stop(self) -> None:
        """SIGTERM the miners this script started (they answer what they
        hold and exit 0), check each exit and its report, then stop the
        server in the background."""
        if self.server.poll() is not None:
            raise AssertionError(f"{self.name}: the server exited {self.server.returncode} "
                                 f"before it was stopped: {self.read('server.out')[-2000:]!r}")
        for p, _conn in self.miners:
            if p.poll() is None:
                p.terminate()
        for i, (p, _conn) in enumerate(self.miners):
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                raise AssertionError(f"{self.name}: miner {i} did not drain")
            rep = self.reports().get(p.pid)
            if p.returncode != 0 or rep is None or rep["exit"] != 0:
                raise AssertionError(f"{self.name}: miner {i} exited {p.returncode}, report "
                                     f"{rep}: {self.read(f'miner{i}.out')[-2000:]!r}")
            self.launches_by_miner.append(rep["launches"])

        def stop_server():
            self.server.send_signal(2)  # SIGINT: serve()'s shutdown, then LSP's
            try:
                self.server.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.server.kill()
                self.server.wait()

        self.stopped = threading.Thread(target=stop_server, daemon=True)
        self.stopped.start()

    def last_state(self) -> dict:
        """The server's last fleet-log state (its own registry is a source
        of it), read 2.5 s from now (the hub publishes every 2 s)."""
        time.sleep(2.5)
        states = [ln for ln in self.read("fleet.jsonl").splitlines() if ln.strip()]
        for line in reversed(states):
            try:
                return json.loads(line)
            except ValueError:
                continue  # torn by a write
        raise AssertionError(f"{self.name}: no fleet-log state")


class FedFleet(WorkerObserver, FleetDir):
    """Two port replica processes (``python -m
    bitcoin_miner_tpu_torch.apps.federation``, r1 and r2, each with the
    other as its peer) and one plain port miner per cell at its defaults
    (the cuda rung), observed by WORKER_HOOK, in a working directory of
    their own: each cell's ``log.<cell>.txt`` and ``<cell>.trace.jsonl``
    and every process's output land there.  Clients are ``apps.client``
    processes."""

    def __init__(self, workdir: str, deadline: float) -> None:
        import socket

        self.name = "federation"
        self.deadline = deadline
        self.dir = os.path.join(workdir, "federation")
        self.workers = os.path.join(workdir, "federation-workers")
        os.makedirs(self.dir)
        os.makedirs(self.workers)
        hook = write_hook(workdir)
        self.env = {**os.environ, "SMOKE_WORKER_DIR": self.workers,
                    "PYTHONPATH": os.pathsep.join(
                        p for p in (hook, ROOT, os.environ.get("PYTHONPATH")) if p)}
        socks = []
        for _ in range(2 * len(FED_CELLS)):
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.bind(("127.0.0.1", 0))
            socks.append(sock)
        ports = [sock.getsockname()[1] for sock in socks]
        for sock in socks:
            sock.close()
        self.port = dict(zip(FED_CELLS, ports[:len(FED_CELLS)]))
        self.fed_port = dict(zip(FED_CELLS, ports[len(FED_CELLS):]))
        self.cells = {}  # cell -> its replica process
        self.miners = {}  # cell -> its miner process
        self.clients = []  # output labels of the client processes

    def start_cell(self, cell: str, label: str) -> None:
        """The replica ``cell`` on its ports; ``label`` names its stdout
        (``<label>.out``) and its trace (``<label>.trace.jsonl``)."""
        peers = ",".join(f"{o}=127.0.0.1:{self.fed_port[o]}" for o in FED_CELLS if o != cell)
        self.cells[cell] = self._spawn(label, [
            "-m", "bitcoin_miner_tpu_torch.apps.federation", str(self.port[cell]),
            f"--cell={cell}", f"--fed-port={self.fed_port[cell]}", f"--peers={peers}",
            f"--gossip-interval={FED_GOSSIP_S}", f"--trace={label}.trace.jsonl"])
        self.wait_for(cell, rf"Replica {cell} listening", 1, 30, out=label)

    def start(self) -> None:
        """Both replicas, then one miner per cell (:meth:`joined` waits
        for their Joins)."""
        for cell in FED_CELLS:
            self.start_cell(cell, cell)
        for cell in FED_CELLS:
            self.miners[cell] = self._spawn(f"miner-{cell}", [
                "-m", "bitcoin_miner_tpu_torch.apps.miner", f"127.0.0.1:{self.port[cell]}"])

    def joined(self) -> None:
        for cell in FED_CELLS:
            self.wait_for(cell, r"miner (\d+) joined", 1, SERVE_JOIN_S)

    def wait_for(self, cell: str, pattern: str, count: int, timeout: float,
                 out=None):
        """The ``count``-th match of ``pattern`` in ``cell``'s log (in the
        stdout ``<out>.out`` when given); fails if the replica exits or the
        time runs out first."""
        deadline = min(time.monotonic() + timeout, self.deadline)
        label = f"{out}.out" if out else f"log.{cell}.txt"
        while True:
            found = re.findall(pattern, self.read(label))
            if len(found) >= count:
                return found[count - 1]
            proc = self.cells[cell]
            if proc.poll() is not None:
                raise AssertionError(f"{cell} exited {proc.returncode}: "
                                     f"{self.read(f'{cell}.out')[-2000:]!r}")
            if time.monotonic() > deadline:
                raise AssertionError(f"{cell}: no {pattern!r} within {timeout} s")
            time.sleep(0.05)

    def jobs(self, jobs):
        """:meth:`FleetDir.finish_clients` of one ``apps.client`` per job
        ``(cell, data, maxNonce)``, all at once, at the cell's public
        port."""
        return self.finish_clients(self.spawn_clients(
            [(self.port[cell], data, hi) for cell, data, hi in jobs]), jobs)

    def trace(self, label: str):
        rows = []
        for line in self.read(f"{label}.trace.jsonl").splitlines():
            try:
                rows.append(json.loads(line))
            except ValueError:
                pass  # a line torn by a kill
        return rows

    def counters(self, cell: str) -> dict:
        """The ``federation.*`` / ``fed.*`` / ``gossip.*`` counters of the
        cell's last health line (every 10 s, a repeat skipped), and the
        line's peer states."""
        import ast

        lines = re.findall(r"health .*", self.read(f"log.{cell}.txt"))
        if not lines:
            return {}
        m = HEALTH_EXTRA.search(lines[-1])
        extra = ast.literal_eval(m.group(1)) if m else {}
        out = {k: v for k, v in extra.items()
               if k.startswith(("federation.", "fed.", "gossip."))}
        peers = re.search(r" fed_peers=(\S+)", lines[-1])
        if peers:
            out["fed_peers"] = peers.group(1)
        return out

    def kill_all(self) -> None:
        for p in [*self.cells.values(), *self.miners.values()]:
            if p.poll() is None:
                p.kill()
                p.wait()


def parse_prom(text: str) -> dict:
    """Check ``text`` as Prometheus text exposition (version 0.0.4): every
    sample's family declared by one ``# TYPE`` line before it, names and
    labels well formed, values numbers.  Returns the unlabelled samples."""
    sample = re.compile(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
                        r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? (\S+)')
    types, values = {}, {}
    for n, line in enumerate(text.splitlines(), 1):
        if line.startswith("# TYPE "):
            _h, _t, name, kind = line.split(" ")
            if name in types or kind not in ("counter", "gauge", "histogram", "summary",
                                             "untyped"):
                raise AssertionError(f"prom line {n}: bad TYPE {line!r}")
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        m = sample.fullmatch(line)
        if not m:
            raise AssertionError(f"prom line {n}: not a sample: {line!r}")
        name, labels, value = m.groups()
        float(value)  # raises on a non-number
        family = name
        if name not in types:
            family = re.sub(r"_(bucket|sum|count)$", "", name)
            if types.get(family) != "histogram":
                raise AssertionError(f"prom line {n}: {name} has no TYPE before it")
        if labels is None:
            values[name] = float(value)
    if not values:
        raise AssertionError("prom text has no samples")
    return values


def hist_summary(state) -> dict:
    """A histogram state's count, exact mean and p50/p95 (log-bucket upper
    edges, so within one 19% bucket above the true sample quantile)."""
    from bitcoin_miner_tpu_torch.utils.metrics import Histogram

    h = Histogram.from_state(state or {})
    return {"count": h.count(), "mean_s": h.mean(), "p50_s": h.quantile(0.5),
            "p95_s": h.quantile(0.95)}


def smi(query: str) -> str:
    from bitcoin_miner_tpu_torch.utils.platform import nvidia_smi

    return nvidia_smi(query) or ""


def kernel_label(mangled: str):
    """``minhash_kernel<NB, FB, sieve>`` / ``factored_kernel<NB, FIB, sieve>``
    / ``blake2b_kernel<NB, FB, sieve>`` / ``hot_merge_kernel`` /
    ``empty_kernel`` for a mangled kernel name, else None."""
    t = re.search(r"(minhash_kernel|factored_kernel|blake2b_kernel)ILi(\d)E(?:Li(\d)E)?Lb([01])E",
                  mangled)
    if not t:
        t = re.search(r"\d(hot_merge_kernel|empty_kernel)E", mangled)
        return t.group(1) if t else None
    args = [t.group(2)] + ([t.group(3)] if t.group(3) else [])
    return f"{t.group(1)}<{', '.join(args)}, {'true' if t.group(4) == '1' else 'false'}>"


def ptxas_stats(log: str) -> dict:
    """Registers and spill bytes of each kernel instance, from nvcc's
    ``-Xptxas -v`` output."""
    stats, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            label = kernel_label(m.group(1))
            cur = stats.setdefault(label, {}) if label else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return stats


def sass_mix(lib_path, nvcc: str) -> dict:
    """Static SASS instruction counts of each min-hash kernel instance in
    the built library (``cuobjdump -sass``), by opcode class: what the
    compiled lane loop issues, beside the derived minimum of ``lane_ops``.
    Empty when cuobjdump is not beside nvcc."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=120).stdout
    mixes, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = kernel_label(m.group(1))
            cur = None
            if label:
                cur = mixes.setdefault(
                    label, {"SHF": 0, "LOP3": 0, "IADD3": 0, "IMAD": 0, "other": 0, "total": 0})
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if cur is not None and m:
            op = m.group(1)
            cur[op if op in cur else "other"] += 1
            cur["total"] += 1
    return mixes


class Smoke:
    def __init__(self, torch) -> None:
        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.card = ""
        self.failures = []
        self.k_stats = {}
        self.f_stats = {}  # the factored kernel's
        self.b_stats = {}  # the BLAKE2b kernel's
        # message -> (operands, counters, plain result, plain ms) of a BLAKE2b
        # full dispatch (MAIN_B rows x 10^MAIN_K lanes)
        self.b_full = {}
        self.w_rates = {}  # workload -> [(data, lo, hi, nonces/s)] per Request
        self.plain_ms = {}  # job data -> ms of the plain version on its full dispatch
        # message -> (n_tb, operands, plain result, plain ms or None) of a
        # full dispatch that both kernels are timed on
        self.full_disp = {}
        self.folds = {}  # job data -> the unfactored main path's fold
        # miner argv joined -> {(data, lo, hi): (hash, nonce)} of each Result
        self.results = {}
        self.mesh = {}  # the mesh path's launches and rates
        self.multihost = {}  # the multihost miner's ranks
        self.native = {}  # the native host sweep's numbers
        self.serving = {}  # the serving path's jobs, times and launches
        self.h_stats = {}  # the hot merge kernel's
        self.hot = {}  # the hot path's launches, rates and checks
        self.tele = {}  # the telemetry path's checks, dispatch times and pair
        self.gate = {}  # the gateway path's legs, counters and launches
        self.autoscale = {}  # the autoscale path's workers, timeline and launches
        self.chaos = {}  # the chaos path's drills and served job
        self.fed = {}  # the federation path's drills, process legs and model entry
        self.tools = {}  # the tools path's runs, launches and the supervisor's leg

    # ------------------------------------------------------------ helpers

    def operands(self, data: str, d: int, k: int, rows, ntb_expect=None):
        """Device operands of one dispatch: rows = [(high_base_nonce, lo,
        hi)], plus padding rows (None)."""
        from bitcoin_miner_tpu_torch.ops.sweep import Chunk, ChunkGroup, _fill_templates
        from bitcoin_miner_tpu_torch.ops.sha256 import build_layout
        import numpy as np

        torch = self.torch
        lay = build_layout(data.encode(), d)
        if ntb_expect is not None and lay.n_tail_blocks != ntb_expect:
            raise AssertionError(f"{data!r} d={d}: {lay.n_tail_blocks} tail blocks")
        chunks = [Chunk(base=b, lo_off=lo, hi_off=hi) for b, lo, hi in rows if b is not None]
        group = ChunkGroup(d=d, k=k, chunks=tuple(chunks))
        tail, bounds = _fill_templates(lay, group, chunks, len(rows))
        return dict(
            midstate=torch.from_numpy(np.array(lay.midstate, dtype=np.uint32)).to(self.dev),
            tail=torch.from_numpy(tail).to(self.dev),
            bounds=torch.from_numpy(bounds).to(self.dev),
            low_pos=lay.digit_pos[d - k:],
        ), chunks, lay

    def time_kernel(self, fn, reps: int = 10, warm: int = 2):
        """(ms per call by CUDA events, the last call's output as a list)."""
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps, out.tolist()

    def graph_time(self, fn, reps: int, replays: int = 5) -> float:
        """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
        Graph, replayed ``replays`` times between CUDA events, the fastest
        replay over ``reps``.  The host issues nothing per call, so this
        is the card's time for the launches, not the host's."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm on a side stream, as capture asks
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(replays):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / reps)
        return best

    # ------------------------------------------------------------- phases

    def phase_env(self) -> None:
        from bitcoin_miner_tpu_torch.utils.platform import device_desc

        torch = self.torch
        self.card = smi("name,power.limit")
        log(f"nvidia-smi: {self.card}")
        log(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
        log(f"device_desc: {device_desc()}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"devices {torch.cuda.device_count()} python {sys.version.split()[0]}")

    def phase_build(self) -> None:
        from bitcoin_miner_tpu_torch import native
        from bitcoin_miner_tpu_torch.ops import _build

        t0 = time.monotonic()
        paths, errors = {}, []

        def one(name):
            try:
                paths[name] = (native.build() if name == "native"
                               else _build.build(name, verbose=True))
            except Exception as e:  # re-raised below, after all joined
                errors.append(e)

        threads = [threading.Thread(target=one, args=(n,))
                   for n in ("sha256_minhash", "sha256_minhash_factored", "blake2b_minhash",
                             "hot_merge", "native")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if not native.available():
            raise AssertionError("the native host sweep did not load")
        log(f"built {sorted(os.path.relpath(p, ROOT) for p in paths.values())} "
            f"in {time.monotonic() - t0:.1f} s (in parallel); SHA-NI on this host: "
            f"{native.have_shani()}")
        for name, stats in (("sha256_minhash", self.k_stats),
                            ("sha256_minhash_factored", self.f_stats),
                            ("blake2b_minhash", self.b_stats),
                            ("hot_merge", self.h_stats)):
            stats["sass"] = sass_mix(paths[name], _build.nvcc_path())
            stats["ptxas"] = ptxas_stats(paths[name].with_suffix(".log").read_text())
            for kern, mix in stats["sass"].items():
                log(f"  static SASS of {kern}: {mix}; ptxas {stats['ptxas'].get(kern)}")

    def phase_compare(self) -> None:
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash, minhash_plain, sieved

        torch = self.torch
        max_err = 0
        n_cases = 0
        # (data, tail blocks, k) at d = 10: the main path's two layouts at
        # k 6 and 5, and at k 1..4 (a row shorter than a run of 10 lanes or
        # a block's tile); the 56-character message with its low digits
        # straddling tail blocks 1 and 2 (k 6) or all in block 2 (k 3, so
        # the row's constant prefix is all of block 1); the 54-character
        # one at k 6.
        layouts = [(data, ntb, k) for data, ntb in (("cmu440", 1), (TWO_BLOCK_DATA, 2))
                   for k in (6, 5, 4, 3, 2, 1)]
        layouts += [(FIB1_DATA, 2, 6), (FIB1_DATA, 2, 3), (STRADDLE_DATA, 2, 6)]
        d = 10
        for data, ntb, k in layouts:
            span = 10**k
            hb = 10 ** (d - 1) // span + 7  # any high-digit prefix of class d
            if k >= 5:
                rows = [
                    (hb * span, 0, span),                 # full row
                    ((hb + 3) * span, 123, span - 77),    # partial bounds
                    ((hb + 9) * span, span // 2, span // 2 + 1000),
                    (None, 0, 0),                         # padding row
                ]
            else:  # partial rows start and end inside a run of 10 lanes
                rows = [
                    (hb * span, 0, span),
                    ((hb + 3) * span, span // 7 + 3, span - span // 9 - 1),
                    ((hb + 9) * span, span // 2 + 1, span // 2 + span // 50 + 3),
                    (None, 0, 0),
                ]
            ops, chunks, _lay = self.operands(data, d, k, rows, ntb)
            full = minhash(**ops)
            torch.cuda.synchronize()
            ref = minhash_plain(**ops)
            h0, h1, fi = full.tolist()
            if fi == I32_MAX:
                raise AssertionError("full fold found no lane")
            nonce = chunks[fi // span].base + fi % span
            if ((h0 << 32) | h1) != hash_nonce(data, nonce):
                raise AssertionError(f"kernel min disagrees with hashlib at {nonce}")
            cases = [
                ("full", None),
                ("sieve U32_MAX", U32_MAX),
                ("sieve thresh == min h0 (tie survives)", h0),
                ("sieve thresh < min h0 (I32_MAX)", h0 - 1),
            ]
            for label, th in cases:
                got = minhash(**ops, thresh=th)
                torch.cuda.synchronize()
                want = ref if th is None else minhash_plain(**ops, thresh=th)
                err = int((got - want).abs().max())
                max_err = max(max_err, err)
                n_cases += 1
                log(f"  {data[:12]!r} n_tb={ntb} k={k} {label}: kernel {got.tolist()} "
                    f"plain {want.tolist()} {'OK' if err == 0 else 'MISMATCH'}")
                if err:
                    raise AssertionError(f"kernel != plain ({data[:12]!r} {label}, n_tb={ntb}, k={k})")
                if th is not None and th < h0 and got.tolist() != [U32_MAX, U32_MAX, I32_MAX]:
                    raise AssertionError("threshold below the min did not give the sentinel")
        # The main path's own dispatches: B=1024 rows x 10^6 lanes at d=10
        # (flat_idx up to 1.024e9, grid.y 1024), and the partial batch of a
        # 5e8-nonce Request (500 rows, then padding).  The plain version runs
        # once per dispatch (its full fold, timed); each threshold's expected
        # output is that fold through ``sieved``, minhash_plain's own rule.
        for data, ntb, n_valid in (("cmu440", 1, MAIN_B), ("cmu440", 1, 500),
                                   (TWO_BLOCK_DATA, 2, MAIN_B)):
            rows = [((10**3 + r) * 10**MAIN_K, 0, 10**MAIN_K) for r in range(n_valid)]
            rows += [(None, 0, 0)] * (MAIN_B - n_valid)
            ops, chunks, _lay = self.operands(data, 10, MAIN_K, rows, ntb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = minhash_plain(**ops).tolist()
            plain_ms = (time.perf_counter() - t0) * 1e3
            nonce = chunks[ref[2] // 10**MAIN_K].base + ref[2] % 10**MAIN_K
            if ((ref[0] << 32) | ref[1]) != hash_nonce(data, nonce):
                raise AssertionError(f"plain min disagrees with hashlib at {nonce}")
            for label, th in (("full", None), ("sieve U32_MAX", U32_MAX),
                              ("sieve thresh == min h0", ref[0]),
                              ("sieve thresh < min h0", ref[0] - 1)):
                got = minhash(**ops, thresh=th).tolist()
                want = list(sieved(ref, th))
                n_cases += 1
                ok = got == want
                max_err = max(max_err, max(abs(a - b) for a, b in zip(got, want)))
                log(f"  main-path dispatch B={MAIN_B} ({n_valid} rows valid) x 1e{MAIN_K}, "
                    f"n_tb={ntb} {label}: kernel {got} plain {want} "
                    f"{'OK' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"kernel != plain at the main-path shape ({label})")
            log(f"  plain version {plain_ms:.1f} ms for {n_valid}e{MAIN_K} lanes, "
                f"n_tb={ntb} [{self.card}]")
            if n_valid == MAIN_B:
                self.plain_ms[data] = plain_ms
                self.full_disp[data] = (ntb, ops, ref, None)
        self.k_stats["max_abs_err"] = max_err
        log(f"kernel == plain, bit-exact, in {n_cases} cases (tolerance 0)")

    def phase_factored_compare(self) -> None:
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash, sieved
        from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import (
            minhash_factored, minhash_factored_plain)
        from bitcoin_miner_tpu_torch.ops.sweep import default_factor_k_in

        torch = self.torch
        max_err = 0
        n_cases = 0

        def check(label, got, want):
            nonlocal max_err, n_cases
            n_cases += 1
            err = max(abs(a - b) for a, b in zip(got, want))
            max_err = max(max_err, err)
            log(f"  {label}: kernel {got} plain {want} {'OK' if not err else 'MISMATCH'}")
            if err:
                raise AssertionError(f"factored kernel != plain ({label})")

        # (data, tail blocks, first tail block holding an inner digit at
        # d = 10, k = 6, k_in = 3)
        layouts = (("cmu440", 1, 0), (STRADDLE_DATA, 2, 0), (FIB1_DATA, 2, 1))
        for data, ntb, fib in layouts:
            for k in range(2, 7):
                k_def = default_factor_k_in(k)
                k_ins = [k_def] + ([1 if k_def > 1 else k - 1] if k > 2 else [])
                span = 10**k
                hb = 10 ** (10 - 1) // span + 7
                rows = [
                    (hb * span, 0, span),                               # full row
                    ((hb + 3) * span, span // 8, span - span // 5),     # partial bounds
                    ((hb + 9) * span, span // 2, span // 2 + span // 50 + 1),
                    (None, 0, 0),                                       # padding row
                ]
                ops, chunks, lay = self.operands(data, 10, k, rows, ntb)
                if k == MAIN_K and lay.factor(k, k_def).first_inner_word // 16 != fib:
                    raise AssertionError(f"{data!r}: not the layout this case is for")
                for k_in in k_ins:
                    full = minhash_factored_plain(**ops, k_in=k_in).tolist()
                    nonce = chunks[full[2] // span].base + full[2] % span
                    if ((full[0] << 32) | full[1]) != hash_nonce(data, nonce):
                        raise AssertionError(f"plain min disagrees with hashlib at {nonce}")
                    for th_label, th in (("full", None), ("sieve U32_MAX", U32_MAX),
                                         ("sieve thresh == min h0", full[0]),
                                         ("sieve thresh < min h0", full[0] - 1)):
                        got = minhash_factored(**ops, k_in=k_in, thresh=th).tolist()
                        check(f"{data[:12]!r} n_tb={ntb} k={k} k_in={k_in} {th_label}",
                              got, list(sieved(full, th)))
        torch.cuda.synchronize()
        # The main path's full dispatches, held to phase 3's plain folds:
        # both plain versions compute one function (the CPU tests prove it).
        for data, (ntb, ops, ref, _ms) in list(self.full_disp.items()):
            for th_label, th in (("full", None), ("sieve U32_MAX", U32_MAX),
                                 ("sieve thresh == min h0", ref[0]),
                                 ("sieve thresh < min h0", ref[0] - 1)):
                got = minhash_factored(**ops, k_in=MAIN_K_IN, thresh=th).tolist()
                check(f"main-path dispatch B={MAIN_B} x 1e{MAIN_K} {data[:12]!r} "
                      f"n_tb={ntb} {th_label}", got, list(sieved(ref, th)))
        # The 56-character message (block 1 is per-group work) at the full
        # shape, against its own plain run; the unfactored kernel too.
        rows = [((10**3 + r) * 10**MAIN_K, 0, 10**MAIN_K) for r in range(MAIN_B)]
        ops, chunks, _lay = self.operands(FIB1_DATA, 10, MAIN_K, rows, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = minhash_factored_plain(**ops, k_in=MAIN_K_IN).tolist()
        plain_ms = (time.perf_counter() - t0) * 1e3
        nonce = chunks[ref[2] // 10**MAIN_K].base + ref[2] % 10**MAIN_K
        if ((ref[0] << 32) | ref[1]) != hash_nonce(FIB1_DATA, nonce):
            raise AssertionError(f"plain min disagrees with hashlib at {nonce}")
        for th_label, th in (("full", None), ("sieve U32_MAX", U32_MAX),
                             ("sieve thresh == min h0", ref[0]),
                             ("sieve thresh < min h0", ref[0] - 1)):
            check(f"main-path dispatch {FIB1_DATA[:12]!r} factored {th_label}",
                  minhash_factored(**ops, k_in=MAIN_K_IN, thresh=th).tolist(),
                  list(sieved(ref, th)))
            check(f"main-path dispatch {FIB1_DATA[:12]!r} unfactored {th_label}",
                  minhash(**ops, thresh=th).tolist(), list(sieved(ref, th)))
        log(f"  factored plain version {plain_ms:.1f} ms for {MAIN_B}e{MAIN_K} lanes, "
            f"{FIB1_DATA[:12]!r} n_tb=2 [{self.card}]")
        self.full_disp[FIB1_DATA] = (2, ops, ref, plain_ms)
        self.plain_ms[FIB1_DATA] = plain_ms  # the factored plain: the same function
        self.f_stats["max_abs_err"] = max_err
        log(f"factored kernel == plain, bit-exact, in {n_cases} cases (tolerance 0)")

    def b_operands(self, data: str, d: int, k: int, rows, n_rows: int):
        """Device operands of one BLAKE2b dispatch: rows = [(high_base_nonce,
        lo, hi)], then padding rows up to n_rows.  Returns (operands, the
        blocks' counters, chunks)."""
        from bitcoin_miner_tpu_torch.ops import blake2b
        from bitcoin_miner_tpu_torch.ops.sweep import Chunk, ChunkGroup, _fill_templates
        import numpy as np

        torch = self.torch
        lay = blake2b.build_layout(data.encode(), d)
        chunks = [Chunk(base=b, lo_off=lo, hi_off=hi) for b, lo, hi in rows]
        group = ChunkGroup(d=d, k=k, chunks=tuple(chunks))
        tail, bounds = _fill_templates(lay, group, chunks, n_rows)
        ops = dict(
            midstate=torch.from_numpy(np.array(lay.midstate, dtype=np.uint32)).to(self.dev),
            tail=torch.from_numpy(tail).to(self.dev),
            bounds=torch.from_numpy(bounds).to(self.dev),
            low_pos=lay.digit_pos[d - k:],
        )
        return ops, dict(msg_len=lay.msg_len, tail_off=lay.tail_off), chunks

    @staticmethod
    def b_plain(ops, counters, thresh=None):
        from bitcoin_miner_tpu_torch.ops.blake2b import blake2b_minhash_plain

        return blake2b_minhash_plain(
            ops["midstate"], ops["tail"], ops["bounds"], thresh, low_pos=ops["low_pos"],
            k=len(ops["low_pos"]), **counters).tolist()

    @staticmethod
    def thresholds(h0: int):
        """The full fold and the sieve at U32_MAX, at the min h0 (the tie
        survives) and below it (no uint32 lies below 0)."""
        out = [("full", None), ("sieve U32_MAX", U32_MAX), ("sieve thresh == min h0", h0)]
        return out + ([("sieve thresh < min h0", h0 - 1)] if h0 > 0 else [])

    def phase_blake2b_compare(self) -> None:
        from bitcoin_miner_tpu_torch import workloads
        from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import sieved

        torch = self.torch
        w = workloads.get("blake2b64")
        max_err = n_cases = 0

        def check(label, got, want):
            nonlocal max_err, n_cases
            n_cases += 1
            err = max(abs(a - b) for a, b in zip(got, want))
            max_err = max(max_err, err)
            log(f"  {label}: kernel {got} plain {want} {'OK' if not err else 'MISMATCH'}")
            if err:
                raise AssertionError(f"blake2b kernel != plain ({label})")

        def held(data, chunks, span, ref):
            nonce = chunks[ref[2] // span].base + ref[2] % span
            if ((ref[0] << 32) | ref[1]) != w.hash_nonce(data, nonce):
                raise AssertionError(f"plain min disagrees with hashlib at {nonce}")

        d = 10
        for data in ("cmu440", B2_TWO, B2_FOLDED, B2_FB1):
            for k in (1, 2, 3, 4, 5, 6):
                span = 10**k
                hb = 10 ** (d - 1) // span + 7
                rows = [(hb * span, 0, span),                               # full row
                        ((hb + 3) * span, span // 7 + 3, span - span // 9 - 1),
                        ((hb + 9) * span, span // 2 + 1, span // 2 + span // 50 + 3)]
                ops, counters, chunks = self.b_operands(data, d, k, rows, 4)  # + padding
                ref = self.b_plain(ops, counters)
                held(data, chunks, span, ref)
                for label, th in self.thresholds(ref[0]):
                    got = blake2b_minhash(**ops, thresh=th, **counters).tolist()
                    check(f"{len(data)}-byte data n_tb={len(ops['tail'][0]) // 32} k={k} {label}",
                          got, list(sieved(ref, th)))
        # The main path's own dispatches: B=1024 rows x 10^6 lanes at d=10
        # on the three layouts (one tail block; two, the digits straddling
        # them; two, the digits all in the second), and the partial batch of
        # a 5e8-nonce Request (500 rows, then padding).
        for data, n_valid in (("cmu440", MAIN_B), (B2_TWO, MAIN_B), (B2_FB1, MAIN_B),
                              ("cmu440", 500)):
            rows = [((10**3 + r) * 10**MAIN_K, 0, 10**MAIN_K) for r in range(n_valid)]
            ops, counters, chunks = self.b_operands(data, 10, MAIN_K, rows, MAIN_B)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = self.b_plain(ops, counters)
            plain_ms = (time.perf_counter() - t0) * 1e3
            held(data, chunks, 10**MAIN_K, ref)
            for label, th in self.thresholds(ref[0]):
                got = blake2b_minhash(**ops, thresh=th, **counters).tolist()
                check(f"main-path dispatch {n_valid} of {MAIN_B} rows x 1e{MAIN_K}, "
                      f"{len(data)}-byte data {label}", got, list(sieved(ref, th)))
            log(f"  plain version {plain_ms:.1f} ms for {n_valid}e{MAIN_K} lanes, "
                f"{len(data)}-byte data [{self.card}]")
            if n_valid == MAIN_B:
                self.b_full[data] = (ops, counters, ref, plain_ms)
        self.b_stats["max_abs_err"] = max_err
        log(f"blake2b kernel == plain, bit-exact, in {n_cases} cases (tolerance 0)")

    def drive_miner(self, argv, jobs, hash_fn, range_fn, kernels, run=None):
        """Run the port miner's ``main`` with ``argv`` in a thread against
        this script's own LSP server (or ``run(server)``, which serves it
        some other way and returns an exit code).  Each job ``(data, hi)``
        is served as Requests of 1e9 nonces, then again as pipelined
        Requests of 5e8, and the two folds must agree; then one Request
        across 1e9 (``"cmu440"``) against ``range_fn``.  Every Result is
        held to ``hash_fn`` and kept in ``self.results[label][(data, lo,
        hi)]``, the label being ``argv`` joined.  The launch counts of
        ``kernels`` (wrappers) are set to 0 just before the miner starts and
        read just after it stops.  Returns ``(folds, rates, launches)``."""
        from bitcoin_miner_tpu_torch import lsp
        from bitcoin_miner_tpu_torch.apps import miner
        from bitcoin_miner_tpu_torch.bitcoin.message import Message, MsgType

        server = lsp.Server(0)
        port = server.port
        results = self.results.setdefault(" ".join(argv), {})
        rc = {}
        if run is None:
            def run(_server):
                return miner.main(["miner", f"127.0.0.1:{port}", *argv, "--reconnect", "0"])
        t = threading.Thread(
            target=lambda: rc.setdefault("rc", run(server)), name="port-miner", daemon=True,
        )
        for k in kernels:
            k.launches = 0  # counts from here on are this path's
        t.start()
        folds, rates = {}, []
        try:
            conn, payload = server.read()
            msg = Message.unmarshal(payload)
            if msg is None or msg.type != MsgType.JOIN:
                raise AssertionError(f"expected Join, got {payload!r}")

            def serve(data, ranges, pipelined):
                """Send Requests, read Results FIFO; returns [(lo, hi, hash,
                nonce, seconds)] with each Result checked against hash_fn."""
                out = []
                if pipelined:
                    t0 = time.monotonic()
                    for lo, hi in ranges:
                        server.write(conn, Message.request(data, lo, hi).marshal())
                for lo, hi in ranges:
                    if not pipelined:
                        t0 = time.monotonic()
                        server.write(conn, Message.request(data, lo, hi).marshal())
                    while True:
                        cid, p = server.read()
                        r = Message.unmarshal(p)
                        if cid == conn and r is not None and r.type == MsgType.RESULT:
                            break
                    dt = time.monotonic() - t0
                    if pipelined:
                        t0 = time.monotonic()
                    if not lo <= r.nonce <= hi or r.hash != hash_fn(data, r.nonce):
                        raise AssertionError(f"bad Result {r} for [{lo}, {hi}]")
                    out.append((lo, hi, r.hash, r.nonce, dt))
                    results[(data, lo, hi)] = (r.hash, r.nonce)
                    log(f"  Request {data[:12]!r}[{lo}, {hi}] -> ({r.hash}, {r.nonce}) "
                        f"{dt:.3f} s, {(hi - lo + 1) / dt:,.0f} nonces/s [{self.card}]")
                return out

            def split(lo, hi, size):
                return [(a, min(a + size - 1, hi)) for a in range(lo, hi + 1, size)]

            for data, hi in jobs:
                coarse = serve(data, split(0, hi, 10**9), pipelined=False)
                fine = serve(data, split(0, hi, 5 * 10**8), pipelined=True)
                fold = min((h, n) for _lo, _hi, h, n, _dt in coarse)
                fold2 = min((h, n) for _lo, _hi, h, n, _dt in fine)
                if fold != fold2:
                    raise AssertionError(f"{data!r}: 1e9 split {fold} != 5e8 split {fold2}")
                log(f"job {data!r} [0, {hi}]: fold {fold} equal over both splits")
                folds[data] = fold
                rates += [(data, lo, h, (h - lo + 1) / dt) for lo, h, _x, _n, dt in coarse]
            lo, hi = 999_900_000, 1_000_099_999
            (r,) = serve("cmu440", [(lo, hi)], pipelined=False)
            want = range_fn("cmu440", lo, hi)
            if (r[2], r[3]) != want:
                raise AssertionError(f"[{lo}, {hi}]: miner {r[2:4]} != oracle {want}")
            log(f"Request across 1e9 equals the oracle's min over the range: {want}")
        finally:
            server.close()
            t.join(timeout=60)
        launches = {k.__name__: k.launches for k in kernels}
        if t.is_alive():
            raise AssertionError("the miner thread did not exit")
        if rc.get("rc") != 0:
            raise AssertionError(f"miner main returned {rc.get('rc')}")
        return folds, rates, launches

    def phase_main_path(self) -> None:
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce, min_hash_range
        from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored

        folds, rates, launches = self.drive_miner(
            ["--backend", "cuda"],
            [("cmu440", 3_999_999_999), (TWO_BLOCK_DATA, 999_999_999)],
            hash_nonce, min_hash_range, (minhash, minhash_factored, blake2b_minhash))
        self.folds.update(folds)
        self.k_stats["launches"] = launches["minhash"]
        self.k_stats["rates"] = rates
        log(f"main path launched the kernel {launches['minhash']} times "
            f"(the factored kernel {launches['minhash_factored']}, the BLAKE2b kernel "
            f"{launches['blake2b_minhash']})")
        if launches["minhash"] <= 0:
            raise AssertionError("the main path never launched the kernel")

    def phase_workload_paths(self) -> None:
        from bitcoin_miner_tpu_torch import workloads
        from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored

        kernels = (minhash, minhash_factored, blake2b_minhash)
        for name, two_block, kernel in (("blake2b64", B2_TWO, "blake2b_minhash"),
                                        ("preimage", TWO_BLOCK_DATA, "minhash")):
            w = workloads.get(name)
            log(f"-- workload {name}")
            _folds, rates, launches = self.drive_miner(
                ["--backend", "cuda", "--workload", name],
                [("cmu440", 1_999_999_999), (two_block, 999_999_999)],
                w.hash_nonce, w.min_range, kernels)
            self.w_rates[name] = rates
            log(f"workload {name}: launches {launches}")
            if launches[kernel] <= 0:
                raise AssertionError(f"the {name} path never launched {kernel}")
            if name == "blake2b64":
                self.b_stats["launches"] = launches[kernel]
            else:
                self.k_stats["launches_preimage"] = launches[kernel]

    def phase_watchdog(self) -> None:
        import io

        from bitcoin_miner_tpu_torch import workloads
        from bitcoin_miner_tpu_torch.apps import miner
        from bitcoin_miner_tpu_torch.ops import sweep

        class Tee(io.StringIO):
            def write(self, text):
                sys.__stderr__.write(text)
                return super().write(text)

        w = workloads.get("blake2b64")
        lo, hi = 10**6, 10**6 + 99_999
        os.environ["BMT_WEDGE_DISPATCH"] = "1"
        sweep._WEDGE_STATE["fired"] = False
        err = Tee()
        old_err, sys.stderr = sys.stderr, err
        try:
            ts = miner.make_tiered_search("cuda", wedge_seconds=5.0, workload=w)
            try:
                got = ts.submit("cmu440", lo, hi).result(timeout=120)
                tier, downgrades = ts.active_tier, ts.downgrades
            finally:
                ts.close()
        finally:
            sys.stderr = old_err
            del os.environ["BMT_WEDGE_DISPATCH"]
        lines = [ln for ln in err.getvalue().splitlines() if "downgrading" in ln]
        want = w.min_range("cmu440", lo, hi)
        log(f"watchdog drill: result {got}, oracle {want}, active tier {tier!r}, "
            f"downgrades {downgrades}, logged {lines}")
        if got != want or tier != "cpu" or downgrades != 1 or len(lines) != 1 \
                or "'cuda'" not in lines[0] or "to 'cpu'" not in lines[0] \
                or not sweep._WEDGE_STATE["fired"]:
            raise AssertionError("the watchdog drill did not downgrade cuda -> cpu once, "
                                 "logged, with an exact Result")

    def phase_factored_path(self) -> None:
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce, min_hash_range
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored
        from bitcoin_miner_tpu_torch.ops.sweep import SweepPipeline

        def split(lo, hi, size):
            return [(a, min(a + size - 1, hi)) for a in range(lo, hi + 1, size)]

        across = ("cmu440", 999_900_000, 1_000_099_999)
        jobs = [("cmu440", r) for r in split(0, 3_999_999_999, 10**9)]
        jobs += [(TWO_BLOCK_DATA, (0, 999_999_999)), (FIB1_DATA, (0, 999_999_999)),
                 (across[0], across[1:])]
        # The 56-character job has no phase-5 fold: the unfactored pipeline
        # computes it first, outside the counted run.
        ref = SweepPipeline(backend="cuda")
        try:
            r = ref.submit(FIB1_DATA, 0, 999_999_999).result(timeout=300)
            self.folds[FIB1_DATA] = (r.hash, r.nonce)
        finally:
            ref.close()
        p = SweepPipeline(backend="cuda", factored=True)
        minhash.launches = minhash_factored.launches = 0  # the factored path's counts
        try:
            t0 = time.monotonic()
            futs = [(data, lo, hi, p.submit(data, lo, hi)) for data, (lo, hi) in jobs]
            results = []
            for data, lo, hi, fut in futs:
                r = fut.result(timeout=300)
                if not lo <= r.nonce <= hi or r.hash != hash_nonce(data, r.nonce):
                    raise AssertionError(f"bad factored result {r} for {data!r}[{lo}, {hi}]")
                results.append((data, lo, hi, r.hash, r.nonce))
                log(f"  factored {data[:12]!r}[{lo}, {hi}] -> ({r.hash}, {r.nonce})")
            wall = time.monotonic() - t0
        finally:
            p.close()
        self.f_stats["launches"] = minhash_factored.launches
        log(f"factored path: {len(jobs)} submits in {wall:.3f} s; launched the factored "
            f"kernel {minhash_factored.launches} times (the unfactored {minhash.launches})")
        if minhash_factored.launches <= 0:
            raise AssertionError("the factored path never launched the factored kernel")
        for data in ("cmu440", TWO_BLOCK_DATA, FIB1_DATA):
            fold = min((h, n) for d, lo, hi, h, n in results
                       if d == data and (d, lo, hi) != across)
            if fold != self.folds[data]:
                raise AssertionError(f"{data!r}: factored fold {fold} != unfactored "
                                     f"{self.folds[data]}")
            log(f"job {data!r}: factored fold {fold} equals the unfactored fold")
        got = next((h, n) for d, lo, hi, h, n in results if (d, lo, hi) == across)
        if got != min_hash_range(*across):
            raise AssertionError(f"{across}: factored {got} != oracle")
        log(f"factored Request across 1e9 equals the min_hash_range oracle: {got}")

    def same_as_single_device(self, key: str) -> None:
        """Every Result of the miner run ``key`` equals the single-device
        miner's (the main path's) for the same Request."""
        single = self.results["--backend cuda"]
        for req, res in self.results[key].items():
            if req not in single or single[req] != res:
                raise AssertionError(f"{key} {req}: {res} != single-device {single.get(req)}")

    def phase_mesh_path(self) -> None:
        """The multi-device sweep on the one card: (a) one shard equals the
        single-device sweep bit for bit on 1e9-nonce Requests of each
        kernel's path; (b) two shards on cuda:0 equal them too, and the
        oracle on small ranges (4 rows per shard, so both shards hold rows),
        across 10^19 and up to 2^64 - 1; (c) every card, when there are
        more; (d) the miner with ``--devices 1`` and with two shards on
        cuda:0 over LSP, each Result equal to the single-device miner's;
        (e) a same-seed U S S U pair of 1e9 Requests, single-device against
        ``devices=[cuda:0]``."""
        from bitcoin_miner_tpu_torch import lsp, workloads
        from bitcoin_miner_tpu_torch.apps import miner
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce, min_hash_range
        from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored
        from bitcoin_miner_tpu_torch.ops.sweep import SweepPipeline, sweep_min_hash
        from bitcoin_miner_tpu_torch.parallel import default_devices, sweep_min_hash_sharded

        torch, dev = self.torch, self.dev
        b2 = workloads.get("blake2b64")
        sha = workloads.get("sha256d")
        # (label, data, workload, factored, the wrapper its path launches)
        paths = [("sha256d", "cmu440", sha, False, minhash),
                 ("sha256d", FIB1_DATA, sha, False, minhash),
                 ("blake2b64", "cmu440", b2, False, blake2b_minhash),
                 ("sha256d factored", FIB1_DATA, sha, True, minhash_factored)]

        def held(label, got, want):
            got = (got.hash, got.nonce, got.lanes_swept)
            want = want if isinstance(want, tuple) else (want.hash, want.nonce, want.lanes_swept)
            log(f"  {label}: {got[:2]} {'OK' if got[:len(want)] == want else 'MISMATCH'}")
            if got[:len(want)] != want:
                raise AssertionError(f"{label}: {got} != {want}")

        lo, hi = 0, 10**9 - 1
        for label, data, w, factored, kern in paths:
            one = sweep_min_hash(data, lo, hi, device=dev, workload=w, factored=factored)
            if one.hash != w.hash_nonce(data, one.nonce):
                raise AssertionError(f"{label} {data[:12]!r}: bad single-device result {one}")
            shard_sets = [("1 shard", [dev]), ("2 shards on cuda:0", [dev, dev])]
            if torch.cuda.device_count() > 1:
                shard_sets.append((f"{torch.cuda.device_count()} cards", default_devices()))
            for name, shards in shard_sets:
                n0 = kern.launches
                got = sweep_min_hash_sharded(data, lo, hi, devices=shards, workload=w,
                                             factored=factored)
                if kern.launches == n0:
                    raise AssertionError(f"{label} {name}: {kern.__name__} never launched")
                held(f"{label} {data[:12]!r}[{lo}, {hi}] {name} == single device", got, one)
        if torch.cuda.device_count() < 2:
            log("  (c) every card: skipped, this machine has one CUDA card")
        small = [(999_000, 1_012_345, dict(max_k=3, batch_per_device=4))]
        small += [(a, b, {}) for a, b in ((10**19 - 40, 10**19 + 25), (2**64 - 60, 2**64 - 1))]
        for label, _data, w, factored, _kern in paths[::2] + paths[3:]:
            for a, b, kw in small:
                want = w.min_range("mesh", a, b)
                for sieve in (False, True):
                    for shards in ([dev], [dev, dev]):
                        got = sweep_min_hash_sharded("mesh", a, b, devices=shards, workload=w,
                                                     factored=factored, sieve=sieve, **kw)
                        held(f"{label} [{a}, {b}] sieve={sieve} {len(shards)} shard(s) "
                             f"== oracle", got, want)
        # (d) the miner over LSP: --devices 1, then two shards on cuda:0.
        kernels = (minhash, minhash_factored, blake2b_minhash)

        def two_shards(server):
            client = lsp.Client("127.0.0.1", server.port)
            try:
                miner.run_miner(client, miner.make_async_search("cuda", devices=[dev, dev]))
            finally:
                try:
                    client.close()
                except lsp.LspError:
                    pass
            return 0

        for argv, run in ((["--backend", "cuda", "--devices", "1"], None),
                          (["--backend", "cuda", "devices=[cuda:0, cuda:0]"], two_shards)):
            _folds, _rates, launches = self.drive_miner(
                argv, [("cmu440", 999_999_999)], hash_nonce, min_hash_range, kernels, run=run)
            key = " ".join(argv)
            self.same_as_single_device(key)
            log(f"miner {key}: every Result equals the single-device miner's; "
                f"launches {launches}")
            if launches["minhash"] <= 0:
                raise AssertionError(f"miner {key} never launched the kernel")
            self.mesh[f"launches {key}"] = launches
        # (e) U S S U: nonces/s per 1e9 Request, single device against one shard.
        pipes = {"single": SweepPipeline(backend="cuda"),
                 "sharded": SweepPipeline(backend="cuda", devices=[dev])}
        try:
            for p in pipes.values():  # warm: streams, pinned buffers
                p.submit("cmu440", 2 * 10**9, 2 * 10**9 + 10**6 - 1).result(timeout=300)
            lo, hi = 10**9, 2 * 10**9 - 1
            rates, found = {}, set()
            for name in ("single", "sharded", "sharded", "single"):
                t0 = time.monotonic()
                r = pipes[name].submit("cmu440", lo, hi).result(timeout=300)
                dt = time.monotonic() - t0
                if r.hash != hash_nonce("cmu440", r.nonce):
                    raise AssertionError(f"{name}: bad result {r}")
                found.add((r.hash, r.nonce))
                rates.setdefault(name, []).append((hi - lo + 1) / dt)
            if len(found) != 1:
                raise AssertionError(f"single device and one shard disagree: {found}")
        finally:
            for p in pipes.values():
                p.close()
        self.mesh["request_pair_u_s_s_u"] = rates
        log(f"nonces/s per 1e9 Request 'cmu440'[{lo}, {hi}], U S S U: single device "
            f"{rates['single']}, devices=[cuda:0] {rates['sharded']} [{self.card}]")

    def phase_multihost(self) -> None:
        """Two miner processes on the one card, ``--multihost --num-hosts
        2`` over gloo, serving this script's LSP server: each Result held
        to hashlib and to the single-device miner's for the same Request,
        the Request across 1e9 to the oracle; both processes exit 0 and
        report their launch counts (from 0 in each process)."""
        import socket

        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce, min_hash_range

        logs = os.path.join(ROOT, "bitcoin_miner_tpu_torch", "build")
        ranks = {}

        def run(server):
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                coord = sock.getsockname()[1]
            procs = []
            for i in range(2):
                with open(os.path.join(logs, f"multihost_rank{i}.log"), "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", RANK_CODE, f"127.0.0.1:{server.port}",
                         "--multihost", f"--coordinator=127.0.0.1:{coord}",
                         "--num-hosts=2", f"--host-id={i}"],
                        stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                        env={**os.environ, "PYTHONPATH": os.pathsep.join(
                            p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}))
            deadline = time.monotonic() + 300
            try:
                # A rank that fails, or a run past the deadline, ends both
                # ranks and the server (unblocking this phase's reads).
                while any(p.poll() is None for p in procs):
                    if any(p.poll() not in (None, 0) for p in procs) \
                            or time.monotonic() > deadline:
                        server.close()
                        break
                    time.sleep(0.2)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
            for i, p in enumerate(procs):
                with open(os.path.join(logs, f"multihost_rank{i}.log")) as f:
                    text = f.read()
                log(f"  rank {i} exited {p.returncode}; its output ends: {text[-600:]!r}")
                last = [ln for ln in text.splitlines() if ln.startswith("{")]
                ranks[i] = dict(rc=p.returncode, **(json.loads(last[-1]) if last else {}))
            return max(abs(p.returncode) for p in procs)

        argv = ["--multihost", "--num-hosts=2"]
        self.drive_miner(argv, [("cmu440", 999_999_999)], hash_nonce, min_hash_range, (),
                         run=run)
        self.same_as_single_device(" ".join(argv))
        log(f"multihost: every Result equals the single-device miner's; ranks {ranks}")
        for i in range(2):
            if ranks[i]["rc"] != 0 or ranks[i].get("minhash_launches", 0) <= 0:
                raise AssertionError(f"rank {i}: {ranks[i]}")
        self.multihost = ranks

    def serve_traced(self, fleet, jobs, got):
        """Per served job: the scheduler's time to Result and the Requests
        it sent, from the server's trace (job_start's data and upper name
        the job; its trace id joins the dispatch events)."""
        rows = fleet.trace_events()
        ids = {}
        for r in rows:
            a = r.get("attrs") or {}
            if r["event"] == "job_start":
                ids[(a["data"], a["upper"])] = r["trace"]
        out = []
        for (data, hi), (h, n, wall) in zip(jobs, got):
            tid = ids.get((data[:64], hi))
            done = [r for r in rows if r["trace"] == tid and r["event"] == "job_done"]
            sent = [r for r in rows if r["trace"] == tid and r["event"] == "dispatch"]
            sched_s = (done[0].get("attrs") or {}).get("elapsed") if done else None
            row = dict(data=data[:12], max_nonce=hi, result=[h, n], client_wall_s=wall,
                       client_nonces_per_s=(hi + 1) / wall, sched_s=sched_s,
                       sched_nonces_per_s=(hi + 1) / sched_s if sched_s else None,
                       requests=len(sent), trace_id=tid)
            out.append(row)
            log(f"  {fleet.name}: job {data[:12]!r} [0, {hi}] -> ({h}, {n}); time to "
                f"Result {wall:.3f} s at the client ({(hi + 1) / wall:,.0f} nonces/s), "
                f"{sched_s} s in the scheduler; {len(sent)} Requests sent [{self.card}]")
            if tid is None or not done or not sent:
                raise AssertionError(f"{fleet.name}: job {data!r} is not in the trace")
        return out, rows

    def serve_held(self, fleet, jobs, got, wl=None):
        """Each served Result held to the workload's hash_nonce and to
        ``min_hash_range`` (a job short enough for hashlib) or this
        process's ``sweep_min_hash`` over the same range on the card."""
        from bitcoin_miner_tpu_torch import workloads
        from bitcoin_miner_tpu_torch.bitcoin.hash import min_hash_range
        from bitcoin_miner_tpu_torch.ops.sweep import sweep_min_hash

        for (data, hi), (h, n, _wall) in zip(jobs, got):
            w = wl or workloads.get("sha256d")
            if h != w.hash_nonce(data, n) or not 0 <= n <= hi:
                raise AssertionError(f"{fleet.name}: bad Result ({h}, {n}) for {data!r}")
            if hi <= SERVE_JOBS[-1][1]:
                want = min_hash_range(data, 0, hi) if wl is None else wl.min_range(data, 0, hi)
                how = "min_hash_range"
            else:
                r = sweep_min_hash(data, 0, hi, device=self.dev, workload=wl)
                want, how = (r.hash, r.nonce), "sweep_min_hash on the card"
            if (h, n) != want:
                raise AssertionError(f"{fleet.name}: {data!r} [0, {hi}]: served ({h}, {n}) "
                                     f"!= {how} {want}")
            log(f"  {fleet.name}: {data[:12]!r} [0, {hi}] equals {how}: {want}")

    def phase_serving(self) -> None:
        """The port's three binaries on the card: ``apps.server`` (the
        blocking shell) with two ``apps.miner`` processes at their defaults
        (the cuda rung, the sieve kernel) and three concurrent
        ``apps.client`` jobs; then a fourth job with one miner SIGKILLed
        after the server sent it work; one long job again through a server
        with ``--async-ingress`` and two fresh miners; one job through a
        ``--workload=blake2b64`` server and miner.  Every Result is held to
        hashlib and to this process's ``sweep_min_hash`` over the same range
        on the card (an independent split), the short job to
        ``min_hash_range``.  Prints each job's time to Result (the client
        process's wall time and the scheduler's, from its trace) and
        nonces/s, the Requests the server sent per job, the drill's
        reassignments, and each miner's launch counts.  The miners share
        one card, so their sum is no faster than one miner: this measures
        the scheduler's split, reassignment and time to Result, not
        scaling."""
        import shutil
        import tempfile

        from bitcoin_miner_tpu_torch import workloads

        deadline = time.monotonic() + SERVE_PHASE_S
        b2 = workloads.get("blake2b64")
        work = tempfile.mkdtemp(prefix="serving-")
        keep = os.path.join(ROOT, "bitcoin_miner_tpu_torch", "build", "serving")
        fleets, report = [], {}

        try:
            # (a) the blocking server, two miners, three concurrent jobs.
            s1 = ServeFleet(work, "serve", deadline, miner_args=SERVE_MINER_ARGS)
            fleets.append(s1)
            s1.start_miners(2, serial=True)  # serial: each miner's conn id known
            jobs = SERVE_JOBS
            got, _ = s1.jobs(jobs)
            # (b) the kill drill: the first miner dies holding work.
            drill = [SERVE_DRILL]
            got_d, killed_at = s1.jobs(drill, kill=0)
            time.sleep(1.5)  # the server's ticker flushes its trace each second
            rows1, trace1 = self.serve_traced(s1, jobs, got)
            rows_d, _ = self.serve_traced(s1, drill, got_d)
            dead = s1.miners[0][1]
            tid = rows_d[0]["trace_id"]
            to_dead = [r for r in trace1 if r["trace"] == tid and r["event"] == "dispatch"
                       and r["attrs"]["miner"] == dead]
            before = [r for r in to_dead if r["t"] < killed_at]
            answered = [r for r in trace1 if r["trace"] == tid and r["event"] == "chunk_result"
                        and r["attrs"]["miner"] == dead]
            reclaimed = [r for r in trace1 if r["trace"] == tid and r["attrs"]
                         and r["attrs"].get("miner") == dead
                         and r["event"] in ("steal", "straggler_requeue")]
            rows_d[0].update(killed_miner=dead, sent_to_killed=len(to_dead),
                             sent_before_kill=len(before), answered_by_killed=len(answered),
                             reassigned=len(to_dead) - len(answered),
                             steal_or_requeue_events=len(reclaimed))
            log(f"  kill drill: miner conn {dead} SIGKILLed; the server had sent it "
                f"{len(before)} Requests of the job before ({len(to_dead)} in all), it "
                f"answered {len(answered)}; {len(to_dead) - len(answered)} went to the "
                f"other miner ({len(reclaimed)} by steal or straggler re-queue, the rest "
                f"on the conn's loss)")
            if len(before) <= len(answered):
                raise AssertionError("the killed miner held no work when it died")
            health = re.findall(r"health .*", s1.read("log.txt"))
            log(f"  last health line: {health[-1] if health else None}")
            s1.stop()
            # (c) the async-ingress server and (d) the blake2b64 server: both
            # fleets start together (their start-ups overlap), then run in turn.
            s2 = ServeFleet(work, "async", deadline, ["--async-ingress"], SERVE_MINER_ARGS)
            s3 = ServeFleet(work, "blake2b64", deadline, ["--workload=blake2b64"],
                            ["--workload", "blake2b64", *SERVE_MINER_ARGS])
            fleets += [s2, s3]
            s2.start_miners(2, serial=False)
            s3.start_miners(1, serial=False)
            jobs2 = [SERVE_ASYNC_JOB]
            got2, _ = s2.jobs(jobs2)
            jobs3 = [SERVE_B2_JOB]
            got3, _ = s3.jobs(jobs3)
            time.sleep(1.5)
            rows2, _ = self.serve_traced(s2, jobs2, got2)
            rows3, _ = self.serve_traced(s3, jobs3, got3)
            s2.stop()
            s3.stop()
            # The Results, held on the card after every fleet is idle.
            self.serve_held(s1, jobs + drill, got + got_d)
            self.serve_held(s2, jobs2, got2)
            self.serve_held(s3, jobs3, got3, b2)
            if got2[0][:2] != got[0][:2]:
                raise AssertionError("the async-ingress server's Result differs")
            for f in fleets:
                log(f"  {f.name}: launches per drained miner {f.launches}")
            sha = [f for f in fleets if f is not s3]
            if not all(ln["minhash"] > 0 for f in sha for ln in f.launches) \
                    or not s3.launches or s3.launches[0]["blake2b_minhash"] <= 0:
                raise AssertionError("a serving miner never launched its kernel")
            for f in fleets:
                f.stopped.join(timeout=60)
            if time.monotonic() > deadline:
                raise AssertionError(f"the serving phase ran past {SERVE_PHASE_S} s")
            # The drained miners' counts (the killed one printed none).
            self.k_stats["launches_serving"] = sum(ln["minhash"] for f in sha
                                                   for ln in f.launches)
            self.b_stats["launches_serving"] = s3.launches[0]["blake2b_minhash"]
            report.update(jobs=rows1 + rows_d + rows2 + rows3,
                          launches={f.name: f.launches for f in fleets},
                          card=self.card)
            self.serving = report
        finally:
            for f in fleets:
                f.kill_all()
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(work, keep, dirs_exist_ok=True)
            shutil.rmtree(work, ignore_errors=True)

    def phase_telemetry(self) -> None:
        """The fleet metrics plane on the card.  (1) The throttled run: the
        server (blocking shell) with its hub armed and ``--slo=TELE_SLO``,
        miners ``miner-a``, ``miner-b`` at their defaults and ``miner-c``
        paced to TELE_THROTTLE_NPS, all exporting every TELE_INTERVAL s, and
        the TELE_JOBS clients at once; checks (a)–(i) on the last fleet-log
        state once every Request is answered.  (2) The clean run: two
        unthrottled miners, bare ``--slo``: no alert fires.  (3) Each
        miner's ``hist.device_dispatch_s`` p50/p95 (printed beside the
        kernel's per-dispatch time after "numbers").  (4) An A B B A pair of
        nonces/s per 1e9 Request on one miner in this process, exporter
        armed (to an in-process hub) against bare; nothing is claimed."""
        import shutil
        import tempfile

        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.ops.sweep import sweep_min_hash

        deadline = time.monotonic() + TELE_PHASE_S
        work = tempfile.mkdtemp(prefix="telemetry-")
        keep = os.path.join(ROOT, "bitcoin_miner_tpu_torch", "build", "telemetry")
        fleets, tele = [], self.tele

        def dispatched(fleet):
            """conn id -> (Requests the server sent it, their nonces), from
            its trace; and the trace's rows."""
            rows = fleet.trace_events()
            per = {}
            for r in rows:
                if r["event"] == "dispatch" and r["span"] == "sched":
                    a = r["attrs"]
                    n, nonces = per.get(a["miner"], (0, 0))
                    per[a["miner"]] = (n + 1, nonces + a["hi"] - a["lo"] + 1)
            return per, rows

        def held(fleet, jobs, got):
            for (data, hi), (h, n, _wall) in zip(jobs, got):
                if h != hash_nonce(data, n) or not 0 <= n <= hi:
                    raise AssertionError(f"{fleet.name}: bad Result ({h}, {n}) for {data!r}")
                r = sweep_min_hash(data, 0, hi, device=self.dev)
                if (h, n) != (r.hash, r.nonce):
                    raise AssertionError(f"{fleet.name}: {data!r} [0, {hi}]: served ({h}, {n}) "
                                         f"!= sweep_min_hash on the card {(r.hash, r.nonce)}")
                log(f"  {fleet.name}: {data[:12]!r} [0, {hi}] -> ({h}, {n}): equals hashlib "
                    f"and sweep_min_hash on the card")

        def common(fleet, state, names):
            """(a), (b), (c), (d), (e), (i) on one settled fleet; returns the
            per-miner rows."""
            srcs = state["per_source"]
            if sorted(srcs) != sorted([*names, "server"]) or any(
                    v["stale"] for v in srcs.values()):
                raise AssertionError(f"{fleet.name}: (a) sources {srcs}")
            log(f"  (a) sources fresh: {sorted(srcs)}")
            per, rows = dispatched(fleet)
            fleet.stop()
            reports = fleet.reports()
            out = {}
            for i, (name, rep) in enumerate(zip(names, reports)):
                if rep["main_rc"] != 0 or len(rep["conns"]) != 1:
                    raise AssertionError(f"{fleet.name}: {name} report {rep['main_rc']}, "
                                         f"conns {rep['conns']}")
                sent, nonces = per.get(rep["conns"][0], (0, 0))
                st = rep["state"]
                disp = hist_summary(st["hists"].get("hist.device_dispatch_s"))
                chunk = hist_summary(st["hists"].get("hist.miner_chunk_s"))
                launches = rep["launches"]["minhash"]
                swept = st["counters"].get("miner.nonces", 0)
                err = fleet.read(f"miner{i}.err")
                lines = [ln for ln in err.splitlines() if ln.strip()]
                m = LIFETIME.fullmatch(lines[-1]) if lines else None
                row = dict(conn=rep["conns"][0], requests=sent, nonces_dispatched=nonces,
                           miner_nonces=swept, launches=launches,
                           dispatch_done_events=rep["dispatch_done"], dispatch=disp,
                           chunk=chunk, lifetime=lines[-1] if lines else None)
                out[name] = row
                log(f"  {name} (conn {row['conn']}): (b) miner.nonces {swept} == dispatched "
                    f"{nonces}; (c) hist.device_dispatch_s count {disp['count']} == launches "
                    f"{launches} ({rep['dispatch_done']} dispatch_done events); (d) "
                    f"hist.miner_chunk_s count {chunk['count']} == answered Requests {sent}; "
                    f"dispatch p50 {disp['p50_s']:.4f} s p95 {disp['p95_s']:.4f} s, chunk p50 "
                    f"{chunk['p50_s']:.4f} s [{self.card}]")
                if swept != nonces or disp["count"] != launches or launches <= 0 \
                        or rep["dispatch_done"] != launches or chunk["count"] != sent:
                    raise AssertionError(f"{fleet.name}: {name} (b)/(c)/(d) failed: {row}")
                if m is None or int(m.group(1)) != swept:
                    raise AssertionError(f"{fleet.name}: (i) {name}'s stderr ends {lines[-3:]}")
            total = sum(n for _s, n in per.values())
            merged = state["counters"].get("miner.nonces")
            m_disp = state["hists"].get("hist.device_dispatch_s", {}).get("count")
            m_chunk = state["hists"].get("hist.miner_chunk_s", {}).get("count")
            log(f"  merged: miner.nonces {merged} == dispatched {total}; "
                f"hist.device_dispatch_s {m_disp} == launches "
                f"{sum(r['launches'] for r in out.values())}; hist.miner_chunk_s {m_chunk} == "
                f"Requests {sum(s for s, _n in per.values())}; (i) lifetime lines "
                f"{[r['lifetime'] for r in out.values()]}")
            if merged != total or m_disp != sum(r["launches"] for r in out.values()) \
                    or m_chunk != sum(s for s, _n in per.values()):
                raise AssertionError(f"{fleet.name}: (b)-(d) on the merged view failed")
            rtt = state["hists"].get("hist.lsp_rtt_s", {}).get("count", 0)
            log(f"  (e) hist.lsp_rtt_s: {rtt} samples")
            if rtt <= 0:
                raise AssertionError(f"{fleet.name}: (e) hist.lsp_rtt_s is empty")
            return out, rows

        try:
            # (1) the throttled run.
            a = TeleFleet(work, "throttled", deadline, [f"--slo={TELE_SLO}"])
            fleets.append(a)
            names = ["miner-a", "miner-b", "miner-c"]
            a.start_tele_miners({"miner-a": [], "miner-b": [],
                                 "miner-c": ["--throttle-nps", str(TELE_THROTTLE_NPS)]})
            # The clean run's fleet starts now, so its start-up overlaps.
            b = TeleFleet(work, "clean", deadline, ["--slo"])
            fleets.append(b)
            got, _ = a.jobs(TELE_JOBS)
            t_run = max(w for _h, _n, w in got)
            state = a.settle()
            miners, rows = common(a, state, names)
            strag = [s["source"] for s in state["stragglers"]]
            events = [r["attrs"] for r in rows if (r["span"], r["event"]) == ("fleet", "straggler")]
            log(f"  (f) stragglers {state['stragglers']}; fleet straggler events {events}")
            if "miner-c" not in strag or [e["source"] for e in events].count("miner-c") != 1:
                raise AssertionError("(f) miner-c is not the one flagged straggler")
            fired = [r["attrs"] for r in rows if (r["span"], r["event"]) == ("slo", "alert_fired")]
            n_fired = state["counters"].get("slo.alerts_fired", 0)
            log(f"  (g) --slo={TELE_SLO}: alerts fired {fired} (slo.alerts_fired {n_fired}); "
                f"last SLO state {state.get('slo', {}).get('alerts')}")
            if not any(e["slo"] == "chunk-rtt-p95" for e in fired) or n_fired < 1:
                raise AssertionError("(g) the throttled run fired no chunk-rtt-p95 alert")
            prom = parse_prom(a.read("metrics.prom"))
            health = re.findall(r"health .*", a.read("log.txt"))
            log(f"  (h) Prometheus file: {len(prom)} unlabelled samples, bmt_miner_nonces "
                f"{prom.get('bmt_miner_nonces')}; health lines with fleet=/slo=: "
                f"{sum(1 for h in health if ' fleet=' in h and ' slo=' in h)} of {len(health)}; "
                f"last: {health[-1] if health else None}")
            if "bmt_miner_nonces" not in prom or not health or not all(
                    " fleet=" in h and " slo=" in h for h in health[-1:]):
                raise AssertionError("(h) the Prometheus file or the health lines lack the plane")
            tele["throttled"] = dict(jobs=TELE_JOBS, slowest_client_s=t_run, miners=miners,
                                     stragglers=state["stragglers"], alerts_fired=fired,
                                     slo=TELE_SLO, throttle_nps=TELE_THROTTLE_NPS,
                                     card=self.card)
            # (2) the clean run: its miners start up while the throttled
            # run's Results are held on the card.
            b.start_tele_miners({"miner-a": [], "miner-b": []}, wait=False)
            held(a, TELE_JOBS, got)
            b.wait_for(r"miner (\d+) joined", len(b.miners), SERVE_JOIN_S)
            got_b, _ = b.jobs(TELE_CLEAN_JOBS)
            state_b = b.settle()
            miners_b, rows_b = common(b, state_b, ["miner-a", "miner-b"])
            fired_b = [r["attrs"] for r in rows_b if (r["span"], r["event"]) == ("slo",
                                                                                 "alert_fired")]
            log(f"  (g) clean run, bare --slo: alerts fired {fired_b}, slo.alerts_fired "
                f"{state_b['counters'].get('slo.alerts_fired', 0)}")
            if fired_b or state_b["counters"].get("slo.alerts_fired", 0) or state_b.get(
                    "slo", {}).get("alerts") != []:
                raise AssertionError("(g) the clean run fired an SLO alert")
            held(b, TELE_CLEAN_JOBS, got_b)
            tele["clean"] = dict(jobs=TELE_CLEAN_JOBS, miners=miners_b, card=self.card)
            for f in fleets:
                f.stopped.join(timeout=60)
            tele["pair"] = self.telemetry_pair()
            if time.monotonic() > deadline:
                raise AssertionError(f"the telemetry phase ran past {TELE_PHASE_S} s")
        finally:
            for f in fleets:
                f.kill_all()
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(work, keep, dirs_exist_ok=True)
            shutil.rmtree(work, ignore_errors=True)

    # ----------------------------------------------------- gateway, autoscale

    def gate_client(self, port: int, src=None):
        """A port LSP client of the server on ``port``, from the loopback
        address ``src`` when given: another host to the gateway, whose
        admission keys each client by its address."""
        import asyncio

        from bitcoin_miner_tpu_torch import lsp, lspnet
        from bitcoin_miner_tpu_torch.lspnet import udp

        if src is None:
            return lsp.Client("127.0.0.1", port)
        real = lspnet.create_client_endpoint

        async def bound(host, p, label=None):
            loop = asyncio.get_running_loop()
            transport, protocol = await loop.create_datagram_endpoint(
                udp._QueueProtocol, local_addr=(src, 0))
            return udp.UDPEndpoint(transport, protocol, is_server=False, remote=(host, p),
                                   label=label)

        lspnet.create_client_endpoint = bound
        try:
            return lsp.Client("127.0.0.1", port)
        finally:
            lspnet.create_client_endpoint = real

    def gate_ask(self, port: int, data: str, lo: int, hi: int, src=None,
                 timeout: float = SERVE_JOB_S):
        """One Request through a port client; returns ``((hash, nonce) or
        None when the server closed the conn, seconds to Result)``."""
        from bitcoin_miner_tpu_torch.apps import client

        conn = self.gate_client(port, src)
        t0 = time.monotonic()
        try:
            got = client.request_once(conn, data, hi, lower=lo, timeout=timeout)
        finally:
            dt = time.monotonic() - t0
            try:
                conn.close()
            except Exception:
                pass  # a shed conn is already gone
        return got, dt

    @staticmethod
    def gate_trace(fleet):
        """The server's trace rows, and per Request signature ``(data,
        lower, upper)`` the trace ids of its ``gw request`` events."""
        rows = fleet.trace_events()
        ids = {}
        for r in rows:
            a = r.get("attrs") or {}
            if (r["span"], r["event"]) == ("gw", "request"):
                ids.setdefault((a["data"], a["lower"], a["upper"]), []).append(r["trace"])
        return rows, ids

    @staticmethod
    def dispatched(rows, tid):
        """The chunks the scheduler sent miners under trace id ``tid``."""
        return [(r["attrs"]["lo"], r["attrs"]["hi"]) for r in rows
                if r["trace"] == tid and (r["span"], r["event"]) == ("sched", "dispatch")]

    def replay(self, search, data, chunks):
        """The min-hash kernel's launches and the fold of ``chunks`` swept
        one by one through ``search`` (the miner's own
        ``make_async_search("cuda")``) in this process."""
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash

        before, best = minhash.launches, None
        for lo, hi in chunks:
            h, n = search.submit(data, lo, hi).result()
            best = min(best or (h, n), (h, n))
        return minhash.launches - before, best

    def span_rows(self, fleet, path, data, lo, hi):
        """``data``'s rows of the span file at ``path`` once they tile
        ``[lo, hi]`` (the server flushes the store every tick)."""
        from bitcoin_miner_tpu_torch.utils.intervals import merge_intervals

        deadline = min(time.monotonic() + 10, fleet.deadline)
        while True:
            rows = []
            try:
                with open(path) as f:
                    state = json.load(f)
                rows = sorted(next((r for d, r in state.get("data", ()) if d == data), []))
            except (OSError, ValueError):
                pass
            if merge_intervals([(a, b) for a, b, _h, _n in rows]) == [(lo, hi)]:
                return rows
            if time.monotonic() > deadline:
                raise AssertionError(f"{fleet.name}: the span file never tiled [{lo}, {hi}]: "
                                     f"{rows}")
            time.sleep(0.1)

    def gateway_legs(self, fleet, search) -> dict:
        """Legs (a)-(d) on one gateway fleet (two port miners, nothing else
        live): (a) GATE_TWINS identical Requests at once; (b) the same
        Request again; (c) a sub-range of whole solved spans; (d) a range
        that adds GATE_GAP nonces below the solved ones and ends on a span
        edge.  Per leg: each Result, its seconds to Result, each miner's
        launches over the leg.  Returns the legs and their signatures."""
        from bitcoin_miner_tpu_torch.utils.intervals import merge_intervals

        data, lo, hi = GATE_JOB
        legs = {}

        def leg(name, keys):
            before = fleet.settled()
            got = [None] * len(keys)

            def one(i):
                got[i] = self.gate_ask(fleet.port, *keys[i])

            threads = [threading.Thread(target=one, args=(i,), daemon=True)
                       for i in range(len(keys))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=SERVE_JOB_S)
            after = fleet.settled()
            if any(g is None or g[0] is None for g in got):
                raise AssertionError(f"{fleet.name} ({name}): a Request got no Result: {got}")
            per = {pid: n - before.get(pid, 0) for pid, n in after.items()}
            legs[name] = dict(keys=keys, results=[list(g[0]) for g in got],
                              seconds=[g[1] for g in got], launches=per)
            log(f"  {fleet.name} ({name}) {keys[0][0]!r} [{keys[0][1]}, {keys[0][2]}] x"
                f"{len(keys)} -> {got[0][0]}; time to Result "
                f"{', '.join(f'{g[1]:.3f}' for g in got)} s; launches per miner "
                f"{sorted(per.values())} [{self.card}]")
            return got

        got_a = leg("a", [GATE_JOB] * GATE_TWINS)
        if len({g[0] for g in got_a}) != 1:
            raise AssertionError(f"{fleet.name} (a): the twins got different Results {got_a}")
        leg("b", [GATE_JOB])
        rows = self.span_rows(fleet, fleet.spans, data, lo, hi)
        inner = rows[1:-1] if len(rows) >= 3 else rows[:1]
        sub = (data, inner[0][0], inner[-1][1])
        if sub == GATE_JOB:
            raise AssertionError(f"{fleet.name}: one span covers the whole job: {rows}")
        leg("c", [sub])
        legs["c"]["span_rows"] = rows
        over = (data, lo - GATE_GAP, rows[0][1])
        leg("d", [over])
        time.sleep(1.5)  # the server's ticker flushes its trace every second
        trace, ids = self.gate_trace(fleet)
        # (a): one submit, the rest coalesced into it, its chunks tile the job.
        tids = ids.get(GATE_JOB, [])
        ev = {t: [r["event"] for r in trace if r["trace"] == t and r["span"] == "gw"]
              for t in tids}
        primary = [t for t in tids if "submit" in ev[t]]
        twins = [t for t in tids if "coalesce" in ev[t]]
        cached = [t for t in tids if "cache_hit" in ev[t]]
        if len(tids) != GATE_TWINS + 1 or len(primary) != 1 or len(twins) != GATE_TWINS - 1 \
                or len(cached) != 1:
            raise AssertionError(f"{fleet.name}: (a)/(b) trace {ev}")
        chunks_a = self.dispatched(trace, primary[0])
        if merge_intervals(list(chunks_a)) != [(lo, hi)] or \
                sum(b - a + 1 for a, b in chunks_a) != hi - lo + 1:
            raise AssertionError(f"{fleet.name} (a): dispatched {chunks_a} do not tile "
                                 f"[{lo}, {hi}] without overlap")
        want_a, best_a = self.replay(search, data, chunks_a)
        got_launch_a = sum(legs["a"]["launches"].values())
        legs["a"].update(dispatched=len(chunks_a), one_sweep_launches=want_a,
                         coalesced=len(twins))
        log(f"  {fleet.name} (a): {GATE_TWINS} Requests, 1 submit, {len(twins)} coalesced; "
            f"{len(chunks_a)} chunks tile the job; the miners launched {got_launch_a}, one "
            f"sweep of those chunks here launches {want_a}")
        if got_launch_a != want_a or best_a != got_a[0][0]:
            raise AssertionError(f"{fleet.name} (a): launches {got_launch_a} != one sweep's "
                                 f"{want_a}, or its fold {best_a} != {got_a[0][0]}")
        # (b), (c): answered without a chunk, with no launch.
        for name, key, event in (("b", GATE_JOB, "cache_hit"), ("c", sub, "span_hit")):
            tid = cached[0] if name == "b" else (ids.get(key) or [None])[0]
            evs = [r["event"] for r in trace if r["trace"] == tid and r["span"] == "gw"]
            n = sum(legs[name]["launches"].values())
            log(f"  {fleet.name} ({name}): {event} in the trace ({evs}); launches {n}")
            if event not in evs or self.dispatched(trace, tid) or n != 0:
                raise AssertionError(f"{fleet.name} ({name}): {evs}, launches {n}")
        want_c = min((h, n) for _a, _b, h, n in inner)
        if tuple(legs["c"]["results"][0]) != want_c:
            raise AssertionError(f"{fleet.name} (c): {legs['c']['results']} != the spans' "
                                 f"fold {want_c}")
        # (d): only the gap is swept.
        (tid_d,) = ids.get(over, [None])
        subm = [r["attrs"] for r in trace if r["trace"] == tid_d
                and (r["span"], r["event"]) == ("gw", "submit")]
        chunks_d = self.dispatched(trace, tid_d)
        gap = (over[1], lo - 1)
        want_d, _best = self.replay(search, data, chunks_d)
        got_launch_d = sum(legs["d"]["launches"].values())
        swept = sum(b - a + 1 for a, b in chunks_d)
        legs["d"].update(gap=list(gap), dispatched_nonces=swept, gap_launches=want_d,
                         submit=subm)
        log(f"  {fleet.name} (d): submit {subm}; {len(chunks_d)} chunks, {swept} nonces, "
            f"tile the gap {gap} ({lo - over[1]} nonces); the miners launched "
            f"{got_launch_d}, the gap's chunks here launch {want_d}")
        if merge_intervals(list(chunks_d)) != [gap] or swept != lo - over[1] or not subm \
                or subm[0].get("gaps") != 1 or got_launch_d != want_d:
            raise AssertionError(f"{fleet.name} (d): swept {chunks_d}, submit {subm}, "
                                 f"launches {got_launch_d} != {want_d}")
        return legs

    def phase_gateway(self) -> None:
        """The serving gateway on the card.  Two port servers with
        ``--gateway --cache=F --spans=F``, one per shell (the blocking one
        and ``--async-ingress``), each with two plain port miners at their
        defaults, run legs (a)-(d) (:meth:`gateway_legs`).  The blocking
        one is then restarted on the same files with ``--prefill`` and
        small admission knobs, and two fresh miners: (e) the job again,
        answered from the reloaded cache with no launch; (f) GATE_FLOOD
        Requests from one host at once: one admitted, the rest throttled,
        the overflow shed (those clients see the conn closed), while a
        Request from a second host (127.0.0.2) is served; (g) a span hit
        makes the job's data hot, and after an idle second the prefill
        legs launch on the card with no Request live; a real Request
        preempts them.  Every Result is held to hashlib and to
        ``sweep_min_hash`` over the same range on the card; the gateway's
        counters are read from each server's fleet log."""
        import shutil
        import tempfile

        from bitcoin_miner_tpu_torch.apps import miner
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.ops.sweep import sweep_min_hash

        deadline = time.monotonic() + GATE_PHASE_S
        work = tempfile.mkdtemp(prefix="gateway-")
        keep = os.path.join(ROOT, "bitcoin_miner_tpu_torch", "build", "gateway")
        fleets, report, held = [], {"card": self.card}, []
        search = miner.make_async_search("cuda")

        def gateway_fleet(name, extra=(), files=None):
            files = files or (os.path.join(work, f"{name}.cache.json"),
                              os.path.join(work, f"{name}.spans.json"))
            f = GateFleet(work, name, deadline, [
                "--gateway", f"--cache={files[0]}", f"--spans={files[1]}",
                "--fleet-log=fleet.jsonl", *extra])
            f.cache, f.spans = files
            fleets.append(f)
            return f

        def counters(fleet, want):
            """The server's ``gateway.*`` counters; ``want`` maps a name to
            its value, or to a predicate of it."""
            c = fleet.last_state()["counters"]
            got = {k: c.get(f"gateway.{k}", 0) for k in want}
            log(f"  {fleet.name}: gateway counters {got}")
            for k, v in want.items():
                if not (v(got[k]) if callable(v) else got[k] == v):
                    raise AssertionError(f"{fleet.name}: gateway.{k} = {got[k]}")
            return {k: c[k] for k in sorted(c) if k.startswith("gateway.")}

        try:
            s1 = gateway_fleet("blocking")
            s3 = gateway_fleet("async", ["--async-ingress"])
            for f in (s1, s3):  # both fleets' start-ups overlap
                for i in range(2):
                    f.miners.append((f._spawn(f"miner{i}", [
                        "-m", "bitcoin_miner_tpu_torch.apps.miner", f"127.0.0.1:{f.port}"]),
                        None))
            for f in (s1, s3):
                f.wait_for(r"miner (\d+) joined", 2, SERVE_JOIN_S)
            # Legs (a)-(d) on the blocking shell, then on the async one.
            want = dict(coalesced=GATE_TWINS - 1, fanout=GATE_TWINS - 1, cache_hits=1,
                        span_hits=1, span_partial=1, completed=2)
            for f in (s1, s3):
                legs = self.gateway_legs(f, search)
                report[f.name] = dict(legs=legs, counters=counters(f, want))
                held += [(f.name, k, r) for lg in legs.values()
                         for k, r in zip(lg["keys"], lg["results"])]
                f.stop()
            if report["async"]["legs"]["a"]["results"] != report["blocking"]["legs"]["a"][
                    "results"]:
                raise AssertionError("the async shell's (a) Results differ")
            s1.stopped.join(timeout=60)  # its final flush is on disk
            # (e) the restart on the same files, with prefill and admission.
            s2 = gateway_fleet("restarted", [f"--prefill={GATE_PREFILL}", *GATE_ADMISSION],
                               files=(s1.cache, s1.spans))
            s2.start_port_miners(2)
            base = s2.settled()
            got_e, dt_e = self.gate_ask(s2.port, *GATE_JOB)
            n_e = sum(s2.settled().values()) - sum(base.values())
            log(f"  restarted (e): {GATE_JOB} -> {got_e} in {dt_e:.3f} s from the reloaded "
                f"cache; launches {n_e} [{self.card}]")
            if got_e is None or n_e != 0 or list(got_e) != \
                    report["blocking"]["legs"]["a"]["results"][0]:
                raise AssertionError(f"restarted (e): {got_e}, launches {n_e}")
            held.append(("restarted", GATE_JOB, list(got_e)))
            # (f) one host's flood, then a second host's Request.
            flood = [(f"flood-{i}", 0, GATE_FLOOD_SIZE - 1) for i in range(GATE_FLOOD)]
            fgot = {}
            threads = [threading.Thread(
                target=lambda i=i: fgot.__setitem__(i, self.gate_ask(s2.port, *flood[i],
                                                                      timeout=90)),
                daemon=True) for i in range(GATE_FLOOD)]
            for t in threads:
                t.start()
            s2.wait_for(r"request from \d+: data='flood-", GATE_FLOOD, 30)
            got_q, dt_q = self.gate_ask(s2.port, "quiet", 0, GATE_FLOOD_SIZE - 1, "127.0.0.2")
            for t in threads:
                t.join(timeout=120)
            served = sorted(i for i, (g, _dt) in fgot.items() if g is not None)
            shed = sorted(i for i, (g, _dt) in fgot.items() if g is None)
            log(f"  restarted (f): {GATE_FLOOD} flood Requests from 127.0.0.1 "
                f"({' '.join(GATE_ADMISSION)}): served {served} after "
                f"{[round(fgot[i][1], 3) for i in served]} s, shed {shed} (conn closed, seen "
                f"after {[round(fgot[i][1], 3) for i in shed]} s); the second host's Request "
                f"-> {got_q} in {dt_q:.3f} s [{self.card}]")
            if got_q is None or len(fgot) != GATE_FLOOD or len(served) != 3 or len(shed) != 3:
                raise AssertionError(f"restarted (f): flood {fgot}, second host {got_q}")
            held += [("restarted", flood[i], list(fgot[i][0])) for i in served]
            held.append(("restarted", ("quiet", 0, GATE_FLOOD_SIZE - 1), list(got_q)))
            # (g) a span hit turns the data hot (the last solved span: no
            # earlier Request asked for it, so the cache cannot answer);
            # an idle second later the prefill legs launch with no Request
            # live; a Request preempts them.
            last = report["blocking"]["legs"]["c"]["span_rows"][-1]
            got_h, _dt = self.gate_ask(s2.port, GATE_JOB[0], last[0], last[1])
            if got_h is None or list(got_h) != last[2:]:
                raise AssertionError(f"restarted (g): span hit {got_h} != {last}")
            held.append(("restarted", (GATE_JOB[0], last[0], last[1]), list(got_h)))
            base, t0 = sum(s2.live_launches().values()), time.monotonic()
            while sum(s2.live_launches().values()) == base:
                if time.monotonic() - t0 > 15:
                    raise AssertionError("restarted (g): no prefill launch within 15 s")
                time.sleep(0.02)
            t_pre = time.monotonic() - t0
            got_p, dt_p = self.gate_ask(s2.port, *GATE_PREEMPT, "127.0.0.2")
            if got_p is None:
                raise AssertionError("restarted (g): the preempting Request got no Result")
            held.append(("restarted", GATE_PREEMPT, list(got_p)))
            c2 = counters(s2, dict(cache_hits=1, span_hits=1, shed=3, throttled=5,
                                   prefill_jobs=lambda v: v >= 1,
                                   prefill_preempted=lambda v: v >= 1))
            time.sleep(0.5)
            trace, _ids = self.gate_trace(s2)
            pre = [r for r in trace if (r["span"], r["event"]) == ("gw", "prefill")]
            pre_chunks = [c for r in pre for c in self.dispatched(trace, r["trace"])]
            log(f"  restarted (g): prefill launched {t_pre:.3f} s after the span hit; "
                f"{len(pre)} prefill jobs {[(r['attrs']['lower'], r['attrs']['upper']) for r in pre]}, "
                f"{len(pre_chunks)} chunks dispatched; the preempting Request -> {got_p} in "
                f"{dt_p:.3f} s [{self.card}]")
            if not pre or not pre_chunks:
                raise AssertionError("restarted (g): no prefill job or chunk in the trace")
            s2.stop()
            report["restarted"] = dict(
                e=dict(result=list(got_e), seconds=dt_e, launches=n_e),
                f=dict(served=served, shed=shed, seconds={i: fgot[i][1] for i in fgot},
                       second_host=dict(result=list(got_q), seconds=dt_q),
                       admission=GATE_ADMISSION),
                g=dict(prefill_after_s=t_pre, prefill_jobs=len(pre),
                       prefill_chunks=len(pre_chunks), preempt=dict(result=list(got_p),
                                                                   seconds=dt_p)),
                counters=c2)
            for f in fleets:
                f.stopped.join(timeout=60)
            # Every Result, held on the card with every fleet idle (each
            # distinct one once: the twins and both shells agree).
            distinct = {(k, tuple(r)): name for name, k, r in held}
            for ((data, lo, hi), (h, n)), name in distinct.items():
                if h != hash_nonce(data, n) or not lo <= n <= hi:
                    raise AssertionError(f"{name}: bad Result ({h}, {n}) for {data!r}")
                r = sweep_min_hash(data, lo, hi, device=self.dev)
                if (h, n) != (r.hash, r.nonce):
                    raise AssertionError(f"{name}: {data!r} [{lo}, {hi}]: served ({h}, {n}) "
                                         f"!= sweep_min_hash on the card {(r.hash, r.nonce)}")
            log(f"  {len(held)} Results ({len(distinct)} distinct) equal hashlib and "
                f"sweep_min_hash on the card")
            launched = {f.name: f.launches_by_miner for f in fleets}
            log(f"  launches per drained miner {launched}")
            if not all(n > 0 for f in fleets for n in f.launches_by_miner):
                raise AssertionError("a gateway miner never launched the kernel")
            self.k_stats["launches_gateway"] = sum(sum(v) for v in launched.values())
            report["launches"] = launched
            if time.monotonic() > deadline:
                raise AssertionError(f"the gateway phase ran past {GATE_PHASE_S} s")
            self.gate = report
        finally:
            search.close()
            for f in fleets:
                f.kill_all()
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(work, keep, dirs_exist_ok=True)
            shutil.rmtree(work, ignore_errors=True)

    def phase_autoscale(self) -> None:
        """The autoscaler on the card.  A port server with ``--gateway``,
        its hub (``--telemetry-port``, ``--fleet-log``), ``--slo=AS_SLO``
        (a Request over 0.5 s is bad) and ``--autoscale=AS_SPEC``, in an
        environment with ``BMT_MINER_THROTTLE_NPS=AS_PACE_NPS``; one plain
        port miner, paced by it, and AS_STREAMS clients sending
        AS_REQUEST-nonce Requests in turn.  One paced miner misses the
        objective, the request alert fires, and the controller spawns
        workers — ``python -m bitcoin_miner_tpu_torch.apps.miner``, paced
        by the inherited variable, on the card — until every miner has
        answered chunks; then the load stops, the alert resolves, and the
        controller drains the newest worker.  Checks: each spawned
        worker's argv names the port's miner with ``--backend auto``,
        each spawned worker launched the min-hash kernel, the drained one
        exited 0 with ``drained`` in its trace, every Result equals hashlib
        and ``sweep_min_hash`` on the card.  Prints the controller's
        timeline from its trace events and its ``status()`` in the fleet
        log."""
        import shutil
        import socket
        import tempfile

        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.ops.sweep import sweep_min_hash

        deadline = time.monotonic() + AS_PHASE_S
        work = tempfile.mkdtemp(prefix="autoscale-")
        keep = os.path.join(ROOT, "bitcoin_miner_tpu_torch", "build", "autoscale")
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.bind(("127.0.0.1", 0))
            tport = sock.getsockname()[1]
        fleet = None
        results, stop = [], threading.Event()
        try:
            fleet = GateFleet(work, "autoscale", deadline, [
                "--gateway", f"--telemetry-port={tport}", "--fleet-log=fleet.jsonl",
                f"--slo={AS_SLO}", f"--autoscale={AS_SPEC}"],
                env={"BMT_MINER_THROTTLE_NPS": str(AS_PACE_NPS)})
            fleet.start_port_miners(1, ["--telemetry", f"127.0.0.1:{tport}",
                                        "--source", "paced-0"])
            t_load = time.monotonic()

            def stream(k):
                i = 0
                while not stop.is_set() and time.monotonic() < deadline:
                    lo = (i * AS_STREAMS + k) * AS_REQUEST
                    got, dt = self.gate_ask(fleet.port, "autoscale", lo, lo + AS_REQUEST - 1)
                    results.append((lo, lo + AS_REQUEST - 1, got, dt,
                                    time.monotonic() - t_load))
                    i += 1

            threads = [threading.Thread(target=stream, args=(k,), daemon=True)
                       for k in range(AS_STREAMS)]
            for t in threads:
                t.start()

            def answered():
                """Distinct miner conns that answered a chunk so far."""
                return {r["attrs"]["miner"] for r in fleet.trace_events()
                        if (r["span"], r["event"]) == ("sched", "chunk_result")}

            # Load until two workers are spawned and every miner answered.
            while True:
                spawned = re.findall(r"autoscale spawned worker \d+ \(pid (\d+)\)",
                                     fleet.read("log.txt"))
                if len(spawned) >= 2 and len(answered()) >= 3:
                    break
                if fleet.server.poll() is not None or time.monotonic() > deadline - 60:
                    raise AssertionError(f"autoscale: spawned {spawned}, answered by "
                                         f"{answered()} when the load had to stop")
                time.sleep(0.2)
            t_stop = time.monotonic() - t_load
            stop.set()
            for t in threads:
                t.join(timeout=SERVE_JOB_S)
            log(f"  load stopped at {t_stop:.1f} s: {len(results)} Requests, spawned pids "
                f"{spawned}, chunks answered by {len(answered())} miners")
            # Quiet: the controller drains the newest worker.
            m = fleet.wait_for(r"autoscale draining worker pid (\d+)", 1,
                               max(1.0, deadline - time.monotonic()))
            drained = int(m)
            t_drain = time.monotonic() - t_load
            while drained not in fleet.reports():
                if time.monotonic() > deadline:
                    raise AssertionError(f"autoscale: worker {drained} never exited")
                time.sleep(0.1)
            t_exit = time.monotonic() - t_load
            fleet.stop()  # the paced miner; the server drains the rest on its way out
            fleet.stopped.join(timeout=90)
            reports = fleet.reports()
            workers = {int(p): reports.get(int(p)) for p in spawned}
            for pid, rep in workers.items():
                log(f"  spawned worker pid {pid}: argv {rep and rep['argv'][1:]}, launches "
                    f"{rep and rep['launches']}, exit {rep and rep['exit']}, miner events "
                    f"{rep and rep['miner_events']}")
                if rep is None or rep["argv"][1:5] != [
                        "-m", "bitcoin_miner_tpu_torch.apps.miner",
                        f"127.0.0.1:{fleet.port}", "--backend"] or rep["argv"][5] != "auto" \
                        or rep["exit"] != 0:
                    raise AssertionError(f"autoscale: worker {pid}: {rep}")
            # The load ran until every miner had answered a chunk, so each
            # spawned worker (the scale-up's second one among them) must
            # have launched the kernel on the card.
            idle = [pid for pid, rep in workers.items() if rep["launches"] <= 0]
            if idle:
                raise AssertionError(f"autoscale: spawned workers {idle} answered chunks "
                                     f"without launching the kernel")
            if "drained" not in workers[drained]["miner_events"]:
                raise AssertionError(f"autoscale: worker {drained} did not drain cleanly")
            # The controller's timeline: its trace events and the statuses it
            # published through the hub.
            rows = fleet.trace_events()
            t0 = rows[0]["t"] if rows else 0.0
            timeline = [(round(r["t"] - t0, 3), r["span"], r["event"], r.get("attrs"))
                        for r in rows if r["span"] == "autoscale"
                        or (r["span"], r["event"]) in (("slo", "alert_fired"),
                                                       ("slo", "alert_resolved"))]
            for row in timeline:
                log(f"  timeline {row}")
            statuses = []
            for line in fleet.read("fleet.jsonl").splitlines():
                try:
                    st = json.loads(line).get("autoscale")
                except ValueError:
                    continue
                if st and (not statuses or st != statuses[-1]):
                    statuses.append(st)
            for st in statuses:
                log(f"  status() {st}")
            kinds = [a for _t, span, ev, a in timeline if span == "autoscale" and ev == "action"]
            if [a["kind"] for a in kinds][:3] != ["spawn", "spawn", "drain"]:
                raise AssertionError(f"autoscale: actions {kinds}")
            # Every Result exact, held on the card with the fleet gone.
            for lo, hi, got, dt, _at in results:
                if got is None:
                    raise AssertionError(f"autoscale: [{lo}, {hi}] got no Result")
                h, n = got
                r = sweep_min_hash("autoscale", lo, hi, device=self.dev)
                if h != hash_nonce("autoscale", n) or (h, n) != (r.hash, r.nonce):
                    raise AssertionError(f"autoscale: [{lo}, {hi}] served {got} != "
                                         f"{(r.hash, r.nonce)}")
            log(f"  {len(results)} Results equal hashlib and sweep_min_hash on the card; "
                f"seconds to Result {[round(dt, 3) for *_x, dt, _a in results]} [{self.card}]")
            launched = {pid: rep["launches"] for pid, rep in reports.items()}
            self.k_stats["launches_autoscale"] = sum(launched.values())
            self.autoscale = dict(
                spec=AS_SPEC, slo=AS_SLO, pace_nps=AS_PACE_NPS, request=AS_REQUEST,
                streams=AS_STREAMS, load_stopped_s=t_stop, drain_s=t_drain,
                drained_exit_s=t_exit, drained_pid=drained,
                workers={pid: dict(launches=rep["launches"], exit=rep["exit"],
                                   miner_events=rep["miner_events"])
                         for pid, rep in workers.items()},
                launches=launched, requests=[[lo, dt, at] for lo, _h, _g, dt, at in results],
                timeline=timeline, statuses=statuses, card=self.card)
            if time.monotonic() > deadline:
                raise AssertionError(f"the autoscale phase ran past {AS_PHASE_S} s")
        finally:
            stop.set()
            if fleet is not None:
                fleet.kill_all()
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(work, keep, dirs_exist_ok=True)
            shutil.rmtree(work, ignore_errors=True)

    def pair_leg(self, armed: bool, hub_port: int):
        """One leg of the overhead pair: a port miner's serve loop
        (``run_miner`` over ``make_async_search("cuda")``, as ``main``
        builds it) in a thread, with a ``TelemetryExporter`` to
        ``hub_port`` when ``armed``, served TELE_PAIR_REQUESTS Requests of
        TELE_PAIR_SIZE nonces of ``"cmu440"`` one at a time by this
        script's LSP server; the miner ends by its drain.  Returns the nonces/s
        of every Request but the first (which folds d <= 9 on the host
        and in small dispatches), the fold of all of them and the
        ``hist.device_dispatch_s`` summary of the timed Requests'
        dispatches (this process's registry, its part after the first
        Result; a dispatch is observed before its Request's Result is
        written)."""
        from bitcoin_miner_tpu_torch import lsp
        from bitcoin_miner_tpu_torch.apps import miner
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.bitcoin.message import Message, MsgType
        from bitcoin_miner_tpu_torch.utils.metrics import METRICS
        from bitcoin_miner_tpu_torch.utils.telemetry import TelemetryExporter

        def dispatch_state():
            h = METRICS.histogram("hist.device_dispatch_s")
            if h is None:
                raise AssertionError("the pair's miner observed no dispatch")
            return h.state()

        server = lsp.Server(0)
        search = miner.make_async_search("cuda")
        exp = (TelemetryExporter("127.0.0.1", hub_port, "pair",
                                 interval=TELE_INTERVAL).start() if armed else None)
        client = lsp.Client("127.0.0.1", server.port)
        drain = threading.Event()
        t = threading.Thread(target=miner.run_miner, args=(client, search),
                             kwargs=dict(drain=drain), name="pair-miner", daemon=True)
        t.start()
        rates, best, before = [], None, None
        try:
            conn, _join = server.read()
            for i in range(TELE_PAIR_REQUESTS):
                lo, hi = i * TELE_PAIR_SIZE, (i + 1) * TELE_PAIR_SIZE - 1
                t0 = time.monotonic()
                server.write(conn, Message.request("cmu440", lo, hi).marshal())
                while True:
                    cid, payload = server.read()
                    r = Message.unmarshal(payload)
                    if cid == conn and r is not None and r.type == MsgType.RESULT:
                        break
                dt = time.monotonic() - t0
                if not lo <= r.nonce <= hi or r.hash != hash_nonce("cmu440", r.nonce):
                    raise AssertionError(f"the pair: bad Result {r} for [{lo}, {hi}]")
                if i:
                    rates.append((hi - lo + 1) / dt)
                else:
                    before = dispatch_state()
                best = min(best or (r.hash, r.nonce), (r.hash, r.nonce))
            after = dispatch_state()
        finally:
            drain.set()
            t.join(timeout=30)
            client.close()
            if exp is not None:
                exp.stop()
            server.close()
        if t.is_alive():
            raise AssertionError("the pair's miner did not drain")
        return rates, best, hist_summary({
            "buckets": {k: v - before["buckets"].get(k, 0) for k, v in after["buckets"].items()
                        if v != before["buckets"].get(k, 0)},
            "zero": after["zero"] - before["zero"],
            "count": after["count"] - before["count"],
            "sum": after["sum"] - before["sum"]})

    def telemetry_pair(self) -> dict:
        """The telemetry phase's overhead pair: legs A (exporter armed, to a
        hub in this process) B B A (bare) of :meth:`pair_leg` on the same
        Requests; each leg's mean nonces/s and its dispatches'
        ``hist.device_dispatch_s`` summary (this process's registry, the
        leg's part of it).  Nothing is claimed from it."""
        from bitcoin_miner_tpu_torch.utils.telemetry import TelemetryHub

        hub = TelemetryHub(0, source=None).start()
        pair, disp, seen = {"armed": [], "bare": []}, {}, set()
        try:
            for leg in ("armed", "bare", "bare", "armed"):
                rates, found, summary = self.pair_leg(leg == "armed", hub.port)
                seen.add(found)
                pair[leg].append(sum(rates) / len(rates))
                disp.setdefault(leg, []).append(summary)
                log(f"  pair leg {leg}: {pair[leg][-1]:,.0f} nonces/s per 1e9 Request "
                    f"(mean of {len(rates)}); their dispatches {summary} [{self.card}]")
            merged = hub.fleet.export_sources().get("pair")
        finally:
            hub.close()
        if merged is None or len(seen) != 1:
            raise AssertionError(f"the pair: the exporter never reached the hub "
                                 f"({merged is not None}) or the legs disagree ({seen})")
        log(f"  A B B A nonces/s per 1e9 Request, exporter armed {pair['armed']}, bare "
            f"{pair['bare']} [{self.card}] (no claim)")
        return dict(nonces_per_s=pair, dispatch=disp, interval_s=TELE_INTERVAL, card=self.card)

    def phase_chaos(self) -> None:
        """The chaos layer on the card.  (1) Four drills in this process:
        the port's ``run_drill(backend="auto")`` (three miners on the cuda
        rung, a resilient pair and the kill target, a retrying client) under
        each standard scenario, ``miner-partition`` with miner-0 killed at
        0.8 s.  Each Result must equal this process's ``sweep_min_hash``
        over the range on the card (an independent split, swept before the
        drill) and hashlib on its nonce; every miner's search must be the
        cuda rung, the kernel's launches must rise in the drill, and the
        drill's counters must show each fault class its scenario arms (for
        the kill, a reassignment or a re-Join).  (2) One job through an
        ``apps.server`` process armed by ``BMT_CHAOS_SCENARIO`` and
        ``BMT_CHAOS_LOOP``, two ``apps.miner`` processes at their defaults
        and an ``apps.client``: the Result held as the serving path holds
        its jobs, the server's chaos counters (its health line after the
        Result) showing the scenario's faults, the miners' launches.  Prints each leg's time
        to Result, counters and launches beside the card."""
        import shutil
        import tempfile

        from bitcoin_miner_tpu_torch.apps.drill import run_drill
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
        from bitcoin_miner_tpu_torch.ops.sweep import sweep_min_hash

        deadline = time.monotonic() + CHAOS_PHASE_S
        drills, launches = {}, 0
        for name, seed, kill_at in CHAOS_DRILLS:
            data = f"chaos-card-{name}"
            r = sweep_min_hash(data, 0, CHAOS_MAX_NONCE, device=self.dev)
            want = (r.hash, r.nonce)
            n0 = minhash.launches
            rep = run_drill(name, seed=seed, data=data, max_nonce=CHAOS_MAX_NONCE,
                            n_miners=CHAOS_MINERS, kill_miner_at=kill_at, backend="auto",
                            timeout=min(CHAOS_DRILL_S, deadline - time.monotonic()),
                            oracle=lambda d, lo, hi, want=want: want)
            row = dict(rep.as_dict(), launches=minhash.launches - n0)
            drills[name] = row
            log(f"  drill {name} (seed {seed}, kill {kill_at}): Result {rep.got} in "
                f"{rep.result_s} s (drill {rep.elapsed:.3f} s); sweep_min_hash on the card "
                f"{want}; launches {row['launches']}; miners {rep.miners}; counters "
                f"{rep.counters} [{self.card}]")
            if rep.errors or not rep.ok or rep.got is None:
                raise AssertionError(f"drill {name}: {row}")
            if hash_nonce(data, rep.got[1]) != rep.got[0]:
                raise AssertionError(f"drill {name}: hashlib disagrees with {rep.got}")
            if row["launches"] <= 0:
                raise AssertionError(f"drill {name}: the kernel was never launched")
            if {m["tier"] for m in rep.miners.values()} != {"cuda"}:
                raise AssertionError(f"drill {name}: a miner off the cuda rung: {rep.miners}")
            missing = [k for k in CHAOS_WANT[name] if rep.counters.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"drill {name}: no {missing} in {rep.counters}")
            if kill_at is not None and rep.counters.get("sched.chunks_reassigned", 0) \
                    + rep.counters.get("miner.reconnects", 0) <= 0:
                raise AssertionError(f"drill {name}: no reassignment or re-Join: "
                                     f"{rep.counters}")
            launches += row["launches"]
        work = tempfile.mkdtemp(prefix="chaos-")
        keep = os.path.join(ROOT, "bitcoin_miner_tpu_torch", "build", "chaos")
        fleet = None
        try:
            fleet = ServeFleet(work, "chaos-serve", deadline, miner_args=SERVE_MINER_ARGS,
                               env=CHAOS_SERVE_ENV)
            fleet.start_miners(2, serial=False)
            jobs = [CHAOS_SERVE_JOB]
            before = re.findall(r"health .*", fleet.read("log.txt"))
            got, _ = fleet.jobs(jobs)
            t_end = time.monotonic()
            self.serve_held(fleet, jobs, got)
            time.sleep(1.5)  # the server's ticker flushes its trace each second
            rows, _ = self.serve_traced(fleet, jobs, got)
            # The server's chaos counters: its health line (every 10 s, a
            # repeat skipped) as of a tick after the Result.
            while time.monotonic() < t_end + 11 and len(
                    re.findall(r"health .*", fleet.read("log.txt"))) <= len(before):
                time.sleep(0.1)
            health = re.findall(r"health .*", fleet.read("log.txt"))[-1]
            counters = {f"chaos.{k}": float(v) for k, v in HEALTH_CHAOS.findall(health)}
            start = {f"chaos.{k}": float(v) for k, v in HEALTH_CHAOS.findall(
                before[-1] if before else "")}
            fleet.stop()
            log(f"  served job under {CHAOS_SERVE_ENV}: {rows[0]['data']!r} "
                f"[0, {rows[0]['max_nonce']}] in {rows[0]['client_wall_s']:.3f} s at the "
                f"client, {rows[0]['sched_s']} s in the scheduler; the server's counters "
                f"{counters} (at the last health line before the job: {start}); launches "
                f"per drained miner {fleet.launches} [{self.card}]")
            # A short job's server may send no packet inside the 0.2 s cut
            # of a period: any of the scenario's faults shows that the armed
            # weather shaped the traffic.
            if not any(counters.get(k, 0) > 0 for k in CHAOS_WANT[
                    CHAOS_SERVE_ENV["BMT_CHAOS_SCENARIO"]]):
                raise AssertionError(f"served job: no chaos counter in {health!r}")
            if len(fleet.launches) != 2 or not all(ln["minhash"] > 0 for ln in fleet.launches):
                raise AssertionError(f"served job: a miner never launched: {fleet.launches}")
            launches += sum(ln["minhash"] for ln in fleet.launches)
            fleet.stopped.join(timeout=30)
            if time.monotonic() > deadline:
                raise AssertionError(f"the chaos phase ran past {CHAOS_PHASE_S} s")
            self.k_stats["launches_chaos"] = launches
            self.chaos = dict(drills=drills, served=dict(
                rows[0], env=CHAOS_SERVE_ENV, counters=counters, counters_before_job=start,
                launches=fleet.launches),
                card=self.card)
        finally:
            if fleet is not None:
                fleet.kill_all()
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(work, keep, dirs_exist_ok=True)
            shutil.rmtree(work, ignore_errors=True)

    def fed_drills(self) -> dict:
        """Leg (a) of the federation path: the port's four drills in this
        process, miners on ``make_search("auto")`` (the cuda rung).  Each
        job's oracle is ``sweep_min_hash`` on the card, swept before the
        drills (the drills' keys come from the same ring, so they are known
        ahead); the kernel's count is set to 0 after those sweeps, so what
        it reads after each drill is the drill's miners' alone."""
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.federation import Ring
        from bitcoin_miner_tpu_torch.federation.drill import DRILLS, run_fed_drill
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
        from bitcoin_miner_tpu_torch.ops.sweep import sweep_min_hash
        from bitcoin_miner_tpu_torch.utils.metrics import METRICS

        ring = Ring(["r0", "r1"])

        def key(home, prefix):
            return next(f"{prefix}{i}" for i in range(4096)
                        if ring.home(f"{prefix}{i}") == home)

        sizes = dict.fromkeys(DRILLS, FED_DRILL_HI)
        keys = {"shed-storm": [key("r0", "calm")],
                "drain-handoff": [key("r1", "drain"), key("r0", "scratch")],
                "death-detect": [key("r1", "death")],
                "ack-retransmit": [key("r1", "ackpart")]}
        table = {}
        for name, ks in keys.items():
            for k in ks:
                r = sweep_min_hash(k, 0, sizes[name], device=self.dev)
                if hash_nonce(k, r.nonce) != r.hash:
                    raise AssertionError(f"hashlib disagrees with sweep_min_hash on {k!r}")
                table[(k, 0, sizes[name])] = (r.hash, r.nonce)

        def oracle(d, lo, hi):
            return table[(d, lo, hi)]  # a job the table lacks fails the drill

        minhash.launches = 0  # counts from here on are this path's
        drills = {}
        for name in DRILLS:
            kw = dict(hi=sizes[name], backend="auto", oracle=oracle)
            if name == "drain-handoff":
                kw["rate"] = FED_DRAIN_RATE
            before, n0, t0 = METRICS.snapshot(), minhash.launches, time.monotonic()
            rep = run_fed_drill(name, seed=1, **kw)
            after = METRICS.snapshot()
            counters = {k: after[k] - before.get(k, 0) for k in sorted(after)
                        if k.startswith(("federation.", "fed.", "gossip."))
                        and after[k] != before.get(k, 0)}
            row = dict(rep, seconds=time.monotonic() - t0, launches=minhash.launches - n0,
                       counters=counters, jobs={k: [0, sizes[name], *table[(k, 0, sizes[name])]]
                                                for k in keys[name]})
            drills[name] = row
            log(f"  drill {name}: ok {rep['ok']} in {row['seconds']:.3f} s; launches "
                f"{row['launches']}; miners {rep['miners']}; evidence "
                f"{ {k: v for k, v in rep.items() if k not in ('miners', 'errors', 'name')} }; "
                f"counters {counters} [{self.card}]")
            if rep["errors"] or not rep["ok"]:
                raise AssertionError(f"drill {name}: {row}")
            if row["launches"] <= 0:
                raise AssertionError(f"drill {name}: the kernel was never launched")
            if {m["tier"] for m in rep["miners"].values()} != {"cuda"}:
                raise AssertionError(f"drill {name}: a miner off the cuda rung: {rep['miners']}")
            if name == "drain-handoff" and not (
                    rep["resumed_nonces_swept"] < rep["scratch_nonces_swept"]):
                raise AssertionError(f"drill {name}: resumed {rep['resumed_nonces_swept']} "
                                     f"not below {rep['scratch_nonces_swept']}")
        return drills

    def fed_processes(self, fleet, search, oracles) -> dict:
        """Leg (b) of the federation path on a started :class:`FedFleet`:
        (1) a key homed on r2 sent to r1 (forwarded); (2) twin Requests for
        an r1-homed key at both ports (one sweep: the miners' launches
        equal those of the submitted job's chunks swept here); (3) a range
        r1 solved, asked of r2 after eight gossip intervals (answered from
        the gossiped spans: no forward, no launch); (4) r2 SIGKILLed, then
        an r2-homed key at r1 (answered by r1's own miner).  Per leg: each
        Result, its seconds to Result, each miner's launches.  ``oracles``
        collects every ``(data, 0, hi) -> Result`` to hold later.  Leaves
        r1 live for the SIGTERM leg."""
        from bitcoin_miner_tpu_torch.federation import Ring

        ring = Ring(list(FED_CELLS))

        def key(home, prefix):
            return next(f"{prefix}{i}" for i in range(4096)
                        if ring.home(f"{prefix}{i}") == home)

        pid = {cell: fleet.miners[cell].pid for cell in FED_CELLS}
        legs = {}

        def leg(name, jobs):
            before = fleet.settled()
            got = fleet.jobs(jobs)
            after = fleet.settled()
            per = {cell: after.get(pid[cell], 0) - before.get(pid[cell], 0)
                   for cell in FED_CELLS}
            for (cell, data, hi), g in zip(jobs, got):
                oracles.setdefault((data, 0, hi), []).append((cell, g[:2]))
            legs[name] = dict(jobs=[list(j) for j in jobs], results=[list(g[:2]) for g in got],
                              seconds=[g[2] for g in got], launches=per)
            log(f"  federation ({name}) {jobs} -> {[g[:2] for g in got]}; time to Result "
                f"{', '.join(f'{g[2]:.3f}' for g in got)} s at the client; launches per "
                f"miner {per} [{self.card}]")
            return got, per

        def events(cell, span, event, data):
            return [r for r in fleet.trace(cell) if (r["span"], r["event"]) == (span, event)
                    and (r.get("attrs") or {}).get("data") == data]

        # (1) forwarded: r1 relays to r2, whose miner sweeps.
        k_fwd = key("r2", "fed-forward-")
        _got, per_fwd = leg("forward", [("r1", k_fwd, FED_JOB_HI)])
        # (2) twins at both ports: r2 forwards, r1 sweeps once.
        k_twin = key("r1", "fed-twin-")
        got_twin, per_twin = leg("twins", [("r1", k_twin, FED_JOB_HI),
                                           ("r2", k_twin, FED_JOB_HI)])
        if got_twin[0][:2] != got_twin[1][:2]:
            raise AssertionError(f"federation (twins): different Results {got_twin}")
        # (3) gossip: r1 solves, r2 answers from the gossiped spans.
        k_gossip = key("r1", "fed-gossip-")
        leg("solve", [("r1", k_gossip, FED_JOB_HI)])
        time.sleep(8 * FED_GOSSIP_S)
        _got, per_gossip = leg("gossip", [("r2", k_gossip, FED_JOB_HI)])
        time.sleep(1.2)  # each replica's ticker flushes its trace every second
        fwd = {k: events("r2", "fed", "forward", k) for k in (k_twin, k_gossip)}
        if not fwd[k_twin] or fwd[k_gossip] or any(per_gossip.values()):
            raise AssertionError(f"federation: r2 forwarded {fwd}; gossip leg's launches "
                                 f"{per_gossip}")
        # (4) SIGKILL r2; its key at r1 is swept by r1's miner.
        legs["counters_r2_before_kill"] = fleet.counters("r2")
        fleet.cells["r2"].kill()
        fleet.cells["r2"].wait()
        time.sleep(10 * FED_GOSSIP_S)  # past suspicion and confirmation
        k_dead = key("r2", "fed-failover-")
        _got, per_dead = leg("failover", [("r1", k_dead, FED_JOB_HI)])
        time.sleep(1.2)
        rows = fleet.trace("r1")
        fwd = events("r1", "fed", "forward", k_fwd)
        if len(fwd) != 1 or per_fwd["r1"] != 0 or per_fwd["r2"] <= 0:
            raise AssertionError(f"federation (forward): r1 traced {fwd}, launches {per_fwd}")
        tids = [r["trace"] for r in rows if (r["span"], r["event"]) == ("gw", "request")
                and (r.get("attrs") or {}).get("data") == k_twin]
        ev = {t: [r["event"] for r in rows if r["trace"] == t and r["span"] == "gw"]
              for t in tids}
        primary = [t for t in tids if "submit" in ev[t]]
        if len(tids) != 2 or len(primary) != 1:
            raise AssertionError(f"federation (twins): r1's gw events {ev}")
        chunks = [(r["attrs"]["lo"], r["attrs"]["hi"]) for r in rows
                  if r["trace"] == primary[0] and (r["span"], r["event"]) == ("sched", "dispatch")]
        one, best = self.replay(search, k_twin, chunks)
        legs["twins"].update(gw_events=list(ev.values()), chunks=len(chunks),
                             one_sweep_launches=one)
        log(f"  federation (twins): r1's gw events {list(ev.values())}; {len(chunks)} chunks; "
            f"the miners launched {sum(per_twin.values())}, one sweep of those chunks here "
            f"{one}")
        if sum(per_twin.values()) != one or per_twin["r2"] != 0 or best != got_twin[0][:2]:
            raise AssertionError(f"federation (twins): launches {per_twin} != one sweep's "
                                 f"{one}, or its fold {best} != {got_twin[0][:2]}")
        asked = events("r1", "gw", "request", k_gossip)
        fall = events("r1", "fed", "local_fallback", k_dead)
        if len(asked) != 1 or not fall or per_dead["r1"] <= 0:
            raise AssertionError(f"federation: r1 saw {len(asked)} requests for the gossiped "
                                 f"range; failover traced {fall}, launches {per_dead}")
        return legs

    def phase_federation(self) -> None:
        """The federation tier and the model entry on the card.  (a) The
        port's four drills in this process (:meth:`fed_drills`).  (b) Two
        ``apps.federation`` replica processes with one ``apps.miner`` each
        (started before the drills, so their start-up overlaps them) and
        ``apps.client`` jobs (:meth:`fed_processes`); then r1 SIGTERMed:
        it prints ``Replica r1 draining`` and exits 0.  Every Result is held
        to ``sweep_min_hash`` on the card (swept while r1 drains) and
        hashlib.  (c) ``forward_step_example(device="cuda")`` against its
        plain version, and at the main path's shape ("cmu440", d 10, k 6,
        batch 1024) against ``sweep_min_hash`` over the same 1.024e9
        nonces.  Prints each leg's time to Result, counters and launches
        per miner beside the card."""
        import shutil
        import tempfile

        from bitcoin_miner_tpu_torch.apps import miner
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.models import forward_step_example
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash, minhash_plain
        from bitcoin_miner_tpu_torch.ops.sweep import sweep_min_hash

        deadline = time.monotonic() + FED_PHASE_S
        work = tempfile.mkdtemp(prefix="federation-")
        keep = os.path.join(ROOT, "bitcoin_miner_tpu_torch", "build", "federation")
        fleet = FedFleet(work, deadline)
        try:
            fleet.start()
            drills = self.fed_drills()
            fleet.joined()
            search = miner.make_async_search("cuda")
            oracles = {}
            legs = self.fed_processes(fleet, search, oracles)
            # r2 back with a fresh incarnation, so r1's drain has a live
            # successor (a drain whose every peer is dead waits out LSP
            # epochs on each dead conn): once its gossip conn to r1 is up
            # and a few beats went by, SIGTERM r1, and sweep the oracles
            # and drive the model here while it drains.
            fleet.start_cell("r2", "r2-restarted")
            while not any((r["span"], r["event"]) == ("lsp", "connect")
                          and (r.get("attrs") or {}).get("label") == "gossip-r2"
                          for r in fleet.trace("r2-restarted")):
                if time.monotonic() > deadline:
                    raise AssertionError("the restarted r2 never reached r1")
                time.sleep(0.1)
            time.sleep(4 * FED_GOSSIP_S)
            r1 = fleet.cells["r1"]
            legs["counters_r1_before_drain"] = fleet.counters("r1")
            t_term, exited = time.monotonic(), []
            r1.terminate()
            waiter = threading.Thread(target=lambda: exited.append(
                (r1.wait(), time.monotonic())), daemon=True)
            waiter.start()
            held = []
            for (data, lo, hi), got in oracles.items():
                r = sweep_min_hash(data, lo, hi, device=self.dev)
                for cell, g in got:
                    held.append([cell, data, hi, list(g)])
                    if tuple(g) != (r.hash, r.nonce) or hash_nonce(data, g[1]) != g[0]:
                        raise AssertionError(f"federation: {cell} answered {data!r} [0, {hi}] "
                                             f"with {g}; sweep_min_hash {r}")
            model = self.fed_model(forward_step_example, minhash, minhash_plain,
                                   sweep_min_hash, hash_nonce)
            waiter.join(timeout=max(1.0, min(t_term + FED_DRAIN_S, deadline)
                                    - time.monotonic()))
            if not exited:
                raise AssertionError(f"r1 did not exit within {FED_DRAIN_S} s of SIGTERM")
            drain_s = exited[0][1] - t_term
            out = fleet.read("r1.out")
            log(f"  federation (SIGTERM r1): exit {r1.returncode} after {drain_s:.3f} s; "
                f"stdout {out.splitlines()} [{self.card}]")
            if r1.returncode != 0 or "Replica r1 draining" not in out.splitlines():
                raise AssertionError(f"r1 exited {r1.returncode}: {out!r}")
            handoff = fleet.wait_for("r2", r"handoff from r1: (\d+) resumable", 1, 5)
            log(f"  federation (SIGTERM r1): the restarted r2 logged the handoff "
                f"({handoff} resumable identities)")
            for p in fleet.miners.values():
                if p.poll() is None:
                    p.terminate()
            for p in fleet.miners.values():
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            reports = fleet.reports()
            miners = {cell: reports.get(p.pid) for cell, p in fleet.miners.items()}
            if any(r is None for r in miners.values()):
                raise AssertionError(f"federation: a miner left no report: {miners}")
            launches = {cell: r["launches"] for cell, r in miners.items()}
            counters = {"r1": legs.pop("counters_r1_before_drain"),
                        "r2": legs.pop("counters_r2_before_kill")}
            log(f"  federation processes: launches per miner {launches}, exits "
                f"{ {c: r['exit'] for c, r in miners.items()} }; counters at each cell's last "
                f"health line {counters}; {len(held)} Results held to sweep_min_hash and "
                f"hashlib [{self.card}]")
            in_drills = sum(d["launches"] for d in drills.values())
            self.k_stats["launches_federation"] = in_drills + sum(launches.values())
            self.fed = dict(drills=drills, processes=dict(
                legs=legs, launches=launches, counters=counters, drain_s=drain_s,
                handoff_identities=int(handoff),
                held=held), model_entry=model, launches_drills=in_drills, card=self.card)
            if time.monotonic() > deadline:
                raise AssertionError(f"the federation phase ran past {FED_PHASE_S} s")
        finally:
            fleet.kill_all()
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(work, keep, dirs_exist_ok=True)
            shutil.rmtree(work, ignore_errors=True)

    def fed_model(self, forward_step_example, minhash, minhash_plain, sweep_min_hash,
                  hash_nonce) -> dict:
        """Leg (c): the model entry on the card against its plain version
        at the default shape, and at the main path's shape against
        ``sweep_min_hash`` over the same nonces."""
        fn, args = forward_step_example(device="cuda")
        if fn is not minhash:
            raise AssertionError(f"forward_step_example(device='cuda') gave {fn}")
        n0 = minhash.launches
        got = fn(*args).tolist()
        want = minhash_plain(*args).tolist()
        launches = minhash.launches - n0
        if got != want or launches != 1:
            raise AssertionError(f"model entry: kernel {got}, plain {want}, launches {launches}")
        d, k, batch = 10, MAIN_K, MAIN_B
        fn, args = forward_step_example(b"cmu440", d=d, k=k, batch=batch, device="cuda")
        ms, tri = self.time_kernel(lambda: fn(*args), reps=3, warm=1)
        lo = 10 ** (d - 1)
        hi = lo + batch * 10**k - 1
        r = sweep_min_hash("cmu440", lo, hi, device=self.dev)
        mine = ((tri[0] << 32) | tri[1], lo + tri[2])
        log(f"  model entry: default shape {got} == plain; ('cmu440', d {d}, k {k}, batch "
            f"{batch}) -> {tri} = {mine}, {ms:.3f} ms per call; sweep_min_hash over "
            f"[{lo}, {hi}] {(r.hash, r.nonce)} [{self.card}]")
        if mine != (r.hash, r.nonce) or hash_nonce("cmu440", mine[1]) != mine[0]:
            raise AssertionError(f"model entry at the main shape: {mine} != {r}")
        return dict(default=got, main_shape=[d, k, batch], main_triple=tri, main_ms=ms,
                    sweep_min_hash=[r.hash, r.nonce])

    def run_tool(self, main, argv) -> dict:
        """One port tool's ``main(argv)`` in this process: its return code
        must be 0; returns its JSON line (the last line of its stdout)."""
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        lines = buf.getvalue().strip().splitlines()
        if rc != 0 or not lines:
            raise AssertionError(f"tool {argv}: exit {rc}, stdout {buf.getvalue()[-2000:]!r}")
        return json.loads(lines[-1])

    def tools_loadgen(self) -> dict:
        """The tools path's loadgen runs (in this process, miners on the
        cuda rung, the card as the oracle): the default mode, --overlap
        and --open-loop, each held to the tool's own invariants."""
        from bitcoin_miner_tpu_torch.tools import loadgen

        out = {}
        for name, extra in (("default", []), ("overlap", ["--overlap"]),
                            ("open_loop", TOOLS_OPEN_LOOP)):
            t0 = time.monotonic()
            row = out[name] = self.run_tool(loadgen.main, [*TOOLS_LOADGEN, *extra])
            row["seconds"] = time.monotonic() - t0
            if (row["tier"], row["oracle"], row["device"]) != (
                    "cuda", "card", self.torch.cuda.get_device_name(0)):
                raise AssertionError(f"loadgen {name}: ran on {row['tier']}, {row['device']}, "
                                     f"oracle {row['oracle']}")
            if row["repeat_zero_chunks"] is not True:
                raise AssertionError(f"loadgen {name}: the repeat probe assigned chunks")
            getattr(self, f"tools_loadgen_{name}")(row)
        return out

    def tools_loadgen_default(self, d: dict) -> None:
        gw = d["gateway_counters"]
        hits = gw.get("gateway.coalesced", 0) + gw.get("gateway.cache_hits", 0)
        launches = (d["launches"]["minhash"], d["baseline_launches"]["minhash"])
        log(f"  loadgen (default): {d['jobs']} jobs, {d['distinct_signatures']} distinct, "
            f"{d['value']} jobs/s gateway against {d['baseline_jobs_per_sec']} baseline; hits "
            f"{hits} (coalesced {gw.get('gateway.coalesced', 0)}, cache "
            f"{gw.get('gateway.cache_hits', 0)}); swept {d['swept_nonces']} against "
            f"{d['baseline_swept_nonces']}; row 2 launches gateway {launches[0]}, baseline "
            f"{launches[1]}, oracle {d['oracle_launches']['minhash']}; latency "
            f"{d['latency_s']}; {d['seconds']:.1f} s [{self.card}]")
        if hits != d["jobs"] - d["distinct_signatures"] + 1:
            raise AssertionError(f"loadgen: {hits} gateway hits for {d['jobs']} jobs, "
                                 f"{d['distinct_signatures']} distinct")
        if not 0 < launches[0] < launches[1]:
            raise AssertionError(f"loadgen: launches gateway {launches[0]}, baseline "
                                 f"{launches[1]}")

    def tools_loadgen_overlap(self, o: dict) -> None:
        log(f"  loadgen (--overlap): {o['jobs']} jobs, {o['distinct_signatures']} distinct; "
            f"swept {o['swept_nonces']} against the exact cache's {o['exact_swept_nonces']} "
            f"(reduction {o['swept_reduction']}); row 2 launches {o['launches']['minhash']} "
            f"against {o['exact_launches']['minhash']}, oracle "
            f"{o['oracle_launches']['minhash']}; sub-range probe 0 chunks "
            f"{o['subrange_zero_chunks']}; {o['seconds']:.1f} s [{self.card}]")
        if o["subrange_zero_chunks"] is not True or o["launches"]["minhash"] <= 0:
            raise AssertionError(f"loadgen --overlap: {o}")

    def tools_loadgen_open_loop(self, ol: dict) -> None:
        st = ol["open_loop"]
        log(f"  loadgen (--open-loop 2, 5 s): offered {st['offered']}, completed "
            f"{st['completed']}, failed {st['failed']}, shed {st['shed']}; p50 "
            f"{st['latency_s']['p50']} s, p95 {st['latency_s']['p95']} s; row 2 launches "
            f"{ol['launches']['minhash']}, oracle {ol['oracle_launches']['minhash']}; "
            f"{ol['seconds']:.1f} s [{self.card}]")
        if st["completed"] <= 0 or st["wrong"] or ol["subrange_zero_chunks"] is not True:
            raise AssertionError(f"loadgen --open-loop: {ol}")

    def tools_chaos(self) -> dict:
        """The tools path's chaos_replay runs (in this process, miners on
        the cuda rung, the card as the oracle)."""
        from bitcoin_miner_tpu_torch.tools import chaos_replay

        out = {}
        for name, argv in (("burst-loss", TOOLS_CHAOS), ("death-detect", TOOLS_FED)):
            t0 = time.monotonic()
            row = self.run_tool(chaos_replay.main, argv)
            row["seconds"] = time.monotonic() - t0
            out[name] = row
            log(f"  chaos_replay {name}: ok {row['ok']}, {row.get('got') or row.get('bit_exact')}"
                f"; row 2 launches {row['launches']['minhash']}, oracle "
                f"{row['oracle_launches']['minhash']}; miners {row['miners']}; "
                f"{row['seconds']:.1f} s [{self.card}]")
            if not row["ok"] or row["tier"] != "cuda" or row["launches"]["minhash"] <= 0:
                raise AssertionError(f"chaos_replay {name}: {row}")
            if {m["tier"] for m in row["miners"].values()} != {"cuda"}:
                raise AssertionError(f"chaos_replay {name}: a miner off the cuda rung")
        if out["burst-loss"]["counters"].get("chaos.dropped", 0) <= 0:
            raise AssertionError(f"chaos_replay burst-loss dropped nothing: "
                                 f"{out['burst-loss']['counters']}")
        return out

    def phase_tools(self) -> None:
        """The port's operator tools on the card.  The autoscale supervisor
        (``python -m bitcoin_miner_tpu_torch.tools.autoscale``) starts
        first, against a port server process with ``--fleet-log``, so its
        worker's start-up overlaps the rest: this script appends burn rows
        to that log until the supervisor spawns its one worker (the plain
        port miner, ``--backend auto``, observed by WORKER_HOOK).  Then, in
        this process, ``loadgen`` (default mode, ``--overlap``,
        ``--open-loop``) and ``chaos_replay`` (burst-loss, the death-detect
        federation drill), every miner on the cuda rung and every Result
        held by the tool to ``sweep_min_hash`` on the card and to
        ``hash_nonce``.  Then TOOLS_AS_JOB through an ``apps.client`` to
        the worker alone, held to ``sweep_min_hash`` and hashlib; the
        supervisor is SIGTERMed and must exit 0, its worker drained with
        exit 0 and launches.  The kernels' counts are set to 0 at the start
        and read at the end; the oracles' launches are counted apart."""
        import shutil
        import signal
        import tempfile

        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.ops.sweep import sweep_min_hash
        from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
        from bitcoin_miner_tpu_torch.ops.hot import hot_merge
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored
        from bitcoin_miner_tpu_torch.tools import kernel_launches

        deadline = time.monotonic() + TOOLS_PHASE_S
        work = tempfile.mkdtemp(prefix="tools-")
        keep = os.path.join(ROOT, "bitcoin_miner_tpu_torch", "build", "tools")
        fleet = supervisor = None
        spawned, stop_rows = threading.Event(), threading.Event()
        t_phase = time.monotonic()
        try:
            for wrapper in (minhash, minhash_factored, blake2b_minhash, hot_merge):
                wrapper.launches = 0  # counts from here on are this path's
            fleet = GateFleet(work, "tools-autoscale", deadline, ["--fleet-log=fleet.jsonl"])
            supervisor = fleet._spawn("supervisor", [
                "-m", "bitcoin_miner_tpu_torch.tools.autoscale", f"127.0.0.1:{fleet.port}",
                "--fleet-log", "fleet.jsonl", "--spec", TOOLS_AS_SPEC])
            rows = []

            def burn():
                """Burn rows into the server's fleet log until the spawn."""
                path = os.path.join(fleet.dir, "fleet.jsonl")
                while not stop_rows.is_set() and time.monotonic() < deadline:
                    with open(path, "a") as f:
                        f.write(json.dumps({"source": "chip_smoke", "slo": {
                            "alerts": ["tools-path-burn"]}, "gauges": {
                            "fleet.utilization": 1.0}}) + "\n")
                    rows.append(time.monotonic() - t_phase)
                    if '"last_action": "spawn 1"' in fleet.read("supervisor.out"):
                        spawned.set()
                        return
                    time.sleep(0.2)

            burner = threading.Thread(target=burn, name="tools-burn", daemon=True)
            burner.start()
            lg = self.tools_loadgen()
            ch = self.tools_chaos()
            in_process = kernel_launches()
            oracle = {k: sum(r["oracle_launches"][k] for r in (*lg.values(), *ch.values()))
                      for k in in_process}
            # The supervisor's leg: its worker alone serves the job.
            if not spawned.wait(timeout=max(0.0, deadline - time.monotonic())):
                raise AssertionError(f"the supervisor never spawned: "
                                     f"{fleet.read('supervisor.out')[-2000:]!r}")
            fleet.wait_for(r"miner (\d+) joined", 1, max(1.0, deadline - time.monotonic()))
            t_joined = time.monotonic() - t_phase
            data, hi = TOOLS_AS_JOB
            r = sweep_min_hash(data, 0, hi, device=self.dev)  # its launches are not the path's
            before = fleet.settled()
            got = fleet.finish_clients(fleet.spawn_clients([(fleet.port, data, hi)]), [TOOLS_AS_JOB])
            after = fleet.settled()
            h, n, job_s = got[0]
            if (h, n) != (r.hash, r.nonce) or hash_nonce(data, n) != h:
                raise AssertionError(f"supervisor leg: served ({h}, {n}), sweep_min_hash {r}")
            supervisor.send_signal(signal.SIGTERM)
            try:
                supervisor.wait(timeout=max(1.0, min(20.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                raise AssertionError("the supervisor did not exit within 20 s of SIGTERM")
            decisions = [json.loads(ln) for ln in fleet.read("supervisor.out").splitlines()
                         if ln.startswith("{")]
            reports = fleet.reports()
            log(f"  supervisor: {len(rows)} burn rows appended by this script to the server's "
                f"fleet log (the server arms no SLO), {rows[0]:.2f} to {rows[-1]:.2f} s into "
                f"the phase; decisions "
                f"{[(d['state'], d['live'], d['last_action']) for d in decisions]}; exit "
                f"{supervisor.returncode}; worker joined at {t_joined:.1f} s; "
                f"{TOOLS_AS_JOB} -> ({h}, {n}) in {job_s:.3f} s at the client, equal to "
                f"sweep_min_hash and hashlib; worker reports "
                f"{ {p: (rep['argv'][1:], rep['launches'], rep['exit'], rep['miner_events'][-1:], len(rep['miner_events'])) for p, rep in reports.items()} } "
                f"(argv, launches, exit, last miner event, events) [{self.card}]")
            if supervisor.returncode != 0:
                raise AssertionError(f"the supervisor exited {supervisor.returncode}: "
                                     f"{fleet.read('supervisor.out')[-2000:]!r}")
            if [d["last_action"] for d in decisions if d["acted"]][:1] != ["spawn 1"]:
                raise AssertionError(f"supervisor: decisions {decisions}")
            if len(reports) != 1:
                raise AssertionError(f"supervisor: {len(reports)} worker reports: {reports}")
            (pid, rep), = reports.items()
            served = after.get(pid, 0) - before.get(pid, 0)
            if rep["argv"][1:] != ["-m", "bitcoin_miner_tpu_torch.apps.miner",
                                   f"127.0.0.1:{fleet.port}", "--backend", "auto"] \
                    or rep["exit"] != 0 or "drained" not in rep["miner_events"] \
                    or served <= 0 or rep["launches"] != after.get(pid):
                raise AssertionError(f"supervisor's worker: {rep}, launches in the job {served}")
            fleet.stop()
            fleet.stopped.join(timeout=60)
            miners = {k: in_process[k] - oracle[k] for k in in_process}
            self.k_stats["launches_tools"] = miners["minhash"] + rep["launches"]
            self.tools = dict(
                loadgen=lg, chaos_replay=ch, in_process_miner_launches=miners,
                oracle_launches=oracle, supervisor=dict(
                    spec=TOOLS_AS_SPEC, burn_rows=[len(rows), rows[0], rows[-1]],
                    decisions=decisions,
                    exit=supervisor.returncode, worker=dict(
                        pid=pid, argv=rep["argv"][1:], launches=rep["launches"],
                        exit=rep["exit"], miner_events=len(rep["miner_events"]),
                        last_miner_event=rep["miner_events"][-1], joined_at_s=t_joined),
                    job=[data, hi, h, n, job_s], job_launches=served),
                seconds=time.monotonic() - t_phase, card=self.card)
            log(f"  tools path: row 2 launches by the tools' miners {self.k_stats['launches_tools']} "
                f"(in this process {miners['minhash']}, the supervisor's worker "
                f"{rep['launches']}); the oracles' {oracle['minhash']} apart [{self.card}]")
            if time.monotonic() > deadline:
                raise AssertionError(f"the tools phase ran past {TOOLS_PHASE_S} s")
        finally:
            stop_rows.set()
            if supervisor is not None and supervisor.poll() is None:
                supervisor.kill()
                supervisor.wait()
            if fleet is not None:
                # A worker the supervisor left behind: observed, never reported.
                for p in set(fleet.live_launches()) - set(fleet.reports()):
                    try:
                        os.kill(p, signal.SIGKILL)
                    except OSError:
                        pass
                fleet.kill_all()
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(work, keep, dirs_exist_ok=True)
            shutil.rmtree(work, ignore_errors=True)

    def phase_hot_path(self) -> None:
        """The hot plane: (a) the merge kernel against its plain version;
        (b) hot sweeps against per-chunk ones and the oracle; (c) the hot
        pipeline; (d) two shards on cuda:0; (e) the miner over LSP; (f) a
        U H H U pair of 1e9 Requests; (g) the merge's time per launch."""
        import numpy as np

        from bitcoin_miner_tpu_torch import lsp, workloads
        from bitcoin_miner_tpu_torch.apps import miner
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce, min_hash_range
        from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
        from bitcoin_miner_tpu_torch.ops.hot import (
            empty_launch, hot_merge, hot_merge_plain, new_carry)
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored
        from bitcoin_miner_tpu_torch.ops.sweep import SweepPipeline, sweep_min_hash
        from bitcoin_miner_tpu_torch.parallel import sweep_min_hash_sharded

        torch, dev = self.torch, self.dev
        # (a) the merge: seeded sequences from a vacant carry, then single
        # steps from random carries; values from a small set so ties occur.
        rng = np.random.default_rng(9)
        hs = [0, 1, 2, 7, U32_MAX - 1, U32_MAX]
        sentinel = (U32_MAX, U32_MAX, I32_MAX)

        def draw():
            if rng.random() < 0.25:
                return sentinel
            return (int(rng.choice(hs)), int(rng.choice(hs)), int(rng.integers(0, 50)))

        n_cases = max_err = 0
        for n in (1, 2):
            for sieve in (False, True):
                cases = [(None, [[(U32_MAX, U32_MAX, 5)] + [sentinel] * (n - 1)]
                          + [[draw() for _ in range(n)] for _ in range(199)])]
                cases += [([int(rng.choice(hs)), int(rng.choice(hs)), int(rng.integers(0, 9)),
                            int(rng.integers(0, 2)), int(rng.integers(0, 50))],
                           [[draw() for _ in range(n)]]) for _ in range(100)]
                for start, steps in cases:
                    carry, ref = new_carry(dev), new_carry(dev)
                    if start is not None:
                        carry.copy_(torch.tensor(start))
                        ref.copy_(carry)
                    words = [torch.full((1,), -1, dtype=torch.int32, device=dev)
                             for _ in range(2)]
                    for seq, outs in enumerate(steps):
                        outs = [torch.tensor(o, device=dev) for o in outs]
                        got = hot_merge(outs, seq + 9, carry, words[:1] if sieve else [])
                        want = hot_merge_plain(outs, seq + 9, ref, words[1:] if sieve else [])
                        torch.cuda.synchronize()
                        n_cases += 1
                        err = max(int((a - b).abs().max()) for a, b in (
                            (got, want), (carry, ref), (words[0], words[1])))
                        max_err = max(max_err, err)
                        if err:
                            raise AssertionError(
                                f"hot_merge != plain (n={n}, sieve={sieve}, step {seq}): "
                                f"{got.tolist()} {carry.tolist()} {words[0].tolist()} vs "
                                f"{want.tolist()} {ref.tolist()} {words[1].tolist()}")
        self.h_stats["max_abs_err"] = max_err
        log(f"hot_merge == plain, bit-exact, in {n_cases} steps (N 1 and 2, both forms, "
            f"vacant and random carries; tolerance 0)")

        # (b) hot against per-chunk on 1e9 Requests of each kernel's path,
        # and against the oracle on small ranges.
        b2, sha = workloads.get("blake2b64"), workloads.get("sha256d")
        paths = [("sha256d", "cmu440", sha, False, minhash),
                 ("sha256d", FIB1_DATA, sha, False, minhash),
                 ("blake2b64", "cmu440", b2, False, blake2b_minhash),
                 ("sha256d factored", FIB1_DATA, sha, True, minhash_factored)]
        kernels = (minhash, minhash_factored, blake2b_minhash)
        for label, data, w, factored, kern in paths:
            kw = dict(device=dev, workload=w, factored=factored)
            n0, m0, k0 = sum(k.launches for k in kernels), hot_merge.launches, kern.launches
            got = sweep_min_hash(data, 0, 10**9 - 1, hot=True, **kw)
            # Every kernel launch (the factored path's d = 1 class takes the
            # unfactored kernel) is followed by one merge.
            launched = (sum(k.launches for k in kernels) - n0, hot_merge.launches - m0)
            want = sweep_min_hash(data, 0, 10**9 - 1, **kw)
            ok = (got.hash, got.nonce, got.lanes_swept) == (want.hash, want.nonce,
                                                            want.lanes_swept)
            log(f"  {label} {data[:12]!r}[0, 999999999] hot {(got.hash, got.nonce)} == "
                f"per-chunk: {'OK' if ok else 'MISMATCH'}; launches (kernel, merge) {launched}")
            if not ok or launched[0] != launched[1] or kern.launches == k0:
                raise AssertionError(f"{label}: hot {got} / per-chunk {want}, {launched}")
        small = [(985, 101_234, dict(max_k=3, batch=4)), (10**19 - 40, 10**19 + 25, {}),
                 (2**64 - 60, 2**64 - 1, {})]
        for label, _data, w, factored, _kern in paths[::2] + paths[3:]:
            for lo, hi, kw in small:
                want = w.min_range("hot", lo, hi)
                for sieve in (False, True):
                    got = sweep_min_hash("hot", lo, hi, device=dev, workload=w, hot=True,
                                         factored=factored, sieve=sieve, **kw)
                    if (got.hash, got.nonce, got.lanes_swept) != (*want, hi - lo + 1):
                        raise AssertionError(f"{label} [{lo}, {hi}] sieve={sieve}: hot {got} "
                                             f"!= oracle {want}")
                    n_cases += 1
        log(f"hot sweeps == oracle on small ranges, across 10^19 and up to 2^64 - 1, "
            f"both forms, three kernels")

        # (c) the hot pipeline: back-to-back jobs, one wholly host-folded.
        jobs = [("cmu440", 0, 99_999), ("cmu440", 10**9, 2 * 10**9 - 1),
                (FIB1_DATA, 0, 999_999_999), ("cmu440", 999_900_000, 1_000_099_999)]
        p = SweepPipeline(backend="cuda", hot=True)
        try:
            futs = [(job, p.submit(*job)) for job in jobs]
            for job, fut in futs:
                r = fut.result(timeout=300)
                want = (min_hash_range(*job) if job[2] - job[1] < 10**6
                        else sweep_min_hash(*job, device=dev))
                want = want if isinstance(want, tuple) else (want.hash, want.nonce)
                if (r.hash, r.nonce) != want or r.lanes_swept != job[2] - job[1] + 1:
                    raise AssertionError(f"hot pipeline {job[0][:12]!r}{job[1:]}: {r} != {want}")
                log(f"  hot pipeline {job[0][:12]!r}[{job[1]}, {job[2]}] -> {(r.hash, r.nonce)} OK")
        finally:
            p.close()

        # (d) two shards on cuda:0 with hot=True against one device.
        for label, data, w, factored, _kern in paths:
            kw = dict(workload=w, factored=factored)
            one = sweep_min_hash(data, 0, 10**9 - 1, device=dev, **kw)
            got = sweep_min_hash_sharded(data, 0, 10**9 - 1, devices=[dev, dev], hot=True, **kw)
            if (got.hash, got.nonce, got.lanes_swept) != (one.hash, one.nonce, one.lanes_swept):
                raise AssertionError(f"{label}: two hot shards {got} != one device {one}")
            log(f"  {label} {data[:12]!r}[0, 999999999] two hot shards on cuda:0 == one "
                f"device OK")

        # (e) the miner over LSP with the hot rung on.
        def hot_miner(server):
            client = lsp.Client("127.0.0.1", server.port)
            try:
                miner.run_miner(client, miner.make_async_search("cuda", hot=True))
            finally:
                try:
                    client.close()
                except lsp.LspError:
                    pass
            return 0

        argv = ["--backend", "cuda", "hot=True"]
        _folds, _rates, launches = self.drive_miner(
            argv, [("cmu440", 999_999_999)], hash_nonce, min_hash_range,
            (minhash, minhash_factored, blake2b_minhash, hot_merge), run=hot_miner)
        self.same_as_single_device(" ".join(argv))
        log(f"miner hot=True over LSP: every Result equals the per-chunk miner's; "
            f"launches {launches}")
        if launches["hot_merge"] <= 0 or launches["hot_merge"] != launches["minhash"]:
            raise AssertionError(f"hot miner: merge launches != kernel launches: {launches}")
        self.h_stats["launches"] = launches["hot_merge"]
        self.hot["launches_miner"] = launches

        # (f) U H H U: nonces/s per 1e9 Request, per-chunk against hot.
        pipes = {"per-chunk": SweepPipeline(backend="cuda"),
                 "hot": SweepPipeline(backend="cuda", hot=True)}
        try:
            for pp in pipes.values():  # warm: streams and pinned buffers
                pp.submit("cmu440", 2 * 10**9, 2 * 10**9 + 10**6 - 1).result(timeout=300)
            lo, hi = 10**9, 2 * 10**9 - 1
            rates, found = {}, set()
            for name in ("per-chunk", "hot", "hot", "per-chunk"):
                t0 = time.monotonic()
                r = pipes[name].submit("cmu440", lo, hi).result(timeout=300)
                dt = time.monotonic() - t0
                if r.hash != hash_nonce("cmu440", r.nonce):
                    raise AssertionError(f"{name}: bad result {r}")
                found.add((r.hash, r.nonce))
                rates.setdefault(name, []).append((hi - lo + 1) / dt)
            if len(found) != 1:
                raise AssertionError(f"per-chunk and hot disagree: {found}")
        finally:
            for pp in pipes.values():
                pp.close()
        self.hot["request_pair_u_h_h_u"] = rates
        log(f"nonces/s per 1e9 Request 'cmu440'[{lo}, {hi}], U H H U: per-chunk "
            f"{rates['per-chunk']}, hot {rates['hot']} [{self.card}]")

        # (g) the merge per launch on the device (a CUDA Graph of many
        # launches, replayed between CUDA events), an empty kernel timed the
        # same way as its bound; beside them the same launches issued back
        # to back from Python (the host's issue time per launch) and the
        # plain version per call.
        reps = 2000
        outs = [torch.tensor((3, 4, 7), device=dev), torch.tensor((3, 4, 2), device=dev)]
        carry = new_carry(dev)
        word = torch.full((1,), -1, dtype=torch.int32, device=dev)

        def empty():
            empty_launch(dev)
            return carry

        times = {"empty": self.graph_time(empty, reps),
                 "empty issue": self.time_kernel(empty, reps=reps, warm=20)[0]}
        for n in (1, 2):
            merge = functools.partial(hot_merge, outs[:n], 5, carry, [word])
            times[f"merge {n}"] = self.graph_time(merge, reps)
            times[f"merge issue {n}"], _ = self.time_kernel(merge, reps=reps, warm=20)
            times[f"plain {n}"], _ = self.time_kernel(
                lambda: hot_merge_plain(outs[:n], 5, carry, [word]), reps=reps // 10, warm=5)
        # Bytes the merge must move for one shard output and one word: the
        # output, the carry and the word read; the carry, the probe and the
        # word written.
        moved = 3 * 8 + 5 * 8 + 4 + 5 * 8 + 2 * 8 + 4
        self.h_stats.update(
            ms=times["merge 1"], plain_ms=times["plain 1"],
            bound_ms=moved / 3.35e12 * 1e3, empty_kernel_ms=times["empty"],
            ms_two_shards=times["merge 2"], plain_ms_two_shards=times["plain 2"],
            host_issue_ms=times["merge issue 1"],
            host_issue_ms_two_shards=times["merge issue 2"],
            empty_kernel_host_issue_ms=times["empty issue"],
            shape=f"one shard output, one threshold word; ms and empty_kernel_ms: device "
                  f"time per launch, {reps} launches in one CUDA Graph (CUDA events); "
                  f"host_issue_ms: {reps} launches issued back to back from Python")
        us = {k: v * 1e3 for k, v in times.items()}
        log(f"hot_merge on the device {us['merge 1']:.3f} us per launch (two shard outputs "
            f"{us['merge 2']:.3f} us), empty kernel {us['empty']:.3f} us (CUDA Graph of "
            f"{reps}); issued from Python: merge {us['merge issue 1']:.2f} us "
            f"({us['merge issue 2']:.2f} us), empty {us['empty issue']:.2f} us; plain version "
            f"{us['plain 1']:.1f} us ({us['plain 2']:.1f} us); bytes bound "
            f"{self.h_stats['bound_ms'] * 1e3:.5f} us [{self.card}]")

    def phase_numbers(self) -> None:
        from bitcoin_miner_tpu_torch.ops.sha256 import factor_low_pos
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import (
            bound_seconds, lane_ops, lanes_valid, minhash, sieved)
        from bitcoin_miner_tpu_torch.ops.sha256_minhash_factored import minhash_factored

        clock_mhz = float((smi("clocks.max.sm").split() or ["0"])[0] or 0)
        if not clock_mhz:
            raise AssertionError("nvidia-smi gave no clocks.max.sm for the bound")

        def bounds_of(ops, ntb):
            """(bound ms, lane ops) of a dispatch: one bound for the function,
            counting only work that depends on the inner digits; and the
            older count over all k low digits, for comparison."""
            lanes = lanes_valid(ops["bounds"], MAIN_K)
            inner = factor_low_pos(tuple(ops["low_pos"]), MAIN_K_IN).inner_pos
            return (bound_seconds(lanes, inner, ntb, clock_mhz * 1e6) * 1e3,
                    lane_ops(inner, ntb),
                    bound_seconds(lanes, ops["low_pos"], ntb, clock_mhz * 1e6) * 1e3,
                    lane_ops(ops["low_pos"], ntb))

        results = {}
        # The unfactored kernel on the three full dispatches: "cmu440" (1
        # tail block), the 50- and the 56-character message (2 blocks).
        for data in ("cmu440", TWO_BLOCK_DATA, FIB1_DATA):
            ntb, ops, ref, _f_plain_ms = self.full_disp[data]
            plain_ms = self.plain_ms[data]
            # The steady-state threshold: the dispatch's own min h0 (from the
            # plain version), which a sweep's running min reaches after its
            # first dispatch.  Every timed call's output is held to plain.
            runs = {}
            for label, th in (("sieve", ref[0]), ("sieve U32_MAX", U32_MAX), ("full", None)):
                ms, got = self.time_kernel(lambda: minhash(**ops, thresh=th))
                if got != list(sieved(ref, th)):
                    raise AssertionError(f"timed {label} dispatch {got} != plain {ref}")
                runs[label] = ms
            bound, ops_in, bound_all, ops_all = bounds_of(ops, ntb)
            results[data] = (runs, bound, plain_ms, ops_in, bound_all, ops_all)
            log(f"full dispatch B={MAIN_B} x 1e{MAIN_K} lanes, {data[:12]!r} n_tb={ntb}: sieve (steady "
                f"threshold) {runs['sieve']:.3f} ms, sieve (U32_MAX) "
                f"{runs['sieve U32_MAX']:.3f} ms, full fold {runs['full']:.3f} ms; plain "
                f"{plain_ms:.1f} ms; bound {bound:.3f} ms at {clock_mhz:.0f} MHz "
                f"(inner-digit lane ops logic, adds = {ops_in}; over all {MAIN_K} "
                f"digits {ops_all}: {bound_all:.3f} ms); "
                f"{lanes_valid(ops['bounds'], MAIN_K) / runs['sieve'] * 1e3:.3e} "
                f"nonces/s [{self.card}]")
        runs, bound, plain_ms, ops1, bound1_all, _ = results["cmu440"]
        runs2, bound2, plain_ms2, ops2, bound2_all, _ = results[TWO_BLOCK_DATA]
        runs3, bound3, plain_ms3, ops3, _bound3_all, _ = results[FIB1_DATA]
        self.k_stats.update(
            ms=runs["sieve"], ms_sieve_u32max=runs["sieve U32_MAX"],
            ms_full_fold=runs["full"], plain_ms=plain_ms, bound_ms=bound,
            bound_ms_all_k_digits=bound1_all,
            lane_ops=ops1, ms_two_blocks=runs2["sieve"], plain_ms_two_blocks=plain_ms2,
            bound_ms_two_blocks=bound2, bound_ms_two_blocks_all_k_digits=bound2_all,
            lane_ops_two_blocks=ops2, ms_56_chars=runs3["sieve"],
            ms_full_fold_56_chars=runs3["full"], plain_ms_56_chars=plain_ms3,
            bound_ms_56_chars=bound3, lane_ops_56_chars=ops3,
            shape=f"B={MAIN_B} x 1e{MAIN_K} lanes, d=10, n_tb=1, sieve, steady threshold",
            sm_clock_mhz=clock_mhz,
        )
        for data, lo, hi, rate in self.k_stats.get("rates", []):
            log(f"nonces/s per Request {data[:12]!r}[{lo}, {hi}]: {rate:,.0f} [{self.card}]")

        # Both kernels on the same full dispatches, in turns (unfactored,
        # factored, factored, unfactored), both forms.
        per_msg = {}
        for data, (ntb, ops, ref, plain_ms) in self.full_disp.items():
            fns = {"unfactored": lambda th: minhash(**ops, thresh=th),
                   "factored": lambda th: minhash_factored(**ops, k_in=MAIN_K_IN, thresh=th)}
            times = {}
            for form, th in (("sieve", ref[0]), ("full", None)):
                acc = {"unfactored": [], "factored": []}
                for name in ("unfactored", "factored", "factored", "unfactored"):
                    ms, got = self.time_kernel(lambda: fns[name](th), reps=5, warm=1)
                    if got != list(sieved(ref, th)):
                        raise AssertionError(f"timed {name} {form} dispatch {got} != plain {ref}")
                    acc[name].append(ms)
                for name, v in acc.items():
                    times[f"{name}_{form}_ms"] = v
            bound, ops_in, bound_all, ops_all = bounds_of(ops, ntb)
            per_msg[data] = dict(n_tb=ntb, bound_ms=bound, lane_ops=ops_in,
                                 bound_ms_all_k_digits=bound_all, lane_ops_all_k_digits=ops_all,
                                 factored_plain_ms=plain_ms, **times)
            log(f"full dispatch {data[:12]!r} n_tb={ntb}: " + ", ".join(
                f"{key} {v[0]:.3f}/{v[1]:.3f}" for key, v in times.items())
                + f"; bound {bound:.3f} ms (all-k count {bound_all:.3f} ms) [{self.card}]")
        fib1 = per_msg[FIB1_DATA]
        self.f_stats.update(
            ms=sum(fib1["factored_sieve_ms"]) / 2,
            plain_ms=fib1["factored_plain_ms"], bound_ms=fib1["bound_ms"],
            shape=f"B={MAIN_B} x 1e{MAIN_K} lanes (k_in={MAIN_K_IN}), d=10, "
                  f"{len(FIB1_DATA)}-char message, n_tb=2, sieve, steady threshold",
            per_message={d[:12]: v for d, v in per_msg.items()}, sm_clock_mhz=clock_mhz,
        )
        self.f_stats["request_pair"] = self.request_pair()
        self.blake2b_numbers(clock_mhz)
        self.native_numbers()

    def blake2b_numbers(self, clock_mhz: float) -> None:
        """The BLAKE2b kernel per full dispatch (MAIN_B rows x 10^MAIN_K
        lanes, the operands the plain version ran on), its bound, and
        nonces/s per 1e9 Request of both workload paths."""
        from bitcoin_miner_tpu_torch.ops.blake2b import bound_seconds, lane_ops
        from bitcoin_miner_tpu_torch.ops.blake2b_minhash import blake2b_minhash
        from bitcoin_miner_tpu_torch.ops.sha256_minhash import lanes_valid, sieved

        per = {}
        for data, (ops, counters, ref, plain_ms) in self.b_full.items():
            ntb = ops["tail"].shape[1] // 32
            # Every timed call's output is held to the plain fold.
            ms, got = self.time_kernel(lambda: blake2b_minhash(**ops, **counters), reps=5, warm=1)
            ms_sieve, got_s = self.time_kernel(
                lambda: blake2b_minhash(**ops, thresh=ref[0], **counters), reps=5, warm=1)
            if got != ref or got_s != list(sieved(ref, ref[0])):
                raise AssertionError(f"timed BLAKE2b dispatch {got}/{got_s} != plain {ref}")
            lanes = lanes_valid(ops["bounds"], MAIN_K)
            bound = bound_seconds(lanes, ops["low_pos"], ntb, clock_mhz * 1e6) * 1e3
            per[f"{len(data)}-byte"] = dict(
                n_tb=ntb, ms=ms, ms_sieve_steady=ms_sieve, bound_ms=bound,
                share_of_bound=bound / ms, lane_ops=lane_ops(ops["low_pos"], ntb),
                plain_ms=plain_ms)
            log(f"BLAKE2b full dispatch B={MAIN_B} x 1e{MAIN_K}, {len(data)}-byte data "
                f"n_tb={ntb}: full fold {ms:.3f} ms, sieve (steady threshold) {ms_sieve:.3f} "
                f"ms; bound {bound:.3f} ms ({100 * bound / ms:.1f}%) at {clock_mhz:.0f} MHz, "
                f"lane ops {lane_ops(ops['low_pos'], ntb)}; plain {plain_ms:.1f} ms; "
                f"{lanes / ms * 1e3:.3e} nonces/s [{self.card}]")
        one = per["6-byte"]
        self.b_stats.update(
            ms=one["ms"], plain_ms=one["plain_ms"], bound_ms=one["bound_ms"],
            shape=(f"B={MAIN_B} x 1e{MAIN_K} lanes, d=10, 6-byte data, n_tb=1, full fold "
                   f"(the rung's default)"),
            per_message=per, sm_clock_mhz=clock_mhz,
            request_rates={name: [r for _d, _lo, _hi, r in rates]
                           for name, rates in self.w_rates.items()},
        )
        for name, rates in self.w_rates.items():
            for data, lo, hi, rate in rates:
                log(f"nonces/s per Request, {name} {data[:12]!r}[{lo}, {hi}]: {rate:,.0f} "
                    f"[{self.card}]")

    def native_numbers(self) -> None:
        """The native host sweep's nonces/s, and the host fold of a first
        Request's d <= 5 classes with it and with hashlib; the d = 6 class
        folded natively against its one device dispatch."""
        from bitcoin_miner_tpu_torch import native
        from bitcoin_miner_tpu_torch.bitcoin.hash import min_hash_range
        from bitcoin_miner_tpu_torch.ops.sweep import decompose_range, sweep_min_hash

        t0 = time.perf_counter()
        native.min_hash_range_native("cmu440", 10**9, 10**9 + 2 * 10**7 - 1)
        rate = 2 * 10**7 / (time.perf_counter() - t0)
        classes = [(g.chunks[0].base + g.chunks[0].lo_off, g.chunks[-1].base + g.chunks[-1].hi_off - 1)
                   for g in decompose_range(0, 99_999, MAIN_K)]
        times, folds = {}, {}
        for name, fn in (("native", native.min_hash_range_native), ("hashlib", min_hash_range)):
            t0 = time.perf_counter()
            folds[name] = [fn("cmu440", lo, hi) for lo, hi in classes]
            times[name] = (time.perf_counter() - t0) * 1e3
        if folds["native"] != folds["hashlib"]:
            raise AssertionError("native and hashlib host folds disagree")
        t0 = time.perf_counter()
        nat6 = native.min_hash_range_native("cmu440", 10**5, 10**6 - 1)
        nat6_ms = (time.perf_counter() - t0) * 1e3
        sweep_min_hash("cmu440", 10**5, 10**5 + 9, device=self.dev)  # warm
        t0 = time.perf_counter()
        r = sweep_min_hash("cmu440", 10**5, 10**6 - 1, device=self.dev)
        dev6_ms = (time.perf_counter() - t0) * 1e3
        if (r.hash, r.nonce) != nat6:
            raise AssertionError("the d = 6 class: device and native folds disagree")
        self.native = dict(nonces_per_s=rate, shani=native.have_shani(),
                           host_fold_d_le_5_ms=times, d6_native_ms=nat6_ms, d6_device_ms=dev6_ms,
                           host_cores=os.cpu_count())
        log(f"native host sweep: {rate:,.0f} nonces/s on {os.cpu_count()} cores, SHA-NI "
            f"{native.have_shani()}; first Request's host fold of d <= 5 (1e5 nonces): "
            f"native {times['native']:.1f} ms, hashlib {times['hashlib']:.1f} ms; d = 6 class "
            f"(9e5 nonces): native {nat6_ms:.1f} ms, one device dispatch {dev6_ms:.1f} ms")

    def request_pair(self) -> dict:
        """nonces/s per 1e9-nonce Request on both rungs: the same Requests
        through an unfactored and a factored pipeline, in turns (U, F, F,
        U); each result held to hashlib and to the other rung's."""
        from bitcoin_miner_tpu_torch.bitcoin.hash import hash_nonce
        from bitcoin_miner_tpu_torch.ops.sweep import SweepPipeline

        pipes = {"unfactored": SweepPipeline(backend="cuda"),
                 "factored": SweepPipeline(backend="cuda", factored=True)}
        pair = {}
        try:
            for p in pipes.values():  # warm: stream, pinned buffers
                p.submit("cmu440", 2 * 10**9, 2 * 10**9 + 10**6 - 1).result(timeout=300)
            lo, hi = 10**9, 2 * 10**9 - 1
            for data in ("cmu440", TWO_BLOCK_DATA, FIB1_DATA):
                rates, found = {}, set()
                for name in ("unfactored", "factored", "factored", "unfactored"):
                    t0 = time.monotonic()
                    r = pipes[name].submit(data, lo, hi).result(timeout=300)
                    dt = time.monotonic() - t0
                    if r.hash != hash_nonce(data, r.nonce):
                        raise AssertionError(f"{name} {data!r}: bad result {r}")
                    found.add((r.hash, r.nonce))
                    rates.setdefault(name, []).append((hi - lo + 1) / dt)
                if len(found) != 1:
                    raise AssertionError(f"{data!r}: the rungs disagree: {found}")
                pair[data[:12]] = rates
                log(f"nonces/s per 1e9 Request {data[:12]!r}[{lo}, {hi}], U F F U: "
                    f"unfactored {rates['unfactored']}, factored {rates['factored']} "
                    f"[{self.card}]")
        finally:
            for p in pipes.values():
                p.close()
        return pair

    def run(self) -> int:
        phases = [
            ("environment", self.phase_env),
            ("build", self.phase_build),
            ("kernel vs plain", self.phase_compare),
            ("factored kernel vs plain", self.phase_factored_compare),
            ("blake2b kernel vs plain", self.phase_blake2b_compare),
            ("main path", self.phase_main_path),
            ("workload paths", self.phase_workload_paths),
            ("watchdog drill", self.phase_watchdog),
            ("factored path", self.phase_factored_path),
            ("mesh path", self.phase_mesh_path),
            ("multihost", self.phase_multihost),
            ("serving path", self.phase_serving),
            ("telemetry path", self.phase_telemetry),
            ("gateway path", self.phase_gateway),
            ("autoscale path", self.phase_autoscale),
            ("chaos path", self.phase_chaos),
            ("federation path", self.phase_federation),
            ("tools path", self.phase_tools),
            ("hot path", self.phase_hot_path),
            ("numbers", self.phase_numbers),
        ]
        for name, fn in phases:
            log(f"== phase: {name}")
            t0 = time.monotonic()
            try:
                fn()
            except Exception:
                traceback.print_exc()
                self.failures.append(name)
                log(f"== phase {name} FAILED")
                if name in ("environment", "build"):
                    break
            log(f"== phase {name}: {time.monotonic() - t0:.1f} s")
        if self.failures:
            log(f"FAILED phases: {self.failures}")
            return 1
        for run_name in ("throttled", "clean"):
            for name, row in self.tele[run_name]["miners"].items():
                log(f"telemetry path, {run_name} run, {name}: hist.device_dispatch_s mean "
                    f"{row['dispatch']['mean_s'] * 1e3:.2f} ms p50 "
                    f"{row['dispatch']['p50_s'] * 1e3:.1f} ms p95 "
                    f"{row['dispatch']['p95_s'] * 1e3:.1f} ms over {row['launches']} "
                    f"dispatches; the kernel's per full dispatch ('numbers') "
                    f"{self.k_stats['ms']:.2f} ms ('cmu440'), "
                    f"{self.k_stats['ms_56_chars']:.2f} ms (56 chars) [{self.card}]")
        for leg, rows in self.tele["pair"]["dispatch"].items():
            log(f"telemetry path, one miner alone ({leg} legs): hist.device_dispatch_s "
                f"{[(round(r['mean_s'] * 1e3, 2), round(r['p50_s'] * 1e3, 1), round(r['p95_s'] * 1e3, 1)) for r in rows]} "
                f"ms (mean, p50, p95) against {self.k_stats['ms']:.2f} ms of kernel; Request "
                f"{[round(1e3 * TELE_PAIR_SIZE / r, 2) for r in self.tele['pair']['nonces_per_s'][leg]]} "
                f"ms (mean per leg) [{self.card}]")
        s, f, b, h = self.k_stats, self.f_stats, self.b_stats, self.h_stats
        common = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms")
        line = {"kernels": [{
            "name": "sha256_minhash",
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES,
            **{key: s[key] for key in common},
            "bound_by": "operations",
            "library_ms": None,
            **{key: s[key] for key in (
                "shape", "ms_sieve_u32max", "ms_full_fold", "lane_ops",
                "bound_ms_all_k_digits", "ms_two_blocks", "plain_ms_two_blocks",
                "bound_ms_two_blocks", "bound_ms_two_blocks_all_k_digits",
                "lane_ops_two_blocks", "ms_56_chars", "ms_full_fold_56_chars",
                "plain_ms_56_chars", "bound_ms_56_chars", "lane_ops_56_chars",
                "launches_serving", "launches_gateway", "launches_autoscale",
                "launches_chaos", "launches_federation", "launches_tools", "sm_clock_mhz",
                "sass", "ptxas")},
        }, {
            "name": "sha256_minhash_factored",
            "route": "cuda",
            "source": F_SOURCE,
            "replaces": F_REPLACES,
            **{key: f[key] for key in common},
            "bound_by": "operations",
            "library_ms": None,
            **{key: f[key] for key in (
                "shape", "per_message", "request_pair", "sm_clock_mhz", "sass", "ptxas")},
        }, {
            "name": "blake2b_minhash",
            "route": "cuda",
            "source": B_SOURCE,
            "replaces": B_REPLACES,
            **{key: b[key] for key in common},
            "bound_by": "operations",
            "library_ms": None,
            **{key: b[key] for key in (
                "shape", "per_message", "request_rates", "launches_serving",
                "sm_clock_mhz", "sass", "ptxas")},
        }, {
            "name": "hot_merge",
            "route": "cuda",
            "source": H_SOURCE,
            "replaces": H_REPLACES,
            **{key: h[key] for key in common},
            "bound_by": "bytes",
            "library_ms": None,
            **{key: h[key] for key in (
                "shape", "empty_kernel_ms", "ms_two_shards", "plain_ms_two_shards",
                "host_issue_ms", "host_issue_ms_two_shards", "empty_kernel_host_issue_ms",
                "sass", "ptxas")},
        }], "launches_preimage_path": s["launches_preimage"], "native": self.native,
            "mesh_path": self.mesh, "multihost_ranks": self.multihost,
            "serving_path": self.serving, "telemetry_path": self.tele,
            "gateway_path": self.gate, "autoscale_path": self.autoscale,
            "chaos_path": self.chaos, "federation_path": self.fed, "tools_path": self.tools,
            "hot_path": self.hot}
        print(json.dumps(line), flush=True)
        print(self.card, flush=True)
        torch = self.torch
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import bitcoin_miner_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script: {e}",
              file=sys.stderr)
        return 2
    return Smoke(torch).run()


if __name__ == "__main__":
    sys.exit(main())
