"""Replay a chaos-soak scenario from the command line.

The port's counterpart of the repository's ``tools/chaos_replay.py``.  A
failing chaos test prints its ``(scenario, seed)`` pair; this tool re-runs
that exact drill (the port's ``apps.drill.run_drill``: same seeded fault
decisions, same fleet shape) outside pytest, so a failure can be bisected
with extra logging or under a debugger:

    python -m bitcoin_miner_tpu_torch.tools.chaos_replay --scenario burst-loss --seed 1234
    python -m bitcoin_miner_tpu_torch.tools.chaos_replay --list
    python -m bitcoin_miner_tpu_torch.tools.chaos_replay --scenario miner-partition \\
        --seed 7 --miners 3 --kill-at 0.5 --max-nonce 8000 -v
    python -m bitcoin_miner_tpu_torch.tools.chaos_replay --fed-drill death-detect \\
        --max-nonce 9999999999 --oracle card

Prints one JSON report line (the drill's oracle verdict + chaos/self-
healing counter totals) and exits non-zero on an oracle mismatch, so it
slots into shell bisection loops.

Deliberate differences from the reference tool: the drill's miners run
on ``--backend`` (default ``auto``: the cuda rung on a card; ``cpu`` the
native host tier), and with no card and no ``--backend cpu`` the tool
exits 2 naming the missing card.  ``--oracle card`` takes the expected
Result from the port's ``sweep_min_hash`` on the card (hashlib cannot
check ranges of 1e9 nonces and more); a scenario drill's job is swept
before the drill, a federation drill's as the drill asks for it (its
miners idle then).  ``--max-nonce`` sets a federation drill's ``hi`` too;
left out there, each drill keeps its own default size.  The report
stamps the oracle, the rung and the drill's kernel launches
(``launches``), the oracle's own launches counted apart.
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import lspnet
from ..apps.drill import run_drill
from ..federation.drill import DRILLS, run_fed_drill
from ..utils.trace import TRACE
from . import ORACLES, Oracle, miner_launches, resolve_tier, run_stamp

#: The scenario drill's job size when ``--max-nonce`` is left out.
DEFAULT_MAX_NONCE = 4000


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bitcoin_miner_tpu_torch.tools.chaos_replay",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument("--scenario", default="burst-loss",
                        help="named schedule from lspnet.standard_scenarios")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--data", default="chaos")
    parser.add_argument("--max-nonce", type=int, default=None,
                        help=f"the job's upper nonce (default "
                             f"{DEFAULT_MAX_NONCE}; a federation drill's "
                             f"own default when left out)")
    parser.add_argument("--miners", type=int, default=2)
    parser.add_argument("--kill-at", type=float, default=None,
                        help="kill miner-0's conn this many seconds in")
    parser.add_argument("--epoch-millis", type=int, default=100)
    parser.add_argument("--timeout", type=float, default=120.0)
    parser.add_argument("--fed-drill", metavar="NAME", default=None,
                        help="replay a federation resilience drill instead "
                             "of a chaos-soak scenario: shed-storm, "
                             "drain-handoff, death-detect, ack-retransmit — "
                             "same seeded decisions as the failing "
                             "fleet_bench --federation leg")
    parser.add_argument("--list", action="store_true",
                        help="list scenario names and exit")
    parser.add_argument("--trace", metavar="FILE", default=None,
                        help="write the drill's structured event log here "
                             "(JSONL; analyze with python -m tools.trace)")
    parser.add_argument("--backend", default="auto",
                        help="the drill's miners' rung: auto (the cuda rung "
                             "on a card, the default), cuda, or cpu (the "
                             "native host tier)")
    parser.add_argument("--oracle", choices=ORACLES, default="hashlib",
                        help="the expected Result: hashlib (the default) or "
                             "card (the port's sweep_min_hash on the card)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="enable lspnet debug drop logging")
    args = parser.parse_args(argv)

    if args.list:
        for name, sched in lspnet.standard_scenarios().items():
            print(f"{name:24s} {sched.desc}")
        for name in DRILLS:
            print(f"{name:24s} federation resilience drill (--fed-drill)")
        return 0
    try:
        args.tier = resolve_tier(args.backend)
        oracle = Oracle(args.oracle)
    except ValueError as e:
        print(f"chaos_replay: {e}", file=sys.stderr)
        return 2
    if args.verbose:
        lspnet.enable_debug_logs(True)
    if args.fed_drill:
        kw = {} if args.max_nonce is None else {"hi": args.max_nonce}
        if args.trace:
            TRACE.enable(path=args.trace)
        launches = miner_launches(oracle)
        try:
            report = run_fed_drill(args.fed_drill, seed=args.seed,
                                   backend=args.backend, oracle=oracle, **kw)
        except ValueError as e:
            print(f"chaos_replay: {e}", file=sys.stderr)
            return 2
        finally:
            if args.trace:
                TRACE.disable()
        report.update(launches=launches(), **run_stamp(args, oracle))
        print(json.dumps(report))
        return 0 if report.get("ok") else 1
    max_nonce = DEFAULT_MAX_NONCE if args.max_nonce is None else args.max_nonce
    if oracle.kind == "card":
        oracle(args.data, 0, max_nonce)  # swept before the drill's miners start
    launches = miner_launches(oracle)
    try:
        report = run_drill(
            args.scenario,
            seed=args.seed,
            data=args.data,
            max_nonce=max_nonce,
            n_miners=args.miners,
            kill_miner_at=args.kill_at,
            epoch_millis=args.epoch_millis,
            timeout=args.timeout,
            trace_path=args.trace,
            backend=args.backend,
            oracle=oracle,
        )
    except ValueError as e:  # e.g. a typoed --scenario name
        print(f"chaos_replay: {e}", file=sys.stderr)
        return 2
    print(json.dumps(dict(report.as_dict(), launches=launches(), **run_stamp(args, oracle))))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
