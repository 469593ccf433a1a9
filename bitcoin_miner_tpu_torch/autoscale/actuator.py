"""Fleet actuators for the autoscale controller.

The controller (:mod:`.controller`) is pure policy; everything that
touches the world lives here, one class per actuation axis:

- :class:`ProcessActuator` (axis a) owns miner WORKER SUBPROCESSES —
  the port's own miner, ``python -m bitcoin_miner_tpu_torch.apps.miner``
  (the cuda rung on the card at the default ``backend="auto"``) — and
  retires them by CLEAN DRAIN: SIGTERM, which the miner binary catches to
  finish its in-flight chunks, deliver their Results, and exit 0, so a
  resumed job sweeps strictly fewer nonces than after a SIGKILL.  A
  worker whose kernel fails to build or launch fails; it never sweeps
  with the plain version instead.
- :class:`GatewayWeightActuator` (axis c) applies/clears the gateway's
  tenant WFQ weight overrides under the serve event lock.
- :class:`CellActuator` (axis b) signals a federation replica's early
  membership handoff (the DRAINING broadcast + successor handoff path).
  The federation binary (``apps/federation.py --autoscale``) wires it.

:class:`ControllerPump` is the wall-clock driver: a daemon thread
ticking the controller every ``interval`` seconds — the ONLY place the
autoscale plane owns a thread, kept out of the controller so the policy
stays externally-serialized and deterministic under test.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional


class ProcessActuator:
    """Spawn/retire miner worker subprocesses against one serving port.

    Single-threaded use by its driver (the controller's pump or the
    bench thread) — like every policy-side object, the caller
    serializes.  ``drain(n)`` SIGTERMs the NEWEST n live workers (LIFO:
    the floor workers the fleet started with are the last to go);
    ``exit_codes()`` is the bench's honesty surface — a clean drain is
    exit 0, a SIGKILL shows up as -9.
    """

    def __init__(
        self,
        port: int,
        *,
        host: str = "127.0.0.1",
        backend: str = "auto",
        telemetry: Optional[str] = None,
        source_prefix: str = "as-worker",
        log_dir: Optional[str] = None,
        extra_env: Optional[Mapping[str, str]] = None,
        log: Optional[logging.Logger] = None,
    ) -> None:
        self._port = port
        self._host = host
        self._backend = backend
        self._telemetry = telemetry
        self._source_prefix = source_prefix
        self._log_dir = log_dir
        self._extra_env = dict(extra_env or {})
        self._log = log or logging.getLogger("bitcoin_miner_tpu_torch.autoscale")
        self._spawned = 0
        self._procs: List[subprocess.Popen] = []  # live, spawn order
        self._retired: List[subprocess.Popen] = []  # draining or exited

    # ---------------------------------------------------------------- state

    def live(self) -> int:
        self._procs = [p for p in self._procs if p.poll() is None]
        return len(self._procs)

    def exit_codes(self) -> List[Optional[int]]:
        """Poll()ed exit codes of every worker ever retired or died —
        the clean-drain evidence (0 = drained, -SIGKILL = killed)."""
        dead = [p for p in self._procs if p.poll() is not None]
        self._procs = [p for p in self._procs if p.poll() is None]
        self._retired.extend(dead)
        return [p.poll() for p in self._retired]

    # -------------------------------------------------------------- actions

    def spawn(self, n: int = 1) -> int:
        for _ in range(max(0, n)):
            idx = self._spawned
            self._spawned += 1
            argv = [
                sys.executable, "-m", "bitcoin_miner_tpu_torch.apps.miner",
                f"{self._host}:{self._port}", "--backend", self._backend,
            ]
            if self._telemetry:
                argv += [
                    "--telemetry", self._telemetry,
                    "--telemetry-interval", "1.0",
                    "--source", f"{self._source_prefix}-{idx}",
                ]
            stderr: Any = subprocess.DEVNULL
            if self._log_dir:
                stderr = open(
                    os.path.join(self._log_dir, f"worker.{idx}.log"), "ab",
                    buffering=0,
                )
            proc = subprocess.Popen(
                argv,
                env={**os.environ, **self._extra_env},
                stdout=subprocess.DEVNULL,
                stderr=stderr,
            )
            self._procs.append(proc)
            self._log.info("autoscale spawned worker %d (pid %d)",
                           idx, proc.pid)
        return self.live()

    def drain(self, n: int = 1) -> int:
        """Clean-retire the newest n live workers: SIGTERM now; the
        miner finishes its in-flight chunks and exits on its own (the
        harvest is asynchronous — ``live()`` drops as they finish)."""
        self._procs = [p for p in self._procs if p.poll() is None]
        for _ in range(max(0, n)):
            if not self._procs:
                break
            proc = self._procs.pop()
            self._retired.append(proc)
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass  # already gone: its exit code still counts
            self._log.info("autoscale draining worker pid %d", proc.pid)
        return len(self._procs)

    def stop_all(self, timeout: float = 10.0) -> None:
        """Teardown (bench/CLI exit): drain everything, then escalate to
        SIGKILL past the deadline."""
        self.drain(len(self._procs))
        deadline = time.monotonic() + timeout
        for proc in self._retired:
            left = max(0.1, deadline - time.monotonic())
            try:
                proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass


class GatewayWeightActuator:
    """Axis c: apply/clear the gateway's tenant WFQ weight overrides
    under the serve event lock (the same lock every other gateway access
    holds — see apps/server._EventPlane)."""

    def __init__(self, gateway: Any, lock: Any) -> None:
        self._gw = gateway
        self._lock = lock

    def reweight(self, weights: Mapping[str, float]) -> None:
        with self._lock:
            self._gw.set_tenant_weights(dict(weights))

    def restore(self) -> None:
        with self._lock:
            self._gw.clear_tenant_weights()


class CellActuator:
    """Axis b: hand a federation cell off early.  ``drain()`` broadcasts
    DRAINING through membership, stashes live-job progress, and ships
    spans + orphans to the successor (federation/replica);
    idempotent, so a repeated signal is harmless.  ``on_drained`` (the
    federation binary's exit latch) fires after a successful drain."""

    def __init__(
        self,
        replica: Any,
        reason: str = "autoscale",
        on_drained: Optional[Callable[[], None]] = None,
    ) -> None:
        self._replica = replica
        self._reason = reason
        self._on_drained = on_drained

    def drain_cell(self) -> None:
        self._replica.drain(reason=self._reason)
        if self._on_drained is not None:
            self._on_drained()


class ControllerPump:
    """The controller's wall-clock driver: one daemon thread, one
    ``tick()`` per ``interval``.  Failure-isolated like the serve
    ticker — a raising evidence provider or actuator logs and retries
    next beat, it never kills the loop."""

    def __init__(
        self,
        controller: Any,
        interval: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        log: Optional[logging.Logger] = None,
    ) -> None:
        self._controller = controller
        self._interval = interval
        self._clock = clock
        self._log = log or logging.getLogger("bitcoin_miner_tpu_torch.autoscale")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ControllerPump":
        self._thread = threading.Thread(
            target=self._loop, name="autoscale-pump", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self._controller.tick(self._clock())
            except Exception:
                self._log.exception("autoscale tick failed; will retry")
