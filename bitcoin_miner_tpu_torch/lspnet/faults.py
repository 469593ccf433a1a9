"""Global fault-injection knobs for the instrumented UDP layer.

The port's copy of the JAX package's ``lspnet/faults.py``: the same knobs,
the same clamping and the same seeded draw, so one seed gives the same
``sometimes`` sequence in both packages.

Parity: reference ``lspnet/staff.go:18-75`` — atomic global percentages for
client/server × read/write drops plus Data-payload shorten/lengthen
mutation, and ``lspnet/net.go:16-22``'s connection-origin registry that lets
the knobs distinguish client-side from server-side endpoints.  Tests drive
these to fake lossy networks over real loopback sockets (SURVEY §4).

The reference's validation typo (``if 0 <= 0 && p <= 100`` accepting
negatives, staff.go:31,38) is fixed here: percentages are clamped to
[0, 100].
"""

from __future__ import annotations

import os
import random
import threading


def env_chaos_seed():
    """LSPNET_CHAOS_SEED as an int, or None if unset/unparseable — a typo
    in an env knob must never crash every binary at import time."""
    env = os.environ.get("LSPNET_CHAOS_SEED")
    if not env:
        return None
    try:
        return int(env)
    except ValueError:
        import sys

        print(
            f"lspnet: ignoring non-integer LSPNET_CHAOS_SEED={env!r}",
            file=sys.stderr,
        )
        return None


class _Faults:
    """Process-global knob set.  All accesses are GIL-atomic reads of ints;
    a lock guards compound updates only."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.client_read_drop = 0
        self.server_read_drop = 0
        self.client_write_drop = 0
        self.server_write_drop = 0
        self.msg_shorten = 0
        self.msg_lengthen = 0
        self.debug = False
        # Deterministic by default when LSPNET_CHAOS_SEED is set: any chaos
        # failure is then replayable from the seed alone (the seed() knob
        # below re-seeds at runtime).
        seed = env_chaos_seed()
        self._rng = random.Random() if seed is None else random.Random(seed)

    # -- setters (lspnet/staff.go:18-75 surface) ----------------------------

    @staticmethod
    def _clamp(p: int) -> int:
        return max(0, min(100, int(p)))

    def set_read_drop_percent(self, p: int) -> None:
        with self._lock:
            self.client_read_drop = self.server_read_drop = self._clamp(p)

    def set_write_drop_percent(self, p: int) -> None:
        with self._lock:
            self.client_write_drop = self.server_write_drop = self._clamp(p)

    def set_client_read_drop_percent(self, p: int) -> None:
        self.client_read_drop = self._clamp(p)

    def set_server_read_drop_percent(self, p: int) -> None:
        self.server_read_drop = self._clamp(p)

    def set_client_write_drop_percent(self, p: int) -> None:
        self.client_write_drop = self._clamp(p)

    def set_server_write_drop_percent(self, p: int) -> None:
        self.server_write_drop = self._clamp(p)

    def set_msg_shortening_percent(self, p: int) -> None:
        self.msg_shorten = self._clamp(p)

    def set_msg_lengthening_percent(self, p: int) -> None:
        self.msg_lengthen = self._clamp(p)

    def reset(self) -> None:
        """Zero every knob — tests call this in teardown for isolation
        (mirrors lspnet.ResetDropPercent + the mutation knobs)."""
        with self._lock:
            self.client_read_drop = 0
            self.server_read_drop = 0
            self.client_write_drop = 0
            self.server_write_drop = 0
            self.msg_shorten = 0
            self.msg_lengthen = 0

    def enable_debug_logs(self, enable: bool) -> None:
        self.debug = bool(enable)

    def seed(self, s: int) -> None:
        """Deterministic fault sequences for reproducible tests."""
        self._rng.seed(s)

    # -- queries used by the conn layer -------------------------------------

    def sometimes(self, percent: int) -> bool:
        """True with the given probability (lspnet/conn.go:169-178)."""
        if percent <= 0:
            return False
        if percent >= 100:
            return True
        return self._rng.randrange(100) < percent

    def read_drop_percent(self, is_server: bool) -> int:
        return self.server_read_drop if is_server else self.client_read_drop

    def write_drop_percent(self, is_server: bool) -> int:
        return self.server_write_drop if is_server else self.client_write_drop


FAULTS = _Faults()

# Module-level convenience API mirroring the reference's package functions.
set_read_drop_percent = FAULTS.set_read_drop_percent
set_write_drop_percent = FAULTS.set_write_drop_percent
set_client_read_drop_percent = FAULTS.set_client_read_drop_percent
set_server_read_drop_percent = FAULTS.set_server_read_drop_percent
set_client_write_drop_percent = FAULTS.set_client_write_drop_percent
set_server_write_drop_percent = FAULTS.set_server_write_drop_percent
set_msg_shortening_percent = FAULTS.set_msg_shortening_percent
set_msg_lengthening_percent = FAULTS.set_msg_lengthening_percent
reset_faults = FAULTS.reset
enable_debug_logs = FAULTS.enable_debug_logs
