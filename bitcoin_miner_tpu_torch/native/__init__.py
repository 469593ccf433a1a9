"""Native (C++) host tier: the compiled SHA-256 min-hash sweep.

Counterpart of ``bitcoin_miner_tpu/native``: ``sha256_sweep.cc`` (a copy of
that package's source: midstate-folded prefix, incrementally carried digit
buffer, SHA-NI compression where the CPU has it, all cores) compiled at
first use with the system ``g++`` into ``build/libsha256_sweep.so`` beside
the port's CUDA libraries (the directory is listed in ``.gitignore``) and
loaded with ctypes.  It computes the frozen ``sha256d`` message format
only (``"<data> <nonce>"``).

It is the ``cpu`` rung of the ``sha256d`` ladder and the host fold of the
sweep's tiny digit classes (``ops/sweep.py::_host_min``).  Where ``g++`` is
missing or refuses the source, :func:`available` is False and one line on
stderr says why; callers then use the hashlib oracle.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Tuple

from ..ops._build import BUILD_DIR

_SRC = Path(__file__).with_name("sha256_sweep.cc")
_OUT = BUILD_DIR / "libsha256_sweep.so"
_lock = threading.Lock()
_state: dict = {"lib": None, "error": None}


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the native sweep's source."""


def build() -> Path:
    """Compile the source into ``build/libsha256_sweep.so`` unless a library
    newer than the source is there; returns its path.  Raises
    :class:`NativeBuildError`.  One portable build: the SHA-NI compression
    is gated per function in the source (target attribute plus a runtime
    CPU check), so no translation-unit-wide ISA flags."""
    if _OUT.exists() and _OUT.stat().st_mtime >= _SRC.stat().st_mtime:
        return _OUT
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _OUT.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [gxx, "-O3", "-shared", "-fPIC", "-pthread", "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"g++ did not run: {e!r}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed on {_SRC.name} (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, _OUT)  # atomic: two processes building at once race benignly
    return _OUT


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, p64 = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
    lib.sha256_sweep_min_mt.argtypes = [ctypes.c_char_p, u64, u64, u64, ctypes.c_uint32, p64, p64]
    lib.sha256_sweep_min_mt.restype = None
    lib.sha256_have_shani.argtypes = []
    lib.sha256_have_shani.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The built and bound library; raises :class:`NativeBuildError` (every
    call after a failure raises the same error without building again)."""
    with _lock:
        if _state["lib"] is None:
            if _state["error"] is not None:
                raise _state["error"]
            try:
                _state["lib"] = _bind(ctypes.CDLL(str(build())))
            except (NativeBuildError, OSError) as e:
                err = e if isinstance(e, NativeBuildError) else NativeBuildError(repr(e))
                _state["error"] = err
                print(f"native sweep unavailable, using hashlib: {err}".splitlines()[0],
                      file=sys.stderr)
                raise err
        return _state["lib"]


def available() -> bool:
    """Whether the native sweep built and loaded (building it at first
    call)."""
    try:
        load()
    except NativeBuildError:
        return False
    return True


def have_shani() -> bool:
    """Whether this CPU runs the SHA-NI compression paths; False also when
    the native tier is unavailable."""
    return available() and bool(load().sha256_have_shani())


def min_hash_range_native(
    msg: str, lower: int, upper: int, threads: int = 0
) -> Tuple[int, int]:
    """Compiled scan of inclusive ``[lower, upper]``: ``(min hash, nonce)``,
    bit-exact with the hashlib oracle, lowest nonce on a tie.  ``threads``:
    0 = every hardware core (contiguous sub-ranges, min-reduced), 1 = the
    single-threaded loop.  Raises :class:`NativeBuildError` when the
    native tier is unavailable."""
    if lower > upper:
        raise ValueError(f"empty nonce range [{lower}, {upper}]")
    if lower < 0 or upper >= 1 << 64:
        raise ValueError(f"nonce range out of uint64: [{lower}, {upper}]")
    if lower == 0 and upper == (1 << 64) - 1:
        # 2^64 nonces wrap the u64 span arithmetic; no such sweep returns.
        raise ValueError("full 2^64-nonce range not supported; split it")
    if threads < 0:
        raise ValueError(f"threads must be >= 0, got {threads}")
    lib = load()
    h = ctypes.c_uint64()
    n = ctypes.c_uint64()
    data = msg.encode("utf-8")
    lib.sha256_sweep_min_mt(data, len(data), lower, upper, threads,
                            ctypes.byref(h), ctypes.byref(n))
    return h.value, n.value


def host_min_fn(default):
    """:func:`min_hash_range_native` when the native tier is available,
    else ``default`` (the hashlib oracle)."""
    return min_hash_range_native if available() else default


__all__ = [
    "NativeBuildError",
    "available",
    "build",
    "have_shani",
    "host_min_fn",
    "load",
    "min_hash_range_native",
]
