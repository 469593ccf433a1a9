"""Build the port's CUDA source at first use and load it with ctypes.

``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` into
``build/lib<name>.so`` beside the package (the directory is listed in
``.gitignore``): no PyTorch headers, so a build takes seconds.  Each source
builds under its own lock, because the sweep pipeline's dispatcher thread
and a direct caller can reach a kernel at once; two sources build in
parallel.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_locks_guard = threading.Lock()
_locks: "dict[str, threading.Lock]" = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels build only on a machine with the CUDA toolkit"
    )


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>.so`` unless a
    library newer than every file in ``csrc/`` is there.  ``verbose``
    always compiles, with ``-Xptxas -v``, prints nvcc's output (registers,
    shared memory and spills per kernel) and writes it beside the library
    as ``lib<name>.log``.  Returns the library path."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    out = BUILD_DIR / f"lib{name}.so"
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        newest = max(p.stat().st_mtime for p in CSRC_DIR.iterdir())
        if out.exists() and out.stat().st_mtime >= newest and not verbose:
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [
            nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-I", str(CSRC_DIR), "-o", str(tmp), str(src),
        ]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if verbose or proc.returncode != 0:
            text = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            print(text, flush=True)
            if verbose:
                out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, out)
        return out


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed.  Callers
    keep the loaded handle."""
    return ctypes.CDLL(str(build(name)))
