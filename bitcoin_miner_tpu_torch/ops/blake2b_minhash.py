"""The BLAKE2b-64 min-hash kernel of the sweep: CUDA wrapper.

Counterpart of ``bitcoin_miner_tpu/ops/blake2b.py::make_blake2b_kernel_body``
(the reference's jitted device program for the ``blake2b64`` workload).
The kernel is ``csrc/blake2b_minhash.cu``; its source note gives its bound
and design.  Its plain PyTorch version is ``ops/blake2b.py::
blake2b_minhash_plain``, which CPU tensors take.

Operands (the port's, all on one device):

- ``midstate`` (16,) uint32 — the host-folded chaining state, each u64 word
  as a (hi, lo) pair;
- ``tail`` (B, 32 * n_tail_blocks) uint32 — per-row (hi, lo) word-pair
  templates with the high digits folded in;
- ``bounds`` (B, 2) int32 — lane range ``[lo, hi)`` of each row, ``(0, 0)``
  for padding rows;
- ``low_pos`` — the k low digits' ``(word, shift)`` positions, most
  significant first; ``k = len(low_pos)``;
- ``thresh`` — None for the full fold, else the sieve's uint32 threshold;
- ``th_word`` — in place of ``thresh``, the sieve's (1,) int32 device word,
  used and lowered in place (as in ops/sha256_minhash.py);
- ``msg_len`` / ``tail_off`` — the message length and the bytes folded into
  the midstate, which give the blocks' byte counters.

Result: a (3,) int64 tensor ``(h0, h1, flat_idx)``, as the SHA-256 kernels'
(ops/sha256_minhash.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import _build
from .blake2b import _check_operands, blake2b_minhash_plain, block_counters
from .sha256_minhash import _launch_args

_SOURCE = "blake2b_minhash"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.bmt_blake2b_minhash.argtypes = [p, p, p, i, i, i, p, p, u64, u64, i, p, p, p, p]
    lib.bmt_blake2b_minhash.restype = i
    lib.bmt_blake2b_minhash_partials.argtypes = [i, i]
    lib.bmt_blake2b_minhash_partials.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The built and bound kernel library (a failed build is not cached)."""
    return _bind(_build.load(_SOURCE))


def blake2b_minhash(
    midstate: torch.Tensor,
    tail: torch.Tensor,
    bounds: torch.Tensor,
    low_pos: Sequence,
    thresh: Optional[int] = None,
    *,
    msg_len: int,
    tail_off: int,
    th_word: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The BLAKE2b min-hash of one dispatch (see the module docstring).

    CPU tensors take :func:`ops.blake2b.blake2b_minhash_plain`.  CUDA
    tensors launch the kernel on the current stream (building it at first
    use) and return without synchronising; anything the kernel does not
    take raises."""
    k = len(low_pos)
    if midstate.device.type == "cpu":
        return blake2b_minhash_plain(midstate, tail, bounds, thresh, low_pos=low_pos,
                                     k=k, msg_len=msg_len, tail_off=tail_off,
                                     th_word=th_word)
    if midstate.device.type != "cuda":
        raise ValueError(f"no BLAKE2b min-hash kernel for device {midstate.device}")
    batch, n_tb = _check_operands(midstate, tail, bounds, low_pos, k)
    counters = block_counters(msg_len, tail_off, n_tb)
    words, shifts, th_word = _launch_args(midstate, tail, bounds, low_pos, thresh, th_word)
    lib = _lib()
    dev = midstate.device
    # The C entry point launches on the calling thread's current device:
    # make it the operands' device (a thread's current device is cuda:0
    # unless set, so a launch on another card would fail).
    with torch.cuda.device(dev):
        partials = torch.empty(
            2 * lib.bmt_blake2b_minhash_partials(batch, k), dtype=torch.int64, device=dev
        )
        out = torch.empty(3, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bmt_blake2b_minhash(
            midstate.data_ptr(), tail.data_ptr(), bounds.data_ptr(), batch, n_tb, k,
            words, shifts, counters[0] if n_tb == 2 else 0, counters[-1],
            int(th_word is not None), None if th_word is None else th_word.data_ptr(),
            partials.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{_SOURCE} launch failed with code {rc}")
    blake2b_minhash.launches += 1
    return out


blake2b_minhash.launches = 0  # type: ignore[attr-defined]
