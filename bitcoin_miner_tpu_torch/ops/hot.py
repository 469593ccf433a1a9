"""The hot plane's merge: CUDA wrapper + plain PyTorch version.

Counterpart of the device step of ``bitcoin_miner_tpu/ops/sweep.py::
make_hot_step`` (its ``_merge``, jitted with the carry donated) and of the
mesh cascade that feeds it there (``bitcoin_miner_tpu/parallel/sweep.py::
_collective_min``).  The kernel is ``csrc/hot_merge.cu``; its source note
gives the function, its bound and its design.

Operands (all on one device):

- ``outs`` — the N (3,) int64 outputs ``(h0, h1, flat_idx)`` of one
  dispatch's min-hash launches, in shard order (N = 1 on one device);
- ``seq`` — the dispatch's sequence number, in ``[0, I32_MAX]``;
- ``carry`` — the job's (5,) int64 ``(best_h0, best_h1, best_seq,
  best_dev, best_flat)``, updated in place; :func:`new_carry` makes it
  vacant (``best_flat == I32_MAX``);
- ``th_words`` — the sieve's (1,) int32 threshold words on this device
  (uint32 bits, the min-hash kernels' ``th_word``), each lowered in place
  to the carried h0; none without the sieve.

Result: a new (2,) int64 probe ``(best_h0, best_seq)``, the only part of
the carry the host reads before the job's end.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build

U32_MAX = 0xFFFFFFFF
I32_MAX = 0x7FFFFFFF
#: A vacant carry: no candidate yet.
VACANT = (U32_MAX, U32_MAX, -1, 0, I32_MAX)
MAX_SHARDS = 16  # csrc/hot_merge.cu kMaxShards (and kMaxWords)

_SOURCE = "hot_merge"


def new_carry(device) -> torch.Tensor:
    return torch.tensor(VACANT, dtype=torch.int64, device=device)


def _check(outs: Sequence[torch.Tensor], seq: int, carry: torch.Tensor,
           th_words: Sequence[torch.Tensor]) -> None:
    if carry.shape != (5,) or carry.dtype != torch.int64 or not carry.is_contiguous():
        raise ValueError(f"carry must be (5,) int64, got {tuple(carry.shape)} {carry.dtype}")
    if not 1 <= len(outs) <= MAX_SHARDS or len(th_words) > MAX_SHARDS:
        raise ValueError(f"{len(outs)} outputs and {len(th_words)} threshold words: "
                         f"1 to {MAX_SHARDS} outputs, at most {MAX_SHARDS} words")
    if not 0 <= seq <= I32_MAX:
        raise ValueError(f"dispatch seq {seq} is outside int32")
    for o in outs:
        if o.shape != (3,) or o.dtype != torch.int64 or not o.is_contiguous():
            raise ValueError(f"outputs must be (3,) int64, got {tuple(o.shape)} {o.dtype}")
    for w in th_words:
        if w.shape != (1,) or w.dtype != torch.int32 or not w.is_contiguous():
            raise ValueError(f"threshold words must be (1,) int32, got {tuple(w.shape)} {w.dtype}")
    for t in (*outs, *th_words):
        if t.device != carry.device:
            raise ValueError(f"operands on {carry.device} and {t.device}")


def hot_merge_plain(outs: Sequence[torch.Tensor], seq: int, carry: torch.Tensor,
                    th_words: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """The kernel's function as torch operations on the operands' device:
    the reference's cascade (its three mins, in its order), then its
    ``_merge``.  Nothing is read back to the host."""
    _check(outs, seq, carry, th_words)
    h0, h1, flat = torch.stack(list(outs)).unbind(1)
    dev = torch.arange(len(outs), device=carry.device)
    g_h0 = h0.min()
    h1m = torch.where(h0 == g_h0, h1, U32_MAX)
    g_h1 = h1m.min()
    mine = (h0 == g_h0) & (h1m == g_h1) & (flat != I32_MAX)
    g_dev = torch.where(mine, dev, I32_MAX).min()
    g_flat = torch.where(mine & (dev == g_dev), flat, I32_MAX).min()
    bh0, bh1, _bseq, _bdev, bflat = carry.unbind()
    better = (g_flat != I32_MAX) & (
        (bflat == I32_MAX) | (g_h0 < bh0) | ((g_h0 == bh0) & (g_h1 < bh1)))
    new = torch.stack([g_h0, g_h1, torch.full_like(g_h0, seq), g_dev, g_flat])
    carry.copy_(torch.where(better, new, carry))
    for w in th_words:
        low = torch.minimum(w.to(torch.int64) & U32_MAX, carry[0])
        w.copy_(torch.where(low > I32_MAX, low - (1 << 32), low).to(torch.int32))
    return carry[[0, 2]]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bmt_hot_merge.argtypes = [p, i, ctypes.c_longlong, p, p, p, i, p]
    lib.bmt_hot_merge.restype = i
    lib.bmt_empty_kernel.argtypes = [p]
    lib.bmt_empty_kernel.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The built and bound kernel library (a failed build is not cached)."""
    return _bind(_build.load(_SOURCE))


def hot_merge(outs: Sequence[torch.Tensor], seq: int, carry: torch.Tensor,
              th_words: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Merge one dispatch into the carry (see the module docstring).

    CPU tensors take :func:`hot_merge_plain`.  CUDA tensors launch the
    kernel on the current stream (building it at first use) and return
    without synchronising; anything the kernel does not take, and a build
    or launch failure, raises."""
    if carry.device.type == "cpu":
        return hot_merge_plain(outs, seq, carry, th_words)
    if carry.device.type != "cuda":
        raise ValueError(f"no hot merge kernel for device {carry.device}")
    _check(outs, seq, carry, th_words)
    lib = _lib()
    ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    words = (ctypes.c_void_p * max(len(th_words), 1))(*(w.data_ptr() for w in th_words))
    dev = carry.device
    # The C entry point launches on the calling thread's current device.
    with torch.cuda.device(dev):
        probe = torch.empty(2, dtype=torch.int64, device=dev)
        rc = lib.bmt_hot_merge(ptrs, len(outs), seq, carry.data_ptr(), probe.data_ptr(),
                               words, len(th_words), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_SOURCE} launch failed with code {rc}")
    hot_merge.launches += 1
    return probe


hot_merge.launches = 0  # type: ignore[attr-defined]


def empty_launch(device) -> None:
    """Launch the empty kernel of ``csrc/hot_merge.cu`` on ``device``'s
    current stream: :func:`hot_merge`'s bound, for measuring scripts."""
    with torch.cuda.device(device):
        rc = _lib().bmt_empty_kernel(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_SOURCE} empty launch failed with code {rc}")
