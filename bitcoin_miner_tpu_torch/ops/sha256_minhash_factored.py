"""The factored min-hash kernel of the sweep: CUDA wrapper + plain version.

Counterpart of ``bitcoin_miner_tpu/ops/pallas_sha256.py``'s
``_build_factored_call`` (bound by ``make_pallas_minhash_factored``, both
sieve forms) and of the xla body ``make_kernel_body(factored=k_in)`` in
``bitcoin_miner_tpu/ops/sweep.py``.  The kernel is
``csrc/sha256_minhash_factored.cu``; its source note gives its bound and
design.

It computes the same function as :func:`.sha256_minhash.minhash`, on the
same operands (see that module), split differently: a row's ``10^k`` lanes
are ``10^k_out`` outer groups of ``10^k_in`` inner lanes.  The outer digits
are the same for every lane of a group, so the round prefix up to the
first inner-digit word is computed once per (row, group) and resumed per
lane.  Result: the (3,) int64 ``(h0, h1, flat_idx)``, ``flat_idx = row *
10^k + group * 10^k_in + lane`` (that is, ``row * 10^k + offset``), lowest
index on a tie; with a threshold, that min only when its ``h0 <= thresh``;
otherwise, or when no lane is valid, ``(U32_MAX, U32_MAX, I32_MAX)``.
``th_word`` may stand for ``thresh`` as it does there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import _build
from .sha256 import DigitPos, compress, factor_low_pos, outer_patch_table
from .sha256_minhash import (
    I32_MAX,
    PLAIN_LANES,
    U32_MAX,
    _check_operands,
    _launch_args,
    _pairs,
    lower_word,
    plain_threshold,
    sieved,
)

_SOURCE = "sha256_minhash_factored"


def _split(low_pos: Sequence, k_in: int):
    """The :class:`FactorSplit` of ``low_pos`` (DigitPos or pairs)."""
    return factor_low_pos(tuple(DigitPos(w, s) for w, s in _pairs(low_pos)), k_in)


def _check_factored(midstate, tail, bounds, low_pos, k_in) -> Tuple[int, int, int]:
    """:func:`_check_operands` plus ``1 <= k_in < k``."""
    batch, n_tb, k = _check_operands(midstate, tail, bounds, low_pos)
    if not 1 <= k_in < k:
        raise ValueError(f"k_in ({k_in}) must be in [1, {k - 1}] for k = {k}")
    return batch, n_tb, k


def _lanes(x):
    """Give a (rows, groups) value a trailing lane axis."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def minhash_factored_plain(
    midstate: torch.Tensor,
    tail: torch.Tensor,
    bounds: torch.Tensor,
    low_pos: Sequence,
    k_in: int,
    thresh: Optional[int] = None,
    th_word: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The factored kernel's function in plain PyTorch, on the operands'
    device, computed through the real split.

    For a block of rows and outer groups: the outer digits are ORed into
    each row's template from :func:`outer_patch_table` as (rows, groups)
    values; the blocks before the first inner-digit word and that block's
    leading rounds run once at that shape (``compress(stop_round=)``); the
    inner digits then make (rows, groups, 10^k_in) lanes, which resume
    from the carried state (``group_state=``).  The min over valid lanes
    uses the remapped flat index; then the threshold is applied."""
    _batch, n_tb, k = _check_factored(midstate, tail, bounds, low_pos, k_in)
    thresh = plain_threshold(thresh, th_word, midstate.device)
    split = _split(low_pos, k_in)
    owords, otab_np = outer_patch_table(split.outer_pos)
    fib, prefix_rounds = divmod(split.first_inner_word, 16)
    dev = midstate.device
    n_lanes, s_in, g_count = 10**k, 10**k_in, 10**split.k_out
    otab = torch.from_numpy(otab_np.astype("int64")).to(dev)
    mid = [int(v) for v in midstate.to(torch.int64).tolist()]
    tail64 = tail.to(torch.int64)
    b64 = bounds.to(torch.int64).clamp(0, n_lanes)
    lane = torch.arange(s_in, device=dev)
    inner = {}  # word -> (s_in,) OR mask of the inner digits
    for j, dp in enumerate(split.inner_pos):
        dig = ((lane // 10 ** (k_in - 1 - j)) % 10 + 48) << dp.shift
        inner[dp.word] = inner[dp.word] | dig if dp.word in inner else dig
    # Rows with no valid lane, and groups the rows' bounds do not reach, are
    # skipped; blocks of rows x groups keep the lane tensors near
    # PLAIN_LANES elements.
    rows_all = torch.nonzero(b64[:, 1] > b64[:, 0]).flatten()
    g_step = max(1, min(g_count, PLAIN_LANES // s_in))
    r_step = max(1, PLAIN_LANES // (g_step * s_in))
    best = (U32_MAX, U32_MAX, I32_MAX)
    for r0 in range(0, len(rows_all), r_step):
        rows = rows_all[r0 : r0 + r_step]
        lo = b64[rows, 0].view(-1, 1, 1)
        hi = b64[rows, 1].view(-1, 1, 1)
        g_lo = int(lo.min()) // s_in
        g_hi = (int(hi.max()) + s_in - 1) // s_in
        for g0 in range(g_lo, g_hi, g_step):
            og = torch.arange(g0, min(g0 + g_step, g_hi), device=dev)
            # Group-constant words: (rows, 1) template columns, (rows,
            # groups) where the outer digits land.
            words = [tail64[rows, i].unsqueeze(1) for i in range(16 * n_tb)]
            for m, wd in enumerate(owords):
                words[wd] = words[wd] | otab[og, m]
            blocks = [words[b * 16 : (b + 1) * 16] for b in range(n_tb)]
            state = mid
            for b in range(fib):
                state = compress(state, blocks[b])
            p, carried = compress(state, blocks[fib], stop_round=prefix_rounds)
            # Per lane: the inner digits, then the resumed rounds.
            state = tuple(_lanes(x) for x in state)
            gs = (p, tuple(_lanes(x) for x in carried))
            lane_words = [_lanes(w) | inner[i] if i in inner else _lanes(w)
                          for i, w in enumerate(words)]
            st = state
            for b in range(fib, n_tb):
                last = b == n_tb - 1
                blk = lane_words[b * 16 : (b + 1) * 16]
                st = compress(st, blk, final_only=last,
                              group_state=gs if b == fib else None)
            h0, h1 = st
            off = og.view(1, -1, 1) * s_in + lane
            valid = (off >= lo) & (off < hi)
            # Invalid lanes get h0 = 2^32, above every hash.
            h0 = torch.where(valid, h0, U32_MAX + 1)
            m0 = int(h0.min())
            if m0 > U32_MAX:
                continue
            sel = h0 == m0
            h1 = torch.broadcast_to(h1, sel.shape)
            m1 = int(h1[sel].min())
            idx = torch.broadcast_to(rows.view(-1, 1, 1) * n_lanes + off, sel.shape)
            mi = int(idx[sel & (h1 == m1)].min())
            best = min(best, (m0, m1, mi))
    return torch.tensor(lower_word(th_word, sieved(best, thresh)), dtype=torch.int64,
                        device=dev)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bmt_sha256_minhash_factored.argtypes = [
        p, p, p, i, i, i, i, p, p, i, p, p, p, p]
    lib.bmt_sha256_minhash_factored.restype = i
    lib.bmt_sha256_minhash_factored_partials.argtypes = [i, i, i]
    lib.bmt_sha256_minhash_factored_partials.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The built and bound kernel library (a failed build is not cached)."""
    return _bind(_build.load(_SOURCE))


def minhash_factored(
    midstate: torch.Tensor,
    tail: torch.Tensor,
    bounds: torch.Tensor,
    low_pos: Sequence,
    k_in: int,
    thresh: Optional[int] = None,
    th_word: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The min-hash of one dispatch through the factored kernel (see the
    module docstring).

    CPU tensors take :func:`minhash_factored_plain`.  CUDA tensors launch
    the kernel on the current stream (building it at first use) and
    return without synchronising; anything the kernel does not take
    raises."""
    if midstate.device.type == "cpu":
        return minhash_factored_plain(midstate, tail, bounds, low_pos, k_in, thresh, th_word)
    if midstate.device.type != "cuda":
        raise ValueError(f"no factored min-hash kernel for device {midstate.device}")
    batch, n_tb, k = _check_factored(midstate, tail, bounds, low_pos, k_in)
    words, shifts, th_word = _launch_args(midstate, tail, bounds, low_pos, thresh, th_word)
    lib = _lib()
    dev = midstate.device
    # The C entry point launches on the calling thread's current device:
    # make it the operands' device (a thread's current device is cuda:0
    # unless set, so a launch on another card would fail).
    with torch.cuda.device(dev):
        partials = torch.empty(
            2 * lib.bmt_sha256_minhash_factored_partials(batch, k, k_in),
            dtype=torch.int64, device=dev,
        )
        out = torch.empty(3, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bmt_sha256_minhash_factored(
            midstate.data_ptr(), tail.data_ptr(), bounds.data_ptr(), batch, n_tb, k,
            k_in, words, shifts, int(th_word is not None),
            None if th_word is None else th_word.data_ptr(),
            partials.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{_SOURCE} launch failed with code {rc}")
    minhash_factored.launches += 1
    return out


minhash_factored.launches = 0  # type: ignore[attr-defined]
