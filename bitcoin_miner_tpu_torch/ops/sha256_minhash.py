"""The min-hash kernel of the sweep: CUDA wrapper + plain PyTorch version.

Counterpart of ``bitcoin_miner_tpu/ops/pallas_sha256.py`` (the Pallas
``_build_call`` in its full-fold and sieve forms, bound statically by
``make_pallas_minhash`` and dynamically by ``make_pallas_minhash_dyn``).
The kernel is ``csrc/sha256_minhash.cu``; its source note gives its bound
and design.

Operands (the port's, all on one device):

- ``midstate`` (8,) uint32 — the host-folded constant prefix;
- ``tail`` (B, 16 * n_tail_blocks) uint32 — per-row word templates with
  the high digits folded in;
- ``bounds`` (B, 2) int32 — lane range ``[lo, hi)`` of each row, ``(0, 0)``
  for padding rows;
- ``low_pos`` — the k low digits' ``(word, shift)`` positions, most
  significant first (``DigitPos`` or pairs); ``k = len(low_pos)``;
- ``thresh`` — None for the full fold, else the sieve's plain uint32
  threshold;
- ``th_word`` — in place of ``thresh``, the sieve's threshold as a (1,)
  int32 tensor on the operands' device (uint32 bits), read by the launch
  and lowered in place to the output's h0, never refilled from the host
  (the hot plane's carried threshold).  Passing both raises.

Result: a (3,) int64 tensor ``(h0, h1, flat_idx)`` — the lexicographic min
over valid lanes, ``flat_idx = row * 10^k + lane``, lowest index on a tie;
with a threshold, that min only when its ``h0 <= thresh``; otherwise, or
when no lane is valid, ``(U32_MAX, U32_MAX, I32_MAX)``.  The JAX kernel's
sign-flipped int32 domain is a Mosaic workaround and is not carried over:
values are plain.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .sha256 import compress

U32_MAX = 0xFFFFFFFF
I32_MAX = 0x7FFFFFFF
#: Lanes per chunk of the plain version: bounds its int64 working set
#: (about 2 GB on a card) while keeping launches per lane few.
PLAIN_LANES = 1 << 22

_SOURCE = "sha256_minhash"


def _pairs(low_pos) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(p.word), int(p.shift)) if hasattr(p, "word") else
                 (int(p[0]), int(p[1])) for p in low_pos)


def _check_operands(midstate, tail, bounds, low_pos) -> Tuple[int, int, int]:
    """Validate shapes and dtypes; returns ``(batch, n_tail_blocks, k)``."""
    if midstate.shape != (8,) or midstate.dtype != torch.uint32:
        raise ValueError(f"midstate must be (8,) uint32, got {tuple(midstate.shape)} {midstate.dtype}")
    if tail.dim() != 2 or tail.dtype != torch.uint32:
        raise ValueError(f"tail must be (B, 16*n_tb) uint32, got {tuple(tail.shape)} {tail.dtype}")
    batch, n_words = tail.shape
    if n_words not in (16, 32):
        raise ValueError(f"tail rows must hold 16 or 32 words, got {n_words}")
    if bounds.shape != (batch, 2) or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be ({batch}, 2) int32, got {tuple(bounds.shape)} {bounds.dtype}")
    k = len(low_pos)
    if not 1 <= k <= 9:
        raise ValueError(f"k ({k}) must be in [1, 9]")
    if batch * 10**k > I32_MAX:
        # The flat argmin index row * 10^k + lane must fit int32.
        raise ValueError(
            f"batch ({batch}) * 10^k ({10**k}) lanes overflow the int32 "
            "argmin index; lower batch or max_k"
        )
    for t in (tail, bounds):
        if t.device != midstate.device:
            raise ValueError(f"operands on {midstate.device} and {t.device}")
    return batch, n_words // 16, k


def minhash_plain(
    midstate: torch.Tensor,
    tail: torch.Tensor,
    bounds: torch.Tensor,
    low_pos: Sequence,
    thresh: Optional[int] = None,
    th_word: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on the operands' device.

    Straightforward: enumerate the valid (row, lane) pairs in chunks,
    assemble each message, run the torch compression over int64 lanes, and
    take the lexicographic min; then apply the threshold.  Invalid lanes
    never win over a valid one (their index would be I32_MAX), so only
    valid lanes are hashed."""
    _batch, n_tb, k = _check_operands(midstate, tail, bounds, low_pos)
    thresh = plain_threshold(thresh, th_word, midstate.device)
    pos = _pairs(low_pos)
    dev = midstate.device
    n_lanes = 10**k
    mid = [int(v) for v in midstate.to(torch.int64).tolist()]
    tail64 = tail.to(torch.int64)
    b64 = bounds.to(torch.int64)
    lo = b64[:, 0].clamp(0, n_lanes)
    hi = b64[:, 1].clamp(0, n_lanes)
    counts = (hi - lo).clamp(min=0)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    total = int(ends[-1]) if len(ends) else 0
    best = (U32_MAX, U32_MAX, I32_MAX)
    for s in range(0, total, PLAIN_LANES):
        # Valid lane number g lies in the row whose [start, end) holds it.
        g = torch.arange(s, min(s + PLAIN_LANES, total), device=dev)
        rows = torch.searchsorted(ends, g, right=True)
        lanes = g - starts[rows] + lo[rows]
        words = list(tail64[rows].unbind(1))
        for j, (word, shift) in enumerate(pos):
            digit = (lanes // 10 ** (k - 1 - j)) % 10 + 48
            words[word] = words[word] | (digit << shift)
        state = mid
        for blk in range(n_tb):
            last = blk == n_tb - 1
            state = compress(state, words[blk * 16 : (blk + 1) * 16],
                             final_only=last)
        h0, h1 = state
        idx = rows * n_lanes + lanes
        m0 = int(h0.min())
        sel = h0 == m0
        m1 = int(h1[sel].min())
        mi = int(idx[sel & (h1 == m1)].min())
        best = min(best, (m0, m1, mi))
    return torch.tensor(lower_word(th_word, sieved(best, thresh)), dtype=torch.int64,
                        device=dev)


def sieved(best: Sequence[int], thresh: Optional[int]) -> Tuple[int, int, int]:
    """The sieve form's output for the full fold ``best``: ``best`` when
    there is no threshold or its h0 is ``<= thresh`` (ties survive), else
    ``(U32_MAX, U32_MAX, I32_MAX)``."""
    if thresh is not None and best[0] > thresh:
        return (U32_MAX, U32_MAX, I32_MAX)
    return tuple(int(v) for v in best)


def check_th_word(thresh: Optional[int], th_word: Optional[torch.Tensor],
                  device: torch.device) -> None:
    """Raise unless ``th_word`` is None or a contiguous (1,) int32 tensor
    on ``device``, passed without ``thresh``."""
    if th_word is None:
        return
    if thresh is not None:
        raise ValueError("pass the sieve threshold as thresh or as th_word, not both")
    if (th_word.shape != (1,) or th_word.dtype != torch.int32
            or th_word.device != device or not th_word.is_contiguous()):
        raise ValueError(f"th_word must be a contiguous (1,) int32 tensor on {device}, got "
                         f"{tuple(th_word.shape)} {th_word.dtype} on {th_word.device}")


def plain_threshold(thresh: Optional[int], th_word: Optional[torch.Tensor],
                    device: torch.device) -> Optional[int]:
    """The threshold a plain version sieves with: ``thresh``, or the value
    of the device word ``th_word`` (checked by :func:`check_th_word`)."""
    check_th_word(thresh, th_word, device)
    return thresh if th_word is None else int(th_word[0]) & U32_MAX


def lower_word(th_word: Optional[torch.Tensor], out: Sequence[int]) -> Tuple[int, int, int]:
    """Lower ``th_word`` in place to the h0 of the output ``out``, as the
    kernels lower it (nothing for the sentinel or without a word); returns
    ``out``."""
    out = tuple(int(v) for v in out)
    if th_word is not None and out[2] != I32_MAX and out[0] < int(th_word[0]) & U32_MAX:
        th_word.fill_(out[0] - (1 << 32) if out[0] > I32_MAX else out[0])
    return out


def resume_point(low_pos: Sequence, n_tail_blocks: int) -> Tuple[int, int]:
    """``(first_block, round)``: the tail block that holds the first word a
    low digit touches, and the rounds of that block before it.  Every round
    before that point reads only words that are the same for every lane of
    a chunk row, so the kernel runs them once per CUDA block and each lane
    resumes there."""
    words = [w for w, _ in _pairs(low_pos)]
    if not 0 <= min(words) <= max(words) < 16 * n_tail_blocks:
        raise ValueError(f"low digit words {words} are not all in {n_tail_blocks} tail blocks")
    return divmod(min(words), 16)


def _launch_args(midstate, tail, bounds, low_pos, thresh, th_word=None):
    """What a kernel launch takes beyond the checked operands: raises on
    non-contiguous operands, a threshold outside uint32 or a bad
    ``th_word``, and returns the digit (word, shift) ctypes arrays and the
    sieve's device word: ``th_word`` itself, one filled from ``thresh``,
    or None for the full fold."""
    for t in (midstate, tail, bounds):
        if not t.is_contiguous():
            raise ValueError("min-hash operands must be contiguous")
    if thresh is not None and not 0 <= thresh <= U32_MAX:
        raise ValueError(f"threshold {thresh} is not a uint32")
    check_th_word(thresh, th_word, midstate.device)
    pos = _pairs(low_pos)
    words = (ctypes.c_int * len(pos))(*(w for w, _ in pos))
    shifts = (ctypes.c_int * len(pos))(*(s for _, s in pos))
    if thresh is not None:
        # The sieve's device word, int32 bits of the uint32 threshold.
        th_word = torch.full(
            (1,), thresh - (1 << 32) if thresh > I32_MAX else thresh,
            dtype=torch.int32, device=midstate.device,
        )
    return words, shifts, th_word


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bmt_sha256_minhash.argtypes = [p, p, p, i, i, i, p, p, i, i, i, p, p, p, p]
    lib.bmt_sha256_minhash.restype = i
    lib.bmt_sha256_minhash_partials.argtypes = [i, i]
    lib.bmt_sha256_minhash_partials.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The built and bound kernel library (a failed build is not cached)."""
    return _bind(_build.load(_SOURCE))


def minhash(
    midstate: torch.Tensor,
    tail: torch.Tensor,
    bounds: torch.Tensor,
    low_pos: Sequence,
    thresh: Optional[int] = None,
    th_word: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The min-hash of one dispatch (see the module docstring).

    CPU tensors take :func:`minhash_plain`.  CUDA tensors launch the
    kernel on the current stream (building it at first use) and return
    without synchronising; anything the kernel does not take raises."""
    if midstate.device.type == "cpu":
        return minhash_plain(midstate, tail, bounds, low_pos, thresh, th_word)
    if midstate.device.type != "cuda":
        raise ValueError(f"no min-hash kernel for device {midstate.device}")
    batch, n_tb, k = _check_operands(midstate, tail, bounds, low_pos)
    words, shifts, th_word = _launch_args(midstate, tail, bounds, low_pos, thresh, th_word)
    lib = _lib()
    dev = midstate.device
    # The C entry point launches on the calling thread's current device:
    # make it the operands' device (a thread's current device is cuda:0
    # unless set, so a launch on another card would fail).
    with torch.cuda.device(dev):
        partials = torch.empty(
            2 * lib.bmt_sha256_minhash_partials(batch, k), dtype=torch.int64, device=dev
        )
        out = torch.empty(3, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bmt_sha256_minhash(
            midstate.data_ptr(), tail.data_ptr(), bounds.data_ptr(), batch, n_tb, k,
            words, shifts, *resume_point(low_pos, n_tb), int(th_word is not None),
            None if th_word is None else th_word.data_ptr(),
            partials.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{_SOURCE} launch failed with code {rc}")
    minhash.launches += 1
    return out


minhash.launches = 0  # type: ignore[attr-defined]


def operands_from_reference(
    midstate: np.ndarray,
    tailc_bounds: np.ndarray,
    thresh_flipped_i32: Optional[np.ndarray],
    low_pos: Sequence,
    *,
    n_tail_blocks: int,
    device="cpu",
):
    """The port's operands for the JAX Pallas kernel's numpy ones.

    ``tailc_bounds`` is the JAX kernel's chunk table, ``(B, nw + 2)`` or its
    flattening, each row ``[words..., lo_off, hi_off]``;
    ``thresh_flipped_i32`` its sieve operand (``(1,)`` int32, sign-flipped)
    or None; ``low_pos`` the k low digits' positions (the window form of
    the dynamic JAX kernel takes the same positions).  Returns the keyword
    arguments of :func:`minhash` / :func:`minhash_plain`."""
    nw = 16 * n_tail_blocks
    table = np.asarray(tailc_bounds, dtype=np.uint32).reshape(-1, nw + 2)
    thresh = None
    if thresh_flipped_i32 is not None:
        flipped = np.asarray(thresh_flipped_i32).astype(np.int32).view(np.uint32)
        thresh = int(flipped.reshape(-1)[0]) ^ 0x80000000
    return dict(
        midstate=torch.from_numpy(
            np.ascontiguousarray(midstate, dtype=np.uint32)).to(device),
        tail=torch.from_numpy(np.ascontiguousarray(table[:, :nw])).to(device),
        bounds=torch.from_numpy(
            np.ascontiguousarray(table[:, nw:].astype(np.int32))).to(device),
        low_pos=_pairs(low_pos),
        thresh=thresh,
    )


def lanes_valid(bounds: torch.Tensor, k: int) -> int:
    """Valid lanes of one dispatch (the work its bound is counted on)."""
    b = bounds.to(torch.int64).clamp(0, 10**k)
    return int((b[:, 1] - b[:, 0]).clamp(min=0).sum())


def _add_ops(terms: Sequence[bool]) -> int:
    """3-input adds a sum needs for its lane-dependent part: the constant
    terms fold into one, and ``n`` terms take ``n // 2`` adds."""
    if not any(terms):
        return 0
    return (sum(terms) + (not all(terms))) // 2


def lane_ops(low_pos: Sequence, n_tail_blocks: int) -> Tuple[int, int]:
    """``(logic, adds)``: the 32-bit integer instructions one lane needs,
    counting only those whose result depends on the lane's low digits.

    Derived from the rounds by following which values depend on the lane:
    message words other than the digit words are the same for every lane of
    a row (rounds before the first digit word, and every schedule word of a
    block without digits, are per-row or per-dispatch constants).  Per
    dependent value: a Σ or σ costs 3 shifts (funnel or plain) and 1 LOP3;
    ch and maj 1 LOP3 each; a sum 3-input adds (:func:`_add_ops`).  The last
    block feeds forward only (h0, h1) and its last round's e is dead.
    ``logic`` (shifts, LOP3) issues only on the integer ALU pipe; adds may
    also issue on the FMA pipe (IMAD).  Digit generation and the fold are
    not counted, so the bound stays a lower bound."""
    digit_words = {w for w, _ in _pairs(low_pos)}
    logic = adds = 0
    st = [False] * 8  # the midstate is a per-dispatch constant
    for blk in range(n_tail_blocks):
        last = blk == n_tail_blocks - 1
        w = [blk * 16 + i in digit_words for i in range(16)]
        a, b, c, d, e, f, g, h = st
        for t in range(64):
            if t >= 16:
                w16, w15, w7, w2 = (w[(t - j) & 15] for j in (16, 15, 7, 2))
                logic += 4 * w15 + 4 * w2  # σ0, σ1
                adds += _add_ops([w16, w15, w7, w2])
                w[t & 15] = w16 or w15 or w7 or w2
            wt = w[t & 15]
            ch = e or f or g
            maj = a or b or c
            logic += 4 * e + ch + 4 * a + maj  # Σ1, ch, Σ0, maj
            t1 = [h, e, ch, False, wt]  # h + Σ1(e) + ch + K[t] + W[t]
            adds += _add_ops(t1)
            t1v = any(t1)
            new_a = t1v or a or maj
            adds += _add_ops([t1v, a, maj])  # t1 + Σ0(a) + maj
            if not (last and t == 63):
                adds += _add_ops([d, t1v])
            a, b, c, d, e, f, g, h = new_a, a, b, c, d or t1v, e, f, g
        out = [a, b, c, d, e, f, g, h]
        n_out = 2 if last else 8
        adds += sum(_add_ops([s, o]) for s, o in zip(st[:n_out], out[:n_out]))
        st = [s or o for s, o in zip(st, out)]
    return logic, adds


def bound_seconds(lanes: int, low_pos: Sequence, n_tail_blocks: int,
                  sm_clock_hz: float, n_sms: int = 132) -> float:
    """Least time for ``lanes`` lanes of this digit layout at the card's
    integer issue rates: the logic instructions at the ALU pipe's 64 lanes
    per SM per clock, or all of them at the SM's issue rate of 128 (ALU and
    FMA pipes together), whichever is longer."""
    logic, adds = lane_ops(low_pos, n_tail_blocks)
    per_clk = n_sms * sm_clock_hz
    return lanes * max(logic / (64 * per_clk), (logic + adds) / (128 * per_clk))
