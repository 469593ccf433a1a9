"""BLAKE2b-64 family of the port: host layout, plain PyTorch version, bound.

Counterpart of ``bitcoin_miner_tpu/ops/blake2b.py``.  The ``blake2b64``
workload hashes ``"<data> <nonce>"`` with BLAKE2b at an 8-byte digest and
reads it big-endian.  The sweep's message-template decomposition carries
over from the SHA-256 family:

- **Midstate folding.**  BLAKE2b chains 128-byte blocks, so every whole
  block of the constant ``data + sep`` prefix is compressed once per job on
  the host (:func:`compress_py`) into 16 u32 — each u64 chaining word as a
  (hi, lo) pair.
- **Tail template.**  The rest of the message, at most two 128-byte blocks,
  as little-endian u64 words split into (hi, lo) u32 pairs: index ``2q`` is
  the high half of u64 word ``q`` and ``2q + 1`` the low half.  A digit at
  byte offset ``o`` of word ``q`` lands in word ``2q + 1`` at shift ``8 o``
  for ``o < 4``, else in ``2q`` at ``8 (o - 4)``.  BLAKE2b zero-pads its
  last block (no padding bits); the counter ``t`` counts message bytes.

The plain version (:func:`blake2b_minhash_plain`) computes the min-hash of
one dispatch — the triple ``(min_h0, min_h1, flat_idx)`` of the reference's
``make_blake2b_kernel_body`` — in int64 tensors that hold u32 halves masked
to 32 bits (CPU torch has no uint32 arithmetic): a u64 add is two masked
u32 adds with the carry taken from bit 32, a rotation two shifted halves.
The CUDA kernel is ``csrc/blake2b_minhash.cu`` (``ops/blake2b_minhash.py``);
:func:`lane_ops` / :func:`bound_seconds` give its bound.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .sha256 import DigitPos
from .sha256_minhash import (
    I32_MAX,
    PLAIN_LANES,
    U32_MAX,
    _pairs,
    lower_word,
    plain_threshold,
    sieved,
)

_MASK64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF

#: BLAKE2b IV (RFC 7693 §2.6): the SHA-512 IV.
IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

#: Message schedule (RFC 7693 §2.7); rounds 10/11 repeat rows 0/1.
SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)

#: The column/diagonal (a, b, c, d) state indices of one round's 8 G's.
GIDX = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)

#: Parameter-block word 0 for digest_size=8, no key, fanout=1, depth=1,
#: XORed into h[0] (the digest size keys the hash).
_PARAM0 = 0x01010008


# --------------------------------------------------------------------------
# Host-side reference (python ints): midstate folding and an oracle
# --------------------------------------------------------------------------


def _rotr64_py(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & _MASK64


def compress_py(h: Tuple[int, ...], block: bytes, t: int, final: bool) -> Tuple[int, ...]:
    """One BLAKE2b compression of a 128-byte block on python ints; ``t``
    counts the message bytes through this block."""
    m = [int.from_bytes(block[8 * i : 8 * i + 8], "little") for i in range(16)]
    v = list(h) + list(IV)
    v[12] ^= t & _MASK64
    v[13] ^= (t >> 64) & _MASK64
    if final:
        v[14] ^= _MASK64
    for r in range(12):
        s = SIGMA[r]
        for gi, (a, b, c, d) in enumerate(GIDX):
            x, y = m[s[2 * gi]], m[s[2 * gi + 1]]
            v[a] = (v[a] + v[b] + x) & _MASK64
            v[d] = _rotr64_py(v[d] ^ v[a], 32)
            v[c] = (v[c] + v[d]) & _MASK64
            v[b] = _rotr64_py(v[b] ^ v[c], 24)
            v[a] = (v[a] + v[b] + y) & _MASK64
            v[d] = _rotr64_py(v[d] ^ v[a], 16)
            v[c] = (v[c] + v[d]) & _MASK64
            v[b] = _rotr64_py(v[b] ^ v[c], 63)
    return tuple(h[i] ^ v[i] ^ v[8 + i] for i in range(8))


def init_h() -> Tuple[int, ...]:
    """The BLAKE2b-64 initial chaining state: the IV with the parameter
    block's word 0 folded into h[0]."""
    return (IV[0] ^ _PARAM0,) + IV[1:]


def digest64_py(msg: bytes) -> int:
    """Pure-python BLAKE2b-64 of ``msg`` read big-endian (independent of
    hashlib)."""
    h = init_h()
    n_blocks = max(1, (len(msg) + 127) // 128)
    for b in range(n_blocks):
        chunk = msg[128 * b : 128 * (b + 1)]
        final = b == n_blocks - 1
        t = len(msg) if final else 128 * (b + 1)
        h = compress_py(h, chunk.ljust(128, b"\x00"), t, final)
    return int.from_bytes(h[0].to_bytes(8, "little"), "big")


# --------------------------------------------------------------------------
# Message layout (host): midstate + tail template + digit positions
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Blake2bLayout:
    """Per-(data, separator, digit count) layout of the BLAKE2b family, with
    the field contract of :class:`ops.sha256.MsgLayout` so the sweep's
    template fill is family-generic:

    - ``midstate``: 16 u32, (hi, lo) per u64 chaining word, after the
      ``tail_off`` bytes of whole prefix blocks;
    - ``tail_template``: ``32 * n_tail_blocks`` u32, the remaining message
      bytes as (hi, lo) pairs of little-endian u64 words, digits zero;
    - ``digit_pos``: (word, shift) of each ASCII nonce digit, most
      significant first;
    - ``live_words``: the template words that are nonzero for some lane
      (template content or a digit position).
    """

    family = "blake2b"

    data_len: int
    digit_count: int
    msg_len: int
    tail_off: int
    midstate: Tuple[int, ...]
    tail_template: Tuple[int, ...]
    digit_pos: Tuple[DigitPos, ...]
    live_words: Tuple[int, ...]

    @property
    def n_tail_blocks(self) -> int:
        return len(self.tail_template) // 32


def build_layout(data: bytes, digit_count: int, sep: bytes = b" ") -> Blake2bLayout:
    """The :class:`Blake2bLayout` of ``data + sep + <digit_count digits>``:
    whole prefix blocks fold into the midstate; the rest is laid out as
    zero-padded (hi, lo) word-pair templates."""
    if not 1 <= digit_count <= 20:
        raise ValueError(f"digit_count {digit_count} outside u64's 1..20")
    prefix = data + sep
    c_len = len(prefix)
    msg_len = c_len + digit_count
    n_const = c_len // 128
    tail_off = 128 * n_const
    n_tail_blocks = (msg_len - tail_off + 127) // 128
    tail = bytearray(128 * n_tail_blocks)
    tail[: c_len - tail_off] = prefix[tail_off:]

    digit_pos = []
    for j in range(digit_count):
        q, o = divmod(c_len - tail_off + j, 8)
        digit_pos.append(
            DigitPos(word=2 * q + 1, shift=8 * o) if o < 4
            else DigitPos(word=2 * q, shift=8 * (o - 4))
        )

    tmpl = []
    for q in range(16 * n_tail_blocks):
        w = int.from_bytes(tail[8 * q : 8 * q + 8], "little")
        tmpl.append((w >> 32) & U32_MAX)
        tmpl.append(w & U32_MAX)

    h = init_h()
    for b in range(n_const):
        h = compress_py(h, prefix[128 * b : 128 * (b + 1)], 128 * (b + 1), False)
    midstate = []
    for hv in h:
        midstate.append((hv >> 32) & U32_MAX)
        midstate.append(hv & U32_MAX)

    dwords = {dp.word for dp in digit_pos}
    live = tuple(w for w in range(32 * n_tail_blocks) if tmpl[w] or w in dwords)
    return Blake2bLayout(
        data_len=len(data),
        digit_count=digit_count,
        msg_len=msg_len,
        tail_off=tail_off,
        midstate=tuple(midstate),
        tail_template=tuple(tmpl),
        digit_pos=tuple(digit_pos),
        live_words=live,
    )


def block_counters(msg_len: int, tail_off: int, n_tail_blocks: int) -> List[int]:
    """The counter ``t`` of each tail block: the message bytes through it.
    A block before the last is full (``tail_off + 128 (b + 1)``); the last
    carries ``msg_len`` and the final flag."""
    if n_tail_blocks not in (1, 2):
        raise ValueError(f"{n_tail_blocks} tail blocks (1 or 2)")
    if not tail_off + 128 * (n_tail_blocks - 1) < msg_len <= tail_off + 128 * n_tail_blocks:
        raise ValueError(
            f"msg_len {msg_len} does not end in tail block {n_tail_blocks} "
            f"after {tail_off} folded bytes"
        )
    return [tail_off + 128 * (b + 1) for b in range(n_tail_blocks - 1)] + [msg_len]


# --------------------------------------------------------------------------
# Plain PyTorch version: int64 tensors holding u32 halves
# --------------------------------------------------------------------------


def _add(a, b, x=None):
    """u64 ``a + b (+ x)`` on (hi, lo) pairs of 32-bit values: the low
    halves' sum (below 3 * 2^32) carries from bit 32 into the high half."""
    lo = a[1] + b[1] + (0 if x is None else x[1])
    hi = a[0] + b[0] + (0 if x is None else x[0]) + (lo >> 32)
    return hi & _M32, lo & _M32


def _xor_rotr(a, b, n: int):
    """``rotr64(a ^ b, n)`` on (hi, lo) pairs; n == 32 swaps the halves."""
    h, l = a[0] ^ b[0], a[1] ^ b[1]
    if n == 32:
        return l, h
    if n > 32:
        h, l, n = l, h, n - 32
    return ((h >> n) | (l << (32 - n))) & _M32, ((l >> n) | (h << (32 - n))) & _M32


def compress_pairs(h: Sequence[Tuple], m: Sequence[Tuple], t: int, final: bool,
                   n_out: int = 8) -> List[Tuple]:
    """One BLAKE2b compression on (hi, lo) pairs: ``h`` 8 chaining words,
    ``m`` 16 message words, each pair of int64 tensors or python ints below
    2^32.  Returns the first ``n_out`` words of the new chaining state."""
    v = list(h)
    for q in range(8):
        iv = IV[q]
        if q == 4:
            iv ^= t & _MASK64
        if q == 6 and final:
            iv ^= _MASK64
        v.append((iv >> 32, iv & _M32))
    for r in range(12):
        s = SIGMA[r]
        for gi, (a, b, c, d) in enumerate(GIDX):
            v[a] = _add(v[a], v[b], m[s[2 * gi]])
            v[d] = _xor_rotr(v[d], v[a], 32)
            v[c] = _add(v[c], v[d])
            v[b] = _xor_rotr(v[b], v[c], 24)
            v[a] = _add(v[a], v[b], m[s[2 * gi + 1]])
            v[d] = _xor_rotr(v[d], v[a], 16)
            v[c] = _add(v[c], v[d])
            v[b] = _xor_rotr(v[b], v[c], 63)
    return [(h[i][0] ^ v[i][0] ^ v[8 + i][0], h[i][1] ^ v[i][1] ^ v[8 + i][1])
            for i in range(n_out)]


def _bswap32(x):
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00)
            | ((x >> 24) & 0xFF))


def _hash_words(mid: Sequence[int], words: Sequence, counters: Sequence[int]):
    """``(h0, h1)`` of lanes whose tail words (u32, (hi, lo) order) are
    ``words``: the digest's first 8 bytes read big-endian, from h'[0]."""
    state = [(mid[2 * q], mid[2 * q + 1]) for q in range(8)]
    n_tb = len(counters)
    for blk, t in enumerate(counters):
        w = words[32 * blk : 32 * (blk + 1)]
        m = [(w[2 * q], w[2 * q + 1]) for q in range(16)]
        last = blk == n_tb - 1
        state = compress_pairs(state, m, t, last, n_out=1 if last else 8)
    hi, lo = state[0]
    return _bswap32(lo), _bswap32(hi)


def _check_operands(midstate, tail, bounds, low_pos, k) -> Tuple[int, int]:
    """Validate shapes and dtypes; returns ``(batch, n_tail_blocks)``."""
    if midstate.shape != (16,) or midstate.dtype != torch.uint32:
        raise ValueError(f"midstate must be (16,) uint32, got {tuple(midstate.shape)} {midstate.dtype}")
    if tail.dim() != 2 or tail.dtype != torch.uint32:
        raise ValueError(f"tail must be (B, 32*n_tb) uint32, got {tuple(tail.shape)} {tail.dtype}")
    batch, n_words = tail.shape
    if n_words not in (32, 64):
        raise ValueError(f"tail rows must hold 32 or 64 words, got {n_words}")
    if bounds.shape != (batch, 2) or bounds.dtype != torch.int32:
        raise ValueError(f"bounds must be ({batch}, 2) int32, got {tuple(bounds.shape)} {bounds.dtype}")
    if k != len(low_pos):
        raise ValueError(f"k ({k}) != {len(low_pos)} low digit positions")
    if not 1 <= k <= 9:
        raise ValueError(f"k ({k}) must be in [1, 9]")
    if batch * 10**k > I32_MAX:
        raise ValueError(
            f"batch ({batch}) * 10^k ({10**k}) lanes overflow the int32 "
            "argmin index; lower batch or max_k"
        )
    for w, s in _pairs(low_pos):
        if not (0 <= w < n_words and s in (0, 8, 16, 24)):
            raise ValueError(f"digit position ({w}, {s}) outside a {n_words}-word tail")
    for t in (tail, bounds):
        if t.device != midstate.device:
            raise ValueError(f"operands on {midstate.device} and {t.device}")
    return batch, n_words // 32


def _fold_lanes(mid, tail64, rows, lanes, digit_terms, counters, n_lanes):
    """Min ``(h0, h1, flat_idx)`` of the given (row, lane) pairs (non-empty
    int64 tensors): each message is the row's template with
    ``digit_terms(lanes)`` — ``[(word, tensor)]`` — ORed in."""
    words = list(tail64[rows].unbind(1))
    for word, val in digit_terms(lanes):
        words[word] = words[word] | val
    h0, h1 = _hash_words(mid, words, counters)
    idx = rows * n_lanes + lanes
    m0 = int(h0.min())
    sel = h0 == m0
    m1 = int(h1[sel].min())
    return m0, m1, int(idx[sel & (h1 == m1)].min())


def blake2b_minhash_plain(
    midstate: torch.Tensor,
    tail_const: torch.Tensor,
    bounds: torch.Tensor,
    thresh: Optional[int] = None,
    *,
    low_pos: Sequence,
    k: int,
    msg_len: int,
    tail_off: int,
    k_in: int = 0,
    th_word: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The BLAKE2b min-hash of one dispatch in plain PyTorch, on the
    operands' device: the triple of the reference's
    ``make_blake2b_kernel_body`` as a (3,) int64 tensor.

    Lane ``i`` of row ``r`` is valid when ``bounds[r, 0] <= i <
    bounds[r, 1]``; its message is the row's template with the ASCII digits
    of ``i`` at ``low_pos`` (``k`` of them, most significant first).  The
    result is the lexicographic min of ``(h0, h1, r * 10^k + i)`` over valid
    lanes, ``(U32_MAX, U32_MAX, I32_MAX)`` when none is; with ``thresh``
    the min only when its ``h0 <= thresh`` (ties survive); ``th_word`` may
    stand for ``thresh`` as in ``ops/sha256_minhash.py``.  ``msg_len`` and
    ``tail_off`` give the blocks' byte counters (:func:`block_counters`).

    ``k_in = 0`` is the full-lane form: valid lanes are enumerated in
    chunks.  ``k_in > 0`` is the reference's grouped form: the ``10^k``
    lanes of a row as ``10^(k - k_in)`` outer groups of ``10^k_in`` inner
    lanes, the outer digits patched into the template once per group and
    the threshold tightened by the running best across groups.  Both
    compute the same function."""
    batch, n_tb = _check_operands(midstate, tail_const, bounds, low_pos, k)
    thresh = plain_threshold(thresh, th_word, midstate.device)
    counters = block_counters(msg_len, tail_off, n_tb)
    pos = _pairs(low_pos)
    dev = midstate.device
    n_lanes = 10**k
    mid = [int(v) for v in midstate.to(torch.int64).tolist()]
    tail64 = tail_const.to(torch.int64)
    b64 = bounds.to(torch.int64).clamp(0, n_lanes)
    if k_in:
        if not 1 <= k_in < k:
            raise ValueError(f"k_in must be in [1, {k - 1}], got {k_in}")
        best = _grouped(mid, tail64, b64, pos, k, k_in, counters, thresh, dev)
        return torch.tensor(lower_word(th_word, best), dtype=torch.int64, device=dev)

    def digits(lanes):
        return [(w, ((lanes // 10 ** (k - 1 - j)) % 10 + 48) << s)
                for j, (w, s) in enumerate(pos)]

    lo, hi = b64[:, 0], b64[:, 1]
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
        best = min(best, _fold_lanes(mid, tail64, rows, lanes, digits, counters, n_lanes))
    return torch.tensor(lower_word(th_word, sieved(best, thresh)), dtype=torch.int64,
                        device=dev)


def _grouped(mid, tail64, b64, pos, k, k_in, counters, thresh, dev) -> Tuple[int, int, int]:
    """The grouped form of :func:`blake2b_minhash_plain`: its output."""
    s_in = 10**k_in
    n_lanes = 10**k
    outer, inner = pos[: k - k_in], pos[k - k_in :]
    i = torch.arange(s_in, device=dev)
    inner_terms = [(w, ((i // 10 ** (k_in - 1 - j)) % 10 + 48) << s)
                   for j, (w, s) in enumerate(inner)]
    best = (U32_MAX, U32_MAX, I32_MAX)
    rows_all = torch.arange(b64.shape[0], device=dev)
    for og in range(10 ** (k - k_in)):
        gb = (b64 - og * s_in).clamp(0, s_in)
        valid = (i[None, :] >= gb[:, :1]) & (i[None, :] < gb[:, 1:2])
        rows, lane_in = valid.nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        outer_terms = [(w, ((og // 10 ** (k - k_in - 1 - j)) % 10 + 48) << s)
                       for j, (w, s) in enumerate(outer)]

        def digits(lanes, lane_in=lane_in, outer_terms=outer_terms):
            return outer_terms + [(w, val[lane_in]) for w, val in inner_terms]

        cand = _fold_lanes(mid, tail64, rows_all[rows], og * s_in + lane_in, digits,
                           counters, n_lanes)
        # Sieve: lanes above the threshold, tightened by the best so far,
        # are masked; the group's min survives iff its h0 is not above it.
        if thresh is None or cand[0] <= min(thresh, best[0]):
            best = min(best, cand)
    return best


# --------------------------------------------------------------------------
# The bound: lane-dependent integer instructions
# --------------------------------------------------------------------------


def lane_ops(low_pos: Sequence, n_tail_blocks: int) -> Tuple[int, int]:
    """``(logic, adds)``: the 32-bit integer instructions one lane needs,
    counting only those whose result depends on the lane's low digits and
    reaches the digest.

    Derived from the compression by following which u64 values depend on
    the lane (message words holding a low digit; everything computed from
    them) and which are live (backwards from ``h'[0]``: the last round's G's
    that feed neither ``v[0]`` nor ``v[8]`` are dead).  Per dependent, live
    u64 operation: a 2- or 3-input add is 2 adds (``IADD3`` with carry out,
    ``IADD3.X``); ``rotr(x ^ y, 32)`` is 2 LOP3 (the rotation swaps the
    halves); ``rotr(x ^ y, n)`` for n = 24, 16, 63 is 2 LOP3 and 2 funnel
    shifts or byte permutes; the feed-forward ``h ^ v[i] ^ v[i + 8]`` 2
    LOP3; the final byte swaps 2.  ``logic`` issues only on the ALU pipe;
    adds may also issue on the FMA pipe.  Digit generation and the fold are
    not counted, so the bound stays a lower bound."""
    digit_words = {w // 2 for w, _ in _pairs(low_pos)}  # u64 message words
    new = itertools.count()
    dep: Dict[int, bool] = {}
    ops: List[Tuple[int, Tuple[int, ...], int, int]] = []

    def var(is_dep: bool) -> int:
        v = next(new)
        dep[v] = is_dep
        return v

    def op(ins: Tuple[int, ...], logic: int, adds: int) -> int:
        out = var(any(dep[i] for i in ins))
        ops.append((out, ins, logic, adds))
        return out

    h = [var(False) for _ in range(8)]  # the midstate: per dispatch
    out = None
    for blk in range(n_tail_blocks):
        last = blk == n_tail_blocks - 1
        m = [var(16 * blk + q in digit_words) for q in range(16)]
        v = list(h) + [var(False) for _ in range(8)]
        for r in range(12):
            s = SIGMA[r]
            for gi, (a, b, c, d) in enumerate(GIDX):
                x, y = m[s[2 * gi]], m[s[2 * gi + 1]]
                v[a] = op((v[a], v[b], x), 0, 2)
                v[d] = op((v[d], v[a]), 2, 0)
                v[c] = op((v[c], v[d]), 0, 2)
                v[b] = op((v[b], v[c]), 4, 0)
                v[a] = op((v[a], v[b], y), 0, 2)
                v[d] = op((v[d], v[a]), 4, 0)
                v[c] = op((v[c], v[d]), 0, 2)
                v[b] = op((v[b], v[c]), 4, 0)
        if last:
            out = op((op((h[0], v[0], v[8]), 2, 0),), 2, 0)  # h'[0], byte swaps
        else:
            h = [op((h[i], v[i], v[8 + i]), 2, 0) for i in range(8)]
    live = {out}
    logic = adds = 0
    for o, ins, lg, ad in reversed(ops):
        if o in live:
            live.update(ins)
            if dep[o]:
                logic += lg
                adds += ad
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
