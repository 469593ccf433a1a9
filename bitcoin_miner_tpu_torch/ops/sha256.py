"""SHA-256 primitives of the port: host message layout + torch compression.

The mining hash contract (reference ``bitcoin/hash.go:13-17``) is a single
SHA-256 over the ASCII string ``"<data> <nonce>"`` whose length varies with
the nonce's decimal digit count.  This module provides:

- the round constants and a **pure-Python compression** used host-side to
  fold the constant message prefix (job data + space) into a *midstate*;
- the **message layout** (``build_layout``): for job ``data``, separator
  and digit count ``d`` the padded tail-block word template and the (word, shift)
  position of every nonce digit byte; and the factored kernel's split of
  the low digits into outer groups and inner lanes (``factor_low_pos``,
  ``outer_patch_table``);
- a **torch compression** over int64 tensors holding 32-bit values, used
  by the plain versions of the min-hash kernels (ops/sha256_minhash.py,
  ops/sha256_minhash_factored.py), with the factored kernel's resumable
  entry points (``stop_round=``, ``group_state=``).
  torch has no uint32 arithmetic on the CPU, so every sum is masked back to
  32 bits; a rotation ``(x >> n) | (x << (32 - n))`` of a value below 2^32
  stays below 2^63 and cannot overflow.

The final 8 digest bytes are the big-endian pair ``(h0, h1)``, compared
lexicographically.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

# fmt: off
K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], dtype=np.uint32)

H0 = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], dtype=np.uint32)
# fmt: on

_M32 = 0xFFFFFFFF
_K_INT = tuple(int(v) for v in K)


# --------------------------------------------------------------------------
# torch compression (plain version of the device tier)
# --------------------------------------------------------------------------


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def compress(
    state: Sequence,
    w: Sequence,
    final_only: "bool | str" = False,
    stop_round: "int | None" = None,
    group_state: "Tuple | None" = None,
) -> Tuple:
    """One SHA-256 compression of a 16-word block.

    ``state``: 8 values, ``w``: 16 values; each an int64 tensor of 32-bit
    values or a Python int (a word constant across lanes stays a scalar
    until it meets a tensor).  Returns the 8 updated state values.

    ``final_only=True`` (a message's LAST block when only the first 8
    digest bytes matter — the mining contract reads exactly ``(h0, h1)``)
    returns just ``(out_a, out_b)``; ``final_only="h0"`` returns ``(out_a,)``.

    ``stop_round=p`` and ``group_state=`` are the factored kernel's entry
    points.  ``stop_round=p`` (0 <= p <= 16) runs rounds ``[0, p)``, which
    read only ``w[:p]``, and returns the carried state ``(p, (a..h))``.
    ``group_state=`` resumes from such a carried state: rounds ``[p, 64)``
    run, and ``state`` stays the block's initial state for the
    feed-forward.  ``compress(s, w, group_state=compress(s, w,
    stop_round=p))`` equals ``compress(s, w)`` for every p.
    """
    if group_state is None:
        start = 0
        a, b, c, d, e, f, g, h = state
    else:
        start, (a, b, c, d, e, f, g, h) = group_state
    if stop_round is not None and not start <= stop_round <= 16:
        # Past round 16 the schedule buffer has been overwritten, so the
        # carried state would no longer be (round, 8 words).
        raise ValueError(f"stop_round must be in [{start}, 16], got {stop_round}")
    w = list(w)
    for t in range(start, 64):
        if t == stop_round:
            return (t, (a, b, c, d, e, f, g, h))
        if t < 16:
            wt = w[t]
        else:
            w15 = w[(t - 15) % 16]
            w2 = w[(t - 2) % 16]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            wt = (w[t % 16] + s0 + w[(t - 7) % 16] + s1) & _M32
            w[t % 16] = wt
        s1e = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = g ^ (e & (f ^ g))
        t1 = (h + s1e + ch + _K_INT[t] + wt) & _M32
        s0a = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) | (c & (a | b))
        t2 = s0a + maj
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    if final_only == "h0":
        return ((a + state[0]) & _M32,)
    if final_only:
        return ((a + state[0]) & _M32, (b + state[1]) & _M32)
    out = (a, b, c, d, e, f, g, h)
    return tuple((x + y) & _M32 for x, y in zip(out, state))


# --------------------------------------------------------------------------
# Pure-Python compression (host tier: midstate + oracle cross-checks)
# --------------------------------------------------------------------------


def _rotr_py(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def compress_py(state: Sequence[int], block: bytes) -> List[int]:
    """Host-side single-block compression over plain ints (for midstate)."""
    if len(block) != 64:
        raise ValueError(f"block must be 64 bytes, got {len(block)}")
    w = [int.from_bytes(block[i : i + 4], "big") for i in range(0, 64, 4)]
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        if t < 16:
            wt = w[t]
        else:
            w15 = w[(t - 15) % 16]
            w2 = w[(t - 2) % 16]
            s0 = _rotr_py(w15, 7) ^ _rotr_py(w15, 18) ^ (w15 >> 3)
            s1 = _rotr_py(w2, 17) ^ _rotr_py(w2, 19) ^ (w2 >> 10)
            wt = (w[t % 16] + s0 + w[(t - 7) % 16] + s1) & _M32
            w[t % 16] = wt
        s1e = _rotr_py(e, 6) ^ _rotr_py(e, 11) ^ _rotr_py(e, 25)
        ch = (e & f) ^ (~e & _M32 & g)
        t1 = (h + s1e + ch + _K_INT[t] + wt) & _M32
        s0a = _rotr_py(a, 2) ^ _rotr_py(a, 13) ^ _rotr_py(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0a + maj) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, (t1 + t2) & _M32
    out = [a, b, c, d, e, f, g, h]
    return [(x + y) & _M32 for x, y in zip(out, state)]


# --------------------------------------------------------------------------
# Message layout: "<data> <nonce>" -> midstate + tail template
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DigitPos:
    """Where nonce digit ``j`` (most-significant first) lands in the tail."""

    word: int  # index into the flattened tail word array
    shift: int  # left shift of the ASCII byte within that big-endian word


@dataclass(frozen=True)
class MsgLayout:
    """Precomputed layout for hashing ``"<data> <nonce>"`` at a fixed digit
    count ``d``.  ``midstate`` covers the fully-constant prefix blocks;
    ``tail_template`` holds the remaining block words with zeros at digit
    byte positions; ``digit_pos`` says how to OR each digit's ASCII byte in.
    """

    family = "sha256"

    data_len: int
    digit_count: int
    midstate: Tuple[int, ...]  # 8 uint32
    tail_template: Tuple[int, ...]  # n_tail_blocks*16 uint32
    digit_pos: Tuple[DigitPos, ...]  # length == digit_count

    @property
    def n_tail_blocks(self) -> int:
        return len(self.tail_template) // 16

    def factor(self, k: int, k_in: int) -> "FactorSplit":
        """Outer/inner split of this layout's ``k`` low digits (see
        :func:`factor_low_pos`)."""
        if k > self.digit_count:
            raise ValueError(f"k ({k}) exceeds digit_count ({self.digit_count})")
        return factor_low_pos(self.digit_pos[self.digit_count - k :], k_in)


@dataclass(frozen=True)
class FactorSplit:
    """Outer/inner factoring of the ``k`` low digits of a dispatch.

    A chunk's ``10^k`` lanes factor as ``10^k_out`` outer groups of
    ``10^k_in`` inner lanes.  The outer digits (``outer_pos``) are the same
    for every lane of a group and are patched into the row's template once
    per group (:func:`outer_patch_table`); only the inner digits
    (``inner_pos``) vary per lane.  Every round before ``first_inner_word``
    reads group-constant words only, so the factored kernel computes that
    round prefix once per (row, group) and resumes it per lane
    (``compress``'s ``stop_round=`` / ``group_state=``).
    """

    k_out: int
    k_in: int
    outer_pos: Tuple[DigitPos, ...]  # high k_out of the k low digits
    inner_pos: Tuple[DigitPos, ...]  # low k_in digits (vary per lane)
    first_inner_word: int  # flat tail-word index of the first inner digit


def factor_low_pos(low_pos: Tuple[DigitPos, ...], k_in: int) -> FactorSplit:
    """Split the ``k`` low digit positions into outer and inner groups;
    ``1 <= k_in < k`` (with no outer digit there is nothing to factor)."""
    k = len(low_pos)
    if not 1 <= k_in < k:
        raise ValueError(f"k_in must be in [1, {k - 1}], got {k_in}")
    outer_pos = tuple(low_pos[: k - k_in])
    inner_pos = tuple(low_pos[k - k_in :])
    return FactorSplit(
        k_out=k - k_in,
        k_in=k_in,
        outer_pos=outer_pos,
        inner_pos=inner_pos,
        first_inner_word=min(dp.word for dp in inner_pos),
    )


@lru_cache(maxsize=64)
def outer_patch_table(
    outer_pos: Tuple[DigitPos, ...],
) -> Tuple[Tuple[int, ...], np.ndarray]:
    """``(words, table)``: the tail-word indices the outer digits touch
    (ascending) and a read-only ``(10^k_out, len(words))`` uint32 table
    whose row ``g`` holds the masks that OR outer group ``g``'s ASCII
    digits into those words."""
    k_out = len(outer_pos)
    words = tuple(sorted({dp.word for dp in outer_pos}))
    widx = {w: m for m, w in enumerate(words)}
    g = np.arange(10**k_out, dtype=np.int64)
    table = np.zeros((10**k_out, len(words)), dtype=np.uint32)
    for j, dp in enumerate(outer_pos):
        p = 10 ** (k_out - 1 - j)
        dig = ((g // p) % 10 + 48).astype(np.uint32) << np.uint32(dp.shift)
        table[:, widx[dp.word]] |= dig
    table.setflags(write=False)
    return words, table


def build_layout(data: bytes, digit_count: int, sep: bytes = b" ") -> MsgLayout:
    """Build the layout for messages ``data + sep + <digit_count digits>``.

    Standard SHA-256 padding: message || 0x80 || zeros || 64-bit big-endian
    bit length, to a multiple of 64 bytes.  Blocks wholly inside the constant
    prefix (data + separator) are folded into the midstate host-side — for
    long job data the device then hashes only the final block(s).

    ``sep`` is the workload's separator (``b" "`` for ``sha256d``, ``b":"``
    for ``preimage``).  Digit positions depend on the prefix length only,
    so the kernels and ``resume_point`` take every separator unchanged; its
    bytes ride the midstate and template operands.
    """
    if digit_count < 1 or digit_count > 20:  # uint64 max has 20 digits
        raise ValueError(f"digit_count out of range: {digit_count}")
    prefix = data + sep
    c_len = len(prefix)
    msg_len = c_len + digit_count
    n_blocks = (msg_len + 9 + 63) // 64
    n_const = c_len // 64  # blocks fully covered by the constant prefix

    midstate = [int(x) for x in H0]
    for i in range(n_const):
        midstate = compress_py(midstate, prefix[i * 64 : (i + 1) * 64])

    tail = bytearray((n_blocks - n_const) * 64)
    rem = prefix[n_const * 64 :]
    tail[: len(rem)] = rem
    digit_off = len(rem)
    # digit bytes live at [digit_off, digit_off + digit_count): template zeros
    tail[digit_off + digit_count] = 0x80
    bit_len = msg_len * 8
    tail[-8:] = bit_len.to_bytes(8, "big")

    words = tuple(
        int.from_bytes(tail[i : i + 4], "big") for i in range(0, len(tail), 4)
    )
    digit_pos = tuple(
        DigitPos(word=(digit_off + j) // 4, shift=(3 - (digit_off + j) % 4) * 8)
        for j in range(digit_count)
    )
    return MsgLayout(
        data_len=len(data),
        digit_count=digit_count,
        midstate=tuple(midstate),
        tail_template=words,
        digit_pos=digit_pos,
    )


def digest_u64_py(layout: MsgLayout, digits: str) -> int:
    """Host oracle: finish the hash from a layout + explicit digit string.
    Used by tests to validate the layout machinery itself against hashlib."""
    if len(digits) != layout.digit_count:
        raise ValueError(f"expected {layout.digit_count} digits, got {digits!r}")
    words = list(layout.tail_template)
    for j, dp in enumerate(layout.digit_pos):
        words[dp.word] |= ord(digits[j]) << dp.shift
    state = list(layout.midstate)
    for b in range(layout.n_tail_blocks):
        block = b"".join(
            w.to_bytes(4, "big") for w in words[b * 16 : (b + 1) * 16]
        )
        state = compress_py(state, block)
    return (state[0] << 32) | state[1]
