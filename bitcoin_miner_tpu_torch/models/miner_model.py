"""The flagship "miner model": the chunked min-hash search step.

The analogue of a model forward pass: the input batch is a set of
10^k-aligned nonce chunks (message-word templates + lane bounds), the
"forward" is the SHA-256 compression over all lanes, and the output is
the reduced ``(min_h0, min_h1, flat_idx)``.

The port's counterpart of the reference package's
``models/miner_model.py``: the same operands, built by the same host
layout (:func:`~bitcoin_miner_tpu_torch.ops.sweep._layout_cache`,
:func:`~bitcoin_miner_tpu_torch.ops.sweep._fill_templates`) as torch
tensors, and a step that is the hand-written kernel
(:func:`~bitcoin_miner_tpu_torch.ops.sha256_minhash.minhash`) on the card.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.sha256_minhash import minhash, minhash_plain
from ..ops.sweep import Chunk, ChunkGroup, _fill_templates, _layout_cache


def forward_step_example(
    data: bytes = b"cmu440", d: int = 6, k: int = 4, batch: int = 8,
    device=None,
) -> Tuple[Callable, Tuple]:
    """Build ``(fn, args)`` for one representative shape class.

    ``fn(*args)`` is the single-device min-hash step over nonces
    ``[10^(d-1), 10^(d-1) + batch*10^k)`` of ``Hash(data, nonce)``: a (3,)
    int64 tensor ``(min_h0, min_h1, flat_idx)``, ``flat_idx = row * 10^k +
    lane``.  ``device`` None is the card (``"cuda"``), where ``fn`` is the
    kernel; ``"cpu"`` gives ``fn`` = its plain version.  Without a card
    and without ``device="cpu"`` it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(
                "forward_step_example found no CUDA device; pass device='cpu'"
            )
        fn = minhash
    elif dev.type == "cpu":
        fn = minhash_plain
    else:
        raise ValueError(f"no min-hash step for device {dev}")
    layout = _layout_cache(data, d)
    low_pos = tuple(
        (int(p.word), int(p.shift))
        for p in layout.digit_pos[layout.digit_count - k :]
    )
    span = 10**k
    base0 = 10 ** (d - 1)
    chunks = tuple(
        Chunk(base=base0 + i * span, lo_off=0, hi_off=span) for i in range(batch)
    )
    group = ChunkGroup(d=d, k=k, chunks=chunks)
    tail, bounds = _fill_templates(layout, group, chunks, batch)
    midstate = np.array(layout.midstate, dtype=np.uint32)
    args = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (midstate, tail, bounds)
    )
    return fn, (*args, low_pos)
