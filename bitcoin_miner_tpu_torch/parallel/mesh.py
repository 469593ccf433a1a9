"""The devices of a multi-device sweep.

Counterpart of ``bitcoin_miner_tpu/parallel/mesh.py``.  The reference
builds a 1-D ``jax.sharding.Mesh`` over the local chips; the port's
"mesh" is a plain list of torch devices, one shard each, in shard order.
A miner process still presents *one* worker to the scheduler however
many cards it drives.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..utils.platform import NoDeviceError

DeviceSpec = Union[str, torch.device]


def default_devices(n: Optional[int] = None) -> List[torch.device]:
    """``cuda:0 … cuda:n-1``; ``n=None`` takes every visible card.  More
    cards than are visible raises ``ValueError``; no card at all raises
    :class:`NoDeviceError` (a CPU sweep is only ever asked for by name)."""
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available; pass devices=['cpu'] * n "
            "(CLI: --backend torch --device cpu --devices N) for CPU shards"
        )
    have = torch.cuda.device_count()
    if n is None:
        n = have
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def resolve_devices(
    devices: Union[int, Sequence[DeviceSpec]], device: Optional[DeviceSpec] = None
) -> List[torch.device]:
    """The shard devices of a ``devices`` argument.

    An int ``n`` is :func:`default_devices` ``(n)``, or ``n`` CPU shards when
    ``device`` is the CPU (the tests' and the CLI's hermetic stand-in for
    ``n`` cards).  A sequence is taken as given, repeats included (two shards
    on one card).  A specific card in ``device`` beside ``n > 1`` is
    ambiguous and raises."""
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"--devices must be >= 1, got {devices}")
        if device is None:
            return default_devices(devices)
        dev = torch.device(device)
        if dev.type == "cpu":
            return [dev] * devices
        raise ValueError(
            f"--device {dev} names one card; --devices {devices} shards over "
            f"cuda:0..cuda:{devices - 1} (pass no --device)"
        )
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices is empty")
    if len({d.type for d in out}) != 1:
        raise ValueError(f"shard devices of mixed types: {out}")
    if out[0].type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(f"devices {out} requested but CUDA is unavailable")
    return out
