"""One logical miner spanning several processes.

Counterpart of ``bitcoin_miner_tpu/parallel/multihost.py``.  Two scaling
axes exist: process parallelism over LSP (every miner an independent
worker; the scheduler splits ranges across them — the default, and the
right answer for scaling out), and this module's: N processes (hosts)
join one ``torch.distributed`` job and present ONE worker to the
scheduler.  Run the same CLI on every host::

    python -m bitcoin_miner_tpu_torch.apps.miner host:port --multihost \\
        --coordinator <host0>:1234 --num-hosts N --host-id I

Only host 0 opens the LSP connection; it broadcasts each Request (the
fixed-shape buffer below) and every host runs the same sharded sweep over
the global shard list (``parallel/sweep.py``, with a :class:`World`): each
fills the same templates for all ``world shards * per_dev_batch`` rows of a
dispatch and launches only its own devices' contiguous slice, ranks in
order, then the cascade runs over the local shards and again across the
ranks.

The collectives are gloo's on host tensors: the cascade carries 4 words
per dispatch (~80 ms of kernel time at the cuda rung's shape), and those
words are already on the host; NCCL would also refuse two ranks on one
card, which is how a one-card machine runs this path.  Every rank calls
the same collectives in the same order: the digit classes routed to the
host fold must be the same on every rank (the budget is passed
explicitly), or the ranks would wait in mismatched collectives.  A rank
that dies closes its sockets, which fails the survivors' pending
collective at once; :data:`COLLECTIVE_TIMEOUT` bounds a rank that hangs
during a job.  The Request broadcast has a group of its own
(:func:`request_group`) with :data:`REQUEST_TIMEOUT`, because there the
secondaries wait as long as the scheduler sends host 0 no work.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .sweep import World

#: Max UTF-8-encoded job-data bytes in one broadcast buffer.  Chosen to fit
#: an LSP datagram (MaxMessageSize=1000, lsp/util.go:16) alongside the other
#: Request fields — data the scheduler could never have delivered anyway.
MAX_DATA = 960

_HDR = 6  # [alive, lower_hi, lower_lo, upper_hi, upper_lo, dlen]

#: How long a collective of a job (the rendezvous, the cascade) waits for
#: the other ranks: a rank's dispatch takes ~0.1 s at the cuda rung's shape.
COLLECTIVE_TIMEOUT = timedelta(minutes=10)
#: How long the Request broadcast waits: an idle miner's secondaries wait
#: there until the scheduler has work.
REQUEST_TIMEOUT = timedelta(days=7)


def encode_request(data: str, lower: int, upper: int) -> np.ndarray:
    """Pack a Request into the fixed-shape u32 broadcast buffer.

    u32 halves because the broadcast rides a jax collective (no u64 on all
    paths).  Raises ``ValueError`` on oversize data rather than truncating:
    a silently shortened message would mine the wrong string and return a
    plausible-but-incorrect Result.
    """
    raw = data.encode("utf-8")
    if len(raw) > MAX_DATA:
        raise ValueError(
            f"job data is {len(raw)} UTF-8 bytes; multihost broadcast caps "
            f"at {MAX_DATA}"
        )
    if not 0 <= lower < 1 << 64 or not 0 <= upper < 1 << 64:
        raise ValueError(f"nonce bounds out of u64 range: [{lower}, {upper}]")
    buf = np.zeros(_HDR + MAX_DATA, dtype=np.uint32)
    buf[0] = 1
    buf[1], buf[2] = lower >> 32, lower & 0xFFFFFFFF
    buf[3], buf[4] = upper >> 32, upper & 0xFFFFFFFF
    buf[5] = len(raw)
    buf[_HDR : _HDR + len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return buf


def encode_shutdown() -> np.ndarray:
    """The all-hosts-exit sentinel (alive flag 0)."""
    return np.zeros(_HDR + MAX_DATA, dtype=np.uint32)


def decode_request(buf: np.ndarray) -> Optional[Tuple[str, int, int]]:
    """Inverse of :func:`encode_request`; ``None`` means shutdown."""
    buf = np.asarray(buf)
    if buf[0] == 0:
        return None
    lower = (int(buf[1]) << 32) | int(buf[2])
    upper = (int(buf[3]) << 32) | int(buf[4])
    dlen = int(buf[5])
    data = bytes(buf[_HDR : _HDR + dlen].astype(np.uint8)).decode("utf-8")
    return data, lower, upper


def initialize(coordinator: str, num_hosts: int, host_id: int,
               timeout: timedelta = COLLECTIVE_TIMEOUT) -> None:
    """Join this process to the job (gloo over TCP; host 0 serves the
    rendezvous at ``coordinator``, ``host:port``).  Idempotent."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_hosts,
        rank=host_id, timeout=timeout,
    )


def request_group():
    """A gloo group of every rank for the Request broadcast, with
    :data:`REQUEST_TIMEOUT` (every rank creates it, in the same order
    relative to the other collectives)."""
    return dist.new_group(backend="gloo", timeout=REQUEST_TIMEOUT)


def shutdown() -> None:
    """Leave the job (no-op when not joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the host that owns the LSP connection (rank 0)."""
    return dist.get_rank() == 0


def _all_min(x) -> int:
    t = torch.tensor([int(x)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t[0])


def global_world(local_devices: Sequence) -> World:
    """This rank's place in the global shard list: ranks in order, each
    with its own devices (one collective, the same on every rank)."""
    counts = torch.zeros(dist.get_world_size(), dtype=torch.int64)
    counts[dist.get_rank()] = len(local_devices)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    per_rank = counts.tolist()
    return World(offset=sum(per_rank[: dist.get_rank()]), n_shards=sum(per_rank),
                 pmin=_all_min)


def broadcast(buf: np.ndarray, group=None) -> np.ndarray:
    """Host 0's buffer on every host, over ``group`` (None: the default
    group).  The u32 words ride as int64: gloo has no unsigned 32-bit
    type."""
    t = torch.from_numpy(np.asarray(buf, dtype=np.int64).copy())
    dist.broadcast(t, src=0, group=group)
    return t.numpy().astype(np.uint32)
