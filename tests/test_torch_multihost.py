"""The port's multi-host miner against the JAX package's.

The broadcast codec and the primary/secondary Request loop
(``serve_multihost``) are held byte for byte to the reference's functions
on the cases of tests/test_multihost.py, with a faked broadcast.  Then two
real port miner processes join one gloo job over loopback (``--multihost
--num-hosts 2``, each with two CPU shards) and serve the reference's
scheduler; their Result must equal the oracle.  When host 0 dies mid-job,
the other rank must exit rather than wait in a collective.
"""

import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from bitcoin_miner_tpu import lsp as ref_lsp
from bitcoin_miner_tpu.apps import client as ref_client
from bitcoin_miner_tpu.apps import miner as ref_miner
from bitcoin_miner_tpu.apps import server as ref_server
from bitcoin_miner_tpu.apps.scheduler import Scheduler
from bitcoin_miner_tpu.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu.bitcoin.message import Message as RefMessage
from bitcoin_miner_tpu.parallel import multihost as ref_mh
from bitcoin_miner_tpu_torch import lsp
from bitcoin_miner_tpu_torch.apps import miner
from bitcoin_miner_tpu_torch.bitcoin.message import Message
from bitcoin_miner_tpu_torch.parallel import multihost as mh

REPO = Path(__file__).resolve().parents[1]

ROUND_TRIPS = [
    ("cmu440", 0, 10**6),
    ("", 5, 5),
    ("héllo wörld ⚡", 0, (1 << 64) - 1),  # multi-byte UTF-8
    ("x" * mh.MAX_DATA, 123, 456),  # exactly at the cap
]


@pytest.mark.parametrize("data,lo,hi", ROUND_TRIPS)
def test_codec_matches_reference(data, lo, hi):
    buf = mh.encode_request(data, lo, hi)
    ref = ref_mh.encode_request(data, lo, hi)
    assert buf.dtype == ref.dtype and buf.tobytes() == ref.tobytes()
    assert mh.decode_request(buf) == ref_mh.decode_request(ref) == (data, lo, hi)


def test_codec_shutdown_and_shape_match_reference():
    assert mh.encode_shutdown().tobytes() == ref_mh.encode_shutdown().tobytes()
    assert mh.decode_request(mh.encode_shutdown()) is None
    assert (mh.MAX_DATA, mh._HDR) == (ref_mh.MAX_DATA, ref_mh._HDR)
    a, b = mh.encode_request("abc", 0, 1), mh.encode_shutdown()
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint32


@pytest.mark.parametrize("args,match", [
    (("x" * (mh.MAX_DATA + 1), 0, 1), "caps at"),
    (("⚡" * 481, 0, 1), "caps at"),  # 1443 bytes: no mid-sequence truncation
    (("d", 0, 1 << 64), "u64"),
    (("d", -1, 1), "u64"),
])
def test_codec_refusals_match_reference(args, match):
    for mod in (mh, ref_mh):
        with pytest.raises(ValueError, match=match):
            mod.encode_request(*args)


class FakeClient:
    """Scripted LSP client: read() pops payloads, then raises the given
    package's ConnLostError; write() records the payloads."""

    def __init__(self, payloads, lsp_mod):
        self._payloads, self._lsp = list(payloads), lsp_mod
        self.written = []

    def read(self):
        if not self._payloads:
            raise self._lsp.ConnLostError(0)
        return self._payloads.pop(0)

    def write(self, payload):
        self.written.append(payload)


def _serve(serve_fn, lsp_mod, payloads, script=None):
    """Run one serve loop; returns (written payloads, broadcast buffers,
    sweeps run).  ``script`` (secondaries): the buffers the broadcast
    returns, in order; else the broadcast echoes host 0's buffer."""
    client = None if payloads is None else FakeClient(payloads, lsp_mod)
    sent, swept = [], []

    def broadcast(buf):
        sent.append(np.array(buf).tobytes())
        return script.pop(0) if script is not None else buf

    def sweep(data, lo, hi):
        swept.append((data, lo, hi))
        return min_hash_range(data, lo, hi)

    serve_fn(client, sweep, broadcast)
    return (None if client is None else client.written), sent, swept


SERVE_CASES = {
    "primary Request, sweep, Result": [("cmu440", 0, 99), ("cmu440", 100, 199)],
    "primary skips non-Requests": ["join", "result", ("d", 0, 9)],
    "oversize Request shuts down": [("y" * 2000, 0, 9)],
}


def _payloads(items, msg_cls):
    out = []
    for it in items:
        if it == "join":
            out.append(msg_cls.join().marshal())
        elif it == "result":
            out.append(msg_cls.result(1, 2).marshal())
        else:
            out.append(msg_cls.request(*it).marshal())
    return out


@pytest.mark.parametrize("name", sorted(SERVE_CASES))
def test_serve_multihost_primary_matches_reference(name, capsys):
    items = SERVE_CASES[name]
    got = _serve(miner.serve_multihost, lsp, _payloads(items, Message))
    port_err = capsys.readouterr().err
    want = _serve(ref_miner.serve_multihost, ref_lsp, _payloads(items, RefMessage))
    ref_err = capsys.readouterr().err
    assert got == want
    assert port_err == ref_err
    if name.startswith("oversize"):
        assert got[0] == [] and len(got[1]) == 1 and "rejecting request" in port_err
    else:
        assert got[1][-1] == mh.encode_shutdown().tobytes()  # conn loss fans out


def test_serve_multihost_secondary_matches_reference():
    def script():
        return [mh.encode_request("jobdata", 50, 60), mh.encode_request("jobdata", 61, 70),
                mh.encode_shutdown()]

    got = _serve(miner.serve_multihost, lsp, None, script())
    want = _serve(ref_miner.serve_multihost, ref_lsp, None, script())
    assert got == want
    assert got[2] == [("jobdata", 50, 60), ("jobdata", 61, 70)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_miner_serves_reference_scheduler():
    """Two port miners, ``--multihost --num-hosts 2`` with two CPU shards
    each (four shards in all), serve the reference's scheduler over LSP;
    the job crosses from the host-folded d = 5 class into d = 6, which
    runs as sharded dispatches with the cascade across the two ranks.
    Both processes exit 0 once the server is gone."""
    server = ref_lsp.Server(0)  # default LSP params, as the miner's client
    threading.Thread(target=ref_server.serve, args=(server, Scheduler(min_chunk=50)),
                     daemon=True).start()
    coord = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bitcoin_miner_tpu_torch.apps.miner",
         f"127.0.0.1:{server.port}", "--multihost", f"--coordinator=127.0.0.1:{coord}",
         "--num-hosts=2", f"--host-id={i}", "--devices", "2", "--backend", "torch",
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)},
    ) for i in range(2)]
    try:
        c = ref_lsp.Client("127.0.0.1", server.port)
        try:
            res = ref_client.request_once(c, "multihost", 100_049, lower=99_950, timeout=60)
        finally:
            c.close()
        assert res == min_hash_range("multihost", 99_950, 100_049)
    finally:
        server.close()
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate())
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


def test_secondary_exits_when_host0_dies_mid_job():
    """Kill host 0 (the rank holding the LSP conn) while the job runs: the
    other rank's next collective fails on the closed sockets and it exits
    (non-zero) instead of waiting in the collective."""
    import signal
    import time

    from bitcoin_miner_tpu.utils.metrics import METRICS

    METRICS.reset()
    server = ref_lsp.Server(0)
    threading.Thread(target=ref_server.serve, args=(server, Scheduler(min_chunk=2000)),
                     daemon=True).start()
    coord = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bitcoin_miner_tpu_torch.apps.miner",
         f"127.0.0.1:{server.port}", "--multihost", f"--coordinator=127.0.0.1:{coord}",
         "--num-hosts=2", f"--host-id={i}", "--backend", "torch", "--device", "cpu"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)},
    ) for i in range(2)]
    c = ref_lsp.Client("127.0.0.1", server.port)
    try:
        # ~60k nonces in chunks of ~2000: seconds of work on the CPU rung.
        c.write(RefMessage.request("hostdeath", 100_000, 160_000).marshal())
        deadline = time.monotonic() + 60
        while METRICS.get("sched.chunks_assigned") < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert METRICS.get("sched.chunks_assigned") >= 2, "the miner never took work"
        procs[0].send_signal(signal.SIGKILL)
        _out, err = procs[1].communicate(timeout=60)
        assert procs[1].returncode != 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
        c.close()
        server.close()
