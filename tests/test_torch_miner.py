"""The port's miner end to end over LSP, against the JAX package's server.

The JAX package's ``serve`` + ``Scheduler`` and client speak the frozen wire
protocol to a port miner on ``--backend torch`` on the CPU, built with
``host_lane_budget=0`` so the plain version of the kernel, not the host
fold, answers.  In-process, loopback UDP, small LSP epochs.
"""

import io
import threading
from contextlib import redirect_stdout

import pytest
import torch

from bitcoin_miner_tpu import lsp as ref_lsp
from bitcoin_miner_tpu import lspnet as ref_lspnet
from bitcoin_miner_tpu.apps import client as ref_client
from bitcoin_miner_tpu.apps import server as ref_server
from bitcoin_miner_tpu.apps.scheduler import Scheduler
from bitcoin_miner_tpu.bitcoin.hash import min_hash_range
from bitcoin_miner_tpu_torch import lsp
from bitcoin_miner_tpu_torch.apps import miner
from bitcoin_miner_tpu_torch.bitcoin.message import Message as PortMessage
from bitcoin_miner_tpu_torch.bitcoin.message import MsgType as PortMsgType
from bitcoin_miner_tpu.bitcoin.message import Message as RefMessage

REF_PARAMS = ref_lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)
PARAMS = lsp.Params(epoch_limit=5, epoch_millis=100, window_size=5)


@pytest.fixture(autouse=True)
def _clean_network():
    ref_lspnet.reset_faults()
    yield
    ref_lspnet.reset_faults()


def test_port_miner_serves_reference_scheduler():
    server = ref_lsp.Server(0, REF_PARAMS)
    st = threading.Thread(
        target=ref_server.serve, args=(server, Scheduler(min_chunk=50)), daemon=True
    )
    st.start()
    search = miner.make_async_search("torch", device="cpu", host_lane_budget=0)
    mc = lsp.Client("127.0.0.1", server.port, PARAMS)
    mt = threading.Thread(target=miner.run_miner, args=(mc, search), daemon=True)
    mt.start()
    try:
        c = ref_lsp.Client("127.0.0.1", server.port, REF_PARAMS)
        try:
            # 99_950..100_049 crosses into the 6-digit class.
            res = ref_client.request_once(c, "cmu440", 100_049, lower=99_950,
                                          timeout=60)
        finally:
            c.close()
        assert res == min_hash_range("cmu440", 99_950, 100_049)
    finally:
        server.close()
        mt.join(timeout=30)
        mc.close()
    assert not mt.is_alive()


def test_wire_codec_matches_reference():
    for m in (PortMessage.join(), PortMessage.request("cmu440", 5, 10**19),
              PortMessage.result(2**64 - 1, 7)):
        raw = m.marshal()
        r = RefMessage.unmarshal(raw)
        assert r is not None and r.marshal() == raw
    assert PortMessage.unmarshal(b'{"Type":1,"Lower":-1}') is None
    assert PortMessage.unmarshal(raw).type == PortMsgType.RESULT


def test_auto_backend_without_card_is_a_configuration_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: auto resolves to cuda")
    out = io.StringIO()
    with redirect_stdout(out):
        rc = miner.main(["miner", "127.0.0.1:9", "--backend", "auto"])
    assert rc == 0
    assert out.getvalue().startswith("Invalid miner configuration:")
    with pytest.raises(ValueError):
        miner.make_async_search("auto")
    with redirect_stdout(io.StringIO()) as out2:
        miner.main(["miner", "127.0.0.1:9", "--backend", "cuda"])
    assert out2.getvalue().startswith("Invalid miner configuration:")


def test_cpu_backends_resolve_without_card():
    assert miner._resolve_backend("auto", "cpu") == "torch"
    want = min_hash_range("abc", 95, 120)
    assert miner.make_search("cpu")("abc", 95, 120) == want
    assert miner.make_search("torch", device="cpu")("abc", 95, 120) == want
