"""The port's LSP (L2) under loss, driven by the port's own lspnet knobs.

Representative cases of the reference's five LSP suites
(``tests/test_lsp{1..5}_*.py``), at small sizes and with this file's own
small harness:

- lsp1: echo under a symmetric 20% write drop, and under random delays;
- lsp2: the window's max capacity while acks are blackholed, and a gap in
  the first half of a stream filled by retransmission, in order;
- lsp3: close drains pending sends under drop, and a client's death is
  detected at the epoch limit;
- lsp4: bulk streams written across a partition arrive in order after the
  heal, and a fast close during a partition flushes after it;
- lsp5: lengthened payloads truncated to ``Size``, shortened ones never
  surfacing;
- the chaos layer: echo under the ``reorder-dup-delay`` scenario;
- across packages: a port client against the reference's server, and the
  reverse, each package under its own drop knobs, echoes in order;
- the echo runners' ``main`` with the reference's flags.
"""

import io
import random
import threading
import time

import pytest

from bitcoin_miner_tpu import lsp as ref_lsp
from bitcoin_miner_tpu import lspnet as ref_lspnet
from bitcoin_miner_tpu_torch import lsp, lspnet
from bitcoin_miner_tpu_torch.apps import crunner, srunner

EPOCH_MS = 100


@pytest.fixture(autouse=True)
def _clean_network():
    for net in (lspnet, ref_lspnet):
        net.reset_faults()
        net.CHAOS.reset()
    yield
    for net in (lspnet, ref_lspnet):
        net.CHAOS.reset()
        net.reset_faults()


def _params(limit=5, w=2, ms=EPOCH_MS, mod=lsp):
    return mod.Params(epoch_limit=limit, epoch_millis=ms, window_size=w)


def _spawn(fn) -> threading.Thread:
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


def _wait(cond, seconds: float) -> None:
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)


def _echo_server(server, mod=lsp, sleep_max_ms=0):
    """Echo every payload back to its conn until the server closes."""

    def loop():
        while True:
            try:
                cid, payload = server.read()
                if sleep_max_ms:
                    time.sleep(random.uniform(0, sleep_max_ms) / 1000)
                server.write(cid, payload)
            except mod.ConnLostError:
                continue
            except mod.LspError:
                return

    return _spawn(loop)


def _collecting_server(server, mod=lsp):
    """Record every payload (per conn) and never write back."""
    received: dict = {}

    def loop():
        while True:
            try:
                cid, payload = server.read()
                received.setdefault(cid, []).append(payload)
            except mod.ConnLostError:
                continue
            except mod.LspError:
                return

    _spawn(loop)
    return received


def _echo_clients(port, params, n_clients, n_msgs, seconds, mod=lsp, sleep_max_ms=0):
    """``n_clients`` threads, each writing ``n_msgs`` values and checking
    every echo (the reference harness's per-client loop)."""
    errors = []

    def client_loop(idx):
        try:
            c = mod.Client("127.0.0.1", port, params)
        except mod.LspError as e:
            errors.append(f"client {idx} connect failed: {e}")
            return
        try:
            for i in range(n_msgs):
                value = f"{idx}:{i}:{random.randint(0, 10**6)}".encode()
                if sleep_max_ms:
                    time.sleep(random.uniform(0, sleep_max_ms) / 1000)
                c.write(value)
                got = c.read()
                if got != value:
                    errors.append(f"client {idx}: {got!r} != {value!r}")
                    return
        except mod.LspError as e:
            errors.append(f"client {idx} transport error: {e}")
        finally:
            try:
                c.close()
            except mod.LspError:
                pass

    threads = [_spawn(lambda i=i: client_loop(i)) for i in range(n_clients)]
    for t in threads:
        t.join(timeout=seconds)
        if t.is_alive():
            errors.append("deadline exceeded")
    assert not errors, errors


# --------------------------------------------------------------------------
# lsp1: echo
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_clients,n_msgs,w", [(1, 10, 1), (3, 15, 5)])
def test_echo_under_symmetric_write_drop(n_clients, n_msgs, w):
    """The reference's robust regime: 20% write drop both ways, 50 ms
    epochs, epoch limit 20."""
    params = _params(limit=20, w=w, ms=50)
    server = lsp.Server(0, params)
    _echo_server(server)
    lspnet.set_write_drop_percent(20)
    try:
        _echo_clients(server.port, params, n_clients, n_msgs, seconds=20)
    finally:
        lspnet.reset_faults()
        server.close()


def test_echo_under_random_delays():
    params = _params(limit=10, w=2)
    server = lsp.Server(0, params)
    _echo_server(server, sleep_max_ms=40)
    try:
        _echo_clients(server.port, params, 3, 8, seconds=20, sleep_max_ms=40)
    finally:
        server.close()


def test_echo_under_chaos_reorder_dup_delay():
    """The chaos layer's jittery, reordering, duplicating link on every
    endpoint: the echoes still come back exactly once, in order."""
    lspnet.CHAOS.seed(5)
    lspnet.CHAOS.run(lspnet.standard_scenarios()["reorder-dup-delay"])
    params = _params(limit=10, w=4)
    server = lsp.Server(0, params, label="server")
    _echo_server(server)
    try:
        _echo_clients(server.port, params, 2, 20, seconds=20)
        counters = lspnet.CHAOS.counters()
        for key in ("reordered", "duplicated", "delayed"):
            assert counters.get(key, 0) > 0, counters
    finally:
        lspnet.CHAOS.reset()
        server.close()


# --------------------------------------------------------------------------
# lsp2: the window
# --------------------------------------------------------------------------


def test_window_max_capacity():
    """Acks blackholed: of W + 4 writes exactly the first W arrive; after
    the heal, all of them, in order."""
    w = 5
    params = _params(limit=10, w=w)
    server = lsp.Server(0, params)
    received = _collecting_server(server)
    client = lsp.Client("127.0.0.1", server.port, params)
    lspnet.set_server_write_drop_percent(100)
    total = w + 4
    for i in range(total):
        client.write(b"m%d" % i)
    _wait(lambda: sum(map(len, received.values())) >= w, 40 * EPOCH_MS / 1000)
    time.sleep(6 * EPOCH_MS / 1000)  # several epochs of resends: no more may land
    got = next(iter(received.values()), [])
    assert got == [b"m%d" % i for i in range(w)]
    lspnet.set_server_write_drop_percent(0)
    _wait(lambda: len(got) >= total, 40 * EPOCH_MS / 1000)
    assert got == [b"m%d" % i for i in range(total)]
    client.close()
    server.close()


def test_window_gap_fill_never_delivers_out_of_order():
    """The first half of a stream is dropped in flight: nothing surfaces
    until retransmits fill the gap, then everything in order."""
    count = 8
    params = _params(limit=10, w=count)
    server = lsp.Server(0, params)
    received = _collecting_server(server)
    client = lsp.Client("127.0.0.1", server.port, params)
    lspnet.set_client_write_drop_percent(100)
    for i in range(count // 2):
        client.write(b"m%d" % i)
    time.sleep(0.05)
    lspnet.set_client_write_drop_percent(0)
    for i in range(count // 2, count):
        client.write(b"m%d" % i)
    want = [b"m%d" % i for i in range(count)]
    deadline = time.monotonic() + 40 * EPOCH_MS / 1000
    while time.monotonic() < deadline:
        snap = list(next(iter(received.values()), []))
        assert snap == want[: len(snap)], f"out-of-order delivery: {snap}"
        if len(snap) == count:
            break
        time.sleep(0.005)
    assert next(iter(received.values())) == want
    client.close()
    server.close()


# --------------------------------------------------------------------------
# lsp3: close
# --------------------------------------------------------------------------


def test_close_drains_pending_sends_under_drop():
    """A burst beyond the window, then close at once, under a 25% write
    drop both ways: close blocks until every message is acked, and the
    server has them all, in order."""
    params = _params(limit=20, w=2, ms=50)
    server = lsp.Server(0, params)
    received = _collecting_server(server)
    client = lsp.Client("127.0.0.1", server.port, params)
    lspnet.set_write_drop_percent(25)
    total = 16
    for i in range(total):
        client.write(b"x%d" % i)
    client.close()
    lspnet.reset_faults()
    got = next(iter(received.values()), [])
    _wait(lambda: len(got) >= total, 1.0)
    assert got == [b"x%d" % i for i in range(total)]
    server.close()


def test_server_detects_client_death():
    params = _params(limit=3)
    server = lsp.Server(0, params)
    client = lsp.Client("127.0.0.1", server.port, params)
    client.write(b"hello")
    cid, _ = server.read()
    lspnet.set_client_write_drop_percent(100)  # the client goes silent
    t0 = time.monotonic()
    with pytest.raises(lsp.ConnLostError) as ei:
        while True:
            server.read()
    assert ei.value.conn_id == cid
    assert time.monotonic() - t0 < 40 * EPOCH_MS / 1000
    lspnet.reset_faults()
    client.close()
    server.close()


# --------------------------------------------------------------------------
# lsp4: partitions
# --------------------------------------------------------------------------


def _partition(on: bool) -> None:
    lspnet.set_write_drop_percent(100 if on else 0)


def test_bulk_streams_cross_a_partition_in_order():
    """Client→server and server→client streams written during a
    partition arrive, in order, after the heal."""
    n_clients, n_msgs = 2, 15
    params = _params(limit=60, w=8)
    server = lsp.Server(0, params)
    clients = [lsp.Client("127.0.0.1", server.port, params) for _ in range(n_clients)]
    cid_of = {}
    for idx, c in enumerate(clients):
        c.write(b"warm%d" % idx)
    for _ in range(n_clients):
        cid, payload = server.read()
        cid_of[int(payload[4:])] = cid
    received = _collecting_server(server)
    got = {idx: [] for idx in range(n_clients)}

    def reader(idx, c):
        while True:
            try:
                got[idx].append(c.read())
            except lsp.LspError:
                return

    for idx, c in enumerate(clients):
        _spawn(lambda i=idx, c=c: reader(i, c))
    _partition(True)
    for idx, c in enumerate(clients):
        for i in range(n_msgs):
            c.write(b"up%d" % i)
            server.write(cid_of[idx], b"down%d" % i)
    time.sleep(3 * EPOCH_MS / 1000)
    assert not any(received.values()) and not any(got.values())
    _partition(False)
    up = [b"up%d" % i for i in range(n_msgs)]
    down = [b"down%d" % i for i in range(n_msgs)]
    _wait(lambda: all(len(received.get(cid_of[i], [])) >= n_msgs and len(got[i]) >= n_msgs
                      for i in range(n_clients)), 50 * EPOCH_MS / 1000)
    for idx in range(n_clients):
        assert received[cid_of[idx]] == up
        assert got[idx] == down
    for c in clients:
        c.close()
    server.close()


def test_fast_close_during_partition_flushes_after_heal():
    params = _params(limit=60, w=8)
    server = lsp.Server(0, params)
    received = _collecting_server(server)
    client = lsp.Client("127.0.0.1", server.port, params)
    _partition(True)
    total = 20
    for i in range(total):
        client.write(b"f%d" % i)
    closed = []
    t = _spawn(lambda: (client.close(), closed.append(True)))
    time.sleep(3 * EPOCH_MS / 1000)
    assert not closed, "close returned during the partition"
    _partition(False)
    t.join(timeout=50 * EPOCH_MS / 1000)
    assert closed, "close never completed after the heal"
    got = next(iter(received.values()), [])
    _wait(lambda: len(got) >= total, 5.0)
    assert got == [b"f%d" % i for i in range(total)]
    server.close()


# --------------------------------------------------------------------------
# lsp5: variable length
# --------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["server", "client"])
def test_lengthened_payloads_truncated_to_size(side):
    params = _params(limit=5, w=4)
    server = lsp.Server(0, params)
    client = lsp.Client("127.0.0.1", server.port, params)
    client.write(b"hello")
    cid, _ = server.read()
    lspnet.set_msg_lengthening_percent(100)
    for i in range(6):
        msg = b"value-%d" % i
        if side == "server":
            client.write(msg)
            assert server.read() == (cid, msg)
        else:
            server.write(cid, msg)
            assert client.read() == msg
    lspnet.reset_faults()
    client.close()
    server.close()


def test_shortened_payloads_never_surface():
    params = _params(limit=5, w=4)
    server = lsp.Server(0, params)
    received = _collecting_server(server)
    client = lsp.Client("127.0.0.1", server.port, params)
    lspnet.set_msg_shortening_percent(100)
    for i in range(5):
        client.write(b"secret-%d" % i)
    time.sleep(4 * EPOCH_MS / 1000)
    assert not any(received.values()), received
    lspnet.reset_faults()  # retransmits now deliver everything
    _wait(lambda: received and len(next(iter(received.values()))) >= 5, 30 * EPOCH_MS / 1000)
    got = next(iter(received.values()))
    assert got == [b"secret-%d" % i for i in range(5)]
    client.close()
    server.close()


# --------------------------------------------------------------------------
# Across packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_cross_package_echo_under_drops(client_pkg):
    """A port client against the reference's server, and the reverse:
    15% write and 10% read drop on each side, each set through its own
    package's knobs, and every echo comes back in order."""
    mods = {"port": (lsp, lspnet), "ref": (ref_lsp, ref_lspnet)}
    server_pkg = "ref" if client_pkg == "port" else "port"
    s_lsp, s_net = mods[server_pkg]
    c_lsp, c_net = mods[client_pkg]
    server = s_lsp.Server(0, _params(limit=20, w=4, ms=50, mod=s_lsp))
    _echo_server(server, mod=s_lsp)
    s_net.set_server_write_drop_percent(15)
    s_net.set_server_read_drop_percent(10)
    c_net.set_client_write_drop_percent(15)
    c_net.set_client_read_drop_percent(10)
    try:
        _echo_clients(server.port, _params(limit=20, w=4, ms=50, mod=c_lsp), 2, 12,
                      seconds=20, mod=c_lsp)
    finally:
        s_net.reset_faults()
        c_net.reset_faults()
        server.close()


# --------------------------------------------------------------------------
# The echo runners
# --------------------------------------------------------------------------


def test_runner_echo_loop_round_trip(monkeypatch, capsys):
    params = _params(limit=5, w=4)
    server = lsp.Server(0, params)
    st = _spawn(lambda: srunner.run_server(server))
    try:
        client = lsp.Client("127.0.0.1", server.port, params)
        monkeypatch.setattr("sys.stdin", io.StringIO("hello world\nfoo\n"))
        crunner.run_client(client)
        client.close()
        assert capsys.readouterr().out.splitlines() == [
            "[echo] hello", "[echo] world", "[echo] foo"]
    finally:
        server.close()
        st.join(timeout=5)


def test_runner_mains_with_reference_flags(monkeypatch, capsys):
    """``srunner.main`` and ``crunner.main`` with the reference's flag sets,
    drop knobs included, on loopback."""
    created = {}
    real_server = lsp.Server

    def capturing_server(*a, **k):
        created["server"] = s = real_server(*a, **k)
        return s

    monkeypatch.setattr(lsp, "Server", capturing_server)
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    flags = ["-elim", "20", "-ems", "50", "-wsize", "4", "-rdrop", "10", "-wdrop", "10"]
    st = _spawn(lambda: srunner.main(["-port", str(port)] + flags))
    _wait(lambda: "server" in created, 5.0)
    assert "server" in created, "srunner.main never bound its server"
    assert lspnet.FAULTS.server_read_drop == lspnet.FAULTS.server_write_drop == 10
    monkeypatch.setattr("sys.stdin", io.StringIO("ping pong\n"))
    assert crunner.main(["-host", "127.0.0.1", "-port", str(port)] + flags) == 0
    assert lspnet.FAULTS.client_read_drop == lspnet.FAULTS.client_write_drop == 10
    assert capsys.readouterr().out.splitlines() == ["[echo] ping", "[echo] pong"]
    lspnet.reset_faults()
    created["server"].close()
    st.join(timeout=5)
    assert not st.is_alive()
