"""The port's app proxies (babble_tpu_torch/proxy, babble_tpu_torch/dummy.py):
tests/test_proxy.py's socket round trip and dummy-client commit log,
tests/test_durability.py's journal (FileAppProxy) restart dedupe and
torn final line, and JSON-RPC parity with the reference: the port's
babble side against the reference's app side, and the reverse.
Tolerance: exact equality (transactions, rounds, block hashes)."""

from __future__ import annotations

import json
import time

import pytest

from babble_tpu.hashgraph.block import Block as RefBlock
from babble_tpu.proxy import SocketAppProxy as RefSocketAppProxy
from babble_tpu.proxy import SocketBabbleProxy as RefSocketBabbleProxy
from babble_tpu_torch.dummy import DummyClient
from babble_tpu_torch.hashgraph.block import Block
from babble_tpu_torch.proxy import FileAppProxy, SocketAppProxy, SocketBabbleProxy


def socket_pair(app_cls, babble_cls):
    """The babble side binds first, the app side points at it, then the
    babble side learns where the app's server is."""
    app_proxy = app_cls("127.0.0.1:0", "127.0.0.1:0", timeout=1.0)
    babble_proxy = babble_cls(app_proxy.bind_addr, "127.0.0.1:0", timeout=1.0)
    app_proxy.set_client_addr(babble_proxy.bind_addr)
    return app_proxy, babble_proxy


PAIRS = {
    "port": (SocketAppProxy, SocketBabbleProxy, Block),
    "port_node-ref_app": (SocketAppProxy, RefSocketBabbleProxy, Block),
    "ref_node-port_app": (RefSocketAppProxy, SocketBabbleProxy, RefBlock),
}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_socket_proxy_roundtrip(pair):
    """tests/test_proxy.py::test_socket_proxy_roundtrip; across the two
    packages, the JSON-RPC parity: what one side sends, the other side
    of the other package receives unchanged."""
    app_cls, babble_cls, block_cls = PAIRS[pair]
    app_proxy, babble_proxy = socket_pair(app_cls, babble_cls)
    try:
        tx = b"the test transaction"
        babble_proxy.submit_tx(tx)
        assert app_proxy.submit_ch().get(timeout=1.0) == tx

        block = block_cls(7, [b"tx one", b"tx two"])
        app_proxy.commit_block(block)
        got = babble_proxy.commit_ch().get(timeout=1.0)
        assert got.round_received == 7
        assert got.transactions == [b"tx one", b"tx two"]
        assert got.hash() == block.hash() and got.marshal() == block.marshal()

        # nil transactions survive (Go nil slice -> null)
        app_proxy.commit_block(block_cls(8, None))
        assert babble_proxy.commit_ch().get(timeout=1.0).transactions is None
    finally:
        app_proxy.close()
        babble_proxy.close()


def test_dummy_client_commit_log(tmp_path):
    app_proxy = SocketAppProxy("127.0.0.1:0", "127.0.0.1:0", timeout=1.0)
    log = str(tmp_path / "messages.txt")
    client = DummyClient(app_proxy.bind_addr, "127.0.0.1:0", log_path=log)
    app_proxy.set_client_addr(client.proxy.bind_addr)
    try:
        client.submit_tx(b"client1: hello")
        assert app_proxy.submit_ch().get(timeout=1.0) == b"client1: hello"
        app_proxy.commit_block(Block(0, [b"client1: hello", b"client2: hi"]))
        deadline = time.monotonic() + 5.0
        while len(client.state.get_committed_transactions()) < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert client.state.get_committed_transactions() == ["client1: hello", "client2: hi"]
        with open(log) as f:
            assert f.read() == "client1: hello\nclient2: hi\n"
    finally:
        client.close()
        app_proxy.close()


def test_file_app_proxy_journal_and_restart_dedupe(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    p1 = FileAppProxy(path)
    p1.commit_block(Block(3, [b"a", b"b"]))
    p1.commit_block(Block(5, [b"c"]))
    assert p1.last_round() == 5
    assert p1.committed_transactions() == [b"a", b"b", b"c"]
    p1.close()

    # restart: redelivery at or below the journal's tail is dropped
    p2 = FileAppProxy(path)
    assert p2.last_round() == 5
    p2.commit_block(Block(5, [b"c"]))
    p2.commit_block(Block(4, [b"stale"]))
    p2.commit_block(Block(7, [b"d"]))
    assert p2.committed_transactions() == [b"a", b"b", b"c", b"d"]
    p2.close()
    with open(path) as fh:
        assert [json.loads(line)["round"] for line in fh] == [3, 5, 7]


def test_file_app_proxy_ignores_torn_final_line(tmp_path):
    path = str(tmp_path / "torn.jsonl")
    p1 = FileAppProxy(path)
    p1.commit_block(Block(2, [b"a"]))
    p1.close()
    with open(path, "a") as fh:
        fh.write('{"round": 9, "txs": ["ff')  # killed mid-write
    p2 = FileAppProxy(path)
    assert p2.last_round() == 2
    p2.commit_block(Block(3, [b"b"]))
    assert p2.committed_transactions() == [b"a", b"b"]
    p2.close()


def test_file_app_proxy_journal_read_by_reference(tmp_path):
    """A journal the port wrote restarts the reference's FileAppProxy
    with the same tail and transactions, and the reverse."""
    from babble_tpu.proxy import FileAppProxy as RefFileAppProxy

    for writer, reader in ((FileAppProxy, RefFileAppProxy), (RefFileAppProxy, FileAppProxy)):
        path = str(tmp_path / f"{writer.__module__}.jsonl")
        w = writer(path)
        w.commit_block(Block(1, [b"x", b"y"]))
        w.commit_block(Block(4, None))
        w.commit_block(Block(6, [b"z"]))
        w.close()
        r = reader(path)
        assert r.last_round() == 6
        assert r.committed_transactions() == [b"x", b"y", b"z"]
        r.close()
