"""The port's CLI (python -m babble_tpu_torch.cli): tests/test_cli.py's
version, keygen and localhost testnet on the port, the CLI's refusals
(--engine tpu, and run with no GPU and no --engine_device), a node
run with --device_verify on --engine_device cpu, and one with
--engine_mesh 2 (its engine in two shards).

The testnet: 3 processes of `run --engine torch --engine_device cpu`
on free localhost ports, TCP gossip, socket app proxies with one
DummyClient each; it gates on >= 5 committed transactions, prefix-equal
client logs and /Stats answering with engine_state "device". Each
child runs with OMP_NUM_THREADS=1 so that three CPU engines do not
oversubscribe the cores."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

import torch

from babble_tpu_torch.dummy import DummyClient
from chip_smoke import cli_env, free_ports

BOOT_S = 60.0
COMMIT_S = 90.0


def run_cli(*args, timeout=60):
    return subprocess.run([sys.executable, "-m", "babble_tpu_torch.cli", *args],
                          capture_output=True, text=True, timeout=timeout, env=cli_env())


def make_datadirs(tmp_path, n):
    """keygen n nodes and write one peers.json on free ports; returns
    (datadirs, [(node, proxy, client, service) ports])."""
    ports = free_ports(4 * n)
    addrs = [ports[4 * i:4 * i + 4] for i in range(n)]
    datadirs, pubs = [], []
    for i in range(n):
        d = str(tmp_path / f"node{i}")
        out = run_cli("keygen", "--datadir", d)
        assert out.returncode == 0, out.stderr
        pubs.append(out.stdout.split("PublicKey: ")[1].split()[0])
        datadirs.append(d)
    peers = [{"NetAddr": f"127.0.0.1:{addrs[i][0]}", "PubKeyHex": pubs[i]} for i in range(n)]
    for d in datadirs:
        with open(os.path.join(d, "peers.json"), "w") as f:
            json.dump(peers, f)
    return datadirs, addrs


def tail(f):
    f.seek(0)
    return f.read()[-2000:]


def wait_port(port, deadline):
    while time.monotonic() < deadline:
        with socket.socket() as s:
            s.settimeout(0.5)
            if s.connect_ex(("127.0.0.1", port)) == 0:
                return True
        time.sleep(0.2)
    return False


def test_version():
    out = run_cli("version")
    assert out.returncode == 0 and out.stdout.strip()
    import babble_tpu_torch

    assert out.stdout.strip() == babble_tpu_torch.__version__


DAEMON_TORCH_EXIT = """
import runpy, sys, threading, torch
a = torch.randn(1500, 1500)
running = threading.Event()

def work():
    while True:
        running.set()
        a @ a

threading.Thread(target=work, daemon=True).start()
running.wait()
sys.argv = ["babble_tpu_torch.cli", "version"]
runpy.run_module("babble_tpu_torch.cli", run_name="__main__")
"""


def test_exit_with_a_daemon_thread_in_torch():
    """The program exits 0 while a daemon thread is inside a torch call
    (as a node's gossip threads, the engine's stager and device verify
    may be at SIGTERM): finalizing the interpreter would abort it."""
    out = subprocess.run([sys.executable, "-c", DAEMON_TORCH_EXIT], capture_output=True,
                         text=True, timeout=120, env=cli_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert "terminate called" not in out.stderr
    import babble_tpu_torch

    assert out.stdout.strip() == babble_tpu_torch.__version__


def test_keygen(tmp_path):
    datadir = str(tmp_path / "keys")
    out = run_cli("keygen", "--datadir", datadir)
    assert out.returncode == 0 and "PublicKey: 0x" in out.stdout
    with open(os.path.join(datadir, "priv_key.pem")) as f:
        assert "EC PRIVATE KEY" in f.read()
    assert "PRIVATE KEY" in run_cli("keygen").stdout


@pytest.mark.parametrize("flags,message", [
    (["--engine", "tpu"], "engine 'tpu' is the JAX package's device engine"),
], ids=["engine_tpu"])
def test_run_refuses(flags, message, tmp_path):
    """Core's refusals reach the user as an error and a non-zero exit."""
    datadirs, addrs = make_datadirs(tmp_path, 1)
    out = run_cli("run", "--datadir", datadirs[0], "--node_addr", f"127.0.0.1:{addrs[0][0]}",
                  "--no_client", "--service_addr", f"127.0.0.1:{addrs[0][3]}",
                  "--engine_device", "cpu", *flags)
    assert out.returncode != 0
    assert message in out.stderr


def test_run_without_a_gpu_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    datadirs, addrs = make_datadirs(tmp_path, 1)
    out = run_cli("run", "--datadir", datadirs[0], "--node_addr", f"127.0.0.1:{addrs[0][0]}",
                  "--no_client", "--service_addr", f"127.0.0.1:{addrs[0][3]}")
    assert out.returncode != 0
    assert "runs on a CUDA device and none is available" in out.stderr


def test_run_device_verify_answers_stats(tmp_path):
    """run --device_verify --engine_device cpu boots (the P-256 verify
    on the CPU's plain ladder) and answers /Stats; SIGTERM exits 0."""
    datadirs, addrs = make_datadirs(tmp_path, 1)
    node, proxy, client, service = addrs[0]
    with open(tmp_path / "node0.stderr", "w+") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "babble_tpu_torch.cli", "run", "--datadir", datadirs[0],
             "--device_verify", "--engine_device", "cpu", "--no_client",
             "--node_addr", f"127.0.0.1:{node}", "--proxy_addr", f"127.0.0.1:{proxy}",
             "--client_addr", f"127.0.0.1:{client}", "--service_addr", f"127.0.0.1:{service}",
             "--heartbeat", "50", "--log_level", "error"],
            env=cli_env(), stdout=subprocess.DEVNULL, stderr=log)
        try:
            up = wait_port(service, time.monotonic() + BOOT_S)
            assert proc.poll() is None and up, tail(log)
            with urllib.request.urlopen(f"http://127.0.0.1:{service}/Stats", timeout=5) as r:
                stats = json.loads(r.read())
            assert stats["engine_state"] == "device"
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, tail(log)


def test_run_engine_mesh_answers_capacity(tmp_path):
    """run --engine_mesh 2 --engine_device cpu over 2 validators boots
    with its engine in 2 shards (node 0 alone: the service answers
    without its peer); /debug/capacity names them; SIGTERM exits 0."""
    datadirs, addrs = make_datadirs(tmp_path, 2)
    node, proxy, client, service = addrs[0]
    with open(tmp_path / "node0.stderr", "w+") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "babble_tpu_torch.cli", "run", "--datadir", datadirs[0],
             "--engine_mesh", "2", "--engine_device", "cpu", "--no_client",
             "--node_addr", f"127.0.0.1:{node}", "--proxy_addr", f"127.0.0.1:{proxy}",
             "--client_addr", f"127.0.0.1:{client}", "--service_addr", f"127.0.0.1:{service}",
             "--heartbeat", "50", "--log_level", "error"],
            env=cli_env(), stdout=subprocess.DEVNULL, stderr=log)
        try:
            up = wait_port(service, time.monotonic() + BOOT_S)
            assert proc.poll() is None and up, tail(log)
            with urllib.request.urlopen(f"http://127.0.0.1:{service}/debug/capacity",
                                        timeout=5) as r:
                engine = json.loads(r.read())["engine"]
            assert engine["mesh_shards"] == 2 and engine["mesh_devices"] == 1
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, tail(log)


def test_cli_testnet(tmp_path):
    n = 3
    datadirs, addrs = make_datadirs(tmp_path, n)
    procs, clients = [], []
    logs = [open(tmp_path / f"node{i}.stderr", "w+") for i in range(n)]
    try:
        for i, (node, proxy, client, service) in enumerate(addrs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "babble_tpu_torch.cli", "run",
                 "--datadir", datadirs[i], "--engine", "torch", "--engine_device", "cpu",
                 "--node_addr", f"127.0.0.1:{node}", "--proxy_addr", f"127.0.0.1:{proxy}",
                 "--client_addr", f"127.0.0.1:{client}",
                 "--service_addr", f"127.0.0.1:{service}",
                 "--heartbeat", "50", "--log_level", "error"],
                env=cli_env(), stdout=subprocess.DEVNULL, stderr=logs[i]))
        boot_deadline = time.monotonic() + BOOT_S
        for i, (_, proxy, client, _) in enumerate(addrs):
            up = wait_port(proxy, boot_deadline)
            assert procs[i].poll() is None and up, f"node {i} not up: {tail(logs[i])}"
            clients.append(DummyClient(f"127.0.0.1:{proxy}", f"127.0.0.1:{client}"))

        deadline = time.monotonic() + COMMIT_S
        committed, k = [], 0
        while time.monotonic() < deadline:
            try:
                clients[k % n].submit_tx(f"client{k % n}: msg {k}".encode())
            except OSError:
                pass  # the node is still warming up
            k += 1
            committed = clients[0].state.get_committed_transactions()
            if len(committed) >= 5:
                break
            time.sleep(0.05)
        assert len(committed) >= 5, "testnet never committed transactions"

        time.sleep(1.0)
        chats = [c.state.get_committed_transactions() for c in clients]
        m = min(len(chat) for chat in chats)
        assert m > 0
        for chat in chats[1:]:
            assert chat[:m] == chats[0][:m]

        with urllib.request.urlopen(f"http://127.0.0.1:{addrs[0][3]}/Stats", timeout=5) as r:
            stats = json.loads(r.read())
        assert stats["state"] == "Babbling" and stats["engine_state"] == "device"
        assert stats["engine_failovers"] == "0"
        assert int(stats["consensus_transactions"]) > 0
    finally:
        for c in clients:
            c.close()
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * n, [tail(f) for f in logs]
    for f in logs:
        f.close()
