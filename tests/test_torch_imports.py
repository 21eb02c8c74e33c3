"""Import hygiene of the port: babble_tpu_torch and chip_smoke.py import
neither jax nor any module of the JAX package babble_tpu, at run time or
in their sources. Also: chip_smoke.py refuses to run without a CUDA
device or outside the repository."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "babble_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_CHILD = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, %(root)r)
import babble_tpu_torch
names = [m.name for m in pkgutil.walk_packages(babble_tpu_torch.__path__, "babble_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "babble_tpu")
             or m.startswith(("jax.", "jaxlib.", "babble_tpu.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "babble_tpu")


def test_runtime_import_closure_is_clean():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", _CHILD % {"root": str(ROOT)}],
                         capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "babble_tpu_torch.ops.hopper_kernels" in res["modules"]
    assert "babble_tpu_torch.ops.p256" in res["modules"]
    assert "babble_tpu_torch.ops.sim" in res["modules"]
    assert "babble_tpu_torch.ops.sharded" in res["modules"]
    assert "babble_tpu_torch.parallel" in res["modules"]
    assert "babble_tpu_torch.entry" in res["modules"]
    assert "babble_tpu_torch.hashgraph.torch_graph" in res["modules"]
    for name in ("node.node", "node.core", "net.inmem_transport", "service.ingress",
                 "telemetry.promtext", "telemetry.dagdump", "telemetry.tracemerge",
                 "hashgraph.file_store", "net.tcp_transport", "net.faulty_transport",
                 "proxy.jsonrpc", "proxy.socket_app_proxy", "proxy.socket_babble_proxy",
                 "proxy.file_app_proxy", "service.service", "dummy", "cli"):
        assert f"babble_tpu_torch.{name}" in res["modules"], name
    assert res["bad"] == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, timeout=120, cwd=cwd)


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
