"""The port's top-level entry points (babble_tpu_torch/entry.py) against
__graft_entry__.py's, on the CPU. Tolerance: exact equality.

- entry(device="cpu") gives the JAX entry's step: fn(*args) equals the
  jitted JAX step on the same DAG, rounds of shape (256,);
- dryrun_multichip(8, device="cpu") passes parts (a), (b) and (d) on 8
  gloo ranks, and dryrun_multichip(4, device="cpu") with the 2 x 2
  ("dcn", "ici") mesh; the sharded run reaches the strongly-see
  wrapper at both sites in every rank;
- without a CUDA device, entry() and dryrun_multichip() given no device
  raise."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from babble_tpu_torch import dryrun_multichip, entry
from babble_tpu_torch.entry import default_backend


def test_entry_matches_jax():
    fn, args = entry(device="cpu")
    got = fn(*args)
    assert got[0].shape == (256,)
    assert all(a.device.type == "cpu" for a in args)
    jfn, jargs = jax_entry()
    want = jax.jit(jfn)(*jargs)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and (g == w).all()


@pytest.mark.parametrize("d", [8, 4])
def test_dryrun_multichip(d, capsys):
    rec = dryrun_multichip(d, device="cpu")
    assert rec["ranks"] == d and rec["backend"] == "gloo" and rec["n"] == 64
    assert rec["e"] == 5000 and rec["decided"] > 0
    assert rec["mesh"] == ((2, d // 2), ("dcn", "ici"))
    sites = rec["run"]["sites"]
    assert len(sites) == d
    assert all(s["rounds"]["calls"] > 0 and s["fame"]["calls"] == 1 for s in sites)
    out = capsys.readouterr().out
    assert "dryrun_multichip ok" in out and f"2x{d // 2} dcn*ici mesh index a-major" in out


def test_default_backend():
    assert default_backend(8, "cpu") == "gloo"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)
