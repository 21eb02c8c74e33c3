"""The port's pipeline entry point and host finish
(babble_tpu_torch/ops/pipeline.py, engine.py, dag.py) against the JAX
package, on the CPU. Tolerance: exact equality of every array.

- synthetic_dag gives the JAX package's arrays for the same seed;
- run_pipeline equals the JAX run_pipeline for the same engine, in all
  six outputs;
- the consensus order equals the JAX run_consensus_batch order on the
  reference fixtures (S key: the int64 dense rank of each event's
  big-int S);
- without a CUDA device, an entry point given no device raises."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from babble_tpu.ops import build_dag, run_consensus_batch
from babble_tpu.ops.dag import synthetic_dag as jax_synthetic_dag
from babble_tpu.ops.pipeline import run_pipeline as jax_run_pipeline
from babble_tpu_torch import resolve_device
from babble_tpu_torch.ops import closure, consensus_order, run_pipeline
from babble_tpu_torch.ops.dag import dag_from_arrays, synthetic_dag

from fixtures import build_consensus_graph, build_funky_graph, build_round_graph
from test_torch_kernels import CARRIED_FIELDS, carry

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

ARRAYS = ("self_parent", "other_parent", "creator", "index", "coin", "ts_rank",
          "ts_values", "levels", "chain", "chain_len", "chain_rank", "root_round")
OUTPUTS = ("rounds", "witness", "wt", "famous", "rr", "cts")


@pytest.mark.parametrize("n,e,seed,width", [(4, 60, 0, None), (8, 400, 7, None),
                                            (16, 1200, 2, 5)])
def test_synthetic_dag_matches_jax(n, e, seed, width):
    dag, s_rank = synthetic_dag(n, e, seed=seed, max_level_width=width)
    jdag, js_rank = jax_synthetic_dag(n, e, seed=seed, max_level_width=width)
    assert (dag.n, dag.e, dag.depth) == (jdag.n, jdag.e, jdag.depth)
    assert (dag.super_majority, dag.max_rounds) == (jdag.super_majority, jdag.max_rounds)
    for k in ARRAYS:
        a, b = getattr(dag, k), getattr(jdag, k)
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all(), k
    assert (s_rank == js_rank).all()


@pytest.mark.parametrize("engine", ["wavefront", "closure"])
@pytest.mark.parametrize("n,e,seed", [(4, 60, 0), (8, 400, 7), (16, 1200, 2)])
def test_run_pipeline_matches_jax(engine, n, e, seed):
    dag, _ = synthetic_dag(n, e, seed=seed)
    jdag, _ = jax_synthetic_dag(n, e, seed=seed)
    got = run_pipeline(dag, engine=engine, device="cpu")
    want = jax_run_pipeline(jdag, engine=engine)
    for name, g, w in zip(OUTPUTS, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        assert (g == w).all(), name


def _s_key(events):
    """int64 dense rank of each event's big-int S: orders like S."""
    s = [int(ev.s) for ev in events]
    rank = {v: i for i, v in enumerate(sorted(set(s)))}
    return np.array([rank[v] for v in s], dtype=np.int64)


@pytest.mark.parametrize(
    "build", [build_round_graph, build_consensus_graph, build_funky_graph],
    ids=["round", "consensus", "funky"])
def test_consensus_order_matches_batch(build):
    _, b = build()
    want = run_consensus_batch(b.ordered_events, b.participants())
    jdag = build_dag(b.ordered_events, b.participants())
    dag = carry(jdag)
    out = run_pipeline(dag, device="cpu")
    ids = consensus_order(out[4], out[5], _s_key(jdag.events))
    assert [dag.hexes[i] for i in ids] == want.consensus_order
    assert len(ids) > 0 or build is build_round_graph  # round decides nothing
    for name, g, w in zip(OUTPUTS, out, (want.rounds, want.witness, want.witness_table,
                                         want.famous, want.round_received, want.cts_rank)):
        assert (g.numpy() == np.asarray(w)).all(), name


def test_consensus_order_keys():
    """Round received first, then timestamp rank, then S; undecided
    events are left out; full ties keep id order."""
    rr = np.array([2, -1, 1, 1, 2, 1], np.int32)
    cts = np.array([0, 5, 3, 3, 0, 1], np.int32)
    s = np.array([9, 0, 4, 2, 9, 7], np.int64)
    assert consensus_order(torch.from_numpy(rr), cts, s).tolist() == [5, 3, 2, 0, 4]


def test_dag_from_arrays_copies_and_checks():
    jdag, _ = jax_synthetic_dag(4, 60, seed=0)
    dag = carry(jdag)
    assert dag.self_parent is not jdag.self_parent
    dag.self_parent[0] = 7
    assert jdag.self_parent[0] == -1
    fields = {k: getattr(jdag, k) for k in CARRIED_FIELDS}
    fields["creator"] = fields["creator"][:-1]
    with pytest.raises(ValueError):
        dag_from_arrays(**fields)


def test_entry_points_raise_without_cuda():
    """With no device named the port runs on CUDA; where there is none
    it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    dag, _ = synthetic_dag(4, 60, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pipeline(dag)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pipeline(dag, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        closure.coordinates(dag)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_unknown_engine_raises():
    dag, _ = synthetic_dag(4, 60, seed=0)
    with pytest.raises(ValueError):
        run_pipeline(dag, engine="nope", device="cpu")


def test_tf32_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
