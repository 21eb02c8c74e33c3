"""The consensus pipeline on PyTorch (counterpart of babble_tpu/ops):
DAG tensors, the per-stage kernels, block closure, round frontier, the
one-shot pipeline entry point and its host finish, and the live node's
incremental engine."""

from .dag import DagTensors, dag_from_arrays, synthetic_dag
from .engine import consensus_order
from .incremental import IncrementalEngine, PendingPass, RunDelta
from .pipeline import run_pipeline

__all__ = [
    "DagTensors",
    "dag_from_arrays",
    "synthetic_dag",
    "consensus_order",
    "IncrementalEngine",
    "PendingPass",
    "RunDelta",
    "run_pipeline",
]
