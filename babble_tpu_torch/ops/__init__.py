"""The one-shot consensus pipeline on PyTorch (counterpart of
babble_tpu/ops): DAG tensors, the per-stage kernels, block closure,
round frontier, the pipeline entry point and the host finish."""

from .dag import DagTensors, dag_from_arrays, synthetic_dag
from .engine import consensus_order
from .pipeline import run_pipeline

__all__ = [
    "DagTensors",
    "dag_from_arrays",
    "synthetic_dag",
    "consensus_order",
    "run_pipeline",
]
