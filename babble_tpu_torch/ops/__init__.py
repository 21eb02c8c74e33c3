"""The consensus pipeline on PyTorch (counterpart of babble_tpu/ops):
DAG tensors, the per-stage kernels, block closure, round frontier, the
one-shot pipeline entry points and their host finish (`run_consensus_batch`
over signed events), the live node's incremental engine, and the
pipeline memory-sharded over torch.distributed ranks (`sharded_pipeline`)."""

from .dag import DagTensors, build_dag, dag_from_arrays, synthetic_dag
from .engine import BatchConsensusResult, consensus_order, run_consensus_batch
from .incremental import IncrementalEngine, PendingPass, RunDelta
from .pipeline import consensus_pipeline, run_pipeline
from .sharded import sharded_pipeline

__all__ = [
    "DagTensors",
    "build_dag",
    "dag_from_arrays",
    "synthetic_dag",
    "BatchConsensusResult",
    "consensus_order",
    "run_consensus_batch",
    "IncrementalEngine",
    "PendingPass",
    "RunDelta",
    "consensus_pipeline",
    "run_pipeline",
    "sharded_pipeline",
]
