"""babble_tpu_torch: the babble consensus engine on PyTorch and CUDA.

The counterpart of the JAX package `babble_tpu`, ported slice by slice
for one NVIDIA H100. It holds the one-shot consensus pipeline (DAG
tensors -> coordinates -> first descendants -> rounds/witnesses ->
fame -> round received and median timestamps -> the total order, with
`ops.run_consensus_batch` over signed events), the live node's
incremental engine (ops/incremental.py), the hand-written CUDA kernel
for the strongly-see compare-count, and the host surface a node drives:
Go-compatible JSON (gojson), ECDSA P-256 (crypto), the hashgraph models
and in-memory store, the host `Hashgraph` and `TorchHashgraph`, which
runs consensus on the incremental engine (hashgraph/), and the node on
top: `Core` and `Node` (node/) with the in-memory transport (net/), the
in-process app proxy (proxy/), the admission plane (service/) and the
telemetry they record into (telemetry/), where `Core(engine="torch")`
runs consensus on `TorchHashgraph`.

The package imports torch, numpy and the standard library only (and
`cryptography` when it is installed). Entry points run on the CUDA
device unless the caller passes device="cpu"; on the CPU every kernel
wrapper takes its plain PyTorch version.
"""

from .devices import resolve_device

__all__ = ["resolve_device"]
