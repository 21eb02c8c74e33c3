"""babble_tpu_torch: the babble consensus engine on PyTorch and CUDA.

The counterpart of the JAX package `babble_tpu`, ported slice by slice
for one NVIDIA H100. It holds the one-shot consensus pipeline (DAG
tensors -> coordinates -> first descendants -> rounds/witnesses ->
fame -> round received and median timestamps -> the total order), the
live node's incremental engine (ops/incremental.py), and the
hand-written CUDA kernel for the strongly-see compare-count.

The package imports torch and numpy only. Entry points run on the
CUDA device unless the caller passes device="cpu"; on the CPU every
kernel wrapper takes its plain PyTorch version.
"""

from .devices import resolve_device

__all__ = ["resolve_device"]
