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
runs consensus on `TorchHashgraph`. A node runs in a process of its own
through the CLI (`python -m babble_tpu_torch.cli keygen|run|version`):
TCP gossip (net/tcp_transport.py), the sqlite `FileStore`, the socket
and journal app proxies (proxy/), and the HTTP service (service/) with
/Stats, /metrics and /debug/*; `dummy.py` is the chat client an app
runs beside it. The consensus pipeline also runs memory-sharded over
rank processes on torch.distributed (`spawn_ranks`, parallel.py;
`ops.sharded_pipeline`), and entry.py holds the top-level entry points,
`entry` and `dryrun_multichip`.

The package imports torch, numpy and the standard library only (and
`cryptography` when it is installed). Entry points run on the CUDA
device unless the caller passes device="cpu"; on the CPU every kernel
wrapper takes its plain PyTorch version.
"""

from .devices import resolve_device
from .entry import dryrun_multichip, entry
from .parallel import spawn_ranks


def _read_version() -> str:
    """The version from the installed distribution's metadata, or in a
    checkout from the adjacent pyproject.toml (one source for both
    packages)."""
    from importlib.metadata import PackageNotFoundError, version

    try:
        return version("babble-tpu")
    except PackageNotFoundError:
        pass
    try:
        import os
        import re

        pyproject = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "pyproject.toml")
        with open(pyproject, encoding="utf-8") as f:
            m = re.search(r'^version\s*=\s*"([^"]+)"', f.read(), re.M)
        if m:
            return m.group(1)
    except OSError:
        pass
    return "0+unknown"


__version__ = _read_version()

__all__ = ["resolve_device", "spawn_ranks", "entry", "dryrun_multichip", "__version__"]
