"""Device choice for the port (counterpart of babble_tpu/devices.py).

The fame contraction (ops/kernels.py decide_fame) and the closure
squarings (ops/closure.py) are 0/1 float32 products whose sums stay
below 2^24, exact only while nothing rounds them to TF32. Both TF32
switches are therefore pinned off when the package is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default)
    and absent; the CPU is used only when the caller passes it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "babble_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the host")
    return dev
