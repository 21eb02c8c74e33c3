"""Hand-written CUDA kernels for Hopper (counterpart of
babble_tpu/ops/pallas_kernels.py).

`strongly_see_counts` replaces the JAX package's one Pallas kernel,
`pallas_kernels.strongly_see_counts`: counts[x, w] = #{i : la_x[x, i]
>= fd_w[w, i]}. The source is csrc/strongly_see.cu, which says what
bounds it on the H100 and what its tiling does about that.

The library is compiled with nvcc for sm_90a into build/kernels/ at the
repository root on first use (a few seconds: it has a plain C entry
point and includes no PyTorch header) and loaded with ctypes. The file
name carries a hash of the source and the flags, so an edited source is
never served by a stale build.

On a CUDA tensor the wrapper launches the kernel or raises; it never
reaches the plain version. On a CPU tensor it takes the plain version,
`strongly_see_counts_ref` (kernels.strongly_see_counts_chunked), which
is also what chip_smoke.py holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from .kernels import strongly_see_counts_chunked as strongly_see_counts_ref

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "strongly_see.cu",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_MAX_GRID_Y = 65535  # rows of output tiles per launch
_TILE = 64

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")


def build() -> dict:
    """Compile the kernel library if this source and these flags have
    no build yet. Returns {"path", "seconds", "log"}: the library, the
    nvcc time (0 for an existing build) and nvcc's output, ptxas's
    register and shared-memory report included. The output is written
    under a temporary name and renamed, so concurrent builds never
    load a half-written file."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libbabble_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return {"path": lib_path, "seconds": 0.0, "log": "(already built)"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return {"path": lib_path, "seconds": seconds,
            "log": (proc.stdout + proc.stderr).strip()}


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()["path"]))
            fn = lib.babble_strongly_see_counts
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_operand(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def strongly_see_counts(la_x: torch.Tensor, fd_w: torch.Tensor) -> torch.Tensor:
    """counts[x, w] = #{i : la_x[x, i] >= fd_w[w, i]} as int32 [M, W].

    la_x: [M, n] int32, fd_w: [W, n] int32, both contiguous and on one
    device. CUDA tensors go to the hand-written kernel (one launch,
    counted in `strongly_see_counts.launches`); CPU tensors go to the
    plain version."""
    _check_operand("la_x", la_x)
    _check_operand("fd_w", fd_w)
    if la_x.shape[1] != fd_w.shape[1]:
        raise ValueError(
            f"participant axes differ: {la_x.shape[1]} vs {fd_w.shape[1]}")
    if la_x.device != fd_w.device:
        raise ValueError(f"operands on {la_x.device} and {fd_w.device}")
    if la_x.device.type == "cpu":
        return strongly_see_counts_ref(la_x, fd_w)
    if la_x.device.type != "cuda":
        raise ValueError(f"no kernel for device {la_x.device}")
    m, n = la_x.shape
    w = fd_w.shape[0]
    if -(-m // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"la_x has {m} rows; at most {_MAX_GRID_Y * _TILE}")
    out = torch.empty((m, w), dtype=torch.int32, device=la_x.device)
    if m == 0 or w == 0:
        return out
    lib = _load()
    with torch.cuda.device(la_x.device):
        stream = torch.cuda.current_stream(la_x.device).cuda_stream
        err = lib.babble_strongly_see_counts(
            la_x.data_ptr(), fd_w.data_ptr(), out.data_ptr(), m, w, n, stream)
    if err != 0:
        raise RuntimeError(f"strongly_see_counts launch failed: CUDA error {err}")
    strongly_see_counts.launches += 1
    return out


strongly_see_counts.launches = 0
