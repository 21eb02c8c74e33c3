"""Hand-written CUDA kernels for Hopper (counterpart of
babble_tpu/ops/pallas_kernels.py and of the jitted ladder of
babble_tpu/ops/p256.py).

csrc/strongly_see.cu replaces the JAX package's one Pallas kernel,
`pallas_kernels.strongly_see_counts`; the source says what bounds it on
the H100 and what its tiling does about that. Two entry points reach
it:

- `strongly_see_counts(la_x, fd_w)`: the Pallas kernel's contract,
  counts[x, w] = #{i : la_x[x, i] >= fd_w[w, i]};
- `strongly_see_gathered(x_tab, xs, f_tab, w_tab, wrow, sm, mode)`:
  the same count with the rows gathered inside the kernel, a batch of
  witness rows, and the threshold applied on the chip ("matrix": the
  [M, W] strongly-see matrix, "tally": the per-row number of witnesses
  strongly seen). Every strongly-see site of the pipeline calls it:
  decide_fame and compute_rounds (ops/kernels.py), the frontier probe
  and the skip correction (ops/frontier.py), which the incremental
  engine (ops/incremental.py) reaches too.

csrc/p256.cu is the P-256 dual-window ladder of device ECDSA verify;
its wrapper, `p256.dual_window`, lives beside its plain version in
ops/p256.py and launches it through `launch_p256_dual_window`.

Each source is compiled with nvcc for sm_90a into a library of its own
under build/kernels/ at the repository root on first use (seconds: a
plain C entry point, no PyTorch header) and loaded with ctypes. The
file name carries a hash of the source and the flags, so an edited
source is never served by a stale build.

On a CUDA tensor a wrapper launches the kernel or raises; it never
reaches the plain version. On a CPU tensor it takes the plain version
(`strongly_see_counts_ref` = kernels.strongly_see_counts_chunked,
`strongly_see_gathered_ref` = kernels.strongly_see_gathered_ref),
which is also what chip_smoke.py holds the kernel against on the card.
Each wrapper counts its launches, under one lock (`count_launch`):
`strongly_see_counts.launches` (an int), `strongly_see_gathered.launches`
(a dict by mode) and `p256.dual_window.launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch

from .kernels import strongly_see_counts_chunked as strongly_see_counts_ref
from .kernels import strongly_see_gathered_ref

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "strongly_see.cu", _PKG / "csrc" / "p256.cu")
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_MAX_GRID_Y = 65535  # witness tiles per launch
_TILE = 64
# The kernel's epilogues (csrc/strongly_see.cu): 0 is COUNTS.
_COUNTS = 0
MODES = {"matrix": 1, "tally": 2}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
# Each library's entry point and its argument types.
_ENTRY = {
    "strongly_see.cu": ("babble_strongly_see_gathered",
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    "p256.cu": ("babble_p256_dual_window",
                [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")


def build(source: Optional[Path] = None) -> dict:
    """Compile one kernel library (`source`, one of SOURCES) if this
    source and these flags have no build yet; with no source, every
    library, one nvcc each, all started together. Returns {"path",
    "seconds", "log"} for one source (the library, the nvcc time, 0 for
    an existing build, and nvcc's output, ptxas's register, spill and
    shared-memory report included), and {source name: that} for all.
    The output is written under a temporary name and renamed, so
    concurrent builds never load a half-written file."""
    if source is None:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            return dict(zip((s.name for s in SOURCES), pool.map(build, SOURCES)))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    lib_path = BUILD_DIR / f"libbabble_{source.stem}_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return {"path": lib_path, "seconds": 0.0, "log": "(already built)"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return {"path": lib_path, "seconds": seconds,
            "log": (proc.stdout + proc.stderr).strip()}


def _load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>, built and loaded once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(_PKG / "csrc" / name)["path"]))
            entry, argtypes = _ENTRY[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def count_launch(wrapper, key: Optional[str] = None) -> None:
    """Add one to a wrapper's launch count (`wrapper.launches`, or its
    entry `key`) under one lock: engines, gossip threads and verify
    calls launch from several threads at once."""
    with _count_lock:
        if key is None:
            wrapper.launches += 1
        else:
            wrapper.launches[key] += 1


def _check_operand(name: str, t: torch.Tensor, dim: int = 2) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(x_tab, xs, f_tab, w_tab, wrow, out, m, w, n, sm, mode) -> None:
    """One launch on the current stream of out's device; xs, w_tab and
    wrow may be None (COUNTS: no gathers). Raises on a CUDA error."""
    if -(-w // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"{w} witness slots; at most {_MAX_GRID_Y * _TILE}")
    gathers = [None if t is None else t.data_ptr() for t in (xs, w_tab, wrow)]
    lib = _load("strongly_see.cu")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.babble_strongly_see_gathered(
            x_tab.data_ptr(), gathers[0], f_tab.data_ptr(), *gathers[1:],
            out.data_ptr(), m, w, n, sm, mode, stream)
    if err != 0:
        raise RuntimeError(f"strongly-see kernel launch failed: CUDA error {err}")


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
    out = torch.empty((m, w), dtype=torch.int32, device=la_x.device)
    if m == 0 or w == 0:
        return out
    _launch(la_x, None, fd_w, None, None, out, m, w, n, 0, _COUNTS)
    count_launch(strongly_see_counts)
    return out


strongly_see_counts.launches = 0


def strongly_see_gathered(x_tab: torch.Tensor, xs: torch.Tensor, f_tab: torch.Tensor,
                          w_tab: torch.Tensor, wrow: torch.Tensor, sm: int,
                          mode: str) -> torch.Tensor:
    """The gathered, batched, thresholded strongly-see:

        c[m, w] = #{i : x_tab[xs[m], i] >= f_tab[w_tab[wrow[m], w], i]}

    for the witness slots with w_tab[wrow[m], w] >= 0 (-1 names none).
    mode "matrix": uint8 [M, W] = (c >= sm) & witness valid;
    mode "tally": int32 [M] = #{w : witness valid and c >= sm}.

    x_tab [Ex, n], f_tab [Ef, n] and w_tab [R, W] are int32 2-D, xs and
    wrow int32 [M], all contiguous and on one device; the indices must
    lie in x_tab, w_tab and f_tab (the kernel does not check them).
    CUDA tensors go to the hand-written kernel (one launch, counted in
    `strongly_see_gathered.launches[mode]`); CPU tensors go to the
    plain version. No host read."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    for name, t in (("x_tab", x_tab), ("f_tab", f_tab), ("w_tab", w_tab)):
        _check_operand(name, t)
    _check_operand("xs", xs, dim=1)
    _check_operand("wrow", wrow, dim=1)
    if x_tab.shape[1] != f_tab.shape[1]:
        raise ValueError(
            f"participant axes differ: {x_tab.shape[1]} vs {f_tab.shape[1]}")
    if xs.shape != wrow.shape:
        raise ValueError(f"xs {tuple(xs.shape)} and wrow {tuple(wrow.shape)} differ")
    dev = x_tab.device
    if any(t.device != dev for t in (xs, f_tab, w_tab, wrow)):
        raise ValueError("operands on more than one device")
    if dev.type == "cpu":
        return strongly_see_gathered_ref(x_tab, xs, f_tab, w_tab, wrow, sm, mode)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    m, w, n = xs.shape[0], w_tab.shape[1], x_tab.shape[1]
    if mode == "matrix":
        out = torch.empty((m, w), dtype=torch.uint8, device=dev)
    else:  # several witness tiles add their hits into a zeroed tally
        out = (torch.zeros if w > _TILE or w == 0 else torch.empty)(
            (m,), dtype=torch.int32, device=dev)
    if m == 0 or w == 0:
        return out
    _launch(x_tab, xs, f_tab, w_tab, wrow, out, m, w, n, int(sm), MODES[mode])
    count_launch(strongly_see_gathered, mode)
    return out


strongly_see_gathered.launches = {mode: 0 for mode in MODES}


def launch_p256_dual_window(n1: torch.Tensor, n2: torch.Tensor, qwin: torch.Tensor,
                            gwin: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                            Z: torch.Tensor, b: int) -> None:
    """One launch of csrc/p256.cu on the current stream of X's device:
    the ladder for b lanes into X, Y and Z ([b, 16] each). The caller
    (p256.dual_window) has checked the operands: int32, contiguous, on
    one CUDA device, n1/n2 [b, 64], qwin [b, 16, 2, 16], gwin [16, 2,
    16]. Raises on a CUDA error."""
    lib = _load("p256.cu")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.babble_p256_dual_window(
            n1.data_ptr(), n2.data_ptr(), qwin.data_ptr(), gwin.data_ptr(),
            X.data_ptr(), Y.data_ptr(), Z.data_ptr(), b, stream)
    if err != 0:
        raise RuntimeError(f"p256 kernel launch failed: CUDA error {err}")
