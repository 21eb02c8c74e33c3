"""Build and load the port's native libraries: the CUDA kernels
(ops/hopper_kernels.py, with nvcc) and the host reader of a columnar
sync batch (hashgraph/wire_native.py, with the system's C++ compiler).

A library's file name carries a hash of its source and its flags, so an
edited source is never served by a stale build. The compiler writes a
temporary file that is then renamed, so concurrent builds never load a
half-written one."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple


def build_library(source: Path, compiler: Callable[[], str], flags: Sequence[str],
                  build_dir: Path) -> dict:
    """Compile `source` with `flags` into build_dir, unless this source
    and these flags have a build there already. `compiler()` names the
    compiler; it is asked only when there is something to compile.
    Returns {"path", "seconds", "log"}: the library, the compile's
    seconds (0 for an existing build) and the compiler's output. Raises
    RuntimeError, with that output, where the compiler fails."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    lib_path = build_dir / f"libbabble_{source.stem}_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return {"path": lib_path, "seconds": 0.0, "log": "(already built)"}
    cc = compiler()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cc, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cc).name} failed on {source.name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return {"path": lib_path, "seconds": seconds,
            "log": (proc.stdout + proc.stderr).strip()}


def load_library(path: Path, entries: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """Load the library at `path` and give each of its entry points
    (name: (argument types, result type)) its types."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
