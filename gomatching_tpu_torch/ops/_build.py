"""Build and load the port's native libraries.

The CUDA sources under ``gomatching_tpu_torch/csrc/`` have a plain C interface and
no PyTorch headers, so one ``nvcc`` call per source builds a shared library in
seconds; it is loaded with ``ctypes``. The host Hungarian solver
(``native/lap.cpp``) is built the same way with ``g++``. Libraries are built at
first use into ``build/gomatching_tpu_torch/`` at the repository root, named by a
hash of their source and flags, so an edited source never loads a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
REPO_ROOT = PKG_DIR.parent
BUILD_DIR = REPO_ROOT / "build" / "gomatching_tpu_torch"
CSRC_DIR = PKG_DIR / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}_{digest[:16]}.so"


def build(source, compiler: Optional[str] = None,
          flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile ``source`` (a file under ``csrc/``, or an absolute path) into a shared
    library with ``compiler`` (default: nvcc) unless it is already built. The
    library is written under a temporary name and renamed into place."""
    out = library_path(source, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler or find_nvcc(), *flags, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{cmd[0]} failed to build {source} ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load(source: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; ``signatures`` maps each C
    function to its ctypes ``argtypes`` (every function returns a C ``int``). Modules
    that share a source each name their own functions."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(build(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            if fn.argtypes is None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        return lib
