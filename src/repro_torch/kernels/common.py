"""Shared utilities for the CUDA kernel layer: build, load, launch checks.

Each ``.cu`` source is compiled at first use with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``; the wrappers
pass ``data_ptr()`` pointers and the current stream. A library that
includes no PyTorch header builds in seconds, where a
``torch.utils.cpp_extension`` build takes minutes. Libraries land in
``build/torch_ext/`` at the repository root, named by a hash of the
source and flags, so an edited source is rebuilt. A failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: compiler output (``ptxas -v``: registers, shared memory, spills) of each
#: library built by this process, by source stem
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the b2sr_cuda kernels are built from source at "
                       "first use")


def load_library(source: Path) -> ctypes.CDLL:
    """Build (once per source content) and load the library of ``source``."""
    key = str(source)
    if key in _LIBS:
        return _LIBS[key]
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{source.stem}-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source} "
                               f"(exit {proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        BUILD_LOG[source.stem] = proc.stdout + proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[key] = lib
    return lib


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if the launcher returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({msg})")
