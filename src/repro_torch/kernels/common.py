"""Shared utilities for the CUDA kernel layer: build, load, launch checks.

Each ``.cu`` source is compiled at first use with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``; the wrappers
pass ``data_ptr()`` pointers and the current stream. A library that
includes no PyTorch header builds in seconds, where a
``torch.utils.cpp_extension`` build takes minutes. Libraries land in
``build/torch_ext/`` at the repository root, named by a hash of the
source (with the local headers it includes) and flags, so an edited
source is rebuilt. A failed build raises :class:`KernelError` with the
compiler's output, and so does a failed launch: no caller catches it to
take a kernel's plain version instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Tile columns the shared-memory bitmap of ``row_bitmap.cuh`` holds
#: (``rowbm::kMaxWords`` words of 32)
ROW_BITMAP_MAX_TILE_COLS = ((232448 - 4096) // 8) * 32

class KernelError(RuntimeError):
    """A hand kernel did not build (no ``nvcc``, or ``nvcc`` failed) or did
    not launch (the launcher returned a CUDA error)."""


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
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the b2sr_cuda kernels are built from source at "
                       "first use")


def load_library(source: Path) -> ctypes.CDLL:
    """Build (once per source content) and load the library of ``source``."""
    key = str(source)
    if key in _LIBS:
        return _LIBS[key]
    text = source.read_bytes()
    headers = re.findall(rb'^#include "([^"]+)"', text, re.MULTILINE)
    for h in headers:
        text += (source.parent / h.decode()).read_bytes()
    digest = hashlib.sha256(text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{source.stem}-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed to build {source} "
                               f"(exit {proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        BUILD_LOG[source.stem] = proc.stdout + proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[key] = lib
    return lib


def kernel_resources(stem: str) -> Dict[str, Dict[str, int]]:
    """Registers and bytes of spill stores and spill loads of each kernel
    of the library built from ``<stem>.cu`` by this process (from
    ``ptxas -v``), by mangled name; empty when the library came from an
    earlier build."""
    out: Dict[str, Dict[str, int]] = {}
    name = ""
    for line in BUILD_LOG.get(stem, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {"registers": 0, "spill_stores": 0,
                         "spill_loads": 0}
        elif name and "spill stores" in line:
            words = line.split()
            out[name]["spill_stores"] = int(words[4])
            out[name]["spill_loads"] = int(words[8])
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
    return out


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if the launcher returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise KernelError(f"{name}: CUDA launch failed with error {err} "
                           f"({msg})")


def call(source: Path, name: str, argtypes, x: torch.Tensor, *args) -> None:
    """Launch ``name`` of ``source``'s library on ``x``'s device and current
    stream (the last argument the C function takes); raise on error."""
    lib = load_library(source)
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_launch(lib, err, name)


def check_b2sr(name: str, m, device: torch.device, t: int) -> None:
    """Validate a B2SR operand of the row-product kernels."""
    if m.tile_dim != t:
        raise ValueError(f"{name} tile_dim {m.tile_dim} != {t}")
    for part, a, want in (("tile_row_ptr", m.tile_row_ptr, torch.int32),
                          ("tile_col_idx", m.tile_col_idx, torch.int32),
                          ("bit_tiles", m.bit_tiles, torch.int32)):
        if a.device != device:
            raise ValueError(f"{name}.{part} is on {a.device}, expected "
                             f"{device}")
        if a.dtype != want:
            raise TypeError(f"{name}.{part} must be {want}, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name}.{part} must be contiguous")
    if m.bit_tiles.shape != (m.tile_col_idx.shape[0], t):
        raise ValueError(f"{name}.bit_tiles shape {tuple(m.bit_tiles.shape)}"
                         f" != ({m.tile_col_idx.shape[0]}, {t})")
    if m.tile_row_ptr.shape[0] != m.n_tile_rows + 1:
        raise ValueError(f"{name}.tile_row_ptr has "
                         f"{m.tile_row_ptr.shape[0]} entries, expected "
                         f"{m.n_tile_rows + 1}")


def check_bitmap_width(n_tile_cols: int, what: str) -> None:
    if n_tile_cols > ROW_BITMAP_MAX_TILE_COLS:
        raise ValueError(
            f"{what} has {n_tile_cols} tile columns; the kernel's shared-"
            f"memory bitmap holds at most {ROW_BITMAP_MAX_TILE_COLS} "
            f"(n_cols / tile_dim): use a larger tile_dim or the csr backend")
