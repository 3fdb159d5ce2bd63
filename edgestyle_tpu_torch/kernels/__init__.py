"""Build and load the port's hand-written CUDA kernels.

Each ``*.cu`` file here has a plain C interface. On first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/torch_ext/``
at the repo root (git-ignored) and loaded with ``ctypes``; pointers and the
stream are passed as integers from the torch tensors. The library's file
name carries a hash of the source, the shared headers (``*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. The sources include no PyTorch
header, which keeps each build to seconds.

Nothing here runs at import time: the CPU tests import every module, and
a machine without a card has no ``nvcc``. A failed build or launch raises.

``LAUNCHES`` counts the launches of each kernel. Every wrapper adds one
right where it launches its kernel and nowhere else, so a caller can zero
the counts, run the main path and see which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

KERNEL_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNEL_DIR.parents[1]
BUILD_DIR = REPO_ROOT / "build" / "torch_ext"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# library name -> (source file, {C function: argtypes})
SOURCES = {
    "flash_fwd": ("flash_fwd.cu", {
        "flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
    }),
    "gn_stats": ("gn_stats.cu", {
        "gn_scale_shift": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
                           _P),
    }),
    "fused_conv": ("fused_conv.cu", {
        "fused_gn_silu_conv3x3": (_P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P),
    }),
    "flash_bwd": ("flash_bwd.cu", {
        "flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
        "flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
    }),
}

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "gn_scale_shift": 0, "fused_gn_silu_conv3x3": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_locks = {name: threading.Lock() for name in SOURCES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    """The library's path. Its name hashes the source, every header here
    (a source may include any of them) and the flags."""
    h = hashlib.sha256((KERNEL_DIR / SOURCES[name][0]).read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_log(name: str) -> Path:
    """nvcc's output for one source (ptxas register and spill lines)."""
    return _target(name).with_suffix(".log")


def _build(name: str) -> None:
    """Compile one source with nvcc unless its library is already built."""
    target = _target(name)
    if target.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / SOURCES[name][0])]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_log(name).write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name][0]} (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel source, built on first use. Each
    source has its own lock, so callers on several threads build several
    sources at once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locks[name]:
        if name not in _libs:
            _build(name)
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SOURCES[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check_aligned(what: str, **tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary: the kernels
    move 16 bytes per thread (a view with an odd offset would fault)."""
    bad = [name for name, t in tensors.items() if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{what}: {', '.join(bad)} not 16-byte aligned")


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
