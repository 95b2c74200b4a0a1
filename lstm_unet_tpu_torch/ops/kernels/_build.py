"""Build the CUDA sources of ``lstm_unet_tpu_torch/csrc`` and bind them.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, which ``ctypes`` loads. The library is
built at first use into ``lstm_unet_tpu_torch/build/`` (ignored by git),
under a name that hashes the sources and flags, so an edit rebuilds and an
unchanged tree reuses it. Only the sources in this repository are compiled.

Every C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype and activation codes of csrc/common.cuh
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTIVATIONS = {"sigmoid": 0, "hard_sigmoid": 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument and result types of every C entry point in csrc/
_SIGNATURES = {
    "lut_gate_update": ([_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P], _I),
    "lut_convlstm_level": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P], _I),
    "lut_convlstm_level_smem": ([_I, _I], _LL),
    "lut_ccl": ([_P, _P, _P, _I, _I, _P], _I),
    "lut_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # compile time of this process's build


class LaunchCount:
    """How often a kernel was launched, and its plain version called."""

    def __init__(self):
        self.kernel = 0
        self.plain = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libkernels-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this source tree's build exists; returns
    its path. The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it in ``build.log``."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().lut_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
