"""Build the CUDA sources of ``lstm_unet_tpu_torch/csrc`` and bind them.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain C interface, which ``ctypes`` loads. The library is
built at first use into ``lstm_unet_tpu_torch/build/`` (ignored by git),
under a name that hashes the sources and flags, so an edit rebuilds and an
unchanged tree reuses it. Only the sources in this repository are compiled.

Every C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
turns a non-zero code into an exception.

A measurement's own kernels (``csrc/probes/<name>.cu``, never the program's
path) are built by :func:`probe_library` at their first call, into a library
of their own, so the program's build does not compile them.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
PROBE_DIR = os.path.join(CSRC_DIR, "probes")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype and activation codes of csrc/common.cuh
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTIVATIONS = {"sigmoid": 0, "hard_sigmoid": 1}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argument and result types of every C entry point in csrc/
_SIGNATURES = {
    "lut_gate_update": ([_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P], _I),
    "lut_gate_update_bwd": ([_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P], _I),
    "lut_convlstm_level_wgmma": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P], _I),
    "lut_convlstm_level_wgmma_smem": ([_I], _LL),
    "lut_convlstm_level_tf32x3": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _P], _I),
    "lut_convlstm_level_tf32x3_smem": ([_I], _LL),
    "lut_convlstm_level_narrow": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _P], _I),
    "lut_convlstm_level_narrow_smem": ([_I, _I, _I], _LL),
    "lut_ccl_cluster": ([_P, _P, _I, _I, _P], _I),
    "lut_ccl_cluster_smem": ([_I, _I], _LL),
    "lut_ccl_grid": ([_P, _P, _I, _I, _P], _I),
    "lut_grow_into_band": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "lut_erosion_distance": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P], _I),
    "lut_split_markers": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    "lut_conv2d_int8": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                        _I),
    "lut_conv2d_int8_wgmma": ([_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P], _I),
    "lut_conv2d_int8_wgmma_smem": ([_I, _I, _I, _I], _LL),
    "lut_conv2d_int8_wgmma_gates": ([_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, _I, _I, _P], _I),
    "lut_conv2d_int8_smallk": ([_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _P], _I),
    "lut_conv2d_int8_smallk_smem": ([_I, _I, _I, _I, _I], _LL),
    "lut_trace_stamp": ([_P, _P, _LL, _LL, _P], _I),
    "lut_error_string": ([_I], ctypes.c_char_p),
}
# the same for the C entries of csrc/probes/<name>.cu, by name
_PROBE_SIGNATURES = {
    "conv_int8_wgmma_probe": {
        "lut_conv2d_int8_wgmma_probe": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                         _P, _P], _I),
    },
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_probes = {}
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


def _digest(paths) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return digest.hexdigest()[:16]


def library_path() -> str:
    digest = _digest(sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))))
    return os.path.join(BUILD_DIR, f"libkernels-{digest}.so")


def _run_all(cmds, log_dir: str):
    """Run the commands at once, each with its output in a file of
    ``log_dir``; returns ``[(cmd, returncode, output)]`` in order."""
    procs = []
    for i, cmd in enumerate(cmds):
        log = open(os.path.join(log_dir, f"{i}.log"), "w+")
        procs.append((cmd, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log))
    results = []
    for cmd, proc, log in procs:
        rc = proc.wait()
        log.seek(0)
        results.append((cmd, rc, log.read()))
        log.close()
    return results


def build() -> str:
    """Compile the library unless this source tree's build exists; returns
    its path. The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it in ``build.log``."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="nvcc-", dir=BUILD_DIR)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        objs = [os.path.join(work, os.path.basename(src) + ".o") for src in _sources()]
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                            for src, obj in zip(_sources(), objs)], work)
        tmp = f"{out}.{os.getpid()}.tmp"
        if all(rc == 0 for _, rc, _ in results):
            results += _run_all([[nvcc, "-shared", *ARCH_FLAGS, "-o", tmp, *objs]], work)
        build_seconds = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
            for cmd, _, text in results:
                f.write(" ".join(cmd) + "\n" + text)
        failed = [(cmd, rc, text) for cmd, rc, text in results if rc != 0]
        if failed:
            cmd, rc, text = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text[-4000:]}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    finally:
        shutil.rmtree(work, ignore_errors=True)
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


def probe_library(name: str) -> ctypes.CDLL:
    """The bound library of the measurement ``csrc/probes/<name>.cu`` alone,
    built at its first call (named by its source and the headers of
    ``csrc/`` it may include; ptxas's output in ``build/<name>.log``)."""
    with _lock:
        if name not in _probes:
            src = os.path.join(PROBE_DIR, f"{name}.cu")
            digest = _digest([src, *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))])
            out = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, src]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                    f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                       f"{(proc.stdout + proc.stderr)[-4000:]}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
            for entry, (argtypes, restype) in _PROBE_SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = restype
            _probes[name] = lib
        return _probes[name]


def check(err: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().lut_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the C entries take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
