"""Build and load the port's CUDA kernels (one shared library, bound with ctypes).

The sources in ``csrc/`` have a plain C interface, so they build without
PyTorch's headers: each ``.cu`` file is compiled by its own ``nvcc`` process
(all started together), and the objects are linked into one shared library
for Hopper (``sm_90a``).  The build happens on first use, into
``build/kernels/<hash of the sources>/`` at the root of the checkout, so a
changed source is never served by a stale library.  Nothing is built when a
module is imported: the CPU tests import every module and have no ``nvcc``.

Every entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.

The wrappers call in here on every launch, so the common path is cheap: the
loaded library's functions are resolved once (:func:`kernel` is a dict
lookup), and :func:`stream_of` reads PyTorch's current raw stream handle
without building a ``torch.cuda.Stream`` object.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["BUILD_ROOT", "CSRC", "SOURCES", "build", "library", "kernel", "check",
           "stream_of", "DTYPE_CODES", "COUNT_LOCK"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("coded_matvec.cu", "mds_encode.cu", "mds_decode.cu", "lstm_cell.cu",
           "errors.cu")
HEADERS = ("common.cuh",)
# src/repro_torch/kernels/_build.py -> the checkout's root
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# name -> argtypes; every entry point returns an int (a cudaError_t)
_SIGNATURES = {
    "s2c2_coded_matvec": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _I, _P],
    "s2c2_coded_matvec_stream": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _P],
    "s2c2_mds_encode": [_P, _P, _P, _I64, _I64, _I64, _I, _I, _I, _P],
    "s2c2_mds_decode": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P],
    "s2c2_lstm_cell": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    "s2c2_lstm_sequence": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P],
}

_lock = threading.Lock()
# guards every wrapper module's launch counters: the cluster's worker
# threads launch kernels concurrently, and ``+=`` on a module global can
# lose a count between its read and its write
COUNT_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: dict[str, ctypes._CFuncPtr] = {}     # entry point name -> bound function


def _nvcc() -> str | None:
    """``nvcc`` on the PATH, else in the CUDA toolkit PyTorch locates."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    return None


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if not built yet) and return the library's path.

    Raises RuntimeError when there is no ``nvcc`` or a compile fails; the
    compiler's output, ``-Xptxas -v`` register counts included, is kept in
    ``build.log`` beside the library.
    """
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libs2c2_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA toolkit "
            "is installed; CPU tensors use the plain versions")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name} (rc {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(name)
    if not failed:
        tmp = out_dir / f".libs2c2_kernels.{os.getpid()}.so"
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode:
            failed.append("link")
        else:
            os.replace(tmp, lib_path)       # atomic: a reader sees all or nothing
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n" + "\n".join(log))
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
            lib.s2c2_error_string.argtypes = [ctypes.c_int]
            lib.s2c2_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def kernel(name: str) -> ctypes._CFuncPtr:
    """The entry point ``name`` of the library, which is built on first use."""
    if _lib is None:
        library()
    return _fns[name]


def check(err: int, kernel: str) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if err:
        text = library().s2c2_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({text})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
