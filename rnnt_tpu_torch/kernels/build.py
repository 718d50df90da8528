"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/*.cu` file becomes its own shared library with a plain C
interface, compiled for `sm_90a` (Hopper) into `rnnt_tpu_torch/_build/`
and named by a digest of its source, so an edited source is rebuilt and an
unchanged one is reused.  All missing libraries are compiled in parallel, one
nvcc process per source.  Nothing here runs at import: the first CUDA call
of a kernel wrapper builds, and CPU-only paths never need nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel source names (without extension), one library each."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(_CSRC, "*.cu")))


def _digest(name: str) -> str:
    """Digest of a kernel source plus every shared header and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(_CSRC, name + ".cu"),
                 *sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(_BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under CUDA_HOME)")


def build_all(names=None) -> Dict[str, str]:
    """Compile every missing library, all nvcc processes at once.  Returns
    {name: library path}; raises with nvcc's output if any build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    paths = {n: lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = f"{paths[n]}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, n + ".cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{out}")
            else:
                os.replace(tmp, paths[n])  # atomic publish
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build_all([name])[name])
        return _libs[name]


def check_operands(tensors, dtypes) -> None:
    """Raise unless every operand is contiguous, of its dtype, on one
    device."""
    dev = tensors[0].device
    for i, (a, dt) in enumerate(zip(tensors, dtypes)):
        if a.device != dev or not a.is_contiguous() or a.dtype != dt:
            raise ValueError(f"operand {i}: {a.dtype} on {a.device}, "
                             f"contiguous {a.is_contiguous()}; want a "
                             f"contiguous {dt} on {dev}")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        lib.rnnt_cuda_error_string.restype = ctypes.c_char_p
        lib.rnnt_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.rnnt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
