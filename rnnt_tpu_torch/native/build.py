"""Build and load the native library (g++ -> shared library -> ctypes).

The C++ sources beside this file are compiled into one shared library at
first use, into `rnnt_tpu_torch/_build/native/`, named by a digest of the
sources, the flags and the host CPU's feature flags (-march=native builds
for this CPU), so an edited source, or another CPU, is rebuilt and an
unchanged one reused.  A failed build raises with the compiler's output; nothing falls
back to another decoder or loss.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
_SOURCES = ["flac_decoder.cc", "rnnt_loss_cpu.cc"]
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_flags() -> str:
    """The host CPU's feature flags (Linux), else its architecture."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return platform.machine()


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_flags().encode())
    for src in _SOURCES:
        with open(os.path.join(_DIR, src), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(_BUILD_DIR, f"librnnt_native-{_digest()}.so")


def build(force: bool = False) -> str:
    """Compile the library if it is missing (or always, with force);
    returns its path.  The library is written under a temporary name and
    renamed into place, so concurrent builds never load a partial file."""
    path = lib_path()
    if os.path.exists(path) and not force:
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, *(os.path.join(_DIR, s) for s in _SOURCES),
           "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                               f"{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            # flac_decode_file(path, &samples, &n, &sr, &ch, &bits) -> int
            lib.flac_decode_file.restype = ctypes.c_int
            lib.flac_decode_file.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.flac_free.restype = None
            lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
            # rnnt_loss_cpu(logits, labels, f_lens, y_lens, B, T, U1, V,
            #               loss, grad) -> int
            lib.rnnt_loss_cpu.restype = ctypes.c_int
            lib.rnnt_loss_cpu.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
            ]
            _lib = lib
    return _lib
