"""FLAC decoding through the native decoder (`flac_decoder.cc`)."""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from rnnt_tpu_torch.native.build import load_library


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (mono float32 samples in [-1, 1], sample_rate).

    Integer samples are scaled by 2^-(bits - 1); multi-channel audio keeps
    channel 0, as the WAV reader does.  A stream the decoder rejects raises
    ValueError with its code."""
    lib = load_library()
    samples = ctypes.POINTER(ctypes.c_int32)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    bits = ctypes.c_int()
    rc = lib.flac_decode_file(os.fsencode(path), ctypes.byref(samples),
                              ctypes.byref(n), ctypes.byref(sr),
                              ctypes.byref(ch), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc}): {path}")
    try:
        total = n.value * ch.value
        arr = (np.ctypeslib.as_array(samples, shape=(total,)).copy()
               if total else np.zeros((0,), np.int32))
    finally:
        lib.flac_free(samples)
    if ch.value > 1:
        arr = arr.reshape(-1, ch.value)[:, 0]
    scale = float(1 << (bits.value - 1))
    return arr.astype(np.float32) / scale, sr.value
