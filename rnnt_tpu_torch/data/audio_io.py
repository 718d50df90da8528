"""Audio file IO: WAV with the standard library, FLAC through the port's
native decoder (`rnnt_tpu_torch.native`, built with g++ at first use).

The port of `rnnt_tpu.data.audio_io`.  Readers return (float32 mono samples
in [-1, 1], sample_rate); integer PCM is scaled as tf.audio.decode_wav
does, and multi-channel audio keeps channel 0.  There is no second FLAC
decoder: if the native library cannot be built, reading a FLAC raises.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file (a path or a binary file-like object)."""
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        framerate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels)[:, 0]
    return data, framerate


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Read a FLAC file with the native decoder (`native.flac`)."""
    from rnnt_tpu_torch.native import flac as native_flac

    return native_flac.read_flac(path)


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Read an audio file by its extension: .flac (LibriSpeech) through the
    native decoder, anything else as WAV."""
    if path.lower().endswith(".flac"):
        return read_flac(path)
    return read_wav(path)


def write_wav(path, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] samples as 16-bit PCM WAV (a path or a
    binary file-like object)."""
    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
