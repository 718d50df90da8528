"""Wrapper of the log-mel frontend kernel (`csrc/frontend.cu`).

Replaces `rnnt_tpu/ops/features_pallas.py::_frontend_kernel`.  The kernel
computes framing -> Hann-windowed DFT (two fp32 products against the
window-folded cos and sin matrices) -> magnitude -> mel product ->
log(mel + 1e-6) in one launch.  The function's bound on the H100 is moving
the audio in and the log-mel out; the kernel's matrix DFT does some thirty
times the operations an FFT would need; see the source note.

On a CPU tensor the wrapper runs the plain version
(`ops.features.log_mel_plain`); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.ops import features as F


def dft_matrices(cfg: RNNTConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Window-folded DFT matrices C, S [frame_length, n_bins] and the mel
    filterbank [n_bins, mel_bins], all float32:
    C[k, f] = hann[k] cos(2 pi k f / nfft), S[k, f] = -hann[k] sin(...)."""
    flen = cfg.frame_length_samples
    nfft = F.next_pow2(flen)
    n_bins = nfft // 2 + 1
    k = np.arange(flen, dtype=np.float64)[:, None]
    f = np.arange(n_bins, dtype=np.float64)[None, :]
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / flen)  # periodic
    ang = 2.0 * np.pi * k * f / nfft
    cos = (hann * np.cos(ang)).astype(np.float32)
    sin = (-hann * np.sin(ang)).astype(np.float32)
    mel = F.mel_weight_matrix(cfg.mel_bins, n_bins, cfg.sample_rate,
                              cfg.hertz_low, cfg.hertz_high)
    return cos, sin, mel


@functools.lru_cache(maxsize=8)
def _device_matrices(cfg: RNNTConfig, device: torch.device):
    """The kernel's constant inputs, built once per config and device."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in dft_matrices(cfg))


@functools.lru_cache(maxsize=None)
def _lib():
    from rnnt_tpu_torch.kernels import build

    lib = build.load("frontend")
    lib.frontend_log_mel.restype = ctypes.c_int
    lib.frontend_log_mel.argtypes = ([ctypes.c_void_p] * 5
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def log_mel_frontend(audio: torch.Tensor, cfg: RNNTConfig) -> torch.Tensor:
    """audio [N] -> log-mel [num_frames, mel_bins] float32, before mean
    subtraction.  Fewer samples than one frame give [0, mel_bins]."""
    if audio.dim() != 1:
        raise ValueError(f"audio must be 1-D, got shape {tuple(audio.shape)}")
    if not audio.is_cuda:
        return F.log_mel_plain(audio, cfg)
    from rnnt_tpu_torch.kernels import build

    audio = audio.to(torch.float32).contiguous()
    n_frames = F.num_frames(audio.shape[0], cfg)
    out = torch.empty((n_frames, cfg.mel_bins), dtype=torch.float32,
                      device=audio.device)
    if n_frames == 0:
        return out
    cos, sin, mel = _device_matrices(cfg, audio.device)
    lib = _lib()
    with torch.cuda.device(audio.device):  # the launcher uses the current one
        err = lib.frontend_log_mel(
            audio.data_ptr(), cos.data_ptr(), sin.data_ptr(), mel.data_ptr(),
            out.data_ptr(), n_frames, cos.shape[0], cfg.frame_step_samples,
            cos.shape[1], mel.shape[1],
            torch.cuda.current_stream(audio.device).cuda_stream)
    build.check(lib, err, "frontend_log_mel")
    log_mel_frontend.launches += 1
    return out


log_mel_frontend.launches = 0
