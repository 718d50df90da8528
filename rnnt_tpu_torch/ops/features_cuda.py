"""Wrapper of the log-mel frontend kernel (`csrc/frontend.cu`).

Replaces `rnnt_tpu/ops/features_pallas.py::_frontend_kernel`.  The kernel
computes framing -> Hann window -> real FFT in shared memory (a packed
nfft/2-point complex radix-2 FFT and the split step) -> magnitude -> the
sparse mel filters -> log(mel + 1e-6) in one launch, one warp a frame; see
the source note.  Its constant inputs are `fft_tables`: the window and the
twiddles computed in float64 and rounded to fp32, and the mel filterbank
packed as each mel bin's run of nonzero weights.

On a CPU tensor the wrapper runs the plain version
(`ops.features.log_mel_plain`); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.ops import features as F

NFFT_MIN, NFFT_MAX = 64, 4096  # the kernel's FFT lengths (powers of two)


class FFTTables(NamedTuple):
    """The kernel's constant inputs for one geometry."""
    window: np.ndarray   # [L] f32, periodic Hann
    twiddles: np.ndarray  # [nfft/2, 2] f32, exp(-2 pi i t / nfft)
    mel_idx: np.ndarray  # [3, M] int32: first bin, count, offset in mel_w
    mel_w: np.ndarray    # [nnz] f32, each mel bin's weights by ascending bin


def check_geometry(cfg: RNNTConfig) -> int:
    """The FFT length of cfg's frames; raises outside the kernel's design."""
    nfft = F.next_pow2(cfg.frame_length_samples)
    if not NFFT_MIN <= nfft <= NFFT_MAX:
        raise ValueError(
            f"frontend kernel: FFT length {nfft} (frame length "
            f"{cfg.frame_length_samples} samples) is outside "
            f"[{NFFT_MIN}, {NFFT_MAX}]")
    if cfg.frame_step_samples < 1 or cfg.mel_bins < 1:
        raise ValueError("frontend kernel: frame step and mel_bins must be "
                         f">= 1, got {cfg.frame_step_samples}, "
                         f"{cfg.mel_bins}")
    return nfft


def sparse_mel(mel: np.ndarray):
    """[K, M] filterbank -> (mel_idx [3, M] int32, mel_w [nnz] f32): each
    mel bin's span from its first to its last nonzero weight."""
    K, M = mel.shape
    idx = np.zeros((3, M), np.int32)
    runs = []
    off = 0
    for m in range(M):
        nz = np.flatnonzero(mel[:, m])
        lo, cnt = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        idx[:, m] = lo, cnt, off
        runs.append(mel[lo: lo + cnt, m])
        off += cnt
    return idx, np.concatenate(runs).astype(np.float32)


def dense_mel(mel_idx: np.ndarray, mel_w: np.ndarray, n_bins: int):
    """The [n_bins, M] filterbank that (mel_idx, mel_w) describe."""
    M = mel_idx.shape[1]
    mel = np.zeros((n_bins, M), np.float32)
    for m, (lo, cnt, off) in enumerate(mel_idx.T):
        mel[lo: lo + cnt, m] = mel_w[off: off + cnt]
    return mel


def fft_tables(cfg: RNNTConfig) -> FFTTables:
    """Window, twiddles and sparse mel filters of cfg's geometry."""
    nfft = check_geometry(cfg)
    flen = cfg.frame_length_samples
    k = np.arange(flen, dtype=np.float64)
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * k / flen)).astype(np.float32)
    ang = -2.0 * np.pi * np.arange(nfft // 2, dtype=np.float64) / nfft
    twiddles = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
    mel = F.mel_weight_matrix(cfg.mel_bins, nfft // 2 + 1, cfg.sample_rate,
                              cfg.hertz_low, cfg.hertz_high)
    return FFTTables(window, twiddles, *sparse_mel(mel))


@functools.lru_cache(maxsize=8)
def _device_tables(cfg: RNNTConfig, device: torch.device):
    """The kernel's constant inputs, built once per config and device."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in fft_tables(cfg))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a frontend library's entry point."""
    lib.frontend_log_mel_fft.restype = ctypes.c_int
    lib.frontend_log_mel_fft.argtypes = ([ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * 6
                                         + [ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    from rnnt_tpu_torch.kernels import build

    return bind(build.load("frontend"))


def launch(lib: ctypes.CDLL, audio: torch.Tensor, cfg: RNNTConfig):
    """One launch of `lib`'s kernel on fp32 contiguous CUDA audio [N]:
    log-mel [num_frames, mel_bins] before mean subtraction."""
    from rnnt_tpu_torch.kernels import build

    nfft = check_geometry(cfg)
    n_frames = F.num_frames(audio.shape[0], cfg)
    out = torch.empty((n_frames, cfg.mel_bins), dtype=torch.float32,
                      device=audio.device)
    if n_frames == 0:
        return out
    win, tw, mel_idx, mel_w = _device_tables(cfg, audio.device)
    with torch.cuda.device(audio.device):  # the launcher uses the current one
        err = lib.frontend_log_mel_fft(
            audio.data_ptr(), win.data_ptr(), tw.data_ptr(),
            mel_idx.data_ptr(), mel_w.data_ptr(), out.data_ptr(), n_frames,
            cfg.frame_length_samples, cfg.frame_step_samples, nfft,
            cfg.mel_bins, mel_w.shape[0],
            torch.cuda.current_stream(audio.device).cuda_stream)
    build.check(lib, err, "frontend_log_mel_fft")
    return out


def log_mel_frontend(audio: torch.Tensor, cfg: RNNTConfig) -> torch.Tensor:
    """audio [N] -> log-mel [num_frames, mel_bins] float32, before mean
    subtraction.  Fewer samples than one frame give [0, mel_bins]."""
    if audio.dim() != 1:
        raise ValueError(f"audio must be 1-D, got shape {tuple(audio.shape)}")
    if not audio.is_cuda:
        return F.log_mel_plain(audio, cfg)
    out = launch(_lib(), audio.to(torch.float32).contiguous(), cfg)
    if out.shape[0]:
        log_mel_frontend.launches += 1
    return out


log_mel_frontend.launches = 0
