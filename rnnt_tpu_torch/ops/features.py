"""Audio feature frontend: STFT -> log-mel -> mean subtraction -> stacking.

The port of `rnnt_tpu.ops.features`, with tf.signal semantics:

- framing without centering, num_frames = 1 + (N - frame_len) // step,
  periodic Hann window, rfft at the next power of two;
- HTK mel filterbank as tf.signal.linear_to_mel_weight_matrix builds it;
- log(mel + 1e-6), then per-feature mean subtraction over time (+1e-8);
- stacking `downsample_factor` adjacent frames, truncating the tail.

`log_mel_plain` is the plain PyTorch version (torch.fft.rfft).  On a CUDA
tensor `log_mel_spectrogram` runs the frontend kernel instead
(`ops/features_cuda.py`, `csrc/frontend.cu`); mean subtraction and stacking
stay plain PyTorch on either device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rnnt_tpu_torch.config import RNNTConfig


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def hertz_to_mel(f):
    return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)


@functools.lru_cache(maxsize=8)
def mel_weight_matrix(num_mel_bins: int, num_spectrogram_bins: int,
                      sample_rate: int, hertz_low: float,
                      hertz_high: float) -> np.ndarray:
    """HTK-mel triangular filterbank [num_spectrogram_bins, num_mel_bins],
    float32, bin 0 zeroed (tf.signal.linear_to_mel_weight_matrix).  The
    cached array is shared: callers copy it before writing."""
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[1:]
    spec_mels = hertz_to_mel(linear_freqs)[:, None]
    edges = np.linspace(hertz_to_mel(hertz_low), hertz_to_mel(hertz_high),
                        num_mel_bins + 2)
    lower, center, upper = (edges[:-2][None, :], edges[1:-1][None, :],
                            edges[2:][None, :])
    lower_slope = (spec_mels - lower) / (center - lower)
    upper_slope = (upper - spec_mels) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    return np.concatenate(
        [np.zeros((1, num_mel_bins)), weights], axis=0).astype(np.float32)


def num_frames(n_samples: int, cfg: RNNTConfig) -> int:
    """STFT frame count for n samples (0 below one frame)."""
    return max(0, 1 + (n_samples - cfg.frame_length_samples)
               // cfg.frame_step_samples)


def stft_magnitude(audio: torch.Tensor, frame_length: int, frame_step: int,
                   fft_length: int) -> torch.Tensor:
    """|STFT| of mono audio [N] -> [num_frames, fft_length // 2 + 1], in
    the audio's floating dtype."""
    n = audio.shape[-1]
    nf = max(0, 1 + (n - frame_length) // frame_step)
    if nf == 0:  # below one frame; an empty batch is no FFT input
        return torch.zeros((0, fft_length // 2 + 1), dtype=audio.dtype,
                           device=audio.device)
    idx = (torch.arange(nf, device=audio.device)[:, None] * frame_step
           + torch.arange(frame_length, device=audio.device)[None, :])
    frames = audio[idx]
    k = torch.arange(frame_length, dtype=audio.dtype, device=audio.device)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / frame_length)
    spec = torch.fft.rfft(frames * window, n=fft_length, dim=-1)
    return spec.abs()


def log_mel_plain(audio: torch.Tensor, cfg: RNNTConfig,
                  dtype=torch.float32) -> torch.Tensor:
    """Plain version of the frontend kernel: audio [N] -> log-mel
    [num_frames, mel_bins] before mean subtraction, computed in `dtype`
    (float32, as the port runs it; float64 gives the function to ~1e-12,
    the yardstick for the kernel's rounding at near-silent bins)."""
    audio = audio.to(dtype)
    flen = cfg.frame_length_samples
    fft_length = next_pow2(flen)
    mag = stft_magnitude(audio, flen, cfg.frame_step_samples, fft_length)
    mel_mat = torch.from_numpy(mel_weight_matrix(
        cfg.mel_bins, fft_length // 2 + 1, cfg.sample_rate, cfg.hertz_low,
        cfg.hertz_high)).to(audio.device, dtype)
    return torch.log(mag @ mel_mat + 1e-6)


def subtract_mean(log_mel: torch.Tensor) -> torch.Tensor:
    """Per-feature mean subtraction over time (+1e-8, as the reference)."""
    return log_mel - (log_mel.mean(dim=0) + 1e-8)


def log_mel_spectrogram(audio: torch.Tensor, cfg: RNNTConfig,
                        mean_subtract: bool = True) -> torch.Tensor:
    """Audio [N] float32 in [-1, 1] -> log-mel [num_frames, mel_bins],
    per-feature mean-subtracted.  Runs the frontend kernel on a CUDA tensor,
    the plain version on a CPU tensor.  mean_subtract=False returns the raw
    log-mels: streaming owns its normalization (a causal running mean)."""
    from rnnt_tpu_torch.ops.features_cuda import log_mel_frontend

    log_mel = log_mel_frontend(audio, cfg)
    return subtract_mean(log_mel) if mean_subtract else log_mel


def stack_frames(spec: torch.Tensor, n: int) -> torch.Tensor:
    """[T, F] -> [T // n, F * n], truncating the tail."""
    t, f = spec.shape
    return spec[: (t // n) * n].reshape(t // n, f * n)


def preprocess_audio(audio: torch.Tensor, cfg: RNNTConfig) -> torch.Tensor:
    """Full frontend: audio [N] -> stacked log-mel [T, mel_bins * factor]."""
    return stack_frames(log_mel_spectrogram(audio, cfg), cfg.downsample_factor)


def num_feature_frames(n_samples: int, cfg: RNNTConfig) -> int:
    """Output length of `preprocess_audio` for n input samples."""
    return num_frames(n_samples, cfg) // cfg.downsample_factor
