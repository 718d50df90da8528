"""Port frontend (rnnt_tpu_torch.ops.features / features_cuda) vs the JAX
frontend: the XLA rfft path and the Pallas kernel in interpret mode.
Tolerance atol 2e-4, the JAX package's own bound for the kernel-vs-rfft
comparison (fp32 DFT rounding, amplified by the log at quiet bins)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import RNNTConfig, tiny_config
from rnnt_tpu.ops import features as JF
from rnnt_tpu.ops.features_pallas import log_mel_spectrogram_pallas
from rnnt_tpu_torch.config import RNNTConfig as TConfig
from rnnt_tpu_torch.config import tiny_config as t_tiny_config
from rnnt_tpu_torch.ops import features as TF
from rnnt_tpu_torch.ops import features_cuda

torch.set_num_threads(1)

CFG, TCFG = RNNTConfig(), TConfig()


def _audio(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(
        np.float32)


@pytest.mark.parametrize("n", [400, 560, 16000, 16000 * 4 + 37])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_log_mel_parity(n, ref):
    audio = _audio(n, n)
    if ref == "xla":
        want = JF.log_mel_spectrogram(jnp.asarray(audio), CFG)
    else:
        want = log_mel_spectrogram_pallas(jnp.asarray(audio), CFG,
                                          interpret=True)
    got = TF.log_mel_spectrogram(torch.from_numpy(audio), TCFG)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_preprocess_audio_parity():
    audio = _audio(16000 * 2 + 123, 7)
    want = JF.preprocess_audio(jnp.asarray(audio), CFG)
    got = TF.preprocess_audio(torch.from_numpy(audio), TCFG)
    assert tuple(got.shape) == want.shape
    assert got.shape[0] == TF.num_feature_frames(audio.shape[0], TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_nondefault_geometry():
    # hop not dividing the frame length, 8 kHz, 40 mels
    cfg = tiny_config(sample_rate=8000, mel_bins=40)
    tcfg = t_tiny_config(sample_rate=8000, mel_bins=40)
    audio = _audio(8000, 3)
    want = JF.log_mel_spectrogram(jnp.asarray(audio), cfg)
    got = TF.log_mel_spectrogram(torch.from_numpy(audio), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_too_short_audio_yields_zero_frames():
    got = features_cuda.log_mel_frontend(torch.zeros(399), TCFG)
    assert tuple(got.shape) == (0, TCFG.mel_bins)


def test_kernel_matrices_reproduce_the_frontend():
    """The CUDA kernel's constant inputs (`features_cuda.fft_tables`: the
    window, the twiddles, the sparse mel filters), used with an FFT on the
    CPU, reproduce the JAX rfft frontend; the twiddles are exp(-2 pi i t /
    nfft) rounded to fp32."""
    audio = _audio(16000, 11)
    tables = features_cuda.fft_tables(TCFG)
    flen, hop = TCFG.frame_length_samples, TCFG.frame_step_samples
    nfft = TF.next_pow2(flen)
    ang = -2.0 * np.pi * np.arange(nfft // 2) / nfft
    np.testing.assert_array_equal(
        tables.twiddles, np.stack([np.cos(ang), np.sin(ang)], 1).astype(
            np.float32))
    nf = TF.num_frames(audio.shape[0], TCFG)
    idx = np.arange(nf)[:, None] * hop + np.arange(flen)[None, :]
    frames = torch.from_numpy(audio[idx] * tables.window)
    mag = torch.fft.rfft(frames, n=nfft).abs()
    mel = torch.from_numpy(features_cuda.dense_mel(
        tables.mel_idx, tables.mel_w, nfft // 2 + 1))
    got = TF.subtract_mean(torch.log(mag @ mel + 1e-6))
    want = JF.log_mel_spectrogram(jnp.asarray(audio), CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_mel_matrix_matches_jax():
    np.testing.assert_array_equal(
        TF.mel_weight_matrix(80, 257, 16000, 125.0, 7600.0),
        JF.mel_weight_matrix(80, 257, 16000, 125.0, 7600.0))
