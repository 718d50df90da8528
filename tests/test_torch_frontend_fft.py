"""The frontend kernel's schedule (`csrc/frontend.cu`), emulated step by
step in numpy from the host tables that `ops/features_cuda.py` passes to
it (window, twiddles, sparse mel filters): the fp32 windowed frame packed as
nfft/2 complex points at bit-reversed positions, the radix-2 stages in
place and the real-FFT split in fp64 (on the fp32 table values), the
magnitudes rounded to fp32 and the mel sums in fp32 in ascending bin
order.  Held at atol 2e-4 (the kernel's gate on the card; the log
amplifies rounding at quiet bins) against the port's plain version and the
JAX Pallas kernel in interpret mode, both after mean subtraction; and, at a
spectral null where an fp32 FFT errs by more than that, against the
function computed in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import RNNTConfig
from rnnt_tpu.ops.features_pallas import log_mel_spectrogram_pallas
from rnnt_tpu_torch.config import RNNTConfig as TConfig
from rnnt_tpu_torch.ops import features as TF
from rnnt_tpu_torch.ops import features_cuda

torch.set_num_threads(1)

f32 = np.float32


def emulate_kernel(audio: np.ndarray, cfg, fft_dtype=np.float64) -> np.ndarray:
    """log-mel [frames, M] before mean subtraction, by the kernel's steps
    (every frame at once; the butterflies and the split in `fft_dtype`,
    fp64 as the kernel, every other step in fp32)."""
    win, tw, mel_idx, mel_w = features_cuda.fft_tables(cfg)
    L, hop = cfg.frame_length_samples, cfg.frame_step_samples
    nfft = TF.next_pow2(L)
    n, log2n = nfft // 2, (nfft // 2).bit_length() - 1
    nf = TF.num_frames(audio.shape[0], cfg)
    frames = np.zeros((nf, nfft), f32)
    for f in range(nf):
        frames[f, :L] = audio[f * hop: f * hop + L] * win
    # 1. pairs at bit-reversed positions
    rev = np.array([int(format(m, f"0{log2n}b")[::-1], 2) for m in range(n)])
    re, im = np.zeros((nf, n), fft_dtype), np.zeros((nf, n), fft_dtype)
    re[:, rev], im[:, rev] = frames[:, 0::2], frames[:, 1::2]
    # 2. radix-2 stages in place
    wr, wi = tw[:, 0].astype(fft_dtype), tw[:, 1].astype(fft_dtype)
    for s in range(log2n):
        half = 1 << s
        b = np.arange(n // 2)
        p = b & (half - 1)
        i = ((b - p) << 1) + p
        j = i + half
        w_r, w_i = wr[p * (n >> s)], wi[p * (n >> s)]
        tr = re[:, j] * w_r - im[:, j] * w_i
        ti = re[:, j] * w_i + im[:, j] * w_r
        ur, ui = re[:, i].copy(), im[:, i].copy()
        re[:, i], im[:, i] = ur + tr, ui + ti
        re[:, j], im[:, j] = ur - tr, ui - ti
    # 3. the split: bins k and n - k from Z[k], Z[n - k]
    k = np.arange(n // 2 + 1)
    c = (n - k) & (n - 1)
    h = fft_dtype(0.5)
    er, ei = h * (re[:, k] + re[:, c]), h * (im[:, k] - im[:, c])
    o_r, o_i = h * (im[:, k] + im[:, c]), -h * (re[:, k] - re[:, c])
    tr = o_r * wr[k] - o_i * wi[k]
    ti = o_r * wi[k] + o_i * wr[k]
    mag = np.zeros((nf, n + 1), f32)  # rounded to fp32 on the store
    mag[:, k] = np.sqrt((er + tr) ** 2 + (ei + ti) ** 2)
    upper = k[2 * k != n]
    mag[:, n - upper] = np.sqrt((er - tr)[:, 2 * k != n] ** 2
                                + (ei - ti)[:, 2 * k != n] ** 2)
    # 4. sparse mel sums in ascending bin order, then the log
    M = cfg.mel_bins
    mel = np.zeros((nf, M), f32)
    for m in range(M):
        lo, cnt, off = mel_idx[:, m]
        for q in range(cnt):
            mel[:, m] = mel[:, m] + mag[:, lo + q] * mel_w[off + q]
    return np.log(mel + f32(1e-6))


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    tone = sum(0.2 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
               for _ in range(3))
    return (tone + 0.02 * rng.standard_normal(n)).astype(f32)


def _mean_sub(x):
    return x - (x.mean(0) + f32(1e-8))


GEOMETRIES = {
    "parity": (dict(), 16000),
    "8k_40mel": (dict(sample_rate=8000, mel_bins=40), 8000),
    "frame_eq_nfft": (dict(frame_length=0.032), 9000),
    "shorter_than_a_frame": (dict(), 399),
    "tcp_chunk": (dict(), 1360),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_kernel_schedule_matches_plain_and_pallas(geometry):
    over, n = GEOMETRIES[geometry]
    cfg, tcfg = RNNTConfig(**over), TConfig(**over)
    audio = _audio(n, n)
    got = emulate_kernel(audio, tcfg)
    frames = TF.num_frames(n, tcfg)
    assert got.shape == (frames, tcfg.mel_bins)
    if geometry == "frame_eq_nfft":
        assert tcfg.frame_length_samples == TF.next_pow2(
            tcfg.frame_length_samples)
    if frames == 0:
        assert tuple(features_cuda.log_mel_frontend(
            torch.from_numpy(audio), tcfg).shape) == (0, tcfg.mel_bins)
        return
    plain = TF.log_mel_plain(torch.from_numpy(audio), tcfg).numpy()
    pallas = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(audio), cfg,
                                                   interpret=True))
    np.testing.assert_allclose(_mean_sub(got), _mean_sub(plain), atol=2e-4)
    np.testing.assert_allclose(_mean_sub(got), pallas, atol=2e-4)


def test_fp64_butterflies_hold_spectral_nulls():
    """Three tones at 1-3 kHz over a -46 dB noise floor, 16-bit samples: the
    low mel bins, one or two FFT bins wide, fall into spectral nulls, where
    an fp32 radix-2 FFT's rounding (~eps log2 n of the frame's peak) is a
    relative error the log turns into 4e-4, over the 2e-4 gate.  With the
    butterflies and the split in fp64, as the kernel runs them, the
    schedule stays within 2e-4 of the function computed in float64."""
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    audio = sum(0.2 * np.sin(2 * np.pi * rng.uniform(1000, 3000) * t
                             + rng.uniform(0, 6.3)) for _ in range(3))
    audio = audio + 0.005 * rng.standard_normal(t.shape[0])
    audio = (np.round(np.clip(audio, -1, 1) * 32767.0) / 32768.0).astype(f32)
    tcfg = TConfig()
    exact = _mean_sub(TF.log_mel_plain(torch.from_numpy(audio), tcfg,
                                       dtype=torch.float64).numpy())
    fp32_err = np.abs(_mean_sub(emulate_kernel(audio, tcfg, np.float32))
                      - exact).max()
    kernel_err = np.abs(_mean_sub(emulate_kernel(audio, tcfg)) - exact).max()
    assert fp32_err > 2e-4
    assert kernel_err <= 1e-4


@pytest.mark.parametrize("geometry", ["parity", "8k_40mel", "frame_eq_nfft"])
def test_sparse_mel_tables_rebuild_the_filterbank(geometry):
    tcfg = TConfig(**GEOMETRIES[geometry][0])
    nfft = TF.next_pow2(tcfg.frame_length_samples)
    dense = TF.mel_weight_matrix(tcfg.mel_bins, nfft // 2 + 1,
                                 tcfg.sample_rate, tcfg.hertz_low,
                                 tcfg.hertz_high)
    t = features_cuda.fft_tables(tcfg)
    np.testing.assert_array_equal(
        features_cuda.dense_mel(t.mel_idx, t.mel_w, nfft // 2 + 1), dense)
    assert t.mel_w.size == np.count_nonzero(dense)
    assert t.twiddles.shape == (nfft // 2, 2)


def test_geometry_outside_the_design_raises():
    # 25 ms at 1 kHz: 25 samples, FFT length 32 < 64
    with pytest.raises(ValueError, match=r"outside \[64, 4096\]"):
        features_cuda.fft_tables(TConfig(sample_rate=1000))
