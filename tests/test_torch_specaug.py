"""The port's SpecAugment (rnnt_tpu_torch.ops.specaug) against
`rnnt_tpu.ops.specaug`: given JAX's own draws, the port's mask builder
masks bit for bit as `spec_augment` does (frequency, time, both; lengths
shorter than T; starts whose float32 product lands on an integer); with a
torch.Generator the JAX invariants hold; and the train step applies it
after the input noise, on every loss path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.ops.specaug import spec_augment as j_spec_augment
from rnnt_tpu_torch.config import tiny_config
from rnnt_tpu_torch.ops.specaug import Intervals, apply_masks, spec_augment
from rnnt_tpu_torch.train.state import create_train_state
from rnnt_tpu_torch.train.steps import LOSS_IMPLS, make_train_step

torch.set_num_threads(1)

BINS, STACK = 8, 3


def _mel(B, T, seed=0):
    rng = np.random.default_rng(seed)
    # strictly nonzero, so masked cells show as exact zeros
    return rng.uniform(0.5, 1.5, (B, T, BINS * STACK)).astype(np.float32)


def _jax_draws(key, B, n, max_width):
    """The draws `rnnt_tpu.ops.specaug._interval_mask` makes from `key`."""
    kw, ks = jax.random.split(key)
    w = jax.random.randint(kw, (B, n), 0, max_width + 1)
    u = jax.random.uniform(ks, (B, n))
    return Intervals(torch.from_numpy(np.array(w)),
                     torch.from_numpy(np.array(u)))


KINDS = {"freq": (3, 4, 0, 0), "time": (0, 0, 3, 9), "both": (2, 3, 2, 7)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_mask_builder_on_jax_draws_is_bitwise_jax(kind):
    fm, fw, tm, tw = KINDS[kind]
    B, T = 6, 40
    mel = _mel(B, T)
    lengths = np.array([40, 17, 3, 1, 29, 40], np.int32)
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(j_spec_augment(
            key, jnp.asarray(mel), jnp.asarray(lengths), mel_bins=BINS,
            freq_masks=fm, freq_width=fw, time_masks=tm, time_width=tw))
        kf, kt = jax.random.split(key)
        got = apply_masks(
            torch.from_numpy(mel), torch.from_numpy(lengths), mel_bins=BINS,
            freq=_jax_draws(kf, B, fm, fw) if fm else None,
            time=_jax_draws(kt, B, tm, tw) if tm else None).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert (got == 0).any()


def _near_integer_draws(n_pos, max_width):
    """Draws whose start product u * (bound - w + 1) rounds up to an
    integer in float32 but lies below it in float64, for every width."""
    w, u = [], []
    for width in range(max_width + 1):
        m = n_pos - width + 1
        for k in range(1, m):
            cand = np.nextafter(np.float32(k / m), np.float32(0))
            if np.float32(cand * np.float32(m)) == k and float(cand) * m < k:
                w.append(width)
                u.append(cand)
                break
    return np.array([w], np.int32), np.array([u], np.float32)


def test_starts_are_float32_products(monkeypatch):
    """JAX's start = floor(u * (bound - w + 1)) is a float32 product: fed
    draws where float64 would floor one lower, both packages mask alike."""
    T = 37
    w, u = _near_integer_draws(T, 12)
    assert w.shape[1] >= 4
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(w))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    mel = _mel(1, T)
    lengths = np.array([T], np.int32)
    want = np.asarray(j_spec_augment(
        jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(lengths),
        mel_bins=BINS, freq_masks=0, freq_width=0, time_masks=w.shape[1],
        time_width=12))
    got = apply_masks(torch.from_numpy(mel), torch.from_numpy(lengths),
                      mel_bins=BINS, time=Intervals(torch.from_numpy(w),
                                                    torch.from_numpy(u)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the float64 starts would differ
    f64 = np.floor(u.astype(np.float64) * (T - np.minimum(w, T) + 1))
    f32 = np.floor(u * (T - np.minimum(w, T) + 1).astype(np.float32))
    assert (f64 != f32).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generator_draws_keep_the_jax_invariants(dtype):
    B, T = 5, 30
    mel = torch.from_numpy(_mel(B, T, seed=3)).to(dtype)
    lengths = torch.tensor([30, 10, 20, 1, 25])
    gen = torch.Generator().manual_seed(9)
    out = spec_augment(gen, mel, lengths, mel_bins=BINS, freq_masks=2,
                       freq_width=3, time_masks=2, time_width=8)
    assert out.dtype == dtype and out.shape == mel.shape
    zero = (out == 0).numpy()
    frames = zero.all(axis=2)                               # [B, T]
    bins = zero.reshape(B, T, STACK, BINS).all(axis=(1, 2))  # [B, BINS]
    # a cell is zero exactly where its frame or its bin (every stacked
    # copy) is masked; padding frames are never masked
    want = frames[:, :, None] | np.tile(bins, (1, STACK))[:, None, :]
    np.testing.assert_array_equal(zero, want)
    for b in range(B):
        assert not frames[b, int(lengths[b]):].any()
    assert frames.any() and bins.any()
    assert torch.equal(out[~torch.from_numpy(zero)], mel[~torch.from_numpy(zero)])
    # the same generator state draws the same masks
    again = spec_augment(torch.Generator().manual_seed(9), mel, lengths,
                         mel_bins=BINS, freq_masks=2, freq_width=3,
                         time_masks=2, time_width=8)
    assert torch.equal(again, out)


def _batch(cfg, B=3, T=14, U=4, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, cfg.vocab_size, (B, U))
    return {"mel_specs": torch.from_numpy(rng.standard_normal(
                (B, T, cfg.input_feat_size)).astype(np.float32)),
            "pred_inp": torch.from_numpy(np.concatenate(
                [np.zeros((B, 1), np.int64), labels], 1)),
            "labels": torch.from_numpy(labels),
            "spec_lengths": torch.tensor([T, T - 5, T - 2]),
            "label_lengths": torch.tensor([U, U - 1, 2])}


@pytest.mark.parametrize("loss_impl", LOSS_IMPLS)
def test_train_step_masks_after_the_noise(loss_impl):
    """A step with noise and SpecAugment on equals a step with both off on
    the batch that the same generator state noised, then masked."""
    aug = dict(mel_bins=4, downsample_factor=3, input_noise_stddev=0.3,
               specaug_freq_masks=2, specaug_freq_width=2,
               specaug_time_masks=2, specaug_time_width=5)
    cfg_on = tiny_config(**aug, learning_rate=0.05)
    cfg_off = cfg_on.replace(input_noise_stddev=0.0, specaug_freq_masks=0,
                             specaug_time_masks=0)
    batch = _batch(cfg_on)
    s_on = create_train_state(cfg_on, torch.float32, "cpu")
    s_off = create_train_state(cfg_off, torch.float32, "cpu")
    g_on = torch.Generator().manual_seed(4)
    m_on = make_train_step(cfg_on, loss_impl=loss_impl)(s_on, batch, g_on)

    g_off = torch.Generator().manual_seed(4)
    mel = batch["mel_specs"]
    mel = mel + cfg_on.input_noise_stddev * torch.randn(mel.shape,
                                                         generator=g_off)
    mel = spec_augment(g_off, mel, batch["spec_lengths"], mel_bins=4,
                       freq_masks=2, freq_width=2, time_masks=2, time_width=5)
    assert (mel == 0).any()
    m_off = make_train_step(cfg_off, loss_impl=loss_impl)(
        s_off, {**batch, "mel_specs": mel}, g_off)
    assert torch.equal(m_on["loss"], m_off["loss"])
    for (n, a), (_, b) in zip(s_on.model.named_parameters(),
                              s_off.model.named_parameters()):
        assert torch.equal(a, b), n
    # without a generator, training applies neither
    s_plain = create_train_state(cfg_off, torch.float32, "cpu")
    s_nogen = create_train_state(cfg_on, torch.float32, "cpu")
    m_plain = make_train_step(cfg_off, loss_impl=loss_impl)(s_plain, batch)
    m_nogen = make_train_step(cfg_on, loss_impl=loss_impl)(s_nogen, batch)
    assert torch.equal(m_plain["loss"], m_nogen["loss"])
    assert not torch.equal(m_plain["loss"], m_on["loss"])
