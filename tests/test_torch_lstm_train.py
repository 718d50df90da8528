"""Port LSTM training path (rnnt_tpu_torch.ops.lstm_cuda.lstm_seq: the plain
versions of kernels K4 and K5 on the CPU, and the training BatchNorm and
dropout of models.lstm) vs the JAX package's `lstm_seq` (the Pallas forward
and backward kernels in interpret mode) and `batch_norm(training=True)`.
fp32: 1e-5 (summation order only); bf16: the outputs and gradients within
two bf16 ulps of their magnitude (2 ** -7, relative to the largest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.models import lstm as JL
from rnnt_tpu.ops.lstm_pallas import lstm_seq as j_lstm_seq
from rnnt_tpu_torch.models import lstm as TL
from rnnt_tpu_torch.ops import lstm_cuda

torch.set_num_threads(1)

B, T, F, H, P = 8, 5, 6, 16, 8


def _params(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for k, s in (("wx", (F, 4 * H)), ("wh", (P, 4 * H)),
                           ("bias", (4 * H,)), ("wp", (H, P)))}
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    dy = rng.standard_normal((B, T, P)).astype(np.float32)
    return params, x, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_seq_forward_and_grads_match_jax(dtype):
    params, x, dy = _params(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}

    def j_fn(p, xx):
        y, _ = j_lstm_seq(p, xx, (jnp.zeros((B, H), jnp.float32),
                                  jnp.zeros((B, P), jdt)))
        return jnp.sum(y.astype(jnp.float32) * dy), y

    (_, jy), jg = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x, jdt))
    tp = {k: torch.from_numpy(v).to(tdt).requires_grad_()
          for k, v in params.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ty, (c_fin, h_fin) = lstm_cuda.lstm_seq(
        tx, tp["wx"], tp["wh"], tp["bias"], tp["wp"], torch.zeros(B, H),
        torch.zeros(B, P, dtype=tdt))
    assert torch.equal(h_fin, ty[:, -1])
    (ty.float() * torch.from_numpy(dy)).sum().backward()
    pairs = [(ty, jy), (tx.grad, jg[1])] + [(tp[k].grad, jg[0][k])
                                           for k in params]
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()


def test_kernel_wrappers_run_plain_versions_on_cpu():
    params, x, _ = _params(1)
    rng = np.random.default_rng(2)
    xp = torch.from_numpy(x @ params["wx"]).transpose(0, 1).contiguous()
    wh, wp, bias = (torch.from_numpy(params[k]) for k in ("wh", "wp", "bias"))
    h0 = torch.from_numpy(rng.standard_normal((B, P)).astype(np.float32))
    c0 = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
    n_fwd, n_bwd = lstm_cuda.lstm_fwd.launches, lstm_cuda.lstm_bwd.launches
    h_seq, z_seq, c_seq, c_fin = lstm_cuda.lstm_fwd(xp, wh, wp, bias, h0, c0)
    # the inference recurrence is the same loop without the residuals
    h_inf, c_inf = lstm_cuda.lstm_seq_infer(xp, wh, wp, bias, h0, c0)
    assert torch.equal(h_seq, h_inf) and torch.equal(c_fin, c_inf)
    dout = torch.from_numpy(rng.standard_normal((T, B, P)).astype(np.float32))
    dz, dht, dh0, dc0 = lstm_cuda.lstm_bwd(z_seq, c_seq, c0, dout,
                                           wh.t().contiguous(),
                                           wp.t().contiguous())
    assert (lstm_cuda.lstm_fwd.launches, lstm_cuda.lstm_bwd.launches) == (
        n_fwd, n_bwd)  # no kernel on the CPU
    assert dz.shape == (T, B, 4 * H) and dht.shape == (T, B, P)
    assert dh0.shape == (B, P) and dc0.shape == (B, H)
    # dh_total of the last step is the output gradient itself
    assert torch.equal(dht[-1], dout[-1])
    with pytest.raises(ValueError):
        lstm_cuda.lstm_bwd(z_seq, c_seq, c0, dout, wp, wh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, t", [(20, 4), (3, 65)])
def test_lstm_bwd_plain_matches_jax_kernel(b, t, dtype):
    """K5's plain version (what the card's K5 is held to) against the JAX
    backward kernel itself, at a batch that is no multiple of 16 and at the
    prediction net's T = U+1 = 65: dz_seq, dh_total_seq, dh0, dc0."""
    from rnnt_tpu.ops.lstm_pallas import _bwd_call

    rng = np.random.default_rng(4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    arrays = [rng.uniform(-2, 2, (t, b, 4 * H)), rng.uniform(-1, 1, (t, b, H)),
              rng.uniform(-1, 1, (b, H)), rng.standard_normal((t, b, P)),
              rng.uniform(-0.5, 0.5, (4 * H, P)), rng.uniform(-0.5, 0.5, (P, H))]
    arrays = [a.astype(np.float32) for a in arrays]
    want = _bwd_call(*(jnp.asarray(a, jnp.float32 if i == 2 else jdt)
                       for i, a in enumerate(arrays)), Bt=b, dtype=jdt)
    got = lstm_cuda.lstm_bwd(*(torch.from_numpy(a).to(
        torch.float32 if i == 2 else tdt) for i, a in enumerate(arrays)))
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(g - w).max() <= 2 ** -7 * np.abs(w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_plain_versions_match_jax_kernels_at_wide_width(kernel, dtype):
    """K4's and K5's plain versions against the JAX forward and backward
    kernels at H=3072, P=768 (B=2, T=3): the widths of the shape that
    takes the FMA design of both kernels in bf16 on the card."""
    from rnnt_tpu.ops.lstm_pallas import _bwd_call, _fwd_call

    b, t, h, p = 2, 3, 3072, 768
    rng = np.random.default_rng(5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if kernel == "fwd":  # xp, wh, wp, bias, h0, c0
        arrays = [rng.uniform(-2, 2, (t, b, 4 * h)),
                  rng.uniform(-1, 1, (p, 4 * h)) / np.sqrt(p),
                  rng.uniform(-1, 1, (h, p)) / np.sqrt(h),
                  rng.uniform(-1, 1, (4 * h,)), rng.uniform(-1, 1, (b, p)),
                  rng.uniform(-1, 1, (b, h))]
        f32 = (5,)
        call, port = _fwd_call, lstm_cuda.lstm_fwd
    else:  # z_seq, c_seq, c0, dout, whT, wpT
        arrays = [rng.uniform(-2, 2, (t, b, 4 * h)),
                  rng.uniform(-1, 1, (t, b, h)), rng.uniform(-1, 1, (b, h)),
                  rng.standard_normal((t, b, p)),
                  rng.uniform(-1, 1, (4 * h, p)) / np.sqrt(h),
                  rng.uniform(-1, 1, (p, h)) / np.sqrt(p)]
        f32 = (2,)
        call, port = _bwd_call, lstm_cuda.lstm_bwd
    arrays = [a.astype(np.float32) for a in arrays]
    want = call(*(jnp.asarray(a, jnp.float32 if i in f32 else jdt)
                  for i, a in enumerate(arrays)), Bt=b, dtype=jdt)
    got = port(*(torch.from_numpy(a).to(torch.float32 if i in f32 else tdt)
                 for i, a in enumerate(arrays)))
    if kernel == "fwd":  # (h_seq, z_seq, c_seq, h_fin, c_fin): no h_fin
        want = want[:3] + want[4:]
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(g - w).max() <= 2 ** -7 * np.abs(w).max()


def test_training_batch_norm_and_dropout():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32) * 2 + 1
    vals = {k: rng.standard_normal(5).astype(np.float32)
            for k in ("scale", "bias", "mean")}
    vals["var"] = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    bn = TL.BatchNorm(5)
    with torch.no_grad():
        for k, v in vals.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    y, (mean, var) = bn.forward_train(torch.from_numpy(x))
    jy, jstats = JL.batch_norm(vals, jnp.asarray(x), training=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jstats["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jstats["var"]),
                               rtol=1e-6)
    # the running statistics are returned, not changed
    np.testing.assert_array_equal(bn.mean.numpy(), vals["mean"])
    g = torch.Generator().manual_seed(0)
    t = torch.ones(1000, 8)
    d = TL.dropout(t, 0.25, g)
    kept = d != 0
    assert 0.6 < float(kept.float().mean()) < 0.9
    assert torch.allclose(d[kept], torch.full_like(d[kept], 1 / 0.75))
    assert TL.dropout(t, 0.0, g) is t
