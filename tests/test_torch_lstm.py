"""Port projected LSTM (rnnt_tpu_torch.models.lstm / ops.lstm_cuda, plain
version on the CPU) vs the JAX LSTM: the lax.scan path and the Pallas
inference kernel (lstm_seq_infer) in interpret mode.  fp32 on the CPU:
rtol = atol = 1e-5 (summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.models import lstm as JL
from rnnt_tpu.ops.lstm_pallas import lstm_seq_infer as j_seq_infer
from rnnt_tpu_torch.models import lstm as TL
from rnnt_tpu_torch.ops import lstm_cuda

torch.set_num_threads(1)

B, T, F, H, P = 8, 6, 8, 16, 12
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(nonzero_state: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    params = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for k, s in (("wx", (F, 4 * H)), ("wh", (P, 4 * H)),
                           ("bias", (4 * H,)), ("wp", (H, P)))}
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    if nonzero_state:
        state = (rng.standard_normal((B, H)).astype(np.float32),
                 rng.standard_normal((B, P)).astype(np.float32))
    else:
        state = (np.zeros((B, H), np.float32), np.zeros((B, P), np.float32))
    return params, x, state


def _port(params, x, state):
    lstm = TL.ProjLSTM(F, H, P)
    with torch.no_grad():
        for k, v in params.items():
            getattr(lstm, k).copy_(torch.from_numpy(v))
        y, (c, h) = lstm(torch.from_numpy(x),
                         tuple(torch.from_numpy(s) for s in state))
    return y.numpy(), c.numpy(), h.numpy()


@pytest.mark.parametrize("nonzero_state", [False, True])
@pytest.mark.parametrize("ref", ["scan", "pallas"])
def test_proj_lstm_parity(nonzero_state, ref):
    params, x, state = _case(nonzero_state)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tuple(jnp.asarray(s) for s in state)
    if ref == "scan":
        y, (c, h) = JL.lstm_layer(jp, jnp.asarray(x), js, impl="scan")
    else:
        y, (c, h) = j_seq_infer(jp, jnp.asarray(x), js)
    ty, tc, th = _port(params, x, state)
    np.testing.assert_allclose(ty, np.asarray(y), **TOL)
    np.testing.assert_allclose(tc, np.asarray(c), **TOL)
    np.testing.assert_allclose(th, np.asarray(h), **TOL)


def test_wrapper_runs_plain_version_on_cpu():
    params, x, state = _case(True, seed=1)
    xp = torch.from_numpy(x @ params["wx"]).transpose(0, 1).contiguous()
    args = (xp, torch.from_numpy(params["wh"]), torch.from_numpy(params["wp"]),
            torch.from_numpy(params["bias"]), torch.from_numpy(state[1]),
            torch.from_numpy(state[0]))
    before = lstm_cuda.lstm_seq_infer.launches
    h_seq, c_fin = lstm_cuda.lstm_seq_infer(*args)
    p_seq, p_fin = lstm_cuda.lstm_seq_infer_plain(*args)
    assert lstm_cuda.lstm_seq_infer.launches == before  # no kernel on CPU
    assert torch.equal(h_seq, p_seq) and torch.equal(c_fin, p_fin)
    with pytest.raises(ValueError):
        lstm_cuda.lstm_seq_infer(xp, args[2], args[1], *args[3:])


def test_norms_and_time_reduction():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    scale, bias = (rng.standard_normal(6).astype(np.float32) for _ in "sb")
    mean = rng.standard_normal(6).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    ln, bn = TL.LayerNorm(6), TL.BatchNorm(6)
    with torch.no_grad():
        for mod, vals in ((ln, dict(scale=scale, bias=bias)),
                          (bn, dict(scale=scale, bias=bias, mean=mean,
                                    var=var))):
            for k, v in vals.items():
                getattr(mod, k).copy_(torch.from_numpy(v))
        tx = torch.from_numpy(x)
        np.testing.assert_allclose(
            ln(tx).numpy(), np.asarray(JL.layer_norm(
                {"scale": scale, "bias": bias}, jnp.asarray(x))), **TOL)
        jbn, _ = JL.batch_norm({"scale": scale, "bias": bias, "mean": mean,
                                "var": var}, jnp.asarray(x), training=False)
        np.testing.assert_allclose(bn(tx).numpy(), np.asarray(jbn), **TOL)
    np.testing.assert_array_equal(
        TL.time_reduction(torch.from_numpy(x), 2).numpy(),
        np.asarray(JL.time_reduction(jnp.asarray(x), 2)))
    lens = np.array([0, 1, 4, 5], np.int32)
    np.testing.assert_array_equal(
        TL.reduced_length(torch.from_numpy(lens), 2).numpy(),
        np.asarray(JL.reduced_length(jnp.asarray(lens), 2)))
