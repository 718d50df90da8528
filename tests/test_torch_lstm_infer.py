"""Port LSTM inference (rnnt_tpu_torch.models.lstm.ProjLSTM in inference,
the plain version of kernel K2 on the CPU) vs the JAX package's
`lstm_seq_infer` (the Pallas inference kernel in interpret mode), at the
serving shapes: B=1 with T = 1, 2 and 9 (a prediction-net step, a stream
chunk, a short utterance), and widths that 132 blocks do not divide, with
a nonzero carried state.

fp32: rtol = atol = 1e-5 (summation order only).  bf16: every output
within one bf16 ulp of the largest |h| (2 ** -7 of it; c_fin, fp32, of
the largest |c|): the two products round h and hid to bf16 after fp32 sums
taken in different orders, so a value may land one ulp apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.ops.lstm_pallas import lstm_seq_infer as j_seq_infer
from rnnt_tpu_torch.models import lstm as TL
from rnnt_tpu_torch.ops import lstm_cuda

torch.set_num_threads(1)

F = 12
WIDTHS = {"narrow": (16, 12), "ragged": (200, 136)}  # (H, P); 132 ∤ 200


def _case(B, T, H, P, seed):
    rng = np.random.default_rng(seed)
    # Glorot-uniform scales, as ProjLSTM.reset_ draws them
    params = {k: rng.uniform(-1, 1, s).astype(np.float32)
              * np.float32((6.0 / sum(s) if len(s) == 2 else 0.25) ** 0.5)
              for k, s in (("wx", (F, 4 * H)), ("wh", (P, 4 * H)),
                           ("bias", (4 * H,)), ("wp", (H, P)))}
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    state = (rng.standard_normal((B, H)).astype(np.float32),
             rng.uniform(-0.5, 0.5, (B, P)).astype(np.float32))
    return params, x, state


def _port(params, x, state, tdt):
    F_in, H4 = params["wx"].shape
    lstm = TL.ProjLSTM(F_in, H4 // 4, params["wp"].shape[1]).to(tdt)
    with torch.no_grad():
        for k, v in params.items():
            getattr(lstm, k).copy_(torch.from_numpy(v))
        y, (c, h) = lstm(torch.from_numpy(x).to(tdt),
                         (torch.from_numpy(state[0]),
                          torch.from_numpy(state[1]).to(tdt)))
    return [a.float().numpy() for a in (y, c, h)]


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("T", [1, 2, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proj_lstm_infer_matches_jax_at_b1(dtype, T, width):
    H, P = WIDTHS[width]
    params, x, state = _case(1, T, H, P, seed=T)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    y, (c, h) = j_seq_infer(jp, jnp.asarray(x, jdt),
                            (jnp.asarray(state[0]),
                             jnp.asarray(state[1], jdt)))
    want = [np.asarray(a, np.float32) for a in (y, c, h)]
    got = _port(params, x, state, tdt)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(g - w).max() <= 2 ** -7 * np.abs(w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_split_equals_one_call_exactly(dtype):
    """Two K2 calls with the state carried (h_fin = h_seq[-1], c_fin) give
    bit for bit what one call over the whole sequence gives."""
    H, P = WIDTHS["ragged"]
    params, x, state = _case(2, 7, H, P, seed=11)
    dt = getattr(torch, dtype)
    xp = torch.from_numpy(
        np.einsum("btf,fg->tbg", x, params["wx"])).to(dt).contiguous()
    wh, wp, bias = (torch.from_numpy(params[k]).to(dt)
                    for k in ("wh", "wp", "bias"))
    h0, c0 = torch.from_numpy(state[1]).to(dt), torch.from_numpy(state[0])
    h_all, c_all = lstm_cuda.lstm_seq_infer(xp, wh, wp, bias, h0, c0)
    h_a, c_a = lstm_cuda.lstm_seq_infer(xp[:3], wh, wp, bias, h0, c0)
    h_b, c_b = lstm_cuda.lstm_seq_infer(xp[3:], wh, wp, bias, h_a[-1], c_a)
    assert torch.equal(torch.cat([h_a, h_b]), h_all)
    assert torch.equal(c_b, c_all)


def test_launch_counts_by_design_untouched_on_cpu():
    H, P = WIDTHS["narrow"]
    params, x, state = _case(1, 2, H, P, seed=3)
    counts = lstm_cuda.lstm_seq_infer.launches_by_design
    assert set(counts) == {"lat", "mma", "fma"}
    before = (lstm_cuda.lstm_seq_infer.launches, dict(counts))
    _port(params, x, state, torch.bfloat16)
    assert (lstm_cuda.lstm_seq_infer.launches,
            dict(lstm_cuda.lstm_seq_infer.launches_by_design)) == before
