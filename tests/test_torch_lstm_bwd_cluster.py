"""K5's bf16 designs seen from the CPU: the counters of the cluster design
(`lstm_bwd.launches_by_design`, `launches_by_cluster`) that CPU runs leave
untouched, and K5's plain version (what the card's K5 is held to) against
the JAX backward kernel in interpret mode at the Conformer's prediction
width, H = P = 640, which the card runs on clusters of 4.  Tolerances as in test_torch_lstm_train.py: fp32 1e-5; bf16 two
bf16 ulps of the largest magnitude (2 ** -7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu_torch.ops import lstm_cuda

torch.set_num_threads(1)


def _bwd_arrays(rng, t, b, h, p):
    """z_seq, c_seq, c0, dout, whT, wpT as float32 numpy arrays."""
    return [a.astype(np.float32) for a in (
        rng.uniform(-2, 2, (t, b, 4 * h)), rng.uniform(-1, 1, (t, b, h)),
        rng.uniform(-1, 1, (b, h)), rng.standard_normal((t, b, p)),
        rng.uniform(-1, 1, (4 * h, p)) / np.sqrt(h),
        rng.uniform(-1, 1, (p, h)) / np.sqrt(p))]


def test_cluster_counters_exist_and_cpu_runs_leave_them():
    bwd = lstm_cuda.lstm_bwd
    assert set(bwd.launches_by_design) == {"cluster", "fma"}
    assert set(bwd.launches_by_cluster) == {1, 2, 4}
    assert lstm_cuda._DESIGNS[3] == "cluster"
    before = (bwd.launches, dict(bwd.launches_by_design),
              dict(bwd.launches_by_cluster))
    for dt in (torch.float32, torch.bfloat16):
        args = [torch.from_numpy(a).to(torch.float32 if i == 2 else dt)
                for i, a in enumerate(_bwd_arrays(np.random.default_rng(6),
                                                  3, 4, 8, 8))]
        dz, dht, dh0, dc0 = bwd(*args)
        assert dz.dtype == dt and dh0.dtype == torch.float32
    assert (bwd.launches, bwd.launches_by_design,
            bwd.launches_by_cluster) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_bwd_plain_matches_jax_kernel_at_conformer_width(dtype):
    """H = P = 640 (the Conformer cell's 1-layer prediction LSTM), B=20 (no
    multiple of 16), T = 73 (its U+1): dz_seq, dh_total_seq, dh0, dc0."""
    from rnnt_tpu.ops.lstm_pallas import _bwd_call

    b, t, h, p = 20, 73, 640, 640
    arrays = _bwd_arrays(np.random.default_rng(7), t, b, h, p)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
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
