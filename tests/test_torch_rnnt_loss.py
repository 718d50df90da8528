"""Port RNN-T loss (rnnt_tpu_torch.ops.rnnt_loss_ref, .lattice_cuda,
.rnnt_loss) vs the JAX package: the pure-JAX reference loss and its
gradient, the NumPy lattice oracle, and the Pallas lattice kernel in
interpret mode.  fp32 on the CPU: losses rtol 1e-5, gradients atol 1e-5,
lattice 1e-5 (summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rnnt_tpu.ops.rnnt_loss_ref as JR
from rnnt_tpu.ops.rnnt_loss_pallas import lattice_scan_pallas
from rnnt_tpu_torch.ops import lattice_cuda, rnnt_loss_ref as TR
from rnnt_tpu_torch.ops.rnnt_loss import rnnt_loss

torch.set_num_threads(1)


def _case(seed, B=3, T=7, U=4, V=9):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    fl = np.array([T] + list(rng.integers(1, T + 1, B - 1)), np.int32)
    yl = np.array([U] + list(rng.integers(0, U + 1, B - 1)), np.int32)
    return logits, labels, fl, yl


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


@pytest.mark.parametrize("impl", ["ref", "pallas", "auto"])
def test_loss_and_grad_match_jax_reference(impl):
    logits, labels, fl, yl = _case(0)
    j_args = [jnp.asarray(a) for a in (labels, fl, yl)]
    want = np.asarray(JR.rnnt_loss_ref(jnp.asarray(logits), *j_args))
    j_grad = jax.grad(lambda x: jnp.sum(JR.rnnt_loss_ref(x, *j_args)
                                        * jnp.arange(1.0, 4.0)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = rnnt_loss(x, *_t(labels, fl, yl), impl=impl)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(
        got.detach().numpy(),
        JR.rnnt_loss_numpy(logits, labels, fl, yl), rtol=1e-5)
    (got * torch.arange(1.0, 4.0)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), atol=1e-5)


@pytest.mark.parametrize("B, T, U", [(4, 6, 5), (2, 5, 1099)])
def test_plain_lattice_matches_pallas_kernel_interpret(B, T, U):
    # U+1 = 1100 is above one thread a label position of K7's block (1024):
    # the plain scans are what the card holds K7 to there
    logits, labels, fl, yl = _case(1, B=B, T=T, U=U, V=7)
    _, b, e = JR._gather_coeffs(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(yl))
    ja, jb, jll = lattice_scan_pallas(b, e, jnp.asarray(fl), jnp.asarray(yl),
                                      interpret=True)
    ta, tb, tll = TR.lattice_scan_plain(*_t(np.asarray(b), np.asarray(e), fl,
                                            yl))
    U1 = b.shape[2]
    t_idx = np.arange(T)[None, :, None]
    u_idx = np.arange(U1)[None, None, :]
    valid = (t_idx < fl[:, None, None]) & (u_idx <= yl[:, None, None])
    np.testing.assert_allclose(ta.numpy()[valid], np.asarray(ja)[valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.numpy()[valid], np.asarray(jb)[valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-5)


def test_lattice_scans_match_xla_scans_everywhere():
    # the JAX fused loss's lattice (ref._alpha_scan / _beta_scan), on every
    # cell, padded ones included
    logits, labels, fl, yl = _case(2)
    _, b, e = JR._gather_coeffs(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(yl))
    alpha = JR._alpha_scan(b, e)
    beta = JR._beta_scan(b, e, jnp.asarray(fl), jnp.asarray(yl))
    tb_, te_ = _t(np.asarray(b), np.asarray(e))
    np.testing.assert_allclose(TR.alpha_scan(tb_, te_).numpy(),
                               np.asarray(alpha), rtol=1e-5)
    np.testing.assert_allclose(TR.beta_scan(tb_, te_, *_t(fl, yl)).numpy(),
                               np.asarray(beta), rtol=1e-5)


def test_lattice_wrapper_runs_plain_version_on_cpu():
    logits, labels, fl, yl = _case(3)
    _, b, e = TR.gather_coeffs(*_t(logits, labels, yl))
    before = lattice_cuda.lattice_scan.launches
    got = lattice_cuda.lattice_scan(b, e, *_t(fl, yl))
    want = TR.lattice_scan_plain(b, e, *_t(fl, yl))
    assert lattice_cuda.lattice_scan.launches == before  # no kernel on CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        lattice_cuda.lattice_scan(b, e[:, :, :-1], *_t(fl, yl))
    with pytest.raises(ValueError):
        rnnt_loss(torch.from_numpy(logits), *_t(labels, fl, yl),
                  impl="banded")
