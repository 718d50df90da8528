"""Port fused joint + loss (rnnt_tpu_torch.ops.joint_loss_fused, the plain
version of the plane kernel K6 in ops.planes_cuda) vs the JAX package: the
Pallas plane kernel `_compute_planes` in interpret mode (1e-5), and
`transducer_loss_fused` with its gradients (loss 1e-4, gradients rtol 2e-3,
the JAX package's own bounds between its fused and unfused losses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.ops import joint_loss_fused as JF
from rnnt_tpu_torch.ops import joint_loss_fused as TF, planes_cuda

torch.set_num_threads(1)


def _case(seed, B, T, U, P, J, V):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T, P)).astype(np.float32)
    pred = rng.standard_normal((B, U + 1, P)).astype(np.float32)
    jp = {"w1": (rng.standard_normal((P, J)) * 0.3).astype(np.float32),
          "b1": (rng.standard_normal(J) * 0.1).astype(np.float32),
          "w2": (rng.standard_normal((J, V)) * 0.3).astype(np.float32),
          "b2": (rng.standard_normal(V) * 0.1).astype(np.float32)}
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    fl = rng.integers(max(1, T // 2), T + 1, (B,)).astype(np.int32)
    yl = rng.integers(0, U + 1, (B,)).astype(np.int32)
    return enc, pred, jp, labels, fl, yl


class _Joint:
    """The fields of models.joint.Joint that the fused loss reads."""

    def __init__(self, jp):
        for k, v in jp.items():
            setattr(self, k, torch.from_numpy(v.copy()).requires_grad_())


def test_plain_planes_match_pallas_kernel_interpret():
    B, T, U1, J, V = 2, 9, 6, 16, 20
    rng = np.random.default_rng(4)
    f = rng.standard_normal((B, T, J)).astype(np.float32)
    g = rng.standard_normal((B, U1, J)).astype(np.float32)
    y = rng.integers(0, V, (B, U1)).astype(np.int32)
    b1 = (rng.standard_normal(J) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((J, V)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(V) * 0.1).astype(np.float32)
    want = JF._compute_planes(*(jnp.asarray(a) for a in (f, g, y, b1, w2, b2)))
    before = planes_cuda.joint_planes.launches
    got = planes_cuda.joint_planes(
        *(torch.from_numpy(a) for a in (f, g, y, b1, w2, b2)))
    assert planes_cuda.joint_planes.launches == before  # no kernel on CPU
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("B,T,U,P,J,V", [(2, 6, 3, 8, 16, 12),
                                         (3, 9, 5, 12, 8, 20)])
def test_fused_loss_and_grads_match_jax(B, T, U, P, J, V):
    enc, pred, jp, labels, fl, yl = _case(B * 10 + T, B, T, U, P, J, V)
    ja = [jnp.asarray(a) for a in (labels, fl, yl)]
    w = jnp.arange(1.0, B + 1.0)

    def j_loss(p, e, q):
        return JF.transducer_loss_fused(p, e, q, *ja)

    want = np.asarray(j_loss({k: jnp.asarray(v) for k, v in jp.items()},
                             jnp.asarray(enc), jnp.asarray(pred)))
    j_grads = jax.grad(lambda *a: jnp.sum(j_loss(*a) * w), argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(enc),
        jnp.asarray(pred))
    joint = _Joint(jp)
    te = torch.from_numpy(enc).requires_grad_()
    tp = torch.from_numpy(pred).requires_grad_()
    got = TF.transducer_loss_fused(
        joint, te, tp, *(torch.from_numpy(a) for a in (labels, fl, yl)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    (got * torch.arange(1.0, B + 1.0)).sum().backward()
    for k in jp:
        np.testing.assert_allclose(getattr(joint, k).grad.numpy(),
                                   np.asarray(j_grads[0][k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(j_grads[1]),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(j_grads[2]),
                               rtol=2e-3, atol=2e-4)


def test_backward_chunks_cover_odd_batches():
    # B=7 is chunked by 7 (the largest divisor <= 8); B=9 by 3: the chunked
    # gradient equals the one of a single chunk
    for B in (7, 9):
        enc, pred, jp, labels, fl, yl = _case(B, B, 5, 3, 6, 8, 10)
        grads = []
        for chunk in (TF._BWD_CHUNK, B):
            old, TF._BWD_CHUNK = TF._BWD_CHUNK, chunk
            try:
                joint = _Joint(jp)
                TF.transducer_loss_fused(
                    joint, torch.from_numpy(enc), torch.from_numpy(pred),
                    *(torch.from_numpy(a) for a in (labels, fl, yl))
                ).sum().backward()
                grads.append(joint.w2.grad)
            finally:
                TF._BWD_CHUNK = old
        torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)
