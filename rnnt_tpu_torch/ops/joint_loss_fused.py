"""Fused joint network + RNN-T loss: the port of
`rnnt_tpu.ops.joint_loss_fused` (the single-device path).

  joint:  logits[b,t,u,:] = tanh(f[b,t] + g[b,u] + b1) @ W2 + b2
  loss needs per cell only: denom = logsumexp_v, blank = logits[0],
                            emit = logits[y_u]

The forward never writes the [B, T, U+1, V] logits: kernel K6
(`ops.planes_cuda`) reduces each cell's logits to the three planes, and the
lattice runs in kernel K7 (`ops.lattice_cuda`; the JAX package runs its XLA
scans there, which compute the same function).  The backward follows the
JAX `_bwd`: occupancies from alpha and beta, then per chunk of at most
_BWD_CHUNK batch rows a recompute of the tanh tile and the logits and the
dh, dW2, df, dg, db1, db2 products, as plain PyTorch (the JAX package leaves
them to XLA outside any kernel).

Rounding points kept: f and g are (x @ W1) rounded to the activation dtype;
h is fp32 and rounded to W2's dtype before each product; logits, softmax
and dlogits are fp32; dlogits is rounded to the compute dtype before its two
products, whose results are fp32.
"""

from __future__ import annotations

import torch

from rnnt_tpu_torch.ops import lattice_cuda, planes_cuda
from rnnt_tpu_torch.ops.matmul import matmul_f32, mm_f32
from rnnt_tpu_torch.ops.rnnt_loss_ref import NEG, occupancies, pad_labels

_BWD_CHUNK = 8  # batch rows whose [chunk, T, U+1, V] tensors coexist


def planes(f, g, b1, w2, b2, labels, label_lengths):
    """(denom, blank coefficient b, emit coefficient e) [B, T, U+1]: the
    log-softmax planes of the lattice, emit masked from u = U_b on."""
    denom, blank, emit = planes_cuda.joint_planes(
        f, g, pad_labels(labels), b1, w2, b2)
    U1 = g.shape[1]
    u_idx = torch.arange(U1, device=f.device)[None, None, :]
    e = torch.where(u_idx < label_lengths.to(f.device)[:, None, None],
                    emit - denom, NEG)
    return denom, blank - denom, e


def _chunk_grads(fc, gc, b1, w2, b2, occ, gbl, gem, den, yc):
    """One batch chunk's (df, dg, db1, dW2, db2) from its recomputed
    logits (the JAX `chunk_bwd`)."""
    V = w2.shape[1]
    J = fc.shape[-1]
    pre = fc.float()[:, :, None, :] + gc.float()[:, None] + b1.float()
    h = torch.tanh(pre)
    hb = h.to(w2.dtype)
    logits = matmul_f32(hb, w2) + b2.float()
    dlogits = torch.exp(logits - den[..., None]) * occ[..., None]
    dlogits[..., 0] -= gbl
    idx = yc.long()[:, None, :, None].expand(*dlogits.shape[:3], 1)
    dlogits.scatter_add_(-1, idx, -gem[..., None])
    dlb = dlogits.to(w2.dtype)
    dl2 = dlb.reshape(-1, V)
    dh = mm_f32(dl2, w2.t()).reshape(h.shape)
    dw2 = mm_f32(hb.reshape(-1, J).t(), dl2)
    db2 = dlogits.sum((0, 1, 2))
    dpre = dh * (1.0 - h * h)
    return (dpre.sum(2).to(fc.dtype), dpre.sum(1).to(gc.dtype),
            dpre.sum((0, 1, 2)), dw2, db2)


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g, b1, w2, b2, labels, logit_lengths, label_lengths):
        denom, b, e = planes(f, g, b1, w2, b2, labels, label_lengths)
        alpha, beta, ll = lattice_cuda.lattice_scan(b, e, logit_lengths,
                                                    label_lengths)
        ctx.save_for_backward(f, g, b1, w2, b2, denom, b, e, alpha, beta, ll,
                              labels, logit_lengths, label_lengths)
        return -ll

    @staticmethod
    def backward(ctx, ct):
        (f, g, b1, w2, b2, denom, b, e, alpha, beta, ll, labels,
         logit_lengths, label_lengths) = ctx.saved_tensors
        occ, g_blank, g_emit = occupancies(alpha, beta, b, e, ll,
                                           logit_lengths, label_lengths, ct)
        B = f.shape[0]
        chunk = next(c for c in range(min(B, _BWD_CHUNK), 0, -1) if B % c == 0)
        y = pad_labels(labels)
        df, dg = torch.empty_like(f), torch.empty_like(g)
        db1 = torch.zeros(b1.shape, dtype=torch.float32, device=f.device)
        dw2 = torch.zeros(w2.shape, dtype=torch.float32, device=f.device)
        db2 = torch.zeros(b2.shape, dtype=torch.float32, device=f.device)
        for r0 in range(0, B, chunk):
            sl = slice(r0, r0 + chunk)
            dfc, dgc, db1c, dw2c, db2c = _chunk_grads(
                f[sl], g[sl], b1, w2, b2, occ[sl], g_blank[sl], g_emit[sl],
                denom[sl], y[sl])
            df[sl], dg[sl] = dfc, dgc
            db1 += db1c
            dw2 += dw2c
            db2 += db2c
        return (df, dg, db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype),
                None, None, None)


def rnnt_loss_fused(f, g, b1, w2, b2, labels, logit_lengths, label_lengths):
    """Per-example RNN-T NLL from the joint's projected inputs f = enc @ W1
    [B, T, J] and g = pred @ W1 [B, U+1, J]; gradients flow to f, g, b1,
    w2, b2."""
    return _FusedLoss.apply(f, g, b1, w2, b2, labels, logit_lengths,
                            label_lengths)


def transducer_loss_fused(joint, enc, pred, labels, enc_lengths,
                          label_lengths):
    """The fused loss from encoder [B, T, P] and prediction [B, U+1, P]
    activations and the joint module (w1, b1, w2, b2): the first Dense is
    applied to each side (W(a + b) = Wa + Wb), rounded to the activation
    dtype."""
    f = matmul_f32(enc, joint.w1).to(enc.dtype)
    g = matmul_f32(pred, joint.w1).to(pred.dtype)
    return rnnt_loss_fused(f, g, joint.b1, joint.w2, joint.b2, labels,
                           enc_lengths, label_lengths)
