"""Fused joint network + RNN-T loss: the port of
`rnnt_tpu.ops.joint_loss_fused`, one device or a vocabulary shard.

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

Vocab tensor parallelism (`tp`, a `parallel.mesh.VocabShard`; the JAX
shard_map path): W2 and b2 hold this rank's V/mp columns.  The labels are
shifted into the shard's coordinates (another shard's ids fall outside
[0, V/mp) and match nothing), K6 reduces the local columns, blank is NEG
on every shard but 0, and one MAX all-reduce (denom, blank, emit) and one
SUM all-reduce (exp(denom - max)) over the model group combine the
full-vocab planes, on which K7 runs the lattice, replicated across the
group.  The backward starts from the full cotangent on every rank: the
blank term is shard 0's, out-of-shard labels scatter nothing, df, dg and
db1 are partial sums over the local columns, all-reduced over the model
group in fp32, and dW2, db2 stay local.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rnnt_tpu_torch.ops import lattice_cuda, planes_cuda
from rnnt_tpu_torch.ops.matmul import matmul_f32, mm_f32
from rnnt_tpu_torch.ops.rnnt_loss_ref import NEG, occupancies, pad_labels
from rnnt_tpu_torch.parallel import mesh as mesh_mod
from rnnt_tpu_torch.trace import spanned

_BWD_CHUNK = 8  # batch rows whose [chunk, T, U+1, V] tensors coexist


def shift_labels(labels_pad, w2, tp):
    """Global label ids -> this shard's columns (unchanged for tp None)."""
    return labels_pad if tp is None else labels_pad - tp.index * w2.shape[1]


def combine_planes(denom, blank, emit, tp):
    """Full-vocab planes from every shard's partial planes: the max of the
    denominators, blank (shard 0's: NEG elsewhere) and emit (the owner's:
    NEG elsewhere) in one MAX all-reduce, then the logsumexp's sum of
    exp(denom - max) in one SUM all-reduce."""
    if tp.index != 0:
        blank = torch.full_like(blank, NEG)
    top = torch.stack([denom, blank, emit])
    mesh_mod.all_reduce_(top, tp.group, dist.ReduceOp.MAX)
    m = top[0]
    s = torch.exp(denom - m)
    mesh_mod.all_reduce_(s, tp.group)
    return m + torch.log(s), top[1], top[2]


def planes(f, g, b1, w2, b2, labels, label_lengths, tp=None):
    """(denom, blank coefficient b, emit coefficient e) [B, T, U+1]: the
    log-softmax planes of the lattice, emit masked from u = U_b on (over
    the full vocabulary under `tp`)."""
    denom, blank, emit = planes_cuda.joint_planes(
        f, g, shift_labels(pad_labels(labels), w2, tp), b1, w2, b2)
    if tp is not None:
        denom, blank, emit = combine_planes(denom, blank, emit, tp)
    U1 = g.shape[1]
    u_idx = torch.arange(U1, device=f.device)[None, None, :]
    e = torch.where(u_idx < label_lengths.to(f.device)[:, None, None],
                    emit - denom, NEG)
    return denom, blank - denom, e


def dlogits_(logits, den, occ, gbl, gem, y, blank_own):
    """d loss / d logits of a chunk's logits [..., V] (this shard's columns)
    from the global denominator and the occupancies: the softmax times the
    occupancy, less the blank occupancy at column 0 (`blank_own`: this
    shard holds it) and the emit occupancy at each label's column (ids
    outside [0, V) scatter nothing).  Written over `logits`."""
    V = logits.shape[-1]
    d = torch.exp(logits.sub_(den[..., None])).mul_(occ[..., None])
    if blank_own:
        d[..., 0] -= gbl
    inside = (y >= 0) & (y < V)
    idx = y.long().clamp(0, V - 1)[..., None].expand(*d.shape[:-1], 1)
    d.scatter_add_(-1, idx, torch.where(inside, -gem, 0.0)[..., None])
    return d


def _chunk_grads(fc, gc, b1, w2, b2, occ, gbl, gem, den, yc, blank_own):
    """One batch chunk's (df, dg, db1, dW2, db2) from its recomputed
    logits (the JAX `chunk_bwd`); df and dg in fp32."""
    V = w2.shape[1]
    J = fc.shape[-1]
    pre = fc.float()[:, :, None, :] + gc.float()[:, None] + b1.float()
    h = torch.tanh(pre)
    hb = h.to(w2.dtype)
    logits = matmul_f32(hb, w2) + b2.float()
    dlogits = dlogits_(logits, den, occ, gbl, gem, yc[:, None, :], blank_own)
    dlb = dlogits.to(w2.dtype)
    dl2 = dlb.reshape(-1, V)
    dh = mm_f32(dl2, w2.t()).reshape(h.shape)
    dw2 = mm_f32(hb.reshape(-1, J).t(), dl2)
    db2 = dlogits.sum((0, 1, 2))
    dpre = dh * (1.0 - h * h)
    return dpre.sum(2), dpre.sum(1), dpre.sum((0, 1, 2)), dw2, db2


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, f, g, b1, w2, b2, labels, logit_lengths,
                label_lengths):
        denom, b, e = planes(f, g, b1, w2, b2, labels, label_lengths, tp)
        alpha, beta, ll = lattice_cuda.lattice_scan(b, e, logit_lengths,
                                                    label_lengths)
        ctx.tp = tp
        ctx.save_for_backward(f, g, b1, w2, b2, denom, b, e, alpha, beta, ll,
                              labels, logit_lengths, label_lengths)
        return -ll

    @staticmethod
    @spanned("rnnt.loss.bwd")
    def backward(ctx, ct):
        (f, g, b1, w2, b2, denom, b, e, alpha, beta, ll, labels,
         logit_lengths, label_lengths) = ctx.saved_tensors
        tp = ctx.tp
        occ, g_blank, g_emit = occupancies(alpha, beta, b, e, ll,
                                           logit_lengths, label_lengths, ct)
        B = f.shape[0]
        chunk = next(c for c in range(min(B, _BWD_CHUNK), 0, -1) if B % c == 0)
        y = shift_labels(pad_labels(labels), w2, tp)
        df = torch.empty(f.shape, dtype=torch.float32, device=f.device)
        dg = torch.empty(g.shape, dtype=torch.float32, device=f.device)
        db1 = torch.zeros(b1.shape, dtype=torch.float32, device=f.device)
        dw2 = torch.zeros(w2.shape, dtype=torch.float32, device=f.device)
        db2 = torch.zeros(b2.shape, dtype=torch.float32, device=f.device)
        for r0 in range(0, B, chunk):
            sl = slice(r0, r0 + chunk)
            dfc, dgc, db1c, dw2c, db2c = _chunk_grads(
                f[sl], g[sl], b1, w2, b2, occ[sl], g_blank[sl], g_emit[sl],
                denom[sl], y[sl], tp is None or tp.index == 0)
            df[sl], dg[sl] = dfc, dgc
            db1 += db1c
            dw2 += dw2c
            db2 += db2c
        if tp is not None:  # partial sums over this shard's columns
            mesh_mod.all_reduce_sum_((df, dg, db1), None, tp.group)
        return (None, df.to(f.dtype), dg.to(g.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), None, None, None)


def rnnt_loss_fused(f, g, b1, w2, b2, labels, logit_lengths, label_lengths,
                    tp=None):
    """Per-example RNN-T NLL from the joint's projected inputs f = enc @ W1
    [B, T, J] and g = pred @ W1 [B, U+1, J]; gradients flow to f, g, b1,
    w2, b2.  With `tp` (a `parallel.mesh.VocabShard`) w2 and b2 are this
    rank's columns and the NLL is the full vocabulary's; a VocabShard over
    a group of one runs that path with nothing to exchange."""
    return _FusedLoss.apply(tp, f, g, b1, w2, b2, labels, logit_lengths,
                            label_lengths)


@spanned("rnnt.loss")
def transducer_loss_fused(joint, enc, pred, labels, enc_lengths,
                          label_lengths, tp=None):
    """The fused loss from encoder [B, T, P] and prediction [B, U+1, P]
    activations and the joint module (w1, b1, w2, b2): the first Dense is
    applied to each side (W(a + b) = Wa + Wb), rounded to the activation
    dtype.  `tp`: w2 and b2 are vocab-sharded (`rnnt_loss_fused`)."""
    f = matmul_f32(enc, joint.w1).to(enc.dtype)
    g = matmul_f32(pred, joint.w1).to(pred.dtype)
    return rnnt_loss_fused(f, g, joint.b1, joint.w2, joint.b2, labels,
                           enc_lengths, label_lengths, tp)
