"""Banded (pruned) fused joint + RNN-T loss: the port of
`rnnt_tpu.ops.joint_loss_banded`, one device or a vocabulary shard.

The joint's V-reduction, the dominant cost of the loss, is computed only in
a label window of width W around each utterance's expected alignment
diagonal u ~ t * U_b / T_b.  Paths outside the band get log-probability
NEG, so the NLL is an upper bound on the exact NLL (a lower bound on the
log-likelihood), exact when the band covers U+1.

Each (example, tile of 8 frames) pair is one row of the plane kernel K6
(`ops.planes_cuda.joint_planes`): f is reshaped to [B * nT, 8, J], the
label window of g to [B * nT, W, J] and that of the labels to
[B * nT, W], and one launch reduces every row to its denom, blank and
emit planes [B * nT, 8, W].  The blank and emit coefficients are scattered
back into [B, T', U+1] planes with NEG outside the band, and the full
lattice runs in kernel K7 (`ops.lattice_cuda.lattice_scan`; the JAX package
runs its XLA scans there, which compute the same function).  An utterance
whose every path is pruned (its U_b / T_b slope too steep for the band)
reports a loss of 1e9 and a zero gradient.

The backward follows the JAX `_bwd`: occupancies from alpha and beta,
gathered to the band, then the fused loss's plain chain over the band's
cells (`joint_loss_fused.chunked_grads`: per batch chunk a recompute of the
tanh tile, the logits and dlogits and the dh, dW2, df, db1, db2 products;
the JAX package leaves them to XLA outside any kernel).  The band's
gradient for g is summed into its label rows from dpre rounded to the
weight dtype, as the JAX one-hot product does.

Vocab tensor parallelism (`tp`) is the fused loss's: the band rows' labels
shifted into the shard's columns, K6 over the local columns, the planes
combined over the model group (`joint_loss_fused.combine_planes`), and in
the backward the blank term on shard 0 only, no scatter for out-of-shard
labels, and df, dg, db1 summed over the model group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from rnnt_tpu_torch.ops import lattice_cuda, planes_cuda
from rnnt_tpu_torch.ops.joint_loss_fused import (chunked_grads,
                                                 combine_planes, grads_out,
                                                 project, shift_labels)
from rnnt_tpu_torch.ops.rnnt_loss_ref import NEG, occupancies, pad_labels
from rnnt_tpu_torch.trace import spanned

_T_TILE = 8     # frames a band window covers (a plane-kernel row's T)
PRUNED_LOSS = 1e9  # the loss of an utterance with every path pruned


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def band_starts(enc_lengths, label_lengths, T: int, U1: int, band: int):
    """u0 [B, nT] int32: each (example, tile of 8 frames)'s band start,
    centred on the line u = t * U_b / T_b and clipped into [0, U1 - band];
    the origin (0, 0) and the terminal cell (T_b - 1, U_b) always fall
    inside."""
    nT = _round_up(T, _T_TILE) // _T_TILE
    dev = enc_lengths.device
    mid_t = (torch.arange(nT, dtype=torch.float32, device=dev) * _T_TILE
             + (_T_TILE - 1) / 2.0)
    el = torch.clamp(enc_lengths.float(), min=1.0)[:, None]
    ul = label_lengths.to(dev).float()[:, None]
    center = (torch.minimum(mid_t[None, :], el - 1.0)
              / torch.clamp(el - 1.0, min=1.0) * ul)
    u0 = torch.round(center - (band - 1) / 2.0).to(torch.int32)
    u0[:, 0] = 0  # every path starts at (0, 0)
    return torch.clamp(u0, 0, max(0, U1 - band))


def _band_index(u0, band):
    """[..., band] label indices of the windows starting at u0 [...]."""
    return u0.long()[..., None] + torch.arange(band, device=u0.device)


def _gather_rows(x, idx):
    """x [B, U1(, J)] at per-batch-row indices idx [B, ...] ->
    [B, ...(, J)]."""
    b = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


def _scatter_band(banded, u0_full, U1):
    """banded [B, T, W] -> full [B, T, U1] with NEG outside the band."""
    B, T, W = banded.shape
    u = torch.arange(U1, device=banded.device)[None, None, :]
    w = u - u0_full.long()[..., None]
    padded = torch.cat([banded, torch.full((B, T, 1), NEG, dtype=banded.dtype,
                                           device=banded.device)], 2)
    vals = torch.gather(padded, 2, torch.clamp(w, 0, W))
    return torch.where((w >= 0) & (w < W), vals, NEG)


def banded_rows(f, g, labels_pad, u0, band):
    """K6's operands for the band: f rows [B * nT, 8, J] (f zero-padded to
    nT * 8 frames), the label windows of g [B * nT, W, J] and of the padded
    labels [B * nT, W]."""
    B, T, J = f.shape
    nT = u0.shape[1]
    idx = _band_index(u0, band)                                  # [B, nT, W]
    f_rows = Fn.pad(f, (0, 0, 0, nT * _T_TILE - T)).reshape(
        B * nT, _T_TILE, J)
    g_rows = _gather_rows(g, idx).reshape(B * nT, band, J)
    y_rows = _gather_rows(labels_pad, idx).reshape(B * nT, band)
    return f_rows, g_rows, y_rows


def banded_planes(f, g, b1, w2, b2, labels, label_lengths, u0, band,
                  tp=None):
    """(denom [B, T, W] in the band, b and e [B, T, U+1] with NEG outside
    it, u0_full [B, T]): one K6 launch over the band's rows (this shard's
    columns, combined over the model group, under `tp`)."""
    B, T, _ = f.shape
    U1 = g.shape[1]
    nT = u0.shape[1]
    u0_full = torch.repeat_interleave(u0, _T_TILE, dim=1)[:, :T]
    rows = banded_rows(f, g, shift_labels(pad_labels(labels), w2, tp), u0,
                       band)
    planes = planes_cuda.joint_planes(*rows, b1, w2, b2)
    if tp is not None:
        planes = combine_planes(*planes, tp)
    denom, blank, emit = (x.reshape(B, nT * _T_TILE, band)[:, :T]
                          for x in planes)
    b_band = blank - denom
    # emit only below the label length (the fused planes' mask), band-aware
    u_abs = _band_index(u0_full, band)
    e_band = torch.where(
        u_abs < label_lengths.to(f.device).long()[:, None, None],
        emit - denom, NEG)
    return (denom, _scatter_band(b_band, u0_full, U1),
            _scatter_band(e_band, u0_full, U1), u0_full)


class _BandedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, band, tp, f, g, b1, w2, b2, labels, logit_lengths,
                label_lengths):
        T, U1 = f.shape[1], g.shape[1]
        u0 = band_starts(logit_lengths.to(f.device), label_lengths, T, U1,
                         band)
        denom, b, e, u0_full = banded_planes(f, g, b1, w2, b2, labels,
                                             label_lengths, u0, band, tp)
        ctx.tp = tp
        alpha, beta, ll = lattice_cuda.lattice_scan(b, e, logit_lengths,
                                                    label_lengths)
        # every path pruned: ll is a stack of finite NEGs; report a large
        # finite loss (and a zero gradient in the backward), not NaN
        ll = torch.where(ll > NEG / 2, ll, -PRUNED_LOSS)
        ctx.save_for_backward(f, g, b1, w2, b2, denom, b, e, alpha, beta, ll,
                              u0_full, labels, logit_lengths, label_lengths)
        return -ll

    @staticmethod
    @spanned("rnnt.loss.bwd")
    def backward(ctx, ct):
        (f, g, b1, w2, b2, denom, b, e, alpha, beta, ll, u0_full, labels,
         logit_lengths, label_lengths) = ctx.saved_tensors
        T, (U1, J), W = f.shape[1], g.shape[1:], denom.shape[-1]
        alive = (ll > -PRUNED_LOSS / 2)[:, None, None]
        zero = torch.zeros((), device=f.device)
        idx = _band_index(u0_full, W)                            # [B, T, W]
        occ, g_blank, g_emit = (
            torch.gather(torch.where(alive, x, zero), 2, idx)
            for x in occupancies(alpha, beta, b, e, ll, logit_lengths,
                                 label_lengths, ct))
        tp = ctx.tp
        y_b = _gather_rows(shift_labels(pad_labels(labels), w2, tp), idx)

        def dg_of(dpre, rows):
            # band -> label rows: dg[b, u] = sum over (t, w) with
            # u0[b, t] + w = u, from dpre rounded to the weight dtype
            c = dpre.shape[0]
            dg = torch.zeros((c, U1, J), dtype=torch.float32,
                             device=f.device)
            dg.scatter_add_(1, idx[rows].reshape(c, T * W, 1).expand(
                c, T * W, J), dpre.to(w2.dtype).float().reshape(c, T * W, J))
            return dg

        grads = chunked_grads(f, _gather_rows(g, idx), b1, w2, b2, occ,
                              g_blank, g_emit, denom, y_b,
                              tp is None or tp.index == 0, g.shape, dg_of)
        return (None, None, *grads_out(grads, (f, g, b1, w2, b2), tp), None,
                None, None)


def rnnt_loss_banded(f, g, b1, w2, b2, labels, logit_lengths, label_lengths,
                     *, band: int = 16, tp=None):
    """Per-example banded RNN-T NLL from the joint's projected inputs f =
    enc @ W1 [B, T, J] and g = pred @ W1 [B, U+1, J] (the contract of
    `joint_loss_fused.rnnt_loss_fused`), with a label window of `band`
    rounded up to a multiple of 8 (at most U+1, rounded likewise); the label
    axis is zero-padded to a multiple of 8 too (padded rows are
    unreachable, so their gradient is 0, and the pad's gradient is sliced
    off).  The NLL is >= the exact NLL and equal to it for band >= U+1.
    `tp`: w2 and b2 are vocab-sharded (`joint_loss_fused.rnnt_loss_fused`)."""
    B, U1, J = g.shape
    W = _round_up(min(band, U1), 8)
    U1p = _round_up(max(U1, W), 8)
    g = Fn.pad(g, (0, 0, 0, U1p - U1))
    labels = Fn.pad(labels, (0, U1p - 1 - labels.shape[1]))
    return _BandedLoss.apply(W, tp, f, g, b1, w2, b2, labels, logit_lengths,
                             label_lengths)


@spanned("rnnt.loss")
def transducer_loss_banded(joint, enc, pred, labels, enc_lengths,
                           label_lengths, *, band: int = 16, tp=None):
    """The banded loss from encoder [B, T, P] and prediction [B, U+1, P]
    activations and the joint module (w1, b1, w2, b2; w1p where it has
    one), the banded twin of
    `joint_loss_fused.transducer_loss_fused`."""
    f, g = project(joint, enc, pred)
    return rnnt_loss_banded(f, g, joint.b1, joint.w2, joint.b2, labels,
                            enc_lengths, label_lengths, band=band, tp=tp)
