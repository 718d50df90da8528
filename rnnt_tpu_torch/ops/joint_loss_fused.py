"""Fused joint network + RNN-T loss: the port of
`rnnt_tpu.ops.joint_loss_fused`, one device or a vocabulary shard.

  joint:  logits[b,t,u,:] = tanh(f[b,t] + g[b,u] + b1) @ W2 + b2
  loss needs per cell only: denom = logsumexp_v, blank = logits[0],
                            emit = logits[y_u]

The forward never writes the [B, T, U+1, V] logits: kernel K6
(`ops.planes_cuda`) reduces each cell's logits to the three planes, and the
lattice runs in kernel K7 (`ops.lattice_cuda`; the JAX package runs its XLA
scans there, which compute the same function).  The backward follows the
JAX `_bwd`: occupancies from alpha and beta, then per batch chunk a
recompute of the tanh tile and the logits and the dh, dW2, df, dg, db1, db2
products.  Where `loss_bwd_cuda.fits` (bf16 on the card, J within K6's
WGMMA plan) it runs on kernels K8 and K9 around two cuBLAS products
(`_kernel_grads`), from the packed W2 that the forward's K6 launch left;
elsewhere (fp32, a wider joint, the CPU) as the plain chain `_chunk_grads`,
chunks of at most _BWD_CHUNK rows (the JAX package leaves it to XLA outside
any kernel).  `backward_launches_by_design` counts each chunk's path.  The
banded loss (`ops.joint_loss_banded`) shares the plain chain and its chunk
loop (`chunked_grads`), the backward's tail (`grads_out`) and the f/g
projection (`project`): it differs in the cells it visits and in how dpre
becomes dg.

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
import torch.nn.functional as Fn

from rnnt_tpu_torch.models.joint import pred_weight
from rnnt_tpu_torch.ops import lattice_cuda, loss_bwd_cuda, planes_cuda
from rnnt_tpu_torch.ops.matmul import addmm_f32_, matmul_f32, mm_f32
from rnnt_tpu_torch.ops.rnnt_loss_ref import NEG, occupancies, pad_labels
from rnnt_tpu_torch.parallel import mesh as mesh_mod
from rnnt_tpu_torch.trace import spanned

_BWD_CHUNK = 8  # batch rows whose [chunk, T, U+1, V] tensors coexist
BACKWARD_DESIGNS = ("kernel", "plain")
backward_launches_by_design = dict.fromkeys(BACKWARD_DESIGNS, 0)


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


def planes(f, g, b1, w2, b2, labels, label_lengths, tp=None, packed=None):
    """(denom, blank coefficient b, emit coefficient e) [B, T, U+1]: the
    log-softmax planes of the lattice, emit masked from u = U_b on (over
    the full vocabulary under `tp`).  `packed`: K6 packs W2 into it."""
    denom, blank, emit = planes_cuda.joint_planes(
        f, g, shift_labels(pad_labels(labels), w2, tp), b1, w2, b2, packed)
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


def _chunk_grads(fc, gcells, b1, w2, b2, occ, gbl, gem, den, y, blank_own):
    """One batch chunk's fp32 (dpre = dh (1 - h^2), dW2, db2) from its
    recomputed logits (the JAX `chunk_bwd`): g and the labels y come laid
    out over the cells ([c, 1, U+1, J] for the lattice, [c, T, W, J] for a
    band)."""
    V = w2.shape[1]
    J = fc.shape[-1]
    pre = fc.float()[:, :, None, :] + gcells.float() + b1.float()
    h = torch.tanh(pre)
    hb = h.to(w2.dtype)
    logits = matmul_f32(hb, w2) + b2.float()
    dlogits = dlogits_(logits, den, occ, gbl, gem, y, blank_own)
    dl2 = dlogits.to(w2.dtype).reshape(-1, V)
    dh = mm_f32(dl2, w2.t()).reshape(h.shape)
    dw2 = mm_f32(hb.reshape(-1, J).t(), dl2)
    db2 = dlogits.sum((0, 1, 2))
    return dh * (1.0 - h * h), dw2, db2


def chunked_grads(f, gcells, b1, w2, b2, occ, gbl, gem, den, y, blank_own,
                  dg_shape, dg_of):
    """(df, dg, db1, dW2, db2) in fp32 from `_chunk_grads` over chunks of
    the largest divisor of B up to _BWD_CHUNK rows, each counted "plain";
    dg_of(dpre, rows) turns a chunk's dpre into its rows of dg."""
    B = f.shape[0]
    chunk = next(c for c in range(min(B, _BWD_CHUNK), 0, -1) if B % c == 0)
    dev, f32 = f.device, torch.float32
    df = torch.empty(f.shape, dtype=f32, device=dev)
    dg = torch.empty(dg_shape, dtype=f32, device=dev)
    db1 = torch.zeros(b1.shape, dtype=f32, device=dev)
    dw2 = torch.zeros(w2.shape, dtype=f32, device=dev)
    db2 = torch.zeros(b2.shape, dtype=f32, device=dev)
    for r0 in range(0, B, chunk):
        sl = slice(r0, r0 + chunk)
        dpre, dw2c, db2c = _chunk_grads(
            f[sl], gcells[sl], b1, w2, b2, occ[sl], gbl[sl], gem[sl],
            den[sl], y[sl], blank_own)
        df[sl], dg[sl] = dpre.sum(2), dg_of(dpre, sl)
        db1 += dpre.sum((0, 1, 2))
        dw2 += dw2c
        db2 += db2c
        backward_launches_by_design["plain"] += 1
    return df, dg, db1, dw2, db2


def _plain_grads(f, g, b1, w2, b2, occ, gbl, gem, den, y, blank_own):
    """(df, dg, db1, dW2, db2) in fp32 from the plain chain over every
    (t, u) cell."""
    return chunked_grads(f, g[:, None], b1, w2, b2, occ, gbl, gem, den,
                         y[:, None, :], blank_own, g.shape,
                         lambda dpre, rows: dpre.sum(1))


def _kernel_grads(f, g, b1, w2, b2, w2p, occ, gbl, gem, den, y, blank_own,
                  ctas):
    """(df, dg, db1, dW2, db2) in fp32 on kernels K8 and K9
    (`loss_bwd_cuda`), batch chunk by batch chunk: K8's dlogits [cells, V]
    and hb in bf16, dh = dlogits W2^T and dW2 += hb^T dlogits as bf16
    products into fp32, then K9's sums.  w2p: W2 packed by the forward's
    K6 launch; `ctas`: K8's grid at most (the card's SMs).  On CPU tensors
    the kernels' plain versions run the same schedule."""
    B, T, J = f.shape
    U1, V = g.shape[1], w2.shape[1]
    f, g, y, b1, _, b2 = planes_cuda.pad_operands(f, g, y, b1, w2, b2,
                                                  wgmma=True)
    Jp, Vp = f.shape[2], b2.shape[0]
    if Jp != J:
        w2 = Fn.pad(w2, (0, 0, 0, Jp - J))
    dev, f32 = f.device, torch.float32
    df = torch.empty((B, T, Jp), dtype=f32, device=dev)
    dg = torch.empty((B, U1, Jp), dtype=f32, device=dev)
    db1p = torch.empty((B, -(-U1 // loss_bwd_cuda.UG), Jp), dtype=f32,
                       device=dev)
    dw2 = torch.zeros((Jp, V), dtype=f32, device=dev)
    db2p = torch.zeros((ctas * loss_bwd_cuda.WARPS, Vp), dtype=f32,
                       device=dev)
    chunk = loss_bwd_cuda.chunk_rows(B, T, U1, Jp, Vp)
    for r0 in range(0, B, chunk):
        sl = slice(r0, r0 + chunk)
        dl, hb = loss_bwd_cuda.joint_dlogits(
            f[sl], g[sl], y[sl], b1, w2, w2p, b2, den[sl], occ[sl], gbl[sl],
            gem[sl], db2p, V, blank_own, ctas)
        dl = dl[:, :V]
        dh = mm_f32(dl, w2.t())
        addmm_f32_(dw2, hb.t(), dl)
        loss_bwd_cuda.tanh_grads(dh, f[sl], g[sl], b1, df[sl], dg[sl],
                                 db1p[sl])
        backward_launches_by_design["kernel"] += 1
    return (df[..., :J].contiguous(), dg[..., :J].contiguous(),
            db1p.sum((0, 1))[:J], dw2[:J], db2p.sum(0)[:V])


def grads_out(grads, inputs, tp):
    """The backward's tail: (df, dg, db1) all-reduced over the model group
    under `tp` (partial sums over this shard's columns), then each of the
    five fp32 gradients cast to its input's dtype."""
    if tp is not None:
        mesh_mod.all_reduce_sum_(grads[:3], None, tp.group)
    return tuple(d.to(x.dtype) for d, x in zip(grads, inputs))


def project(joint, enc, pred):
    """(f, g): the joint's first Dense applied to each side (W(a + b) = Wa
    + Wb; w1p on the prediction side where the joint has one), rounded to
    the activation dtype."""
    return (matmul_f32(enc, joint.w1).to(enc.dtype),
            matmul_f32(pred, pred_weight(joint)).to(pred.dtype))


class _FusedLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, f, g, b1, w2, b2, labels, logit_lengths,
                label_lengths):
        w2p = None  # the packed W2 K8 streams, from K6's launch
        if loss_bwd_cuda.fits(f, g, b1, w2):
            w2p = torch.empty(planes_cuda.padded_j(w2.shape[0])
                              * planes_cuda.padded_v(w2.shape[1]),
                              dtype=w2.dtype, device=w2.device)
        denom, b, e = planes(f, g, b1, w2, b2, labels, label_lengths, tp,
                             w2p)
        alpha, beta, ll = lattice_cuda.lattice_scan(b, e, logit_lengths,
                                                    label_lengths)
        ctx.tp, ctx.w2p = tp, w2p
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
        y = shift_labels(pad_labels(labels), w2, tp)
        blank_own = tp is None or tp.index == 0
        if ctx.w2p is not None:
            grads = _kernel_grads(
                f, g, b1, w2, b2, ctx.w2p, occ, g_blank, g_emit, denom, y,
                blank_own, loss_bwd_cuda.ctas(f.device))
        else:
            grads = _plain_grads(f, g, b1, w2, b2, occ, g_blank, g_emit,
                                 denom, y, blank_own)
        return (None, *grads_out(grads, (f, g, b1, w2, b2), tp), None, None,
                None)


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
    activations and the joint module (w1, b1, w2, b2; `project`).  `tp`:
    w2 and b2 are vocab-sharded (`rnnt_loss_fused`)."""
    f, g = project(joint, enc, pred)
    return rnnt_loss_fused(f, g, joint.b1, joint.w2, joint.b2, labels,
                           enc_lengths, label_lengths, tp)
