"""Plain PyTorch reference of the Conformer-Transducer, in float32 (TF32 off).

The model, from its published description (Gulati et al., "Conformer:
Convolution-augmented Transformer for Speech Recognition", Interspeech
2020, arXiv:2005.08100, Conformer (L)), and the configuration's assumed
sizes (`benchmark/configs/conformer-l.json`), from features [B, T, F]:

  subsampling  two Conv2d(3x3, stride 2, padding 1) with ReLU, C channels,
               then Dense(C * F'' -> D) over each frame's channel-major
               values; T' = ceil(ceil(T / 2) / 2)
  block        x + 1/2 FFN(x); + MHSA(x); + Conv(x); + 1/2 FFN(x); LayerNorm
  FFN          LayerNorm, Dense(D -> ffn), Swish, Dense(ffn -> D)
  MHSA         LayerNorm; q, k, v Dense(D -> D); per head of d = D / H
               score[i, j] = ((q_i + u) . k_j + (q_i + v) . (R[i - j] Wpos))
                             / sqrt d,
               R[n] the sinusoidal encoding of the distance n (sin at the
               even columns, cos at the odd, frequencies 10000^(-2k / D));
               softmax over the valid keys j; Dense(D -> D)
  Conv         LayerNorm, Dense(D -> 2D), GLU, depthwise Conv1d of kernel K
               ((K - 1) // 2 zeros before, K // 2 after), BatchNorm, Swish,
               Dense(D -> D)
  prediction   embedding, projected LSTMs with LayerNorm (eps 1e-3:
               `transducer.prediction`)
  joint        tanh(enc W1 + pred W1p + b1) W2 + b2; the RNN-T loss, blank 0

LayerNorm and BatchNorm eps 1e-5.  Each utterance's padded frames are
excluded by its length: the features and the first convolution's output
past the length are zero, as if the utterance were alone, padded keys get
no weight, the depthwise convolution sees zeros there, and in training
BatchNorm takes the statistics of the valid frames (biased variance).
The position term indexes the projected table by the distance i - j of
each pair, no shift trick.

`low=True` computes every product (the convolutions too) from operands
rounded to fp8, as `transducer.py`'s control does.

Training (`train_reference`): Adam (0.9, 0.98, eps 1e-9, the
configuration's learning rate, bias-corrected), the parameters and nu held
in the served type, mu in fp32, each update computed in fp32 and rounded
once.  So that a batch of 64 16-second utterances fits in fp32, each block
is recomputed in the backward (`torch.utils.checkpoint`, BatchNorm is
functional: a recompute changes no statistic) and the joint and loss run
over chunks of rows.

Weights are the program's parameter names (`benchlib/conformer_weights.py`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

from .transducer import (_FP8, exact_matmuls, leaf_norms,  # noqa: F401
                         loss_gap, mm, moved_leaves, own_norm_gaps,
                         prediction, rnnt_nll, worst_leaf_gap)

EPS = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.98, 1e-9


def fp8(x: torch.Tensor, low: bool) -> torch.Tensor:
    return _FP8.apply(x) if low else x


def is_stat(name: str) -> bool:
    return name.endswith((".bn.mean", ".bn.var"))


def norm(x, w, prefix):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return ((x - mean) / torch.sqrt(var + EPS) * w[prefix + ".scale"]
            + w[prefix + ".bias"])


def dense(x, w, prefix, low, bias=True):
    y = mm(x.reshape(-1, x.shape[-1]), w[prefix + ".w"], low).reshape(
        *x.shape[:-1], -1)
    return y + w[prefix + ".b"] if bias else y


def swish(x):
    return x * torch.sigmoid(x)


def lengths_mask(lengths, T):
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def subsample(mel, lengths, w, low):
    x = (mel * lengths_mask(lengths, mel.shape[1])[..., None])[:, None]
    x = torch.relu(Fn.conv2d(fp8(x, low), fp8(w["encoder.subsample.conv1_w"],
                                              low),
                             w["encoder.subsample.conv1_b"], 2, 1))
    x = x * lengths_mask(-(-lengths // 2), x.shape[2])[:, None, :, None]
    x = torch.relu(Fn.conv2d(fp8(x, low), fp8(w["encoder.subsample.conv2_w"],
                                              low),
                             w["encoder.subsample.conv2_b"], 2, 1))
    B, C, T, F = x.shape
    return dense(x.permute(0, 2, 1, 3).reshape(B, T, C * F), w,
                 "encoder.subsample.out", low)


def distance_table(T, D, device):
    """R[n] for n = -(T - 1) .. T - 1, row n + T - 1."""
    n = torch.arange(-(T - 1), T, device=device, dtype=torch.float32)
    freq = 10000.0 ** (-torch.arange(0, D, 2, device=device,
                                     dtype=torch.float32) / D)
    R = torch.zeros((2 * T - 1, D), device=device)
    R[:, 0::2] = torch.sin(n[:, None] * freq)
    R[:, 1::2] = torch.cos(n[:, None] * freq)
    return R


def mhsa(x, valid, w, p, m, low):
    B, T, D = x.shape
    H = m["conformer_heads"]
    d = D // H
    y = norm(x, w, p + ".ln")
    wq, wk, wv = w[p + ".qkv_w"].split(D, 1)
    q = (mm(y.reshape(-1, D), wq, low) + w[p + ".q_b"]).view(B, T, H, d)
    k = (mm(y.reshape(-1, D), wk, low) + w[p + ".k_b"]).view(B, T, H, d)
    v = (mm(y.reshape(-1, D), wv, low) + w[p + ".v_b"]).view(B, T, H, d)
    # R[i - j] Wpos for every pair: the projected table indexed by distance
    P = mm(distance_table(T, D, x.device), w[p + ".pos.w"], low)
    idx = (torch.arange(T, device=x.device)[:, None]
           - torch.arange(T, device=x.device)[None, :]) + (T - 1)
    Pij = P[idx].view(T, T, H, d)
    qu = q + w[p + ".pos_u"]
    qv = q + w[p + ".pos_v"]
    ac = torch.einsum("bihd,bjhd->bhij", fp8(qu, low), fp8(k, low))
    bd = torch.einsum("bihd,ijhd->bhij", fp8(qv, low), fp8(Pij, low))
    scores = (ac + bd) / math.sqrt(d)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    att = torch.softmax(scores, -1)
    ctx = torch.einsum("bhij,bjhd->bihd", fp8(att, low), fp8(v, low))
    return dense(ctx.reshape(B, T, D), w, p + ".out", low)


def batch_norm(y, valid, w, p, training):
    """(normalised y, (new running mean, var) or None)."""
    if training:
        msk = valid[..., None].float()
        cnt = msk.sum()
        mean = (y * msk).sum((0, 1)) / cnt
        var = (((y - mean) * msk) ** 2).sum((0, 1)) / cnt
        new = (0.99 * w[p + ".mean"] + 0.01 * mean.detach(),
               0.99 * w[p + ".var"] + 0.01 * var.detach())
    else:
        mean, var, new = w[p + ".mean"], w[p + ".var"], None
    return ((y - mean) / torch.sqrt(var + EPS) * w[p + ".scale"]
            + w[p + ".bias"]), new


def conv_module(x, valid, w, p, m, training, low):
    K = m["conformer_kernel_size"]
    y = dense(norm(x, w, p + ".ln"), w, p + ".pw1", low)
    a, b = y.chunk(2, -1)
    y = (a * torch.sigmoid(b)) * valid[..., None]
    y = Fn.pad(y.transpose(1, 2), ((K - 1) // 2, K // 2))
    y = Fn.conv1d(fp8(y, low), fp8(w[p + ".dw_w"][:, None, :], low),
                  w[p + ".dw_b"], groups=y.shape[1]).transpose(1, 2)
    y, new = batch_norm(y, valid, w, p + ".bn", training)
    return dense(swish(y), w, p + ".pw2", low), new


def ffn(x, w, p, low):
    y = dense(norm(x, w, p + ".ln"), w, p + ".up", low)
    return dense(swish(y), w, p + ".down", low)


def block(x, valid, w, p, m, training, low):
    x = x + 0.5 * ffn(x, w, p + ".ffn1", low)
    x = x + mhsa(x, valid, w, p + ".mhsa", m, low)
    y, new = conv_module(x, valid, w, p + ".conv", m, training, low)
    x = x + y
    x = x + 0.5 * ffn(x, w, p + ".ffn2", low)
    return norm(x, w, p + ".ln"), new


def encoder(mel, lengths, w, m, *, training=False, low=False,
            recompute=False):
    """Features [B, T, F] and lengths [B] -> (encoded [B, T', D], the new
    BatchNorm running statistics by name in training, else {})."""
    x = subsample(mel, lengths, w, low)
    T = x.shape[1]
    valid = lengths_mask(-(-(-(-lengths // 2)) // 2), T)
    stats = {}
    for i in range(m["encoder_layers"]):
        p = f"encoder.blocks.{i}"

        def run(x_, p=p):
            y, new = block(x_, valid, w, p, m, training, low)
            return (y, *new) if new is not None else (y,)

        out = (checkpoint(run, x, use_reentrant=False) if recompute
               else run(x))
        x = out[0]
        if training:
            stats[p + ".conv.bn.mean"] = out[1].detach()
            stats[p + ".conv.bn.var"] = out[2].detach()
    return x, stats


def joint(enc, pred, w, low):
    """enc [.., T, 1, D] and pred [.., 1, U+1, P] -> logits [.., T, U+1, V]."""
    h = torch.tanh(mm(enc, w["joint.w1"], low) + mm(pred, w["joint.w1p"], low)
                   + w["joint.b1"])
    return mm(h, w["joint.w2"], low) + w["joint.b2"]


def nll(logits, labels, t_len, u_len):
    """-log P(labels) [B] of lattices cut to each row's lengths."""
    B, T, U1, _ = logits.shape
    if bool((t_len == T).all()) and bool((u_len == U1 - 1).all()):
        return rnnt_nll(logits, labels)
    return torch.cat([rnnt_nll(logits[b: b + 1, : int(t_len[b]),
                                      : int(u_len[b]) + 1],
                               labels[b: b + 1, : int(u_len[b])])
                      for b in range(B)])


def loss_and_grads(p: Dict[str, torch.Tensor], batch: dict, m: dict, *,
                   low=False, rows: Optional[int] = None, block_rows: int = 4,
                   recompute=True):
    """Mean NLL over the batch (its first `rows` rows when given), the fp32
    gradient of every trainable leaf of parameters `p` and the new
    BatchNorm statistics by name."""
    names = [n for n in p if not is_stat(n)]
    pf = {n: t.detach().float().requires_grad_(n in names)
          for n, t in p.items()}
    n_rows = rows or batch["labels"].shape[0]
    mel = batch["mel_specs"][:n_rows].float()
    lengths = batch["spec_lengths"][:n_rows]
    enc, stats = encoder(mel, lengths, pf, m, training=True, low=low,
                         recompute=recompute)
    pred = prediction(batch["pred_inp"][:n_rows], pf, m, low=low)
    enc_d = enc.detach().requires_grad_()
    pred_d = pred.detach().requires_grad_()
    labels = batch["labels"][:n_rows]
    t_len = -(-(-(-lengths // 2)) // 2)
    u_len = batch["label_lengths"][:n_rows]
    total = 0.0
    for r0 in range(0, n_rows, block_rows):
        sl = slice(r0, r0 + block_rows)
        lg = joint(enc_d[sl, :, None], pred_d[sl, None], pf, low)
        loss = nll(lg, labels[sl], t_len[sl], u_len[sl]).sum() / n_rows
        loss.backward()
        total += float(loss.detach())
        del lg, loss
    torch.autograd.backward([enc, pred], [enc_d.grad, pred_d.grad])
    return total, {n: pf[n].grad for n in names}, stats


def train_reference(w: Dict[str, torch.Tensor], batches: List[dict], m: dict,
                    *, steps: int = 3, low=False, rows=None) -> dict:
    """`steps` Adam steps from weights `w` (stored in their type) on
    batches[0..steps): each step's loss, each leaf's first gradient norm,
    each leaf's parameter change norm after the steps, and the BatchNorm
    running statistics after them."""
    lr = m["learning_rate"]
    p = {n: t.detach().clone() for n, t in w.items()}
    mu, nu = {}, {}
    losses, first = [], None
    for s in range(steps):
        loss, grads, stats = loss_and_grads(p, batches[s], m, low=low,
                                            rows=rows)
        losses.append(loss)
        if first is None:
            first = leaf_norms(grads)
        c1 = 1.0 - ADAM_B1 ** (s + 1)
        c2 = 1.0 - ADAM_B2 ** (s + 1)
        with torch.no_grad():
            for n, g in grads.items():
                mu[n] = (1 - ADAM_B1) * g + ADAM_B1 * mu.get(n, 0.0)
                v = (1 - ADAM_B2) * g * g + ADAM_B2 * (
                    nu[n].float() if n in nu else 0.0)
                nu[n] = v.to(p[n].dtype)
                upd = (mu[n] / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
                p[n] = (p[n].float() - lr * upd).to(p[n].dtype)
            for n, t in stats.items():
                p[n] = t.to(p[n].dtype)
        del grads
    change = {n: float((p[n].float() - w[n].float()).norm()) for n in first}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "stats": {n: p[n] for n in p if is_stat(n)}}


def forward_encoder(w, mel, lengths, m) -> torch.Tensor:
    """The eval encoder (running statistics), fp32, no gradient."""
    with torch.no_grad():
        pf = {n: t.float() for n, t in w.items()}
        return encoder(mel.float(), lengths, pf, m)[0]
