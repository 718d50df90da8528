"""Plain PyTorch reference of the RNN-Transducer, in float32 (TF32 off).

The model, from its published description (He et al., arXiv:1811.06621,
and the reference implementation's hparams), from stacked log-mel
features on: an input BatchNorm (eps 1e-3); `encoder_layers` projected
LSTMs, each followed by a LayerNorm (eps 1e-3), with `time_reduction_factor` adjacent frames concatenated after
layer `time_reduction_index`; an embedding and `pred_net_layers` projected
LSTMs with LayerNorm for the prediction net; the additive joint
tanh(enc W1 + pred W1 + b1) W2 + b2; the RNN-T loss with blank 0.

A projected LSTM step (gates i, g, f, o along 4H):
  z = x Wx + h Wh + bias;  c' = s(f) c + s(i) tanh(g);  h' = (s(o) tanh c') Wp.

`low=True` computes every matrix product from operands rounded to fp8
(e4m3, one scale a tensor; in a backward the incoming gradient is rounded
to e5m2): the control, one precision below the served bf16.

Training check (`train_reference`): the loss, gradients and SGD-with-
momentum steps of the configuration, the parameters and the momentum
trace held in the served type as the configuration states (each update
computed in fp32 and rounded once).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

NORM_EPS = 1e-3
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def exact_matmuls() -> None:
    """fp32 products in fp32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX[dtype]
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


def mm(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    if low:
        a, b = _FP8.apply(a), _FP8.apply(b)
    return a @ b


# ------------------------------------------------------------ the model


def layer_norm(x, w, prefix):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return ((x - mean) / torch.sqrt(var + NORM_EPS) * w[prefix + ".scale"]
            + w[prefix + ".bias"])


def _gates(z, c):
    """(c', hidden) of one step from the gate pre-activations z [.., 4H]."""
    i, g, f, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def lstm(x, w, prefix, low):
    """[B, T, F] -> [B, T, P] from a zero state."""
    wx, wh = w[prefix + ".wx"], w[prefix + ".wh"]
    bias, wp = w[prefix + ".bias"], w[prefix + ".wp"]
    B, T, F = x.shape
    H, P = wp.shape
    xp = mm(x.reshape(B * T, F), wx, low).reshape(B, T, 4 * H) + bias
    c = x.new_zeros((B, H))
    h = x.new_zeros((B, P))
    out = []
    for t in range(T):
        c, hidden = _gates(xp[:, t] + mm(h, wh, low), c)
        h = mm(hidden, wp, low)
        out.append(h)
    return torch.stack(out, 1)


def encoder(mel, w, m, *, training=False, low=False):
    """Features [B, T, F] -> [B, ceil(T / factor), P].  In training the
    BatchNorm takes the batch's statistics (biased variance)."""
    if training:
        mean = mel.mean(dim=(0, 1))
        var = mel.var(dim=(0, 1), unbiased=False)
    else:
        mean, var = w["encoder.bn.mean"], w["encoder.bn.var"]
    x = ((mel - mean) / torch.sqrt(var + NORM_EPS) * w["encoder.bn.scale"]
         + w["encoder.bn.bias"])
    for i in range(m["encoder_layers"]):
        p = f"encoder.layers.{i}"
        x = layer_norm(lstm(x, w, p + ".lstm", low), w, p + ".ln")
        if i == m["time_reduction_index"]:
            f = m["time_reduction_factor"]
            B, T, F = x.shape
            pad = (-T) % f
            if pad:
                x = torch.cat([x, x.new_zeros((B, pad, F))], 1)
            x = x.reshape(B, (T + pad) // f, F * f)
    return x


def prediction(ids, w, m, *, low=False):
    """Token ids [B, U+1] (the blank first) -> [B, U+1, P]."""
    x = w["prediction.embed"][ids]
    for i in range(m["pred_net_layers"]):
        p = f"prediction.layers.{i}"
        x = layer_norm(lstm(x, w, p + ".lstm", low), w, p + ".ln")
    return x


def joint(enc, pred, w, low):
    """enc [.., T, 1, P] and pred [.., 1, U+1, P] -> logits [.., T, U+1, V]."""
    h = torch.tanh(mm(enc, w["joint.w1"], low) + mm(pred, w["joint.w1"], low)
                   + w["joint.b1"])
    return mm(h, w["joint.w2"], low) + w["joint.b2"]


# ------------------------------------------------------------ training


def rnnt_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Full-length lattices: logits [B, T, U+1, V], labels [B, U] ->
    -log P(labels) [B] in fp64 (alpha over t, a log-cumsum over u)."""
    B, T, U1, V = logits.shape
    U = U1 - 1
    lp = torch.log_softmax(logits, -1)
    lb = lp[..., 0].double()
    le = lp[:, :, :U].gather(-1, labels[:, None, :, None].expand(
        B, T, U, 1))[..., 0].double()
    zero = lb.new_zeros((B, 1))
    alpha = torch.cat([zero, le[:, 0].cumsum(-1)], -1)
    for t in range(1, T):
        a = alpha + lb[:, t - 1]
        c = torch.cat([zero, le[:, t].cumsum(-1)], -1)
        alpha = c + torch.logcumsumexp(a - c, -1)
    return -(alpha[:, U] + lb[:, T - 1, U])


def loss_and_grads(p: Dict[str, torch.Tensor], batch: dict, m: dict, *,
                   low=False, rows: Optional[int] = None, block: int = 16):
    """Mean NLL over the batch (its first `rows` rows when given) and the
    fp32 gradient of every trainable leaf of fp32 parameters `p`."""
    names = [n for n in p if n not in ("encoder.bn.mean", "encoder.bn.var")]
    pf = {n: (t.detach().float().requires_grad_(n in names))
          for n, t in p.items()}
    n_rows = rows or batch["labels"].shape[0]
    mel = batch["mel_specs"][:n_rows].float()
    enc = encoder(mel, pf, m, training=True, low=low)
    pred = prediction(batch["pred_inp"][:n_rows], pf, m, low=low)
    enc_d = enc.detach().requires_grad_()
    pred_d = pred.detach().requires_grad_()
    labels = batch["labels"][:n_rows]
    total = 0.0
    for r0 in range(0, n_rows, block):
        lg = joint(enc_d[r0: r0 + block, :, None], pred_d[r0: r0 + block, None],
                   pf, low)
        loss = rnnt_nll(lg, labels[r0: r0 + block]).sum() / n_rows
        loss.backward()
        total += float(loss.detach())
        del lg, loss
    torch.autograd.backward([enc, pred], [enc_d.grad, pred_d.grad])
    return total, {n: pf[n].grad for n in names}


def leaf_norms(ts: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.float().norm()) for n, t in ts.items()}


def train_reference(w: Dict[str, torch.Tensor], batches: List[dict], m: dict,
                    *, steps: int = 3, low=False, rows=None) -> dict:
    """`steps` SGD-with-momentum steps from weights `w` (stored in their
    type) on batches[0..steps): each step's loss, each leaf's first
    gradient norm and each leaf's parameter change norm after the steps."""
    lr, mom = m["learning_rate"], m["momentum"]
    p = {n: t.detach().clone() for n, t in w.items()}
    trace = {}
    losses, first = [], None
    for s in range(steps):
        loss, grads = loss_and_grads(p, batches[s], m, low=low, rows=rows)
        losses.append(loss)
        if first is None:
            first = leaf_norms(grads)
        with torch.no_grad():
            for n, g in grads.items():
                prev = trace.get(n)
                tr = g + mom * prev.float() if prev is not None else g
                trace[n] = tr.to(p[n].dtype)
                p[n] = (p[n].float() - lr * trace[n].float()).to(p[n].dtype)
        del grads
    change = {n: float((p[n].float() - w[n].float()).norm()) for n in first}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   keep=None, floor=True) -> tuple:
    """max over leaves of |got - want| / max(want, the median leaf's want):
    (gap, leaf).  With floor=False each leaf is measured against its own
    want alone."""
    names = [n for n in want if keep is None or n in keep]
    med = float(np.median([want[n] for n in names])) if floor else 0.0
    gaps = {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30)
            for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def own_norm_gaps(grad_norms: Dict[str, float],
                  change_norms: Dict[str, float], want: dict,
                  moved: set) -> dict:
    """The worst leaf's gaps of the first gradient and of the change over
    the `moved` leaves, each leaf against its own reference norm (no
    median floor, so a small leaf's fault is not hidden), with the leaf."""
    g, g_leaf = worst_leaf_gap(grad_norms, want["grad_norms"], moved,
                               floor=False)
    c, c_leaf = worst_leaf_gap(change_norms, want["change_norms"], moved,
                               floor=False)
    return {"grad_gap_own_norm": g, "grad_gap_own_norm_leaf": g_leaf,
            "change_gap_own_norm": c, "change_gap_own_norm_leaf": c_leaf}


def moved_leaves(grad_norms: Dict[str, float]) -> set:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under the update by round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return {n for n, g in grad_norms.items() if g >= 1e-3 * med}


def loss_gap(got: List[float], want: List[float]) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))

