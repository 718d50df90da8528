"""RNN-Transducer loss in plain PyTorch: the port of `rnnt_tpu.ops.rnnt_loss_ref`.

One convention throughout: the op takes RAW logits and owns its log-softmax;
blank is id 0.  The lattice recursions are linear recurrences in the log
semiring along the label axis, x[u] = logaddexp(c[u], w[u] + x[u-1]); each
time row is solved by a doubling scan over U+1 (log2(U+1) vector steps) and a
Python loop walks the T rows.  These scans are the plain version of the
lattice kernel K7 (`ops.lattice_cuda`).  The gradient is analytic (node and
edge occupancies from alpha and beta), as a `torch.autograd.Function`.

Shapes: logits [B, T, U+1, V]; labels [B, U]; logit_lengths [B] (valid
encoder frames after time reduction); label_lengths [B].  Returns the
per-example negative log-likelihood [B].  log(0) is NEG = -1e30, never -inf,
so NEG + NEG stays finite in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

NEG = -1e30


def _row_scan(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x[u] = logaddexp(c[u], w[u] + x[u-1]) along the last axis (x[-1] is
    log 0), by doubling: after step s every x[u] folds in x[u-2s+1..u]."""
    n = c.shape[-1]
    s = 1
    while s < n:
        cp = Fn.pad(c[..., :-s], (s, 0), value=NEG)
        wp = Fn.pad(w[..., :-s], (s, 0), value=0.0)
        c = torch.logaddexp(c, w + cp)
        w = w + wp
        s *= 2
    return c


def _row_scan_rev(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x[u] = logaddexp(c[u], w[u] + x[u+1]) (x[U+1] is log 0)."""
    return torch.flip(_row_scan(torch.flip(c, [-1]), torch.flip(w, [-1])),
                      [-1])


def alpha_scan(b: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """alpha[t,u] = logaddexp(alpha[t-1,u] + b[t-1,u], alpha[t,u-1] +
    e[t,u-1]), alpha[0,0] = 0.  b, e, result: [B, T, U+1] fp32."""
    B, T, U1 = b.shape
    e_shift = Fn.pad(e[:, :, :-1], (1, 0), value=NEG)
    c = torch.full((B, U1), NEG, dtype=b.dtype, device=b.device)
    c[:, 0] = 0.0
    a = _row_scan(c, e_shift[:, 0])
    rows = [a]
    for t in range(1, T):
        a = _row_scan(a + b[:, t - 1], e_shift[:, t])
        rows.append(a)
    return torch.stack(rows, 1)


def beta_scan(b: torch.Tensor, e: torch.Tensor, logit_lengths: torch.Tensor,
              label_lengths: torch.Tensor) -> torch.Tensor:
    """beta[t,u] = logaddexp(b[t,u] + beta[t+1,u], e[t,u] + beta[t,u+1]),
    rooted at the final blank: at t = T_b - 1 the row below is the terminal
    row (0 at u = U_b, log 0 elsewhere)."""
    B, T, U1 = b.shape
    u_idx = torch.arange(U1, device=b.device)[None, :]
    term_row = torch.where(u_idx == label_lengths[:, None].to(b.device),
                           0.0, NEG).to(b.dtype)
    last = (logit_lengths.to(b.device) - 1)[:, None]
    x = torch.full((B, U1), NEG, dtype=b.dtype, device=b.device)
    rows = [None] * T
    for t in range(T - 1, -1, -1):
        x = torch.where(last == t, term_row, x)
        x = _row_scan_rev(b[:, t] + x, e[:, t])
        rows[t] = x
    return torch.stack(rows, 1)


def lattice_scan_plain(b, e, logit_lengths, label_lengths):
    """(alpha, beta [B, T, U+1], ll [B]) from the coefficient planes: the
    plain version of the lattice kernel K7."""
    alpha = alpha_scan(b, e)
    beta = beta_scan(b, e, logit_lengths, label_lengths)
    return alpha, beta, beta[:, 0, 0].contiguous()


def pad_labels(labels: torch.Tensor) -> torch.Tensor:
    """[B, U] -> [B, U+1] with a 0 appended (row U indexes safely)."""
    return Fn.pad(labels, (0, 1), value=0)


def gather_coeffs(logits32: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor):
    """Per-cell log-softmax denominator [B, T, U+1] and the blank/emit
    coefficient planes (emit masked to NEG from u = U_b on)."""
    B, T, U1, V = logits32.shape
    mx = logits32.amax(-1)
    denom = mx + torch.log(torch.exp(logits32 - mx[..., None]).sum(-1))
    b = logits32[..., 0] - denom
    idx = pad_labels(labels).long()[:, None, :, None].expand(B, T, U1, 1)
    e = torch.gather(logits32, -1, idx)[..., 0] - denom
    u_idx = torch.arange(U1, device=logits32.device)[None, None, :]
    e = torch.where(u_idx < label_lengths.to(e.device)[:, None, None], e, NEG)
    return denom, b, e


def occupancies(alpha, beta, b, e, ll, logit_lengths, label_lengths, ct):
    """Node occupancy and blank/emit edge occupancies [B, T, U+1], zero
    outside the valid lattice, each scaled by the cotangent ct [B]."""
    B, T, U1 = alpha.shape
    dev = alpha.device
    t_idx = torch.arange(T, device=dev)[None, :, None]
    u_idx = torch.arange(U1, device=dev)[None, None, :]
    fl = logit_lengths.to(dev)[:, None, None]
    yl = label_lengths.to(dev)[:, None, None]
    valid = (t_idx < fl) & (u_idx <= yl)
    # the row below t: beta[t+1] in range, the terminal row at t = T_b - 1
    term_row = torch.where(u_idx == yl, 0.0, NEG)
    beta_dn = Fn.pad(beta[:, 1:], (0, 0, 0, 1), value=NEG)
    beta_dn = torch.where(t_idx == fl - 1, term_row, beta_dn)
    beta_rt = Fn.pad(beta[:, :, 1:], (0, 1), value=NEG)
    lln = ll[:, None, None]
    s = ct.float()[:, None, None]
    zero = torch.zeros((), device=dev)
    occ = torch.where(valid, torch.exp(alpha + beta - lln), zero) * s
    g_blank = torch.where(valid, torch.exp(alpha + b + beta_dn - lln),
                          zero) * s
    g_emit = torch.where(valid, torch.exp(alpha + e + beta_rt - lln),
                         zero) * s
    return occ, g_blank, g_emit


class _RNNTLoss(torch.autograd.Function):
    """Per-example NLL over materialised logits; `lattice` computes
    (alpha, beta, ll) from the planes (the plain scans or kernel K7)."""

    @staticmethod
    def forward(ctx, logits, labels, logit_lengths, label_lengths, lattice):
        denom, b, e = gather_coeffs(logits.float(), labels, label_lengths)
        alpha, beta, ll = lattice(b, e, logit_lengths, label_lengths)
        ctx.save_for_backward(logits, denom, b, e, alpha, beta, ll, labels,
                              logit_lengths, label_lengths)
        return -ll

    @staticmethod
    def backward(ctx, ct):
        (logits, denom, b, e, alpha, beta, ll, labels, logit_lengths,
         label_lengths) = ctx.saved_tensors
        occ, g_blank, g_emit = occupancies(alpha, beta, b, e, ll,
                                           logit_lengths, label_lengths, ct)
        # d(-ll)/dlogits = softmax * occ - blank and emit edges (the emit
        # edge leaves column y_u of cell u)
        grad = torch.exp(logits.float() - denom[..., None]) * occ[..., None]
        grad[..., 0] -= g_blank
        B, T, U1, _ = grad.shape
        idx = pad_labels(labels).long()[:, None, :, None].expand(B, T, U1, 1)
        grad.scatter_add_(-1, idx, -g_emit[..., None])
        return grad.to(logits.dtype), None, None, None, None


def rnnt_loss_ref(logits, labels, logit_lengths, label_lengths):
    """Per-example RNN-T negative log-likelihood (plain scans)."""
    return _RNNTLoss.apply(logits, labels, logit_lengths, label_lengths,
                           lattice_scan_plain)


def rnnt_loss_with_lattice(logits, labels, logit_lengths, label_lengths,
                           lattice):
    """The same loss with another lattice function (`ops.lattice_cuda`)."""
    return _RNNTLoss.apply(logits, labels, logit_lengths, label_lengths,
                           lattice)
