"""Projected LSTM, LayerNorm, BatchNorm, dropout and TimeReduction.

The port of `rnnt_tpu.models.lstm`.  Parameters keep the JAX layout and gate
order (torch.nn.LSTM's i, f, g, o differs):

  wx [F, 4H], wh [P, 4H], bias [4H], wp [H, P]; gates i, g, f, o.

The input projection x @ Wx over all timesteps is one matmul outside the
recurrence, cast to the weight dtype as the TPU kernel receives it; the
recurrence itself is `ops.lstm_cuda.lstm_seq_infer` in inference and the
differentiable `ops.lstm_cuda.lstm_seq` in training (the CUDA kernels on the
card, their plain versions on the CPU).  The cell state c is fp32.

A layer whose wx, wh or wp is an int8 `ops.int8_exec.QuantWeight` (int8
execution, `ops.quantize.int8_exec_params`) runs a plain step loop on
`qdot` instead, as the JAX package routes int8 weights to its scan: the
input projection in fp32, then per step z = xp + qdot(h, Wh) + bias, the
gates, and h_new = qdot(hidden in fp32, Wp) in the state's dtype.  It is
inference only.

Parameters are created frozen (serving needs no gradients);
`models.transducer.Transducer.make_trainable_` turns training on for all but
the BatchNorm running statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from rnnt_tpu_torch.ops import lstm_cuda
from rnnt_tpu_torch.ops.int8_exec import act_dtype, is_quant, qdot, weight_shape
from rnnt_tpu_torch.ops.matmul import matmul_to


def frozen_param(shape) -> nn.Parameter:
    """An inference parameter (no gradient), zero until loaded or reset."""
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


def glorot_(p: torch.Tensor, rng: np.random.Generator) -> None:
    """Glorot-uniform fill of a 2-D weight from a numpy generator."""
    lim = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
    p.copy_(torch.from_numpy(
        rng.uniform(-lim, lim, tuple(p.shape)).astype(np.float32)))


class ProjLSTM(nn.Module):
    """Projected LSTM over [B, T, F] -> ([B, T, P], (c [B, H], h [B, P]))."""

    def __init__(self, input_size: int, hidden_size: int, proj_size: int):
        super().__init__()
        self.wx = frozen_param((input_size, 4 * hidden_size))
        self.wh = frozen_param((proj_size, 4 * hidden_size))
        self.bias = frozen_param((4 * hidden_size,))
        self.wp = frozen_param((hidden_size, proj_size))

    def reset_(self, rng: np.random.Generator) -> None:
        """Glorot-uniform weights; zero bias with the forget gate at 1."""
        for w in (self.wx, self.wh, self.wp):
            glorot_(w, rng)
        H = self.wp.shape[0]
        self.bias.zero_()
        self.bias[2 * H: 3 * H] = 1.0

    def is_int8(self) -> bool:
        return any(is_quant(w) for w in (self.wx, self.wh, self.wp))

    def zero_state(self, batch: int, dtype=None, device=None):
        """(c, h): c fp32, h in `dtype` (by default the weight dtype, fp32
        for an int8 Wp)."""
        H, P = weight_shape(self.wp)
        device = device or self.wp.device
        return (torch.zeros((batch, H), dtype=torch.float32, device=device),
                torch.zeros((batch, P), dtype=dtype or act_dtype(self.wp),
                            device=device))

    def forward(self, x: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                training: bool = False):
        B, T, F = x.shape
        if state is None:
            state = self.zero_state(B, x.dtype, x.device)
        c0, h0 = state
        if self.is_int8():
            if training:
                raise ValueError("int8 LSTM weights are an inference path; "
                                 "train on fp weights")
            return self._forward_int8(x, c0, h0)
        if training:
            return lstm_cuda.lstm_seq(x, self.wx, self.wh, self.bias, self.wp,
                                      c0, h0)
        xp = matmul_to(x.reshape(B * T, F), self.wx, self.wh.dtype).reshape(
            B, T, -1)
        h_seq, c_fin = lstm_cuda.lstm_seq_infer(
            xp.transpose(0, 1), self.wh, self.wp, self.bias, h0, c0)
        return h_seq.transpose(0, 1), (c_fin, h_seq[-1].to(h0.dtype))

    def _gates_step(self, xp_t, c, h):
        """One step from the precomputed input projection (JAX's
        `_gates_step`)."""
        z = xp_t + qdot(h, self.wh) + self.bias.float()
        i, g, f, o = torch.chunk(z, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hidden = torch.sigmoid(o) * torch.tanh(c_new)
        h_new = qdot(hidden.to(act_dtype(self.wp)), self.wp).to(h.dtype)
        return c_new, h_new

    def _forward_int8(self, x, c, h):
        B, T, F = x.shape
        xp = qdot(x.reshape(B * T, F), self.wx).reshape(B, T, -1)
        hs = []
        for t in range(T):
            c, h = self._gates_step(xp[:, t], c, h)
            hs.append(h)
        return torch.stack(hs, dim=1), (c, h)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-3 (Keras), computed in fp32 and
    returned in the input dtype."""

    def __init__(self, size: int):
        super().__init__()
        self.scale = frozen_param((size,))
        self.bias = frozen_param((size,))

    def reset_(self) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + 1e-3)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class BatchNorm(nn.Module):
    """Feature-wise BatchNorm over [B, T, F], eps 1e-3.  In inference it
    reads the running statistics; `forward_train` normalises with the
    batch's.  The running mean and variance stay fp32 whatever the
    parameter dtype."""

    def __init__(self, size: int):
        super().__init__()
        self.scale = frozen_param((size,))
        self.bias = frozen_param((size,))
        self.mean = frozen_param((size,))
        self.var = frozen_param((size,))

    def reset_(self) -> None:
        for p, v in ((self.scale, 1.0), (self.bias, 0.0), (self.mean, 0.0),
                     (self.var, 1.0)):
            p.fill_(v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._normalize(x, self.mean.float(), self.var.float())

    def _normalize(self, x, mean, var):
        y = (x.float() - mean) * torch.rsqrt(var + 1e-3)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)

    def forward_train(self, x: torch.Tensor):
        """Normalise with the batch statistics over (B, T), padded frames
        included, biased variance.  Returns (y, (new_mean, new_var)) with
        new = 0.99 * running + 0.01 * batch (Keras' momentum); the running
        statistics are not changed here (the train step writes them)."""
        momentum = 0.99
        xf = x.float()
        mean = xf.mean(dim=(0, 1))
        var = xf.var(dim=(0, 1), unbiased=False)
        with torch.no_grad():
            new = (momentum * self.mean.float() + (1 - momentum) * mean,
                   momentum * self.var.float() + (1 - momentum) * var)
        return self._normalize(x, mean, var), new


def time_reduction(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Concatenate `factor` adjacent frames: [B, T, F] -> [B, ceil(T/f), F*f],
    zero-padding the tail to a multiple of `factor`."""
    B, T, F = x.shape
    pad = (-T) % factor
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x.reshape(B, (T + pad) // factor, F * factor)


def reduced_length(lengths: torch.Tensor, factor: int) -> torch.Tensor:
    """Valid-frame count after time_reduction: ceil(len / factor)."""
    return -(-lengths // factor)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the caller's generator (on x's device): keep
    each element with probability 1 - rate, scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (
        1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device)
                       ).to(x.dtype)
