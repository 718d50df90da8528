"""The Conformer encoder (Gulati et al., "Conformer: Convolution-augmented
Transformer for Speech Recognition", Interspeech 2020, arXiv:2005.08100),
selected by `RNNTConfig.encoder_type = "conformer"`.

From features [B, T, F] (F = mel_bins x downsample_factor) and their
lengths:

  subsampling   Conv2d(1 -> C, 3x3, stride 2, pad 1), ReLU,
                Conv2d(C -> C, 3x3, stride 2, pad 1), ReLU, then the C x F''
                values of a frame (channel-major) through Dense(-> D);
                C = D, T' = ceil(ceil(T / 2) / 2), lengths by the same rule
  block         x + 1/2 FFN(x); + MHSA; + Conv; + 1/2 FFN; LayerNorm
  FFN           LayerNorm, Dense(D -> ffn), Swish, Dense(ffn -> D)
  MHSA          LayerNorm, then H heads of d = D / H with Transformer-XL
                relative positions: scores ((q + u) k^T + (q + v) p^T)
                / sqrt d,
                p = R Wpos (R the sinusoidal table of the distances i - j,
                Wpos without bias, u and v learned [H, d]), softmax over the
                valid keys, then Dense(D -> D)
  Conv          LayerNorm, Dense(D -> 2D), GLU, depthwise Conv1d (kernel K,
                (K - 1) // 2 frames of zeros on the left and K // 2 on
                the right), BatchNorm, Swish, Dense(D -> D)

LayerNorm and BatchNorm eps are 1e-5.  Padding: a padded frame never
reaches a valid one.  The features past each length are zeroed before the
subsampling, and the first convolution's frames past ceil(len / 2) before
the second; attention masks the padded keys; the convolution module zeroes
the padded frames before its depthwise convolution; BatchNorm takes its
training statistics over the valid frames (across a data-parallel mesh,
the global batch's) and returns the updated running ones, by name.

Dense weights are [in, out] as everywhere in the port (`w`, `b`).  The
products are bf16 cuBLAS products with fp32 accumulation on the card
(`ops.matmul.dense`); LayerNorm, BatchNorm and the softmax compute in fp32.
On the card the attention runs in `scaled_dot_product_attention`'s
memory-efficient kernel with the position term and the padding as its
float mask; elsewhere the plain formula.  `attention_launches_by_path`
counts each MHSA call's path ("sdpa" / "plain").  Between its two products
the convolution module runs on the hand-written kernels K10 (forward: GLU,
mask, depthwise convolution, BatchNorm statistics, normalisation and Swish)
and K11 (their backward) of `ops.conv_module_cuda` when u and its
parameters are bf16 on the card and the BatchNorm statistics are the
rank's own (no mesh, or a data axis of 1) (`conv_module_cuda.fits`); on
the CPU, in fp32 and under a data mesh of more than one row it keeps the
formula below.  A bf16 module on the card that the kernels do not take (D
not a multiple of 64, a kernel of more than 32 taps, eval with a gradient
asked for) raises.  `conv_module_launches_by_path` counts each call's path
("kernel" / "plain").

Each module runs in `trace.module_span`: `rnnt.conformer.subsample`,
`.ffn`, `.mhsa`, `.conv`, and `.bwd` for their backward.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.models import lstm as L
from rnnt_tpu_torch.ops import conv_module_cuda
from rnnt_tpu_torch.ops.matmul import dense
from rnnt_tpu_torch.trace import module_span

NORM_EPS = 1e-5
ATTENTION_PATHS = ("sdpa", "plain")
attention_launches_by_path = dict.fromkeys(ATTENTION_PATHS, 0)
CONV_MODULE_PATHS = ("kernel", "plain")
conv_module_launches_by_path = dict.fromkeys(CONV_MODULE_PATHS, 0)


def subsampled_length(lengths: torch.Tensor) -> torch.Tensor:
    """Valid frames after the two stride-2 convolutions."""
    return -(-(-(-lengths // 2)) // 2)


def frame_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T] bool, True at the frames before each length."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def relative_table(T: int, D: int, device, dtype) -> torch.Tensor:
    """Sinusoids [2T - 1, D] of the distances T - 1, ..., -(T - 1) (row k
    is distance T - 1 - k): sin at the even columns, cos at the odd."""
    dist = torch.arange(T - 1, -T, -1, device=device, dtype=torch.float32)
    inv = torch.exp(torch.arange(0, D, 2, device=device, dtype=torch.float32)
                    * (-math.log(10000.0) / D))
    ang = dist[:, None] * inv[None, :]
    return torch.stack([ang.sin(), ang.cos()], -1).reshape(2 * T - 1,
                                                           D).to(dtype)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[..., T, 2T - 1] over the distances of `relative_table` ->
    [..., T, T] with out[i, j] = x[i, T - 1 - i + j] (distance i - j): a
    strided view of x, no copy (row i starts T - 1 - i columns in, and
    rows step by 2T - 2)."""
    x = x.contiguous()
    *lead, T, W = x.shape
    stride = list(x.stride()[:-2]) + [W - 1, 1]
    return x.as_strided((*lead, T, T), stride, x.storage_offset() + T - 1)


class LayerNorm(L.LayerNorm):
    """LayerNorm over the last axis, eps 1e-5, in one fused kernel: the
    statistics and the affine map in fp32, the result in the input's
    dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return Fn.layer_norm(x, x.shape[-1:], self.scale.to(x.dtype),
                             self.bias.to(x.dtype), NORM_EPS)


class BatchNorm(L.BatchNorm):
    """BatchNorm over [B, T, D], eps 1e-5, whose training statistics are
    the valid frames' (`mask` [B, T]): mean and E[x^2] in one pass over
    the frames, in fp32, and the normalisation one fused multiply-add
    (across a data-parallel mesh, `models.lstm.BatchNorm`'s global
    statistics)."""

    def __init__(self, size: int):
        super().__init__(size, NORM_EPS)

    def forward_train(self, x: torch.Tensor, mesh=None, mask=None):
        if mesh is not None and mesh.shape["data"] > 1:
            return super().forward_train(x, mesh, mask)
        xf = x.float()
        m = mask.to(xf.dtype)[..., None]
        count = m.sum()
        xm = xf * m
        mean = xm.sum(dim=(0, 1)) / count
        var = (xm * xf).sum(dim=(0, 1)) / count - mean.square()
        with torch.no_grad():
            new = (0.99 * self.mean.float() + 0.01 * mean,
                   0.99 * self.var.float() + 0.01 * var)
        a = torch.rsqrt(var + NORM_EPS) * self.scale.float()
        b = self.bias.float() - mean * a
        return torch.addcmul(b, xf, a).to(x.dtype), new


class Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.w = L.frozen_param((n_in, n_out))
        self.b = L.frozen_param((n_out,)) if bias else None

    def reset_(self, rng: np.random.Generator) -> None:
        L.glorot_(self.w, rng)
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


def _dropout(x, rate, training, generator):
    return L.dropout(x, rate, generator) if training else x


class FeedForward(nn.Module):
    def __init__(self, D: int, hidden: int):
        super().__init__()
        self.ln = LayerNorm(D)
        self.up = Dense(D, hidden)
        self.down = Dense(hidden, D)

    def reset_(self, rng) -> None:
        self.ln.reset_()
        self.up.reset_(rng)
        self.down.reset_(rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(Fn.silu(self.up(self.ln(x))))


class RelPosAttention(nn.Module):
    """Multi-head self-attention with relative positions (module
    docstring).  `qkv_w` [D, 3D] is the three projections' weights side by
    side, one product; their biases are leaves of their own (`q_b`, `k_b`,
    `v_b`): the key's bias adds the same score to every key of a query, so
    its gradient is zero but for rounding, and kept apart it is told apart
    from the leaves that learn."""

    def __init__(self, D: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln = LayerNorm(D)
        self.qkv_w = L.frozen_param((D, 3 * D))
        self.q_b = L.frozen_param((D,))
        self.k_b = L.frozen_param((D,))
        self.v_b = L.frozen_param((D,))
        self.pos = Dense(D, D, bias=False)
        self.pos_u = L.frozen_param((heads, D // heads))
        self.pos_v = L.frozen_param((heads, D // heads))
        self.out = Dense(D, D)

    def reset_(self, rng) -> None:
        self.ln.reset_()
        L.glorot_(self.qkv_w, rng)
        for b in (self.q_b, self.k_b, self.v_b):
            b.zero_()
        for m in (self.pos, self.out):
            m.reset_(rng)
        for p in (self.pos_u, self.pos_v):
            L.glorot_(p, rng)

    def forward(self, x: torch.Tensor, rel: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        """x [B, T, D], rel: `relative_table(T, D)`, valid [B, T] bool."""
        B, T, D = x.shape
        H = self.heads
        d = D // H
        qkv = dense(self.ln(x), self.qkv_w,
                    torch.cat([self.q_b, self.k_b, self.v_b]))
        q, k, v = qkv.view(B, T, 3, H, d).permute(2, 0, 3, 1, 4)  # [B,H,T,d]
        p = self.pos(rel).view(2 * T - 1, H, d).transpose(0, 1)
        qu = q + self.pos_u[None, :, None, :].to(q.dtype)
        # the position term's 1 / sqrt(d) goes on (q + v), where it costs
        # one pass over [B, H, T, d] and not one over [B, H, T, T]
        qv = (q + self.pos_v[None, :, None, :].to(q.dtype)) * (
            1.0 / math.sqrt(d))
        pos = rel_shift(torch.matmul(qv, p.transpose(-1, -2)))
        bias = pos.masked_fill(~valid[:, None, None, :], float("-inf"))
        if x.is_cuda:
            from torch.nn.attention import SDPBackend, sdpa_kernel

            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                ctx = Fn.scaled_dot_product_attention(qu, k, v,
                                                      attn_mask=bias)
            attention_launches_by_path["sdpa"] += 1
        else:
            scores = (torch.matmul(qu, k.transpose(-1, -2)).float()
                      / math.sqrt(d) + bias.float())
            ctx = torch.matmul(torch.softmax(scores, -1).to(v.dtype), v)
            attention_launches_by_path["plain"] += 1
        return self.out(ctx.transpose(1, 2).reshape(B, T, D))


class ConvModule(nn.Module):
    def __init__(self, D: int, kernel: int):
        super().__init__()
        self.kernel = kernel
        self.ln = LayerNorm(D)
        self.pw1 = Dense(D, 2 * D)
        self.dw_w = L.frozen_param((D, kernel))
        self.dw_b = L.frozen_param((D,))
        self.bn = BatchNorm(D)
        self.pw2 = Dense(D, D)

    def reset_(self, rng) -> None:
        self.ln.reset_()
        self.pw1.reset_(rng)
        self.pw2.reset_(rng)
        # a depthwise filter's fan-in and fan-out are both its taps
        lim = (6.0 / (2 * self.kernel)) ** 0.5
        self.dw_w.copy_(torch.from_numpy(rng.uniform(
            -lim, lim, tuple(self.dw_w.shape)).astype(np.float32)))
        self.dw_b.zero_()
        self.bn.reset_()

    def forward(self, x, valid, training, mesh):
        """(y, (BatchNorm mean, var): the updated running statistics in
        training, else None)."""
        s, stats = self.glu_to_swish(self.pw1(self.ln(x)), valid, training,
                                     mesh)
        return self.pw2(s), stats

    def glu_to_swish(self, u, valid, training, mesh):
        """pw1's output u [B, T, 2D] -> (pw2's input, the BatchNorm
        statistics as `forward`): K10 and K11 where
        `conv_module_cuda.fits`, else `formula`."""
        bn = self.bn
        if conv_module_cuda.fits(u, self.dw_w, self.dw_b, bn.scale, bn.bias,
                                 mesh, training):
            conv_module_launches_by_path["kernel"] += 1
            return conv_module_cuda.conv_module(
                u, valid, self.dw_w, self.dw_b, bn.scale, bn.bias, bn.mean,
                bn.var, NORM_EPS, training)
        conv_module_launches_by_path["plain"] += 1
        return self.formula(u, valid, training, mesh)

    def formula(self, u, valid, training, mesh):
        """GLU, mask, depthwise Conv1d, BatchNorm and Swish in PyTorch's
        ops (`glu_to_swish`)."""
        K = self.kernel
        y = Fn.glu(u, dim=-1).masked_fill(~valid[..., None], 0.0)
        y = Fn.pad(y.transpose(1, 2), ((K - 1) // 2, K // 2))
        y = Fn.conv1d(y, self.dw_w.to(y.dtype)[:, None, :],
                      self.dw_b.to(y.dtype), groups=y.shape[1]).transpose(1, 2)
        if training:
            y, stats = self.bn.forward_train(y, mesh, valid)
        else:
            y, stats = self.bn(y), None
        return Fn.silu(y), stats


class ConformerBlock(nn.Module):
    def __init__(self, cfg: RNNTConfig):
        super().__init__()
        D = cfg.conformer_dim
        self.ffn1 = FeedForward(D, cfg.conformer_ffn_size)
        self.mhsa = RelPosAttention(D, cfg.conformer_heads)
        self.conv = ConvModule(D, cfg.conformer_kernel_size)
        self.ffn2 = FeedForward(D, cfg.conformer_ffn_size)
        self.ln = LayerNorm(D)

    def reset_(self, rng) -> None:
        for m in (self.ffn1, self.mhsa, self.conv, self.ffn2):
            m.reset_(rng)
        self.ln.reset_()

    def forward(self, x, rel, valid, *, training, dropout, generator, mesh):
        def drop(y):
            return _dropout(y, dropout, training, generator)

        x = torch.add(x, drop(module_span("rnnt.conformer.ffn", self.ffn1, x)),
                      alpha=0.5)
        x = x + drop(module_span("rnnt.conformer.mhsa", self.mhsa, x, rel,
                                 valid))
        stats = {}

        def conv(x_):
            y, st = self.conv(x_, valid, training, mesh)
            stats["bn"] = st
            return y

        x = x + drop(module_span("rnnt.conformer.conv", conv, x))
        x = torch.add(x, drop(module_span("rnnt.conformer.ffn", self.ffn2, x)),
                      alpha=0.5)
        return self.ln(x), stats["bn"]


class Subsampling(nn.Module):
    def __init__(self, cfg: RNNTConfig):
        super().__init__()
        C = D = cfg.conformer_dim
        F = cfg.input_feat_size
        self.conv1_w = L.frozen_param((C, 1, 3, 3))
        self.conv1_b = L.frozen_param((C,))
        self.conv2_w = L.frozen_param((C, C, 3, 3))
        self.conv2_b = L.frozen_param((C,))
        self.out = Dense(C * (-(-(-(-F // 2)) // 2)), D)

    def reset_(self, rng) -> None:
        for w in (self.conv1_w, self.conv2_w):  # Glorot over 3x3 fans
            fan_in, fan_out = w.shape[1] * 9, w.shape[0] * 9
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            w.copy_(torch.from_numpy(rng.uniform(
                -lim, lim, tuple(w.shape)).astype(np.float32)))
        self.conv1_b.zero_()
        self.conv2_b.zero_()
        self.out.reset_(rng)

    def forward(self, w1: torch.Tensor, mel: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        """mel [B, T, F] -> [B, T', D]; `w1` is conv1's weight (the
        backward span's end, `trace.module_span`)."""
        dt = self.conv2_w.dtype
        keep = frame_mask(lengths, mel.shape[1])
        x = mel.to(dt).masked_fill(~keep[..., None], 0.0)
        x = Fn.relu(Fn.conv2d(x[:, None], w1, self.conv1_b, stride=2,
                              padding=1))
        half = frame_mask(-(-lengths // 2), x.shape[2])
        x = x.masked_fill(~half[:, None, :, None], 0.0)
        x = Fn.relu(Fn.conv2d(x, self.conv2_w, self.conv2_b, stride=2,
                              padding=1))
        B, C, T, F = x.shape
        return self.out(x.permute(0, 2, 1, 3).reshape(B, T, C * F))


class ConformerEncoder(nn.Module):
    """Subsampling and `encoder_layers` blocks (module docstring)."""

    def __init__(self, cfg: RNNTConfig):
        super().__init__()
        self.cfg = cfg
        self.subsample = Subsampling(cfg)
        self.blocks = nn.ModuleList(ConformerBlock(cfg)
                                    for _ in range(cfg.encoder_layers))

    def reset_(self, rng: np.random.Generator) -> None:
        self.subsample.reset_(rng)
        for b in self.blocks:
            b.reset_(rng)

    def running_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics, by parameter name under
        `encoder.`."""
        out = {}
        for i, b in enumerate(self.blocks):
            out[f"encoder.blocks.{i}.conv.bn.mean"] = b.conv.bn.mean
            out[f"encoder.blocks.{i}.conv.bn.var"] = b.conv.bn.var
        return out

    def encode(self, mel: torch.Tensor,
               lengths: Optional[torch.Tensor] = None, state=None):
        """mel [B, T, F] and lengths [B] (None: every frame) -> (encoded
        [B, T', D], None): no state is carried, and one given is refused."""
        if state is not None:
            from rnnt_tpu_torch.models.encoder import require_lstm_encoder

            require_lstm_encoder(self.cfg, "encoding from a carried state")
        return self._forward(mel, lengths, False, None, None)[0], None

    def encode_train(self, mel: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None, generator=None,
                     mesh=None):
        """(encoded, the updated BatchNorm running statistics by name)."""
        return self._forward(mel, lengths, True, generator, mesh)

    @staticmethod
    def encoded_length(cfg: RNNTConfig,
                       spec_lengths: torch.Tensor) -> torch.Tensor:
        """Valid encoder frames: the subsampling's by 4."""
        return subsampled_length(spec_lengths)

    def _forward(self, mel, lengths, training, generator, mesh):
        """(encoded, in training the updated BatchNorm running statistics
        by name, else None)."""
        B, T, _ = mel.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.long, device=mel.device)
        lengths = lengths.to(mel.device)
        sub = self.subsample
        x = module_span("rnnt.conformer.subsample", sub, sub.conv1_w, mel,
                        lengths)
        Tp = x.shape[1]
        valid = frame_mask(subsampled_length(lengths), Tp)
        rel = relative_table(Tp, self.cfg.conformer_dim, x.device, x.dtype)
        stats = {} if training else None
        for i, b in enumerate(self.blocks):
            x, st = b(x, rel, valid, training=training,
                      dropout=self.cfg.dropout, generator=generator, mesh=mesh)
            if training:
                stats[f"encoder.blocks.{i}.conv.bn.mean"] = st[0]
                stats[f"encoder.blocks.{i}.conv.bn.var"] = st[1]
        return x, stats
