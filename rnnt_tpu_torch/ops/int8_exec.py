"""int8 execution of quantized matmul weights: the port of
`rnnt_tpu.ops.int8_exec`.

A quantized weight is a `QuantWeight` holding `q` (int8 [K, N]) and `s`
(fp32 [N], one scale per output channel), as the JAX package's {"q", "s"}
leaves.  `qdot` quantizes the activations per row on the fly and multiplies
int8 x int8 -> int32:

  weights:     symmetric per-output-channel int8, fp32 scales (ops.quantize)
  activations: symmetric per-row int8, scale = row absmax / 127
  accumulate:  int32, rescaled to fp32 by (activation scale x weight scale)

`qdot`, `qtake` and `act_dtype` also take plain tensors and then run the
fp path, so model code calls them whatever the weight's kind, and the kind
of the weight alone chooses the route.

The int32 product: on the card `torch._int_mm` (cuBLASLt's int8 GEMM; the
JAX package computes it with `lax.dot_general`, outside any Pallas kernel,
so a library call is its counterpart here), on the CPU `plain_int_mm`.  Both
are exact, so the two agree bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from rnnt_tpu_torch.ops.matmul import matmul_f32

# torch._int_mm's CUDA constraints: more than 16 rows, and K and N multiples
# of 8.  A QuantWeight pads its q once to the K and N multiples
# (`QuantWeight.operand`); each call pads the activations' rows and K.
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


class QuantWeight(nn.Module):
    """An int8 weight: `q` int8 [K, N] (or [V, D] for an embedding) and `s`
    fp32 [N] per-output-channel scales, as buffers so that `.to(device)`
    moves them.  A matmul weight whose K or N is not a multiple of
    INT_MM_ALIGN also holds `q_mm`, q with zero rows and columns up to them
    (not saved in a state_dict); an embedding table (`matmul=False`), read
    only by `qtake`, does not."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor,
                 matmul: bool = True):
        super().__init__()
        if q.dtype != torch.int8:
            raise ValueError(f"q must be int8, got {q.dtype}")
        self.register_buffer("q", q)
        self.register_buffer("s", s.float())
        K, N = q.shape
        pad_k, pad_n = -K % INT_MM_ALIGN, -N % INT_MM_ALIGN
        self.register_buffer(
            "q_mm", torch.nn.functional.pad(q, (0, pad_n, 0, pad_k))
            if matmul and (pad_k or pad_n) else None, persistent=False)

    @property
    def device(self):
        return self.q.device

    @property
    def operand(self) -> torch.Tensor:
        """q as the int32 product reads it: [K', N'] int8, K' and N' the
        multiples of INT_MM_ALIGN at or above K and N, zero past them."""
        return self.q if self.q_mm is None else self.q_mm

    def extra_repr(self) -> str:
        return f"q={tuple(self.q.shape)} int8"


def is_quant(w) -> bool:
    """True for an int8 weight (a `QuantWeight`)."""
    return isinstance(w, QuantWeight)


def weight_shape(w):
    return w.q.shape if is_quant(w) else w.shape


def act_dtype(w) -> torch.dtype:
    """The dtype activations are cast to before a product with `w`: fp32
    for an int8 weight (qdot quantizes them itself, from an exact range),
    else the weight's dtype."""
    return torch.float32 if is_quant(w) else w.dtype


def plain_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K', N] -> int32 [M, N], exactly: the operands
    widened to float64 (|sum| <= 127^2 K < 2^53), multiplied, cast back.
    b may have zero rows past K (`QuantWeight.operand`); they are not read.
    Runs on any device; it is the card path's plain version."""
    return (a.double() @ b[: a.shape[1]].double()).to(torch.int32)


def padded_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K', N] -> int32 [M, N] through
    `torch._int_mm`.  b must be padded already (`QuantWeight.operand`): K'
    and N multiples of INT_MM_ALIGN, K' >= K, b zero past row K.  a is
    zero-padded here, its rows to INT_MM_MIN_ROWS and its columns to K':
    zeros add nothing to an int32 sum, so the padding is exact, and the
    padded rows are dropped."""
    M, K = a.shape
    Kp, N = b.shape
    if Kp % INT_MM_ALIGN or N % INT_MM_ALIGN or Kp < K:
        raise ValueError(f"torch._int_mm needs b's K' and N % "
                         f"{INT_MM_ALIGN} == 0 and K' >= K={K}, got "
                         f"{tuple(b.shape)}")
    pad_rows = max(0, INT_MM_MIN_ROWS - M)
    if pad_rows or Kp > K:
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, pad_rows))
    y = torch._int_mm(a.contiguous(), b)
    return y[:M] if pad_rows else y


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K', N] -> int32 [M, N] (b zero past row K):
    `padded_int_mm` on a CUDA tensor (counted in `int_mm.launches`),
    `plain_int_mm` on the CPU."""
    if a.device.type != "cuda":
        return plain_int_mm(a, b)
    int_mm.launches += 1
    return padded_int_mm(a, b)


int_mm.launches = 0


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization of x [..., K]: (xi int8, a_scale
    fp32 [..., 1]), in the JAX package's order of operations."""
    xf = x.float()
    a = xf.abs().amax(dim=-1, keepdim=True)
    a_scale = torch.clamp(a, min=1e-12) / 127.0
    # |x| / a_scale <= 127; round is half-to-even, as jnp.round
    xi = torch.round(xf / a_scale).to(torch.int8)
    return xi, a_scale


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ w -> [..., N] fp32, with `w` a plain tensor
    (`matmul_f32`) or a `QuantWeight` (dynamic per-row int8
    activations, int8 x int8 -> int32, then y = yi * a_scale * s in fp32).
    Zero rows quantize to zeros and rescale by the clamped scale: no NaN."""
    if not is_quant(w):
        return matmul_f32(x, w)
    lead = x.shape[:-1]
    xi, a_scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    N = w.s.shape[0]
    yi = int_mm(xi, w.operand)
    if yi.shape[1] != N:  # the zero columns of QuantWeight.q_mm
        yi = yi[:, :N]
    y = yi.float() * a_scale * w.s
    return y.reshape(*lead, -1)


def qtake(embed, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of `ids`: from a plain table as stored, from an int8
    one as the int8 rows times the per-dimension scale (fp32)."""
    if not is_quant(embed):
        return embed[ids]
    return embed.q[ids].float() * embed.s
