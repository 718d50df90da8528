"""Matrix products with JAX's result types, outside any kernel.

JAX's `dot(..., preferred_element_type=float32)` multiplies bf16 operands
exactly and accumulates in fp32 without rounding the result; `torch.matmul`
of two bf16 tensors returns a rounded bf16 tensor instead.  `matmul_f32`
keeps JAX's contract: on the card two bf16 operands go through cuBLAS with
an fp32 output (`torch.mm(..., out_dtype=torch.float32)`), elsewhere the
operands are widened to fp32 first (the same exact products).  `dense`
is a layer's product and bias in the activations' dtype.
"""

from __future__ import annotations

import torch


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D a @ b as an fp32 result, without autograd."""
    if a.dtype == b.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def addmm_f32_(acc: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """acc += a @ b in place for an fp32 acc (2-D, without autograd); on
    the card two bf16 operands accumulate straight into acc (cuBLAS)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)
    return acc.add_(mm_f32(a, b))


class _MatmulF32(torch.autograd.Function):
    """x [..., K] @ w [K, N] -> fp32 [..., N]; the gradients are fp32
    products too, returned in the operands' dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        lead = x.shape[:-1]
        return mm_f32(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy2 = dy.reshape(-1, dy.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = mm_f32(dy2, w.t()).reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = mm_f32(x.reshape(-1, x.shape[-1]).t(), dy2).to(w.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as an fp32 result (JAX's preferred_element_type=float32)."""
    if x.dtype == w.dtype == torch.float32:
        return torch.matmul(x, w)
    return _MatmulF32.apply(x, w)


def matmul_to(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """x @ w with fp32 accumulation, returned in `dtype`.  Operands of one
    dtype multiply directly (cuBLAS accumulates bf16 in fp32 and rounds
    once); mixed operands multiply in fp32."""
    if x.dtype == w.dtype:
        return torch.matmul(x, w).to(dtype)
    return torch.matmul(x.float(), w.float()).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x [..., K] @ w [K, N] (+ b) in x's dtype, with autograd: one cuBLAS
    product accumulating in fp32 on the card, the bias in its epilogue."""
    return torch.nn.functional.linear(x, w.t(), b)
