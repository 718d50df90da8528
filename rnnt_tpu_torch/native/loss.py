"""The OpenMP RNN-T loss (`rnnt_loss_cpu.cc`): an oracle on the host,
independent of the CUDA kernels and of the plain PyTorch lattice."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from rnnt_tpu_torch.native.build import load_library


def rnnt_loss_cpu(logits: np.ndarray, labels: np.ndarray,
                  logit_lengths: np.ndarray, label_lengths: np.ndarray,
                  *, with_grad: bool = False
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Per-example NLL [B] of raw logits [B, T, U+1, V] (blank 0, labels
    [B, U]), and with_grad d(sum of the losses)/d(logits), fp32."""
    lib = load_library()
    logits = np.ascontiguousarray(logits, np.float32)
    labels = np.ascontiguousarray(labels, np.int32)
    fl = np.ascontiguousarray(logit_lengths, np.int32)
    yl = np.ascontiguousarray(label_lengths, np.int32)
    B, T, U1, V = logits.shape
    if labels.shape != (B, U1 - 1):
        raise ValueError(f"labels {labels.shape} do not fit logits "
                         f"{logits.shape}")
    loss = np.zeros((B,), np.float32)
    grad = np.zeros_like(logits) if with_grad else None

    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int32)
    rc = lib.rnnt_loss_cpu(
        logits.ctypes.data_as(fptr), labels.ctypes.data_as(iptr),
        fl.ctypes.data_as(iptr), yl.ctypes.data_as(iptr),
        B, T, U1, V,
        loss.ctypes.data_as(fptr),
        grad.ctypes.data_as(fptr) if with_grad else ctypes.cast(None, fptr))
    if rc != 0:
        raise ValueError(f"rnnt_loss_cpu failed with code {rc}")
    return loss, grad
