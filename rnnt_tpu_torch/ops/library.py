"""Kernel K2 as a registered operator, so that `torch.export` records it.

`torch.export` cannot trace into a `ctypes` launch, so the projected-LSTM
inference recurrence (`ops.lstm_cuda.lstm_seq_infer`) is registered as the
operator `rnnt_tpu_torch::lstm_seq_infer` (no argument mutated): an
exported graph holds a call of the operator, and a loaded artifact calls it
again, which launches K2 on a CUDA tensor (the wrapper's launch counts
move) and runs its plain version on a CPU tensor.  The fake implementation
gives only the output shapes and dtypes; it never calls the launcher or
`torch.cuda`.

`models.lstm.ProjLSTM` calls K2 through this operator while
`torch.export` (or `torch.compile`) traces it, so an exported graph holds
the same operator on the CPU as on the card; eager inference calls the
wrapper directly, since the dispatch costs host time at every
prediction-net step of a greedy decode.  The operator is defined with
`torch.library.Library` and one CompositeExplicitAutograd kernel rather
than the `torch.library.custom_op` decorator, whose Python wrapper costs
more a call.  It is inference only (no autograd formula).  Importing this
module registers the operator: `export.load_artifact` imports it before it
loads a `.pt2`.
"""

from __future__ import annotations

import torch

from rnnt_tpu_torch.ops import lstm_cuda

NAMESPACE, NAME = "rnnt_tpu_torch", "lstm_seq_infer"
_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define(f"{NAME}(Tensor xp, Tensor wh, Tensor wp, Tensor bias, "
            "Tensor h0, Tensor c0) -> (Tensor, Tensor)")


def _lstm_seq_infer_impl(xp, wh, wp, bias, h0, c0):
    """K2 over xp [T, B, 4H]: (h_seq [T, B, P] in Wh's dtype, c_fin [B, H]
    fp32), as `ops.lstm_cuda.lstm_seq_infer` (looked up at each call)."""
    h_seq, c_fin = lstm_cuda.lstm_seq_infer(xp, wh, wp, bias, h0, c0)
    # an operator's outputs may not alias its inputs: h_seq is always a new
    # tensor, c_fin is c0 itself when the plain version runs no step (T = 0)
    if c_fin is c0:
        c_fin = c_fin.clone()
    return h_seq, c_fin


_LIB.impl(NAME, _lstm_seq_infer_impl, "CompositeExplicitAutograd")


@torch.library.register_fake(f"{NAMESPACE}::{NAME}")
def _lstm_seq_infer_fake(xp, wh, wp, bias, h0, c0):
    T, B, _ = xp.shape
    H, P = wp.shape
    return (xp.new_empty((T, B, P), dtype=wh.dtype),
            xp.new_empty((B, H), dtype=torch.float32))


lstm_seq_infer = getattr(getattr(torch.ops, NAMESPACE), NAME).default
