"""Additive joint network: Dense(joint_size, tanh) over enc + pred, then
Dense(vocab).  The port of `rnnt_tpu.models.joint`.  The products are plain
cuBLAS products with fp32 results (`ops.matmul`), as XLA computes them
outside any kernel on the TPU.  `joint_logits` materialises the [B, T, U+1, V] lattice for the
"ref" and "pallas" losses; the fused loss (`ops.joint_loss_fused`) never
does.  An int8 w1 or w2 (`ops.int8_exec.QuantWeight`) goes through `qdot`,
with its input in fp32, as the JAX joint does."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.models.lstm import frozen_param, glorot_
from rnnt_tpu_torch.ops.int8_exec import act_dtype, qdot


class Joint(nn.Module):
    def __init__(self, cfg: RNNTConfig):
        super().__init__()
        self.init_blank_bias = cfg.init_blank_bias
        self.w1 = frozen_param((cfg.projection_size, cfg.joint_size))
        self.b1 = frozen_param((cfg.joint_size,))
        self.w2 = frozen_param((cfg.joint_size, cfg.vocab_size))
        self.b2 = frozen_param((cfg.vocab_size,))

    def reset_(self, rng: np.random.Generator) -> None:
        glorot_(self.w1, rng)
        glorot_(self.w2, rng)
        self.b1.zero_()
        self.b2.zero_()
        self.b2[0] = self.init_blank_bias


def joint_project(joint: Joint, enc: torch.Tensor, pred: torch.Tensor):
    """Project each side through the shared first Dense: [.., P] -> [.., J]."""
    return qdot(enc, joint.w1), qdot(pred, joint.w1)


def joint_logits(joint: Joint, enc: torch.Tensor,
                 pred: torch.Tensor) -> torch.Tensor:
    """Lattice logits [B, T, U+1, V] from enc [B, T, P], pred [B, U+1, P]."""
    f, g = joint_project(joint, enc, pred)
    h = torch.tanh(f[:, :, None, :] + g[:, None, :, :] + joint.b1.float())
    return qdot(h.to(act_dtype(joint.w2)), joint.w2) + joint.b2.float()


def joint_step(joint: Joint, enc_t: torch.Tensor,
               pred_u: torch.Tensor) -> torch.Tensor:
    """Single-cell joint for decoding: enc_t [B, P], pred_u [B, P] ->
    logits [B, V] fp32."""
    h = torch.tanh(qdot(enc_t + pred_u, joint.w1) + joint.b1.float())
    return qdot(h.to(act_dtype(joint.w2)), joint.w2) + joint.b2.float()
