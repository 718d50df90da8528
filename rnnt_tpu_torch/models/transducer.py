"""The RNN-Transducer: encoder + prediction net + joint.

The port of `rnnt_tpu.models.transducer`.  Parameter names mirror the JAX
parameter tree ("encoder.layers.0.lstm.wx" is params["encoder"]["layers"][0]
["lstm"]["wx"]), so `train.checkpoint.params_from_numpy` maps one onto the
other by name.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.models import joint as joint_mod
from rnnt_tpu_torch.models.encoder import Encoder, State, encoded_length
from rnnt_tpu_torch.models.prediction import Prediction

# Leaves that stay fp32 whatever the parameter dtype (BatchNorm running
# statistics, as in the JAX tree).
FP32_LEAVES = ("encoder.bn.mean", "encoder.bn.var")


class Transducer(nn.Module):
    def __init__(self, cfg: RNNTConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.prediction = Prediction(cfg)
        self.joint = joint_mod.Joint(cfg)

    @torch.no_grad()
    def init_(self, seed: int) -> "Transducer":
        """Random parameters from a numpy seed: Glorot-uniform weights,
        forget-gate bias 1, unit LayerNorm/BatchNorm, Keras embedding init
        (the JAX package's init scheme; the random numbers differ)."""
        rng = np.random.default_rng(seed)
        self.encoder.reset_(rng)
        self.prediction.reset_(rng)
        self.joint.reset_(rng)
        return self

    @torch.no_grad()
    def cast_(self, dtype) -> "Transducer":
        """Parameters to `dtype`, except the fp32 BatchNorm statistics."""
        for name, p in self.named_parameters():
            if name not in FP32_LEAVES:
                p.data = p.data.to(dtype)
        return self

    def make_trainable_(self) -> "Transducer":
        """Gradients on for every parameter but the BatchNorm running
        statistics (the JAX package's trainable mask)."""
        for name, p in self.named_parameters():
            p.requires_grad_(name not in FP32_LEAVES)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.joint.w1.dtype

    def encode_predict(self, mel: torch.Tensor, pred_inp: torch.Tensor, *,
                       training: bool = False, generator=None):
        """Encoder and prediction net over a batch: (encoded [B, T', P],
        pred_out [B, U+1, P], (BatchNorm mean, var)).  In training the
        BatchNorm statistics are the updated running ones; otherwise the
        current ones."""
        if training:
            encoded, bn_stats = self.encoder.forward_train(mel, generator)
        else:
            encoded, _ = self.encoder(mel)
            bn_stats = (self.encoder.bn.mean, self.encoder.bn.var)
        pred_out, _ = self.prediction(pred_inp, training=training,
                                      generator=generator)
        return encoded, pred_out, bn_stats

    def apply(self, mel: torch.Tensor, pred_inp: torch.Tensor, *,
              training: bool = False, generator=None):
        """Full forward: (logits [B, T', U+1, V] fp32, BatchNorm stats)."""
        encoded, pred_out, bn_stats = self.encode_predict(
            mel, pred_inp, training=training, generator=generator)
        return joint_mod.joint_logits(self.joint, encoded, pred_out), bn_stats

    def encode(self, mel: torch.Tensor, state: Optional[State] = None):
        """mel [B, T, feat] -> (encoded [B, T', P], new_state)."""
        return self.encoder(mel, state)

    def predict_step(self, tokens: torch.Tensor, state: State):
        """One prediction-net step: tokens [B] -> (out [B, P], new_state)."""
        out, new_state = self.prediction(tokens[:, None], state)
        return out[:, 0], new_state

    def prediction_zero_state(self, batch: int, dtype=None) -> State:
        return self.prediction.zero_state(batch, dtype)

    def encoder_zero_state(self, batch: int, dtype=None) -> State:
        return self.encoder.zero_state(batch, dtype)

    def joint_step(self, enc_t: torch.Tensor,
                   pred_u: torch.Tensor) -> torch.Tensor:
        return joint_mod.joint_step(self.joint, enc_t, pred_u)

    def encoded_length(self, spec_lengths: torch.Tensor) -> torch.Tensor:
        return encoded_length(self.cfg, spec_lengths)
