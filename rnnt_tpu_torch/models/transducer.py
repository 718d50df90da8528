"""The RNN-Transducer: encoder + prediction net + joint.

The port of `rnnt_tpu.models.transducer`.  Parameter names mirror the JAX
parameter tree ("encoder.layers.0.lstm.wx" is params["encoder"]["layers"][0]
["lstm"]["wx"]), so `train.checkpoint.params_from_numpy` maps one onto the
other by name.  `load_params_` also takes the mixed trees of int8 execution
(`ops.quantize.int8_exec_params`), whose int8 weights replace the
parameters of their names as `ops.int8_exec.QuantWeight` modules.

The encoder is the class `models.encoder.ENCODERS` holds for the config's
encoder type, reached only through the encoders' shared contract
(`encode`, `encode_train`, `running_stats`, `encoded_length`): the LSTM
encoder (`encoder.bn.*`, `encoder.layers.*`) or
`models.conformer.ConformerEncoder` (`encoder.subsample.*`,
`encoder.blocks.*`; the joint then has a prediction-side `w1p`), which
reads each utterance's length, holds a BatchNorm in every block and
carries no streaming state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.models import joint as joint_mod
from rnnt_tpu_torch.models.encoder import (State, encoder_class,
                                           require_lstm_encoder)
from rnnt_tpu_torch.models.prediction import Prediction
from rnnt_tpu_torch.ops.int8_exec import is_quant


def fp32_leaf(name: str) -> bool:
    """Leaves that stay fp32 whatever the parameter dtype and take no
    gradient: the BatchNorm running statistics (`encoder.bn.mean` and
    `.var` in the JAX tree; each Conformer block's `conv.bn.mean`, `.var`)."""
    return name.endswith((".bn.mean", ".bn.var"))


class Transducer(nn.Module):
    def __init__(self, cfg: RNNTConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = encoder_class(cfg)(cfg)
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
    def load_params_(self, params) -> "Transducer":
        """Load a tree of every parameter name -> a tensor (copied, in the
        tensor's dtype, onto the model's device, into the same Parameter) or
        a `QuantWeight` (which takes the parameter's place); a name that
        held an int8 weight gets a frozen parameter again from a tensor."""
        want = set(self._param_names())
        if set(params) != want:
            raise ValueError(
                f"parameter names differ: missing "
                f"{sorted(want - set(params))}, unknown "
                f"{sorted(set(params) - want)}")
        device = self.dtype_param.device
        for name, value in params.items():
            owner_name, _, attr = name.rpartition(".")
            owner = self.get_submodule(owner_name)
            current = getattr(owner, attr)
            if is_quant(value):
                delattr(owner, attr)  # a parameter slot takes no module
                setattr(owner, attr, value.to(device))
            elif is_quant(current):
                delattr(owner, attr)
                setattr(owner, attr, torch.nn.Parameter(
                    value.detach().to(device).clone(), requires_grad=False))
            else:  # the same Parameter object, for optimizer and autograd
                current.data = value.detach().to(device).clone()
        return self

    def _param_names(self):
        """Dotted names of the parameter tree, an int8 weight counted once
        under its own name."""
        return [n for n, _ in self.named_parameters()] + self.int8_names()

    def int8_names(self):
        """Names of the weights held in int8."""
        return sorted(n for n, m in self.named_modules() if is_quant(m))

    @torch.no_grad()
    def cast_(self, dtype) -> "Transducer":
        """Parameters to `dtype`, except the fp32 BatchNorm statistics; int8
        weights stay as they are."""
        for name, p in self.named_parameters():
            if not fp32_leaf(name):
                p.data = p.data.to(dtype)
        return self

    def make_trainable_(self) -> "Transducer":
        """Gradients on for every parameter but the BatchNorm running
        statistics (the JAX package's trainable mask)."""
        for name, p in self.named_parameters():
            p.requires_grad_(not fp32_leaf(name))
        return self

    @property
    def dtype_param(self) -> torch.Tensor:
        """The encoder's first parameter in the parameter dtype (int8
        weights live only in the prediction net and the joint)."""
        return next(p for n, p in self.encoder.named_parameters("encoder")
                    if not fp32_leaf(n))

    @property
    def dtype(self) -> torch.dtype:
        """The parameter dtype (the encoder's)."""
        return self.dtype_param.dtype

    def running_stats(self):
        """The BatchNorm running statistics, by parameter name."""
        return self.encoder.running_stats()

    def encode_predict(self, mel: torch.Tensor, pred_inp: torch.Tensor, *,
                       training: bool = False, generator=None, mesh=None,
                       lengths: Optional[torch.Tensor] = None):
        """Encoder and prediction net over a batch: (encoded [B, T', P],
        pred_out [B, U+1, P], BatchNorm statistics by parameter name).  In
        training the statistics are the updated running ones (of the
        global batch across a data-parallel `mesh`); otherwise the current
        ones.  `lengths` [B]: the valid input frames (the Conformer masks
        the rest; the LSTM encoder reads none)."""
        if training:
            encoded, bn_stats = self.encoder.encode_train(mel, lengths,
                                                          generator, mesh)
        else:
            encoded, _ = self.encoder.encode(mel, lengths)
            bn_stats = self.running_stats()
        pred_out, _ = self.prediction(pred_inp, training=training,
                                      generator=generator)
        return encoded, pred_out, bn_stats

    def apply(self, mel: torch.Tensor, pred_inp: torch.Tensor, *,
              training: bool = False, generator=None, mesh=None,
              lengths: Optional[torch.Tensor] = None):
        """Full forward: (logits [B, T', U+1, V] fp32, BatchNorm stats)."""
        encoded, pred_out, bn_stats = self.encode_predict(
            mel, pred_inp, training=training, generator=generator, mesh=mesh,
            lengths=lengths)
        return joint_mod.joint_logits(self.joint, encoded, pred_out), bn_stats

    def encode(self, mel: torch.Tensor, state: Optional[State] = None,
               lengths: Optional[torch.Tensor] = None):
        """mel [B, T, feat] -> (encoded [B, T', P], new_state); a Conformer
        takes the valid frames' `lengths` (None: all) and no state, and
        returns None for it."""
        return self.encoder.encode(mel, lengths, state)

    def predict_step(self, tokens: torch.Tensor, state: State):
        """One prediction-net step: tokens [B] -> (out [B, P], new_state)."""
        out, new_state = self.prediction(tokens[:, None], state)
        return out[:, 0], new_state

    def prediction_zero_state(self, batch: int, dtype=None) -> State:
        return self.prediction.zero_state(batch, dtype)

    def encoder_zero_state(self, batch: int, dtype=None) -> State:
        require_lstm_encoder(self.cfg, "a streaming encoder state")
        return self.encoder.zero_state(batch, dtype)

    def joint_step(self, enc_t: torch.Tensor,
                   pred_u: torch.Tensor) -> torch.Tensor:
        return joint_mod.joint_step(self.joint, enc_t, pred_u)

    def encoded_length(self, spec_lengths: torch.Tensor) -> torch.Tensor:
        return self.encoder.encoded_length(self.cfg, spec_lengths)
