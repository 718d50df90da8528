"""Prediction (label) network: embedding, then stacked projected LSTMs with
dropout and LayerNorm.  The port of `rnnt_tpu.models.prediction`; decoding
carries its LSTM state instead of re-running the emitted prefix."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.models.encoder import LSTMBlock, State
from rnnt_tpu_torch.models.lstm import frozen_param


class Prediction(nn.Module):
    def __init__(self, cfg: RNNTConfig):
        super().__init__()
        self.dropout = cfg.dropout
        self.embed = frozen_param((cfg.vocab_size, cfg.embedding_size))
        in_sizes = [cfg.embedding_size] + [cfg.projection_size] * (
            cfg.pred_net_layers - 1)
        self.layers = nn.ModuleList(
            LSTMBlock(n, cfg.pred_net_size, cfg.projection_size)
            for n in in_sizes)

    def reset_(self, rng: np.random.Generator) -> None:
        for layer in self.layers:
            layer.reset_(rng)
        # Keras Embedding default init: uniform(-0.05, 0.05)
        self.embed.copy_(torch.from_numpy(
            rng.uniform(-0.05, 0.05, self.embed.shape).astype(np.float32)))

    def zero_state(self, batch: int, dtype=None) -> State:
        return [layer.lstm.zero_state(batch, dtype) for layer in self.layers]

    def forward(self, pred_inp: torch.Tensor, state: Optional[State] = None,
                *, training: bool = False, generator=None):
        """pred_inp [B, U+1] int token ids -> (out [B, U+1, P], new_state)."""
        x = self.embed[pred_inp]
        new_state = []
        for i, layer in enumerate(self.layers):
            x, st = layer(x, state[i] if state is not None else None,
                          training=training, dropout=self.dropout,
                          generator=generator)
            new_state.append(st)
        return x, new_state
