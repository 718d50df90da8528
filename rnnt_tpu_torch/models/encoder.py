"""Audio encoder: input BatchNorm, then stacked projected LSTMs with
dropout and LayerNorm, and a TimeReduction after layer
`time_reduction_index`.

The port of `rnnt_tpu.models.encoder`.  The per-layer LSTM state is carried
in and out, as the JAX encoder threads it.  In training the BatchNorm uses
the batch statistics and returns the updated running ones, and dropout
draws from the caller's generator.

`ENCODERS` maps the config's encoder type to the encoder class: this LSTM
encoder or `models.conformer.ConformerEncoder`, which keep one contract, so
`models.transducer.Transducer` and the train step never ask which it is.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.models import lstm as L
from rnnt_tpu_torch.models.conformer import ConformerEncoder

State = List[Tuple[torch.Tensor, torch.Tensor]]


class LSTMBlock(nn.Module):
    """One projected LSTM followed by LayerNorm (`lstm`, `ln` params)."""

    def __init__(self, input_size: int, hidden_size: int, proj_size: int):
        super().__init__()
        self.lstm = L.ProjLSTM(input_size, hidden_size, proj_size)
        self.ln = L.LayerNorm(proj_size)

    def reset_(self, rng: np.random.Generator) -> None:
        self.lstm.reset_(rng)
        self.ln.reset_()

    def forward(self, x, state=None, *, training: bool = False,
                dropout: float = 0.0, generator=None):
        y, new_state = self.lstm(x, state, training=training)
        if training:
            y = L.dropout(y, dropout, generator)
        return self.ln(y), new_state


class Encoder(nn.Module):
    def __init__(self, cfg: RNNTConfig):
        super().__init__()
        self.cfg = cfg
        self.bn = L.BatchNorm(cfg.input_feat_size)
        layers = []
        in_size = cfg.input_feat_size
        for i in range(cfg.encoder_layers):
            layers.append(LSTMBlock(in_size, cfg.encoder_size,
                                    cfg.projection_size))
            in_size = cfg.projection_size
            if i == cfg.time_reduction_index:
                in_size *= cfg.time_reduction_factor
        self.layers = nn.ModuleList(layers)

    def reset_(self, rng: np.random.Generator) -> None:
        self.bn.reset_()
        for layer in self.layers:
            layer.reset_(rng)

    def zero_state(self, batch: int, dtype=None) -> State:
        return [layer.lstm.zero_state(batch, dtype) for layer in self.layers]

    def encode(self, mel: torch.Tensor,
               lengths: Optional[torch.Tensor] = None,
               state: Optional[State] = None):
        """mel [B, T, feat] -> (encoded [B, T', P], new_state), with
        T' = ceil(T / time_reduction_factor); reads no `lengths`."""
        return self._layers(self.bn(mel), state, False, None)

    def encode_train(self, mel: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None, generator=None,
                     mesh=None):
        """The training forward from a zero state: (encoded, the updated
        BatchNorm running statistics by parameter name); with a
        data-parallel `mesh` the statistics are the global batch's."""
        x, (mean, var) = self.bn.forward_train(mel, mesh)
        return (self._layers(x, None, True, generator)[0],
                {"encoder.bn.mean": mean, "encoder.bn.var": var})

    def running_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics, by parameter name."""
        return {"encoder.bn.mean": self.bn.mean, "encoder.bn.var": self.bn.var}

    @staticmethod
    def encoded_length(cfg: RNNTConfig,
                       spec_lengths: torch.Tensor) -> torch.Tensor:
        """Valid encoder frames for given input frame counts; a negative
        time_reduction_index disables the reduction."""
        if cfg.time_reduction_index < 0:
            return spec_lengths
        return L.reduced_length(spec_lengths, cfg.time_reduction_factor)

    def _layers(self, x, state, training, generator):
        new_state = []
        for i, layer in enumerate(self.layers):
            x, st = layer(x, state[i] if state is not None else None,
                          training=training, dropout=self.cfg.dropout,
                          generator=generator)
            new_state.append(st)
            if i == self.cfg.time_reduction_index:
                x = L.time_reduction(x, self.cfg.time_reduction_factor)
        return x, new_state


def require_lstm_encoder(cfg: RNNTConfig, what: str) -> None:
    """Raise NotImplementedError, before any work, where `what` needs the
    LSTM encoder (its carried state, or the shared W1 of its joint)."""
    if cfg.encoder_type != "lstm":
        raise NotImplementedError(
            f"{what} is not available for encoder_type="
            f"{cfg.encoder_type!r}: it needs encoder_type='lstm' (a "
            "streaming encoder state or the joint's shared W1); the "
            "Conformer is a full-context encoder")


# The encoder classes' one contract: encode(mel, lengths, state) ->
# (encoded, new_state or None); encode_train(mel, lengths, generator, mesh)
# -> (encoded, BatchNorm statistics by name); running_stats();
# encoded_length(cfg, spec_lengths); reset_(rng).
ENCODERS = {"lstm": Encoder, "conformer": ConformerEncoder}


def encoder_class(cfg: RNNTConfig):
    """The encoder class of `cfg.encoder_type` (`ENCODERS`)."""
    return ENCODERS[cfg.encoder_type]


def encoded_length(cfg: RNNTConfig, spec_lengths: torch.Tensor) -> torch.Tensor:
    """Valid encoder frames for given input frame counts (the encoder
    class's rule)."""
    return encoder_class(cfg).encoded_length(cfg, spec_lengths)
