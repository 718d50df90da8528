"""Serialized model export via `torch.export`: the port of
`rnnt_tpu.export`.

Two artifacts cover the model's inference surfaces, each a `.pt2` file
(`torch.export.save`) with a `.json` sidecar of its metadata:

- `streaming_step`: the chunked stateful decode step
  (mel_chunk [Tc, F], enc_state, carry) -> (tokens, n, enc_state, carry),
  the encoder with carried state and greedy decoding with the carried
  prediction state, as one function with explicit state;
- `transcribe`: whole-utterance batched greedy decoding
  (mel [B, T, F], spec_lengths [B]) -> (tokens, lengths).

Both take log-mel input and run in fp32.  Greedy decoding is
`decode.greedy.greedy_decode_encoded_graph`, whose loops are a
`while_loop` with no host read, and the LSTM recurrence is the registered
operator `rnnt_tpu_torch::lstm_seq_infer` (`ops.library`), so a loaded
artifact launches kernel K2 on the card.  Loading therefore needs
`rnnt_tpu_torch.ops.library` importable (`load_artifact` imports it); the
JAX package's StableHLO needs nothing of its package.  A `.pt2` holds the
ops of one device, so an artifact is exported for one `device` (the card
unless the caller asks for the CPU), where the JAX artifact names several
platforms.

With `freeze_params=True` (the default) the weights travel inside the
`.pt2`; with False they are a runtime argument, a dict of tensors keyed by
the port's parameter names (`Transducer._param_names()`), and the artifact
holds none.  The sidecar records each artifact's calling convention.
Call a loaded artifact as `load_artifact(path).module()(*args)`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import torch
from torch import nn

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.decode.greedy import greedy_decode_encoded_graph
from rnnt_tpu_torch.device import resolve_device
from rnnt_tpu_torch.models.encoder import require_lstm_encoder
from rnnt_tpu_torch.models.transducer import Transducer
from rnnt_tpu_torch.ops import library  # noqa: F401  (registers K2's op)


class _Bound(nn.Module):
    """Runs `fn(model, *args)` with the model's own weights, which an
    exported program of this module carries."""

    def __init__(self, model: Transducer, fn):
        super().__init__()
        self.model = model
        self._fn = fn

    def forward(self, *args):
        return self._fn(self.model, *args)


class _Unbound(nn.Module):
    """Runs `fn(model, *args)` on weights given at call time, a dict keyed
    by the model's parameter names: the model sits outside this module's
    tree, so an exported program of it carries none of its weights, and
    `torch.func.functional_call` swaps the given ones in."""

    def __init__(self, model: Transducer, fn):
        super().__init__()
        object.__setattr__(self, "_bound", _Bound(model, fn))

    def forward(self, params: Dict[str, torch.Tensor], *args):
        return torch.func.functional_call(
            self._bound, {f"model.{k}": v for k, v in params.items()}, args)


def _fp32_model(model: Transducer, device) -> Transducer:
    """The model moved to `device` with fp32 parameters, in inference mode
    (the artifacts run in fp32, as the JAX package's do)."""
    if model.int8_names():
        raise ValueError("export takes fp weights, not int8 execution's")
    model = model.to(device)
    if model.dtype != torch.float32:
        model = model.cast_(torch.float32)
    return model.eval()


def streaming_init_state(cfg: RNNTConfig, dtype=torch.float32,
                         device="cuda"):
    """(enc_state, pred_state) zero state for the exported streaming step,
    batch 1, on `device` (the card unless the caller asks for the CPU): a
    (c fp32 [1, H], h [1, P] in `dtype`) pair a layer, as the model's
    `encoder_zero_state` and `prediction_zero_state` give."""
    device = resolve_device(device)

    def zeros(layers, H):
        return [(torch.zeros((1, H), dtype=torch.float32, device=device),
                 torch.zeros((1, cfg.projection_size), dtype=dtype,
                             device=device)) for _ in range(layers)]

    return (zeros(cfg.encoder_layers, cfg.encoder_size),
            zeros(cfg.pred_net_layers, cfg.pred_net_size))


def start_carry(model: Transducer, pred_state):
    """The decode carry after the start token (the greedy contract):
    (pred_out, pred_state)."""
    dev = pred_state[0][0].device
    with torch.no_grad():
        return model.predict_step(torch.zeros((1,), dtype=torch.long,
                                              device=dev), pred_state)


def _streaming_fn(max_tokens_per_chunk: int):
    def step(model, mel_chunk, enc_state, carry):
        encoded, new_enc_state = model.encode(mel_chunk[None],
                                              state=enc_state)
        enc_len = torch.full((1,), encoded.shape[1], dtype=torch.int32,
                             device=encoded.device)
        tokens, lengths, new_carry = greedy_decode_encoded_graph(
            model, encoded, enc_len, max_output_length=max_tokens_per_chunk,
            carry=carry)
        return tokens[0], lengths[0], new_enc_state, new_carry

    return step


def _transcribe_fn(max_output_length: int):
    def transcribe(model, mel, spec_lengths):
        encoded, _ = model.encode(mel)
        tokens, lengths, _ = greedy_decode_encoded_graph(
            model, encoded, model.encoded_length(spec_lengths),
            max_output_length=max_output_length)
        return tokens, lengths

    return transcribe


def _export(model, fn, freeze_params, args):
    if freeze_params:
        module = _Bound(model, fn)
    else:
        module = _Unbound(model, fn)
        args = ({n: p.detach() for n, p in model.named_parameters()},) + args
    with torch.no_grad():
        return torch.export.export(module, args)


def export_streaming_step(model: Transducer, cfg: RNNTConfig, *,
                          chunk_frames: int = 4,
                          max_tokens_per_chunk: int = 64, device="cuda",
                          freeze_params: bool = True
                          ) -> Tuple[torch.export.ExportedProgram, dict]:
    """Export the streaming decode step; returns (program, meta)."""
    require_lstm_encoder(model.cfg, "export")
    device = resolve_device(device)
    model = _fp32_model(model, device)
    enc_state, pred_state = streaming_init_state(cfg, device=device)
    carry = start_carry(model, pred_state)
    mel = torch.zeros((chunk_frames, cfg.input_feat_size), device=device)
    program = _export(model, _streaming_fn(max_tokens_per_chunk),
                      freeze_params, (mel, enc_state, carry))
    meta = {
        "kind": "streaming_step",
        "chunk_frames": chunk_frames,
        "max_tokens_per_chunk": max_tokens_per_chunk,
        "device": device.type,
        "frozen_params": freeze_params,
        "input_feat_size": cfg.input_feat_size,
        "calling_convention": (
            "(mel [Tc,F], enc_state, carry) -> (tokens, n, enc_state, carry)"
            if freeze_params else
            "(params, mel [Tc,F], enc_state, carry) -> "
            "(tokens, n, enc_state, carry)"),
    }
    return program, meta


def export_transcribe(model: Transducer, cfg: RNNTConfig, *, batch: int = 1,
                      frames: int = 512, max_output_length: int = 200,
                      device="cuda", freeze_params: bool = True
                      ) -> Tuple[torch.export.ExportedProgram, dict]:
    """Export whole-utterance batched greedy decoding; returns (program,
    meta)."""
    require_lstm_encoder(model.cfg, "export")
    device = resolve_device(device)
    model = _fp32_model(model, device)
    mel = torch.zeros((batch, frames, cfg.input_feat_size), device=device)
    lens = torch.full((batch,), frames, dtype=torch.int32, device=device)
    program = _export(model, _transcribe_fn(max_output_length),
                      freeze_params, (mel, lens))
    meta = {
        "kind": "transcribe",
        "batch": batch,
        "frames": frames,
        "max_output_length": max_output_length,
        "device": device.type,
        "frozen_params": freeze_params,
        "input_feat_size": cfg.input_feat_size,
        "calling_convention": (
            "(mel [B,T,F], spec_lengths [B]) -> (tokens, lengths)"
            if freeze_params else
            "(params, mel [B,T,F], spec_lengths [B]) -> (tokens, lengths)"),
    }
    return program, meta


def save_artifact(out_dir: str, name: str,
                  program: torch.export.ExportedProgram, meta: dict) -> str:
    """Write <name>.pt2 and its <name>.json sidecar; returns the .pt2
    path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.pt2")
    torch.export.save(program, path)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return path


def load_artifact(path: str) -> torch.export.ExportedProgram:
    """Load an exported artifact (call it via `.module()(*args)`).  K2's
    operator is registered by this module's import of `ops.library`."""
    return torch.export.load(path)

