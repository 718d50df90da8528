"""Batched greedy transducer decoding.

The port of `rnnt_tpu.decode.greedy`: the whole batch decodes at once with
per-element done masks, the prediction-net state is carried (one pred-net
step per emission), blank (id 0) ends a frame's emissions, and
`max_symbols_per_frame` bounds the emissions per frame.  The JAX version is a
`lax.while_loop`; here the symbol loop is a Python loop, which reads back
whether any element is still active once per iteration.

Invariant across frames: (pred_out, pred_state) is the prediction net's
output and state after the start token plus every token emitted so far.
"""

from __future__ import annotations

from typing import Optional

import torch

from rnnt_tpu_torch.models.transducer import Transducer


def greedy_decode_encoded(model: Transducer, encoded: torch.Tensor,
                          enc_lengths: torch.Tensor, *,
                          max_output_length: int = 200, carry=None):
    """Greedy decode from encoder output [B, T', P] and lengths [B].
    Returns (tokens [B, max_output_length] int32, lengths [B] int32, carry);
    pass the carry (pred_out, pred_state) back in to continue across
    streaming chunks."""
    B, T, _ = encoded.shape
    dev = encoded.device
    max_sym = model.cfg.max_symbols_per_frame
    if carry is None:
        state0 = model.prediction_zero_state(B, encoded.dtype)
        # consume the start token 0
        pred_out, pred_state = model.predict_step(
            torch.zeros((B,), dtype=torch.long, device=dev), state0)
    else:
        pred_out, pred_state = carry
    out_tokens = torch.zeros((B, max_output_length), dtype=torch.int32,
                             device=dev)
    out_lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
    batch_idx = torch.arange(B, device=dev)
    enc_lengths = enc_lengths.to(dev)
    # frames past every element's length emit nothing
    n_frames = min(T, int(enc_lengths.max())) if B else 0
    for t in range(n_frames):
        enc_t = encoded[:, t, :]
        active = t < enc_lengths
        n = 0
        while n < max_sym and bool(active.any()):
            logits = model.joint_step(enc_t, pred_out)
            pred_id = torch.argmax(logits, dim=-1)
            emit = active & (pred_id != 0) & (out_lengths < max_output_length)
            slot = torch.clamp(out_lengths, max=max_output_length - 1).long()
            cur = out_tokens[batch_idx, slot]
            out_tokens[batch_idx, slot] = torch.where(
                emit, pred_id.to(torch.int32), cur)
            out_lengths = out_lengths + emit.to(torch.int32)
            new_out, new_state = model.predict_step(pred_id, pred_state)
            pred_out = torch.where(emit[:, None], new_out, pred_out)
            pred_state = [
                tuple(torch.where(emit[:, None], nw, old)
                      for nw, old in zip(new_st, old_st))
                for new_st, old_st in zip(new_state, pred_state)]
            active = emit
            n += 1
    return out_tokens, out_lengths, (pred_out, pred_state)


def greedy_decode_encoded_graph(model: Transducer, encoded: torch.Tensor,
                                enc_lengths: torch.Tensor, *,
                                max_output_length: int = 200, carry=None):
    """`greedy_decode_encoded` with no host read, for `torch.export`: the
    same contract and the same tokens.  The frame and symbol loops are one
    `while_loop` whose state carries the frame t and the symbol count n; the
    frame advances when no element emitted or n reaches
    max_symbols_per_frame.  Frames past every element's length are not
    visited; a frame where no element is active takes one step that emits
    nothing (the eager loop takes none).  The body is functional: every
    carried tensor keeps its shape, dtype and device, the token write is an
    out-of-place scatter, and the prediction state travels as a flat tuple
    of (c, h) pairs."""
    from torch._higher_order_ops import while_loop

    B, T, _ = encoded.shape
    dev = encoded.device
    max_sym = model.cfg.max_symbols_per_frame
    if carry is None:
        state0 = model.prediction_zero_state(B, encoded.dtype)
        pred_out, pred_state = model.predict_step(
            torch.zeros((B,), dtype=torch.long, device=dev), state0)
    else:
        pred_out, pred_state = carry
    n_layers = len(pred_state)
    enc_lengths = enc_lengths.to(dev)
    t_end = torch.clamp(enc_lengths.max(), max=T).long()
    if max_sym < 1:
        t_end = torch.zeros_like(t_end)

    def cond(t, n, active, out_tokens, out_lengths, pred_out, *flat):
        return t < t_end

    def body(t, n, active, out_tokens, out_lengths, pred_out, *flat):
        active = torch.where(n == 0, t < enc_lengths, active)
        enc_t = encoded.index_select(1, t.reshape(1))[:, 0]
        logits = model.joint_step(enc_t, pred_out)
        pred_id = torch.argmax(logits, dim=-1)
        emit = active & (pred_id != 0) & (out_lengths < max_output_length)
        slot = torch.clamp(out_lengths, max=max_output_length - 1).long()[
            :, None]
        cur = out_tokens.gather(1, slot)
        out_tokens = out_tokens.scatter(1, slot, torch.where(
            emit[:, None], pred_id.to(torch.int32)[:, None], cur))
        out_lengths = out_lengths + emit.to(torch.int32)
        state = [(flat[2 * i], flat[2 * i + 1]) for i in range(n_layers)]
        new_out, new_state = model.predict_step(pred_id, state)
        pred_out = torch.where(emit[:, None], new_out, pred_out)
        flat = tuple(torch.where(emit[:, None], nw, old)
                     for new_st, old_st in zip(new_state, state)
                     for nw, old in zip(new_st, old_st))
        n = n + 1
        advance = ~emit.any() | (n >= max_sym)
        return (torch.where(advance, t + 1, t),
                torch.where(advance, 0, n), emit, out_tokens, out_lengths,
                pred_out, *flat)

    t0, n0 = (torch.zeros((), dtype=torch.long, device=dev) for _ in "tn")
    init = (t0, n0, torch.zeros((B,), dtype=torch.bool, device=dev),
            torch.zeros((B, max_output_length), dtype=torch.int32,
                        device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev), pred_out,
            *(x for st in pred_state for x in st))
    _, _, _, out_tokens, out_lengths, pred_out, *flat = while_loop(
        cond, body, init)
    pred_state = [(flat[2 * i], flat[2 * i + 1]) for i in range(n_layers)]
    return out_tokens, out_lengths, (pred_out, pred_state)


class JointRecorder:
    """While in use (`with JointRecorder(model) as rec:`), wraps the model's
    joint_step and records, at every call, row 0's argmax (`ids`) and the
    smallest top-2 logit margin over the rows (`margins`): shows whether an
    exact comparison of greedy tokens hinges on a near tie."""

    def __init__(self, model: Transducer):
        self.ids, self.margins = [], []
        self._model = model

    def __enter__(self):
        self._inner = self._model.joint_step
        self._model.joint_step = self._record
        return self

    def __exit__(self, *exc):
        del self._model.joint_step  # back to the class's method

    def _record(self, enc_t, pred_u):
        logits = self._inner(enc_t, pred_u)
        top2 = torch.topk(logits, 2, dim=-1)
        self.ids.append(int(top2.indices[0, 0]))
        self.margins.append(
            float((top2.values[:, 0] - top2.values[:, 1]).min()))
        return logits


def greedy_decode(model: Transducer, mel: torch.Tensor,
                  spec_lengths: Optional[torch.Tensor] = None, *,
                  max_output_length: int = 200):
    """Featurized audio [B, T, feat] -> (tokens, lengths)."""
    B, T, _ = mel.shape
    if spec_lengths is None:
        spec_lengths = torch.full((B,), T, dtype=torch.int32)
    encoded, _ = model.encode(mel, lengths=spec_lengths.to(mel.device))
    enc_lengths = model.encoded_length(spec_lengths.to(mel.device))
    tokens, lengths, _ = greedy_decode_encoded(
        model, encoded, enc_lengths, max_output_length=max_output_length)
    return tokens, lengths
