"""Train and eval steps: the port of `rnnt_tpu.train.steps`.

The loss of a batch is sum(nll * loss_weight) / max(sum(loss_weight), 1)
when the batch carries `loss_weight` (repeat-padded filler rows weigh 0),
else the mean nll.  "fused" runs the fused joint + loss (kernels K6 and K7,
with the encoder and prediction LSTMs in K4 and K5 when training); "ref"
and "pallas" materialise the [B, T', U+1, V] logits and run the loss with
the plain lattice or kernel K7.  The train step threads the BatchNorm
running statistics back into the parameters after the update.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.models.encoder import encoded_length
from rnnt_tpu_torch.train import state as state_mod

LOSS_IMPLS = ("fused", "auto", "ref", "pallas")


def batch_loss(model, cfg: RNNTConfig, batch: Dict[str, torch.Tensor], *,
               training: bool, generator: Optional[torch.Generator] = None,
               loss_impl: str = "fused"):
    """Forward and RNN-T loss of one batch (tensors on the model's device:
    mel_specs [B, T, F], pred_inp [B, U+1], labels [B, U], spec_lengths and
    label_lengths [B], optionally loss_weight [B]).  Returns
    (loss, (per-example nll, BatchNorm (mean, var)))."""
    if loss_impl not in LOSS_IMPLS:
        raise NotImplementedError(
            f"loss_impl={loss_impl!r} is not yet ported (the PyTorch port "
            f"has {', '.join(LOSS_IMPLS)})")
    if training and (cfg.specaug_freq_masks > 0 or cfg.specaug_time_masks > 0):
        raise NotImplementedError(
            "SpecAugment is not yet ported to the PyTorch port; set "
            "specaug_freq_masks=0 and specaug_time_masks=0")
    if model.int8_names():
        raise ValueError(
            "int8 weights (int8 execution) cannot feed the RNN-T loss: the "
            f"loss paths read fp joint weights ({', '.join(model.int8_names())}"
            " are int8); score int8 execution by its decoded WER")
    enc_lengths = encoded_length(cfg, batch["spec_lengths"])
    mel = batch["mel_specs"]
    if training and cfg.input_noise_stddev > 0 and generator is not None:
        mel = mel + cfg.input_noise_stddev * torch.randn(
            mel.shape, generator=generator, device=mel.device, dtype=mel.dtype)
    if loss_impl == "fused":
        from rnnt_tpu_torch.ops.joint_loss_fused import transducer_loss_fused

        encoded, pred_out, bn_stats = model.encode_predict(
            mel, batch["pred_inp"], training=training, generator=generator)
        nll = transducer_loss_fused(model.joint, encoded, pred_out,
                                    batch["labels"], enc_lengths,
                                    batch["label_lengths"])
    else:
        from rnnt_tpu_torch.ops.rnnt_loss import rnnt_loss

        logits, bn_stats = model.apply(mel, batch["pred_inp"],
                                       training=training, generator=generator)
        nll = rnnt_loss(logits, batch["labels"], enc_lengths,
                        batch["label_lengths"], impl=loss_impl)
    if "loss_weight" in batch:
        w = batch["loss_weight"].to(nll.dtype)
        loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss, (nll, bn_stats)


SUBTREES = ("encoder", "prediction", "joint")


def make_train_step(cfg: RNNTConfig, *, loss_impl: str = "fused"):
    """Returns step(state, batch, generator) -> metrics: one update of
    state.model and state.opt_state in place, state.step + 1.  Metrics are
    0-d device tensors (loss, grad_norm and the three subtree norms) and the
    learning rate of the step (the schedule at the pre-update step)."""
    opt = state_mod.Optimizer(cfg)

    def step(state: state_mod.TrainState, batch, generator=None):
        model = state.model
        names = state_mod.trainable_names(model)
        params = dict(model.named_parameters())
        for n in names:
            params[n].grad = None
        loss, (_, (mean, var)) = batch_loss(
            model, cfg, batch, training=True, generator=generator,
            loss_impl=loss_impl)
        loss.backward()
        grads = {n: (params[n].grad if params[n].grad is not None
                     else torch.zeros_like(params[n])) for n in names}
        metrics = {"loss": loss.detach(),
                   "grad_norm": state_mod.global_norm(grads.values())}
        for sub in SUBTREES:
            metrics[f"grad_norm_{sub}"] = state_mod.global_norm(
                g for n, g in grads.items() if n.startswith(sub + "."))
        metrics["lr"] = opt.schedule(state.step)
        opt.apply_(model, grads, state.opt_state)
        with torch.no_grad():
            model.encoder.bn.mean.copy_(mean)
            model.encoder.bn.var.copy_(var)
        for n in names:
            params[n].grad = None
        state.step += 1
        return metrics

    return step


def make_eval_step(cfg: RNNTConfig, *, loss_impl: str = "fused"):
    """Returns step(model, batch) -> {"loss", "nll"} (no gradients; the
    LSTMs run the inference kernel)."""

    def step(model, batch):
        with torch.no_grad():
            loss, (nll, _) = batch_loss(model, cfg, batch, training=False,
                                        loss_impl=loss_impl)
        return {"loss": loss, "nll": nll}

    return step
