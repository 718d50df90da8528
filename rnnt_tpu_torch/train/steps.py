"""Train and eval steps: the port of `rnnt_tpu.train.steps`.

The loss of a batch is sum(nll * loss_weight) / max(sum(loss_weight), 1)
when the batch carries `loss_weight` (repeat-padded filler rows weigh 0),
else the mean nll.  "fused" runs the fused joint + loss (kernels K6 and K7,
with the encoder and prediction LSTMs in K4 and K5 when training);
"banded" the banded loss (`ops.joint_loss_banded`: K6 over a label window of
cfg.loss_band around the alignment diagonal, K7 over the full lattice), an
upper bound on the exact NLL that equals it when the band covers U+1; "ref"
and "pallas" materialise the [B, T', U+1, V] logits and run the loss with
the plain lattice or kernel K7.  A training batch given a generator gets
the configured input noise, then SpecAugment (`ops.specaug`), on its own
device, before any loss path.  The train step threads every BatchNorm's
running statistics back into the parameters of their names after the
update.

Across the ranks of a `parallel.mesh.Mesh` the loss is the one weighted
mean over the global batch: each rank backpropagates its local numerator
over the denominator all-reduced over the data group, the gradients (with
the loss) are summed over the data group in one bucket, and the BatchNorm
statistics are the global batch's (`models.lstm.BatchNorm.forward_train`).
On a model axis above 1 (vocab tensor parallelism) the ranks of a data row
hold the same rows and W2, b2 and their optimizer leaves are sharded: the
loss runs on the shards (`ops.joint_loss_fused`, `ops.joint_loss_banded`),
every replicated gradient is the same on the row's ranks, and the norms
add the sharded gradients' squares over the model group.  So the norms,
the clipping and the update read the same reduced gradients on every
rank, and every rank takes the identical step on what it holds.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.models.encoder import encoded_length
from rnnt_tpu_torch.parallel import mesh as mesh_mod
from rnnt_tpu_torch.trace import span, spanned
from rnnt_tpu_torch.train import state as state_mod

LOSS_IMPLS = ("fused", "banded", "auto", "ref", "pallas")


def batch_loss(model, cfg: RNNTConfig, batch: Dict[str, torch.Tensor], *,
               training: bool, generator: Optional[torch.Generator] = None,
               loss_impl: str = "fused", mesh=None, tp=None):
    """Forward and RNN-T loss of one batch (tensors on the model's device:
    mel_specs [B, T, F], pred_inp [B, U+1], labels [B, U], spec_lengths and
    label_lengths [B], optionally loss_weight [B]).  Returns
    (loss, (per-example nll, BatchNorm statistics by parameter name)).
    With a `mesh` that reduces, the batch is this rank's rows of the
    global batch and `loss` is this rank's share of the global loss: its
    numerator over the global denominator (the shares sum to the global
    loss).  `tp`: the
    model's W2 and b2 are this vocabulary shard's (fused and banded only;
    the data group is reduced only with `mesh`)."""
    if loss_impl not in LOSS_IMPLS:
        raise NotImplementedError(
            f"loss_impl={loss_impl!r} is not yet ported (the PyTorch port "
            f"has {', '.join(LOSS_IMPLS)})")
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
    if training and generator is not None and (
            cfg.specaug_freq_masks > 0 or cfg.specaug_time_masks > 0):
        from rnnt_tpu_torch.ops.specaug import spec_augment

        mel = spec_augment(
            generator, mel, batch["spec_lengths"], mel_bins=cfg.mel_bins,
            freq_masks=cfg.specaug_freq_masks,
            freq_width=cfg.specaug_freq_width,
            time_masks=cfg.specaug_time_masks,
            time_width=cfg.specaug_time_width)
    if loss_impl in ("fused", "banded"):
        encoded, pred_out, bn_stats = model.encode_predict(
            mel, batch["pred_inp"], training=training, generator=generator,
            mesh=mesh, lengths=batch["spec_lengths"])
        args = (model.joint, encoded, pred_out, batch["labels"], enc_lengths,
                batch["label_lengths"])
        if loss_impl == "banded":
            from rnnt_tpu_torch.ops.joint_loss_banded import \
                transducer_loss_banded

            nll = transducer_loss_banded(*args, band=cfg.loss_band, tp=tp)
        else:
            from rnnt_tpu_torch.ops.joint_loss_fused import \
                transducer_loss_fused

            nll = transducer_loss_fused(*args, tp=tp)
    elif tp is not None:
        raise ValueError(f"loss_impl={loss_impl!r} materialises the logits of "
                         "the full vocabulary: with W2 vocab-sharded use "
                         "'fused' or 'banded'")
    else:
        from rnnt_tpu_torch.ops.rnnt_loss import rnnt_loss

        logits, bn_stats = model.apply(mel, batch["pred_inp"],
                                       training=training, generator=generator,
                                       mesh=mesh,
                                       lengths=batch["spec_lengths"])
        nll = rnnt_loss(logits, batch["labels"], enc_lengths,
                        batch["label_lengths"], impl=loss_impl)
    if mesh is not None and mesh.reduces:
        if "loss_weight" in batch:
            w = batch["loss_weight"].to(nll.dtype)
            num, den = (nll * w).sum(), w.sum().detach().reshape(1)
        else:
            num = nll.sum()
            den = torch.full((1,), float(nll.shape[0]), device=nll.device)
        den = den.float()
        mesh_mod.all_reduce_sum_([den], mesh)
        loss = num / torch.clamp(den[0], min=1.0).to(num.dtype)
    elif "loss_weight" in batch:
        w = batch["loss_weight"].to(nll.dtype)
        loss = (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss, (nll, bn_stats)


SUBTREES = ("encoder", "prediction", "joint")


def make_train_step(cfg: RNNTConfig, *, loss_impl: str = "fused",
                    mesh=None):
    """Returns step(state, batch, generator) -> metrics: one update of
    state.model and state.opt_state in place, state.step + 1.  Metrics are
    0-d device tensors (loss, grad_norm and the three subtree norms) and the
    learning rate of the step (the schedule at the pre-update step).  With
    a `mesh` the batch is this rank's rows, the loss and the gradients are
    the global batch's, and where the mesh shards the vocabulary
    (`Mesh.vocab_shard`) state.model holds this rank's W2 and b2 columns
    (`parallel.mesh.shard_state_`)."""
    tp = mesh.vocab_shard(cfg.vocab_size) if mesh is not None else None
    opt = state_mod.Optimizer(cfg, tp)

    @spanned("rnnt.train.step")
    def step(state: state_mod.TrainState, batch, generator=None):
        model = state.model
        names = state_mod.trainable_names(model)
        params = dict(model.named_parameters())
        for n in names:
            params[n].grad = None
        with span("rnnt.train.forward"):
            loss, (_, bn_stats) = batch_loss(
                model, cfg, batch, training=True, generator=generator,
                loss_impl=loss_impl, mesh=mesh, tp=tp)
        with span("rnnt.train.backward"):
            loss.backward()
        grads = {n: (params[n].grad if params[n].grad is not None
                     else torch.zeros_like(params[n])) for n in names}
        loss = loss.detach()
        if mesh is not None and mesh.reduces:
            loss = loss.float().reshape(1)
            mesh_mod.all_reduce_sum_([*grads.values(), loss], mesh)
            loss = loss[0]
        with span("rnnt.train.norms"):
            metrics = {"loss": loss,
                       "grad_norm": state_mod.global_norm(grads, tp)}
            for sub in SUBTREES:
                metrics[f"grad_norm_{sub}"] = state_mod.global_norm(
                    {n: g for n, g in grads.items()
                     if n.startswith(sub + ".")}, tp)
        metrics["lr"] = opt.schedule(state.step)
        with span("rnnt.train.update"):
            opt.apply_(model, grads, state.opt_state)
            with torch.no_grad():
                for n, v in bn_stats.items():
                    params[n].copy_(v)
            for n in names:
                params[n].grad = None
        state.step += 1
        return metrics

    return step


def make_eval_step(cfg: RNNTConfig, *, loss_impl: str = "fused",
                   mesh=None):
    """Returns step(model, batch) -> {"loss", "nll"} (no gradients; the
    LSTMs run the inference kernel).  Each rank scores its own batch: a
    `mesh` that shards the vocabulary only runs the loss on the shards,
    over the model group (whose ranks read the same batches)."""
    tp = mesh.vocab_shard(cfg.vocab_size) if mesh is not None else None

    def step(model, batch):
        with torch.no_grad():
            loss, (nll, _) = batch_loss(model, cfg, batch, training=False,
                                        loss_impl=loss_impl, tp=tp)
        return {"loss": loss, "nll": nll}

    return step
