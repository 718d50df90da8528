"""Training and evaluation loops: the port of `rnnt_tpu.train.loop`, one
process a device.

`run_training` iterates epochs of bucketed batches, logs every
`steps_per_log` steps (the loss read there is the only host sync of a
step), evaluates and checkpoints every `steps_per_checkpoint` steps and at
the end, and on SIGTERM writes a checkpoint at the next step boundary and
returns.  `run_evaluate` reports the eval loss and, from the port's greedy
or beam decoder, token accuracy, WER and CER over the whole set.

With a `parallel.mesh.Mesh` every rank runs the loop on its data row's
rows (the caller keeps the epochs in lockstep), the steps reduce across
ranks (`train.steps`), periodic eval runs on every rank and sums the
statistics over the data group once, checkpoints are collective, and only
the mesh's first rank writes metrics and logs.  Each rank's generator
(input noise, SpecAugment, dropout) is seeded by (step, data row), so
rows draw independently and the ranks of a row (the model axis) alike.
Where the mesh shards the vocabulary, eval scores the loss on the shards
and decodes with W2 and b2 gathered once over the model group.
"""

from __future__ import annotations

import inspect
import signal
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.metrics import error_rate
from rnnt_tpu_torch.parallel import mesh as mesh_mod
from rnnt_tpu_torch.train import checkpoint as ckpt_mod
from rnnt_tpu_torch.train import observe
from rnnt_tpu_torch.train.state import TrainState
from rnnt_tpu_torch.train.steps import make_eval_step, make_train_step


def to_device(batch: Dict, device, mel_dtype=None) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device` (ids and lengths as int64; the
    mel features in `mel_dtype`, fp32 by default); `num_real` is dropped."""
    out = {}
    for k, v in batch.items():
        if k == "num_real":
            continue
        t = torch.from_numpy(np.asarray(v))
        if k == "mel_specs":
            t = t.to(mel_dtype or torch.float32)
        elif not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


def _decode(model, kind: str, mel, spec_lengths, max_out: int):
    if kind == "beam":
        from rnnt_tpu_torch.decode.beam import beam_search_decode

        tokens, lengths, _ = beam_search_decode(
            model, mel, spec_lengths, beam_width=model.cfg.beam_width,
            max_output_length=max_out)
        return tokens, lengths
    from rnnt_tpu_torch.decode.greedy import greedy_decode

    return greedy_decode(model, mel, spec_lengths, max_output_length=max_out)


def run_evaluate(cfg: RNNTConfig, model, eval_batches: Iterable[Dict], *,
                 tokenizer=None, eval_step=None, max_batches: int = 0,
                 decode: str = "greedy", loss_impl: str = "fused",
                 mel_dtype=None, loss_metrics: bool = True, mesh=None
                 ) -> Dict[str, float]:
    """Eval loss (mean nll over the real rows), eval_accuracy (1 - token
    error rate of the decoded tokens) and, with a tokenizer, eval_wer and
    eval_cer, over at most max_batches batches (0: all).  loss_metrics=False
    skips the loss (eval_loss nan), as int8 execution needs: its int8 joint
    weights cannot feed the loss paths.  With a `mesh` each rank evaluates
    its own batches and the sufficient statistics are summed across ranks
    (once; every rank must call this), so every rank returns the metrics
    of the whole set.  Where the mesh shards the vocabulary, the model
    holds this rank's W2 and b2 columns; the decoder reads them gathered
    (once a call)."""
    if loss_metrics:
        eval_step = eval_step or make_eval_step(cfg, loss_impl=loss_impl,
                                                mesh=mesh)
    dev = next(model.parameters()).device
    full = mesh_mod.gather_vocab(
        model, mesh.vocab_shard(cfg.vocab_size) if mesh is not None else None)
    losses, n = [], 0
    tok_err = n_utt = wer_sum = cer_sum = n_txt = 0.0
    for batch in eval_batches:
        n += 1
        num_real = int(batch.get("num_real", batch["labels"].shape[0]))
        tb = to_device(batch, dev, mel_dtype)
        if loss_metrics:
            m = eval_step(model, tb)
            losses.extend(m["nll"][:num_real].float().cpu().tolist())
        max_out = int(batch["labels"].shape[1] * 2 + 8)
        with torch.no_grad(), mesh_mod.full_vocab(model, full):
            tokens, lengths = _decode(model, decode, tb["mel_specs"],
                                      tb["spec_lengths"], max_out)
        tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        labels = np.asarray(batch["labels"])
        lab_lens = np.asarray(batch["label_lengths"])
        for i in range(num_real):
            ref_ids = labels[i, : lab_lens[i]].tolist()
            hyp_ids = tokens[i, : lengths[i]].tolist()
            tok_err += error_rate(ref_ids, hyp_ids)
            n_utt += 1
            if tokenizer is not None:
                r, h = tokenizer.decode(ref_ids), tokenizer.decode(hyp_ids)
                wer_sum += error_rate(r.split(), h.split())
                cer_sum += error_rate(list(r), list(h))
                n_txt += 1
        if max_batches and n >= max_batches:
            break
    # [loss_sum, loss_n, tok_rate_sum, n_utt, wer_sum, cer_sum, n_txt]
    stats = torch.tensor([float(np.sum(losses)), len(losses), tok_err, n_utt,
                          wer_sum, cer_sum, n_txt], dtype=torch.float64)
    if mesh is not None and mesh.reduces:
        stats = stats.to(dev)
        mesh_mod.all_reduce_sum_([stats], mesh)
    stats = stats.cpu().tolist()
    out = {"eval_loss": stats[0] / stats[1] if stats[1] else float("nan")}
    if stats[3]:
        out["eval_accuracy"] = 1.0 - stats[2] / stats[3]
        if stats[6]:
            out["eval_wer"] = stats[4] / stats[6]
            out["eval_cer"] = stats[5] / stats[6]
    return out


def run_training(cfg: RNNTConfig, state: TrainState,
                 train_batches_fn: Callable[..., Iterable[Dict]], *,
                 output_dir: str,
                 eval_batches_fn: Optional[Callable[[], Iterable[Dict]]] = None,
                 tokenizer=None, n_epochs: int = 1, steps_per_log: int = 10,
                 steps_per_checkpoint: int = 1000, eval_max_batches: int = 50,
                 loss_impl: str = "fused", mel_dtype=None,
                 ckpt_backend: str = "auto", mesh=None) -> TrainState:
    """The outer loop; returns the state after the last step (updated in
    place).  train_batches_fn(epoch) or train_batches_fn() gives an epoch's
    numpy batches (this rank's, in lockstep with the others, under a
    data-parallel `mesh`).  ckpt_backend: 'auto' (dcp across processes,
    else npz), 'npz' or 'dcp'."""
    backend = ckpt_mod.resolve_backend(ckpt_backend, mesh)
    train_step = make_train_step(cfg, loss_impl=loss_impl, mesh=mesh)
    eval_step = make_eval_step(cfg, loss_impl=loss_impl, mesh=mesh) \
        if eval_batches_fn else None
    dev = next(state.model.parameters()).device
    row = mesh.data_index if mesh is not None else 0
    # row 0 keeps the one-process seed; the other rows draw their own
    gen = torch.Generator(device=dev).manual_seed(state.step + 17
                                                  + (row << 40))
    lead = mesh is None or mesh.rank == 0
    writer = observe.MetricsWriter(output_dir, "tb") if lead else None
    if lead:
        writer.hparams(cfg)
    saver = ckpt_mod.AsyncSaver()
    last_saved = [-1]

    def checkpoint():
        if state.step == last_saved[0]:
            return
        last_saved[0] = state.step
        if eval_batches_fn is not None:
            t0 = time.time()
            metrics = run_evaluate(cfg, state.model, eval_batches_fn(),
                                   tokenizer=tokenizer, eval_step=eval_step,
                                   max_batches=eval_max_batches,
                                   mel_dtype=mel_dtype, mesh=mesh)
            metrics["eval_seconds"] = time.time() - t0
            if lead:
                writer.scalars(state.step, metrics)
                log(f"step {state.step}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in metrics.items()))
        saver.save(output_dir, state, cfg, backend=backend, mesh=mesh)

    takes_epoch = len(inspect.signature(train_batches_fn).parameters) >= 1
    # SIGTERM (preemption) asks for a checkpoint at the next step boundary
    preempted = threading.Event()

    def on_sigterm(signum, frame):
        preempted.set()
        log("SIGTERM: will checkpoint at the next step boundary and exit")

    try:  # only the main thread may install handlers
        prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:
        prev_handler = None
    t_last, steps_last = time.time(), state.step
    try:
        for epoch in range(n_epochs):
            batches = (train_batches_fn(epoch) if takes_epoch
                       else train_batches_fn())
            for batch in batches:
                m = train_step(state, to_device(batch, dev, mel_dtype), gen)
                if state.step % steps_per_log == 0 and lead:
                    loss = float(m["loss"])  # the step's host sync
                    now = time.time()
                    sec = (now - t_last) / max(state.step - steps_last, 1)
                    t_last, steps_last = now, state.step
                    writer.scalars(state.step, {
                        "train_loss": loss,
                        **{k: float(v) for k, v in m.items()
                           if k.startswith("grad_norm")},
                        "lr": float(m["lr"]), "step_seconds": sec})
                    log(f"epoch {epoch} step {state.step}: loss={loss:.4f} "
                        f"({sec:.3f}s/step)")
                if preempted.is_set():
                    if state.step != last_saved[0]:
                        path = saver.save(output_dir, state, cfg,
                                          backend=backend, mesh=mesh)
                        saver.wait()
                        if lead:
                            log(f"preemption checkpoint written: {path}")
                    else:
                        saver.wait()
                    return state
                if state.step % steps_per_checkpoint == 0:
                    checkpoint()
                    t_last, steps_last = time.time(), state.step
        checkpoint()
    finally:
        saver.wait()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        if writer is not None:
            writer.close()
    return state
