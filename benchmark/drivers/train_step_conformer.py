"""The program's training step of the Conformer-Transducer on seeded
batches, on one card.

As `train_step.py`: set-up builds one train state from the benchmark's
weights (`benchlib.conformer_weights`; `rnnt_tpu_torch.models.transducer.
Transducer` with its Conformer encoder, loaded and made trainable, with
Adam's zero state), the step (`rnnt_tpu_torch.train.steps.make_train_step`
with the traffic's loss) and `distinct_batches` batches made on the device
(`benchlib.traffic.train_batches`: F = 80 x 1 features, full lengths).
Set-up drives that state through its first `reference_steps` steps on the
first batches, each through the window's own call; they warm every kernel
and are the steps the reference follows: each step's loss, each leaf's
first gradient (Adam's mu after step 1 over 1 - 0.9), each leaf's change
after the last.  The last set-up step is timed, and the window runs the
number of steps that fill `--seconds` at that pace, cycling through the
batches, ended by a synchronise.  A traced run then profiles
`profile_steps` more steps and reads them with the program's spans
(`benchlib.spans.digest`: each device record's span in `device_span`).

Correctness (after the program's state is freed): the plain fp32
reference's Adam steps (`reference.conformer_transducer`) from the same
weights on the same batches.  The notes carry the program's counters: the
attention's path, the prediction LSTM's K4/K5 designs and the loss
backward's.
"""

from __future__ import annotations

import gc
import time

import torch

from benchlib import device as devmod
from benchlib import traffic as trafmod
from benchlib.conformer_weights import make_weights
from benchlib.profile import record
from benchlib.result import Run
from benchlib.spans import digest
from drivers.train_step import build_state, dtype_of
from reference import conformer_transducer as ref
from reference import transducer as lstm_ref

ADAM_B1 = 0.9


def counters() -> dict:
    from rnnt_tpu_torch.models import conformer
    from rnnt_tpu_torch.ops import joint_loss_fused, lstm_cuda

    return {"attention_launches_by_path":
            dict(conformer.attention_launches_by_path),
            "k4_launches_by_design":
            dict(lstm_cuda.lstm_fwd.launches_by_design),
            "k5_launches_by_design":
            dict(lstm_cuda.lstm_bwd.launches_by_design),
            "loss_backward_launches_by_design":
            dict(joint_loss_fused.backward_launches_by_design)}


def profiled(steps, attempts: int = 2):
    """`benchlib.spans.digest` of a recorded slice of steps(), again while
    it lacks its markers."""
    for _ in range(attempts):
        out = digest(record(steps))
        if out is not None:
            return out
    return None


def _train(dev, cell, seed, seconds, trace):
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.train.state import trainable_names
    from rnnt_tpu_torch.train.steps import make_train_step

    m, tr = cell.model_fields(), cell.traffic
    cfg = RNNTConfig(**m)
    B, T, U = tr["batch"], tr["frames"], tr["labels"]
    weights = make_weights(m, seed, dev, dtype_of(m))
    state = build_state(cfg, weights, dev)
    del weights
    names = trainable_names(state.model)
    params = dict(state.model.named_parameters())
    p0 = {k: params[k].detach().clone() for k in names}
    batches = trafmod.train_batches(m, tr["distinct_batches"], B, T, U, seed,
                                    dev, dtype_of(m))
    step = make_train_step(cfg, loss_impl=tr["loss_impl"])
    gen = torch.Generator(device=dev).manual_seed(
        trafmod.derived_seed(seed, 5))
    losses, first, est = [], None, None
    for s in range(tr["reference_steps"]):
        if s == tr["reference_steps"] - 1:
            devmod.sync(dev)
            ta = time.perf_counter()
        out = step(state, batches[s], gen)
        losses.append(float(out["loss"]))
        if s == tr["reference_steps"] - 1:
            est = time.perf_counter() - ta
        if first is None:
            first = {k: float(state.opt_state["mu"][k].norm()) / (1 - ADAM_B1)
                     for k in names}
    change = {k: float((params[k].detach().float() - p0[k].float()).norm())
              for k in names}
    del p0
    n_steps = max(2, round(seconds / est))
    devmod.sync(dev)
    rec = {"setup_end": time.perf_counter()}
    t_start = time.perf_counter()
    for k in range(n_steps):
        out = step(state, batches[(tr["reference_steps"] + k) % len(batches)],
                   gen)
    devmod.sync(dev)
    rec["window_s"] = time.perf_counter() - t_start
    rec["last_loss"] = float(out["loss"])
    rec["peak"] = devmod.peak_bytes(dev)
    if trace and dev.type == "cuda":
        i0 = tr["reference_steps"] + n_steps

        def steps():
            for k in range(tr["profile_steps"]):
                step(state, batches[(i0 + k) % len(batches)], gen)

        rec["profile"] = profiled(steps)
    rec.update(steps=n_steps, losses=losses, grad_norms=first, change=change,
               step_est_s=est, counters=counters())
    del state, step, batches, params, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda") -> Run:
    """One run of the Conformer training cell on one card.  A program
    whose configuration has no Conformer fails here, before any build."""
    from rnnt_tpu_torch.config import RNNTConfig

    tr, m = cell.traffic, cell.model_fields()
    if int(tr.get("ranks", 1)) != 1:
        raise SystemExit("the Conformer driver runs on one card")
    RNNTConfig(**m)
    dev = torch.device(device)
    if dev.type == "cuda":
        from rnnt_tpu_torch.kernels import build

        build.build_all()
        dev = torch.device("cuda", torch.cuda.current_device())
    rec = _train(dev, cell, seed, seconds, trace)
    setup_s = rec["setup_end"] - t0

    # the reference, in this process, after the program's state is freed
    lstm_ref.exact_matmuls()
    w = make_weights(m, seed, dev, dtype_of(m))
    batches = trafmod.train_batches(m, tr["reference_steps"], tr["batch"],
                                    tr["frames"], tr["labels"], seed, dev,
                                    dtype_of(m))
    want = ref.train_reference(w, batches, m, steps=tr["reference_steps"])
    del w, batches
    grad_gap, grad_leaf = ref.worst_leaf_gap(rec["grad_norms"],
                                             want["grad_norms"])
    moved = ref.moved_leaves(want["grad_norms"])
    change_gap, change_leaf = ref.worst_leaf_gap(rec["change"],
                                                 want["change_norms"], moved)
    readings = {"loss_gap": ref.loss_gap(rec["losses"], want["losses"]),
                "grad_gap": grad_gap, "change_gap": change_gap,
                **ref.own_norm_gaps(rec["grad_norms"], rec["change"], want,
                                    moved)}
    checks = {k: [v, cell.limits[k]] for k, v in readings.items()
              if k in cell.limits}
    checks["window_loss_finite"] = [
        0.0 if abs(rec["last_loss"]) < float("inf") else 1.0, 0.0]
    return Run(m=m, traffic=tr, device=devmod.describe(dev, 1, rec["peak"]),
               setup_s=setup_s, attempted=rec["steps"], failed=0,
               checks=checks, window_s=rec["window_s"], steps=rec["steps"],
               audio_s=rec["steps"] * trafmod.audio_seconds(
                   m, tr["batch"], tr["frames"]),
               ranks=1, batch=(tr["batch"], tr["frames"], tr["labels"]),
               profile=rec.get("profile"),
               notes={"readings": readings,
                      "program_losses": rec["losses"],
                      "reference_losses": want["losses"],
                      "grad_leaf": grad_leaf, "change_leaf": change_leaf,
                      "left_out_leaves": sorted(set(want["grad_norms"])
                                                - moved),
                      "step_estimate_s": rec["step_est_s"],
                      "counters": rec["counters"]})

