"""The program's training step on seeded batches, on one card or across
`ranks` cards (one process a card over NCCL, ranks 1.. spawned by this
process; rank 0 prints).

Set-up builds one train state from the benchmark's weights
(`rnnt_tpu_torch.models.transducer.Transducer`, loaded and made trainable,
with the optimizer's zero state), the step
(`rnnt_tpu_torch.train.steps.make_train_step`, the traffic's loss, with a
data-parallel mesh across ranks) and `distinct_batches` batches made on the
device; each rank takes its rows of every global batch.  Set-up drives that
same state through its first `reference_steps` steps on the first batches,
each through the window's own call: they warm every kernel, and they are
the steps the reference follows (each step's loss, each leaf's first
gradient as the optimizer holds it after step 1, each leaf's change after
the last).  The last set-up step is timed, and the window runs the number
of steps that fill `--seconds` at that pace (the same on every rank),
cycling through the batches, ended by a synchronise.  A traced run then
profiles `profile_steps` more steps.

Correctness (rank 0, after every rank has stopped and the program's state
is freed): the plain reference's steps from the same weights on the same
global batches, in one process.
"""

from __future__ import annotations

import dataclasses
import gc
import queue as queue_mod
import time
import traceback

import torch

from benchlib import device as devmod
from benchlib import traffic as trafmod
from benchlib.profile import profile_slice
from benchlib.result import Run
from benchlib.weights import make_weights
from reference import transducer as ref

RANK_TIMEOUT_S = 600.0


def dtype_of(m: dict):
    return torch.bfloat16 if m["compute_dtype"] == "bfloat16" else torch.float32


def build_state(cfg, weights, dev):
    from rnnt_tpu_torch.models.transducer import Transducer
    from rnnt_tpu_torch.train.state import Optimizer, TrainState

    with torch.device(dev):
        model = Transducer(cfg)
    model.cast_(dtype_of(dataclasses.asdict(cfg)))
    model.load_state_dict(weights)
    model.make_trainable_()
    return TrainState(step=0, model=model, opt_state=Optimizer(cfg).init(model))


def _train(rank, n, dev, cell, seed, seconds, trace, patch):
    """Every rank: set-up, window, traced slice.  Returns this rank's
    record (rank 0's holds the program's readings)."""
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.parallel import mesh as mesh_mod
    from rnnt_tpu_torch.train.state import trainable_names
    from rnnt_tpu_torch.train.steps import make_train_step

    if patch is not None:
        patch()
    m, tr = cell.model_fields(), cell.traffic
    cfg = RNNTConfig(**m)
    B_all, T, U = tr["batch"], tr["frames"], tr["labels"]
    B = B_all // n
    mesh = mesh_mod.make_mesh(device=dev) if n > 1 else None
    weights = make_weights(m, seed, dev, dtype_of(m))
    state = build_state(cfg, weights, dev)
    del weights
    if mesh is not None:
        mesh_mod.broadcast_module_(state.model, mesh)
    names = trainable_names(state.model)
    params = dict(state.model.named_parameters())
    p0 = {k: params[k].detach().clone() for k in names}
    batches = [{k: v.clone() for k, v in trafmod.rows(
        b, rank * B, (rank + 1) * B).items()} for b in trafmod.train_batches(
        m, tr["distinct_batches"], B_all, T, U, seed, dev, dtype_of(m))]
    step = make_train_step(cfg, loss_impl=tr["loss_impl"], mesh=mesh)
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
            first = {k: float(state.opt_state["trace"][k].float().norm())
                     for k in names}
    change = {k: float((params[k].detach().float() - p0[k].float()).norm())
              for k in names}
    del p0
    n_steps = max(2, round(seconds / est))
    if mesh is not None:
        t = torch.tensor([float(n_steps)], device=dev)
        torch.distributed.broadcast(t, src=0)
        n_steps = int(t.item())
        mesh_mod.barrier(mesh)
    devmod.sync(dev)
    rec = {"rank": rank, "setup_end": time.perf_counter()}
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

        rec["profile"] = profile_slice(steps)
    if mesh is not None:
        mesh_mod.barrier(mesh)
    rec.update(steps=n_steps, losses=losses, grad_norms=first, change=change,
               step_est_s=est)
    del state, step, batches, params, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _rank_entry(rank, n, port, cell, seed, seconds, trace, device, q,
                patch):
    """Ranks 1..n-1, each a spawned process."""
    import torch.distributed as dist

    from rnnt_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(4)
    try:
        dev = mesh_mod.init_distributed(f"localhost:{port}", n, rank, device,
                                        timeout_s=RANK_TIMEOUT_S)
        try:
            rec = _train(rank, n, dev, cell, seed, seconds, trace, patch)
        finally:
            dist.destroy_process_group()
        q.put({"rank": rank, "peak": rec["peak"],
               "busy_s": (rec.get("profile") or {}).get("busy_s")})
    except Exception:  # noqa: BLE001 — reported to rank 0, then re-raised
        q.put({"rank": rank, "error": traceback.format_exc()})
        raise


def _spawn(cell, seed, seconds, trace, device, n, patch):
    """Rank 0 here, ranks 1.. spawned; returns (rank 0's record, the
    others' records)."""
    import multiprocessing as mp

    import torch.distributed as dist

    from rnnt_tpu_torch.parallel import mesh as mesh_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = mesh_mod.free_port()
    procs = [ctx.Process(target=_rank_entry, args=(
        r, n, port, cell, seed, seconds, trace, device, q, patch))
        for r in range(1, n)]
    for p in procs:
        p.start()
    others = []
    try:
        dev = mesh_mod.init_distributed(f"localhost:{port}", n, 0, device,
                                        timeout_s=RANK_TIMEOUT_S)
        try:
            rec = _train(0, n, dev, cell, seed, seconds, trace, patch)
        finally:
            dist.destroy_process_group()
        for _ in procs:
            others.append(q.get(timeout=RANK_TIMEOUT_S))
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S)
    except queue_mod.Empty:
        raise RuntimeError("a rank sent no record") from None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [o["error"] for o in others if "error" in o]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return dev, rec, others


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", patch=None) -> Run:
    """One run of a training cell.  `patch()` runs first in every rank
    (tests)."""
    tr, m = cell.traffic, cell.model_fields()
    n = int(tr.get("ranks", 1))
    if torch.device(device).type == "cuda":
        from rnnt_tpu_torch.kernels import build

        build.build_all()
    if n == 1:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        rec, others = _train(0, 1, dev, cell, seed, seconds, trace, patch), []
    else:
        dev, rec, others = _spawn(cell, seed, seconds, trace, device, n,
                                  patch)
    setup_s = rec["setup_end"] - t0
    peak = max([rec["peak"]] + [o["peak"] for o in others])
    prof = rec.get("profile")
    if prof is not None and others:
        busy = [prof["busy_s"]] + [o["busy_s"] for o in others]
        prof["busy_s_mean"] = (sum(busy) / len(busy)
                               if None not in busy else None)

    # the reference, in this process alone
    ref.exact_matmuls()
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
    # a reading is compared where the cell file gives it a limit (PERF.md
    # says why loss_gap has none); the others are reported in the notes
    checks = {k: [v, cell.limits[k]] for k, v in readings.items()
              if k in cell.limits}
    checks["window_loss_finite"] = [
        0.0 if abs(rec["last_loss"]) < float("inf") else 1.0, 0.0]
    return Run(m=m, traffic=tr, device=devmod.describe(dev, n, peak),
               setup_s=setup_s, attempted=rec["steps"], failed=0,
               checks=checks, window_s=rec["window_s"], steps=rec["steps"],
               audio_s=rec["steps"] * trafmod.audio_seconds(
                   m, tr["batch"], tr["frames"]),
               ranks=n, batch=(tr["batch"] // n, tr["frames"], tr["labels"]),
               profile=prof,
               notes={"readings": readings,
                      "program_losses": rec["losses"],
                      "reference_losses": want["losses"],
                      "grad_leaf": grad_leaf, "change_leaf": change_leaf,
                      "left_out_leaves": sorted(set(want["grad_norms"])
                                                - moved),
                      "step_estimate_s": rec["step_est_s"]})
