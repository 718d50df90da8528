"""One rank of the port's two-process data-parallel tests
(tests/test_torch_data_parallel.py), run as

  python tests/torch_dp_worker.py step|cli RANK WORLD PORT DIR

over gloo on the CPU.  `step` runs one train step of the fused and the
banded loss on this rank's rows of DIR/batch.npz from DIR/params.pt, plus
the input-gradient run and its no-grad BatchNorm control, and writes
DIR/step_rank{RANK}.pt.  `cli` drives rnnt_tpu_torch.cli.run_rnnt
--multihost (train, --checkpoint auto, eval, npz refused) on DIR/data and
writes DIR/cli_rank{RANK}.json.  `run_cases` is also the one-process
reference the test computes in its own process."""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rnnt_tpu_torch.config import RNNTConfig  # noqa: E402
from rnnt_tpu_torch.models.transducer import Transducer  # noqa: E402
from rnnt_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from rnnt_tpu_torch.train import state as state_mod  # noqa: E402
from rnnt_tpu_torch.train.steps import (  # noqa: E402
    batch_loss, make_train_step)

torch.set_num_threads(1)

IMPLS = ("fused", "banded")


def torch_batch(batch, rows=slice(None)):
    return {k: (torch.from_numpy(v[rows]).long() if v.dtype.kind == "i"
                else torch.from_numpy(np.ascontiguousarray(v[rows])))
            for k, v in batch.items()}


def fresh_state(cfg, sd):
    model = Transducer(cfg)
    model.load_state_dict(sd)
    model.make_trainable_()
    return state_mod.TrainState(step=0, model=model,
                                opt_state=state_mod.Optimizer(cfg).init(model))


def one_step(cfg, sd, batch, impl, mesh):
    """One train step: its metrics, the (reduced) gradients the optimizer
    read, the BatchNorm running statistics and the parameters after it."""
    state = fresh_state(cfg, sd)
    seen = {}
    apply_ = state_mod.Optimizer.apply_

    def spy(self, model, grads, opt_state):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return apply_(self, model, grads, opt_state)

    state_mod.Optimizer.apply_ = spy
    try:
        m = make_train_step(cfg, loss_impl=impl, mesh=mesh)(state, batch)
    finally:
        state_mod.Optimizer.apply_ = apply_
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": seen,
            "params": {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()}}


def input_grad(cfg, sd, batch, impl, mesh):
    """d(global loss)/d(this rank's mel rows): the one gradient that flows
    through the BatchNorm statistics (they read the input only)."""
    model = fresh_state(cfg, sd).model
    b = dict(batch)
    b["mel_specs"] = b["mel_specs"].clone().requires_grad_()
    loss, _ = batch_loss(model, cfg, b, training=True, loss_impl=impl,
                         mesh=mesh)
    loss.backward()
    return b["mel_specs"].grad.detach().clone()


def run_cases(cfg, sd, batch_np, rows, mesh):
    out = {}
    batch = torch_batch(batch_np, rows)
    for impl in IMPLS:
        out[impl] = one_step(cfg, sd, batch, impl, mesh)
        out[impl]["mel_grad"] = input_grad(cfg, sd, batch, impl, mesh)
    return out


def no_grad_all_reduce_sum(t, mesh):
    """The control: the statistics summed under no_grad (a right forward,
    a gradient that stops at the local rows)."""
    with torch.no_grad():
        out = t.detach().clone()
        mesh_mod.all_reduce_sum_([out], mesh)
    return out


def step_main(rank, world, d):
    cfg = RNNTConfig.load(d)
    sd = torch.load(os.path.join(d, "params.pt"))
    with np.load(os.path.join(d, "batch.npz")) as f:
        batch_np = {k: f[k] for k in f.files}
    per = batch_np["labels"].shape[0] // world
    mesh = mesh_mod.make_mesh(device=torch.device("cpu"))
    rows = slice(rank * per, (rank + 1) * per)
    out = run_cases(cfg, sd, batch_np, rows, mesh)
    real = mesh_mod.all_reduce_sum
    mesh_mod.all_reduce_sum = no_grad_all_reduce_sum
    try:
        out["control_mel_grad"] = input_grad(cfg, sd, torch_batch(
            batch_np, rows), "fused", mesh)
    finally:
        mesh_mod.all_reduce_sum = real
    torch.save(out, os.path.join(d, f"step_rank{rank}.pt"))


def cli_main(rank, world, port, d):
    from rnnt_tpu_torch.cli import run_rnnt
    from rnnt_tpu_torch.train import checkpoint as ckpt_mod

    data, run = os.path.join(d, "data"), os.path.join(d, "run")

    def argv(mode, **kw):
        a = ["--mode", mode, "--data_dir", data, "--output_dir", run,
             "--batch_size", "2", "--no-bf16", "--device", "cpu",
             "--pad_frames", "64", "--pad_tokens", "8", "--multihost",
             "--coordinator_address", f"localhost:{port}",
             "--num_processes", str(world), "--process_id", str(rank),
             "--steps_per_log", "1", "--eval_size", "0"]
        for k, v in kw.items():
            a += [f"--{k}", str(v)]
        return a

    rec = {}
    state = run_rnnt.main(argv("train", n_epochs=2, steps_per_checkpoint=2))
    rec["trained_step"] = state.step
    # every rank restores the final .dcp checkpoint bitwise
    mesh = mesh_mod.make_mesh(device=torch.device("cpu"))
    latest = ckpt_mod.latest_checkpoint(run)
    rec["latest"] = os.path.basename(latest)
    rec["steps_listed"] = ckpt_mod.list_checkpoint_steps(run)
    back = ckpt_mod.restore_checkpoint(latest, state.model.cfg,
                                       torch.float32, "cpu", mesh)
    want = state.model.state_dict()
    rec["restored_bitwise"] = back.step == state.step and all(
        torch.equal(v, want[k]) for k, v in back.model.state_dict().items())
    rec["opt_bitwise"] = all(
        torch.equal(back.opt_state["trace"][n], t)
        for n, t in state.opt_state["trace"].items())
    state = run_rnnt.main(argv("train", checkpoint="auto", n_epochs=1,
                               steps_per_checkpoint=100))
    rec["resumed_step"] = state.step
    rec["eval"] = run_rnnt.main(argv("eval", checkpoint=run))
    try:
        run_rnnt.main(argv("train", output_dir=os.path.join(d, "npz"),
                           ckpt_backend="npz", n_epochs=1))
        rec["npz_error"] = None
    except ValueError as e:
        rec["npz_error"] = str(e)
    with open(os.path.join(d, f"cli_rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def main(argv):
    mode, rank, world, port, d = argv
    rank, world = int(rank), int(world)
    mesh_mod.init_distributed(f"localhost:{port}", world, rank, "cpu",
                              timeout_s=120)
    try:
        if mode == "step":
            step_main(rank, world, d)
        else:
            cli_main(rank, world, port, d)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
