"""One rank of the port's vocab tensor-parallel tests
(tests/test_torch_tensor_parallel.py), run as

  python tests/torch_tp_worker.py step|cli RANK WORLD MODEL PORT DIR

over gloo on the CPU, the WORLD ranks laid out as a (WORLD / MODEL data,
MODEL model) mesh.  `step` runs one train step of each case of `CASES` on
this rank's data row of DIR/batch.npz from DIR/params.pt (DIR/params31.pt
for the 31-symbol case) and writes DIR/step_{D}x{M}_rank{RANK}.pt: the
loss, the gradients the optimizer read and the parameters after the step,
W2 and b2 as this rank's columns.  `cli` drives rnnt_tpu_torch.cli.run_rnnt
--multihost --model_parallel MODEL (train, eval, test, and eval of the
JAX package's checkpoint in DIR/jax_run) on DIR/data and writes
DIR/cli_{D}x{M}_rank{RANK}.json."""

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
from rnnt_tpu_torch.train.steps import make_train_step  # noqa: E402

torch.set_num_threads(1)

# case -> (loss_impl, the config's vocabulary, per-shard clipping norm)
CASES = {"fused": ("fused", 32, False), "banded": ("banded", 32, False),
         "control": ("fused", 32, True), "v31": ("fused", 31, False)}


def torch_batch(batch, rows=slice(None)):
    return {k: (torch.from_numpy(v[rows]).long() if v.dtype.kind == "i"
                else torch.from_numpy(np.ascontiguousarray(v[rows])))
            for k, v in batch.items()}


def one_step(cfg, sd, batch, impl, mesh, per_shard_norm=False):
    """One train step from the full parameters `sd` (sharded over the
    mesh's model group where it shards the vocabulary): the metrics, the
    gradients the optimizer read and the parameters after the step.
    per_shard_norm: the control, every norm read without the model
    group's sum."""
    model = Transducer(cfg)
    model.load_state_dict(sd)
    model.make_trainable_()
    state = state_mod.TrainState(step=0, model=model,
                                 opt_state=state_mod.Optimizer(cfg).init(
                                     model))
    if mesh is not None:
        mesh_mod.shard_state_(state, mesh.vocab_shard(cfg.vocab_size))
    seen = {}
    apply_, norm = state_mod.Optimizer.apply_, state_mod.global_norm

    def spy(self, model, grads, opt_state):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return apply_(self, model, grads, opt_state)

    state_mod.Optimizer.apply_ = spy
    if per_shard_norm:
        state_mod.global_norm = lambda grads, tp=None: norm(grads, None)
    try:
        m = make_train_step(cfg, loss_impl=impl, mesh=mesh)(state, batch)
    finally:
        state_mod.Optimizer.apply_ = apply_
        state_mod.global_norm = norm
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": seen,
            "params": {k: v.detach().clone()
                       for k, v in state.model.state_dict().items()}}


def run_cases(d, batch_np, rows, mesh):
    out = {}
    batch = torch_batch(batch_np, rows)
    for case, (impl, vocab, per_shard) in CASES.items():
        cfg = RNNTConfig.load(d).replace(vocab_size=vocab)
        sd = torch.load(os.path.join(
            d, "params.pt" if vocab == 32 else f"params{vocab}.pt"))
        out[case] = one_step(cfg, sd, batch, impl, mesh, per_shard)
    return out


def step_main(rank, world, model, d):
    with np.load(os.path.join(d, "batch.npz")) as f:
        batch_np = {k: f[k] for k in f.files}
    mesh = mesh_mod.make_mesh(model=model, device=torch.device("cpu"))
    per = batch_np["labels"].shape[0] // mesh.shape["data"]
    rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    out = run_cases(d, batch_np, rows, mesh)
    out["mesh"] = (mesh.data_index, mesh.shard_index)
    torch.save(out, os.path.join(
        d, f"step_{world // model}x{model}_rank{rank}.pt"))


def cli_main(rank, world, model, port, d):
    from rnnt_tpu_torch.cli import run_rnnt

    data = os.path.join(d, "data")
    tag = f"{world // model}x{model}"
    run = os.path.join(d, f"run_{tag}")

    def argv(mode, **kw):
        a = ["--mode", mode, "--data_dir", data, "--output_dir", run,
             "--batch_size", "2", "--no-bf16", "--device", "cpu",
             "--pad_frames", "64", "--pad_tokens", "8", "--multihost",
             "--coordinator_address", f"localhost:{port}",
             "--num_processes", str(world), "--process_id", str(rank),
             "--model_parallel", str(model), "--steps_per_log", "1",
             "--eval_size", "0"]
        for k, v in kw.items():
            a += [f"--{k}", str(v)]
        return a

    backend = "npz" if world == model else "dcp"
    state = run_rnnt.main(argv("train", n_epochs=1, steps_per_checkpoint=100,
                               ckpt_backend=backend))
    rec = {"trained_step": state.step,
           "w2_shape": list(state.model.joint.w2.shape),
           "eval": run_rnnt.main(argv("eval", checkpoint=run)),
           "test": run_rnnt.main(argv("test", checkpoint=run)),
           # a checkpoint the JAX package wrote, restored onto the shards
           "eval_jax_run": run_rnnt.main(argv(
               "eval", checkpoint=os.path.join(d, "jax_run")))}
    with open(os.path.join(d, f"cli_{tag}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def main(argv):
    mode, rank, world, model, port, d = argv
    rank, world, model = int(rank), int(world), int(model)
    mesh_mod.init_distributed(f"localhost:{port}", world, rank, "cpu",
                              timeout_s=120)
    try:
        if mode == "step":
            step_main(rank, world, model, d)
        else:
            cli_main(rank, world, model, port, d)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
