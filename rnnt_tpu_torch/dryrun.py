"""The multichip dry run (the port of `__graft_entry__.dryrun_multichip`):
one fused train step of a tiny model over n ranks, one process a rank.

  python -m rnnt_tpu_torch.dryrun [--n 4] [--device cpu] [--params P.npz]

The ranks form a (n / M data, M model) mesh with M = 2 when n is even and
at least 4 (vocab tensor parallelism over W2 and b2), else M = 1.  The
config is the JAX dry run's tiny one (V=32, 2x32/16 encoder, joint 16, 8
mel bins), the batch its global batch of B = max(8, n) rows, T=12 frames,
U=4 labels drawn from `np.random.default_rng(0)` in its order, split
among the data rows.  The parameters are `create_train_state`'s from seed
0, or an npz of every parameter by its dotted name (`--params`, e.g. the
JAX package's initial state carried across).  Rank 0 prints

  dryrun_multichip(n): mesh={'data': D, 'model': M} processes=n loss=L ok

On the card the ranks share the card over gloo when there are fewer cards
than ranks (NCCL puts one rank on a device), else run NCCL; on the CPU
they run gloo.  A rank that fails or a run past --timeout fails the whole
(every rank is then killed).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg():
    from rnnt_tpu_torch.config import tiny_config

    return tiny_config(vocab_size=32, encoder_layers=2, encoder_size=32,
                       projection_size=16, pred_net_size=32, joint_size=16,
                       embedding_size=16, mel_bins=8)


def global_batch(cfg, n: int) -> dict:
    """The JAX dry run's batch for n ranks (numpy)."""
    B, T, U = max(8, n), 12, 4
    rng = np.random.default_rng(0)
    return {
        "mel_specs": rng.standard_normal(
            (B, T, cfg.input_feat_size)).astype(np.float32),
        "pred_inp": rng.integers(0, cfg.vocab_size, (B, U + 1)).astype(
            np.int32),
        "labels": rng.integers(1, cfg.vocab_size, (B, U)).astype(np.int32),
        "spec_lengths": np.full((B,), T, np.int32),
        "label_lengths": np.full((B,), U, np.int32),
    }


def model_axis(n: int) -> int:
    return 2 if n % 2 == 0 and n >= 4 else 1


def backend_for(device: str, n: int) -> str:
    import torch

    if device == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= n else "gloo"


def run_rank(rank: int, n: int, port: int, device: str,
             params: str = None) -> float:
    """One rank's step; returns the step's (global) loss."""
    import torch
    import torch.distributed as dist

    from rnnt_tpu_torch.parallel import mesh as mesh_mod
    from rnnt_tpu_torch.train.loop import to_device
    from rnnt_tpu_torch.train.state import create_train_state
    from rnnt_tpu_torch.train.steps import make_train_step

    dev = mesh_mod.init_distributed(f"localhost:{port}", n, rank, device,
                                    timeout_s=300,
                                    backend=backend_for(device, n))
    try:
        mesh = mesh_mod.make_mesh(model=model_axis(n), device=dev)
        cfg = tiny_cfg()
        state = create_train_state(cfg, torch.float32, dev, seed=0)
        if params:
            with np.load(params) as f:
                state.model.load_params_(
                    {k: torch.from_numpy(f[k]) for k in f.files})
        mesh_mod.broadcast_module_(state.model, mesh)
        mesh_mod.shard_state_(state, mesh.vocab_shard(cfg.vocab_size))
        batch = global_batch(cfg, n)
        rows = batch["labels"].shape[0] // mesh.shape["data"]
        mine = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
        step = make_train_step(cfg, loss_impl="fused", mesh=mesh)
        loss = float(step(state, to_device(
            {k: v[mine] for k, v in batch.items()}, dev))["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss}")
        if rank == 0:
            print(f"dryrun_multichip({n}): mesh={mesh.shape} processes="
                  f"{dist.get_world_size()} loss={loss:.4f} ok", flush=True)
        mesh_mod.barrier(mesh)
        return loss
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda", params: str = None,
                     timeout_s: float = 600.0) -> str:
    """Spawn n rank processes of `run_rank`; returns rank 0's line, or
    raises with every rank's output when one fails or the run times
    out."""
    from rnnt_tpu_torch.device import resolve_device
    from rnnt_tpu_torch.parallel.mesh import free_port

    resolve_device(device)  # the card unless the CPU is asked for
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "rnnt_tpu_torch.dryrun", "--device", device,
           "--n", str(n), "--port", str(port)]
    if params:
        cmd += ["--params", os.path.abspath(params)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = [""] * n
    try:
        for r, pr in enumerate(procs):
            outs[r] = pr.communicate(timeout=timeout_s)[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    codes = [pr.returncode for pr in procs]
    lines = [x for x in outs[0].splitlines() if x.startswith(
        "dryrun_multichip(")]
    if codes != [0] * n or not lines:
        raise RuntimeError(f"dry run over {n} ranks: exit codes {codes}\n"
                           + "\n".join(f"[rank {r}]\n{o[-3000:]}"
                                       for r, o in enumerate(outs)))
    return lines[-1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=4, help="ranks")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    p.add_argument("--params", default=None,
                   help="npz of the initial parameters by dotted name")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        import torch

        torch.set_num_threads(1)
        run_rank(args.rank, args.n, args.port, args.device, args.params)
        return 0
    print(dryrun_multichip(args.n, args.device, args.params, args.timeout))
    return 0


if __name__ == "__main__":
    sys.exit(main())
