"""Scaling of the train step across ranks (the port of
`rnnt_tpu.cli.bench_scaling`).

Measures the same train step at a fixed batch per data row over growing
(n / M data, M model) meshes (the first n ranks of the process group, one
process a device, M = --model_parallel: vocab tensor parallelism within a
row) and prints one JSON line per size: throughput and efficiency against
the first size's run, and the mesh as "DATAxMODEL".

  torchrun --nproc_per_node 4 -m rnnt_tpu_torch.cli.bench_scaling \\
      --devices 1 2 4 --per_device_batch 32
  python -m rnnt_tpu_torch.cli.bench_scaling --devices 1     # one card
  python -m rnnt_tpu_torch.cli.bench_scaling --simulate 2 --tiny --device cpu

Without torchrun a single process measures a group of one (NCCL on the
card).  --simulate N spawns N gloo processes on the CPU: like the JAX
package's, its numbers check the parallel path, not speed.  The batch of
data row r is `bench.make_batch(..., seed=r)`; one warm-up step, then
--steps steps, synchronised once.  A size that M does not divide is
skipped.  Each line names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="mesh sizes to measure (default: 1, 2, 4, ... up to "
                        "the world size)")
    p.add_argument("--per_device_batch", type=int, default=8,
                   help="each data row's batch")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--labels", type=int, default=64)
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model-axis size of every mesh (vocab tensor "
                        "parallelism)")
    p.add_argument("--loss_impl", default="fused",
                   choices=["fused", "banded", "auto", "ref", "pallas"])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--simulate", type=int, default=0,
                   help="spawn N gloo processes on the CPU (path check)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model (CPU-feasible) instead of parity scale")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)
    if args.simulate and args.device != "cpu":
        p.error("--simulate runs gloo processes on the CPU: pass --device cpu")
    return args


def measure(args, device) -> list:
    """Every rank of the process group runs this; returns the records (on
    rank 0 of the world; [] elsewhere)."""
    import torch

    from rnnt_tpu_torch.bench import make_batch
    from rnnt_tpu_torch.config import RNNTConfig, tiny_config
    from rnnt_tpu_torch.parallel import mesh as mesh_mod
    from rnnt_tpu_torch.train.loop import to_device
    from rnnt_tpu_torch.train.state import create_train_state
    from rnnt_tpu_torch.train.steps import make_train_step

    world_mesh = mesh_mod.make_mesh(device=device)
    world = world_mesh.size
    sizes = args.devices or [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    if args.tiny:
        cfg = tiny_config(vocab_size=64, encoder_layers=2, encoder_size=64,
                          projection_size=32, pred_net_size=64, joint_size=32,
                          embedding_size=32, mel_bins=16)
    else:
        cfg = RNNTConfig(compute_dtype="bfloat16")
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    T, U = args.frames, args.labels
    sec_per_frame = cfg.frame_step * cfg.downsample_factor
    base, out = None, []
    mp = args.model_parallel
    for n in sizes:
        if n > world or n % mp:
            continue
        mesh = mesh_mod.make_mesh(model=mp, ranks=range(n), device=device)
        if mesh.rank >= 0:
            state = create_train_state(cfg, dtype, device, seed=0)
            mesh_mod.broadcast_module_(state.model, mesh)
            mesh_mod.shard_state_(state, mesh.vocab_shard(cfg.vocab_size))
            row = mesh.data_index
            batch = to_device(make_batch(cfg, args.per_device_batch, T, U,
                                         seed=row), device, dtype)
            step = make_train_step(cfg, loss_impl=args.loss_impl, mesh=mesh)
            gen = torch.Generator(device=device).manual_seed(1 + row)
            loss = float(step(state, batch, gen)["loss"])  # warm-up
            mesh_mod.barrier(mesh)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                m = step(state, batch, gen)
            loss = float(m["loss"])  # waits for the device
            dt = (time.perf_counter() - t0) / args.steps
            if not loss == loss or abs(loss) == float("inf"):
                raise RuntimeError(f"{n} ranks: loss {loss} is not finite")
            rows = n // mp
            audio_s = args.per_device_batch * rows * T * sec_per_frame / dt
            per_dev = audio_s / n
            base = base or per_dev
            out.append({
                "devices": n, "mesh": f"{rows}x{mp}",
                "global_batch": args.per_device_batch * rows,
                "step_ms": dt * 1e3, "audio_s_per_s": audio_s,
                "per_device": per_dev,
                "efficiency_vs_1dev": per_dev / base,
                "loss": loss, "device": name})
            del state, batch
        mesh_mod.barrier(world_mesh)
    return out if world_mesh.rank == 0 else []


def _simulated_rank(rank: int, n: int, port: int, argv, queue) -> None:
    """One spawned gloo rank of --simulate (a top-level function, so the
    spawn start method can import it)."""
    import torch
    import torch.distributed as dist

    from rnnt_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    args = parse_args(argv)
    dev = mesh_mod.init_distributed(f"localhost:{port}", n, rank, "cpu")
    try:
        recs = measure(args, dev)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        queue.put(recs)


def _simulate(args, argv, timeout_s: float = 600.0) -> list:
    """Run `measure` in args.simulate spawned gloo processes; their
    records, or RuntimeError when a rank fails or the run times out (every
    rank is then killed)."""
    import multiprocessing as mp
    import queue as queue_mod

    from rnnt_tpu_torch.parallel.mesh import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_simulated_rank,
                         args=(r, args.simulate, port, argv, q))
             for r in range(args.simulate)]
    for pr in procs:
        pr.start()
    try:
        recs = q.get(timeout=timeout_s)
        for pr in procs:
            pr.join(timeout=60)
        codes = [pr.exitcode for pr in procs]
    except queue_mod.Empty:
        codes = [pr.exitcode for pr in procs]
        recs = None
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    if recs is None or any(c != 0 for c in codes):
        raise RuntimeError(f"--simulate {args.simulate}: rank exit codes "
                           f"{codes}")
    return recs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.simulate:
        recs = _simulate(args, argv)
    else:
        import torch.distributed as dist

        from rnnt_tpu_torch.parallel import mesh as mesh_mod

        owns_group = not dist.is_initialized()
        dev = mesh_mod.init_distributed(device=args.device)
        try:
            recs = measure(args, dev)
        finally:
            if owns_group:
                dist.destroy_process_group()
    for r in recs:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
