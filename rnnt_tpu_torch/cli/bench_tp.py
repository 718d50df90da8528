"""Vocab tensor parallelism's cost on one card (the port of
`rnnt_tpu.cli.bench_tp`).

Times, at the parity geometry (B=32, 216 mel frames -> T'=108 after the
time reduction, 48 tokens, J=640, V=4096, bf16), the fused joint + loss
forward and backward (d/dW2 and d/db2 of the summed NLL):

1. at the full vocabulary (the data-parallel loss);
2. at V/2: each shard's work in a 2-rank model group (W2 column-sharded);
3. the tensor-parallel code path itself (`ops.joint_loss_fused` with a
   `parallel.mesh.VocabShard`) on a model group of one: the label shift,
   the plane combine's all-reduces and the backward's partial-gradient
   all-reduce, run as collectives of a group of one.

and prints a derived 2-rank estimate of the loss,

  t_tp(2) ~ t(V/2) + max(0, t_group_of_one - t(V)) + bytes / bw

where bytes is what the port all-reduces over the model group each step:
four fp32 [B, T', U+1] planes forward (the MAX of denom, blank and emit,
the SUM of exp(denom - max)), and df [B, T', J], dg [B, U+1, J] and db1
[J] in fp32 backward.  bw (--bw_gbps) is an assumed link rate, printed as
such; nothing here measures a link.  The last line is one JSON object of
every number.

  python -m rnnt_tpu_torch.cli.bench_tp [--batch 32] [--frames 216]
      [--tokens 48] [--reps 10] [--bw_gbps 450] [--device cpu]

It runs as one process: a process group of one is created (NCCL on the
card, gloo on the CPU) unless one exists, and destroyed again.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _timeit(fn, reps: int) -> float:
    """Seconds per call of fn() over `reps` calls after one warm-up call;
    only the last result is read back, which waits for the device."""
    float(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn()
    float(r)
    return (time.perf_counter() - t0) / reps


def traffic_bytes(B: int, T: int, U1: int, J: int) -> dict:
    """Bytes the tensor-parallel loss all-reduces over the model group in
    one forward and backward (fp32)."""
    return {"forward_planes": 4 * 4 * B * T * U1,
            "backward_df_dg_db1": 4 * (B * T * J + B * U1 * J + J)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--frames", type=int, default=216,
                   help="mel frames (before the time reduction)")
    p.add_argument("--tokens", type=int, default=48)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--bw_gbps", type=float, default=450.0,
                   help="ASSUMED link rate per direction, GB/s (450: one "
                        "H100 SXM's NVLink, per its data sheet)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.ops.joint_loss_fused import rnnt_loss_fused
    from rnnt_tpu_torch.ops.matmul import matmul_f32
    from rnnt_tpu_torch.parallel import mesh as mesh_mod

    owns_group = not dist.is_initialized()
    dev = mesh_mod.init_distributed(device=args.device)
    try:
        if dist.get_world_size() != 1:
            raise SystemExit("bench_tp runs as one process (a model group "
                             "of one)")
        cfg = RNNTConfig(compute_dtype="bfloat16")
        B, U = args.batch, args.tokens
        T = -(-args.frames // cfg.time_reduction_factor)
        J, P, V = cfg.joint_size, cfg.projection_size, cfg.vocab_size
        dt = torch.bfloat16
        rng = np.random.default_rng(0)

        def put(a, dtype=dt):
            return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

        enc = put(rng.standard_normal((B, T, P)))
        pred = put(rng.standard_normal((B, U + 1, P)))
        labels = put(rng.integers(1, V, (B, U)), torch.long)
        enc_len = torch.full((B,), T, dtype=torch.long, device=dev)
        lab_len = torch.full((B,), U, dtype=torch.long, device=dev)
        w1 = put(rng.standard_normal((P, J)) * 0.05)
        b1 = torch.zeros((J,), dtype=dt, device=dev)
        w2f = put(rng.standard_normal((J, V)) * 0.05)
        b2f = torch.zeros((V,), dtype=dt, device=dev)
        f = matmul_f32(enc, w1).to(dt)
        g = matmul_f32(pred, w1).to(dt)

        def loss_grad(w2, b2, tp=None):
            w2 = w2.detach().requires_grad_()
            b2 = b2.detach().requires_grad_()

            def run():
                loss = rnnt_loss_fused(f, g, b1, w2, b2, labels, enc_len,
                                       lab_len, tp).sum()
                dw2, _ = torch.autograd.grad(loss, (w2, b2))
                return dw2[0, 0]
            return run

        t_full = _timeit(loss_grad(w2f, b2f), args.reps)
        # half the vocabulary: another objective; only its time counts
        t_half = _timeit(loss_grad(w2f[:, : V // 2], b2f[: V // 2]),
                         args.reps)
        one = mesh_mod.VocabShard(dist.group.WORLD, 0, 1)
        t_tp1 = _timeit(loss_grad(w2f, b2f, one), args.reps)

        traffic = traffic_bytes(B, T, U + 1, J)
        nbytes = sum(traffic.values())
        t_comm = nbytes / (args.bw_gbps * 1e9)
        overhead = max(0.0, t_tp1 - t_full)
        t_est2 = t_half + overhead + t_comm
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        print(f"geometry B={B} T'={T} U+1={U + 1} J={J} V={V} bf16 on {name}")
        print(f"fused loss fwd+bwd, full V           : {t_full * 1e3:9.3f} ms")
        print(f"fused loss fwd+bwd, V/2 (per shard)  : {t_half * 1e3:9.3f} ms")
        print(f"TP path, model group of one          : {t_tp1 * 1e3:9.3f} ms "
              f"(overhead {overhead * 1e3:+.3f} ms against full V)")
        print(f"TP all-reduce traffic a step         : {nbytes / 2**20:9.2f} "
              f"MiB -> {t_comm * 1e3:.3f} ms at an ASSUMED "
              f"{args.bw_gbps:g} GB/s")
        print(f"derived 2-rank TP loss step          : {t_est2 * 1e3:9.3f} ms "
              f"(full-V loss {t_full * 1e3:.3f} ms) => x{t_full / t_est2:.2f}"
              " on the loss; W2 memory per rank halves")
        print(json.dumps({
            "device": name, "B": B, "T": T, "U1": U + 1, "J": J, "V": V,
            "full_ms": t_full * 1e3, "half_ms": t_half * 1e3,
            "tp_group_of_one_ms": t_tp1 * 1e3,
            "overhead_ms": overhead * 1e3, "traffic_bytes": traffic,
            "assumed_bw_gbps": args.bw_gbps, "comm_ms": t_comm * 1e3,
            "estimate_2rank_ms": t_est2 * 1e3}), flush=True)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
