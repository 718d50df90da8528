"""RNN-T loss timing harness on the card (the port of
`rnnt_tpu.cli.bench_loss`).

Times every loss implementation at one lattice geometry, forward and
forward + backward, and reports the fused path's achieved TFLOP/s (its
FLOPs are dominated by the joint's vocab projection, 2*B*T*(U+1)*J*V
forward):

  ref     ops/rnnt_loss_ref.rnnt_loss_ref: materialised logits, plain scans
  pallas  ops/lattice_cuda.rnnt_loss_pallas: materialised logits, kernel K7
  fused   ops/joint_loss_fused.rnnt_loss_fused: kernel K6's planes, then K7

  python -m rnnt_tpu_torch.cli.bench_loss --B 64 --T 128 --U 64 --V 4096

Inputs are bf16 on the card and fp32 on the CPU (--device cpu); the
materialised logits are fp32 either way, and are built only when `ref` or
`pallas` runs (8.7 GB at the defaults).  An implementation that raises
prints its `failed` line and its traceback, the rest still run, and the
command exits non-zero.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np
import torch


def _timeit(fn, n: int, read=float) -> float:
    """Seconds per call of fn() over n calls after one warm-up call; only
    the last result is read back (`read`), which waits for the device."""
    read(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    read(r)
    return (time.perf_counter() - t0) / n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--B", type=int, default=64)
    p.add_argument("--T", type=int, default=128,
                   help="encoder frames (post time-reduction)")
    p.add_argument("--U", type=int, default=64)
    p.add_argument("--V", type=int, default=4096)
    p.add_argument("--J", type=int, default=640)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--impls", nargs="+", default=["ref", "pallas", "fused"],
                   choices=["ref", "pallas", "fused"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)

    from rnnt_tpu_torch.device import resolve_device
    from rnnt_tpu_torch.ops import joint_loss_fused, lattice_cuda, \
        rnnt_loss_ref

    dev = resolve_device(args.device)
    B, T, U, V, J = args.B, args.T, args.U, args.V, args.J
    rng = np.random.default_rng(0)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    def put(a, dt):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dt)

    logits = None
    if any(i in args.impls for i in ("ref", "pallas")):
        logits = put(rng.standard_normal((B, T, U + 1, V)), torch.float32)
    labels = put(rng.integers(1, V, (B, U)), torch.long)
    fl = torch.full((B,), T, dtype=torch.long, device=dev)
    yl = torch.full((B,), U, dtype=torch.long, device=dev)
    f = put(rng.standard_normal((B, T, J)), dtype)
    g = put(rng.standard_normal((B, U + 1, J)), dtype)
    b1 = torch.zeros((J,), dtype=dtype, device=dev)
    b2 = torch.zeros((V,), dtype=dtype, device=dev)
    w2 = put(rng.standard_normal((J, V)) * 0.1, dtype)

    # each loss is looked up when it runs, so that a test can replace one
    fns = {
        "ref": (lambda x: rnnt_loss_ref.rnnt_loss_ref(
            x, labels, fl, yl).sum(), logits),
        "pallas": (lambda x: lattice_cuda.rnnt_loss_pallas(
            x, labels, fl, yl).sum(), logits),
        "fused": (lambda x: joint_loss_fused.rnnt_loss_fused(
            x, g, b1, w2, b2, labels, fl, yl).sum(), f),
    }

    def grad_of(lossfn, x):
        x = x.detach().requires_grad_(True)
        (gx,) = torch.autograd.grad(lossfn(x), x)
        return gx

    joint_flops = 2 * B * T * (U + 1) * J * V  # fwd, fused path only
    print(f"backend={dev.type} B={B} T={T} U={U} V={V} J={J}", flush=True)
    failed = False
    for impl in args.impls:
        lossfn, x = fns[impl]
        try:
            with torch.no_grad():
                t_f = _timeit(lambda: lossfn(x), args.iters)
            t_g = _timeit(lambda: grad_of(lossfn, x), args.iters,
                          lambda gx: float(gx.float().sum()))
        except Exception as e:  # noqa: BLE001 - reported; main returns 1
            print(f"{impl:8s} failed: {type(e).__name__}: {str(e)[:120]}",
                  flush=True)
            traceback.print_exc()
            failed = True
            continue
        extra = ""
        if impl == "fused":
            extra = f"  fwd {joint_flops / t_f / 1e12:.1f} TFLOP/s"
        print(f"{impl:8s} fwd {t_f * 1e3:8.2f} ms   fwd+bwd "
              f"{t_g * 1e3:8.2f} ms{extra}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
