"""A/B timing of builds of the LSTM backward kernel K5 on one card.

  python3 -m rnnt_tpu_torch.kernels.lstm_ab A.cu B.cu [...] [--batch 32 96]
      [--steps 256] [--reps 10]

Each source is a copy of `csrc/lstm_bwd.cu` (the parent's, the change's, or
an edited copy), built with the package's nvcc flags into
`rnnt_tpu_torch/_build/ab/`; a `common.cuh` beside a source is used before
the package's.  At each batch B (T = --steps, H=2048, P=640, bf16, random
residuals from the plain forward, seed 0) every build is checked once
against the plain version (`lstm_cuda.lstm_bwd_plain`; its largest relative
error over dz, dh_total, dh0, dc0 is printed, not gated) and then timed in
turns, first source to last and back (parent, change, change, parent for
two sources), the median of `reps` CUDA-event runs each.  A build that
exports `int k5_phases(unsigned long long* out, int reset)` (a copy with
clock64 timers in block 0) also reports its cycles a step by phase.  Prints
one JSON line a batch, then the card's name and power limit.  The scratch
buffers fit both exchange layouts (the fp32 one of the FMA design and the
padded bf16 one of the MMA design), so builds of either design time alike.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from rnnt_tpu_torch.kernels import build
from rnnt_tpu_torch.ops import lstm_cuda

H, P = 2048, 640
PHASES = ("A products", "A epilogue", "A barrier", "B products",
          "B epilogue", "B barrier", "chunk wait and sync (in products)")


def _build_all(sources):
    """{source: ctypes entry lstm_bwd_bf16}, all nvcc processes at once."""
    out_dir = os.path.join(build._BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        lib = os.path.join(out_dir, f"lib{i}_{os.path.basename(src)}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build._CSRC, "-o", lib,
               src]
        procs[src] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for src, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{out}")
        lib = ctypes.CDLL(path)
        fn = lib.lstm_bwd_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        libs[src] = (lib, fn)
    return libs


def _launch(fn, args):
    z, c, c0, dout, whT, wpT = args
    T, B, H4 = z.shape
    dev, dt = z.device, whT.dtype
    ldp, ld4 = -(-P // 16) * 16, -(-H4 // 16) * 16
    # 4 bytes a padded value: room for fp32 [B, P] and bf16 [B, ldp] alike
    dhtot = torch.empty((B * ldp,), dtype=torch.float32, device=dev)
    dzbuf = torch.empty((B * ld4,), dtype=torch.float32, device=dev)
    outs = (torch.empty((T, B, H4), dtype=dt, device=dev),
            torch.empty((T, B, P), dtype=dt, device=dev),
            torch.empty((B, P), dtype=torch.float32, device=dev),
            torch.empty((B, H), dtype=torch.float32, device=dev))
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    err = fn(*(a.data_ptr() for a in (*args, dhtot, dzbuf, *outs, bar)),
             T, B, H, P, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed with {err}")
    return outs


def _median_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _inputs(B, T, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(shape, scale):
        return (torch.rand(shape, generator=g, device="cuda") - 0.5) * scale

    dt = torch.bfloat16
    fwd = (rand((T, B, 4 * H), 4.0).to(dt), rand((P, 4 * H), 0.05).to(dt),
           rand((H, P), 0.1).to(dt), rand((4 * H,), 1.0).to(dt),
           torch.zeros((B, P), dtype=dt, device="cuda"),
           torch.zeros((B, H), device="cuda"))
    _, z, c, _ = lstm_cuda.lstm_fwd_plain(*fwd)
    return (z, c, fwd[5], rand((T, B, P), 1.0).to(dt),
            fwd[1].t().contiguous(), fwd[2].t().contiguous())


def _rel_err(got, want):
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))
               for a, b in zip(got, want))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sources", nargs="+")
    p.add_argument("--batch", type=int, nargs="+", default=[32, 96])
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--reps", type=int, default=10)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("lstm_ab: CUDA is not available", file=sys.stderr)
        return 2
    libs = _build_all(a.sources)
    for B in a.batch:
        args = _inputs(B, a.steps)
        want = lstm_cuda.lstm_bwd_plain(*args)
        rel = {s: _rel_err(_launch(fn, args), want)
               for s, (_, fn) in libs.items()}
        ms = {s: [] for s in a.sources}
        for s in a.sources + a.sources[::-1]:
            ms[s].append(_median_ms(lambda: _launch(libs[s][1], args),
                                    a.reps))
        phases = {}
        for s, (lib, fn) in libs.items():
            if hasattr(lib, "k5_phases"):
                buf = (ctypes.c_ulonglong * 8)()
                lib.k5_phases(buf, 1)
                _launch(fn, args)
                torch.cuda.synchronize()
                lib.k5_phases(buf, 0)
                phases[s] = {n: buf[i] / a.steps for i, n in enumerate(PHASES)}
        print(json.dumps({"B": B, "T": a.steps, "H": H, "P": P,
                          "dtype": "bfloat16", "ms": ms, "rel_err": rel,
                          "block0_cycles_a_step": phases}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
