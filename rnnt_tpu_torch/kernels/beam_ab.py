"""A/B timing of builds of the beam-search kernel K3 on one card.

  python3 -m rnnt_tpu_torch.kernels.beam_ab A.cu B.cu[:NAME=V,...] [...]
      [--seed 0] [--reps 3] [--turns 2] [--phases] [--ptxas]

Each source is a copy of `csrc/beam_search.cu`: the parent's, the change's,
or an edited copy; `new.cu:NAME=V` is built with `-DNAME=V`, so one file can
stand for several builds.  All are built at once with the package's nvcc
flags into `rnnt_tpu_torch/_build/ab/` (a header beside a source is used
before the package's); `--ptxas` adds `-Xptxas -v` and prints each build's
register, shared-memory and spill report of the beam kernels.

The search is the 15 s request's: encoder output [1, 256, 640] (random
normal from --seed) with 250 valid frames, K=4, E=6, L=256, bf16, the
parity width's prediction net and joint (`RNNTConfig()`, random weights
from --seed).  Every build runs it once beside the plain search
(`decode.beam.beam_search_encoded_plain`) on the same inputs; the tool
prints the largest relative score error, whether the best tokens agree and
the first selection where the picks differ with the plain search's gap
there (`decode.beam.trace_divergence`; printed, not gated), and the design
the build reports (`beam_last_design()`, where the build exports it).
Then the builds run in turns, first to last and back, `--turns` times,
`--reps` CUDA-event runs a turn; it prints each build's median, minimum and
maximum.  With `--phases` each build runs once more with per-block phase
timers (`ops.beam_cuda.phase_split`: block 0's row, the heaviest block's
and each phase's maximum over blocks; a build that times block 0 alone
fills only row 0).  Prints one JSON line a build, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from rnnt_tpu_torch.kernels import build
from rnnt_tpu_torch.ops import beam_cuda

FRAMES, T_PAD, K, E, L = 250, 256, 4, 6, 256


def _build_all(sources, ptxas):
    """{spec: (library, bf16 entry, ptxas report)}, all nvcc processes at
    once; a spec is a path, optionally with `:NAME=V,...` definitions."""
    out_dir = os.path.join(build._BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, spec in enumerate(sources):
        src, _, defs = spec.partition(":")
        lib = os.path.join(out_dir, f"libbeam{i}_{os.path.basename(src)}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS,
               *(["-Xptxas", "-v"] if ptxas else []),
               *(f"-D{d}" for d in defs.split(",") if d), "-I", build._CSRC,
               "-o", lib, src]
        procs[spec] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for spec, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {spec}:\n{out}")
        lib = ctypes.CDLL(path)
        fn = lib.beam_search_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3
        lib.beam_workspace_words.restype = ctypes.c_int
        lib.beam_workspace_words.argtypes = [ctypes.c_void_p] * 2
        libs[spec] = (lib, fn, _ptxas_report(out) if ptxas else None)
    return libs


def _launcher(lib, fn, model, enc, enc_len, kw):
    """beam_search through one build."""
    def run(**extra):
        return beam_cuda.beam_search(model, enc, enc_len, library=(lib, fn),
                                     **kw, **extra)
    return run


def _ptxas_report(out):
    """ptxas -v's lines about the beam kernels: the function, then its
    registers, stack, spills and shared memory."""
    keep, take = [], False
    for line in out.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            take = "beam_kernel" in line
        if take:
            keep.append(line.split("ptxas info    :")[-1].strip())
    return keep


def _model(seed):
    """The parity width's prediction net and joint, random from `seed`,
    bf16 on the card (the encoder is not used)."""
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.models.transducer import Transducer

    model = Transducer(RNNTConfig())
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.prediction.reset_(rng)
        model.joint.reset_(rng)
    return model.cast_(torch.bfloat16).cuda().eval()


def _median_min_max(times):
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sources", nargs="+")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--phases", action="store_true")
    p.add_argument("--ptxas", action="store_true")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("beam_ab: CUDA is not available", file=sys.stderr)
        return 2
    from rnnt_tpu_torch.decode.beam import (beam_search_encoded_plain,
                                            trace_divergence)

    libs = _build_all(a.sources, a.ptxas)
    model = _model(a.seed)
    rng = np.random.default_rng(a.seed + 1)
    enc = torch.from_numpy(rng.standard_normal(
        (1, T_PAD, model.cfg.projection_size)).astype(np.float32)).cuda()
    enc_len = torch.tensor([FRAMES], device="cuda")
    kw = dict(beam_width=K, max_output_length=L, expansions_per_frame=E)
    with torch.no_grad():
        stats = {}
        want = beam_search_encoded_plain(model, enc, enc_len, stats=stats,
                                         **kw)
        runs, report = {}, {}
        for spec, (lib, fn, ptx) in libs.items():
            trace = {}
            runs[spec] = _launcher(lib, fn, model, enc, enc_len, kw)
            got = runs[spec](trace=trace)
            torch.cuda.synchronize()
            live = (got[2] > -1e29) & (want[2] > -1e29)
            rel = float((got[2] - want[2]).abs()[live].max()
                        / want[2].abs()[live].max()) if live.any() else 0.0
            first, _ = trace_divergence(trace, stats, enc_len, E)[0]
            report[spec] = {
                "score_rel_err": rel,
                "tokens_equal": bool(torch.equal(got[0].cpu(), want[0].cpu())
                                     and torch.equal(got[1].cpu(),
                                                     want[1].cpu())),
                "first_differing_selection": first,
                "plain_gap_there": None if first is None
                else float(stats["gap"][first, 0]),
                "design": beam_cuda.DESIGNS[lib.beam_last_design()]
                if hasattr(lib, "beam_last_design") else "fma"}
            if ptx is not None:
                report[spec]["ptxas"] = ptx
        order = list(runs)
        times = {s: [] for s in order}
        for _ in range(a.turns):
            for s in order + order[::-1]:
                runs[s]()
                torch.cuda.synchronize()
                for _ in range(a.reps):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    runs[s]()
                    end.record()
                    end.synchronize()
                    times[s].append(start.elapsed_time(end))
        for spec, (lib, fn, _) in libs.items():
            report[spec]["ms"] = _median_min_max(times[spec])
            report[spec]["ms_by_turn"] = times[spec]
            if a.phases:
                # a build's own row width (an older one times fewer
                # phases, or block 0 alone: row 0)
                cols = (lib.beam_phase_count()
                        if hasattr(lib, "beam_phase_count") else 11)
                phase_ns = torch.zeros(
                    (beam_cuda.grid_blocks(enc.device),
                     len(beam_cuda.PHASES)), dtype=torch.int64,
                    device="cuda")
                runs[spec](phase_ns=phase_ns)
                torch.cuda.synchronize()
                rows = phase_ns.reshape(-1)[:phase_ns.shape[0] * cols]
                report[spec]["phase_ms"] = beam_cuda.phase_split(
                    rows.reshape(-1, cols))
    for spec in order:
        print(json.dumps({"kernel": "beam", "source": spec, "frames": FRAMES,
                          "K": K, "E": E, "L": L, "dtype": "bfloat16",
                          **report[spec]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
