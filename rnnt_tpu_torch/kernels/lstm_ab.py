"""A/B timing of builds of the LSTM kernels K2, K4, K5 and of K1, K6 and K7
on one card.

  python3 -m rnnt_tpu_torch.kernels.lstm_ab A.cu B.cu[:NAME=V,...] [...]
      [--kernel infer|fwd|bwd|planes|lattice|frontend] [--batch 32 96]
      [--steps 256] [--shape 1x512 1x1 ...] [--samples 240000 1360]
      [--reps 10] [--ptxas]

Each source is a copy of `csrc/lstm_infer.cu` (`--kernel infer`, K2, entry
`lstm_infer_bf16`; `--kernel fwd`, K4) or of `csrc/lstm_bwd.cu` (`--kernel
bwd`, the default, K5): the parent's, the change's, or an edited copy.
All are built at once with the package's nvcc flags into
`rnnt_tpu_torch/_build/ab/`; a header beside a source is used before the
package's.  At each batch B (T = --steps, H=2048, P=640, bf16,
random inputs, seed 0; K5 gets the residuals of the plain forward) every
build is checked once against the plain version (`lstm_cuda.lstm_fwd_plain`
or `lstm_bwd_plain`; its largest relative error over the outputs is
printed, not gated) and then timed in turns, first source to last and back
(parent, change, change, parent for two sources), the median of `reps`
CUDA-event runs each.  With `--kernel fwd` cuDNN's training forward of
`torch.nn.LSTM(proj_size=640)` on the same widths (input projection
included) takes its turn as one more source, `cudnn`, so one call settles
K4's ratio against it; with `--kernel infer` (K2, checked against
`lstm_seq_infer_plain` with a nonzero carried state) cuDNN's inference
forward of the same LSTM under `torch.no_grad()` does.  `--shape BxT`
gives (B, T) pairs in place of `--batch` x `--steps` (`--kernel infer`
defaults to B=1 at T=512, 2 and 1, and B=32 at T=256).  A source may
carry macro definitions, `new.cu:LAT_MAX_B=0` (built with
`-DLAT_MAX_B=0`: the change without K2's LAT design), so one file can
stand for several builds.  A build that exports `lstm_last_design()`
reports the design it ran ("lat", "mma", "fma" or, for K5, "cluster" with
its cluster size); one that exports `int k2_phases(unsigned long long*
out, int reset)`, `k4_phases` or `k5_phases` (block-0 clock64 timers: for
K2 and K5's cluster design, `new.cu:LSTM_PHASE_TIMERS=1`; for K4, an
edited copy) also reports its cycles a step by phase, under the names its
`k5_phase_names()` gives where it exports one.  A K5 build that exports
`lstm_bwd_plan` gets the dz scratch its plan asks for, and its bytes as
the entry's last argument.  Prints one
JSON line a shape, then the card's name and power limit.  The scratch
buffers fit every exchange layout (the fp32 one of the FMA design, the
padded bf16 one of the MMA design, K2's tagged words), so builds of any
design time alike.  With `--kernel lattice` the sources are copies of
`csrc/rnnt_lattice.cu` (K7), run on random log-probability planes [B, T,
U+1] (T = --steps, U+1 = --labels, emit masked from U_b on) and checked
against `rnnt_loss_ref.lattice_scan_plain` over the valid cells, and timed
as device time (a spin kernel queued ahead, see `--kernel frontend`).  With
`--kernel planes` the sources are copies of `csrc/joint_planes.cu` (K6),
run through `ops.planes_cuda.launch` (each call as the training step makes
it, any packing of W2 included) at T' = --steps (default 128), U+1 =
--labels, J=640, V=4096 in bf16, on `chip_smoke.planes_inputs`'s inputs
(seed 4), checked against `planes_cuda.joint_planes_plain` (the largest
relative error over denom, blank and emit); cuBLAS's bare bf16 [C,J] x
[J,V] product (`torch.mm`) takes a turn as `cublas`, and each build's
packing of W2 alone (the WGMMA launch's first kernel, where the build has
it) one as `<source> pack_w2`.  A build with
`PLANES_PHASE_TIMERS=1` also reports its per-block phase split in ms of
one launch: block 0's, the heaviest block's and each phase's maximum over
blocks.  With `--kernel frontend` the sources are copies of
`csrc/frontend.cu` (K1), run at the parity geometry on `--samples` samples
of `chip_smoke.synthetic_audio`-like audio (default 240000, the 15 s
request's 1498 frames, and 1360, a 7-frame chunk of the TCP stream in
1024-sample frames); a build exporting `frontend_log_mel_fft` runs through
`features_cuda.launch`, one exporting the dense-DFT entry of earlier trees
`frontend_log_mel` with its window-folded DFT matrices.  Each is checked
against `features.log_mel_plain` (max |d log-mel| after mean subtraction)
and timed in turns with `composite`, the plain version's op chain on the
card (framing and window, `torch.fft.rfft`, `abs`, the mel `torch.mm`,
`log`): `ms` is device time (a spin kernel queued ahead of each run, so
the host's enqueueing is hidden), `call_ms` the same runs without the
spin, which the host's Python and launch overhead sets when it is
longer.  `--ptxas` adds `-Xptxas -v` and prints each build's report.
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
from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.ops import features as F
from rnnt_tpu_torch.ops import (features_cuda, lattice_cuda, lstm_cuda,
                                planes_cuda, rnnt_loss_ref)

H, P, F_IN = 2048, 640, 240
PHASES = ("A products", "A epilogue", "A barrier", "B products",
          "B epilogue", "B barrier", "chunk wait and sync (in products)")
# K2's LAT timers (LSTM_PHASE_TIMERS): thread 0 of block 0, in warp 0
K2_PHASES = ("A poll", "A MMAs", "A sync", "A epilogue", "B poll",
             "B MMAs", "B sync", "B epilogue")
# kernel: (entry, pointer arguments, phase-timer export, its phase names)
ENTRY = {"infer": ("lstm_infer_bf16", 10, "k2_phases", K2_PHASES),
         "fwd": ("lstm_fwd_bf16", 12, "k4_phases",
                 ("A products: wait for the other warps",) + PHASES[1:]
                 + ("A products: ring and MMAs",)),
         "bwd": ("lstm_bwd_bf16", 13, "k5_phases", PHASES),
         "lattice": ("rnnt_lattice", 7, None, ()),
         "frontend": (None, 0, None, ()),
         "planes": (None, 0, "planes_phases", (
             "build", "w2_wait", "products", "logits_out", "fold",
             "barrier"))}
DESIGNS = ("fma", "mma", "lat", "cluster")
PLANES_J, PLANES_V = 640, 4096  # the parity joint
INFER_SHAPES = ((1, 512), (1, 2), (1, 1), (32, 256))
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock


def _round16(n):
    return -(-n // 16) * 16


def _build_all(sources, kernel, ptxas=False):
    """{source spec: (library, ctypes entry)}, all nvcc processes at once; a
    spec is a path, optionally with `:NAME=V,...` macro definitions."""
    entry, n_ptr, _, _ = ENTRY[kernel]
    out_dir = os.path.join(build._BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, spec in enumerate(sources):
        src, _, defs = spec.partition(":")
        lib = os.path.join(out_dir, f"lib{i}_{os.path.basename(src)}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS,
               *(["-Xptxas", "-v"] if ptxas else []),
               *(f"-D{d}" for d in defs.split(",") if d), "-I", build._CSRC,
               "-o", lib, src]
        procs[spec] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for src, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{out}")
        if ptxas:
            print(f"ptxas {src}:\n{out}", flush=True)
        lib = ctypes.CDLL(path)
        if kernel == "planes":
            libs[src] = (planes_cuda.bind(lib), None)
            continue
        if kernel == "frontend":
            libs[src] = (lib, _frontend_launcher(lib))
            continue
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (
            3 if kernel == "lattice" else 4) + [ctypes.c_void_p]
        libs[src] = (lib, _BwdEntry(lib, fn) if kernel == "bwd" else fn)
    return libs


class _BwdEntry:
    """A K5 build's entry and the bytes of dz scratch its plan needs: what
    `lstm_bwd_plan` says where the build exports it (such a build takes the
    bytes after the stream), else the exchange's 4 bytes a padded value."""

    def __init__(self, lib, fn):
        self.fn = fn
        self.plan = getattr(lib, "lstm_bwd_plan", None)
        if self.plan is not None:
            self.plan.restype = ctypes.c_int
            self.plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.argtypes = fn.argtypes + [ctypes.c_size_t]

    def scratch_bytes(self, B):
        if self.plan is None:
            return 4 * B * _round16(4 * H)
        out = (ctypes.c_longlong * 8)()
        if self.plan(B, H, P, out) != 0:
            raise RuntimeError("lstm_bwd_plan failed")
        return out[5]


def _launch_fwd(fn, args):
    xp, wh, wp, bias, h0, c0 = args
    T, B, H4 = xp.shape
    dev, dt = xp.device, wh.dtype
    # h0 then room for the padded bf16 exchange; hid 4 bytes a padded value
    off = -(-B * P // 4) * 4
    hbuf = torch.empty((off + B * _round16(P),), dtype=torch.float32,
                       device=dev)
    hbuf[:B * P] = h0.reshape(-1).float()
    hidbuf = torch.empty((B * _round16(H),), dtype=torch.float32, device=dev)
    h_seq = torch.empty((T, B, P), dtype=dt, device=dev)
    c_fin = torch.empty((B, H), dtype=torch.float32, device=dev)
    z_seq = torch.empty((T, B, H4), dtype=dt, device=dev)
    c_seq = torch.empty((T, B, H), dtype=dt, device=dev)
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    ptrs = (xp, wh, wp, bias, c0, hbuf, hidbuf, h_seq, c_fin, z_seq, c_seq,
            bar)
    err = fn(*(a.data_ptr() for a in ptrs), T, B, H, P,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed with {err}")
    return h_seq, z_seq, c_seq, c_fin


def _launch_infer(fn, args):
    xp, wh, wp, bias, h0, c0 = args
    T, B, _ = xp.shape
    dev, dt = xp.device, wh.dtype
    # as lstm_cuda._forward_launch: h0 then room for the padded bf16
    # exchange; hid and h at 4 bytes a padded value
    off = -(-B * P // 4) * 4
    hbuf = torch.empty((off + B * _round16(P),), dtype=torch.float32,
                       device=dev)
    hbuf[:B * P] = h0.reshape(-1).float()
    hidbuf = torch.empty((B * (_round16(H) + _round16(P)),),
                         dtype=torch.float32, device=dev)
    h_seq = torch.empty((T, B, P), dtype=dt, device=dev)
    c_fin = torch.empty((B, H), dtype=torch.float32, device=dev)
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    err = fn(*(a.data_ptr() for a in (xp, wh, wp, bias, c0, hbuf, hidbuf,
                                      h_seq, c_fin, bar)),
             T, B, H, P, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed with {err}")
    return h_seq, c_fin


def _launch_bwd(entry, args):
    z, c, c0, dout, whT, wpT = args
    T, B, H4 = z.shape
    dev, dt = z.device, whT.dtype
    # 4 bytes a padded value: room for fp32 [B, P] and bf16 [B, ldp] alike;
    # dz scratch as the build's plan asks
    dhtot = torch.empty((B * _round16(P),), dtype=torch.float32, device=dev)
    dzbuf = torch.empty((-(-entry.scratch_bytes(B) // 4),),
                        dtype=torch.float32, device=dev)
    outs = (torch.empty((T, B, H4), dtype=dt, device=dev),
            torch.empty((T, B, P), dtype=dt, device=dev),
            torch.empty((B, P), dtype=torch.float32, device=dev),
            torch.empty((B, H), dtype=torch.float32, device=dev))
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    err = entry.fn(*(a.data_ptr() for a in (*args, dhtot, dzbuf, *outs,
                                            bar)),
                   T, B, H, P, torch.cuda.current_stream(dev).cuda_stream,
                   *([dzbuf.numel() * 4] if entry.plan is not None else []))
    if err != 0:
        raise RuntimeError(f"K5 launch failed with {err}")
    return outs


def _launch_lattice(fn, args):
    b, e, fl, yl = args
    B, T, U1 = b.shape
    alpha, beta = torch.empty_like(b), torch.empty_like(b)
    ll = torch.empty((B,), dtype=torch.float32, device=b.device)
    err = fn(*(a.data_ptr() for a in (b, e, fl, yl, alpha, beta, ll)), B, T,
             U1, torch.cuda.current_stream(b.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K7 launch failed with {err}")
    return alpha, beta, ll


def _frontend_launcher(lib):
    """audio -> log-mel through a frontend build of either interface."""
    if hasattr(lib, "frontend_log_mel_fft"):
        features_cuda.bind(lib)
        return lambda audio, cfg: features_cuda.launch(lib, audio, cfg)
    fn = lib.frontend_log_mel  # the dense DFT of earlier trees
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    mats = {}  # window-folded cos, sin and the mel matrix, by config

    def launch(audio, cfg):
        flen, hop = cfg.frame_length_samples, cfg.frame_step_samples
        K = F.next_pow2(flen) // 2 + 1
        if cfg not in mats:
            k = np.arange(flen, dtype=np.float64)[:, None]
            ang = np.pi * k * np.arange(K)[None, :] / (K - 1)
            hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / flen)
            mats[cfg] = [torch.from_numpy(np.ascontiguousarray(m)).cuda()
                         for m in ((hann * np.cos(ang)).astype(np.float32),
                                   (-hann * np.sin(ang)).astype(np.float32),
                                   F.mel_weight_matrix(
                                       cfg.mel_bins, K, cfg.sample_rate,
                                       cfg.hertz_low, cfg.hertz_high))]
        n_frames = F.num_frames(audio.shape[0], cfg)
        out = torch.empty((n_frames, cfg.mel_bins), device="cuda")
        err = fn(audio.data_ptr(), *(m.data_ptr() for m in mats[cfg]),
                 out.data_ptr(), n_frames, flen, hop, K, cfg.mel_bins,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K1 launch failed with {err}")
        return out
    return launch


def _frontend_audio(n, seed=0):
    """chip_smoke.synthetic_audio's mix at 16 kHz: three tones, a slow
    envelope and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    audio = sum(0.2 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t
                             + rng.uniform(0, 6.3)) for _ in range(3))
    audio = audio * (0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t)) \
        + 0.02 * rng.standard_normal(n)
    return torch.from_numpy(audio.astype(np.float32)).cuda()


def composite_frontend(audio, cfg):
    """The plain version's op chain with its constants on the card (framed
    and windowed audio, torch.fft.rfft, abs, the mel product, log): a
    yardstick of several PyTorch calls, not one."""
    flen, hop = cfg.frame_length_samples, cfg.frame_step_samples
    nfft = F.next_pow2(flen)
    n_frames = F.num_frames(audio.shape[0], cfg)
    idx = (torch.arange(n_frames, device=audio.device)[:, None] * hop
           + torch.arange(flen, device=audio.device)[None, :])
    k = torch.arange(flen, dtype=torch.float32, device=audio.device)
    win = 0.5 - 0.5 * torch.cos(2.0 * np.pi * k / flen)
    mel = torch.from_numpy(F.mel_weight_matrix(
        cfg.mel_bins, nfft // 2 + 1, cfg.sample_rate, cfg.hertz_low,
        cfg.hertz_high)).to(audio.device)
    return lambda: torch.log(torch.mm(torch.fft.rfft(
        audio[idx] * win, n=nfft).abs(), mel) + 1e-6)


def _frontend_main(a, libs):
    """K1 builds at each --samples length: error, then times in turns."""
    cfg = RNNTConfig()
    for n in a.samples:
        audio = _frontend_audio(n)
        want = F.subtract_mean(F.log_mel_plain(audio, cfg))
        err = {s: float((F.subtract_mean(fn(audio, cfg)) - want).abs().max())
               for s, (_, fn) in libs.items()}
        runs = {s: (lambda fn=fn: fn(audio, cfg)) for s, (_, fn) in
                libs.items()}
        runs["composite"] = composite_frontend(audio, cfg)
        order = list(runs)
        ms = {s: [] for s in order}
        call_ms = {s: [] for s in order}
        reps = a.reps * 5  # microsecond launches: more runs
        for s in order + order[::-1]:
            ms[s].append(_median_ms(runs[s], reps, ahead=True))
            call_ms[s].append(_median_ms(runs[s], reps))
        print(json.dumps({"kernel": "frontend", "samples": n,
                          "frames": F.num_frames(n, cfg), "ms": ms,
                          "call_ms": call_ms, "max_abs_err": err}),
              flush=True)


def _lattice_inputs(B, T, U1, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = -3.0 * torch.rand((B, T, U1), generator=g, device="cuda") - 0.05
    e = -3.0 * torch.rand((B, T, U1), generator=g, device="cuda") - 0.05
    fl = torch.randint(max(1, T - 28), T + 1, (B,), generator=g,
                       device="cuda", dtype=torch.int32)
    yl = torch.randint(max(0, U1 - 26), U1, (B,), generator=g, device="cuda",
                       dtype=torch.int32)
    u = torch.arange(U1, device="cuda")[None, None, :]
    return b, torch.where(u < yl[:, None, None], e, rnnt_loss_ref.NEG), fl, yl


def _lattice_err(got, args):
    b, _, fl, yl = args
    want = rnnt_loss_ref.lattice_scan_plain(*args)
    _, T, U1 = b.shape
    t = torch.arange(T, device=b.device)[None, :, None]
    u = torch.arange(U1, device=b.device)[None, None, :]
    valid = (t < fl[:, None, None]) & (u <= yl[:, None, None])
    return _rel_err([got[0][valid], got[1][valid], got[2]],
                    [want[0][valid], want[1][valid], want[2]])


def _planes_inputs(B, T, U1, seed=4):
    """`chip_smoke.planes_inputs` at the parity joint, in bf16, and the
    operands of cuBLAS's bare product."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    J, V = PLANES_J, PLANES_V
    lim = (6.0 / (J + V)) ** 0.5

    def rand(shape, scale):
        return (torch.rand(shape, generator=g, device="cuda") * 2 - 1) * scale

    y = torch.randint(1, V, (B, U1), generator=g, device="cuda")
    y[:, -1] = 0
    f, gg, b1, w2, b2 = (rand((B, T, J), 1.0), rand((B, U1, J), 1.0),
                         rand((J,), 0.1), rand((J, V), lim),
                         rand((V,), 0.1))
    dt = torch.bfloat16
    args = (f.to(dt), gg.to(dt), y, b1.to(dt), w2.to(dt), b2.to(dt))
    h2d = torch.randn((B * T * U1, J), device="cuda").to(dt)
    return args, lambda: torch.mm(h2d, args[4])


def _planes_split(lib, args):
    """A timed build's per-block phase split of one launch, in ms: block
    0's row, the heaviest block's and each phase's maximum over blocks."""
    names = ENTRY["planes"][3]
    lib.planes_phases(None, 1)
    planes_cuda.launch(lib, *args)
    torch.cuda.synchronize()
    rows = lib.planes_phase_rows()
    n = lib.planes_phase_count()
    buf = (ctypes.c_ulonglong * (rows * n))()
    lib.planes_phases(buf, 0)
    ns = [[buf[r * n + i] for i in range(n)] for r in range(rows)]
    heavy = max(range(rows), key=lambda r: sum(ns[r]))

    def ms(row):
        return {k: v / 1e6 for k, v in zip(names, row)}
    return {"block0": ms(ns[0]), f"heaviest (block {heavy})": ms(ns[heavy]),
            "max": ms([max(r[i] for r in ns) for i in range(n)]),
            "blocks": rows}


def _median_ms(fn, reps, ahead=False):
    """Median CUDA-event ms of fn().  With `ahead` a ~1 ms spin kernel is
    queued first, so the host has enqueued fn's launches before the card
    reaches them: the device time of a launch shorter than its host call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _inputs(kernel, B, T, seed=0):
    """The kernel's arguments, and cuDNN's forward on the same widths: in
    training mode for K4, under no_grad from the same carried state for K2
    (None for K5)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(shape, scale):
        return (torch.rand(shape, generator=g, device="cuda") - 0.5) * scale

    dt = torch.bfloat16
    fwd = (rand((T, B, 4 * H), 4.0).to(dt), rand((P, 4 * H), 0.05).to(dt),
           rand((H, P), 0.1).to(dt), rand((4 * H,), 1.0).to(dt),
           torch.zeros((B, P), dtype=dt, device="cuda"),
           torch.zeros((B, H), device="cuda"))
    if kernel in ("fwd", "infer"):
        ref = torch.nn.LSTM(F_IN, H, proj_size=P).to("cuda", dt)
        ref.flatten_parameters()  # as a cuDNN user would (`.to()` does not)
        x = rand((T, B, F_IN), 2.0).to(dt)
        if kernel == "fwd":
            x.requires_grad_()
            return fwd, lambda: ref(x)[0]
        # K2 with a nonzero carried state, as in streaming
        fwd = fwd[:4] + (rand((B, P), 0.5).to(dt), rand((B, H), 0.5))
        state = (fwd[4][None], fwd[5].to(dt)[None])

        def infer():
            with torch.no_grad():
                return ref(x, state)[0]
        return fwd, infer
    _, z, c, _ = lstm_cuda.lstm_fwd_plain(*fwd)
    return (z, c, fwd[5], rand((T, B, P), 1.0).to(dt),
            fwd[1].t().contiguous(), fwd[2].t().contiguous()), None


def _rel_err(got, want):
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))
               for a, b in zip(got, want))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sources", nargs="+")
    p.add_argument("--kernel", choices=tuple(ENTRY), default="bwd")
    p.add_argument("--batch", type=int, nargs="+", default=[32, 96])
    p.add_argument("--steps", type=int, default=None,
                   help="T (default 256; T' = 128 for --kernel planes)")
    p.add_argument("--shape", nargs="+", default=None,
                   help="BxT pairs (default: --batch x --steps; for "
                   "--kernel infer 1x512 1x2 1x1 32x256)")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--labels", type=int, default=65,
                   help="U+1 (lattice, planes)")
    p.add_argument("--samples", type=int, nargs="+", default=[240000, 1360],
                   help="audio lengths (frontend)")
    p.add_argument("--ptxas", action="store_true")
    a = p.parse_args(argv)
    if a.steps is None:
        a.steps = 128 if a.kernel == "planes" else 256
    if not torch.cuda.is_available():
        print("lstm_ab: CUDA is not available", file=sys.stderr)
        return 2
    libs = _build_all(a.sources, a.kernel, a.ptxas)
    if a.kernel == "frontend":
        _frontend_main(a, libs)
        print(_smi_line())
        return 0
    if a.kernel == "planes":
        libs = {s: (lib, lib) for s, (lib, _) in libs.items()}
    launch = {"infer": _launch_infer, "fwd": _launch_fwd, "bwd": _launch_bwd,
              "lattice": _launch_lattice,
              "planes": lambda lib, args: planes_cuda.launch(lib, *args)
              }[a.kernel]
    _, _, phases_fn, names = ENTRY[a.kernel]
    if a.shape:
        shapes = [tuple(int(v) for v in s.split("x")) for s in a.shape]
    elif a.kernel == "infer":
        shapes = INFER_SHAPES
    else:
        shapes = [(B, a.steps) for B in a.batch]
    plain = {"infer": lstm_cuda.lstm_seq_infer_plain,
             "fwd": lstm_cuda.lstm_fwd_plain, "bwd": lstm_cuda.lstm_bwd_plain}
    for B, T in shapes:
        if a.kernel == "lattice":
            args, cudnn = _lattice_inputs(B, T, a.labels), None
            check = lambda got: _lattice_err(got, args)  # noqa: E731
        elif a.kernel == "planes":
            args, cudnn = _planes_inputs(B, T, a.labels)
            want = planes_cuda.joint_planes_plain(*args)
            check = lambda got: _rel_err(got, want)  # noqa: E731
        else:
            args, cudnn = _inputs(a.kernel, B, T)
            want = plain[a.kernel](*args)
            check = lambda got: _rel_err(got, want)  # noqa: E731
        rel, design = {}, {}
        for s, (lib, fn) in libs.items():
            rel[s] = check(launch(fn, args))
            if hasattr(lib, "lstm_last_design"):
                design[s] = DESIGNS[lib.lstm_last_design()]
                if design[s] == "cluster":  # with its cluster size
                    design[s] += str(lib.lstm_last_cluster())
            if hasattr(lib, "planes_last_design"):
                design[s] = planes_cuda.DESIGNS[lib.planes_last_design()]
            if hasattr(lib, "lattice_last_design"):
                design[s] = lattice_cuda.DESIGNS[lib.lattice_last_design()]
        runs = {s: (lambda fn=fn: launch(fn, args))
                for s, (_, fn) in libs.items()}
        if cudnn is not None:
            runs["cublas" if a.kernel == "planes" else "cudnn"] = cudnn
        if a.kernel == "planes":
            runs.update({f"{s} pack_w2": (
                lambda lib=lib: planes_cuda.pack_w2_cuda(args[4], lib))
                for s, (lib, _) in libs.items()
                if hasattr(lib, "planes_pack_w2")})
        order = list(runs)
        ms = {s: [] for s in order}
        reps = a.reps * (5 if T <= 2 else 1)  # short launches: more runs
        for s in order + order[::-1]:  # K7: shorter than its host call
            ms[s].append(_median_ms(runs[s], reps,
                                    ahead=a.kernel == "lattice"))
        phases = {}
        for s, (lib, fn) in libs.items():
            if a.kernel == "planes":
                if hasattr(lib, phases_fn):
                    phases[s] = _planes_split(lib, args)
            elif phases_fn and hasattr(lib, phases_fn):
                buf = (ctypes.c_ulonglong * 8)()
                getattr(lib, phases_fn)(buf, 1)
                launch(fn, args)
                torch.cuda.synchronize()
                getattr(lib, phases_fn)(buf, 0)
                own = getattr(lib, f"{phases_fn[:2]}_phase_names", None)
                if own is not None:  # the build names its own phases
                    own.restype = ctypes.c_char_p
                    names_s = own().decode().split(",")
                else:
                    names_s = names
                phases[s] = {n: buf[i] / T for i, n in enumerate(names_s)}
        shape = ({"U+1": a.labels, "dtype": "float32"} if a.kernel == "lattice"
                 else {"U+1": a.labels, "J": PLANES_J, "V": PLANES_V,
                       "dtype": "bfloat16"} if a.kernel == "planes"
                 else {"H": H, "P": P, "dtype": "bfloat16"})
        print(json.dumps({"kernel": a.kernel, "B": B, "T": T, **shape,
                          "ms": ms,
                          "rel_err": rel, "design": design,
                          ("phase_ms" if a.kernel == "planes" else
                           "block0_cycles_a_step"): phases}), flush=True)
    print(_smi_line())
    return 0


def _smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
