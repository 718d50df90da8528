#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (rnnt_tpu_torch) on one H100.

  python3 chip_smoke.py [--seed 0]

Drives the port's serving and training paths at the parity width
(RNNTConfig(): 8x2048/640 encoder, 2x2048 prediction net, joint 640, V=4096,
bf16 parameters, random weights from --seed) through the entry points a user
calls.  Random weights rarely predict blank, so every greedy request decodes
up to max_output_length (256 tokens): the decode times are those of that
worst case.

1. builds every CUDA kernel from rnnt_tpu_torch/csrc (one nvcc per source,
   in parallel);
2. writes a run directory in the JAX package's on-disk layout (config.json,
   a 4096-piece encoder.subwords, checkpoint_00000000/state.npz) and starts
   rnnt_tpu_torch.serve.Server on it (HTTP and TCP streaming), warmed up;
3. drives the serving and training paths, each with every kernel's
   launch count set to 0 just before it and read just after: POSTs of
   WAVs of 2 s, 5 s and 15 s (the 128-, 256- and 512-frame buckets)
   decoded greedily, the same WAVs with
   ?beam=4 (one beam-kernel launch a request, every one running the
   streamed advance), a TCP streaming session of
   the 5 s WAV in 1024-sample frames, then training through
   rnnt_tpu_torch.cli.run_rnnt on synthetic .rnr shards written by the
   port's writer (random-normal 240-wide features, 200-256 frames, 40-64
   labels): `train_cli`, 3 steps at batch 32 in bf16 with the fused loss and
   one eval batch of the dev split, and `train_pallas_loss`, one step with
   --loss_impl pallas (materialised logits, the lattice kernel); each run
   must log finite losses and an eval line and leave a checkpoint that the
   port's restore reads back at its step, and launch per train step the
   LSTM forward (K4, every launch its MMA design) and backward (K5) 10
   times each, the lattice (K7, every launch its warp design) once
   and, fused, the plane kernel (K6, every launch its WGMMA design) once;
   it prints each request's latency
   split into frontend, encoder and decode with its launches, and each
   stream chunk's reply latency (p50, p99, max); then the measurement
   entry points, each a path of its own, called in this process as
   main(argv) on the card with stdout and stderr captured and printed:
   `bench_train`, rnnt_tpu_torch.bench (bench.py's geometry, a warm-up and
   10 timed steps: its one JSON line, a finite positive value, K4 and K5
   10 launches a step, every K6 launch WGMMA and every K7 launch warp);
   `bench_loss`, cli.bench_loss --B 8 --iters 3 (ref, pallas, fused; the
   fused line's TFLOP/s; K6 and K7 launched); `bench_decode`,
   cli.bench_decode --batch 8 --frames 128 --reps 2 (its four rows; one K3
   launch a search of the two cuda rows, none by the plain row; after the
   path, K3 on the same inputs at E=1 and E=6, where N = 32 hypothesis
   rows must run the FMA design, held against the plain search by the
   beam gate below at the bf16 tolerance);
   `bench_streaming_latency`, cli.bench_streaming --chunks 40 (K1 and K2);
   `bench_streaming_wer`, cli.bench_streaming against the run directory
   and three WAVs of 2-3 s with their trans.txt in LibriSpeech layout (3
   utterances, both WERs finite); `bench_serve`, cli.bench_serve on the run
   directory with --requests 8 --concurrency 2 (every line printed, K1, K2
   and K3 launched, no server thread left running); each must return 0;
4. holds each kernel against its plain PyTorch version on the card at the
   request shapes: the frontend (K1) in fp32, max |d log-mel| <= 2e-4 at
   each request's audio, at every chunk length of the TCP stream, at 8 kHz
   with 40 mel bins and at a frame length equal to nfft, input untouched; the
   LSTM (K2) for random inputs with a nonzero carried state at B=1 (T=1, 2,
   512), B=5 (T=7), B=8 and 9 (LAT's threshold and one above, T=7) and
   B=32 (T=64), also at 114 blocks and at H=3072, P=768 (fp32 <= 1e-4,
   bf16 <= 2e-2 relative error, inputs left untouched, each case running
   the design it must: fp32 FMA, bf16 LAT up to B=8, above it MMA, and
   FMA at H=3072), and for the whole encoder in fp32 (<= 1e-4) and bf16 (<=
   2e-2); every bf16 K2 launch of the greedy, beam, TCP and train_cli paths
   must have run a resident-weight design (LAT or MMA); fp32 greedy
   argmaxes are identical at every joint step up to any step whose top-2
   logit margin on the plain path is below 1e-4; the beam search (K3) at
   each request's encoder output, a B=3 batch at the 128 bucket, the 5 s
   request with a sharpened joint and the 15 s one capped at 8 tokens
   (which it must reach, with merges), in fp32 and in bf16: scores finite
   and sorted, lengths within the cap, token ids in [1, V), every live
   score within 1e-4 (fp32) or 1e-2 (bf16) relative error, the two
   searches' picks identical at every selection up to the first near tie
   (a gap below 1e-4 plus twice the score drift so far), slot-0 tokens and
   lengths identical unless such a tie precedes; every bf16 case runs the
   streamed advance (B=1, and B=3: two n8 tiles) and every fp32 case the
   FMA design; the bf16 gate must reject a control (the kernel reading W2
   with the halves of its 16-byte groups swapped); after an in-place
   perturbation of layer 0's Wh the bf16 5 s sharp-joint search repacks
   and holds to the plain search on the perturbed weights, which reject the
   unperturbed run (a stale copy); the fp32 stream through the kernels and
   through the plain
   versions, greedy argmaxes identical up to a near tie (margin < 1e-4);
   and at the train shapes: K4 (h, z, c, c_fin) and K5 (dz, dh_total, dh0,
   dc0, fed the same residuals) at B=32 (T=256, 128 and 65), B=96 (T=256),
   B=20 (T=128) and B=8, 40 and 160 (T=65), relative error <= 1e-4 in fp32
   and <= 2e-2 in bf16, inputs untouched; the same with the grid capped at
   114 blocks (B=32 and 96, T=65), where bf16 K4 must run its MMA design
   and bf16 K5 its FMA design, and at B=32, T=64 for the wide H=3072,
   P=768 (K4 and K5; bf16 K5 must run FMA) and H=4096, P=1024 (K4; bf16
   FMA); K6 (denom, blank,
   emit) at B=32, T'=128, U+1=65, <= 1e-4 in fp32 (FMA) and <=
   PLANES_BF16_TOL in bf16 (WGMMA), in bf16 also at B=96 (WGMMA), at a
   ragged B=3, T'=7, U+1=5, J=40, V=300 (WGMMA; fp32 FMA) and at J=1024
   (outside the WGMMA plan: WMMA), inputs untouched, its W2 pack kernel
   equal to `pack_w2`, and after an in-place change of W2 the next call
   held to the new W2's plain planes, which reject the old call's; K7
   (alpha and beta over the valid cells, ll) from those planes at B=32 and
   B=96 (the planes three times over) with ragged lengths, on its warp
   design, and from random planes at U+1 = 1 (warp), 257, 1025 and 1537 (the
   block design; runs of positions a thread above 1024), <= 1e-5, inputs
   untouched; and one whole fp32 train step at the parity width (B=32,
   T=256, U=64) through K4-K7 on the card against the same step on the CPU
   (every wrapper's plain version): loss <= 1e-4 and every gradient <= 1e-3
   relative error;
5. profiles each request's encoder, greedy decode and beam decode with
   torch.profiler: wall time and device busy time on the profiler's one
   clock (the wall between two marker kernels launched just before and
   after the run, busy the union of the run's device records, every one of
   which must lie between the markers; the CUDA-event wall is printed
   beside), device ops, and the idle share 1 - busy / wall from that same
   run (a profiled run whose records miss a marker or a launch of the
   profiled kernel is repeated, at most 3 runs); and profiles one train
   step at bench.py's geometry (rnnt_tpu_torch.bench.setup: B=96, T=256,
   U=64, bf16, fused, weights and batch from --seed; after one warm-up
   step), printed beside the
   bench_train path's audio-s/s, step ms and peak memory: its idle share
   and device time by kernel, every K6 launch of it on the WGMMA design and
   every K7 launch on the warp design;
6. prints a `kernels` JSON line for K1-K7 (launches on the driven paths,
   median kernel time, plain and library times, the roofline bound, max
   error; for K1 and K7 the device time with a spin kernel queued ahead,
   since their launches are shorter than their host calls, for K1 also at a
   7-frame stream chunk, the wrapper's host-bound call time and the plain
   version's op chain as `composite_ms`, for K7 also at B=96 and at the
   edge widths; for K2, K4 and K5 the cuDNN yardstick's median, minimum and
   maximum of 30 runs and the launches by design, for K2 also the time of
   a one-step launch and at B=32, T=256 and each case's design, for K4 and
   K5 also the time at B=96; for K6 the time, bound and cuBLAS product
   at B=96, the W2 packing's own time and the launches by design; for K3
   also the
   weight traffic of re-reading the weights at every product, and its time
   split over the phases of a search from the timed build: block 0's, the
   heaviest block's and each phase's maximum over blocks), the card's
   name and power limit, and last the line
   {"ok": true, "device": {"platform": "gpu", ...}}.

Any failed check raises, so the exit code is non-zero.  Without a CUDA card,
or without the repository beside it, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import io
import json
import os
import shutil
import socket
import statistics
import struct
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, ".smoke_run")  # listed in .gitignore
TRAIN_DIR = os.path.join(REPO, ".smoke_train")  # shards and runs; ignored
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12      # CUDA cores, fp32
PEAK_BF16_FLOPS = 989e12     # tensor cores, dense bf16
REQUEST_SECONDS = (2.0, 5.0, 15.0)
BEAM, MAX_TOKENS = 4, 256  # the served beam width and max_output_length


def log(*a):
    print(*a, flush=True)


def cuda_times(fn, reps: int, warmup: int = 2) -> list:
    """Milliseconds of each of `reps` runs of fn() on the card (CUDA events,
    after warm-up)."""
    import torch

    for _ in range(warmup):
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
    return times


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card."""
    return statistics.median(cuda_times(fn, reps, warmup))


def require(ok, what) -> None:
    """A check of the smoke test: raises (exit code 1) when it fails."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def plain_lstm():
    """Route every ProjLSTM call to the plain PyTorch recurrence (the
    comparison path; the port itself never does this on the card)."""
    from rnnt_tpu_torch.ops import lstm_cuda

    kernel = lstm_cuda.lstm_seq_infer
    lstm_cuda.lstm_seq_infer = lstm_cuda.lstm_seq_infer_plain
    try:
        yield
    finally:
        lstm_cuda.lstm_seq_infer = kernel


@contextlib.contextmanager
def plain_frontend():
    """Route the log-mel frontend to its plain version (comparison only)."""
    from rnnt_tpu_torch.ops import features as F
    from rnnt_tpu_torch.ops import features_cuda

    kernel = features_cuda.log_mel_frontend
    features_cuda.log_mel_frontend = lambda audio, cfg: F.log_mel_plain(
        audio, cfg)
    try:
        yield
    finally:
        features_cuda.log_mel_frontend = kernel


def kernel_wrappers():
    """Each kernel's wrapper by its name in the kernels line."""
    from rnnt_tpu_torch.ops import (beam_cuda, features_cuda, lattice_cuda,
                                    lstm_cuda, planes_cuda)

    return {"log_mel_frontend": features_cuda.log_mel_frontend,
            "lstm_seq_infer": lstm_cuda.lstm_seq_infer,
            "beam_search": beam_cuda.beam_search,
            "lstm_fwd": lstm_cuda.lstm_fwd,
            "lstm_bwd": lstm_cuda.lstm_bwd,
            "joint_planes": planes_cuda.joint_planes,
            "lattice_scan": lattice_cuda.lattice_scan}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_design"):
            fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def read_designs() -> dict:
    """Launches by design: the LSTM kernels' ("lat", "mma", "fma"), the
    beam kernel's ("stream", "fma"), the plane kernel's ("wgmma", "wmma",
    "fma") and the lattice kernel's ("warp", "block")."""
    w = kernel_wrappers()
    return {name: dict(w[name].launches_by_design)
            for name in ("lstm_seq_infer", "lstm_fwd", "lstm_bwd",
                         "beam_search", "joint_planes", "lattice_scan")}


def require_resident_k2(name, launches) -> None:
    """Every bf16 K2 launch of a driven path at the parity width ran a
    resident-weight design (LAT or MMA), none the FMA one."""
    d = launches["lstm_seq_infer_by_design"]
    require(d["fma"] == 0 and d["lat"] + d["mma"] == launches[
        "lstm_seq_infer"], f"path {name}: K2 launches by design {d}")


def require_streamed_k3(name, launches) -> None:
    """Every bf16 K3 launch of a driven path at the parity width ran the
    streamed advance, none the FMA design."""
    d = launches["beam_search_by_design"]
    require(d["fma"] == 0 and d["stream"] == launches["beam_search"],
            f"path {name}: K3 launches by design {d}")


def synthetic_pieces(n: int):
    """A deterministic n-piece subword vocabulary (blank, characters,
    word-start pieces, then two- and three-letter pieces)."""
    from itertools import product

    from rnnt_tpu_torch.data.tokenizer import WORD_MARK

    letters = "abcdefghijklmnopqrstuvwxyz'"
    pieces = [""] + list(letters) + [WORD_MARK] + [WORD_MARK + c
                                                   for c in letters]
    for k in (2, 3):
        pieces += ["".join(p) for p in product(letters, repeat=k)]
    return pieces[:n]


def write_run_dir(model, cfg, path: str) -> None:
    """config.json, encoder.subwords and checkpoint_00000000/state.npz in
    the JAX package's layout: a whole train state at step 0 (leaf_0 the
    step, the parameters in jax.tree_util flatten order, then the zero
    optimizer state, fp32), which the server and a full restore both
    read."""
    from rnnt_tpu_torch.data.tokenizer import SubwordTokenizer
    from rnnt_tpu_torch.train.checkpoint import state_arrays
    from rnnt_tpu_torch.train.state import Optimizer

    shutil.rmtree(path, ignore_errors=True)
    cfg.save(path)
    SubwordTokenizer(synthetic_pieces(cfg.vocab_size)).save(path)
    leaves = state_arrays(0, model.state_dict(), Optimizer(cfg).init(model))
    os.makedirs(os.path.join(path, "checkpoint_00000000"))
    np.savez(os.path.join(path, "checkpoint_00000000", "state.npz"), **leaves)


def synthetic_audio(seconds: float, rng) -> np.ndarray:
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    audio = sum(0.2 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t
                             + rng.uniform(0, 6.3)) for _ in range(3))
    audio = audio * (0.5 + 0.5 * np.sin(2 * np.pi * 1.5 * t)) \
        + 0.02 * rng.standard_normal(n)
    return audio.astype(np.float32)


def wav_bytes(audio: np.ndarray) -> bytes:
    from rnnt_tpu_torch.data.audio_io import write_wav

    buf = io.BytesIO()
    write_wav(buf, audio, 16000)
    return buf.getvalue()


def device_ms(fn, reps: int) -> float:
    """Median device ms of fn() for a launch shorter than its host call: a
    spin kernel queued ahead of each run keeps the card busy while the host
    enqueues fn's launches, so the CUDA events time the card's work alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # ~1 ms
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_chunk_samples(cfg, n_samples, chunk=1024):
    """The audio lengths the frontend gets from a stream of `chunk`-sample
    frames (decode/streaming.py's framing: whole frames of the carried
    remainder and the new samples; priming left out)."""
    L, hop = cfg.frame_length_samples, cfg.frame_step_samples
    rem, lengths = 0, []
    for _ in range(n_samples // chunk):
        buf = rem + chunk
        n = max(0, 1 + (buf - L) // hop)
        if n:
            lengths.append(n * hop + L - hop)
            rem = buf - n * hop
        else:
            rem = buf
    return sorted(set(lengths))


def check_frontend(cfg, audios):
    """K1 vs its plain version on the card, max |d log-mel| <= 2e-4 after
    mean subtraction, input untouched: at each request's audio (the greedy
    and beam paths' launches), at every chunk length of the TCP stream of
    the 5 s WAV in 1024-sample frames (the stream path's launches), and at
    two other geometries: 8 kHz with 40 mel bins (nfft 256) and a frame
    length equal to nfft (32 ms, 512 samples).  Times (device time, a spin
    queued ahead) at the 15 s request and at the stream's 7-frame chunk,
    beside the plain version and the plain version's op chain
    (`kernels.lstm_ab.composite_frontend`)."""
    import torch

    from rnnt_tpu_torch.kernels.lstm_ab import composite_frontend
    from rnnt_tpu_torch.ops import features as F
    from rnnt_tpu_torch.ops.features_cuda import fft_tables, log_mel_frontend

    rng = np.random.default_rng(1)
    cases = [(f"{a.shape[0]} samples", cfg, a) for a in audios]
    cases += [(f"stream chunk, {n} samples", cfg, audios[1][:n])
              for n in stream_chunk_samples(cfg, audios[1].shape[0])]
    for over in (dict(sample_rate=8000, mel_bins=40),
                 dict(frame_length=0.032)):
        c = cfg.replace(**over)
        a = synthetic_audio(2.0, rng)[: 2 * c.sample_rate]
        cases.append((f"{over}, {a.shape[0]} samples", c, a))
    errs = {}
    for what, c, audio in cases:
        a = torch.from_numpy(audio).cuda()
        kept = a.clone()
        got = F.subtract_mean(log_mel_frontend(a, c))
        want = F.subtract_mean(F.log_mel_plain(a, c))
        require(torch.equal(a, kept), "K1 wrote into its input")
        require(got.shape == want.shape, (got.shape, want.shape))
        err = float((got - want).abs().max())
        log(f"K1 frontend {what} -> {tuple(got.shape)}: max |d log-mel| "
            f"{err:.3e}")
        require(err <= 2e-4, f"frontend kernel disagrees at {what}: {err}")
        errs[what] = err
    # timing at the longest request and at a 7-frame stream chunk
    a = torch.from_numpy(audios[-1]).cuda()
    chunk = torch.from_numpy(audios[1][:6 * cfg.frame_step_samples
                                       + cfg.frame_length_samples]).cuda()
    n_frames = F.num_frames(a.shape[0], cfg)
    L = cfg.frame_length_samples
    nfft = F.next_pow2(L)
    K = nfft // 2 + 1
    M = cfg.mel_bins
    mel_nnz = fft_tables(cfg).mel_w.shape[0]
    # the function's least work a frame: window, real FFT (2.5 N log2 N),
    # magnitude, the sparse mel filters, log
    flops = n_frames * (L + 2.5 * nfft * np.log2(nfft) + 4 * K
                        + 2 * mel_nnz + M)
    nbytes = 4.0 * (a.shape[0] + n_frames * M)  # audio in, log-mel out
    t_flops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {
        "name": "log_mel_frontend",
        "route": "cuda",
        "source": "rnnt_tpu_torch/csrc/frontend.cu",
        "replaces": "rnnt_tpu/ops/features_pallas.py:81",
        "max_abs_err": max(errs.values()),
        "ms": device_ms(lambda: log_mel_frontend(a, cfg), reps=50),
        "plain_ms": cuda_ms(lambda: F.log_mel_plain(a, cfg), reps=20),
        "bound_ms": max(t_flops, t_bytes) * 1e3,
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        "library_ms": None,
        "composite_ms": device_ms(composite_frontend(a, cfg), reps=20),
        "call_ms": cuda_ms(lambda: log_mel_frontend(a, cfg), reps=50),
        "shape": f"audio [{a.shape[0]}] -> [{n_frames},{M}] f32",
        "ms_chunk": device_ms(lambda: log_mel_frontend(chunk, cfg), reps=50),
        "composite_ms_chunk": device_ms(composite_frontend(chunk, cfg),
                                        reps=20),
        "shape_chunk": f"audio [{chunk.shape[0]}] -> "
                       f"[{F.num_frames(chunk.shape[0], cfg)},{M}] f32",
        "max_abs_err_by_case": errs,
    }


def cudnn_proj_lstm(lstm, x):
    """torch.nn.LSTM(proj_size=P) (cuDNN) holding the same weights, for the
    library time only: its gate order i,f,g,o is permuted from i,g,f,o."""
    import torch

    F_in, H4 = lstm.wx.shape
    H, P = lstm.wp.shape
    ref = torch.nn.LSTM(F_in, H, proj_size=P).to(x.device, lstm.wh.dtype)
    perm = torch.cat([torch.arange(0, H), torch.arange(2 * H, 3 * H),
                      torch.arange(H, 2 * H), torch.arange(3 * H, 4 * H)])
    with torch.no_grad():
        ref.weight_ih_l0.copy_(lstm.wx.t()[perm])
        ref.weight_hh_l0.copy_(lstm.wh.t()[perm])
        ref.bias_ih_l0.copy_(lstm.bias[perm])
        ref.bias_hh_l0.zero_()
        ref.weight_hr_l0.copy_(lstm.wp.t())
    ref.flatten_parameters()  # as a cuDNN user would (`.to()` does not)
    return ref


def library_runs(fn, what, reps=30):
    """A library yardstick's times: median, minimum and maximum of `reps`
    runs (its time varies by up to ~2x between runs of one call)."""
    times = cuda_times(fn, reps, warmup=3)
    runs = {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times)}
    log(f"{what}, {reps} runs: "
        + ", ".join(f"{k} {v:.3f}" for k, v in runs.items()))
    return runs


LAT_MAX_B = 8  # K2's LAT design takes B <= 8 (csrc/lstm_infer.cu)
# (B, T) of K2's cases: a prediction-net step, a stream chunk, a 512-frame
# layer call, two FMA passes, LAT's threshold and one above it, eval's B=32
K2_CASES = ((1, 1), (1, 2), (1, 512), (5, 7), (LAT_MAX_B, 7),
            (LAT_MAX_B + 1, 7), (32, 64))


def k2_design(dt, B, H, P, blocks) -> str:
    """The design K2 must run: fp32 always FMA; bf16 at the parity width
    on 114 or 132 blocks LAT up to LAT_MAX_B rows, MMA above; bf16 at
    H=3072, P=768 FMA (LAT's Wh slice and partial tiles, or MMA's Wh slice
    and ring, exceed 227 KB)."""
    import torch

    if dt == torch.float32 or (H, P) != (2048, 640) or blocks < 114:
        return "fma"
    return "lat" if B <= LAT_MAX_B else "mma"


def check_lstm_cases(H: int, P: int) -> dict:
    """K2 vs its plain version on random inputs with a nonzero carried
    state, in both weight dtypes (relative error <= 1e-4 in fp32, <= 2e-2
    in bf16, inputs untouched): every K2_CASES shape at the parity width on
    one block per SM, B=1 T=64, B=9 T=7 and B=32 T=64 with the grid capped
    at CAP_BLOCKS, and B=1 and 9 at T=7 for H=3072, P=768.  Each case must
    run the design k2_design names.  Returns {case: design}."""
    import torch

    from rnnt_tpu_torch.ops import lstm_cuda

    rand = lstm_rand("cuda", 1)
    cases = [(H, P, B, T, 0) for B, T in K2_CASES]
    cases += [(H, P, B, T, CAP_BLOCKS)
              for B, T in ((1, 64), (LAT_MAX_B + 1, 7), (32, 64))]
    cases += [(3072, 768, B, 7, 0) for B in (1, LAT_MAX_B + 1)]
    seen = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for Hc, Pc, B, T, cap in cases:
            args = (rand((T, B, 4 * Hc), 4.0).to(dt),
                    rand((Pc, 4 * Hc), 0.05).to(dt), rand((Hc, Pc), 0.1).to(dt),
                    rand((4 * Hc,), 1.0).to(dt), rand((B, Pc), 0.5).to(dt),
                    rand((B, Hc), 0.5))
            before = [a.clone() for a in args]
            counts = dict(lstm_cuda.lstm_seq_infer.launches_by_design)
            lstm_cuda.set_block_cap(cap)
            try:
                h_k, c_k = lstm_cuda.lstm_seq_infer(*args)
            finally:
                lstm_cuda.set_block_cap(0)
            h_p, c_p = lstm_cuda.lstm_seq_infer_plain(*args)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(args, before)),
                    "LSTM kernel wrote into its inputs")
            design = next(d for d, n in
                          lstm_cuda.lstm_seq_infer.launches_by_design.items()
                          if n > counts[d])
            blocks = cap or torch.cuda.get_device_properties(
                0).multi_processor_count
            case = (f"H={Hc} P={Pc} B={B} T={T} {blocks} blocks "
                    f"{str(dt)[6:]}")
            seen[case] = design
            err = max(rel_err(h_k, h_p), rel_err(c_k, c_p))
            log(f"K2 lstm {case} with state ({design}): rel err {err:.3e}")
            require(err <= tol, f"LSTM kernel disagrees: {err}")
            want = k2_design(dt, B, Hc, Pc, blocks)
            require(design == want, f"K2 {case} ran {design}, want {want}")
    return seen


def check_lstm_layer(model, mel_p):
    """K2's times and bound for one encoder layer call at the request shape
    (layer 0 of the 512-frame bucket, B=1, bf16), and its max |d h| from the
    plain version; the bf16 accuracy gate is the whole encoder's."""
    import torch

    from rnnt_tpu_torch.models.lstm import matmul_to
    from rnnt_tpu_torch.ops import lstm_cuda

    lstm = model.encoder.layers[0].lstm
    dt = lstm.wh.dtype
    x = model.encoder.bn(mel_p)
    B, T, F_in = x.shape
    H, P = lstm.wp.shape
    xp = matmul_to(x.reshape(B * T, F_in), lstm.wx, dt).reshape(B, T, -1)
    xp = xp.transpose(0, 1).contiguous()
    c0, h0 = lstm.zero_state(B)
    args = (xp, lstm.wh, lstm.wp, lstm.bias, h0, c0)
    h_k, c_k = lstm_cuda.lstm_seq_infer(*args)
    h_p, c_p = lstm_cuda.lstm_seq_infer_plain(*args)
    torch.cuda.synchronize()
    err_h, err_c = rel_err(h_k, h_p), rel_err(c_k, c_p)
    max_abs = float((h_k.float() - h_p.float()).abs().max())
    log(f"K2 lstm layer xp {tuple(xp.shape)} {dt}: rel err h {err_h:.3e} "
        f"c {err_c:.3e}, max |d h| {max_abs:.3e}")
    esize = torch.finfo(dt).bits // 8
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS
    # one step, as the prediction net runs it in greedy decoding
    step_args = (xp[:1],) + args[1:]
    step_ms = cuda_ms(lambda: lstm_cuda.lstm_seq_infer(*step_args), reps=50)
    # eval's batch (B=32, T=256, the layer's weights, random xp and state)
    rand = lstm_rand("cuda", 2)
    args32 = (rand((256, 32, 4 * H), 4.0).to(dt), lstm.wh, lstm.wp,
              lstm.bias, rand((32, P), 0.5).to(dt), rand((32, H), 0.5))
    ms32 = cuda_ms(lambda: lstm_cuda.lstm_seq_infer(*args32), reps=10)
    designs = {f"B={a[0].shape[1]} T={a[0].shape[0]}": k2_run_design(a)
               for a in (args, step_args, args32)}
    x_tb = x.transpose(0, 1).to(dt).contiguous()
    ref = cudnn_proj_lstm(lstm, x)  # the yardstick only; the port never uses it
    with torch.no_grad():
        lib = library_runs(lambda: ref(x_tb), f"cuDNN nn.LSTM(proj_size={P}) "
                           f"inference T={T} B={B} {str(dt)[6:]}")
    entry = {
        "name": "lstm_seq_infer",
        "route": "cuda",
        "source": "rnnt_tpu_torch/csrc/lstm_infer.cu",
        "replaces": "rnnt_tpu/ops/lstm_pallas.py:135",
        "max_abs_err": max_abs,
        "ms": cuda_ms(lambda: lstm_cuda.lstm_seq_infer(*args), reps=10),
        "plain_ms": cuda_ms(lambda: lstm_cuda.lstm_seq_infer_plain(*args),
                            reps=3, warmup=1),
        **bound_of(*k2_cost(T, B, H, P, esize), peak),
        "library_ms": lib["median_ms"],
        "library_runs_ms": lib,
        "shape": f"xp [{T},{B},{4 * H}] {str(dt)[6:]}, H={H} P={P}",
        "step_ms": step_ms,
        "ms_B32_T256": ms32,
        "bound_ms_B32_T256": bound_of(*k2_cost(256, 32, H, P, esize),
                                      peak)["bound_ms"],
        "design": designs,
    }
    log(f"K2 one-step launch (prediction-net shape): {step_ms:.4f} ms; "
        f"B=32 T=256 {ms32:.3f} ms; designs {json.dumps(designs)}")
    return entry


def k2_cost(T, B, H, P, esize):
    """(bytes, operations) of one K2 call: xp, the weights, bias and h0 in
    the weight type, c0 in fp32, read once; h_seq and c_fin written once."""
    nbytes = (esize * (T * B * 4 * H + P * 4 * H + H * P + 4 * H + B * P
                       + T * B * P) + 4 * 2 * B * H)
    return nbytes, 2.0 * T * B * (P * 4 * H + H * P)


def k2_run_design(args) -> str:
    """The design of one K2 launch on `args` (launches_by_design's diff)."""
    from rnnt_tpu_torch.ops import lstm_cuda

    counts = dict(lstm_cuda.lstm_seq_infer.launches_by_design)
    lstm_cuda.lstm_seq_infer(*args)
    return next(d for d, n in lstm_cuda.lstm_seq_infer.launches_by_design
                .items() if n > counts[d])


def check_encoder_and_greedy(model, mel_p, t, tol, exact_tokens):
    """The whole encoder and greedy decoding, kernel vs plain LSTM on the
    card.  Returns (encoder rel err, tokens agree)."""
    import torch

    from rnnt_tpu_torch.decode.greedy import (JointRecorder,
                                              greedy_decode_encoded)

    enc_len = model.encoded_length(torch.tensor([t], device=mel_p.device))

    def run():
        with JointRecorder(model) as rec:
            enc, _ = model.encode(mel_p)
            tok, n, _ = greedy_decode_encoded(model, enc, enc_len,
                                              max_output_length=256)
        return enc, tok[0, : int(n[0])].tolist(), rec

    with torch.no_grad():
        enc_k, tok_k, rec_k = run()
        with plain_lstm():
            enc_p, tok_p, rec_p = run()
    require(torch.isfinite(enc_k.float()).all(), "non-finite encoder output")
    err = rel_err(enc_k, enc_p)
    diverge = next((i for i, (a, b) in enumerate(zip(rec_k.ids, rec_p.ids))
                    if a != b), None)
    dt = str(model.dtype)[6:]
    msg = (f"{dt} encoder {tuple(enc_k.shape)} rel err {err:.3e}; greedy "
           f"{len(tok_k)} tokens, {len(rec_p.ids)} joint steps, min plain "
           f"margin {min(rec_p.margins):.3e}")
    if diverge is None:
        log(msg + "; tokens identical")
    else:
        log(msg + f"; first differing step {diverge} of {len(rec_p.ids)}, "
            f"plain margin there {rec_p.margins[diverge]:.3e}")
    require(err <= tol, f"{dt} encoder disagrees: rel err {err}")
    if exact_tokens and diverge is not None:
        require(rec_p.margins[diverge] < 1e-4,
                "greedy tokens differ at a step that is not a near tie")
    return err, diverge is None


def busy_ms(device_events) -> float:
    """Device busy time: the union of the ops' intervals (overlapping or
    repeated records count once)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events)
    total, cur_start, cur_end = 0.0, None, None
    for s, e in spans:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total / 1e3


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel; no profiled fn runs it
MARKER_CYCLES, OPENER_CYCLES = 1000, 400_000  # ~0.5 us and ~200 us spins
OPENERS = 64  # spins, 10 ms apart, that open a profiled session


def device_profile(fn, kernel, symbol, attempts=3, events=None):
    """Run fn() once without and then under torch.profiler.  Returns the
    host wall ms of the first run, and of the profiled run: its wall ms and
    device busy ms, both on the profiler's one clock, the CUDA-event wall
    ms (printed only), device ops, `kernel`'s launches and the number of
    profiled runs; `events`, a list, receives the accepted run's device ops.

    A marker kernel (a short `torch.cuda._sleep`, which fn() never launches)
    runs on the stream just before fn() and another just after it.  The wall
    is the time from the end of the first marker's device record to the
    start of the second's; busy is the union of fn()'s device records
    (`busy_ms`).  So busy <= wall compares one clock with itself, and the
    checks that keep it from being vacuous are that both markers are
    recorded and every other device record of the session lies between
    them: an op on another stream, or outside fn(), fails the run.

    The profiler has lost the first records of a session, a prefix that
    grew from 1 kernel (a beam decode) to 17 (the bench train step, the
    first 88 ms), markers among them.  So each session starts with OPENERS
    longer spins, one every 10 ms, and the first marker follows the last by
    10 ms.  A profiled run is accepted only when its records hold an opener
    (the losses seen were a prefix of the session, so none was lost after
    it), both markers and each launch of the kernel (device ops whose name
    contains `symbol`; with symbol None, a library call whose kernels have
    no fixed name, `kernel` must only have launched), and is repeated
    otherwise, at most `attempts` times.  The session is closed 10 ms after
    fn() ends."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(OPENERS):
                torch.cuda._sleep(OPENER_CYCLES)
                torch.cuda.synchronize()
                time.sleep(0.01)
            n0 = kernel.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(MARKER_CYCLES)
            start.record()
            fn()
            end.record()
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            event_wall_ms = start.elapsed_time(end)
            launches = kernel.launches - n0
            time.sleep(0.01)
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        spins = sorted((e for e in device if MARKER in e.name),
                       key=lambda e: e.time_range.start)
        # the openers are the longer spins; the markers last under 50 us
        markers = [e for e in spins
                   if e.time_range.end - e.time_range.start < 50]
        opened = len(spins) - len(markers)
        device = [e for e in device if MARKER not in e.name]
        recorded = (launches if symbol is None
                    else sum(symbol in e.name for e in device))
        if opened and len(markers) == 2 and launches > 0 and \
                recorded == launches:
            break
        edge = sorted(device + markers, key=lambda e: e.time_range.start)
        log(f"profiled run {attempt}: {len(device)} device ops, {opened} "
            f"of {OPENERS} openers, "
            f"{len(markers)} of 2 markers, {recorded} of {launches} {symbol} "
            f"launches recorded; spins " + ", ".join(
                f"{e.time_range.start:.1f}-{e.time_range.end:.1f}"
                for e in spins) + "; first and last records " + "; ".join(
                f"{e.name[:48]} {e.time_range.start:.1f}-"
                f"{e.time_range.end:.1f}" for e in edge[:3] + edge[-3:]))
    require(opened and len(markers) == 2, f"the profiler recorded {opened} "
            f"of {OPENERS} openers, {len(markers)} of 2 markers in {attempts} "
            f"runs")
    require(launches > 0 and recorded == launches,
            f"the profiler recorded {recorded} of {launches} {symbol} "
            f"launches in {attempts} runs")
    lo, hi = markers[0].time_range.end, markers[1].time_range.start
    outside = [e.name for e in device
               if e.time_range.start < lo or e.time_range.end > hi]
    require(not outside, f"{len(outside)} device records outside the "
            f"marker window, e.g. {outside[:3]}")
    wall_ms, busy = (hi - lo) / 1e3, busy_ms(device)
    if events is not None:
        events.extend(device)
    return plain_wall_ms, wall_ms, busy, event_wall_ms, len(device), \
        launches, attempt


def profile_request(model, mel_p, t, label):
    """Device ops and idle share of the encoder and of greedy decoding for
    one request (B=1, one stream).  Wall, busy time and launches all come
    from the one profiled run."""
    import torch

    from rnnt_tpu_torch.decode.greedy import greedy_decode_encoded
    from rnnt_tpu_torch.ops import lstm_cuda

    enc_len = model.encoded_length(torch.tensor([t], device=mel_p.device))
    with torch.no_grad():
        enc, _ = model.encode(mel_p)
        for phase, fn in (
                ("encoder", lambda: model.encode(mel_p)),
                ("decode", lambda: greedy_decode_encoded(
                    model, enc, enc_len, max_output_length=256))):
            plain_wall, wall, busy, event_wall, ops, launches, runs = \
                device_profile(fn, lstm_cuda.lstm_seq_infer,
                               "lstm_infer_lat_kernel")
            what = f"profile {label} {phase}"
            require(busy <= wall, f"{what}: device busy {busy} ms exceeds "
                    f"wall {wall} ms on one stream")
            # in decoding, each joint step advances the 2-layer prediction
            # net once, after one call that consumes the start token
            steps = launches // 2 - 1
            per = (f", {steps} joint steps, {ops / steps:.1f} device ops a "
                   f"step" if phase == "decode" else "")
            log(f"{what}: wall {wall:.2f} ms between the markers (CUDA "
                f"events {event_wall:.2f}, {plain_wall:.2f} without the "
                f"profiler), device busy {busy:.2f} ms ({ops} device "
                f"ops{per}), idle share {1 - busy / wall:.3f}, profiled "
                f"runs {runs}")


def post_requests(srv, audios, query=""):
    """POST each WAV to the running server.  Returns per-request records
    (latency split and each kernel's launches in that request)."""
    records = []
    for audio in audios:
        before = read_launches()
        conn = http.client.HTTPConnection("127.0.0.1", srv.http_port,
                                          timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/transcribe" + query, body=wav_bytes(audio))
        r = conn.getresponse()
        reply = json.loads(r.read())
        ms = (time.perf_counter() - t0) * 1e3
        conn.close()
        require(r.status == 200, reply)
        require(isinstance(reply["text"], str), reply)
        after = read_launches()
        rec = {"seconds": audio.shape[0] / 16000, "latency_ms": ms,
               **srv.service.last_timings,
               "launches": {k: after[k] - before[k] for k in after},
               "text_chars": len(reply["text"])}
        records.append(rec)
        log(f"request{query} " + json.dumps(rec))
        rec["text"] = reply["text"]  # kept for comparisons, not printed
    return records


def drive_path(name, fn, expect):
    """Run one path with every launch count set to 0 just before it and
    read just after; each kernel in `expect` must have launched.  Returns
    (fn's result, the path's launch counts)."""
    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    launches = read_launches()
    designs = read_designs()
    log(f"path {name}: {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps(launches)}, by design {json.dumps(designs)}")
    launches.update({f"{k}_by_design": v for k, v in designs.items()})
    for k in expect:
        require(launches[k] > 0, f"path {name}: {k} never launched")
    return out, launches


def start_server():
    from rnnt_tpu_torch.serve import Server

    t0 = time.perf_counter()
    srv = Server(RUN_DIR, http_port=0, stream_port=0, device="cuda",
                 warmup=True, warmup_beams=(0, BEAM))
    log(f"server up in {time.perf_counter() - t0:.1f} s (warmup "
        f"{srv.warmup_seconds:.1f} s, greedy and beam {BEAM} buckets and a "
        f"stream), dtype {srv.service.model.dtype}")
    srv.serve_background()
    return srv


def tcp_session(srv, audio, chunk=1024):
    """One streaming session over the TCP port: 1024-sample float32 frames,
    then the end frame.  Returns (final text, per-chunk reply ms)."""
    ms = []
    with socket.create_connection(("127.0.0.1", srv.stream_port),
                                  timeout=600) as conn:
        def exchange(payload):
            t0 = time.perf_counter()
            conn.sendall(struct.pack("<I", len(payload)) + payload)
            (m,) = struct.unpack("<I", conn.recv(4, socket.MSG_WAITALL))
            reply = json.loads(conn.recv(m, socket.MSG_WAITALL))
            ms.append((time.perf_counter() - t0) * 1e3)
            require("error" not in reply, reply)
            return reply

        for o in range(0, len(audio), chunk):
            require(not exchange(audio[o: o + chunk].astype("<f4")
                                 .tobytes())["final"], "final before the end")
        reply = exchange(b"")
    require(reply["final"] is True, reply)
    q = statistics.quantiles(ms[:-1], n=100, method="inclusive")
    log(f"stream {len(ms) - 1} chunks of {chunk} samples + flush: reply ms "
        f"p50 {statistics.median(ms[:-1]):.2f} p99 {q[98]:.2f} max "
        f"{max(ms[:-1]):.2f}, flush {ms[-1]:.2f}; final text "
        f"{len(reply['text'])} chars")
    return reply["text"], ms


def check_stream_kernels(model32, tokenizer, audio, chunk=1024):
    """The same stream in fp32 through the kernels (K1, K2) and through
    their plain versions: greedy argmaxes identical up to the first step
    whose top-2 margin on the plain path is below 1e-4."""
    from rnnt_tpu_torch.decode.greedy import JointRecorder
    from rnnt_tpu_torch.decode.streaming import StreamingTranscriber

    def run():
        st = StreamingTranscriber(model32, tokenizer)
        with JointRecorder(model32) as rec:
            for o in range(0, len(audio), chunk):
                st.process_chunk(audio[o: o + chunk])
            text = st.flush()
        return text, rec

    text_k, rec_k = run()
    with plain_lstm(), plain_frontend():
        text_p, rec_p = run()
    diverge = next((i for i, (a, b) in enumerate(zip(rec_k.ids, rec_p.ids))
                    if a != b), None)
    if diverge is None and len(rec_k.ids) != len(rec_p.ids):
        diverge = min(len(rec_k.ids), len(rec_p.ids))
    log(f"fp32 stream kernels vs plain: {len(rec_p.ids)} joint steps, text "
        f"{'identical' if text_k == text_p else 'differs'}, first differing "
        f"step {diverge}, min plain margin {min(rec_p.margins):.3e}")
    if diverge is not None:
        require(rec_p.margins[diverge] < 1e-4,
                "streamed tokens differ at a step that is not a near tie")


def beam_score_err(got, want):
    """(max |d score|, relative error, alive in the same places) over the
    beam scores alive in both (dead hypotheses score -1e30)."""
    live = (got > -1e29) & (want > -1e29)
    same_live = bool(((got > -1e29) == (want > -1e29)).all())
    if not bool(live.any()):
        return 0.0, 0.0, same_live
    d = (got - want).abs()[live]
    return float(d.max()), float(d.max() / want.abs()[live].max()), same_live


def beam_bound(model, enc, frames, K, E):
    """The beam search's least time (bytes over the memory rate, operations
    over the peak for their type) and the per-frame weight traffic of
    re-reading the weights at every product, from this run's shapes."""
    import torch

    cfg, dt = model.cfg, model.dtype
    B, _, P = enc.shape
    N, J, V, H = B * K, cfg.joint_size, cfg.vocab_size, cfg.pred_net_size
    esize = torch.finfo(dt).bits // 8
    layers = model.prediction.layers
    joint_w = sum(p.numel() for p in (model.joint.w1, model.joint.b1,
                                      model.joint.w2, model.joint.b2))
    layer_w = [sum(p.numel() for p in blk.parameters()) for blk in layers]
    weights = model.prediction.embed.numel() + joint_w + sum(layer_w)
    nbytes = esize * (weights + enc.numel()) + 4 * (B + B * MAX_TOKENS + B
                                                    + B * K)
    mm = 2 * B * P * J + (1 + E) * 2 * N * (P * J + J * V)
    for blk in layers:
        din = blk.lstm.wx.shape[0]
        mm += E * 2 * N * ((din + P) * 4 * H + H * P)
    elem = (1 + E) * N * V * 3  # logits' bias, exp and sum
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops = frames * (mm / peak + elem / PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    frame_bytes = esize * ((1 + E) * joint_w + E * sum(layer_w))
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "frame_weight_bytes": frame_bytes,
            "streamed_weight_ms": frames * frame_bytes / PEAK_BYTES_PER_S
            * 1e3}


@contextlib.contextmanager
def sharp_joint(*models, factor=8.0):
    """The models' joint output layer scaled by a power of two (exact in
    either dtype, and undone after): the beam search on random weights then
    emits a few tokens (with --seed 0 in fp32: 8 in the 5 s request's 125
    frames, 16 in the 15 s request's 250), so its label moves, token writes
    and merges carry real hypotheses at the parity width."""
    import torch

    with torch.no_grad():
        for m in models:
            m.joint.w2.mul_(factor)
        try:
            yield
        finally:
            for m in models:
                m.joint.w2.div_(factor)


@contextlib.contextmanager
def swapped_w2_halves(model):
    """The joint's W2 [J, V] with the two 4-column halves of every 8-column
    group swapped, as a bf16 kernel that unpacked its 16-byte weight loads
    in the wrong order would read it; undone after.  The control that the
    beam gate must reject."""
    import torch

    w2 = model.joint.w2
    J, V = w2.shape
    with torch.no_grad():
        orig = w2.clone()
        w2.copy_(w2.reshape(J, V // 8, 2, 4).flip(2).reshape(J, V))
        try:
            yield
        finally:
            w2.copy_(orig)


BEAM_SCORE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
NEAR_TIE = 1e-4


def gate_beam(got, trace, want, stats, enc_len, E, V, score_tol):
    """K3's result (tokens, lengths, scores) and trace against the plain
    search's on the same inputs.  Returns (failures, notes, max |d score|,
    relative score error); the kernel holds when there are no failures.

    - scores finite and sorted descending, lengths within the cap, token
      ids in [1, V);
    - every live score within `score_tol` relative error (to the largest
      live score), alive in the same places;
    - where the two searches first pick otherwise
      (`decode.beam.trace_divergence`), the plain selection's smallest gap
      is a near tie: below NEAR_TIE plus twice the drift, the largest score
      difference of a pick both searches made up to there (two candidates
      closer than that can trade places);
    - slot-0 tokens and lengths identical unless such a near tie precedes.
    """
    import torch

    from rnnt_tpu_torch.decode.beam import trace_divergence

    (tk, lk, sk), (tp, lp, sp) = got, want
    fails, notes = [], []
    if not bool(torch.isfinite(sk).all()):
        fails.append("non-finite scores")
    if not bool((sk[:, :-1] >= sk[:, 1:]).all()):
        fails.append("beam scores not sorted")
    if not bool(((lk >= 0) & (lk <= tk.shape[1])).all()):
        fails.append(f"lengths out of range: {lk.tolist()}")
    pos = torch.arange(tk.shape[1], device=tk.device)
    ids = tk[pos < lk[:, None].to(tk.device)]
    if not bool(((ids >= 1) & (ids < V)).all()):
        fails.append("token ids out of range")
    max_abs, rel, same_live = beam_score_err(sk, sp)
    if not same_live:
        fails.append("live scores in other places")
    if rel > score_tol:
        fails.append(f"score rel err {rel:.3e} > {score_tol:g}")
    for b, (first, drift) in enumerate(trace_divergence(trace, stats,
                                                        enc_len, E)):
        same = int(lk[b]) == int(lp[b]) and torch.equal(
            tk[b, : lk[b]].cpu(), tp[b, : lp[b]].cpu())
        if first is None:
            if not same:
                fails.append(f"utterance {b}: tokens differ though every "
                             "selection agreed")
            continue
        gap = float(stats["gap"][first, b])
        what = (f"utterance {b}: picks first differ at selection {first} "
                f"(frame {first // (2 * E)}, "
                f"{'pool' if first % 2 else 'labels'}), plain gap {gap:.3e}, "
                f"drift {drift:.3e}, tokens "
                f"{'identical' if same else 'differ'}")
        if gap < NEAR_TIE + 2 * drift:
            notes.append(what + ": a near tie")
        else:
            fails.append(what + ": not a near tie")
    return fails, notes, max_abs, rel


def check_beam(model32, served, cfg, cases):
    """K3 vs its plain version on the card for each case (label, mel_p,
    spec lengths, sharp joint?, length cap), in fp32 and in the served bf16,
    held by `gate_beam` (scores within 1e-4 relative error in fp32, 1e-2 in
    bf16); a case with a cap below MAX_TOKENS must reach it and merge.  The
    bf16 gate must reject a control: the kernel reading W2 with its 16-byte
    groups' halves swapped, on the last capped case.  Then K3's times,
    bound and phase split at the last uncapped B=1 case (the 512-frame
    bucket)."""
    import torch

    from rnnt_tpu_torch.decode.beam import (beam_search_encoded_plain,
                                            default_expansions)
    from rnnt_tpu_torch.ops import beam_cuda

    E = default_expansions(cfg)
    worst_bf16 = 0.0
    control = stale = None
    designs = {}
    for label, mel_p, lengths, sharp, cap in cases:
        kw = dict(beam_width=BEAM, max_output_length=cap,
                  expansions_per_frame=E)
        for model in (model32, served):
            ctx = sharp_joint(model) if sharp else contextlib.nullcontext()
            dt = str(model.dtype)[6:]
            with torch.no_grad(), ctx:
                enc, _ = model.encode(mel_p)
                enc_len = model.encoded_length(lengths.to(enc.device))
                trace, stats = {}, {}
                got = beam_cuda.beam_search(model, enc, enc_len, trace=trace,
                                            **kw)
                design = beam_cuda.beam_search.last_design
                want = beam_search_encoded_plain(model, enc, enc_len,
                                                 stats=stats, **kw)
                torch.cuda.synchronize()
            fails, notes, max_abs, rel = gate_beam(
                got, trace, want, stats, enc_len, E, cfg.vocab_size,
                BEAM_SCORE_TOL[dt])
            log(f"K3 beam {label} L={cap} {dt} enc {tuple(enc.shape)} "
                f"({design} design): "
                f"lengths {got[1].tolist()} (plain {want[1].tolist()}), "
                f"scores max |d| {max_abs:.3e} rel {rel:.3e}, merges "
                f"{stats['merges']}, {stats['idx'].shape[0]} selections "
                + ("identical" if not notes and not fails else
                   "; ".join(notes + fails)))
            require(not fails, f"beam kernel {label} {dt}: {fails}")
            # bf16 at B <= 4 is inside the streamed advance's plan, fp32
            # outside it
            must = "stream" if dt == "bfloat16" else "fma"
            require(design == must, f"beam kernel {label} {dt} ran the "
                    f"{design} design, not {must}")
            designs[f"{label} {dt}"] = design
            if model is served and sharp and cap == MAX_TOKENS:
                stale = (label, enc, enc_len, kw, got, trace)
            if dt == "bfloat16":
                worst_bf16 = max(worst_bf16, max_abs)
            if cap < MAX_TOKENS:
                require(bool((got[1] == cap).all() and (want[1] == cap).all()),
                        f"{label} {dt}: the length cap {cap} not reached")
                require(stats["merges"] > 0, f"{label} {dt}: no merge")
                if model is served:
                    control = (sharp, kw, enc, enc_len, want, stats, label)
    require(control is not None, "no capped case for the control")
    sharp, kw, enc, enc_len, want, stats, label = control
    ctx = sharp_joint(served) if sharp else contextlib.nullcontext()
    with torch.no_grad(), ctx, swapped_w2_halves(served):
        trace = {}
        got = beam_cuda.beam_search(served, enc, enc_len, trace=trace, **kw)
        fails, _, _, rel = gate_beam(got, trace, want, stats, enc_len, E,
                                     cfg.vocab_size,
                                     BEAM_SCORE_TOL["bfloat16"])
    log(f"K3 control ({label}, W2 halves swapped) bf16: lengths "
        f"{got[1].tolist()}, rel err {rel:.3e}, rejected by: {fails}")
    require(fails, "the bf16 beam gate let the swapped-W2 control through")
    check_beam_staleness(served, cfg, stale)
    # times, bound and phases at the 512-frame request in bf16
    _, mel_p, lengths, _, _ = [c for c in cases if c[1].shape[0] == 1
                               and c[4] == MAX_TOKENS][-1]
    kw = dict(beam_width=BEAM, max_output_length=MAX_TOKENS,
              expansions_per_frame=E)
    with torch.no_grad():
        enc, _ = served.encode(mel_p)
        enc_len = served.encoded_length(lengths.to(enc.device))
        frames = min(enc.shape[1], int(enc_len.max()))
        ms = cuda_ms(lambda: beam_cuda.beam_search(served, enc, enc_len, **kw),
                     reps=5)
        plain_ms = cuda_ms(lambda: beam_search_encoded_plain(
            served, enc, enc_len, **kw), reps=1, warmup=0)
        phase_ns = torch.zeros(
            (beam_cuda.grid_blocks(enc.device), len(beam_cuda.PHASES)),
            dtype=torch.int64, device=enc.device)
        beam_cuda.beam_search(served, enc, enc_len, phase_ns=phase_ns, **kw)
    torch.cuda.synchronize()
    split = beam_cuda.phase_split(phase_ns)
    log(f"K3 phases (ms) of block 0: {json.dumps(split['block0'])}; of the "
        f"heaviest block ({split['heaviest_block']}, the most time outside "
        f"the barrier wait): {json.dumps(split['heaviest'])}; maximum over "
        f"blocks: {json.dumps(split['max'])}")
    entry = {
        "name": "beam_search",
        "route": "cuda",
        "source": "rnnt_tpu_torch/csrc/beam_search.cu",
        "replaces": "rnnt_tpu/ops/beam_pallas.py:161",
        "max_abs_err": worst_bf16,
        "ms": ms,
        "plain_ms": plain_ms,
        **beam_bound(served, enc, frames, BEAM, E),
        "library_ms": None,
        "shape": f"enc [{enc.shape[1]},1,{enc.shape[2]}] "
                 f"{str(served.dtype)[6:]}, {frames} frames, K={BEAM} E={E} "
                 f"L={MAX_TOKENS}",
        "design_by_case": designs,
        "phase_ms_block0": split["block0"],
        "phase_ms_heaviest": split["heaviest"],
        "heaviest_block": split["heaviest_block"],
        "phase_ms_max": split["max"],
    }
    return entry


def check_beam_staleness(served, cfg, case):
    """The streamed advance's packed weights follow an in-place update:
    after a run of K3 on `case` (the bf16 sharp-joint request), layer 0's
    Wh gets uniform noise of its own Glorot scale in place; the next run
    must repack, hold to the plain search on the perturbed weights, and the
    first run's result (what a stale copy would give) must fail that gate.
    The weights are restored after."""
    import torch

    from rnnt_tpu_torch.decode.beam import (beam_search_encoded_plain,
                                            default_expansions)
    from rnnt_tpu_torch.ops import beam_cuda

    require(case is not None, "no bf16 sharp-joint case for the staleness "
            "check")
    label, enc, enc_len, kw, before, before_trace = case
    E = default_expansions(cfg)
    wh = served.prediction.layers[0].lstm.wh
    lim = (6.0 / (wh.shape[0] + wh.shape[1])) ** 0.5
    g = torch.Generator(device=wh.device).manual_seed(9)
    with torch.no_grad(), sharp_joint(served):
        orig = wh.clone()
        packed = beam_cuda.packed_slices(served, beam_cuda.grid_blocks(
            wh.device))
        try:
            wh.add_(((torch.rand(wh.shape, generator=g, device=wh.device)
                      * 2 - 1) * lim).to(wh.dtype))
            trace, stats = {}, {}
            got = beam_cuda.beam_search(served, enc, enc_len, trace=trace,
                                        **kw)
            design = beam_cuda.beam_search.last_design
            repacked = beam_cuda.packed_slices(
                served, beam_cuda.grid_blocks(wh.device)) is not packed
            want = beam_search_encoded_plain(served, enc, enc_len,
                                             stats=stats, **kw)
            torch.cuda.synchronize()
        finally:
            wh.copy_(orig)
    fails, notes, max_abs, rel = gate_beam(got, trace, want, stats, enc_len,
                                           E, cfg.vocab_size,
                                           BEAM_SCORE_TOL["bfloat16"])
    stale_fails, _, _, stale_rel = gate_beam(
        before, before_trace, want, stats, enc_len, E, cfg.vocab_size,
        BEAM_SCORE_TOL["bfloat16"])
    log(f"K3 staleness ({label}, layer 0 Wh perturbed in place) bf16 "
        f"({design} design, repacked {repacked}): scores max |d| "
        f"{max_abs:.3e} rel {rel:.3e} "
        + ("; ".join(notes + fails) if notes or fails else "identical")
        + f"; the unperturbed run against it: rel {stale_rel:.3e}, "
        f"rejected by {stale_fails}")
    require(design == "stream" and repacked,
            f"staleness: design {design}, repacked {repacked}")
    require(not fails, f"beam kernel after an in-place update: {fails}")
    require(stale_fails, "the perturbation did not change the search: the "
            "staleness check cannot tell a stale copy")


def profile_beam(served, mel_p, t, label):
    """Device ops and idle share of one beam decode (the search after the
    encoder), from one profiled run, beside greedy's."""
    import torch

    from rnnt_tpu_torch.decode.beam import default_expansions
    from rnnt_tpu_torch.ops import beam_cuda

    enc_len = served.encoded_length(torch.tensor([t], device=mel_p.device))
    with torch.no_grad():
        enc, _ = served.encode(mel_p)
        plain_wall, wall, busy, event_wall, ops, launches, runs = \
            device_profile(
                lambda: beam_cuda.beam_search(
                    served, enc, enc_len, beam_width=BEAM,
                    max_output_length=MAX_TOKENS,
                    expansions_per_frame=default_expansions(served.cfg)),
                beam_cuda.beam_search, "beam_kernel")
    what = f"profile {label} beam decode"
    require(launches == 1, f"{what}: {launches} beam launches")
    require(busy <= wall, f"{what}: busy {busy} ms exceeds wall {wall} ms")
    log(f"{what}: wall {wall:.2f} ms between the markers (CUDA events "
        f"{event_wall:.2f}, {plain_wall:.2f} without the profiler), device "
        f"busy {busy:.2f} ms ({ops} device ops, {launches} beam launch), "
        f"idle share {1 - busy / wall:.3f}, profiled runs {runs}")


# ---------------------------------------------------------------- training

TRAIN_BATCH, TRAIN_STEPS = 32, 3           # the train_cli path's run
PLANES_BF16_TOL = 1e-5  # K6 vs plain in bf16: ~100x the readings (PERF.md)
LATTICE_TOL = 1e-5      # K7 vs plain, fp32


def write_train_data(cfg, path, n_train, n_dev, seed):
    """Synthetic .rnr shards written by the port's writer: random-normal
    stacked mel features, 200-256 frames, 40-64 labels in [1, V); the
    config and a V-piece encoder.subwords beside them."""
    from rnnt_tpu_torch.data.records import write_shards
    from rnnt_tpu_torch.data.tokenizer import SubwordTokenizer

    rng = np.random.default_rng(seed)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    cfg.save(path)
    SubwordTokenizer(synthetic_pieces(cfg.vocab_size)).save(path)

    def examples(n):
        for _ in range(n):
            t, u = int(rng.integers(200, 257)), int(rng.integers(40, 65))
            labels = rng.integers(1, cfg.vocab_size, u).astype(np.int32)
            yield {"mel_specs": rng.standard_normal(
                       (t, cfg.input_feat_size)).astype(np.float32),
                   "pred_inp": np.concatenate([[0], labels]).astype(np.int32),
                   "labels": labels, "spec_lengths": np.int32(t),
                   "label_lengths": np.int32(u)}

    write_shards(examples(n_train), os.path.join(path, "train-{shard:05d}.rnr"),
                 2)
    write_shards(examples(n_dev), os.path.join(path, "dev-{shard:05d}.rnr"), 1)


def run_train_cli(data_dir, out_dir, loss_impl, steps, device="cuda"):
    """One training run through rnnt_tpu_torch.cli.run_rnnt (bf16, batch 32,
    one epoch, a log line every step, one eval batch at the end, the
    256-frame / 64-label bucket).  Requires `steps` finite train losses, one
    eval line and a checkpoint that the port's restore reads back at the
    same step.  Returns (train losses, eval metrics)."""
    import torch

    from rnnt_tpu_torch.cli import run_rnnt
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.train.checkpoint import restore_checkpoint

    shutil.rmtree(out_dir, ignore_errors=True)
    run_rnnt.main(["--mode", "train", "--data_dir", data_dir,
                   "--output_dir", out_dir, "--batch_size", str(TRAIN_BATCH),
                   "--n_epochs", "1", "--steps_per_log", "1",
                   "--eval_size", "1", "--pad_frames", "256",
                   "--pad_tokens", "64", "--loss_impl", loss_impl,
                   "--device", device])
    with open(os.path.join(out_dir, "tb", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    evals = [r for r in recs if "eval_loss" in r]
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"train_{loss_impl}: train losses {losses}, want {steps} finite")
    require(len(evals) == 1 and np.isfinite(evals[0]["eval_loss"]),
            f"train_{loss_impl}: eval lines {evals}")
    state = restore_checkpoint(out_dir, RNNTConfig.load(out_dir),
                               torch.bfloat16, device)
    require(state.step == steps, f"restored step {state.step} != {steps}")
    log(f"train {loss_impl}: losses {losses}, eval {json.dumps(evals[0])}, "
        f"checkpoint restored at step {state.step}")
    return losses, evals[0]


def require_train_launches(name, launches, steps, eval_batches, pallas):
    """Per train step: K4 10 and K5 10 (8 encoder + 2 prediction LSTMs),
    and one K7; K6 once a step on the fused path, never on the pallas one.
    The eval batches add one K6 (fused) and one K7 each."""
    want = {"lstm_fwd": 10 * steps, "lstm_bwd": 10 * steps,
            "joint_planes": 0 if pallas else steps + eval_batches,
            "lattice_scan": steps + eval_batches}
    for k, n in want.items():
        require(launches[k] == n, f"path {name}: {k} launched {launches[k]} "
                f"times, want {n}")
    # bf16 K4 at the parity width fits its MMA plan on any H100, and bf16
    # K6 its WGMMA plan
    mma = launches["lstm_fwd_by_design"]["mma"]
    require(mma == want["lstm_fwd"], f"path {name}: {mma} of "
            f"{want['lstm_fwd']} K4 launches ran the MMA design")
    require_wgmma_k6(name, launches["joint_planes_by_design"],
                     want["joint_planes"])
    require_warp_k7(name, launches["lattice_scan_by_design"],
                    want["lattice_scan"])


def require_wgmma_k6(name, by_design, n) -> None:
    """All n K6 launches of a bf16 path at the parity width ran WGMMA."""
    require(by_design["wgmma"] == n and sum(by_design.values()) == n,
            f"path {name}: K6 launches by design {by_design}, want {n} "
            f"wgmma")


def lstm_cost(T, B, H, P, esize, backward):
    """(bytes, operations) of one LSTM sequence call: each input read once,
    each output written once; the recurrent products' operations."""
    weights = esize * (P * 4 * H + H * P)
    if backward:  # z, c, dout, Wh^T, Wp^T, c0 in; dz, dh_total, dh0, dc0 out
        nbytes = (weights + esize * 2 * T * B * (4 * H + P + H // 2)
                  + 4 * 2 * B * H + 4 * B * P)
    else:  # xp, Wh, Wp, bias, h0, c0 in; h, z, c, c_fin out
        nbytes = (weights + esize * (4 * H + B * P)
                  + esize * T * B * (2 * 4 * H + P + H) + 4 * 2 * B * H)
    return nbytes, 2.0 * T * B * (P * 4 * H + H * P)


def bound_of(nbytes, flops, peak):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lstm_rand(device, seed):
    """rand(shape, scale): uniform in [-scale/2, scale/2) on the device."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return lambda shape, scale: (torch.rand(shape, generator=g,
                                            device=device) - 0.5) * scale


def check_lstm_case(H, P, B, T, dt, tol, rand, backward=True):
    """K4 (h, z, c, c_fin) and, with `backward`, K5 (dz, dh_total, dh0, dc0;
    fed the plain forward's residuals and a random output gradient) vs
    their plain versions on random inputs with a carried state: relative
    error <= tol, inputs untouched.  Returns ({kernel: (rel err, max |d| of
    the first output)}, {kernel: the design its launch ran})."""
    import torch

    from rnnt_tpu_torch.ops import lstm_cuda

    before = read_designs()
    fwd_args = (rand((T, B, 4 * H), 4.0).to(dt), rand((P, 4 * H), 0.05).to(dt),
                rand((H, P), 0.1).to(dt), rand((4 * H,), 1.0).to(dt),
                rand((B, P), 0.5).to(dt), rand((B, H), 0.5))
    cases = [("lstm_fwd", lstm_cuda.lstm_fwd, lstm_cuda.lstm_fwd_plain,
              fwd_args)]
    want_f = lstm_cuda.lstm_fwd_plain(*fwd_args)
    if backward:
        cases.append(("lstm_bwd", lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
                      (want_f[1], want_f[2], fwd_args[5],
                       rand((T, B, P), 1.0).to(dt),
                       fwd_args[1].t().contiguous(),
                       fwd_args[2].t().contiguous())))
    errs = {}
    for name, fn, plain, args in cases:
        kept = [a.clone() for a in args]
        got = fn(*args)
        want = want_f if name == "lstm_fwd" else plain(*args)
        require(all(torch.equal(a, b) for a, b in zip(args, kept)),
                f"{name} wrote into its inputs")
        errs[name] = (max(rel_err(a, b) for a, b in zip(got, want)),
                      float((got[0].float() - want[0].float()).abs().max()))
    after = read_designs()
    designs = {k: next((d for d in after[k] if after[k][d] > before[k][d]),
                       "plain")
               for k in errs}
    log(f"H={H} P={P} T={T} B={B} {str(dt)[6:]}: "
        + "; ".join(f"{'K4' if k == 'lstm_fwd' else 'K5'} {k} ({designs[k]}) "
                    f"rel err {e:.3e}" for k, (e, _) in errs.items()))
    for k, (e, _) in errs.items():
        require(e <= tol, f"{k} H={H} P={P} T={T} B={B} {dt} disagrees: {e}")
    return errs, designs


def check_lstm_train(H, P, B=TRAIN_BATCH, device="cuda"):
    """K4 and K5 vs their plain versions at the train shapes: B=32 and
    T=256 (encoder layers 0-1), T=128 (after the time reduction) and T=65
    (the prediction net's U+1), B=96 at T=256 (bench.py's batch), a ragged
    B=20 at T=128 (not a multiple of K5's 16-row tiles), and at T=65 the
    other passes of K5's bf16 tiling: B=8 and B=40 (one and three ragged
    16-row tiles) and B=160 (passes of 64, 64 and 32 rows through the
    half-size staging ring), in fp32 (relative error <= 1e-4) and bf16
    (<= 2e-2); K5 is fed the plain
    forward's residuals and a random output gradient; neither kernel may
    write into its inputs.  Returns the K4 and K5 entries (times at layer
    0's shape in bf16, also at B=96; the cuDNN yardstick as the median of
    30 runs, with their minimum and maximum)."""
    import torch

    from rnnt_tpu_torch import bench
    from rnnt_tpu_torch.ops import lstm_cuda

    rand = lstm_rand(device, 3)
    worst = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for Bc, T in ((B, 256), (B, 128), (B, 65), (bench.B, 256), (20, 128),
                      (8, 65), (40, 65), (160, 65)):
            errs, _ = check_lstm_case(H, P, Bc, T, dt, tol, rand)
            name = str(dt)[6:]
            for k, (_, max_abs) in errs.items():
                worst[name, k[5:]] = max(worst.get((name, k[5:]), 0.0),
                                         max_abs)
    # times at layer 0's shape (T=256, F=240) in bf16
    T, F_in, dt = 256, 240, torch.bfloat16

    def layer0_args(Bc):
        fwd = (rand((T, Bc, 4 * H), 4.0).to(dt),
               rand((P, 4 * H), 0.05).to(dt), rand((H, P), 0.1).to(dt),
               rand((4 * H,), 1.0).to(dt),
               torch.zeros((Bc, P), dtype=dt, device=device),
               torch.zeros((Bc, H), device=device))
        _, z, c, _ = lstm_cuda.lstm_fwd_plain(*fwd)
        return fwd, (z, c, fwd[5], rand((T, Bc, P), 1.0).to(dt),
                     fwd[1].t().contiguous(), fwd[2].t().contiguous())

    fwd_args, bwd_args = layer0_args(B)
    # cuDNN's projected LSTM in training mode on the same widths, for the
    # library times only (it also computes the input projection x @ Wx)
    ref = torch.nn.LSTM(F_in, H, proj_size=P).to(device, dt)
    ref.flatten_parameters()  # as a cuDNN user would (`.to()` does not)
    x = rand((T, B, F_in), 2.0).to(dt).requires_grad_()
    dy = rand((T, B, P), 1.0).to(dt)

    def lib_fwd():
        return ref(x)[0]

    def lib_fwd_bwd():
        torch.autograd.backward(ref(x)[0], dy)

    lib = {what: library_runs(fn, f"cuDNN nn.LSTM(proj_size={P}) {what} "
                              f"T={T} B={B} bf16")
           for what, fn in (("forward", lib_fwd),
                            ("forward+backward", lib_fwd_bwd))}
    lib_f = lib["forward"]["median_ms"]
    lib_fb = lib["forward+backward"]["median_ms"]
    args96 = layer0_args(bench.B)
    entries = []
    for kind, fn, plain, args, src, line in (
            ("lstm_fwd", lstm_cuda.lstm_fwd, lstm_cuda.lstm_fwd_plain,
             fwd_args, "lstm_infer.cu", 62),
            ("lstm_bwd", lstm_cuda.lstm_bwd, lstm_cuda.lstm_bwd_plain,
             bwd_args, "lstm_bwd.cu", 215)):
        nbytes, flops = lstm_cost(T, B, H, P, 2, kind == "lstm_bwd")
        entries.append({
            "name": kind, "route": "cuda",
            "source": f"rnnt_tpu_torch/csrc/{src}",
            "replaces": f"rnnt_tpu/ops/lstm_pallas.py:{line}",
            "max_abs_err": worst["bfloat16", kind[5:]],
            "ms": cuda_ms(lambda: fn(*args), reps=10),
            "plain_ms": cuda_ms(lambda: plain(*args), reps=2, warmup=1),
            **bound_of(nbytes, flops, PEAK_BF16_FLOPS),
            "library_ms": lib_f if kind == "lstm_fwd" else lib_fb - lib_f,
            "library": (f"torch.nn.LSTM(proj_size={P}) (cuDNN), training mode, "
                        + ("forward" if kind == "lstm_fwd" else
                           "backward (forward + backward less forward)")),
            "library_runs_ms": lib,
            "shape": f"T={T} B={B} H={H} P={P} bf16",
            "max_abs_err_fp32": worst["float32", kind[5:]]})
    for k, fn, args in zip(entries, (lstm_cuda.lstm_fwd, lstm_cuda.lstm_bwd),
                           args96):
        k["ms_B96"] = cuda_ms(lambda: fn(*args), reps=10)
        k["bound_ms_B96"] = bound_of(*lstm_cost(
            T, bench.B, H, P, 2, k["name"] == "lstm_bwd"), PEAK_BF16_FLOPS)[
                "bound_ms"]
        log(f"{k['name']} T={T} bf16: B={B} {k['ms']:.3f} ms, B={bench.B} "
            f"{k['ms_B96']:.3f} ms (bound {k['bound_ms_B96']:.4f})")
    return entries


CAP_BLOCKS = 114  # an H100 PCIe's SMs
WIDE = ((3072, 768, True), (4096, 1024, False))  # (H, P, K5 too)


def check_lstm_designs(H, P, device="cuda"):
    """Which design each LSTM training kernel runs, and that it agrees:
    (a) the parity width with the grid capped at CAP_BLOCKS (as on an H100
    PCIe) at B=32 and 96, T=65: bf16 K4 must run its MMA design (18 units
    a block) and bf16 K5 its FMA design (its MMA plan holds 16); (b) the
    WIDE shapes at one block per SM, B=32, T=64: bf16 K5 at H=3072 must run
    FMA (24 units a block), and bf16 K4 at H=4096 too (its Wh slice alone
    would be 266 KB); K4 at H=3072 runs what its plan picks.  fp32 runs
    FMA throughout.  Relative error <= 1e-4 in fp32, <= 2e-2 in bf16.
    Returns {case: {kernel: design}}."""
    import torch

    from rnnt_tpu_torch import bench
    from rnnt_tpu_torch.ops import lstm_cuda

    rand = lstm_rand(device, 7)
    seen = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        name = str(dt)[6:]
        bf16 = dt == torch.bfloat16
        lstm_cuda.set_block_cap(CAP_BLOCKS)
        try:
            for B in (32, bench.B):
                _, d = check_lstm_case(H, P, B, 65, dt, tol, rand)
                seen[f"H={H} B={B} T=65 {CAP_BLOCKS} blocks {name}"] = d
                require(d == ({"lstm_fwd": "mma", "lstm_bwd": "fma"} if bf16
                              else {"lstm_fwd": "fma", "lstm_bwd": "fma"}),
                        f"designs at {CAP_BLOCKS} blocks, B={B}, {name}: {d}")
        finally:
            lstm_cuda.set_block_cap(0)
        for Hw, Pw, backward in WIDE:
            _, d = check_lstm_case(Hw, Pw, 32, 64, dt, tol, rand, backward)
            seen[f"H={Hw} P={Pw} B=32 T=64 {name}"] = d
            must = {"lstm_bwd": "fma"} if backward else {"lstm_fwd": "fma"}
            if not bf16:
                must = dict.fromkeys(d, "fma")
            require(all(d[k] == v for k, v in must.items()),
                    f"designs at H={Hw}, P={Pw}, {name}: {d}")
    log("LSTM training kernels' designs " + json.dumps(seen))
    return seen


def planes_inputs(cfg, B, T, U1, device, seed, J=None, V=None):
    """K6's inputs (f, g, labels, b1, W2, b2) in fp32, random from `seed`
    at the config's joint width unless J, V say otherwise."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    J = cfg.joint_size if J is None else J
    V = cfg.vocab_size if V is None else V
    lim = (6.0 / (J + V)) ** 0.5

    def rand(shape, scale):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * scale

    y = torch.randint(1, V, (B, U1), generator=g, device=device)
    y[:, -1] = 0
    return (rand((B, T, J), 1.0), rand((B, U1, J), 1.0), y, rand((J,), 0.1),
            rand((J, V), lim), rand((V,), 0.1))


def planes_case(args, tol, design, what):
    """One K6 call against its plain version: every plane within `tol`
    relative error, the inputs untouched, and the launch on `design`.
    Returns (max |d|, the plain planes)."""
    import torch

    from rnnt_tpu_torch.ops import planes_cuda

    before = [a.clone() for a in args]
    counts = dict(planes_cuda.joint_planes.launches_by_design)
    got = planes_cuda.joint_planes(*args)
    ran = [d for d, n in planes_cuda.joint_planes.launches_by_design.items()
           if n != counts[d]]
    want = planes_cuda.joint_planes_plain(*args)
    require(all(torch.equal(a, b) for a, b in zip(args, before)),
            f"K6 {what} wrote into its inputs")
    rel = [rel_err(a, b) for a, b in zip(got, want)]
    max_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    log(f"K6 joint_planes {what} on {ran}: rel err denom {rel[0]:.3e} blank "
        f"{rel[1]:.3e} emit {rel[2]:.3e}, max |d| {max_abs:.3e}")
    require(max(rel) <= tol, f"K6 {what} disagrees: {rel}")
    require(ran == [design], f"K6 {what} ran {ran}, want {design}")
    return max_abs, want


def planes_cost(B, T, U1, J, V, esize):
    """(bytes, operations) of one K6 call: f, g, b1, W2, b2 in the weight
    type and the labels, each read once, three fp32 planes written once;
    the [cells, J] x [J, V] product."""
    C = B * T * U1
    nbytes = (esize * (B * T * J + B * U1 * J + J * V + J + V) + 4 * B * U1
              + 3 * 4 * C)
    return nbytes, 2.0 * C * J * V


def check_planes(cfg, B=32, T=128, U1=65, device="cuda"):
    """K6 vs its plain version on denom, blank and emit: relative error <=
    1e-4 in fp32 (the FMA design), <= PLANES_BF16_TOL in bf16, inputs
    untouched, each case on the design it must run.  bf16 at the parity
    joint (J=640, V=4096) runs WGMMA: the train shape (B=32, T'=128,
    U+1=65), bench.py's (B=96), and a ragged shape (B=3, T'=7, U+1=5, J=40,
    V=300: 105 cells, a partial tile, J and V padded; fp32 too); a joint too
    wide for its plan (J=1024) runs WMMA.  The pack kernel must equal
    `pack_w2` at both widths; after W2 changes in place the next call must
    hold to the plain planes of the new W2, which reject the planes of the
    old one (nothing stale).  Returns (K6 entry, the fp32 train-shape
    planes)."""
    import torch

    from rnnt_tpu_torch import bench
    from rnnt_tpu_torch.ops import planes_cuda

    bf16 = torch.bfloat16
    J, V = cfg.joint_size, cfg.vocab_size
    f, gg, y, b1, w2, b2 = planes_inputs(cfg, B, T, U1, device, 4)
    args32 = (f, gg, y, b1, w2, b2)
    errs, designs = {}, {}
    errs["float32"], planes32 = planes_case(args32, 1e-4, "fma",
                                            f"B={B} T={T} U+1={U1} fp32")
    designs["train shape fp32"] = "fma"
    args = tuple(a.to(bf16) if a.is_floating_point() else a for a in args32)
    errs["bfloat16"], _ = planes_case(args, PLANES_BF16_TOL, "wgmma",
                                      f"B={B} T={T} U+1={U1} bf16")
    designs["train shape bf16"] = "wgmma"
    Bb = bench.B
    fb, gb, yb, b1b, w2b, b2b = planes_inputs(cfg, Bb, T, U1, device, 7)
    args_b = (fb.to(bf16), gb.to(bf16), yb, b1b.to(bf16), w2b.to(bf16),
              b2b.to(bf16))
    errs["bfloat16 B=96"], _ = planes_case(args_b, PLANES_BF16_TOL, "wgmma",
                                           f"B={Bb} T={T} U+1={U1} bf16")
    designs["bench shape bf16"] = "wgmma"
    rag32 = planes_inputs(cfg, 3, 7, 5, device, 8, J=40, V=300)
    for dt, tol, design in ((bf16, PLANES_BF16_TOL, "wgmma"),
                            (torch.float32, 1e-4, "fma")):
        rag = tuple(a.to(dt) if a.is_floating_point() else a for a in rag32)
        name = str(dt)[6:]
        errs[f"{name} ragged"], _ = planes_case(
            rag, tol, design, f"ragged B=3 T=7 U+1=5 J=40 V=300 {name}")
        designs[f"ragged {name}"] = design
    wide = planes_inputs(cfg, 4, 16, 9, device, 9, J=1024, V=512)
    wide = tuple(a.to(bf16) if a.is_floating_point() else a for a in wide)
    errs["bfloat16 J=1024"], _ = planes_case(
        wide, PLANES_BF16_TOL, "wmma", "B=4 T=16 U+1=9 J=1024 V=512 bf16")
    designs["J=1024 bf16"] = "wmma"
    for w in (args[4], rag32[4].to(bf16)):
        require(torch.equal(planes_cuda.pack_w2_cuda(w),
                            planes_cuda.pack_w2(w)),
                f"K6's pack kernel differs from pack_w2 at W2 "
                f"{tuple(w.shape)}")
        log(f"K6 pack kernel equals pack_w2 at W2 {tuple(w.shape)}")
    # staleness: W2 changed in place between two calls
    st = [args[0][:4], args[1][:4], args[2][:4], args[3], args[4].clone(),
          args[5]]
    old = planes_cuda.joint_planes(*st)
    gen = torch.Generator(device=device).manual_seed(10)
    st[4].add_((torch.rand(st[4].shape, generator=gen, device=device) - 0.5)
               * 0.02)
    _, want_new = planes_case(tuple(st), PLANES_BF16_TOL, "wgmma",
                              "B=4 after W2 changed in place")
    stale = max(rel_err(a, b) for a, b in zip(old, want_new))
    log(f"K6 staleness: the planes before the update against the plain "
        f"planes after it: rel err {stale:.3e}")
    require(stale > PLANES_BF16_TOL,
            f"K6 staleness control not rejected: {stale}")
    C = B * T * U1
    h2d = torch.randn((C, J), device=device).to(bf16)  # the library's operands
    h2d_b = torch.randn((Bb * T * U1, J), device=device).to(bf16)
    entry = {
        "name": "joint_planes", "route": "cuda",
        "source": "rnnt_tpu_torch/csrc/joint_planes.cu",
        "replaces": "rnnt_tpu/ops/joint_loss_fused.py:61",
        "max_abs_err": errs["bfloat16"],
        "ms": cuda_ms(lambda: planes_cuda.joint_planes(*args), reps=5),
        "plain_ms": cuda_ms(lambda: planes_cuda.joint_planes_plain(*args),
                            reps=2, warmup=1),
        **bound_of(*planes_cost(B, T, U1, J, V, 2), PEAK_BF16_FLOPS),
        "library_ms": cuda_ms(lambda: torch.mm(h2d, args[4]), reps=5),
        "library": "cuBLAS bf16 [C,J]x[J,V] product alone (torch.mm), "
                   "without the tanh tile and the logsumexp",
        "shape": f"B={B} T'={T} U+1={U1} J={J} V={V} bf16 ({C} cells), "
                 "the on-card packing of W2 included",
        "ms_b96": cuda_ms(lambda: planes_cuda.joint_planes(*args_b), reps=5),
        "bound_ms_b96": bound_of(*planes_cost(Bb, T, U1, J, V, 2),
                                 PEAK_BF16_FLOPS)["bound_ms"],
        "library_ms_b96": cuda_ms(lambda: torch.mm(h2d_b, args_b[4]),
                                  reps=5),
        "pack_ms": cuda_ms(lambda: planes_cuda.pack_w2_cuda(args[4]),
                           reps=10),
        "designs_by_case": designs,
        "max_abs_err_by_case": errs,
        "max_abs_err_fp32": errs["float32"]}
    return entry, planes32


def lattice_case(b, e, fl, yl, design, what):
    """K7 vs its plain version on one input: alpha and beta over the valid
    cells and ll within LATTICE_TOL relative error, inputs untouched, the
    launch on `design`.  Returns (relative errors, max |d| over the valid
    cells)."""
    import torch

    from rnnt_tpu_torch.ops import lattice_cuda, rnnt_loss_ref

    B, T, U1 = b.shape
    args = (b, e, fl, yl)
    kept = [a.clone() for a in args]
    k7 = lattice_cuda.lattice_scan
    before = dict(k7.launches_by_design)
    got = k7(*args)
    ran = [d for d, n in k7.launches_by_design.items() if n > before[d]]
    want = rnnt_loss_ref.lattice_scan_plain(*args)
    require(all(torch.equal(a, c) for a, c in zip(args, kept)),
            "K7 wrote into its inputs")
    require(ran == [design], f"K7 {what} ran {ran}, not {design}")
    t_idx = torch.arange(T, device=b.device)[None, :, None]
    u_idx = torch.arange(U1, device=b.device)[None, None, :]
    valid = (t_idx < fl[:, None, None]) & (u_idx <= yl[:, None, None])
    rel = [rel_err(got[i][valid], want[i][valid]) for i in (0, 1)]
    rel.append(rel_err(got[2], want[2]))
    max_abs = max(float((got[i][valid] - want[i][valid]).abs().max())
                  for i in (0, 1))
    log(f"K7 lattice {what} B={B} T={T} U+1={U1} ({design}): rel err alpha "
        f"{rel[0]:.3e} beta {rel[1]:.3e} ll {rel[2]:.3e}; max |d| "
        f"{max_abs:.3e}")
    require(max(rel) <= LATTICE_TOL, f"K7 {what} U+1={U1} disagrees: {rel}")
    return rel, max_abs


def lattice_design(U1) -> str:
    from rnnt_tpu_torch.ops import lattice_cuda

    return "warp" if U1 <= lattice_cuda.WARP_MAX_U1 else "block"


def check_lattice(planes32, device="cuda", seed=5):
    """K7 vs its plain version (`lattice_case`) from the fp32 planes of
    check_planes (b = blank - denom, e = emit - denom masked from u = U_b
    on) at B=32, T'=128, U+1=65, and at B=96 from the same planes three
    times over, each with random ragged frame and label lengths; both on the
    warp design.  Returns the K7 entry, timed (device time) at both."""
    import torch

    from rnnt_tpu_torch.ops import lattice_cuda, rnnt_loss_ref

    denom, blank, emit = planes32
    B, T, U1 = denom.shape
    g = torch.Generator(device=device).manual_seed(seed)
    u_idx = torch.arange(U1, device=device)[None, None, :]
    inputs, errs = {}, {}
    for nb in (B, 3 * B):
        fl = torch.randint(max(1, T - 28), T + 1, (nb,), generator=g,
                           device=device)
        yl = torch.randint(max(0, U1 - 26), U1, (nb,), generator=g,
                           device=device)
        b = (blank - denom).repeat(nb // B, 1, 1)
        e = torch.where(u_idx < yl[:, None, None],
                        (emit - denom).repeat(nb // B, 1, 1),
                        rnnt_loss_ref.NEG)
        inputs[nb] = (b, e, fl, yl)
        errs[f"B={nb}"] = lattice_case(*inputs[nb], lattice_design(U1),
                                       "from the planes")
    cells = B * T * U1

    def cost(nb):  # planes in, alpha and beta out; ~10 fp32 ops a cell
        c = cells * nb // B
        return 4 * 4 * c + 4 * 3 * nb, 2 * 10.0 * c

    return {
        "name": "lattice_scan", "route": "cuda",
        "source": "rnnt_tpu_torch/csrc/rnnt_lattice.cu",
        "replaces": "rnnt_tpu/ops/rnnt_loss_pallas.py:76",
        "max_abs_err": max(m for _, m in errs.values()),
        "rel_err_by_case": {k: max(r) for k, (r, _) in errs.items()},
        "ms": device_ms(lambda: lattice_cuda.lattice_scan(*inputs[B]),
                        reps=20),
        "plain_ms": cuda_ms(lambda: rnnt_loss_ref.lattice_scan_plain(
            *inputs[B]), reps=2, warmup=1),
        **bound_of(*cost(B), PEAK_FP32_FLOPS),
        "library_ms": None,
        "shape": f"B={B} T'={T} U+1={U1} fp32",
        "ms_b96": device_ms(lambda: lattice_cuda.lattice_scan(
            *inputs[3 * B]), reps=20),
        "bound_ms_b96": bound_of(*cost(3 * B), PEAK_FP32_FLOPS)["bound_ms"]}


def check_lattice_wide(device="cuda", seed=6, B=2, T=24):
    """K7 at the edges of its designs: U+1 = 1 (the warp design, one
    position), 257 (the block design's first width) and 1025, 1537 (runs of
    2 positions a thread): random log-probability planes, emit masked from
    u = U_b on, random frame and label lengths, `lattice_case`'s gates.
    Returns {U+1: device ms}."""
    import torch

    from rnnt_tpu_torch.ops import lattice_cuda, rnnt_loss_ref

    g = torch.Generator(device=device).manual_seed(seed)
    times = {}
    for U1 in (1, 257, 1025, 1537):
        b = -3.0 * torch.rand((B, T, U1), generator=g, device=device) - 0.05
        e = -3.0 * torch.rand((B, T, U1), generator=g, device=device) - 0.05
        fl = torch.randint(T - 6, T + 1, (B,), generator=g, device=device)
        yl = torch.randint(max(0, U1 - 60), U1, (B,), generator=g,
                           device=device)
        u_idx = torch.arange(U1, device=device)[None, None, :]
        e = torch.where(u_idx < yl[:, None, None], e, rnnt_loss_ref.NEG)
        args = (b, e, fl, yl)
        lattice_case(*args, lattice_design(U1), "random planes")
        times[U1] = device_ms(lambda: lattice_cuda.lattice_scan(*args),
                              reps=20)
    return times


def require_warp_k7(name, by_design, n) -> None:
    """Every K7 launch of a driven training path ran the warp design."""
    require(n > 0 and by_design["warp"] == n,
            f"{name}: K7 launches by design {by_design} of {n}")


def random_batch(cfg, B, T, U, device, seed):
    """A training batch at (B, T frames, U labels), every row full length."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    labels = torch.randint(1, cfg.vocab_size, (B, U), generator=g,
                           device=device)
    return {"mel_specs": torch.randn((B, T, cfg.input_feat_size),
                                     generator=g, device=device),
            "pred_inp": torch.cat([torch.zeros((B, 1), dtype=labels.dtype,
                                               device=device), labels], 1),
            "labels": labels,
            "spec_lengths": torch.full((B,), T, device=device),
            "label_lengths": torch.full((B,), U, device=device)}


def check_train_step_fp32(cfg, seed, B=TRAIN_BATCH, device="cuda"):
    """One whole fp32 train step's loss and gradients through the kernels
    (K4-K7, on the card) against the plain versions (the same step on the
    CPU, where every wrapper runs its plain version), at the parity width
    and depth and the train_cli path's B=32, T=256, U=64: loss within 1e-4
    and every gradient within 1e-3 relative error (to its largest
    element)."""
    import torch

    from rnnt_tpu_torch.train.state import create_train_state, trainable_names
    from rnnt_tpu_torch.train.steps import batch_loss

    batch = random_batch(cfg, B, 256, 64, device, seed)
    runs = []
    for dev in (device, "cpu"):
        model = create_train_state(cfg, torch.float32, dev, seed).model
        t0 = time.perf_counter()
        loss, _ = batch_loss(model, cfg, {k: v.to(dev) for k, v in
                                          batch.items()},
                             training=True, loss_impl="fused")
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: params[n].grad.cpu() for n in trainable_names(model)}
        runs.append((float(loss.detach()), grads, time.perf_counter() - t0))
        del model, params, loss
    (loss_k, grads_k, secs_k), (loss_p, grads_p, secs_p) = runs
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    errs = {n: rel_err(grads_k[n], grads_p[n]) for n in grads_p}
    worst = max(errs, key=errs.get)
    log(f"fp32 train step B={B} T=256 U=64 kernels ({secs_k:.2f} s) vs plain "
        f"on the CPU ({secs_p:.2f} s, {torch.get_num_threads()} threads): "
        f"loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}); worst "
        f"gradient {worst} rel err {errs[worst]:.3e}")
    require(loss_rel <= 1e-4, f"fp32 train-step loss disagrees: {loss_rel}")
    require(errs[worst] <= 1e-3, f"fp32 gradient {worst} disagrees: "
            f"{errs[worst]}")


def step_split(events):
    """Device ms of a train step's ops by kernel."""
    groups = (("K4 lstm_fwd", ("lstm_infer_kernel", "lstm_fwd_mma_kernel")),
              ("K5 lstm_bwd", "lstm_bwd_kernel"),
              ("K6 joint_planes", ("plane_kernel", "pack_w2_kernel")),
              ("K7 lattice", ("lattice_warp_kernel", "lattice_kernel")),
              ("cuBLAS products", ("gemm", "Gemm", "nvjet", "xmma",
                                   "cutlass", "cublas")))
    split = {}
    for e in events:
        key = next((k for k, pat in groups
                    if any(p in e.name for p in (
                        pat if isinstance(pat, tuple) else (pat,)))),
                   "other (elementwise, reductions, copies)")
        split[key] = split.get(key, 0.0) + (e.time_range.end
                                            - e.time_range.start) / 1e3
    return {k: round(v, 3) for k, v in sorted(split.items())}


def bench_train_step(smi, timed, seed, device="cuda"):
    """One profiled train step at bench.py's geometry, set up by
    `rnnt_tpu_torch.bench.setup` (B=96, T=256 stacked frames, U=64, bf16,
    fused loss, random weights and batch from `seed`) after one warm-up
    step: device busy time,
    idle share and the split by kernel.  The timed steps are the bench_train
    path's run of `rnnt_tpu_torch.bench` (`timed`: its audio-s/s, step ms
    and peak memory)."""
    from rnnt_tpu_torch import bench
    from rnnt_tpu_torch.ops import lattice_cuda, lstm_cuda, planes_cuda

    state, batch, step, gen = bench.setup(device, seed=seed)
    k6, k7 = planes_cuda.joint_planes, lattice_cuda.lattice_scan
    k6_before = (k6.launches, dict(k6.launches_by_design))
    k7_before = (k7.launches, dict(k7.launches_by_design))
    losses = [float(step(state, batch, gen)["loss"])]
    events = []
    plain_wall, wall, busy, event_wall, ops, launches, runs = device_profile(
        lambda: step(state, batch, gen), lstm_cuda.lstm_bwd,
        "lstm_bwd_kernel", events=events)
    require(all(np.isfinite(losses)), f"bench train losses {losses}")
    require(launches == 10, f"profiled train step: {launches} K5 launches")
    k6_by_design = {d: n - k6_before[1][d]
                    for d, n in k6.launches_by_design.items()}
    require_wgmma_k6("bench step", k6_by_design,
                     k6.launches - k6_before[0])
    k7_by_design = {d: n - k7_before[1][d]
                    for d, n in k7.launches_by_design.items()}
    require_warp_k7("bench step", k7_by_design, k7.launches - k7_before[0])
    result = {"B": bench.B, "T": bench.T, "U": bench.U, "dtype": "bfloat16",
              "loss": "fused", "step_ms": timed["step_ms"],
              "audio_s_per_s": timed["value"],
              "peak_memory_bytes": timed["peak_memory_bytes"],
              "profiled_step_wall_ms": wall,
              "profiled_step_event_wall_ms": event_wall,
              "unprofiled_step_ms": plain_wall,
              "device_busy_ms": busy, "device_ops": ops,
              "idle_share": 1 - busy / wall, "profiled_runs": runs,
              "split_ms": step_split(events), "losses": losses,
              "k6_launches_by_design": k6_by_design,
              "k7_launches_by_design": k7_by_design, "card": smi}
    log("bench-geometry train step " + json.dumps(result))
    return result


# ------------------------------------------------- measurement entry points

CORPUS_SPLIT = "test-synth"


def run_main(name, main, argv):
    """Call an entry point's main(argv) in this process with its standard
    output and error captured; log both.  It must return 0.  Returns (its
    stdout lines, its stderr lines)."""
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        for line in err.getvalue().splitlines():
            log(f"{name} stderr: {line}")
        for line in out.getvalue().splitlines():
            log(f"{name}: {line}")
    require(rc == 0, f"{name} {' '.join(argv)} returned {rc}")
    return out.getvalue().splitlines(), err.getvalue().splitlines()


def json_line(name, lines):
    """The one JSON line an entry point printed."""
    require(len(lines) == 1, f"{name} printed {len(lines)} lines, want 1")
    return json.loads(lines[0])


def write_corpus(cfg, path, seed):
    """Three WAVs of 2-3 s and their trans.txt in LibriSpeech layout
    (split/speaker/chapter), the transcript listing .flac ids as the corpus
    does (the loader falls back to the .wav)."""
    from rnnt_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(seed)
    chapter = os.path.join(path, CORPUS_SPLIT, "84", "121123")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(chapter)
    texts = ["GO DO YOU HEAR", "BUT IN LESS THAN FIVE MINUTES",
             "AT THIS MOMENT THE WHOLE SOUL OF THE OLD MAN"]
    lines = []
    for i, (seconds, text) in enumerate(zip((2.0, 2.5, 3.0), texts)):
        utt = f"84-121123-{i:04d}"
        write_wav(os.path.join(chapter, utt + ".wav"),
                  synthetic_audio(seconds, rng), cfg.sample_rate)
        lines.append(f"{utt} {text}")
    with open(os.path.join(chapter, "84-121123.trans.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def check_bench_decode_beam(batch, frames, reps):
    """K3 against its plain version on bench_decode's own inputs
    (`bench_decode.setup`: bf16, the blank bias lowered, encoder outputs
    normal x 2) at E=1 and at E=6, the two cuda rows' searches: N = batch x
    BEAM hypothesis rows above the streamed plan's MAXN, so each must run
    the FMA design, held by `gate_beam` at the bf16 tolerance.  The plain
    E=1 search is timed beside the kernel's, as the row that bench_decode
    prints.  Returns {E: record} with the largest |d score| of each."""
    import torch

    from rnnt_tpu_torch.cli import bench_decode
    from rnnt_tpu_torch.decode.beam import beam_search_encoded_plain
    from rnnt_tpu_torch.ops import beam_cuda

    cfg, model, enc, lens = bench_decode.setup(batch, frames, True, "cuda")
    require(batch * BEAM > beam_cuda.MAXN,
            f"B={batch} x K={BEAM} is inside the streamed plan")
    out = {}
    for E in (1, 6):
        kw = dict(beam_width=BEAM, max_output_length=200,
                  expansions_per_frame=E)
        with torch.no_grad():
            trace, stats = {}, {}
            got = beam_cuda.beam_search(model, enc, lens, trace=trace, **kw)
            design = beam_cuda.beam_search.last_design
            want = beam_search_encoded_plain(model, enc, lens, stats=stats,
                                             **kw)
            torch.cuda.synchronize()
        fails, notes, max_abs, rel = gate_beam(
            got, trace, want, stats, lens, E, cfg.vocab_size,
            BEAM_SCORE_TOL["bfloat16"])
        log(f"K3 bench_decode inputs B={batch} T={frames} E={E} bf16 "
            f"({design} design): lengths {got[1].tolist()} (plain "
            f"{want[1].tolist()}), scores max |d| {max_abs:.3e} rel "
            f"{rel:.3e}, merges {stats['merges']}, "
            f"{stats['idx'].shape[0]} selections "
            + ("identical" if not notes and not fails else
               "; ".join(notes + fails)))
        require(not fails, f"beam kernel on bench_decode's inputs E={E}: "
                f"{fails}")
        require(design == "fma", f"beam kernel on bench_decode's inputs "
                f"E={E} ran the {design} design, not fma")
        rec = {"design": design, "max_abs_err": max_abs, "rel_err": rel,
               "near_ties": len(notes)}
        if E == 1:
            with torch.no_grad():
                rec["ms"] = cuda_ms(lambda: beam_cuda.beam_search(
                    model, enc, lens, **kw), reps=reps)
                rec["plain_ms"] = cuda_ms(lambda: beam_search_encoded_plain(
                    model, enc, lens, **kw), reps=reps, warmup=0)
        out[E] = rec
    del model, enc
    return out


def drive_bench_entry_points(paths, cfg, seed):
    """Each measurement entry point's main, in this process on the card,
    as a driven path of its own (counts set to 0 just before, read just
    after).  Returns the bench's record (its JSON line, step ms and peak
    device memory) and K3's check on bench_decode's inputs."""
    import threading

    from rnnt_tpu_torch import bench
    from rnnt_tpu_torch.cli import (bench_decode, bench_loss, bench_serve,
                                    bench_streaming)

    (out, err), launches = drive_path(
        "bench_train", lambda: run_main("bench", bench.main, []),
        ("lstm_fwd", "lstm_bwd", "joint_planes", "lattice_scan"))
    paths["bench_train"] = launches
    timed = json_line("bench", out)
    require(np.isfinite(timed["value"]) and timed["value"] > 0,
            f"bench value {timed['value']}")
    stats = next(line for line in err if line.startswith("bench: "))
    timed["step_ms"] = float(stats.split(" step ")[1].split(" ms")[0])
    timed["peak_memory_bytes"] = int(
        stats.split("peak device memory ")[1].split(" B")[0])
    steps = bench.N_STEPS + 1  # the warm-up and the timed steps
    for k in ("lstm_fwd", "lstm_bwd"):
        require(launches[k] == 10 * steps, f"path bench_train: {k} launched "
                f"{launches[k]} times, want {10 * steps}")
    require_wgmma_k6("bench_train", launches["joint_planes_by_design"],
                     launches["joint_planes"])
    require_warp_k7("bench_train", launches["lattice_scan_by_design"],
                    launches["lattice_scan"])

    (out, _), paths["bench_loss"] = drive_path(
        "bench_loss", lambda: run_main("bench_loss", bench_loss.main,
                                       ["--B", "8", "--iters", "3"]),
        ("joint_planes", "lattice_scan"))
    fused = [line for line in out if line.startswith("fused ")]
    require(len(fused) == 1 and "TFLOP/s" in fused[0],
            f"bench_loss fused line {fused}")
    require(len(out) == 4, f"bench_loss printed {out}")

    reps = 2
    (out, _), launches = drive_path(
        "bench_decode", lambda: run_main(
            "bench_decode", bench_decode.main,
            ["--batch", "8", "--frames", "128", "--reps", str(reps)]),
        ("lstm_seq_infer", "beam_search"))
    paths["bench_decode"] = launches
    rows = ("greedy", "beam-4 cuda E=1", "beam-4 cuda E=6",
            "beam-4 plain E=1")
    require(len(out) == 1 + len(rows) and all(
        line.startswith(f"{r:20s} ") for r, line in zip(rows, out[1:])),
        f"bench_decode rows {out}")
    # one K3 launch a search: the warm-up and the timed reps of the two
    # cuda rows; the plain row launches none
    require(launches["beam_search"] == 2 * (reps + 1),
            f"bench_decode: {launches['beam_search']} K3 launches")
    k3_decode = check_bench_decode_beam(8, 128, reps)

    (out, _), paths["bench_streaming_latency"] = drive_path(
        "bench_streaming_latency", lambda: run_main(
            "bench_streaming", bench_streaming.main, ["--chunks", "40"]),
        ("log_mel_frontend", "lstm_seq_infer"))
    rec = json_line("bench_streaming", out)
    require(rec["backend"] == "cuda" and np.isfinite(rec["value"]),
            f"bench_streaming {rec}")

    corpus = os.path.join(TRAIN_DIR, "corpus")
    write_corpus(cfg, corpus, seed)
    (out, _), paths["bench_streaming_wer"] = drive_path(
        "bench_streaming_wer", lambda: run_main(
            "bench_streaming_wer", bench_streaming.main,
            ["--checkpoint", RUN_DIR, "--audio_dir", corpus, "--split",
             CORPUS_SPLIT]),
        ("log_mel_frontend", "lstm_seq_infer"))
    rec = json_line("bench_streaming_wer", out)
    require(rec["n_utts"] == 3 and np.isfinite(rec["offline_wer"])
            and np.isfinite(rec["streamed_wer"]), f"bench_streaming {rec}")

    threads = set(threading.enumerate())
    (out, _), paths["bench_serve"] = drive_path(
        "bench_serve", lambda: run_main(
            "bench_serve", bench_serve.main,
            ["--checkpoint", RUN_DIR, "--requests", "8", "--concurrency",
             "2"]),
        ("log_mel_frontend", "lstm_seq_infer", "beam_search"))
    heads = ("rtt_ms: ", "cold start: ", "first beam-4 request: ",
             "sequential: ", "concurrent x2: ", "streaming: ")
    require(len(out) == len(heads) and all(
        line.startswith(h) for h, line in zip(heads, out)),
        f"bench_serve lines {out}")
    for t in set(threading.enumerate()) - threads:
        t.join(timeout=10)  # a handler may still be closing its socket
    left = [t.name for t in set(threading.enumerate()) - threads]
    require(not left, f"bench_serve left threads running: {left}")
    return timed, k3_decode



# ---------------------------------------------------------------- int8 ----

INT8_ROWS = (1, 8, 32)  # greedy B=1, bench_decode's B=8, the eval batch
# (K, N) of every int8 product at the parity width: the prediction net's
# first wx (K = embedding_size = 500), its second wx and both wh, both wp,
# the joint's w1 and w2; then the joint's w2 at the character vocabulary
# (N = 31) and a product padded in both K and N
INT8_SHAPES = ((500, 8192), (640, 8192), (2048, 640), (640, 640),
               (640, 4096), (640, 31), (500, 31))
PEAK_INT8_OPS = 1979e12  # tensor cores, dense int8


@contextlib.contextmanager
def plain_int8_product():
    """Route qdot's int32 product to its exact plain version (int8 operands
    widened to float64 on the card; comparison only)."""
    from rnnt_tpu_torch.ops import int8_exec

    card = int8_exec.int_mm
    int8_exec.int_mm = int8_exec.plain_int_mm
    try:
        yield
    finally:
        int8_exec.int_mm = card


def run_quantize(ckpt, out):
    """cli.quantize_model on a run directory; returns (fp MB, int8 MB) of
    its size line."""
    from rnnt_tpu_torch.cli import quantize_model

    lines, _ = run_main("quantize_model", quantize_model.main,
                        ["--checkpoint", ckpt, "-o", out])
    require(len(lines) == 1 and lines[0].startswith("params: ")
            and os.path.exists(out), f"quantize_model printed {lines}")
    fp_mb = float(lines[0].split("fp: ")[1].split(" MB")[0])
    q_mb = float(lines[0].split("int8: ")[1].split(" MB")[0])
    log(f"int8 artifact {out}: {os.path.getsize(out)} B on disk, fp "
        f"{fp_mb} MB -> int8 {q_mb} MB")
    return fp_mb, q_mb


def check_qdot(smi):
    """qdot on the card (torch._int_mm, the weight's K and N padded once, the
    activations' rows and K on each call) against its exact plain product
    at every product shape of the int8 path: the int32 products and the
    fp32 outputs bitwise equal.  Returns the record printed as
    `int8_qdot`."""
    import torch

    from rnnt_tpu_torch.ops import int8_exec as I

    g = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for K, N in INT8_SHAPES:
        w = I.QuantWeight(
            torch.randint(-127, 128, (K, N), dtype=torch.int8,
                          device="cuda", generator=g),
            torch.rand((N,), device="cuda", generator=g) * 1e-3 + 1e-5)
        require((w.q_mm is not None) == bool(K % 8 or N % 8),
                f"QuantWeight K={K} N={N}: q_mm {w.q_mm is not None}")
        for M in INT8_ROWS:
            x = torch.randn((M, K), device="cuda", generator=g).to(
                torch.bfloat16)
            x[0] = 0.0  # a zero row
            xi, _ = I.quantize_rows(x)
            n0 = I.int_mm.launches
            yi = I.int_mm(xi, w.operand)
            y = I.qdot(x, w)
            require(I.int_mm.launches == n0 + 2, "qdot on the card did not "
                    "run torch._int_mm")
            with plain_int8_product():
                yi_p = I.int_mm(xi, w.operand)
                y_p = I.qdot(x, w)
            torch.cuda.synchronize()
            same = bool(torch.equal(yi, yi_p)) and bool(torch.equal(y, y_p))
            require(same and yi.dtype == torch.int32 and y.dtype ==
                    torch.float32 and bool(torch.isfinite(y).all()),
                    f"qdot M={M} K={K} N={N}: the card's product differs "
                    f"from the exact plain one")
            ms = cuda_ms(lambda: I.qdot(x, w), reps=50)
            with plain_int8_product():
                plain_ms = cuda_ms(lambda: I.qdot(x, w), reps=20)
            mm_ms = cuda_ms(lambda: I.int_mm(xi, w.operand), reps=50)
            nbytes = M * K * 2 + K * N + N * 4 + M * N * 4
            bound = max(nbytes / PEAK_BYTES_PER_S,
                        2 * M * K * N / PEAK_INT8_OPS) * 1e3
            cases.append({"M": M, "K": K, "N": N, "ms": ms,
                          "int_mm_ms": mm_ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bitwise": same})
    rec = {"name": "qdot", "route": "torch._int_mm (library call)",
           "replaces": "rnnt_tpu/ops/int8_exec.py:60 lax.dot_general "
                       "(outside any Pallas kernel)", "card": smi,
           "cases": cases}
    log("int8_qdot " + json.dumps(rec))
    return rec


def padded_mel(cfg, audio, device="cuda"):
    """The request's log-mel features padded to its frame bucket, as the
    service pads them: (mel [1, t_pad, feat], t)."""
    import torch

    from rnnt_tpu_torch.ops import features as F

    mel = F.preprocess_audio(torch.from_numpy(audio).to(device), cfg)
    t = mel.shape[0]
    t_pad = max(64, 1 << (t - 1).bit_length())
    mel_p = torch.zeros((1, t_pad, mel.shape[1]), device=device)
    mel_p[0, :t] = mel
    return mel_p, t


def direct_greedy_text(model, tokenizer, cfg, audio):
    """The service's greedy transcript of one request (the audio as its
    16-bit WAV body carries it), decoded here from the model directly."""
    import torch

    from rnnt_tpu_torch.data.audio_io import read_wav
    from rnnt_tpu_torch.decode.greedy import greedy_decode_encoded

    pcm, _ = read_wav(io.BytesIO(wav_bytes(audio)))
    with torch.no_grad():
        mel_p, t = padded_mel(cfg, pcm)
        enc, _ = model.encode(mel_p)
        tok, n, _ = greedy_decode_encoded(
            model, enc, model.encoded_length(torch.tensor([t],
                                                          device="cuda")),
            max_output_length=MAX_TOKENS)
    return tokenizer.decode(tok[0, : int(n[0])].tolist())


def start_quantized_server(art, int8_exec):
    from rnnt_tpu_torch.serve import Server

    t0 = time.perf_counter()
    srv = Server(RUN_DIR, http_port=0, stream_port=0, device="cuda",
                 warmup=True, warmup_beams=(0, BEAM), quantized=art,
                 int8_exec=int8_exec)
    log(f"{'int8-exec' if int8_exec else 'dequantized'} server up in "
        f"{time.perf_counter() - t0:.1f} s (warmup "
        f"{srv.warmup_seconds:.1f} s), int8 weights "
        f"{len(srv.service.model.int8_names())}, info "
        f"{json.dumps(srv.service.info())}")
    srv.serve_background()
    return srv


def drive_int8_path(name, fn, expect, int8_calls):
    """drive_path, with qdot's card-path count (`int_mm.launches`) set to
    0 before and read after: it must be positive when int8_calls and 0
    otherwise.  Returns (fn's result, launches with an `int_mm` entry)."""
    from rnnt_tpu_torch.ops import int8_exec

    int8_exec.int_mm.launches = 0
    out, launches = drive_path(name, fn, expect)
    launches["int_mm"] = int8_exec.int_mm.launches
    log(f"path {name}: {launches['int_mm']} int8 products on the card")
    require((launches["int_mm"] > 0) == int8_calls,
            f"path {name}: {launches['int_mm']} int8 products on the card")
    return out, launches


def profile_int8_request(model, mel_p, t, label, smi):
    """Device ops and idle share of the encoder (K2) and of greedy decoding
    on int8 weights for one request; the int8 products' share of a greedy
    joint step's wall time from CUDA events at B=1."""
    import torch

    from rnnt_tpu_torch.decode.greedy import greedy_decode_encoded
    from rnnt_tpu_torch.ops import int8_exec, lstm_cuda

    enc_len = model.encoded_length(torch.tensor([t], device=mel_p.device))
    with torch.no_grad():
        enc, _ = model.encode(mel_p)
        for phase, fn, kernel, symbol in (
                ("encoder", lambda: model.encode(mel_p),
                 lstm_cuda.lstm_seq_infer, "lstm_infer_lat_kernel"),
                ("decode", lambda: greedy_decode_encoded(
                    model, enc, enc_len, max_output_length=MAX_TOKENS),
                 int8_exec.int_mm, None)):
            plain_wall, wall, busy, event_wall, ops, launches, runs = \
                device_profile(fn, kernel, symbol)
            what = f"profile int8-exec {label} {phase}"
            require(busy <= wall, f"{what}: device busy {busy} ms exceeds "
                    f"wall {wall} ms on one stream")
            log(f"{what}: wall {wall:.2f} ms between the markers (CUDA "
                f"events {event_wall:.2f}, {plain_wall:.2f} without the "
                f"profiler), device busy {busy:.2f} ms ({ops} device ops, "
                f"{launches} {'int8 products' if symbol is None else 'K2'}"
                f"), idle share {1 - busy / wall:.3f}, profiled runs {runs} "
                f"({smi})")
        # one greedy joint step at B=1 and its two int8 products alone
        pred = torch.randn((1, model.cfg.projection_size), device="cuda").to(
            enc.dtype)
        enc_t = enc[:, 0]
        step_ms = cuda_ms(lambda: model.joint_step(enc_t, pred), reps=200)
        h = torch.tanh(int8_exec.qdot(enc_t + pred, model.joint.w1))
        qdot_ms = (cuda_ms(lambda: int8_exec.qdot(enc_t + pred,
                                                  model.joint.w1), reps=200)
                   + cuda_ms(lambda: int8_exec.qdot(h, model.joint.w2),
                             reps=200))
        state = model.prediction_zero_state(1, enc.dtype)
        tok = torch.ones((1,), dtype=torch.long, device="cuda")
        pstep_ms = cuda_ms(lambda: model.predict_step(tok, state), reps=200)
    log(f"int8-exec greedy step ({label}, B=1, CUDA events, {smi}): joint "
        f"step {step_ms:.4f} ms, of it its two qdots {qdot_ms:.4f} ms "
        f"({qdot_ms / step_ms:.2f}); prediction-net step {pstep_ms:.4f} ms")


def check_quantized_serving(paths, srv, cfg, audios, art, smi):
    """The dequantized and the int8-exec servers on the run directory's
    int8 artifact, each a driven path: greedy and ?beam=BEAM requests of
    the three WAVs, and on the int8-exec server one TCP session.  The
    dequantized server's greedy texts must equal a direct decode on the fp
    model loaded with the same dequantized weights; the int8-exec server's
    those of the same int8 model with qdot's plain product on the card."""
    import copy

    from rnnt_tpu_torch.ops.quantize import load_quantized_into_

    tokenizer = srv.service.tokenizer
    for int8 in (False, True):
        mode = "int8_exec" if int8 else "dequant"
        qsrv = start_quantized_server(art, int8)
        try:
            greedy, paths[f"{mode}_greedy_http"] = drive_int8_path(
                f"{mode} greedy HTTP", lambda: post_requests(qsrv, audios),
                ("log_mel_frontend", "lstm_seq_infer"), int8)
            beam_kernels = (("log_mel_frontend", "lstm_seq_infer") if int8
                            else ("log_mel_frontend", "lstm_seq_infer",
                                  "beam_search"))
            beam, paths[f"{mode}_beam_http"] = drive_int8_path(
                f"{mode} beam {BEAM} HTTP", lambda: post_requests(
                    qsrv, audios, f"?beam={BEAM}"), beam_kernels, int8)
            require(paths[f"{mode}_beam_http"]["beam_search"] ==
                    (0 if int8 else len(audios)),
                    f"{mode} beam: K3 launches "
                    f"{paths[f'{mode}_beam_http']['beam_search']}")
            if not int8:
                require_streamed_k3("dequant_beam_http",
                                    paths["dequant_beam_http"])
            else:
                _, paths["int8_exec_stream_tcp"] = drive_int8_path(
                    "int8_exec stream TCP", lambda: tcp_session(
                        qsrv, audios[1]),
                    ("log_mel_frontend", "lstm_seq_infer"), True)
            direct = copy.deepcopy(srv.service.model)
            load_quantized_into_(direct, art, int8)
            with (plain_int8_product() if int8 else contextlib.nullcontext()):
                want = [direct_greedy_text(direct, tokenizer, cfg, a)
                        for a in audios]
            got = [r["text"] for r in greedy]
            require(got == want, f"{mode} server's greedy texts differ from "
                    f"the direct decode ({[len(t) for t in got]} vs "
                    f"{[len(t) for t in want]} characters)")
            log(f"{mode} server: greedy texts identical to the direct decode "
                f"({'plain int8 product' if int8 else 'fp model, same'} "
                f"weights), {[len(t) for t in got]} characters; "
                f"request ms greedy {[round(r['latency_ms'], 2) for r in greedy]}"
                f", beam {[round(r['latency_ms'], 2) for r in beam]} "
                f"({smi})")
            if int8:
                for audio, secs in zip(audios, REQUEST_SECONDS):
                    mel_p, t = padded_mel(cfg, audio)
                    profile_int8_request(qsrv.service.model, mel_p, t,
                                         f"{secs:g} s", smi)
            del direct
        finally:
            qsrv.shutdown()


def check_int8_entry_points(paths, data_dir, train_run, art, smi):
    """cli/run_rnnt.py --mode eval on the train phase's checkpoint and its
    int8 artifact with --int8_exec (greedy WER printed, no loss), then
    cli/bench_decode.py --int8 and cli/bench_serve.py --quantized A
    --int8_exec at the smoke run's small settings, each a driven path."""
    from rnnt_tpu_torch.cli import bench_decode, bench_serve, run_rnnt

    train_art = os.path.join(train_run, "model_int8.npz")
    run_quantize(train_run, train_art)

    def eval_main(argv):
        run_rnnt.main(argv)
        return 0

    (out, _), paths["int8_exec_eval"] = drive_int8_path(
        "int8_exec eval", lambda: run_main("run_rnnt eval", eval_main, [
            "--mode", "eval", "--data_dir", data_dir, "--checkpoint",
            train_run, "--output_dir", train_run, "--quantized", train_art,
            "--int8_exec", "--batch_size", str(TRAIN_BATCH), "--pad_frames",
            "256", "--pad_tokens", "64"]), ("lstm_seq_infer",), True)
    line = next((x for x in out if "eval_wer=" in x), "")
    wer = float(line.split("eval_wer=")[1].split()[0]) if line else \
        float("nan")
    require(np.isfinite(wer) and "eval_loss=nan" in line,
            f"int8_exec eval printed {out}")
    log(f"int8_exec eval: greedy WER {wer} ({smi})")

    reps = 2
    (out, _), launches = drive_int8_path(
        "bench_decode_int8", lambda: run_main(
            "bench_decode --int8", bench_decode.main,
            ["--batch", "8", "--frames", "128", "--reps", str(reps),
             "--int8"]), ("lstm_seq_infer", "beam_search"), True)
    paths["bench_decode_int8"] = launches
    rows = ("greedy", "beam-4 cuda E=1", "beam-4 cuda E=6",
            "beam-4 plain E=1", "greedy int8-exec", "greedy dequant",
            "beam-4 xla int8-exec", "beam-4 cuda dequant E=1")
    require(out[0].startswith("int8 exec: pred+joint weights ")
            and len(out) == 2 + len(rows) and all(
                line.startswith(f"{r:20s} ")
                for r, line in zip(rows, out[2:])),
            f"bench_decode --int8 rows {out}")
    require(launches["beam_search"] == 3 * (reps + 1),
            f"bench_decode --int8: {launches['beam_search']} K3 launches")

    threads = set(__import__("threading").enumerate())
    (out, _), paths["bench_serve_int8"] = drive_int8_path(
        "bench_serve_int8", lambda: run_main(
            "bench_serve --quantized --int8_exec", bench_serve.main,
            ["--checkpoint", RUN_DIR, "--requests", "8", "--concurrency",
             "2", "--quantized", art, "--int8_exec"]),
        ("log_mel_frontend", "lstm_seq_infer"), True)
    heads = ("rtt_ms: ", "cold start: ", "first beam-4 request: ",
             "sequential: ", "concurrent x2: ", "streaming: ")
    require(len(out) == len(heads) and all(
        line.startswith(h) for h, line in zip(heads, out)),
        f"bench_serve int8 lines {out}")
    require(paths["bench_serve_int8"]["beam_search"] == 0,
            "bench_serve --int8_exec launched K3")
    import threading

    for t in set(threading.enumerate()) - threads:
        t.join(timeout=10)
    left = [t.name for t in set(threading.enumerate()) - threads]
    require(not left, f"bench_serve int8 left threads running: {left}")


def check_flac(paths, audio):
    """A 5 s WAV's samples encoded as FLAC (tests/flac_fixture.py's encoder)
    transcribe, through cli/transcribe_file.py on the card, as the WAV
    does; the decoded samples equal the WAV's."""
    import importlib.util

    from rnnt_tpu_torch.cli import transcribe_file
    from rnnt_tpu_torch.data.audio_io import read_audio, write_wav

    # by its path: an installed package named `tests` may shadow the
    # repository's tests/ directory, which is not a package
    spec = importlib.util.spec_from_file_location(
        "flac_fixture", os.path.join(REPO, "tests", "flac_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    encode_flac = fixture.encode_flac

    d = os.path.join(TRAIN_DIR, "flac")
    os.makedirs(d, exist_ok=True)
    wav, flac = os.path.join(d, "a.wav"), os.path.join(d, "a.flac")
    write_wav(wav, audio, 16000)
    pcm, _ = read_audio(wav)
    t0 = time.perf_counter()
    with open(flac, "wb") as f:
        f.write(encode_flac(np.round(pcm * 32768.0).astype(np.int64),
                            blocksize=4096))
    log(f"FLAC of {len(pcm)} samples: {os.path.getsize(flac)} B, encoded in "
        f"{time.perf_counter() - t0:.1f} s")
    decoded, sr = read_audio(flac)
    require(sr == 16000 and np.array_equal(decoded, pcm),
            "the FLAC's decoded samples differ from the WAV's")

    def transcribe(path):
        return run_main("transcribe_file", lambda argv: (
            transcribe_file.main(argv), 0)[1], ["--checkpoint", RUN_DIR,
                                                "-i", path])[0]

    (texts, paths["flac"]) = drive_path(
        "flac", lambda: (transcribe(flac), transcribe(wav)),
        ("log_mel_frontend", "lstm_seq_infer"))
    require(texts[0] == texts[1] and len(texts[0]) == 1,
            f"FLAC and WAV transcripts differ: {texts}")
    log(f"FLAC and WAV transcripts identical ({len(texts[0][0])} "
        f"characters)")


def check_loss_oracle(paths, seed, B=4, T=64, U=32, J=640, V=4096):
    """K7 (--loss_impl pallas: the lattice over materialised logits) and
    the fused loss (K6 + K7) in fp32 on the card against the port's OpenMP
    oracle (native/rnnt_loss_cpu.cc) on the same logits, ragged lengths:
    the losses rtol 1e-4; K7's d/dlogits rtol 1e-3 / atol 1e-4 element by
    element, as tests/test_native.py holds the oracle.  The fused loss has
    no d/dlogits: its gradients of f, g, b1, w2 and b2 are held against the
    oracle's d/dlogits carried back through the joint by autograd, each to
    a relative error of 1e-3 of its largest magnitude (the gate
    `check_train_step_fp32` puts on a step's gradients).  Element by element
    they cannot meet atol 1e-4: an element of dW2, db2 or db1 sums B T (U+1)
    cells, each carrying the lattice's fp32 roundoff (K7's d/dlogits differ
    from the oracle's by up to ~2e-4, within the bound), and some cancel
    towards 0."""
    import torch

    from rnnt_tpu_torch.native.loss import rnnt_loss_cpu
    from rnnt_tpu_torch.ops.joint_loss_fused import rnnt_loss_fused
    from rnnt_tpu_torch.ops.rnnt_loss import rnnt_loss

    rng = np.random.default_rng(seed + 13)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    f = put(rng.standard_normal((B, T, J)) * 0.5).requires_grad_(True)
    g = put(rng.standard_normal((B, U + 1, J)) * 0.5).requires_grad_(True)
    b1 = put(rng.standard_normal(J) * 0.1).requires_grad_(True)
    w2 = put(rng.standard_normal((J, V)) * 0.05).requires_grad_(True)
    b2 = put(rng.standard_normal(V) * 0.1).requires_grad_(True)
    labels_np = rng.integers(1, V, (B, U)).astype(np.int32)
    fl_np = np.array([T, T - 4, T - 14, T], np.int32)[:B]
    yl_np = np.array([U, U - 2, U - 12, U], np.int32)[:B]
    labels = torch.from_numpy(labels_np).long().cuda()
    fl = torch.from_numpy(fl_np).long().cuda()
    yl = torch.from_numpy(yl_np).long().cuda()
    logits = torch.tanh(f[:, :, None] + g[:, None] + b1) @ w2 + b2
    t0 = time.perf_counter()
    want, want_grad = rnnt_loss_cpu(logits.detach().cpu().numpy(), labels_np,
                                    fl_np, yl_np, with_grad=True)
    oracle_s = time.perf_counter() - t0
    grad_ref = torch.autograd.grad(logits, (f, g, b1, w2, b2),
                                   put(want_grad))

    def close(got, ref, rtol, atol):
        got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
        excess = ((got - ref).abs() - (atol + rtol * ref.abs())).max()
        return float(excess) <= 0, float((got - ref).abs().max())

    def k7():
        x = logits.detach().clone().requires_grad_(True)
        loss = rnnt_loss(x, labels, fl, yl, impl="pallas")
        loss.sum().backward()
        return loss, x.grad

    def fused():
        loss = rnnt_loss_fused(f, g, b1, w2, b2, labels, fl, yl)
        grads = torch.autograd.grad(loss.sum(), (f, g, b1, w2, b2))
        return loss, grads

    (res, paths["loss_oracle"]) = drive_path(
        "loss_oracle", lambda: (k7(), fused()),
        ("joint_planes", "lattice_scan"))
    (k7_loss, k7_grad), (f_loss, f_grads) = res
    want_t = torch.from_numpy(want)
    ok, err = close(k7_loss, want_t, 1e-4, 0.0)
    ok_g, err_g = close(k7_grad, torch.from_numpy(want_grad), 1e-3, 1e-4)
    log(f"loss oracle B={B} T={T} U={U} V={V} fp32 (oracle {oracle_s:.2f} s "
        f"on the host): K7 loss max |d| {err:.3e}, grad max |d| "
        f"{err_g:.3e}")
    require(ok and ok_g, f"K7 disagrees with the OpenMP oracle: loss "
            f"{err}, grad {err_g}")
    ok, err = close(f_loss, want_t, 1e-4, 0.0)
    errs = []
    for name, got, ref in zip(("f", "g", "b1", "w2", "b2"), f_grads,
                              grad_ref):
        _, e = close(got, ref, 0.0, 0.0)
        errs.append((name, e, rel_err(got, ref)))
    log(f"loss oracle fused (K6 + K7): loss max |d| {err:.3e}, grads max "
        f"|d| (relative to the largest) " + ", ".join(
            f"{n} {e:.3e} ({r:.3e})" for n, e, r in errs))
    require(ok and all(r <= 1e-3 for _, _, r in errs), f"the fused loss "
            f"disagrees with the OpenMP oracle: loss {err}, grads {errs}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "rnnt_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.kernels import build
    from rnnt_tpu_torch.models.transducer import Transducer
    from rnnt_tpu_torch.ops import features as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    from rnnt_tpu_torch.cli.benchutil import nvidia_smi_line

    smi = nvidia_smi_line()
    log(f"device: {kind} ({smi}); torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")

    cfg = RNNTConfig()
    rng = np.random.default_rng(args.seed)
    audios = [synthetic_audio(s, rng) for s in REQUEST_SECONDS]
    t0 = time.perf_counter()
    model32 = Transducer(cfg).init_(args.seed)
    log(f"parity model: {sum(p.numel() for p in model32.parameters())} "
        f"params, init {time.perf_counter() - t0:.1f} s")

    def padded_mel(audio, device="cuda"):
        mel = F.preprocess_audio(torch.from_numpy(audio).to(device), cfg)
        t = mel.shape[0]
        t_pad = max(64, 1 << (t - 1).bit_length())
        mel_p = torch.zeros((1, t_pad, mel.shape[1]), device=device)
        mel_p[0, :t] = mel
        return mel_p, t

    srv = None
    try:
        t0 = time.perf_counter()
        write_run_dir(model32, cfg, RUN_DIR)
        log(f"run dir written in {time.perf_counter() - t0:.1f} s")
        srv = start_server()
        served = srv.service.model
        paths = {}
        records, paths["greedy_http"] = drive_path(
            "greedy HTTP", lambda: post_requests(srv, audios),
            ("log_mel_frontend", "lstm_seq_infer"))
        beam_records, paths["beam_http"] = drive_path(
            f"beam {BEAM} HTTP", lambda: post_requests(srv, audios,
                                                       f"?beam={BEAM}"),
            ("log_mel_frontend", "lstm_seq_infer", "beam_search"))
        require(all(r["launches"]["beam_search"] == 1 for r in beam_records),
                "one beam launch a request")
        require_streamed_k3("beam_http", paths["beam_http"])
        _, paths["stream_tcp"] = drive_path(
            "stream TCP", lambda: tcp_session(srv, audios[1]),
            ("log_mel_frontend", "lstm_seq_infer"))
        t_phase = time.perf_counter()

        k1 = check_frontend(cfg, audios)
        mel_long, t_long = padded_mel(audios[-1])
        k2 = check_lstm_layer(served, mel_long)
        k2["designs_by_case"] = check_lstm_cases(cfg.encoder_size,
                                                 cfg.projection_size)
        for audio, secs in zip(audios, REQUEST_SECONDS):
            profile_request(served, *padded_mel(audio), f"{secs:g} s bf16")
            profile_beam(served, *padded_mel(audio), f"{secs:g} s bf16")
        log(f"phase K1/K2 checks and profiles: "
            f"{time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        model32 = model32.cuda()
        for audio in audios:
            mel_p, t = padded_mel(audio)
            check_encoder_and_greedy(model32, mel_p, t, 1e-4, True)
            check_encoder_and_greedy(served, mel_p, t, 2e-2, False)
        log(f"phase encoder and greedy checks: "
            f"{time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        # three utterances of up to 2 s in the 128-frame bucket
        short = [audios[0], audios[1][: 16000 * 3 // 2], audios[2][:16000]]
        mels = [padded_mel(a) for a in short]
        batch = torch.zeros((3, 128, cfg.input_feat_size), device="cuda")
        for i, (m, t) in enumerate(mels):
            batch[i, :t] = m[0, :t]
        cases = [("B=3 128-bucket", batch,
                  torch.tensor([t for _, t in mels]), False, MAX_TOKENS)]
        mel_p, t = padded_mel(audios[1])
        cases.append(("5 s, joint x8", mel_p, torch.tensor([t]), True,
                      MAX_TOKENS))
        # with --seed 0 the sharp joint emits 6 tokens in the 15 s request's
        # first 60 frames and 16 in all 250 (fp32): a cap of 8 is reached
        # well before the end, then only blanks settle
        mel_p, t = padded_mel(audios[2])
        cases.append(("15 s, joint x8", mel_p, torch.tensor([t]), True, 8))
        for audio, secs in zip(audios, REQUEST_SECONDS):
            mel_p, t = padded_mel(audio)
            cases.append((f"{secs:g} s", mel_p, torch.tensor([t]), False,
                          MAX_TOKENS))
        k3 = check_beam(model32, served, cfg, cases)
        log(f"phase beam checks and times: "
            f"{time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        check_stream_kernels(model32, srv.service.tokenizer, audios[1])
        log(f"phase stream kernels vs plain: "
            f"{time.perf_counter() - t_phase:.1f} s")
        del model32
        t_phase = time.perf_counter()
        train_kernels = ("lstm_fwd", "lstm_bwd", "lattice_scan")
        data = os.path.join(TRAIN_DIR, "data")
        write_train_data(cfg, data, TRAIN_STEPS * TRAIN_BATCH, TRAIN_BATCH,
                         args.seed)
        _, paths["train_cli"] = drive_path(
            "train_cli (fused loss)", lambda: run_train_cli(
                data, os.path.join(TRAIN_DIR, "run_fused"), "fused",
                TRAIN_STEPS),
            train_kernels + ("joint_planes", "lstm_seq_infer"))
        require_train_launches("train_cli", paths["train_cli"], TRAIN_STEPS,
                               1, pallas=False)
        for name in ("greedy_http", "beam_http", "stream_tcp", "train_cli"):
            require_resident_k2(name, paths[name])
        data = os.path.join(TRAIN_DIR, "data_pallas")
        write_train_data(cfg, data, TRAIN_BATCH, TRAIN_BATCH, args.seed + 1)
        _, paths["train_pallas_loss"] = drive_path(
            "train_pallas_loss", lambda: run_train_cli(
                data, os.path.join(TRAIN_DIR, "run_pallas"), "pallas", 1),
            train_kernels)
        require_train_launches("train_pallas_loss", paths["train_pallas_loss"],
                               1, 1, pallas=True)
        log(f"phase training paths: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        timed, k3["bench_decode_inputs"] = drive_bench_entry_points(
            paths, cfg, args.seed)
        k3["max_abs_err"] = max([k3["max_abs_err"]] + [
            r["max_abs_err"] for r in k3["bench_decode_inputs"].values()])
        log(f"phase bench entry points: "
            f"{time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        art = os.path.join(RUN_DIR, "model_int8.npz")
        run_quantize(RUN_DIR, art)
        check_qdot(smi)
        check_quantized_serving(paths, srv, cfg, audios, art, smi)
        check_int8_entry_points(paths, os.path.join(TRAIN_DIR, "data"),
                                os.path.join(TRAIN_DIR, "run_fused"), art,
                                smi)
        check_flac(paths, audios[1])
        check_loss_oracle(paths, args.seed)
        log(f"phase int8, FLAC and loss oracle: "
            f"{time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        k45 = check_lstm_train(cfg.encoder_size, cfg.projection_size)
        designs = check_lstm_designs(cfg.encoder_size, cfg.projection_size)
        for k in k45:
            k["designs_by_case"] = {case: d[k["name"]]
                                    for case, d in designs.items()
                                    if k["name"] in d}
        k6, planes32 = check_planes(cfg)
        k7 = check_lattice(planes32)
        k7["ms_by_wide_U1"] = check_lattice_wide()
        del planes32
        check_train_step_fp32(cfg, args.seed)
        log(f"phase K4-K7 checks and times: "
            f"{time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        bench_train_step(smi, timed, args.seed)
        log(f"phase bench-geometry train step: "
            f"{time.perf_counter() - t_phase:.1f} s")
        kernels = [k1, k2, k3, *k45, k6, k7]
        per_request = {"greedy_http": records, "beam_http": beam_records}
        for k in kernels:
            name = k["name"]
            k["launches"] = sum(p[name] for p in paths.values())
            k["launches_by_path"] = {path: counts[name]
                                     for path, counts in paths.items()}
            k["launches_per_request"] = {
                path: [r["launches"][name] for r in recs]
                for path, recs in per_request.items()}
            if f"{name}_by_design" in paths["train_cli"]:
                k["launches_by_design"] = {
                    d: sum(p[f"{name}_by_design"][d] for p in paths.values())
                    for d in paths["train_cli"][f"{name}_by_design"]}
            log(f"{name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f}, "
                f"bound {k['bound_ms']:.5f} by {k['bound_by']}, library "
                f"{k['library_ms']}), launches {k['launches_by_path']}")
    finally:
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(RUN_DIR, ignore_errors=True)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
