#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (rnnt_tpu_torch) on one H100.

  python3 chip_smoke.py [--seed 0] [--phases all]

--phases takes a comma list of the phases below (PHASES: serving, k1_k2,
encoder_greedy, beam, stream_kernels, export, training, conformer,
bench_entry_points, data_prep, int8_flac_oracle, k4_k7, bench_step,
data_parallel, tensor_parallel); a phase brings the phases it reads from (PHASE_NEEDS),
and the default runs every phase and every gate.  Each phase logs its
time.  A plain version's comparison run is timed as it runs (`once_ms`)
and not run again to be timed.

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
   and, fused, the plane kernel (K6, every launch its WGMMA design) once,
   every chunk of the fused loss's backward on K8 and K9 (train_cli,
   bench_train and the bench step); then the Conformer (`conformer`):
   its convolution module's K10 and K11 against their plain versions in
   bf16 at conformer-l.train-b64's shapes and at three shapes at the
   kernels' edges (an odd kernel longer than the utterance, one partial
   chunk of one channel tile, an odd kernel over two chunks), and the
   module's path against its formula (`check_conv_module`), timed beside
   their bound and the formula; and `train_conformer`, three steps of
   make_train_step at conformer-l.train-b64's widths and batch (17 blocks
   of 512, B=64, 1600 frames, uneven lengths, 72 pieces, Adam, fused
   loss), with one K10 and one K11 launch a block a step and every module
   call on the kernels (`conv_module_launches_by_path`); it prints each request's latency
   split into frontend, encoder and decode with its launches, and each
   stream chunk's reply latency (p50, p99, max); then the measurement
   entry points, each a path of its own, called in this process as
   main(argv) on the card with stdout and stderr captured and printed:
   `bench_train`, rnnt_tpu_torch.bench (bench.py's geometry, a warm-up and
   10 timed steps: its one JSON line, a finite positive value, K4 and K5
   10 launches a step, every K6 launch WGMMA and every K7 launch warp);
   `bench_loss`, cli.bench_loss --B 8 --iters 3 (ref, pallas, fused; the
   fused line's TFLOP/s; K6 and K7 launched); `bench_decode`,
   cli.bench_decode --batch 8 --frames 128 --reps 1 (its four rows; one K3
   launch a search of the two cuda rows, none by the plain row; after the
   path, K3 on the same inputs at E=1 and E=6, where N = 32 hypothesis
   rows must run the FMA design, held against the plain search by the
   beam gate below at the bf16 tolerance);
   `bench_streaming_latency`, cli.bench_streaming --chunks 20 (K1 and K2);
   `bench_streaming_wer`, cli.bench_streaming against the run directory
   and three WAVs of 2-3 s with their trans.txt in LibriSpeech layout (3
   utterances, both WERs finite); `bench_serve`, cli.bench_serve on the run
   directory with --requests 4 --concurrency 2 (every line printed, K1, K2
   and K3 launched, no server thread left running); each must return 0;
   then data preparation and augmented training on a LibriSpeech-layout
   corpus written from --seed (48 train, 8 dev, 8 test utterances of 2-8 s,
   half FLAC, half WAV, transcripts from a fixed word list):
   `prep_librispeech`, cli.preprocess_librispeech on the card (word-piece,
   --vocab_size 4096 --pad_vocab, 2 shards; its config.json the parity
   config), exactly one K1 launch per utterance kept and no other kernel,
   each written example's features within 2e-4 of the plain frontend in
   fp64 on the card for the same audio and its labels the written tokenizer's
   encode; `prep_parallel`, the same with --workers 2, every file
   byte-identical to the serial run's; debug_dataset on each split and
   corpus_stats on the train split; `train_specaug_profiled`,
   cli.run_rnnt --mode train on those shards at batch 32 for 2 steps with
   2 frequency and 2 time masks and --profile_dir (per step 10 K4, all
   MMA, and 10 K5 launches; every K6 launch WGMMA and every K7 launch warp;
   the eval's K2 resident; finite losses; the trace names K4's, K5's and
   K6's kernels); and SpecAugment on a B=8 batch of those features on the
   card in fp32 and bf16 (whole frames and whole bins, in every stacked
   copy, set to zero; padding never masked; the rest untouched; equal to
   the CPU's masks from the same draws); then export and the banded loss:
   `export_transcribe`, cli.export_model on the run directory (fp32,
   frozen, --batch 1 --frames 512 --max_output_length 200 --check; it
   writes the streaming step too), then `export.load_artifact` of the
   transcribe .pt2 called on the 15 s request's log-mel (its call must
   launch K2, every launch FMA, no call of K2's plain version, and give the
   live eager greedy decode's tokens and lengths; export, load and call
   times and each .pt2's size printed); `export_streaming`, the streaming
   step's .pt2 loaded and run over the 5 s request's log-mel in chunks of
   4 stacked frames from `streaming_init_state` (tokens, n and every state
   tensor equal to the live chunked decode's at every chunk, K2 launched
   by every chunk, all FMA); the host cost of K2's registered operator
   over a direct wrapper call; `train_banded`, cli.run_rnnt --loss_impl
   banded on its own synthetic shards, 2 bf16 steps at B=32 and one eval
   batch (finite losses, an eval line, a checkpoint restored, per step 10
   K4 (MMA) and 10 K5 launches, one K6 (WGMMA) and one K7 (warp));
   and data parallelism (`data_parallel`): `dp_nccl`, cli.run_rnnt
   --multihost as one process on NCCL (bf16, B=32, 2 steps and an eval
   batch writing a .dcp checkpoint, then --checkpoint auto resuming from
   it for one more step and an eval batch; per step 10 K4 (MMA), 10 K5,
   one K6 (WGMMA), one K7 (warp)); `dp_two_ranks`, two processes sharing
   the card over gloo (`--dp_worker`), fp32, one step at B=16 a rank
   against one process's step on both ranks' rows: loss <= 1e-5, every
   gradient <= 1e-4, the BatchNorm statistics and every updated parameter
   <= 1e-5 relative error (a parameter that was zero before the step, which
   then holds its update alone, <= 1e-4), per rank 10 K4, 10 K5, one K6 and
   one K7 (warp); `bench_scaling`, cli.bench_scaling --devices 1 at B=32
   for 3 steps (its JSON line, efficiency_vs_1dev 1.0);
   and vocab tensor parallelism (`tensor_parallel`): `tp_two_ranks`, two
   processes sharing the card over gloo as a 1x2 (data, model) mesh
   (`--tp_worker`), fp32, one step at B=16 on rows both hold with W2 and
   b2 sharded (V_local 2048) and grad_clip_norm 1e-3 (clipping engages),
   against one process's step on the same rows within the dp_two_ranks
   bounds (W2, b2 and their gradients gathered), per rank 10 K4, 10 K5,
   one K6 at V=2048 and one K7 (warp); `tp_cli`, two processes
   (`--tp_cli_worker`) running cli.run_rnnt --multihost --model_parallel 2
   (bf16, B=32, 2 steps, an eval batch decoded greedily with W2 gathered,
   an npz checkpoint; per rank and step 10 K4 (MMA), 10 K5, one K6 (WGMMA,
   V=2048), one K7 (warp)), then one process's `--mode eval` of that
   checkpoint: eval loss within 1e-4 relative and the same decoded tokens;
   `bench_tp`, cli.bench_tp at its defaults (its lines; every K6 launch
   WGMMA); the dry run, rnnt_tpu_torch.dryrun over 4 processes sharing
   the card (a 2x2 mesh, the tiny config), its line;
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
   (which it must reach, with merges), in fp32 and in bf16, against the
   plain search run along the kernel's picks: scores finite and sorted,
   lengths within the cap, token ids in [1, V), every live score within
   1e-4 (fp32) or 1e-2 (bf16) relative error, slot-0 tokens and lengths
   identical, and at every selection the kernel's picks the plain
   search's own top K up to a near tie (its top-K values above theirs by
   at most 1e-4 plus twice the score drift so far); every bf16 case runs the
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
   held to the new W2's plain planes, which reject the old call's; K6 on
   vocabulary shards, V_local 2048 and 1024 (shards 0 and 1 of V=4096,
   the labels shifted, so ids fall below 0 and at or above V_local), in
   bf16 WGMMA (J=640), bf16 WMMA (J=768) and fp32 FMA, at the bounds
   above, emit exactly NEG wherever the id is outside the shard; K7
   (alpha and beta over the valid cells, ll) from those planes at B=32 and
   B=96 (the planes three times over) with ragged lengths, on its warp
   design, and from random planes at U+1 = 1 (warp), 257, 1025 and 1537 (the
   block design; runs of positions a thread above 1024), <= 1e-5, inputs
   untouched; and one whole fp32 train step at the parity width (B=32,
   T=256, U=64) through K4-K7 on the card against the same step on the CPU
   (every wrapper's plain version; a process of its own started before
   the int8 phase, so it overlaps the card's phases): loss <= 1e-4 and
   every gradient <= 1e-3 relative error; the banded loss at the train
   shapes (B=32, T'=128, U+1=65, band 32): K6 at the banded row shapes
   (512 rows of 8 x 32 cells) against its plain planes (fp32 FMA <= 1e-4,
   bf16 WGMMA <= PLANES_BF16_TOL, inputs untouched), K7 over the banded,
   mostly NEG planes against the plain scans (finite, the same reachable
   cells, <= 1e-5 on them), a band >= U+1 equal to the fused loss (fp32: loss
   1e-5, gradients 1e-4 relative), at band 32 the NLL >= the exact NLL -
   1e-4 for every utterance and loss and gradients within 1e-4 and 1e-3 of
   the same function on the host CPU, a fully pruned utterance at 1e9 with
   exactly zero gradient rows; and a bf16 train step fused against banded
   at B=32 timed in turns; the fused loss's backward in bf16 on K8 and K9
   with its two products against the plain chain (df, dg, db1, dW2, db2
   each within LOSS_BWD_TOL of its largest magnitude, inputs untouched) at
   both cells' shapes (B=96, T'=128, J=640: U+1=65, V=4096 and U+1=116,
   V=31), a ragged B=3, T'=7, U+1=5, J=40, V=300 and shard 1 of two at
   V_local 2048 (no blank, ids outside), the wp4096 case twice equal bit
   for bit, K9 against its plain version, and fp32 and J=1024 backward
   chunks on the plain chain;
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
6. prints a `kernels` JSON line for K1-K9 (launches on the driven paths,
   median kernel time, plain and library times, the roofline bound, max
   error; for K1 and K7 the device time with a spin kernel queued ahead,
   since their launches are shorter than their host calls, for K1 also at a
   7-frame stream chunk, the wrapper's host-bound call time and the plain
   version's op chain as `composite_ms`, for K7 also at B=96 and at the
   edge widths; for K2, K4 and K5 the cuDNN yardstick's median, minimum and
   maximum of 30 runs and the launches by design, for K2 also the time of
   a one-step launch and at B=32, T=256 and each case's design and the
   export paths' record, for K4 and
   K5 also the time at B=96; for K6 the time, bound and cuBLAS product
   at B=96, the W2 packing's own time, the time and bound at the banded
   rows, the fused and banded train steps, the time at each V_local and
   the launches by design; for K8 the whole backward's time at B=96 in
   both cells beside its bound and the plain chain's; for K3
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


def once_ms(fn):
    """(fn()'s result, its milliseconds on the card) from one run, CUDA
    events around it after a synchronise, no warm-up: a plain version's
    comparison run timed as it runs, never repeated to be timed."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


PLAIN_ONCE = ("one run: the comparison's own run of the plain version, "
              "timed once without a warm-up")


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
    from rnnt_tpu_torch.ops import (beam_cuda, conv_module_cuda,
                                    features_cuda, lattice_cuda,
                                    loss_bwd_cuda, lstm_cuda, planes_cuda)

    return {"log_mel_frontend": features_cuda.log_mel_frontend,
            "lstm_seq_infer": lstm_cuda.lstm_seq_infer,
            "beam_search": beam_cuda.beam_search,
            "lstm_fwd": lstm_cuda.lstm_fwd,
            "lstm_bwd": lstm_cuda.lstm_bwd,
            "joint_planes": planes_cuda.joint_planes,
            "lattice_scan": lattice_cuda.lattice_scan,
            "joint_dlogits": loss_bwd_cuda.joint_dlogits,
            "tanh_grads": loss_bwd_cuda.tanh_grads,
            "conv_module_fwd": conv_module_cuda.conv_module_fwd,
            "conv_module_bwd": conv_module_cuda.conv_module_bwd}


def zero_launches() -> None:
    from rnnt_tpu_torch.ops import joint_loss_fused

    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_design"):
            fn.launches_by_design = dict.fromkeys(fn.launches_by_design, 0)
        if hasattr(fn, "launches_by_cluster"):
            fn.launches_by_cluster = dict.fromkeys(fn.launches_by_cluster, 0)
    joint_loss_fused.backward_launches_by_design.update(
        dict.fromkeys(joint_loss_fused.BACKWARD_DESIGNS, 0))


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def read_designs() -> dict:
    """Launches by design: the LSTM kernels' ("lat", "mma", "fma"), the
    beam kernel's ("stream", "fma"), the plane kernel's ("wgmma", "wmma",
    "fma"), the lattice kernel's ("warp", "block") and the fused loss's
    backward chunks (`loss_bwd`: "kernel", K8 and K9; "plain", the chain)."""
    from rnnt_tpu_torch.ops import joint_loss_fused

    w = kernel_wrappers()
    designs = {name: dict(w[name].launches_by_design)
               for name in ("lstm_seq_infer", "lstm_fwd", "lstm_bwd",
                            "beam_search", "joint_planes", "lattice_scan")}
    designs["loss_bwd"] = dict(joint_loss_fused.backward_launches_by_design)
    return designs


def read_clusters() -> dict:
    """K5's cluster-design launches by cluster size."""
    from rnnt_tpu_torch.ops import lstm_cuda

    return dict(lstm_cuda.lstm_bwd.launches_by_cluster)


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
    (h_p, c_p), plain_ms = once_ms(
        lambda: lstm_cuda.lstm_seq_infer_plain(*args))
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
        "plain_ms": plain_ms,
        "plain_ms_note": PLAIN_ONCE,
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
    launches["lstm_bwd_by_cluster"] = read_clusters()
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


def plain_along(model, enc, enc_len, trace, kw):
    """The plain search on `model` along a kernel run's picks (its
    `trace`): (result, stats with "own" and "slack"), for `gate_beam`."""
    from rnnt_tpu_torch.decode.beam import beam_search_encoded_plain

    stats = {}
    want = beam_search_encoded_plain(model, enc, enc_len, stats=stats,
                                     follow=trace, **kw)
    return want, stats


def gate_beam(got, trace, want, stats, enc_len, E, V, score_tol):
    """K3's result (tokens, lengths, scores) and trace against the plain
    search run along the kernel's picks (`plain_along`: the same hypotheses
    in the same slots, scored and merged by the plain version, which also
    records the picks it would have made itself).  Returns (failures,
    notes, max |d score|, relative score error); the kernel holds when
    there are no failures.

    - scores finite and sorted descending, lengths within the cap, token
      ids in [1, V);
    - every live beam score within `score_tol` relative error (to the
      largest live score), alive in the same places, and the slot-0 tokens
      and lengths identical: the same picks must build the same hypotheses
      with the same scores;
    - at every selection the kernel's picks are the plain search's own top
      K up to a near tie: the plain's sorted top-K values exceed the sorted
      plain values of the kernel's picks (`slack`) by at most NEAR_TIE plus
      twice the drift so far, the largest |score difference| between the
      kernel's and the plain's value of a pick that both would make in the
      same slot, live in both, up to that selection (two candidates closer
      than that can trade places; a pick the plain search would not make
      does not count towards the drift, so it cannot excuse itself).

    Run along the kernel's picks, the plain search cannot part from it at
    a near tie and then hold a different beam to its scores: the two score
    one path, so a bf16 tie-break within the drift passes, and the final
    beam's scores and tokens are still held to the plain version's."""
    import torch

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
    S = stats["val"].shape[0]
    frame = torch.arange(S) // (2 * E)
    val_k, val_p = trace["val"][:S].cpu(), stats["val"].cpu()
    agree = stats["idx"].cpu() == stats["own"].cpu()
    slack = stats["slack"].cpu()
    for b in range(tk.shape[0]):
        if not (int(lk[b]) == int(lp[b]) and torch.equal(
                tk[b, : lk[b]].cpu(), tp[b, : lp[b]].cpu())):
            fails.append(f"utterance {b}: tokens differ along the same "
                         "picks")
        n = int((frame < int(enc_len[b])).sum())
        vk, vp = val_k[:n, b], val_p[:n, b]
        live = (vk > -1e29) & (vp > -1e29) & agree[:n, b]
        drift = torch.where(live, (vk - vp).abs(),
                            torch.zeros_like(vk)).amax(dim=1)
        allowed = NEAR_TIE + 2 * torch.cummax(drift, dim=0).values
        sl = slack[:n, b]
        left = (sl > 0).nonzero()
        if not len(left):
            continue
        worst = int(sl.argmax())
        what = (f"utterance {b}: {len(left)} of {n} selections left the "
                f"plain's own top K, first at selection {int(left[0])} "
                f"(frame {int(left[0]) // (2 * E)}); the largest slack "
                f"{float(sl[worst]):.3e} at selection {worst}, allowed "
                f"{float(allowed[worst]):.3e} there")
        if bool((sl <= allowed).all()):
            notes.append(what + ": near ties")
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

    from rnnt_tpu_torch.decode.beam import default_expansions
    from rnnt_tpu_torch.ops import beam_cuda

    E = default_expansions(cfg)
    worst_bf16 = 0.0
    control = stale = None
    designs, plain_ms_by_case = {}, {}
    for label, mel_p, lengths, sharp, cap in cases:
        kw = dict(beam_width=BEAM, max_output_length=cap,
                  expansions_per_frame=E)
        for model in (model32, served):
            ctx = sharp_joint(model) if sharp else contextlib.nullcontext()
            dt = str(model.dtype)[6:]
            with torch.no_grad(), ctx:
                enc, _ = model.encode(mel_p)
                enc_len = model.encoded_length(lengths.to(enc.device))
                trace = {}
                got = beam_cuda.beam_search(model, enc, enc_len, trace=trace,
                                            **kw)
                design = beam_cuda.beam_search.last_design
                (want, stats), plain_ms = once_ms(
                    lambda: plain_along(model, enc, enc_len, trace, kw))
                plain_ms_by_case[label, dt] = plain_ms
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
                    control = (sharp, kw, enc, enc_len, label)
    require(control is not None, "no capped case for the control")
    sharp, kw, enc, enc_len, label = control
    ctx = sharp_joint(served) if sharp else contextlib.nullcontext()
    with torch.no_grad(), ctx:
        trace = {}
        with swapped_w2_halves(served):
            got = beam_cuda.beam_search(served, enc, enc_len, trace=trace,
                                        **kw)
        want, stats = plain_along(served, enc, enc_len, trace, kw)
        fails, _, _, rel = gate_beam(got, trace, want, stats, enc_len, E,
                                     cfg.vocab_size,
                                     BEAM_SCORE_TOL["bfloat16"])
    log(f"K3 control ({label}, W2 halves swapped) bf16: lengths "
        f"{got[1].tolist()}, rel err {rel:.3e}, rejected by: {fails}")
    require(fails, "the bf16 beam gate let the swapped-W2 control through")
    check_beam_staleness(served, cfg, stale)
    # times, bound and phases at the 512-frame request in bf16
    label, mel_p, lengths, _, _ = [c for c in cases if c[1].shape[0] == 1
                                   and c[4] == MAX_TOKENS][-1]
    kw = dict(beam_width=BEAM, max_output_length=MAX_TOKENS,
              expansions_per_frame=E)
    with torch.no_grad():
        enc, _ = served.encode(mel_p)
        enc_len = served.encoded_length(lengths.to(enc.device))
        frames = min(enc.shape[1], int(enc_len.max()))
        ms = cuda_ms(lambda: beam_cuda.beam_search(served, enc, enc_len, **kw),
                     reps=5)
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
        # the gate's plain search along the kernel's picks on this request
        "plain_ms": plain_ms_by_case[label, str(served.dtype)[6:]],
        "plain_ms_note": PLAIN_ONCE + " (along the kernel's picks)",
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

    from rnnt_tpu_torch.decode.beam import default_expansions
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
            trace = {}
            got = beam_cuda.beam_search(served, enc, enc_len, trace=trace,
                                        **kw)
            design = beam_cuda.beam_search.last_design
            repacked = beam_cuda.packed_slices(
                served, beam_cuda.grid_blocks(wh.device)) is not packed
            want, stats = plain_along(served, enc, enc_len, trace, kw)
            stale_want, stale_stats = plain_along(served, enc, enc_len,
                                                  before_trace, kw)
            torch.cuda.synchronize()
        finally:
            wh.copy_(orig)
    fails, notes, max_abs, rel = gate_beam(got, trace, want, stats, enc_len,
                                           E, cfg.vocab_size,
                                           BEAM_SCORE_TOL["bfloat16"])
    stale_fails, _, _, stale_rel = gate_beam(
        before, before_trace, stale_want, stale_stats, enc_len, E,
        cfg.vocab_size, BEAM_SCORE_TOL["bfloat16"])
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


def run_train_cli(data_dir, out_dir, loss_impl, steps, device="cuda",
                  pad=(256, 64), extra=()):
    """One training run through rnnt_tpu_torch.cli.run_rnnt (bf16, batch 32,
    one epoch, a log line every step, one eval batch at the end, the
    `pad` (frames, labels) bucket, then the `extra` flags).  Requires
    `steps` finite train losses, one eval line and a checkpoint that the
    port's restore reads back at the same step.  Returns (train losses,
    eval metrics)."""
    import torch

    from rnnt_tpu_torch.cli import run_rnnt
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.train.checkpoint import restore_checkpoint

    shutil.rmtree(out_dir, ignore_errors=True)
    run_rnnt.main(["--mode", "train", "--data_dir", data_dir,
                   "--output_dir", out_dir, "--batch_size", str(TRAIN_BATCH),
                   "--n_epochs", "1", "--steps_per_log", "1",
                   "--eval_size", "1", "--pad_frames", str(pad[0]),
                   "--pad_tokens", str(pad[1]), "--loss_impl", loss_impl,
                   "--device", device, *extra])
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
    require_cluster_k5(name, launches, want["lstm_bwd"])
    require_wgmma_k6(name, launches["joint_planes_by_design"],
                     want["joint_planes"])
    require_warp_k7(name, launches["lattice_scan_by_design"],
                    want["lattice_scan"])


def require_cluster_k5(name, launches, n) -> None:
    """All n K5 launches of a bf16 path at the parity width ran the
    cluster design (split-K phase B) on an H100."""
    d = launches["lstm_bwd_by_design"]
    require(d["cluster"] == n and sum(d.values()) == n,
            f"path {name}: K5 launches by design {d}, want {n} cluster")


def require_wgmma_k6(name, by_design, n) -> None:
    """All n K6 launches of a bf16 path at the parity width ran WGMMA."""
    require(by_design["wgmma"] == n and sum(by_design.values()) == n,
            f"path {name}: K6 launches by design {by_design}, want {n} "
            f"wgmma")


def require_kernel_bwd(name, launches, steps) -> None:
    """Every fused-loss backward chunk of a bf16 path at the parity width
    ran K8 and K9 (at least one chunk a step), none the plain chain."""
    d = launches["loss_bwd_by_design"]
    require(d["plain"] == 0 and d["kernel"] >= steps
            and launches["joint_dlogits"] == launches["tanh_grads"]
            == d["kernel"], f"path {name}: loss backward chunks by design "
            f"{d}, K8 {launches['joint_dlogits']}, K9 "
            f"{launches['tanh_grads']}, want {steps}+ kernel chunks")


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
            "plain_ms": once_ms(lambda: plain(*args))[1],
            "plain_ms_note": "one run, no warm-up",
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
    a block) and bf16 K5 its FMA design (its cluster plan holds 16); (b) the
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


# K5's bf16 cases at the parity width: (block cap, B, T) and the design
# and cluster size each must run on an H100 SXM.  30 clusters of 4 blocks
# are co-resident there, so c = 4 would leave 18 units a block on 120
# blocks: c = 2 runs 132 (or the cap's 128); at 114 blocks every c leaves
# 18 units a block, and the FMA design runs.
K5_CASES = tuple((0, B, T, ("cluster", 2)) for T in (65, 256)
                 for B in (8, 20, 32, 40, 96, 160)) + tuple(
    (128, B, 65, ("cluster", 2)) for B in (32, 96, 160)) + tuple(
    (114, B, 65, ("fma", 0)) for B in (32, 96)) + ((132, 32, 65,
                                                    ("cluster", 2)),)
# (H, P, B, T, design and c) at other widths: the Conformer cell's
# prediction LSTM, H = P = 640, B=64, T = U+1 = 73 (c = 4 on 120 blocks)
K5_WIDTHS = ((640, 640, 64, 73, ("cluster", 4)),)


def check_k5_designs(H, P, device="cuda"):
    """bf16 K5 at K5_CASES (the parity width) and K5_WIDTHS: each case
    against the plain version (relative error <= 2e-2, inputs untouched),
    running the design and cluster size it names (the launch counters and
    `lstm_cuda.bwd_plan` agree), and two launches bitwise equal.  Returns
    {case: plan}."""
    import torch

    from rnnt_tpu_torch.ops import lstm_cuda

    bwd, dt = lstm_cuda.lstm_bwd, torch.bfloat16
    rand = lstm_rand(device, 11)
    seen = {}
    cases = [(H, P, *c) for c in K5_CASES] + [(h, p, 0, *rest)
                                              for h, p, *rest in K5_WIDTHS]
    for h, p, cap, B, T, (design, c) in cases:
        fwd = (rand((T, B, 4 * h), 4.0).to(dt), rand((p, 4 * h), 0.05).to(dt),
               rand((h, p), 0.1).to(dt), rand((4 * h,), 1.0).to(dt),
               rand((B, p), 0.5).to(dt), rand((B, h), 0.5))
        _, z, cs, _ = lstm_cuda.lstm_fwd_plain(*fwd)
        args = (z, cs, fwd[5], rand((T, B, p), 1.0).to(dt),
                fwd[1].t().contiguous(), fwd[2].t().contiguous())
        kept = [a.clone() for a in args]
        name = f"H={h} P={p} B={B} T={T} cap={cap or 'none'}"
        lstm_cuda.set_block_cap(cap)
        try:
            plan = lstm_cuda.bwd_plan(B, h, p)
            before = (dict(bwd.launches_by_design),
                      dict(bwd.launches_by_cluster))
            got = [bwd(*args) for _ in range(2)]
            torch.cuda.synchronize()
        finally:
            lstm_cuda.set_block_cap(0)
        ran = {d: n - before[0][d] for d, n in bwd.launches_by_design.items()}
        by_c = {k: n - before[1][k] for k, n in bwd.launches_by_cluster.items()}
        require(ran[design] == 2 and sum(ran.values()) == 2
                and plan["design"] == design and plan["c"] == c
                and by_c == {k: 2 if k == c else 0 for k in by_c},
                f"K5 {name}: ran {ran}, clusters {by_c}, plan {plan}; want "
                f"{design} c={c}")
        require(all(torch.equal(a, b) for a, b in zip(args, kept)),
                f"K5 {name} wrote into its inputs")
        require(all(torch.equal(a, b) for a, b in zip(*got)),
                f"K5 {name}: two launches differ")
        want = lstm_cuda.lstm_bwd_plain(*args)
        err = max(rel_err(a, b) for a, b in zip(got[0], want))
        require(err <= 2e-2, f"K5 {name} disagrees: {err}")
        seen[name] = dict(plan, rel_err=err)
        log(f"K5 {name}: {design} c={c} on {plan['blocks']} blocks, "
            f"{plan['smem_bytes']} B shared, rel err {err:.3e}, repeat "
            "bitwise equal")
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


def planes_case(args, tol, design, what, plain_times=None):
    """One K6 call against its plain version: every plane within `tol`
    relative error, the inputs untouched, and the launch on `design`.
    Returns (max |d|, the plain planes); the plain run's time (`once_ms`)
    goes into plain_times[what]."""
    import torch

    from rnnt_tpu_torch.ops import planes_cuda

    before = [a.clone() for a in args]
    counts = dict(planes_cuda.joint_planes.launches_by_design)
    got = planes_cuda.joint_planes(*args)
    ran = [d for d, n in planes_cuda.joint_planes.launches_by_design.items()
           if n != counts[d]]
    want, plain_ms = once_ms(lambda: planes_cuda.joint_planes_plain(*args))
    if plain_times is not None:
        plain_times[what] = plain_ms
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
    plain_t = {}
    errs["bfloat16"], _ = planes_case(args, PLANES_BF16_TOL, "wgmma",
                                      f"B={B} T={T} U+1={U1} bf16", plain_t)
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
        "plain_ms": plain_t[f"B={B} T={T} U+1={U1} bf16"],
        "plain_ms_note": PLAIN_ONCE,
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


def lattice_case(b, e, fl, yl, design, what, plain_times=None):
    """K7 vs its plain version on one input: alpha and beta over the valid
    cells and ll within LATTICE_TOL relative error, inputs untouched, the
    launch on `design`.  Returns (relative errors, max |d| over the valid
    cells); the plain run's time (`once_ms`) goes into
    plain_times[f"B={B}"]."""
    import torch

    from rnnt_tpu_torch.ops import lattice_cuda, rnnt_loss_ref

    B, T, U1 = b.shape
    args = (b, e, fl, yl)
    kept = [a.clone() for a in args]
    k7 = lattice_cuda.lattice_scan
    before = dict(k7.launches_by_design)
    got = k7(*args)
    ran = [d for d, n in k7.launches_by_design.items() if n > before[d]]
    want, plain_ms = once_ms(lambda: rnnt_loss_ref.lattice_scan_plain(*args))
    if plain_times is not None:
        plain_times[f"B={B}"] = plain_ms
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


LOSS_BWD_TOL = 5e-4  # K8 + K9 vs the plain chain: ~10x the readings


def loss_bwd_problem(B, T, U, J, V, device, seed, shards=1):
    """bf16 joint inputs (J, and V * shards columns), ragged lengths, and
    the fused forward's denominator and occupancies on the card (K6, K7):
    (f, g, b1, w2, b2, padded labels, den, occ, g_blank, g_emit)."""
    import torch

    from rnnt_tpu_torch.ops import joint_loss_fused as TF, lattice_cuda
    from rnnt_tpu_torch.ops.rnnt_loss_ref import occupancies, pad_labels

    gen = torch.Generator(device=device).manual_seed(seed)
    Vt = V * shards

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    f, g = rand((B, T, J), 0.5), rand((B, U + 1, J), 0.5)
    b1, w2, b2 = rand((J,), 0.1), rand((J, Vt), (6.0 / (J + Vt)) ** 0.5), \
        rand((Vt,), 0.1)
    labels = torch.randint(1, Vt, (B, U), generator=gen, device=device)
    fl = torch.randint(max(1, T // 2), T + 1, (B,), generator=gen,
                       device=device)
    yl = torch.randint(0, U + 1, (B,), generator=gen, device=device)
    fl[0], yl[0] = T, U
    den, b, e = TF.planes(f, g, b1, w2, b2, labels, yl)
    alpha, beta, ll = lattice_cuda.lattice_scan(b, e, fl, yl)
    occ, gbl, gem = occupancies(alpha, beta, b, e, ll, fl, yl,
                                torch.ones(B, device=device))
    return f, g, b1, w2, b2, pad_labels(labels), den, occ, gbl, gem


def loss_bwd_case(prob, what, index=None, plain_times=None):
    """K8 + K9 + the two products (`_kernel_grads`) against the plain chain
    (`_plain_grads`) on one problem, on this rank's columns when `index`
    is a shard of two (no blank on shard 1): each of df, dg, db1, dW2, db2
    within LOSS_BWD_TOL of its largest magnitude, the inputs untouched, one
    K8 and one K9 launch a chunk.  Returns (errors, the kernel's grads)."""
    import torch

    from rnnt_tpu_torch.ops import joint_loss_fused as TF, loss_bwd_cuda
    from rnnt_tpu_torch.ops import planes_cuda

    f, g, b1, w2, b2, y, den, occ, gbl, gem = prob
    if index is not None:
        Vl = w2.shape[1] // 2
        cols = slice(index * Vl, (index + 1) * Vl)
        w2, b2, y = w2[:, cols].contiguous(), b2[cols].contiguous(), \
            y - index * Vl
    own = index in (None, 0)
    args = (f, g, b1, w2, b2)
    before = [a.clone() for a in (*args, den, occ, gbl, gem)]
    k8 = loss_bwd_cuda.joint_dlogits.launches
    got = TF._kernel_grads(*args, planes_cuda.pack_w2_cuda(w2), occ, gbl,
                           gem, den, y, own,
                           loss_bwd_cuda.ctas(f.device))
    B, T, J = f.shape
    chunks = B // loss_bwd_cuda.chunk_rows(
        B, T, g.shape[1], planes_cuda.padded_j(J),
        planes_cuda.padded_v(w2.shape[1]))
    require(loss_bwd_cuda.joint_dlogits.launches - k8 == chunks,
            f"loss backward {what}: K8 launches, want {chunks}")
    want, plain_ms = once_ms(lambda: TF._plain_grads(
        *args, occ, gbl, gem, den, y, own))
    if plain_times is not None:
        plain_times[what] = plain_ms
    require(all(torch.equal(a, b) for a, b in zip(
        (*args, den, occ, gbl, gem), before)),
        f"loss backward {what} wrote into its inputs")
    errs = {n: rel_err(a, b) for n, a, b in zip(
        ("df", "dg", "db1", "dw2", "db2"), got, want)}
    log(f"loss backward {what}: K8 + K9 against the plain chain, relative "
        f"error " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    require(max(errs.values()) <= LOSS_BWD_TOL,
            f"loss backward {what} disagrees: {errs}")
    return errs, got


def loss_bwd_route(what, dtype, J, V, want, device="cuda"):
    """The fused loss's forward and backward at a small shape (B=2, T'=16,
    U+1=9) in `dtype` at joint width J: every backward chunk takes `want`
    ("kernel": K8 and K9; "plain": the chain)."""
    import torch

    from rnnt_tpu_torch.ops import joint_loss_fused as TF

    prob = loss_bwd_problem(2, 16, 8, J, V, device, 40)
    params = [a.to(dtype).requires_grad_() for a in prob[:5]]
    labels = prob[5][:, :-1].long()
    lengths = (torch.full((2,), 16, device=device),
               torch.full((2,), 8, device=device))
    before = dict(TF.backward_launches_by_design)
    TF.rnnt_loss_fused(*params, labels, *lengths).sum().backward()
    ran = {d: n - before[d] for d, n in TF.backward_launches_by_design.items()}
    log(f"loss backward route {what}: chunks by design {ran}")
    require(ran[want] > 0 and sum(ran.values()) == ran[want],
            f"loss backward {what}: chunks by design {ran}, want {want}")
    require(all(torch.isfinite(p.grad).all() for p in params),
            f"loss backward {what}: gradients not finite")


def check_loss_backward(cfg, device="cuda"):
    """The fused loss's backward on K8 and K9 against the plain chain on
    the card, bf16 (`loss_bwd_case`): the cells' shapes, wp4096 (B=96,
    T'=128, U+1=65, J=640, V=4096) and char31 (U+1=116, V=31), a ragged
    B=3, T'=7, U+1=5, J=40, V=300, and shard 1 of two at V_local 2048
    (B=32, U+1=65: no blank, ids of shard 0 outside); the wp4096 case run
    twice gives the same bits.  Routing: bf16 at J=640 takes `kernel`,
    fp32 and bf16 at J=1024 `plain`.  Returns the K8 and K9 entries of the
    kernels line (K8's carries the whole backward's time at B=96 beside
    its bound, the three products at the tensor cores' rate)."""
    import torch

    from rnnt_tpu_torch.ops import joint_loss_fused as TF, loss_bwd_cuda
    from rnnt_tpu_torch.ops import planes_cuda
    from rnnt_tpu_torch.ops.matmul import mm_f32

    J, V = cfg.joint_size, cfg.vocab_size
    errs, plain_t, times = {}, {}, {}
    wp = loss_bwd_problem(96, 128, 64, J, V, device, 30)
    errs["wp4096 B=96"], got = loss_bwd_case(wp, "wp4096 B=96", None,
                                             plain_t)
    _, again = loss_bwd_case(wp, "wp4096 B=96 again")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            "loss backward: two runs of K8 + K9 differ")
    log("loss backward wp4096 B=96: two runs equal bit for bit")
    f, g, b1, w2, b2, y, den, occ, gbl, gem = wp
    w2p = planes_cuda.pack_w2_cuda(w2)
    ctas = loss_bwd_cuda.ctas(f.device)
    times["wp4096 B=96"] = cuda_ms(lambda: TF._kernel_grads(
        f, g, b1, w2, b2, w2p, occ, gbl, gem, den, y, True, ctas), reps=5)
    del wp, got, again
    ch = loss_bwd_problem(96, 128, 115, J, 31, device, 31)
    errs["char31 B=96"], _ = loss_bwd_case(ch, "char31 B=96", None, plain_t)
    f, g, b1, w2, b2, y, den, occ, gbl, gem = ch
    w2p = planes_cuda.pack_w2_cuda(w2)
    times["char31 B=96"] = cuda_ms(lambda: TF._kernel_grads(
        f, g, b1, w2, b2, w2p, occ, gbl, gem, den, y, True, ctas), reps=5)
    del ch
    errs["ragged"], _ = loss_bwd_case(
        loss_bwd_problem(3, 7, 4, 40, 300, device, 32),
        "ragged B=3 T=7 U+1=5 J=40 V=300")
    errs["shard 1 V_local=2048"], _ = loss_bwd_case(
        loss_bwd_problem(32, 128, 64, J, V // 2, device, 33, shards=2),
        "shard 1 of 2, V_local=2048", index=1)
    loss_bwd_route("bf16 J=640", torch.bfloat16, J, 512, "kernel")
    loss_bwd_route("fp32 J=640", torch.float32, J, 512, "plain")
    loss_bwd_route("bf16 J=1024", torch.bfloat16, 1024, 512, "plain")
    # the kernels alone at the train shape (B=32, T'=128, U+1=65), one
    # launch each over the 32 rows
    f, g, b1, w2, b2, y, den, occ, gbl, gem = loss_bwd_problem(
        32, 128, 64, J, V, device, 34)
    fp, gp, yp, b1p, _, b2p = planes_cuda.pad_operands(f, g, y, b1, w2, b2,
                                                       wgmma=True)
    Jp = fp.shape[2]
    w2j = torch.nn.functional.pad(w2, (0, 0, 0, Jp - J))
    db2p = torch.zeros((ctas * loss_bwd_cuda.WARPS, b2p.shape[0]),
                       device=device)
    k8_args = (fp, gp, yp, b1p, w2j, planes_cuda.pack_w2_cuda(w2), b2p, den,
               occ, gbl, gem, db2p, V, True, ctas)
    dl, hb = loss_bwd_cuda.joint_dlogits(*k8_args)
    dh = mm_f32(dl[:, :V], w2j.t())
    (Bk, T, _), C, U1 = f.shape, dh.shape[0], g.shape[1]
    out = (torch.empty((Bk, T, Jp), device=device),
           torch.empty((Bk, U1, Jp), device=device),
           torch.empty((Bk, -(-U1 // loss_bwd_cuda.UG), Jp), device=device))
    want = [torch.empty_like(o) for o in out]
    loss_bwd_cuda.tanh_grads(dh, fp, gp, b1p, *out)
    _, k9_plain_ms = once_ms(lambda: loss_bwd_cuda.tanh_grads_plain(
        dh.reshape(Bk, T, U1, Jp), fp, gp, b1p, *want))
    k9_err = max(rel_err(a, b) for a, b in zip(out, want))
    log(f"K9 tanh_grads B=32 against its plain version: rel err "
        f"{k9_err:.3e}")
    require(k9_err <= 1e-5, f"K9 disagrees with its plain version: {k9_err}")
    h2d = torch.randn((C, J), device=device).to(torch.bfloat16)
    k8_flops, bwd_flops = 2.0 * C * J * V, 3 * 2.0 * 96 / Bk * C * J * V
    k8_bytes = 2 * (f.numel() + g.numel() + J * V + C * V + C * J) + 16 * C
    k9_bytes = 4 * C * J * (1 + 2 / loss_bwd_cuda.TG) + 2 * (
        f.numel() + g.numel()) + 4 * (f.numel() + g.numel())
    k8 = {"name": "joint_dlogits", "route": "cuda",
          "source": "rnnt_tpu_torch/csrc/joint_loss_bwd.cu",
          "replaces": "none: joint_loss_fused._chunk_grads' plain chain "
                      "around its products (the JAX _bwd leaves it to XLA)",
          "max_abs_err": None, "max_rel_err_by_case": errs,
          "ms": cuda_ms(lambda: loss_bwd_cuda.joint_dlogits(*k8_args),
                        reps=5),
          "plain_ms": plain_t["wp4096 B=96"],
          "plain_ms_note": "the plain chain (_plain_grads, the whole "
                           "backward at B=96 with its products), "
                           + PLAIN_ONCE,
          **bound_of(k8_bytes, k8_flops, PEAK_BF16_FLOPS),
          "library_ms": cuda_ms(lambda: torch.mm(h2d, w2), reps=5),
          "library": "cuBLAS bf16 [C,J]x[J,V] product alone (torch.mm)",
          "shape": f"B=32 T'=128 U+1=65 J={J} V={V} bf16 ({C} cells), "
                   "dlogits and hb written, db2 partial rows",
          "bwd_ms_b96": times["wp4096 B=96"],
          "bwd_bound_ms_b96": bwd_flops / PEAK_BF16_FLOPS * 1e3,
          "bwd_bound_note": "the backward's three products (logits "
                            "recomputed, dh, dW2) at 989 TFLOP/s",
          "bwd_plain_ms_b96": plain_t["wp4096 B=96"],
          "bwd_ms_b96_char31": times["char31 B=96"],
          "bwd_plain_ms_b96_char31": plain_t["char31 B=96"]}
    k9 = {"name": "tanh_grads", "route": "cuda",
          "source": "rnnt_tpu_torch/csrc/joint_loss_bwd.cu",
          "replaces": "none: the chain's dh (1 - h^2) and its sums",
          "max_abs_err": max(float((a - b).abs().max())
                             for a, b in zip(out, want)),
          "ms": cuda_ms(lambda: loss_bwd_cuda.tanh_grads(dh, fp, gp, b1p,
                                                         *out), reps=5),
          "plain_ms": k9_plain_ms, "plain_ms_note": PLAIN_ONCE,
          **bound_of(k9_bytes, 0.0, PEAK_BF16_FLOPS),
          "library_ms": None,
          "shape": f"dh [{C}, {Jp}] fp32 (B=32 T'=128 U+1=65)"}
    return k8, k9


# conformer-l.train-b64's convolution module: B, T', D, K
CONV_SHAPE = (64, 400, 512, 32)
# the kernels' edges, each at B, T', D, K: an odd kernel longer than the
# utterance (zeros on both sides of every frame); one partial chunk of one
# channel tile at the cell's kernel; an odd kernel of 31 taps over two
# chunks, the second partial
CONV_EDGE_SHAPES = {"odd K=7, T'=5 < K": (3, 5, 64, 7),
                    "one partial chunk, D=64": (2, 100, 64, 32),
                    "odd K=31, two chunks": (2, 300, 128, 31)}
# K10 / K11 against their plain versions, each bf16 result within one bf16
# step (2^-8) of the largest value: the kernels' fused multiply-adds and
# sums in their own order differ from the plain version's in fp32's last
# bits, which can move one rounding to bf16 by a step
CONV_BF16_TOL = 2.0 ** -8
CONV_STATS_TOL = 1e-4  # the fp32 statistics: sums of 25600 frames reordered
# the kernels against the module's formula in bf16 (PyTorch's ops), which
# rounds GLU's output, the normalised values and the BatchNorm gradient to
# bf16 where the kernels keep fp32: a few bf16 steps
CONV_FORMULA_TOL = 0.05


def conv_module_problem(B, T, D, K, device, seed):
    """(u, valid, w, b, gamma, beta, mean, var, ds) at the module's scales:
    u, ds normal bf16, the taps uniform at the module's init, uneven lengths
    (the first full, the rest in [T / 2, T])."""
    import torch

    from rnnt_tpu_torch.models import conformer

    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device)

    bf = torch.bfloat16
    lim = (6.0 / (2 * K)) ** 0.5
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g, device=device)
    lengths[0] = T
    w = ((torch.rand(D, K, generator=g, device=device) * 2 - 1) * lim).to(bf)
    return (rnd(B, T, 2 * D).to(bf), conformer.frame_mask(lengths, T), w,
            (0.1 * rnd(D)).to(bf), (1 + 0.2 * rnd(D)).to(bf),
            (0.2 * rnd(D)).to(bf), 0.1 * rnd(D),
            0.5 + torch.rand(D, generator=g, device=device),
            (0.1 * rnd(B, T, D)).to(bf))


def conv_kernel_errs(B, T, D, K, device, seed):
    """K10 and K11 against their plain versions at (B, T', D, K) with
    uneven lengths: (relative errors of the bf16 results, of the fp32
    statistics, the problem, K10's training outputs, K11's outputs), each
    error already required within CONV_BF16_TOL / CONV_STATS_TOL, and the
    plain versions' ms (one run each)."""
    from rnnt_tpu_torch.models import conformer
    from rnnt_tpu_torch.ops import conv_module_cuda as C

    prob = conv_module_problem(B, T, D, K, device, seed)
    u, valid, w, b, gamma, beta, mean, var, ds = prob
    fwd_args = (u, valid, w, b, gamma, beta, mean, var, conformer.NORM_EPS)
    got = C.conv_module_fwd(*fwd_args, True)
    want, plain_fwd_ms = once_ms(lambda: C.conv_module_fwd_plain(*fwd_args,
                                                                 True))
    errs = {n: rel_err(got[i], want[i])
            for i, n in ((0, "s"), (1, "y"))}
    stats_errs = {n: rel_err(got[2][i], want[2][i]) for i, n in enumerate(
        ("mean", "var", "rstd", "scale", "shift", "count"))}
    stats_errs.update(new_mean=rel_err(got[3], want[3]),
                      new_var=rel_err(got[4], want[4]))
    bwd_args = (ds, u, valid, w, got[1], got[2], gamma)
    gotb = C.conv_module_bwd(*bwd_args)
    wantb, plain_bwd_ms = once_ms(lambda: C.conv_module_bwd_plain(*bwd_args))
    errs.update({n: rel_err(a, e) for n, a, e in zip(
        ("du", "dw", "db", "dgamma", "dbeta"), gotb, wantb)})
    # the depthwise bias's gradient is zero but for rounding (BatchNorm
    # subtracts the mean the bias shifts): held to the weight gradient's
    # scale
    errs["db"] = float((gotb[2] - wantb[2]).float().abs().max()
                       / wantb[1].float().abs().max())
    ev = C.conv_module_fwd(*fwd_args, False)[0]
    errs["s eval"] = rel_err(ev, C.conv_module_fwd_plain(*fwd_args,
                                                         False)[0])
    log(f"conv module K10 + K11 at B={B}, T'={T}, D={D}, K={K} against "
        "their plain versions, relative error "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + "; statistics " + ", ".join(f"{n} {e:.3e}"
                                      for n, e in stats_errs.items()))
    require(max(errs.values()) <= CONV_BF16_TOL,
            f"conv module kernels at {(B, T, D, K)} disagree with their "
            f"plain versions: {errs}")
    require(max(stats_errs.values()) <= CONV_STATS_TOL,
            f"conv module statistics at {(B, T, D, K)} disagree: "
            f"{stats_errs}")
    return errs, stats_errs, prob, got, gotb, (plain_fwd_ms, plain_bwd_ms)


def check_conv_module(device="cuda"):
    """K10 and K11 against their plain versions on the card in bf16 at
    conformer-l.train-b64's module ([64, 400, 1024] -> [64, 400, 512],
    K=32, uneven lengths) and at CONV_EDGE_SHAPES: K10's s, y, statistics
    and running statistics (CONV_BF16_TOL, CONV_STATS_TOL), K11's du, dW,
    db, dgamma and dbeta from the same y and statistics, the eval form;
    two runs bit for bit at the cell's shape; the module's path through
    both against its formula (PyTorch's ops, CONV_FORMULA_TOL) and its
    routing: bf16 training and eval without gradients on the kernels, fp32
    on the formula, a bf16 module the kernels do not take refused.
    Returns the K10 and K11 entries of the kernels line: each timed
    against its bound (bytes), its plain version and the parent's native
    chain (the formula), forward and forward + backward."""
    import torch

    from rnnt_tpu_torch.models import conformer
    from rnnt_tpu_torch.ops import conv_module_cuda as C

    edge_errs = {}
    for i, (name, shape) in enumerate(CONV_EDGE_SHAPES.items()):
        e, se = conv_kernel_errs(*shape, device, 60 + i)[:2]
        edge_errs[name] = max(max(e.values()), max(se.values()))
    B, T, D, K = CONV_SHAPE
    errs, stats_errs, prob, got, gotb, plain_ms = conv_kernel_errs(
        B, T, D, K, device, 50)
    u, valid, w, b, gamma, beta, mean, var, ds = prob
    plain_fwd_ms, plain_bwd_ms = plain_ms
    fwd_args = (u, valid, w, b, gamma, beta, mean, var, conformer.NORM_EPS)
    bwd_args = (ds, u, valid, w, got[1], got[2], gamma)
    again = C.conv_module_fwd(*fwd_args, True)
    againb = C.conv_module_bwd(ds, u, valid, w, again[1], again[2], gamma)
    require(all(torch.equal(a, e) for a, e in zip(
        (*got, *gotb), (*again, *againb))),
        "conv module: two runs of K10 + K11 differ")
    log("conv module: two runs of K10 + K11 equal bit for bit")
    # the module's path through the kernels against its formula, with
    # autograd, and its routing
    m = conformer.ConvModule(D, K).to(device)
    with torch.no_grad():
        for p, v in ((m.dw_w, w), (m.dw_b, b), (m.bn.scale, gamma),
                     (m.bn.bias, beta), (m.bn.mean, mean), (m.bn.var, var)):
            p.data = v.clone()
    leaves = [m.dw_w, m.dw_b, m.bn.scale, m.bn.bias]
    for p in leaves:
        p.requires_grad_(True)
    ul = u.clone().requires_grad_(True)
    before = dict(conformer.conv_module_launches_by_path)
    k_out, k_stats = m.glu_to_swish(ul, valid, True, None)
    k_grads = torch.autograd.grad((k_out * ds).float().sum(), [ul, *leaves])
    f_out, f_stats = m.formula(ul, valid, True, None)
    f_grads = torch.autograd.grad((f_out * ds).float().sum(), [ul, *leaves])
    ran = {p: n - before[p]
           for p, n in conformer.conv_module_launches_by_path.items()}
    require(ran == {"kernel": 1, "plain": 0},
            f"conv module bf16 training path: {ran}, want one kernel call")
    formula_errs = {n: rel_err(a, e) for n, a, e in zip(
        ("s", "mean", "var", "du", "dw", "db", "dgamma", "dbeta"),
        (k_out, *k_stats, *k_grads), (f_out, *f_stats, *f_grads))}
    # the depthwise bias's gradient, zero but for rounding, as above
    formula_errs["db"] = float((k_grads[2] - f_grads[2]).abs().max()
                               / f_grads[1].abs().max())
    log("conv module path against its formula (bf16), relative error "
        + ", ".join(f"{n} {e:.3e}" for n, e in formula_errs.items()))
    require(max(formula_errs.values()) <= CONV_FORMULA_TOL,
            f"conv module path disagrees with its formula: {formula_errs}")
    with torch.no_grad():
        before = dict(conformer.conv_module_launches_by_path)
        m.glu_to_swish(u, valid, False, None)
        m32 = conformer.ConvModule(64, 8).to(device)
        m32.glu_to_swish(u[:2, :16, :128].float(), valid[:2, :16], True,
                         None)
    ran = {p: n - before[p]
           for p, n in conformer.conv_module_launches_by_path.items()}
    require(ran == {"kernel": 1, "plain": 1},
            f"conv module routes: bf16 eval and fp32 training ran {ran}")
    with torch.no_grad():
        m96 = conformer.ConvModule(96, 8).to(device).to(torch.bfloat16)
        try:
            m96.glu_to_swish(u[:2, :16, :192], valid[:2, :16], True, None)
            refused = False
        except ValueError:
            refused = True
    require(refused, "conv module: a bf16 module of D=96 on the card was "
            "not refused")
    # times: each kernel, its plain version's comparison run, and the
    # formula (the parent's native chain) forward and forward + backward
    k10_ms = cuda_ms(lambda: C.conv_module_fwd(*fwd_args, True), reps=20)
    k10_eval_ms = cuda_ms(lambda: C.conv_module_fwd(*fwd_args, False),
                          reps=20)
    k11_ms = cuda_ms(lambda: C.conv_module_bwd(*bwd_args), reps=20)
    for p in leaves:
        p.requires_grad_(False)

    def native_fwd():
        with torch.no_grad():
            m.formula(u, valid, True, None)

    def native_fwd_bwd():
        x = u.detach().requires_grad_(True)
        out, _ = m.formula(x, valid, True, None)
        out.backward(ds)

    native_fwd_ms = cuda_ms(native_fwd, reps=10)
    native_ms = cuda_ms(native_fwd_bwd, reps=10)
    N = B * T
    k10_bytes = 2 * N * (2 * D) + 3 * 2 * N * D + 2 * (D * K + 3 * D)
    k11_bytes = 2 * (2 * 2 * N * D + N * 2 * D + N * 2 * D) + 2 * (
        D * K + 4 * D)
    shape = (f"u [{B}, {T}, {2 * D}] -> [{B}, {T}, {D}] bf16, K={K}, "
             "uneven lengths")
    source = "rnnt_tpu_torch/csrc/conv_module.cu"
    replaces = ("none: the JAX package has no Conformer; ConvModule's "
                "native chain (GLU, mask, depthwise Conv1d, masked "
                "BatchNorm, Swish)")
    k10 = {"name": "conv_module_fwd", "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": None,
           "max_rel_err_by_case": {**errs, **stats_errs},
           "max_rel_err_by_edge_shape": edge_errs,
           "formula_rel_err": formula_errs, "ms": k10_ms,
           "ms_eval": k10_eval_ms, "plain_ms": plain_fwd_ms,
           "plain_ms_note": PLAIN_ONCE,
           **bound_of(k10_bytes, 2.0 * N * D * K, PEAK_FP32_FLOPS),
           "library_ms": native_fwd_ms,
           "library": "the module's formula forward (PyTorch's GLU, "
                      "masked_fill, pad, native depthwise conv1d, masked "
                      "BatchNorm, silu)", "shape": shape}
    k11 = {"name": "conv_module_bwd", "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": None,
           "max_rel_err_by_case": {n: errs[n] for n in
                                   ("du", "dw", "db", "dgamma", "dbeta")},
           "ms": k11_ms, "plain_ms": plain_bwd_ms,
           "plain_ms_note": PLAIN_ONCE,
           **bound_of(k11_bytes, 4.0 * N * D * K, PEAK_FP32_FLOPS),
           "library_ms": native_ms - native_fwd_ms,
           "library": "the formula's forward + backward less its forward",
           "library_fwd_bwd_ms": native_ms,
           "kernels_fwd_bwd_ms": k10_ms + k11_ms, "shape": shape}
    log(f"conv module: K10 {k10_ms:.4f} ms (eval {k10_eval_ms:.4f}; bound "
        f"{k10['bound_ms']:.4f}; native {native_fwd_ms:.4f}), K11 "
        f"{k11_ms:.4f} ms (bound {k11['bound_ms']:.4f}; native "
        f"{native_ms - native_fwd_ms:.4f}); plain {plain_fwd_ms:.2f} / "
        f"{plain_bwd_ms:.2f}")
    return k10, k11


CONFORMER_CONFIG = os.path.join(REPO, "benchmark", "configs",
                                "conformer-l.json")
# conformer-l.train-b64's batch: B, frames, labels; and the steps driven
CONFORMER_BATCH, CONFORMER_STEPS = (64, 1600, 72), 3


def run_conformer_steps(seed, device="cuda"):
    """`train_conformer`: CONFORMER_STEPS steps of make_train_step (fused
    loss, Adam) on the Conformer-Transducer of CONFORMER_CONFIG (random
    weights from `seed`, bf16) at CONFORMER_BATCH with uneven frame lengths
    (the first full, the rest in [T / 2, T]), one batch a step.  Returns
    (the losses, the ms of each step after the first, the module calls by
    path during the steps, the model's blocks)."""
    import torch

    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.models import conformer
    from rnnt_tpu_torch.train.state import create_train_state
    from rnnt_tpu_torch.train.steps import make_train_step

    with open(CONFORMER_CONFIG) as f:
        cfg = RNNTConfig(**json.load(f)["model"])
    B, T, U = CONFORMER_BATCH
    state = create_train_state(cfg, None, device, seed)
    step = make_train_step(cfg, loss_impl="fused")
    gen = torch.Generator(device=device).manual_seed(seed)
    by_path = conformer.conv_module_launches_by_path
    by_path.update(dict.fromkeys(by_path, 0))
    losses, ms = [], []
    for k in range(CONFORMER_STEPS):
        batch = random_batch(cfg, B, T, U, device, seed + k)
        lengths = torch.randint(T // 2, T + 1, (B,), generator=gen,
                                device=device)
        lengths[0] = T
        batch["spec_lengths"] = lengths
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(state, batch, gen)["loss"]))
        if k:
            ms.append(1e3 * (time.perf_counter() - t0))
    ran = dict(by_path)
    del state, step
    torch.cuda.empty_cache()
    return losses, ms, ran, cfg.encoder_layers


def require_conformer_launches(name, launches, ran, layers, steps) -> None:
    """One K10 and one K11 launch a block a step, and every module call on
    the kernels (`conv_module_launches_by_path`)."""
    want = layers * steps
    require(ran == {"kernel": want, "plain": 0},
            f"path {name}: conv module calls by path {ran}, want {want} "
            "kernel and 0 plain")
    for k in ("conv_module_fwd", "conv_module_bwd"):
        require(launches[k] == want,
                f"path {name}: {launches[k]} {k} launches, want {want}")


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
    inputs, errs, plain_t = {}, {}, {}
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
                                       "from the planes", plain_t)
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
        "plain_ms": plain_t[f"B={B}"],
        "plain_ms_note": PLAIN_ONCE,
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


PLAIN_STEP_THREADS = 4  # the plain step's; the card's phases keep the rest


def start_plain_train_step_fp32(cfg, seed, B=TRAIN_BATCH, device="cuda"):
    """Start the plain side of `check_train_step_fp32` in a process of its
    own (`--plain_step`), on the host CPU beside the card's phases, so its
    minute and a half overlaps them: the train_cli path's B=32, T=256,
    U=64 batch is drawn on the card and handed over in a file.  Returns
    (the batch on the card, the process, its directory)."""
    import subprocess

    import torch

    batch = random_batch(cfg, B, 256, 64, device, seed)
    path = os.path.join(TRAIN_DIR, "fp32_step")
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.cpu() for k, v in batch.items()},
               os.path.join(path, "batch.pt"))
    cfg.save(path)
    with open(os.path.join(path, "plain.log"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--plain_step", path,
             "--seed", str(seed)], stdout=out, stderr=subprocess.STDOUT,
            cwd=REPO)
    log(f"plain fp32 train step started on the host CPU "
        f"({PLAIN_STEP_THREADS} threads, pid {proc.pid})")
    return batch, proc, path


def plain_train_step(path, seed) -> int:
    """The plain fp32 train step (`--plain_step`): the model of path's
    config from `seed` on the CPU, where every wrapper runs its plain
    version, on the batch in path/batch.pt; writes its loss, gradients and
    seconds."""
    import torch

    sys.path.insert(0, REPO)
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.train.state import create_train_state, trainable_names
    from rnnt_tpu_torch.train.steps import batch_loss

    torch.set_num_threads(PLAIN_STEP_THREADS)
    cfg = RNNTConfig.load(path)
    batch = torch.load(os.path.join(path, "batch.pt"))
    model = create_train_state(cfg, torch.float32, "cpu", seed).model
    t0 = time.perf_counter()
    loss, _ = batch_loss(model, cfg, batch, training=True, loss_impl="fused")
    loss.backward()
    params = dict(model.named_parameters())
    torch.save({"loss": float(loss.detach()),
                "grads": {n: params[n].grad for n in trainable_names(model)},
                "secs": time.perf_counter() - t0,
                "threads": torch.get_num_threads()},
               os.path.join(path, "plain.pt"))
    return 0


def check_train_step_fp32(cfg, seed, plain, device="cuda"):
    """One whole fp32 train step's loss and gradients through the kernels
    (K4-K7, on the card) against the plain versions (the same step on the
    host CPU, where every wrapper runs its plain version, started earlier
    by `start_plain_train_step_fp32`: `plain`), at the parity width and
    depth and the train_cli path's B=32, T=256, U=64: loss within 1e-4 and
    every gradient within 1e-3 relative error (to its largest element)."""
    import torch

    from rnnt_tpu_torch.train.state import create_train_state, trainable_names
    from rnnt_tpu_torch.train.steps import batch_loss

    batch, proc, path = plain
    B = batch["labels"].shape[0]
    model = create_train_state(cfg, torch.float32, device, seed).model
    t0 = time.perf_counter()
    loss, _ = batch_loss(model, cfg, batch, training=True, loss_impl="fused")
    loss.backward()
    params = dict(model.named_parameters())
    grads_k = {n: params[n].grad.cpu() for n in trainable_names(model)}
    loss_k, secs_k = float(loss.detach()), time.perf_counter() - t0
    del model, params, loss
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    with open(os.path.join(path, "plain.log")) as f:
        for line in f.read().splitlines()[-20:]:
            log(f"plain fp32 step: {line}")
    require(rc == 0, f"the plain fp32 train step exited {rc}")
    ref = torch.load(os.path.join(path, "plain.pt"))
    loss_p, grads_p = ref["loss"], ref["grads"]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    errs = {n: rel_err(grads_k[n], grads_p[n]) for n in grads_p}
    worst = max(errs, key=errs.get)
    log(f"fp32 train step B={B} T=256 U=64 kernels ({secs_k:.2f} s) vs plain "
        f"on the CPU ({ref['secs']:.2f} s, {ref['threads']} threads, beside "
        f"the card's phases; waited {time.perf_counter() - t0:.2f} s for it):"
        f" loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}); worst "
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
              ("K8 joint_dlogits", "joint_dlogits_kernel"),
              ("K9 tanh_grads", ("dtanh_rows_kernel", "dtanh_cols_kernel")),
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
    from rnnt_tpu_torch.ops import (joint_loss_fused, lattice_cuda,
                                    lstm_cuda, planes_cuda)

    state, batch, step, gen = bench.setup(device, seed=seed)
    k6, k7 = planes_cuda.joint_planes, lattice_cuda.lattice_scan
    k6_before = (k6.launches, dict(k6.launches_by_design))
    k7_before = (k7.launches, dict(k7.launches_by_design))
    bwd = joint_loss_fused.backward_launches_by_design
    bwd_before = dict(bwd)
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
    bwd_by_design = {d: n - bwd_before[d] for d, n in bwd.items()}
    require(bwd_by_design["plain"] == 0 and bwd_by_design["kernel"] > 0,
            f"bench step: loss backward chunks by design {bwd_by_design}")
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
              "k7_launches_by_design": k7_by_design,
              "loss_bwd_chunks_by_design": bwd_by_design, "card": smi}
    log("bench-geometry train step " + json.dumps(result))
    return result


# ------------------------------------------ data preparation and SpecAugment

# the bench entry points' depth: every one drives a path that another phase
# also drives (greedy and beam serving, the TCP stream, bench_decode's K3
# gate), so one timed repetition, 20 stream chunks and 4 requests do
BENCH_REPS, BENCH_CHUNKS, BENCH_REQUESTS = 1, 20, 4
PREP_SPLITS = (("train-mini", 48), ("dev-mini", 8), ("test-mini", 8))
PREP_WORDS = ("the and of to a in that he was it his i with as had you her "
              "for she not but at be him on they all by this which said "
              "from have so were one when there would what then them "
              "upon into out more no now up could if time some little very "
              "man only great before over such long like its good our old "
              "come").split()
PREP_PAD = (272, 64)  # an 8 s utterance is 266 stacked frames
PREP_STEPS = 2        # 48 train utterances at batch 32: one full, one partial
SPECAUG = ("specaug_freq_masks=2", "specaug_time_masks=2")


def write_prep_corpus(cfg, path, seed):
    """A LibriSpeech-layout corpus from `seed`: PREP_SPLITS utterances of
    2-8 s over two speakers, half FLAC (tests/flac_fixture.py's encoder),
    half WAV, 16-bit samples; transcripts of ~2.5 words a second from
    PREP_WORDS.  Returns its audio seconds."""
    from rnnt_tpu_torch.data.audio_io import write_wav

    encode_flac = flac_encoder()
    rng = np.random.default_rng(seed)
    shutil.rmtree(path, ignore_errors=True)
    total = 0.0
    for split, n in PREP_SPLITS:
        for spk, chap in (("103", "1240"), ("1034", "121119")):
            d = os.path.join(path, split, spk, chap)
            os.makedirs(d)
            lines = []
            for i in range(n // 2):
                utt = f"{spk}-{chap}-{i:04d}"
                secs = float(rng.uniform(2.0, 8.0))
                pcm = np.round(np.clip(synthetic_audio(secs, rng), -1, 1)
                               * 32767.0)
                if i % 2:
                    write_wav(os.path.join(d, utt + ".wav"),
                              (pcm / 32767.0).astype(np.float32),
                              cfg.sample_rate)
                else:
                    with open(os.path.join(d, utt + ".flac"), "wb") as f:
                        f.write(encode_flac(pcm.astype(np.int64),
                                            blocksize=4096))
                words = rng.choice(PREP_WORDS, max(1, int(2.5 * secs)))
                lines.append(f"{utt} {' '.join(words).upper()}")
                total += pcm.shape[0] / cfg.sample_rate
            with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
    return total


def shard_examples(out_dir, split):
    """A split's examples in the order they were written: write_shards
    deals example i to shard i % N, so the shards interleave."""
    import glob as globlib

    from rnnt_tpu_torch.data.records import read_shard

    shards = [list(read_shard(p)) for p in sorted(globlib.glob(
        os.path.join(out_dir, f"{split}-*-of-*.rnr")))]
    out = []
    for i in range(max(map(len, shards))):
        out += [s[i] for s in shards if i < len(s)]
    return out


def check_prep_output(cfg, corpus, out_dir, device="cuda"):
    """The prepared directory against the corpus: config.json the parity
    config, a 4096-piece tokenizer, and every split's examples in corpus
    order with their labels equal to the written tokenizer's encode and
    their features within 2e-4 of the plain frontend in fp64 on the card
    for the same audio (mean subtraction and stacking as preprocess_audio).
    Returns (examples, K1's device ms summed over them, max error).

    The yardstick is the plain frontend in fp64 (`log_mel_plain(...,
    dtype=torch.float64)`): in fp32 the plain version's FFT rounds as an
    fp32 FFT kernel would, which at spectral nulls of the low mel bins
    exceeds 2e-4 on clean audio (tests/test_torch_frontend_fft.py), so it
    cannot hold the kernel to 2e-4; its error is printed beside."""
    import torch

    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.data import audio_io, librispeech
    from rnnt_tpu_torch.data.tokenizer import SubwordTokenizer
    from rnnt_tpu_torch.ops import features as F
    from rnnt_tpu_torch.ops.features_cuda import log_mel_frontend

    require(RNNTConfig.load(out_dir) == cfg, "the prepared config.json is "
            "not the parity RNNTConfig()")
    tok = SubwordTokenizer.load(out_dir)
    require(tok.vocab_size == cfg.vocab_size, f"tokenizer {tok.vocab_size}")
    n, k1_ms, err, err_fp32 = 0, 0.0, 0.0, 0.0
    for split, count in PREP_SPLITS:
        name = split.split("-")[0]
        exs = shard_examples(out_dir, name)
        utts = list(librispeech.iter_utterance_files(corpus, [split]))
        require(len(exs) == len(utts) == count,
                f"{name}: {len(exs)} examples of {len(utts)} utterances")
        for ex, (path, text) in zip(exs, utts):
            require(np.array_equal(ex["labels"], tok.encode(text)),
                    f"{path}: labels differ from the tokenizer's encode")
            require(ex["labels"].shape[0] <= PREP_PAD[1], f"{path}: "
                    f"{ex['labels'].shape[0]} labels")
            audio, _ = audio_io.read_audio(path)
            a = torch.from_numpy(audio).to(device)
            want, fp32 = (F.stack_frames(F.subtract_mean(F.log_mel_plain(
                a, cfg, dtype=dt)), cfg.downsample_factor).cpu().numpy()
                for dt in (torch.float64, torch.float32))
            require(ex["mel_specs"].shape == want.shape,
                    f"{path}: {ex['mel_specs'].shape} != {want.shape}")
            e = float(np.abs(ex["mel_specs"] - want).max())
            require(e <= 2e-4, f"{path}: max |d mel| {e}")
            err = max(err, e)
            err_fp32 = max(err_fp32, float(np.abs(fp32 - want).max()))
            k1_ms += device_ms(lambda: log_mel_frontend(a, cfg), reps=5)
            n += 1
    log(f"prep: the plain frontend in fp32 on the card errs by up to "
        f"{err_fp32:.3e} against it in fp64 on the same audio")
    return n, k1_ms, err


def check_specaug_on_card(cfg, out_dir, seed, B=8, device="cuda"):
    """SpecAugment on the card, on a B=8 batch of the prepared train
    features (the train step's config: 2 frequency masks of up to
    specaug_freq_width bins, 2 time masks of up to specaug_time_width
    frames), in fp32 and bf16: a cell is zero exactly where its frame or
    its mel bin (in every stacked copy) is masked, padding frames are never
    masked, the rest is untouched, and the same draws applied on the CPU
    give the same output."""
    import torch

    from rnnt_tpu_torch.data.pipeline import pad_batch
    from rnnt_tpu_torch.ops.specaug import Intervals, apply_masks, \
        draw_intervals

    batch = pad_batch(shard_examples(out_dir, "train")[:B], PREP_PAD[0],
                      PREP_PAD[1])
    lengths = torch.from_numpy(batch["spec_lengths"]).to(device)
    bins, stack = cfg.mel_bins, cfg.downsample_factor
    for dt in (torch.float32, torch.bfloat16):
        mel = torch.from_numpy(batch["mel_specs"]).to(device, dt)
        gen = torch.Generator(device=device).manual_seed(seed)
        freq = draw_intervals(gen, B, 2, cfg.specaug_freq_width, device)
        time_ = draw_intervals(gen, B, 2, cfg.specaug_time_width, device)
        out = apply_masks(mel, lengths, mel_bins=bins, freq=freq, time=time_)
        host = apply_masks(mel.cpu(), lengths.cpu(), mel_bins=bins,
                           freq=Intervals(*(t.cpu() for t in freq)),
                           time=Intervals(*(t.cpu() for t in time_)))
        require(torch.equal(out.cpu(), host), f"SpecAugment {dt}: the card "
                "and the CPU mask differently")
        masked = (out == 0) & (mel != 0)
        zero = (out == 0).cpu().numpy()
        T = zero.shape[1]
        frames = zero.all(axis=2)
        fbins = zero.reshape(B, T, stack, bins).all(axis=(1, 2))
        want = frames[:, :, None] | np.tile(fbins, (1, stack))[:, None, :]
        require(np.array_equal(zero | (mel == 0).cpu().numpy(),
                               want | (mel == 0).cpu().numpy()),
                f"SpecAugment {dt}: masked cells are not whole frames and "
                "whole bins")
        real = np.arange(T)[None, :] < batch["spec_lengths"][:, None]
        require(not (masked.any(dim=2).cpu().numpy() & ~real).any(),
                f"SpecAugment {dt}: a padding frame was masked")
        require(torch.equal(out[~masked], mel[~masked]),
                f"SpecAugment {dt}: an unmasked cell changed")
        require(bool(masked.any()), f"SpecAugment {dt}: nothing masked")
        log(f"SpecAugment on the card ({dt}, B={B}, T={T}): "
            f"{int(frames.any(axis=0).sum())} frames and "
            f"{int(fbins.sum())} (example, bin) pairs masked; equal to the "
            f"CPU's on the same draws")


def check_prep_and_specaug(paths, cfg, seed, smi, device="cuda"):
    """The data-preparation paths and the augmented, profiled training
    path, each driven with the launch counts set to 0 before it:
    `prep_librispeech`, cli.preprocess_librispeech on a corpus written
    from `seed` (word-piece, --vocab_size 4096 --pad_vocab, 2 shards),
    exactly one K1 launch per utterance kept, and `check_prep_output`;
    `prep_parallel`, the same with --workers 2, its files byte-identical
    to the serial run's; debug_dataset on each split and corpus_stats on
    the train split; `train_specaug_profiled`, run_rnnt --mode train on the
    prepared shards at batch 32 for PREP_STEPS steps with SpecAugment and
    --profile_dir (the launches of `require_train_launches`, K2 resident in
    the eval, finite losses, a trace naming K4's, K5's and K6's kernels);
    then `check_specaug_on_card`.  Returns the timings."""
    from rnnt_tpu_torch.cli import corpus_stats, debug_dataset, \
        preprocess_librispeech

    corpus = os.path.join(TRAIN_DIR, "prep_corpus")
    t0 = time.perf_counter()
    audio_s = write_prep_corpus(cfg, corpus, seed)
    log(f"prep corpus: {sum(n for _, n in PREP_SPLITS)} utterances, "
        f"{audio_s:.1f} s of audio, written in "
        f"{time.perf_counter() - t0:.1f} s")
    flags = ["--data_dir", corpus, "--train_splits", "train-mini",
             "--dev_splits", "dev-mini", "--test_splits", "test-mini",
             "--vocab_size", "4096", "--pad_vocab", "--num_shards", "2",
             "--device", device]
    n_utts = sum(n for _, n in PREP_SPLITS)
    walls = {}
    dirs = {"prep_librispeech": os.path.join(TRAIN_DIR, "prep_serial"),
            "prep_parallel": os.path.join(TRAIN_DIR, "prep_workers")}
    for name, extra in (("prep_librispeech", []),
                        ("prep_parallel", ["--workers", "2"])):
        argv = flags + ["--output_dir", dirs[name]] + extra
        t0 = time.perf_counter()
        _, paths[name] = drive_path(name, lambda: run_main(
            name, preprocess_librispeech.main, argv), ("log_mel_frontend",))
        walls[name] = time.perf_counter() - t0
        k1 = paths[name]["log_mel_frontend"]
        require(k1 == n_utts, f"path {name}: {k1} K1 launches for {n_utts} "
                "utterances kept")
        others = {k: v for k, v in paths[name].items()
                  if k != "log_mel_frontend" and isinstance(v, int) and v}
        require(not others, f"path {name}: other kernels launched {others}")
    n, k1_ms, err = check_prep_output(cfg, corpus, dirs["prep_librispeech"],
                                      device)
    files = sorted(os.listdir(dirs["prep_librispeech"]))
    require(sorted(os.listdir(dirs["prep_parallel"])) == files,
            "prep_parallel wrote other files")
    for f in files:
        with open(os.path.join(dirs["prep_librispeech"], f), "rb") as a, \
                open(os.path.join(dirs["prep_parallel"], f), "rb") as b:
            require(a.read() == b.read(), f"prep_parallel: {f} differs from "
                    "the serial run's")
    log(f"prep: {n} examples held to the plain frontend (max |d mel| "
        f"{err:.3e}); serial and --workers 2 files byte-identical: {files}")
    for split in ("train", "dev", "test"):
        out, _ = run_main("debug_dataset", debug_dataset.main, [
            "--data_dir", dirs["prep_librispeech"], "--split", split])
        require(out[-1].startswith("All checks passed."), out)
    out, _ = run_main("corpus_stats", corpus_stats.main,
                      ["--dir", os.path.join(corpus, "train-mini")])
    require(out[0] == f"files: {PREP_SPLITS[0][1]}", out)

    run_dir = os.path.join(TRAIN_DIR, "run_specaug")
    prof_dir = os.path.join(TRAIN_DIR, "profile")
    t0 = time.perf_counter()
    (losses, _), paths["train_specaug_profiled"] = drive_path(
        "train_specaug_profiled", lambda: run_train_cli(
            dirs["prep_librispeech"], run_dir, "fused", PREP_STEPS, device,
            pad=PREP_PAD, extra=["--config_override", *SPECAUG,
                                 "--profile_dir", prof_dir]),
        ("lstm_fwd", "lstm_bwd", "joint_planes", "lattice_scan",
         "lstm_seq_infer"))
    train_wall = time.perf_counter() - t0
    launches = paths["train_specaug_profiled"]
    require_train_launches("train_specaug_profiled", launches, PREP_STEPS, 1,
                           pallas=False)
    require_resident_k2("train_specaug_profiled", launches)
    with open(os.path.join(run_dir, "config.json")) as f:
        run_cfg = json.load(f)
    require(run_cfg["specaug_freq_masks"] == 2
            and run_cfg["specaug_time_masks"] == 2, "SpecAugment was off")
    trace = os.path.join(prof_dir, "run_rnnt_train.pt.trace.json")
    with open(trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    for sym in ("lstm_fwd_mma_kernel", "lstm_bwd_kernel_cluster",
                "plane_kernel_wgmma"):
        require(any(sym in n for n in names), f"the trace names no {sym}")
    with open(os.path.join(run_dir, "tb", "metrics.jsonl")) as f:
        step_s = [r["step_seconds"] for r in map(json.loads, f)
                  if "step_seconds" in r]
    check_specaug_on_card(cfg, dirs["prep_librispeech"], seed, device=device)
    result = {
        "audio_s": audio_s, "utterances": n_utts,
        "prep_s": walls["prep_librispeech"],
        "prep_workers2_s": walls["prep_parallel"],
        "prep_s_per_audio_hour": walls["prep_librispeech"] / audio_s * 3600,
        "prep_workers2_s_per_audio_hour":
            walls["prep_parallel"] / audio_s * 3600,
        "k1_device_ms_sum": k1_ms,
        "k1_share_of_prep_wall": k1_ms / 1e3 / walls["prep_librispeech"],
        "train_specaug_profiled_s": train_wall, "step_seconds": step_s,
        "losses": losses, "trace_bytes": os.path.getsize(trace),
        "card": smi}
    log("data prep and augmented training " + json.dumps(result))
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
    the FMA design, held by `gate_beam` at the bf16 tolerance.  At E=1 the
    kernel is timed and the gate's plain search beside it (its one run).
    Returns {E: record} with the largest |d score| of each."""
    import torch

    from rnnt_tpu_torch.cli import bench_decode
    from rnnt_tpu_torch.ops import beam_cuda

    cfg, model, enc, lens = bench_decode.setup(batch, frames, True, "cuda")
    require(batch * BEAM > beam_cuda.MAXN,
            f"B={batch} x K={BEAM} is inside the streamed plan")
    out = {}
    for E in (1, 6):
        kw = dict(beam_width=BEAM, max_output_length=200,
                  expansions_per_frame=E)
        with torch.no_grad():
            trace = {}
            got = beam_cuda.beam_search(model, enc, lens, trace=trace, **kw)
            design = beam_cuda.beam_search.last_design
            (want, stats), plain_ms = once_ms(
                lambda: plain_along(model, enc, lens, trace, kw))
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
            rec["plain_ms"], rec["plain_ms_note"] = plain_ms, PLAIN_ONCE
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
    require_cluster_k5("bench_train", launches, 10 * steps)
    require_wgmma_k6("bench_train", launches["joint_planes_by_design"],
                     launches["joint_planes"])
    require_warp_k7("bench_train", launches["lattice_scan_by_design"],
                    launches["lattice_scan"])
    require_kernel_bwd("bench_train", launches, steps)

    (out, _), paths["bench_loss"] = drive_path(
        "bench_loss", lambda: run_main("bench_loss", bench_loss.main,
                                       ["--B", "8", "--iters", "3"]),
        ("joint_planes", "lattice_scan"))
    fused = [line for line in out if line.startswith("fused ")]
    require(len(fused) == 1 and "TFLOP/s" in fused[0],
            f"bench_loss fused line {fused}")
    require(len(out) == 4, f"bench_loss printed {out}")

    reps = BENCH_REPS
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
            "bench_streaming", bench_streaming.main,
            ["--chunks", str(BENCH_CHUNKS)]),
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
            ["--checkpoint", RUN_DIR, "--requests", str(BENCH_REQUESTS),
             "--concurrency", "2"]),
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
INT8_STEP_REPS = 50  # the int8-exec greedy step's timings (host-bound)


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
        reps = INT8_STEP_REPS
        step_ms = cuda_ms(lambda: model.joint_step(enc_t, pred), reps=reps)
        h = torch.tanh(int8_exec.qdot(enc_t + pred, model.joint.w1))
        qdot_ms = (cuda_ms(lambda: int8_exec.qdot(enc_t + pred,
                                                  model.joint.w1), reps=reps)
                   + cuda_ms(lambda: int8_exec.qdot(h, model.joint.w2),
                             reps=reps))
        state = model.prediction_zero_state(1, enc.dtype)
        tok = torch.ones((1,), dtype=torch.long, device="cuda")
        pstep_ms = cuda_ms(lambda: model.predict_step(tok, state), reps=reps)
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

    reps = BENCH_REPS
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
            ["--checkpoint", RUN_DIR, "--requests", str(BENCH_REQUESTS),
             "--concurrency", "2", "--quantized", art, "--int8_exec"]),
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


def flac_encoder():
    """tests/flac_fixture.py's `encode_flac`, loaded by its path: an
    installed package named `tests` may shadow the repository's tests/
    directory, which is not a package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "flac_fixture", os.path.join(REPO, "tests", "flac_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    return fixture.encode_flac


def check_flac(paths, audio):
    """A 5 s WAV's samples encoded as FLAC (tests/flac_fixture.py's encoder)
    transcribe, through cli/transcribe_file.py on the card, as the WAV
    does; the decoded samples equal the WAV's."""
    from rnnt_tpu_torch.cli import transcribe_file
    from rnnt_tpu_torch.data.audio_io import read_audio, write_wav

    encode_flac = flac_encoder()

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


# ------------------------------------------ export and the banded loss

EXPORT_MAX_OUT = 200  # the transcribe artifact's max_output_length
EXPORT_CHUNK, EXPORT_CHUNK_TOKENS = 4, 64  # the streaming step's


@contextlib.contextmanager
def count_plain_k2():
    """Counts the calls of K2's plain version while in use (the port calls
    it only for CPU tensors; an exported path on the card must make none).
    Yields the list of counts, one entry a call."""
    from rnnt_tpu_torch.ops import lstm_cuda

    plain, calls = lstm_cuda.lstm_seq_infer_plain, []

    def counted(*args):
        calls.append(1)
        return plain(*args)

    lstm_cuda.lstm_seq_infer_plain = counted
    try:
        yield calls
    finally:
        lstm_cuda.lstm_seq_infer_plain = plain


def k2_launches():
    """(K2 launches, K2 FMA launches) so far."""
    from rnnt_tpu_torch.ops import lstm_cuda

    k2 = lstm_cuda.lstm_seq_infer
    return k2.launches, k2.launches_by_design["fma"]


def synced_s(fn):
    """(fn()'s result, its host seconds ending in a synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_export_transcribe(model32, mel_p, t, device="cuda"):
    """The `export_transcribe` path: cli.export_model on the run directory
    (fp32, frozen, --batch 1 --frames 512 --max_output_length 200 --check,
    which also writes the streaming step), then `load_artifact` of the
    transcribe .pt2 and a call on the 15 s request's log-mel.  The call must
    launch K2, every launch on its fp32 FMA design, make no call of K2's
    plain version, and give the tokens and lengths of the live eager
    `greedy_decode` on the same input.  Returns a record of export, load
    and call times, the artifacts' sizes and the launches."""
    import torch

    from rnnt_tpu_torch import export as ex
    from rnnt_tpu_torch.cli import export_model
    from rnnt_tpu_torch.decode.greedy import greedy_decode

    out = os.path.join(RUN_DIR, "export")
    with count_plain_k2() as plain:
        t0 = time.perf_counter()
        lines, _ = run_main("export_model", export_model.main, [
            "--checkpoint", RUN_DIR, "--output", out, "--batch", "1",
            "--frames", str(mel_p.shape[1]), "--max_output_length",
            str(EXPORT_MAX_OUT), "--chunk_frames", str(EXPORT_CHUNK),
            "--max_tokens_per_chunk", str(EXPORT_CHUNK_TOKENS), "--device",
            device, "--check"])
        export_s = time.perf_counter() - t0
        require(any("parity: OK" in line for line in lines),
                "export_model --check did not report parity")
        path = os.path.join(out, "transcribe.pt2")
        artifact, load_s = synced_s(lambda: ex.load_artifact(path).module())
        lens = torch.tensor([t], dtype=torch.int32, device=device)
        k2_before = k2_launches()
        with torch.no_grad():
            got, call_s = synced_s(lambda: artifact(mel_p, lens))
            k2_after = k2_launches()
            times = [synced_s(lambda: artifact(mel_p, lens))[1]
                     for _ in range(2)]
            want, eager_s = synced_s(lambda: greedy_decode(
                model32, mel_p, lens, max_output_length=EXPORT_MAX_OUT))
            eager = [synced_s(lambda: greedy_decode(
                model32, mel_p, lens, max_output_length=EXPORT_MAX_OUT))[1]
                for _ in range(2)]
    launches = k2_after[0] - k2_before[0]
    fma = k2_after[1] - k2_before[1]
    rec = {"export_and_check_s": export_s, "load_s": load_s,
           "pt2_bytes": {n: os.path.getsize(os.path.join(out, f"{n}.pt2"))
                         for n in ("transcribe", "streaming_step")},
           "artifact_call_ms": [call_s * 1e3] + [s * 1e3 for s in times],
           "eager_greedy_ms": [eager_s * 1e3] + [s * 1e3 for s in eager],
           "tokens": int(got[1][0]), "k2_launches_by_the_call": launches,
           "k2_fma_launches_by_the_call": fma, "plain_k2_calls": len(plain)}
    log("export_transcribe " + json.dumps(rec))
    require(launches > 0 and fma == launches,
            f"the transcribe artifact's K2 launches: {launches}, {fma} FMA")
    require(not plain, f"{len(plain)} calls of K2's plain version")
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "the transcribe artifact's tokens differ from the live greedy "
            "decode's")
    return rec


def drive_export_streaming(model32, cfg, mel, device="cuda"):
    """The `export_streaming` path: `load_artifact` of the streaming step
    that `export_transcribe` wrote (4 stacked frames a chunk, at most 64
    tokens), then the 5 s request's log-mel [T, F] chunk by chunk from
    `streaming_init_state`: tokens, n and every state tensor equal to the
    live chunked decode (`encode` with state, then `greedy_decode_encoded`
    with carry) at every chunk, and K2 launched by every chunk (every
    launch FMA), no call of K2's plain version.  Returns a record."""
    import torch

    from rnnt_tpu_torch import export as ex
    from rnnt_tpu_torch.decode.greedy import greedy_decode_encoded

    path = os.path.join(RUN_DIR, "export", "streaming_step.pt2")
    with count_plain_k2() as plain:
        step, load_s = synced_s(lambda: ex.load_artifact(path).module())
        enc_state, pred_state = ex.streaming_init_state(cfg, device=device)
        carry = ex.start_carry(model32, pred_state)
        enc_live, pred_live = ex.streaming_init_state(cfg, device=device)
        carry_live = ex.start_carry(model32, pred_live)
        n_chunks = mel.shape[0] // EXPORT_CHUNK
        chunk_ms, live_ms, tokens = [], [], 0
        for i in range(n_chunks):
            m = mel[i * EXPORT_CHUNK: (i + 1) * EXPORT_CHUNK].contiguous()
            before = k2_launches()
            with torch.no_grad():
                (tok, n, enc_state, carry), s = synced_s(
                    lambda: step(m, enc_state, carry))
            after = k2_launches()
            chunk_ms.append(s * 1e3)
            require(after[0] > before[0] and after[1] - before[1]
                    == after[0] - before[0],
                    f"chunk {i}: K2 launches {after} after {before}")

            def live():
                enc, st = model32.encode(m[None], state=enc_live)
                tk, n_live, cr = greedy_decode_encoded(
                    model32, enc, torch.full((1,), enc.shape[1],
                                             device=device),
                    max_output_length=EXPORT_CHUNK_TOKENS, carry=carry_live)
                return tk, n_live, st, cr

            with torch.no_grad():
                (tk, n_live, enc_live, carry_live), s = synced_s(live)
            live_ms.append(s * 1e3)
            require(int(n) == int(n_live[0]) and torch.equal(
                tok[: int(n)], tk[0, : int(n)]),
                f"chunk {i}: tokens differ from the live decode")
            got = [x for st in enc_state for x in st] + [carry[0]] + [
                x for st in carry[1] for x in st]
            want = [x for st in enc_live for x in st] + [carry_live[0]] + [
                x for st in carry_live[1] for x in st]
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"chunk {i}: a state tensor differs from the live "
                    "decode's")
            tokens += int(n)
    rec = {"load_s": load_s, "chunks": n_chunks, "tokens": tokens,
           "chunk_ms_median": statistics.median(chunk_ms),
           "chunk_ms_max": max(chunk_ms),
           "live_chunk_ms_median": statistics.median(live_ms),
           "plain_k2_calls": len(plain)}
    log("export_streaming " + json.dumps(rec))
    require(not plain, f"{len(plain)} calls of K2's plain version")
    return rec


def k2_operator_cost(model, batches=5, calls=200):
    """The host time a call of K2's registered operator (`ops.library`, the
    route an exported graph records) adds to a direct call of the wrapper
    (the eager route), at a greedy prediction-net step's shape (B=1, T=1,
    the prediction net's layer 0): the enqueue time of `calls` calls each
    way in turns, each batch ended by a synchronize, the least of
    `batches`.  Returns {route: us a call}."""
    import torch

    from rnnt_tpu_torch.models.lstm import matmul_to
    from rnnt_tpu_torch.ops import library, lstm_cuda

    lstm = model.prediction.layers[0].lstm
    dt = lstm.wh.dtype
    x = model.prediction.embed[:1].to(dt)
    xp = matmul_to(x, lstm.wx, dt).reshape(1, 1, -1)
    c0, h0 = lstm.zero_state(1)
    args = (xp, lstm.wh, lstm.wp, lstm.bias, h0, c0)
    best = {}
    for _ in range(batches):
        for name, fn in (("wrapper", lstm_cuda.lstm_seq_infer),
                         ("operator", library.lstm_seq_infer)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            us = (time.perf_counter() - t0) / calls * 1e6
            torch.cuda.synchronize()
            best[name] = min(best.get(name, us), us)
    log(f"K2 one-step call, host enqueue: wrapper {best['wrapper']:.2f} us, "
        f"through the registered operator {best['operator']:.2f} us")
    return best


def time_banded_step(cfg, seed, device="cuda", reps=3):
    """A bf16 train step (make_train_step) at the train_cli shapes (B=32,
    T=256 stacked frames, U=64, full-length rows) with the fused and the
    banded loss (band cfg.loss_band), in turns on one state: median host
    ms of each, every step ending in a read of its loss."""
    import torch

    from rnnt_tpu_torch.train.state import create_train_state
    from rnnt_tpu_torch.train.steps import make_train_step

    state = create_train_state(cfg, torch.bfloat16, device, seed)
    batch = random_batch(cfg, TRAIN_BATCH, 256, 64, device, seed)
    steps = {impl: make_train_step(cfg, loss_impl=impl)
             for impl in ("fused", "banded")}
    times = {impl: [] for impl in steps}
    for impl in ("fused", "banded") + ("fused", "banded", "banded",
                                        "fused") * reps:
        (loss, s) = synced_s(lambda: float(steps[impl](state, batch)["loss"]))
        require(np.isfinite(loss), f"{impl} step loss {loss}")
        times[impl].append(s * 1e3)
    rec = {impl: statistics.median(t[1:]) for impl, t in times.items()}
    rec["band"] = cfg.loss_band
    log(f"train step B={TRAIN_BATCH} T=256 U=64 bf16, fused vs banded "
        f"(median of {2 * reps} each, after a warm-up): {json.dumps(rec)}")
    return rec


BANDED_B, BANDED_T, BANDED_U1, BAND = 32, 128, 65, 32  # the train shapes
BANDED_STEPS = 2  # the train_banded path's run


def banded_problem(cfg, device, seed, pruned_row=None):
    """The banded loss's inputs at the train shapes in fp32 (f, g, b1, W2,
    b2 from `planes_inputs`, labels [B, U], ragged frame and label
    lengths); with `pruned_row`, that row gets 10 frames for 64 labels,
    too steep for a band of 32 (every path pruned)."""
    import torch

    f, g, y, b1, w2, b2 = planes_inputs(cfg, BANDED_B, BANDED_T, BANDED_U1,
                                        device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    fl = torch.randint(BANDED_T - 28, BANDED_T + 1, (BANDED_B,),
                       generator=gen, device=device)
    yl = torch.randint(BANDED_U1 - 26, BANDED_U1, (BANDED_B,), generator=gen,
                       device=device)
    if pruned_row is not None:
        fl[pruned_row], yl[pruned_row] = 10, BANDED_U1 - 1
    return [f, g, b1, w2, b2], y[:, :-1].contiguous(), fl, yl


def banded_loss_and_grads(params, labels, fl, yl, band, device):
    """The banded loss (or the fused one, band None) and the gradients of
    its sum for f, g, b1, W2, b2, on `device`."""
    import torch

    from rnnt_tpu_torch.ops.joint_loss_banded import rnnt_loss_banded
    from rnnt_tpu_torch.ops.joint_loss_fused import rnnt_loss_fused

    ps = [p.detach().to(device).requires_grad_(True) for p in params]
    rest = [x.to(device) for x in (labels, fl, yl)]
    loss = (rnnt_loss_fused(*ps, *rest) if band is None
            else rnnt_loss_banded(*ps, *rest, band=band))
    grads = torch.autograd.grad(loss.sum(), ps)
    return loss.detach(), [x.detach() for x in grads]


def check_banded(cfg, device="cuda", seed=21):
    """The banded loss's gates on the card at the train shapes (B=32,
    T'=128, U+1=65, J=640, V=4096, ragged lengths): K6 at the banded row
    shapes ([B nT, 8, W] rows of f, the label windows of g and y, W = 32)
    against its plain planes, fp32 (FMA) <= 1e-4 and bf16 (WGMMA) <=
    PLANES_BF16_TOL, inputs untouched; K7 over the banded (mostly NEG) b/e
    planes against the plain scans: finite everywhere, the same reachable
    cells, alpha and beta there and ll within LATTICE_TOL; a band >= U+1
    equal to the fused loss in fp32 (loss 1e-5, each gradient 1e-4
    relative); at band 32 with one fully pruned utterance: the NLL >= the
    exact NLL - 1e-4 for every utterance, loss and gradients within 1e-4
    and 1e-3 of the same function on the host CPU (every wrapper's plain
    version), the pruned utterance's loss 1e9 and its f and g gradient rows
    exactly zero, nothing NaN.  Returns K6's banded-row record."""
    import torch

    from rnnt_tpu_torch.ops import joint_loss_banded as JB
    from rnnt_tpu_torch.ops import lattice_cuda, planes_cuda, rnnt_loss_ref
    from rnnt_tpu_torch.ops.rnnt_loss_ref import NEG

    params, labels, fl, yl = banded_problem(cfg, device, seed, pruned_row=7)
    f, g, b1, w2, b2 = params
    W = BAND
    U1p = -(-BANDED_U1 // 8) * 8
    g_p = torch.nn.functional.pad(g, (0, 0, 0, U1p - BANDED_U1))
    y_p = torch.nn.functional.pad(labels, (0, U1p - 1 - labels.shape[1]))
    u0 = JB.band_starts(fl, yl, BANDED_T, U1p, W)
    rows32 = JB.banded_rows(f, g_p, rnnt_loss_ref.pad_labels(y_p), u0,
                            W) + (b1, w2, b2)
    n_rows = rows32[0].shape[0]
    what = f"banded rows [{n_rows}, 8, {W}]"
    err32, _ = planes_case(rows32, 1e-4, "fma", what + " fp32")
    rows16 = tuple(a.to(torch.bfloat16) if a.is_floating_point() else a
                   for a in rows32)
    err16, _ = planes_case(rows16, PLANES_BF16_TOL, "wgmma", what + " bf16")
    J, V = cfg.joint_size, cfg.vocab_size
    record = {
        "shape_banded": f"rows [{n_rows}, 8, {W}] (B={BANDED_B} T'="
                        f"{BANDED_T} U+1={BANDED_U1}, band {W}) J={J} V={V} "
                        "bf16",
        "ms_banded": cuda_ms(lambda: planes_cuda.joint_planes(*rows16),
                             reps=10),
        "bound_ms_banded": bound_of(*planes_cost(n_rows, 8, W, J, V, 2),
                                    PEAK_BF16_FLOPS)["bound_ms"],
        "max_abs_err_banded": {"float32": err32, "bfloat16": err16}}
    log(f"K6 at the banded rows: {record['ms_banded']:.4f} ms (bound "
        f"{record['bound_ms_banded']:.4f})")

    # K7 over the banded planes (NEG outside the band)
    _, b, e, _ = JB.banded_planes(f, g_p, b1, w2, b2, y_p, yl, u0, W)
    kept = [x.clone() for x in (b, e)]
    before = dict(lattice_cuda.lattice_scan.launches_by_design)
    got = lattice_cuda.lattice_scan(b, e, fl, yl)
    ran = [d for d, n in lattice_cuda.lattice_scan.launches_by_design.items()
           if n > before[d]]
    want = rnnt_loss_ref.lattice_scan_plain(b, e, fl, yl)
    require(torch.equal(b, kept[0]) and torch.equal(e, kept[1]),
            "K7 wrote into the banded planes")
    require(ran == ["warp"], f"K7 on the banded planes ran {ran}")
    require(all(torch.isfinite(x).all() for x in got),
            "K7 on the banded planes: non-finite values")
    t_idx = torch.arange(BANDED_T, device=device)[None, :, None]
    u_idx = torch.arange(U1p, device=device)[None, None, :]
    valid = (t_idx < fl[:, None, None]) & (u_idx <= yl[:, None, None])
    rel = []
    for k in (0, 1):
        reach = valid & (want[k] > NEG / 2)
        require(torch.equal(reach, valid & (got[k] > NEG / 2)),
                "K7 on the banded planes: reachable cells differ")
        rel.append(rel_err(got[k][reach], want[k][reach]))
    alive = want[2] > NEG / 2
    rel.append(rel_err(got[2][alive], want[2][alive]))
    log(f"K7 on the banded planes ({ran}): rel err alpha {rel[0]:.3e} beta "
        f"{rel[1]:.3e} ll {rel[2]:.3e}; {int(valid.sum())} valid cells, "
        f"{int((valid & (want[0] > NEG / 2)).sum())} reachable; "
        f"{int((~alive).sum())} utterance(s) fully pruned")
    require(max(rel) <= LATTICE_TOL, f"K7 on the banded planes: {rel}")

    # a band >= U+1 is exact
    ok_params, ok_labels, ok_fl, ok_yl = banded_problem(cfg, device, seed + 2)
    wide, wide_g = banded_loss_and_grads(ok_params, ok_labels, ok_fl, ok_yl,
                                         BANDED_U1, device)
    fused, fused_g = banded_loss_and_grads(ok_params, ok_labels, ok_fl,
                                           ok_yl, None, device)
    wide_rel = [rel_err(wide, fused)] + [rel_err(a, c)
                                         for a, c in zip(wide_g, fused_g)]
    log(f"banded loss, band {BANDED_U1} >= U+1 vs the fused loss (fp32): "
        f"loss rel err {wide_rel[0]:.3e}, gradients f g b1 w2 b2 "
        + " ".join(f"{r:.3e}" for r in wide_rel[1:]))
    require(wide_rel[0] <= 1e-5 and max(wide_rel[1:]) <= 1e-4,
            f"the wide band is not exact: {wide_rel}")

    # band 32: an upper bound, the same function as on the CPU, a pruned row
    k_loss, k_grads = banded_loss_and_grads(params, labels, fl, yl, BAND,
                                            device)
    exact, _ = banded_loss_and_grads(params, labels, fl, yl, None, device)
    t0 = time.perf_counter()
    c_loss, c_grads = banded_loss_and_grads(params, labels, fl, yl, BAND,
                                            "cpu")
    cpu_s = time.perf_counter() - t0
    gap = k_loss - exact
    live = torch.arange(BANDED_B) != 7
    loss_rel = rel_err(k_loss.cpu()[live], c_loss[live])
    grad_rel = [rel_err(a.cpu(), c) for a, c in zip(k_grads, c_grads)]
    log(f"banded loss, band {BAND} (fp32): NLL - exact NLL min "
        f"{float(gap.min()):.4e} median {float(gap.median()):.4e}; vs the "
        f"CPU ({cpu_s:.1f} s): loss rel err {loss_rel:.3e}, gradients "
        + " ".join(f"{r:.3e}" for r in grad_rel)
        + f"; pruned row loss {float(k_loss[7]):.6g}")
    require(bool((gap >= -1e-4).all()),
            f"the banded NLL undercuts the exact one: {float(gap.min())}")
    require(loss_rel <= 1e-4 and max(grad_rel) <= 1e-3,
            f"banded loss on the card vs the CPU: {loss_rel}, {grad_rel}")
    require(float(k_loss[7]) == JB.PRUNED_LOSS == float(c_loss[7]),
            f"the pruned utterance's loss {float(k_loss[7])}")
    require(all(torch.isfinite(x).all() for x in k_grads)
            and bool((k_grads[0][7] == 0).all())
            and bool((k_grads[1][7] == 0).all()),
            "the pruned utterance's gradient is not exactly zero")
    return record


def require_fma_k2(name, launches) -> None:
    """Every K2 launch of an fp32 path ran the FMA design."""
    d = launches["lstm_seq_infer_by_design"]
    require(d["fma"] == launches["lstm_seq_infer"] > 0,
            f"path {name}: K2 launches by design {d}")


# --------------------------------------------------- data parallelism ----

DP_STEPS = 2          # dp_nccl: bf16 steps at B=32, then one resumed step
DP_RANK_BATCH = 16    # dp_two_ranks: each rank's rows (32 in all)
DP_WORKER_TIMEOUT_S = 600


def run_dp_nccl(cfg, seed, device="cuda"):
    """`run_rnnt --multihost` on NCCL as one process (world 1, the card's
    one device), bf16 at B=32 with the fixed (256, 64) bucket: DP_STEPS
    steps and one eval batch writing a collective .dcp checkpoint (dcp
    named: `auto` picks it above one process), then
    `--checkpoint auto` resumes from it for one more step and one more
    eval batch.  Returns its record: losses, eval lines, the
    checkpoints and the logged step seconds."""
    import torch.distributed as dist

    from rnnt_tpu_torch.cli import run_rnnt
    from rnnt_tpu_torch.train import checkpoint as ckpt_mod

    data = os.path.join(TRAIN_DIR, "dp_data")
    data_resume = os.path.join(TRAIN_DIR, "dp_data_resume")
    write_train_data(cfg, data, DP_STEPS * TRAIN_BATCH, TRAIN_BATCH, seed)
    write_train_data(cfg, data_resume, TRAIN_BATCH, TRAIN_BATCH, seed + 1)
    out = os.path.join(TRAIN_DIR, "run_dp")
    shutil.rmtree(out, ignore_errors=True)
    common = ["--multihost", "--num_processes", "1", "--process_id", "0",
              "--batch_size", str(TRAIN_BATCH), "--n_epochs", "1",
              "--steps_per_log", "1", "--eval_size", "1", "--pad_frames",
              "256", "--pad_tokens", "64", "--output_dir", out,
              "--ckpt_backend", "dcp", "--device", device]
    state = run_rnnt.main(["--mode", "train", "--data_dir", data, *common])
    require(not dist.is_initialized(), "run_rnnt left its process group")
    require(state.step == DP_STEPS, f"dp_nccl trained {state.step} steps")
    first = ckpt_mod.latest_checkpoint(out)
    require(first is not None and first.endswith(
        f"checkpoint_{DP_STEPS:08d}.dcp"), f"dp_nccl checkpoint {first}")
    state = run_rnnt.main(["--mode", "train", "--data_dir", data_resume,
                           "--checkpoint", "auto", *common])
    require(state.step == DP_STEPS + 1,
            f"dp_nccl resumed to step {state.step}, want {DP_STEPS + 1}")
    steps = ckpt_mod.list_checkpoint_steps(out)
    require(steps == [DP_STEPS, DP_STEPS + 1], f"dp_nccl checkpoints {steps}")
    with open(os.path.join(out, "tb", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    evals = [r["eval_loss"] for r in recs if "eval_loss" in r]
    require(len(losses) == DP_STEPS + 1 and all(np.isfinite(losses)),
            f"dp_nccl train losses {losses}")
    require(len(evals) == 2 and all(np.isfinite(evals)),
            f"dp_nccl eval losses {evals}")
    rec = {"losses": losses, "eval_losses": evals,
           "checkpoints": [os.path.basename(p) for p in sorted(
               os.listdir(out)) if p.endswith(".dcp")],
           "step_seconds": [r["step_seconds"] for r in recs
                            if "step_seconds" in r]}
    log(f"dp_nccl: {json.dumps(rec)}")
    return rec


def step_with_grads(cfg, state, batch, mesh):
    """One train step; returns (loss, the gradients the optimizer read)."""
    from rnnt_tpu_torch.train import state as state_mod
    from rnnt_tpu_torch.train.steps import make_train_step

    seen = {}
    apply_ = state_mod.Optimizer.apply_

    def spy(self, model, grads, opt_state):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return apply_(self, model, grads, opt_state)

    state_mod.Optimizer.apply_ = spy
    try:
        m = make_train_step(cfg, loss_impl="fused", mesh=mesh)(state, batch)
        loss = float(m["loss"])
    finally:
        state_mod.Optimizer.apply_ = apply_
    return loss, seen


def dp_worker(rank, port, data, seed, device="cuda") -> int:
    """One rank of dp_two_ranks (a process of its own; two share the card
    over gloo): one fp32 fused step at the parity width on this rank's
    DP_RANK_BATCH rows (its shard of `data`, under `data`'s config), then,
    from the same initial state, one process's step on both ranks' rows
    concatenated; writes the launches of the data-parallel step and the
    errors between the two to data/dp_rank{rank}.json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.data.pipeline import batches_from_shards
    from rnnt_tpu_torch.parallel import mesh as mesh_mod
    from rnnt_tpu_torch.train.loop import to_device
    from rnnt_tpu_torch.train.state import Optimizer, create_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_mod.init_distributed(f"localhost:{port}", 2, rank, device,
                                    timeout_s=DP_WORKER_TIMEOUT_S,
                                    backend="gloo")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    try:
        mesh = mesh_mod.make_mesh(device=dev)
        cfg = RNNTConfig.load(data)
        rows = [next(batches_from_shards(
            os.path.join(data, "train-*.rnr"), DP_RANK_BATCH,
            process_index=r, process_count=2, t_buckets=[256],
            u_buckets=[64])) for r in range(2)]
        mine = to_device(rows[rank], dev)
        both = to_device({k: np.concatenate([rows[0][k], rows[1][k]])
                          for k in rows[0]}, dev)
        state = create_train_state(cfg, torch.float32, dev, seed)
        mesh_mod.broadcast_module_(state.model, mesh)
        init = {k: v.clone() for k, v in state.model.state_dict().items()}
        sync()
        zero_launches()
        t0 = time.perf_counter()
        loss, grads = step_with_grads(cfg, state, mine, mesh)
        sync()
        dp_s = time.perf_counter() - t0
        launches = read_launches()
        launches.update({f"{k}_by_design": v
                         for k, v in read_designs().items()})
        after = {k: v.clone() for k, v in state.model.state_dict().items()}
        state.model.load_state_dict(init)
        state.opt_state, state.step = Optimizer(cfg).init(state.model), 0
        loss_ref, grads_ref = step_with_grads(cfg, state, both, None)
        rec = {"rank": rank, **step_errors(
            init, after, state.model.state_dict(), grads, grads_ref, loss,
            loss_ref), "dp_step_s": dp_s, "launches": launches,
               "backend": dist.get_backend(mesh.group), "device": str(dev)}
        with open(os.path.join(data, f"dp_rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()
    return 0


def step_errors(init, after, want, grads, grads_ref, loss, loss_ref):
    """The errors of a parallel step against one process's step from the
    same state `init` (full tensors on both sides): the loss, the worst
    gradient, the worst updated parameter, the BatchNorm statistics, and
    apart the parameters that were zero before the step (their value after
    it is the update alone, -lr x the clipped gradient, so their error is
    a gradient's)."""
    grad_err = {n: rel_err(g, grads_ref[n]) for n, g in grads.items()}
    bn = ("encoder.bn.mean", "encoder.bn.var")
    fresh = {n for n, v in init.items() if not bool(v.any()) and n not in bn}
    err = {n: rel_err(after[n], want[n]) for n in want}
    param_err = {n: e for n, e in err.items()
                 if n not in fresh and n not in bn}
    update_err = {n: err[n] for n in fresh}
    worst_g = max(grad_err, key=grad_err.get)
    worst_p = max(param_err, key=param_err.get)
    worst_u = max(update_err, key=update_err.get)
    return {"loss": loss, "loss_ref": loss_ref,
            "loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            "worst_grad": worst_g, "grad_rel": grad_err[worst_g],
            "worst_param": worst_p, "param_rel": param_err[worst_p],
            "zero_before": sorted(fresh), "worst_zero_before": worst_u,
            "zero_before_rel": update_err[worst_u],
            "bn_rel": max(err[n] for n in bn)}


def require_step_errors(name, rec) -> None:
    """A parallel step's bounds against one process (`step_errors`): loss
    1e-5, every gradient 1e-4 of its largest element, the BatchNorm
    statistics and every updated parameter 1e-5, a parameter zero before
    the step 1e-4."""
    who = f"{name} rank {rec['rank']}"
    require(rec["loss_rel"] <= 1e-5, f"{who}: loss {rec['loss']} vs one "
            f"process {rec['loss_ref']}")
    require(rec["grad_rel"] <= 1e-4, f"{who}: gradient {rec['worst_grad']} "
            f"rel err {rec['grad_rel']}")
    require(rec["bn_rel"] <= 1e-5 and rec["param_rel"] <= 1e-5,
            f"{who}: BatchNorm statistics {rec['bn_rel']}, parameter "
            f"{rec['worst_param']} {rec['param_rel']}")
    require(rec["zero_before_rel"] <= 1e-4, f"{who}: parameter "
            f"{rec['worst_zero_before']} (zero before the step) "
            f"{rec['zero_before_rel']}")


def spawn_ranks(flag, name, data, seed, device, n=2):
    """Run `chip_smoke.py FLAG RANK` as n processes sharing the card (each
    writes data/{name}_rank{RANK}.json); log each one's last lines; every
    one must exit 0 within DP_WORKER_TIMEOUT_S.  Returns their records."""
    import subprocess

    from rnnt_tpu_torch.parallel.mesh import free_port

    port = str(free_port())
    procs, logs = [], []
    for r in range(n):
        logs.append(open(os.path.join(data, f"{name}_rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag,
             str(r), "--dp_port", port, "--dp_dir", data, "--seed",
             str(seed), "--dp_device", device], stdout=logs[-1],
            stderr=subprocess.STDOUT,
            cwd=REPO))
    deadline = time.time() + DP_WORKER_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for r, f in enumerate(logs):
            f.seek(0)
            for line in f.read().splitlines()[-40:]:
                log(f"{name} rank {r}: {line}")
            f.close()
    codes = [p.returncode for p in procs]
    require(codes == [0] * n, f"{name} workers exited {codes}")
    recs = []
    for r in range(n):
        with open(os.path.join(data, f"{name}_rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def sum_launches(recs) -> dict:
    """The launch counts (and counts by design) of several ranks, summed;
    each record's `launches` is taken out of it."""
    launches = {}
    for rec in recs:
        for k, v in rec.pop("launches").items():
            if isinstance(v, dict):
                launches.setdefault(k, dict.fromkeys(v, 0))
                for d, c in v.items():
                    launches[k][d] += c
            else:
                launches[k] = launches.get(k, 0) + v
    return launches


def run_dp_two_ranks(cfg, seed, device="cuda"):
    """Two processes on the one card over gloo (NCCL puts one rank on a
    device), each a rank of `dp_worker`: the data-parallel step must equal
    one process's step on the concatenated rows within
    `require_step_errors`' bounds; each rank launches per step 10 K4, 10
    K5 (fp32: FMA), one K6 and one K7.  Returns (the record, the path's
    launches summed over ranks)."""
    data = os.path.join(TRAIN_DIR, "dp2_data")
    write_train_data(cfg, data, 2 * DP_RANK_BATCH, DP_RANK_BATCH, seed)
    recs = spawn_ranks("--dp_worker", "dp", data, seed, device)
    log("dp_two_ranks: " + json.dumps(
        [{k: v for k, v in r.items() if k != "launches"} for r in recs]))
    for rec in recs:
        n = rec["launches"]
        require_step_errors("dp_two_ranks", rec)
        for k, want in (("lstm_fwd", 10), ("lstm_bwd", 10),
                        ("joint_planes", 1), ("lattice_scan", 1)):
            require(n[k] == want, f"dp_two_ranks rank {rec['rank']}: {k} "
                    f"launched {n[k]} times, want {want}")
        require_warp_k7("dp_two_ranks", n["lattice_scan_by_design"], 1)
    return recs, sum_launches(recs)


def drive_data_parallel(paths, cfg, seed, smi, device="cuda"):
    """The data-parallel phase: dp_nccl, dp_two_ranks and bench_scaling,
    each a driven path (dp_two_ranks' launches are its ranks')."""
    from rnnt_tpu_torch.cli import bench_scaling

    train_kernels = ("lstm_fwd", "lstm_bwd", "joint_planes", "lattice_scan")
    t0 = time.perf_counter()
    rec = {}
    rec["dp_nccl"], paths["dp_nccl"] = drive_path(
        "dp_nccl", lambda: run_dp_nccl(cfg, seed, device), train_kernels
        + ("lstm_seq_infer",))
    require_train_launches("dp_nccl", paths["dp_nccl"], DP_STEPS + 1, 2,
                           pallas=False)
    require_resident_k2("dp_nccl", paths["dp_nccl"])
    log(f"path dp_nccl with its data: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["dp_two_ranks"], paths["dp_two_ranks"] = run_dp_two_ranks(cfg, seed,
                                                                   device)
    log(f"path dp_two_ranks with its data: {time.perf_counter() - t0:.1f} s")
    steps = 3
    (out, _), paths["bench_scaling"] = drive_path(
        "bench_scaling", lambda: run_main(
            "bench_scaling", bench_scaling.main,
            ["--devices", "1", "--per_device_batch", str(TRAIN_BATCH),
             "--steps", str(steps), "--device", device]), train_kernels)
    line = json_line("bench_scaling", out)
    require(line["devices"] == 1 and line["efficiency_vs_1dev"] == 1.0
            and np.isfinite(line["audio_s_per_s"])
            and line["audio_s_per_s"] > 0, f"bench_scaling {line}")
    require_train_launches("bench_scaling", paths["bench_scaling"],
                           steps + 1, 0, pallas=False)
    rec["bench_scaling"] = dict(line, card=smi)
    return rec


# --------------------------------------------- vocab tensor parallelism ----

TP_SHARDS = (2048, 1024)  # K6's V_local at model axes 2 and 4 (V=4096)
TP_RANK_BATCH = 16        # tp_two_ranks: the rows both ranks hold
TP_CLIP = 1e-3            # tp_two_ranks' grad_clip_norm: clipping engages
TP_STEPS = 2              # tp_cli: bf16 steps at B=32


def check_planes_shards(cfg, B=32, T=128, U1=65, device="cuda"):
    """K6 on vocabulary shards: V_local 2048 and 1024 (the columns of
    shards 0 and 1 of a V=4096 W2, labels in [1, V) shifted as for each,
    so ids fall below 0 and at or above V_local) in its three designs
    (bf16 `wgmma` at the parity J=640, bf16 `wmma` at J=768, above the
    WGMMA plan, fp32 `fma`), each against the plain version (1e-4 fp32,
    PLANES_BF16_TOL bf16), inputs untouched, on the design it must run,
    and emit exactly NEG wherever the id is outside the shard.  Returns
    ({case: max rel err}, {V_local: the wgmma call's ms, CUDA events})."""
    import torch

    from rnnt_tpu_torch.ops import planes_cuda
    from rnnt_tpu_torch.ops.rnnt_loss_ref import NEG

    errs, ms = {}, {}
    designs = (("wgmma", torch.bfloat16, cfg.joint_size, PLANES_BF16_TOL),
               ("wmma", torch.bfloat16, 768, PLANES_BF16_TOL),
               ("fma", torch.float32, cfg.joint_size, 1e-4))
    for vl in TP_SHARDS:
        for design, dt, J, tol in designs:
            f, g, y, b1, w2, b2 = planes_inputs(cfg, B, T, U1, device, 12,
                                                J=J)
            for shard in (0, 1):
                lo = shard * vl
                args = tuple(a.to(dt) if a.is_floating_point() else a
                             for a in (f, g, y - lo, b1,
                                       w2[:, lo: lo + vl].contiguous(),
                                       b2[lo: lo + vl].contiguous()))
                what = f"V_local={vl} shard {shard} J={J} {design}"
                before = [a.clone() for a in args]
                counts = dict(planes_cuda.joint_planes.launches_by_design)
                got = planes_cuda.joint_planes(*args)
                ran = [d for d, n in
                       planes_cuda.joint_planes.launches_by_design.items()
                       if n != counts[d]]
                want, _ = once_ms(
                    lambda: planes_cuda.joint_planes_plain(*args))
                require(all(torch.equal(a, b) for a, b in zip(args, before)),
                        f"K6 {what} wrote into its inputs")
                rel = [rel_err(a, b) for a, b in zip(got, want)]
                outside = (args[2] < 0) | (args[2] >= vl)
                require(bool(outside.any()) and bool((~outside).any()),
                        f"K6 {what}: labels all inside or all outside")
                mask = outside[:, None, :].expand(got[2].shape)
                neg = bool((got[2][mask] == NEG).all())
                log(f"K6 joint_planes {what} on {ran}: rel err denom "
                    f"{rel[0]:.3e} blank {rel[1]:.3e} emit {rel[2]:.3e}; "
                    f"{int(outside.sum())} of {outside.numel()} ids outside "
                    f"the shard, their emit all NEG: {neg}")
                require(max(rel) <= tol, f"K6 {what} disagrees: {rel}")
                require(ran == [design], f"K6 {what} ran {ran}")
                require(neg, f"K6 {what}: an out-of-shard id's emit is not "
                        "NEG")
                errs[what] = max(rel)
                if design == "wgmma" and shard == 0:
                    ms[vl] = cuda_ms(lambda: planes_cuda.joint_planes(*args),
                                     reps=5)
    log(f"K6 on shards: wgmma ms by V_local {json.dumps(ms)}")
    return errs, ms


class KernelV:
    """Records the V of every K6 launch (`planes_cuda.launch`'s W2 columns)
    while in place: what a vocabulary shard hands the kernel."""

    def __enter__(self):
        from rnnt_tpu_torch.ops import planes_cuda

        self.seen, self.real = [], planes_cuda.launch

        def spy(lib, f, g, labels_pad, b1, w2, b2, packed=None):
            self.seen.append(int(w2.shape[1]))
            return self.real(lib, f, g, labels_pad, b1, w2, b2, packed)

        planes_cuda.launch = spy
        return self

    def __exit__(self, *exc):
        from rnnt_tpu_torch.ops import planes_cuda

        planes_cuda.launch = self.real


class DecodedTokens:
    """Records the tokens of every eval decode (`train.loop._decode`) while
    in place."""

    def __enter__(self):
        from rnnt_tpu_torch.train import loop

        self.tokens, self.real = [], loop._decode

        def spy(*a, **kw):
            tokens, lengths = self.real(*a, **kw)
            self.tokens.append([t[:n].tolist() for t, n in
                                zip(tokens.cpu(), lengths.cpu())])
            return tokens, lengths

        loop._decode = spy
        return self

    def __exit__(self, *exc):
        from rnnt_tpu_torch.train import loop

        loop._decode = self.real


def tp_worker(rank, port, data, seed, device="cuda") -> int:
    """One rank of tp_two_ranks (a process of its own; two share the card
    over gloo as a 1x2 mesh): one fp32 fused step at the parity width on
    the TP_RANK_BATCH rows both ranks hold, W2 and b2 sharded (V_local
    2048), with grad_clip_norm TP_CLIP; then, from the same initial state,
    one process's step on the same rows; writes the launches (and each
    K6 launch's V), the gradient norm and the errors between the two, W2,
    b2 and their gradients gathered, to data/tp_rank{rank}.json."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.data.pipeline import batches_from_shards
    from rnnt_tpu_torch.parallel import mesh as mesh_mod
    from rnnt_tpu_torch.train.loop import to_device
    from rnnt_tpu_torch.train.state import create_train_state, global_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh_mod.init_distributed(f"localhost:{port}", 2, rank, device,
                                    timeout_s=DP_WORKER_TIMEOUT_S,
                                    backend="gloo")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    try:
        mesh = mesh_mod.make_mesh(model=2, device=dev)
        cfg = RNNTConfig.load(data).replace(grad_clip_norm=TP_CLIP)
        tp = mesh.vocab_shard(cfg.vocab_size)
        require(tp is not None and mesh.shape == {"data": 1, "model": 2},
                f"tp_two_ranks mesh {mesh}")
        batch = to_device(next(batches_from_shards(
            os.path.join(data, "train-*.rnr"), TP_RANK_BATCH,
            t_buckets=[256], u_buckets=[64])), dev)
        state = create_train_state(cfg, torch.float32, dev, seed)
        mesh_mod.broadcast_module_(state.model, mesh)
        init = {k: v.clone() for k, v in state.model.state_dict().items()}
        mesh_mod.shard_state_(state, tp)
        sync()
        zero_launches()
        t0 = time.perf_counter()
        with KernelV() as kv:
            loss, grads = step_with_grads(cfg, state, batch, mesh)
        sync()
        tp_s = time.perf_counter() - t0
        launches = read_launches()
        launches.update({f"{k}_by_design": v
                         for k, v in read_designs().items()})
        grad_norm = float(global_norm(grads, tp))
        grads = {n: (mesh_mod.gather_columns(g, mesh_mod.VOCAB_SHARDED[n], tp)
                     if n in mesh_mod.VOCAB_SHARDED else g)
                 for n, g in grads.items()}
        after, _ = mesh_mod.full_state(state, tp)
        after = {k: v.clone() for k, v in after.items()}
        ref = create_train_state(cfg, torch.float32, dev, seed)
        ref.model.load_state_dict(init)
        loss_ref, grads_ref = step_with_grads(cfg, ref, batch, None)
        rec = {"rank": rank, **step_errors(
            init, after, ref.model.state_dict(), grads, grads_ref, loss,
            loss_ref), "grad_norm": grad_norm, "tp_step_s": tp_s,
               "k6_v": kv.seen, "local_w2": list(state.model.joint.w2.shape),
               "launches": launches, "backend": dist.get_backend(mesh.group),
               "device": str(dev)}
        with open(os.path.join(data, f"tp_rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()
    return 0


def run_tp_two_ranks(cfg, seed, device="cuda"):
    """Two `tp_worker` processes on the card (gloo, a 1x2 mesh): the
    tensor-parallel step equals one process's within `require_step_errors`'
    bounds, with clipping engaged (the global norm above TP_CLIP); each
    rank holds W2 [640, 2048] and launches per step 10 K4, 10 K5 (fp32:
    FMA), one K6 at V=2048 and one K7 (warp).  Returns (the records, the
    path's launches summed over ranks)."""
    data = os.path.join(TRAIN_DIR, "tp2_data")
    write_train_data(cfg, data, TP_RANK_BATCH, TP_RANK_BATCH, seed + 4)
    recs = spawn_ranks("--tp_worker", "tp", data, seed, device)
    log("tp_two_ranks: " + json.dumps(
        [{k: v for k, v in r.items() if k != "launches"} for r in recs]))
    for rec in recs:
        n = rec["launches"]
        who = f"tp_two_ranks rank {rec['rank']}"
        require_step_errors("tp_two_ranks", rec)
        require(rec["grad_norm"] > TP_CLIP, f"{who}: gradient norm "
                f"{rec['grad_norm']} does not engage clipping at {TP_CLIP}")
        require(rec["local_w2"] == [cfg.joint_size, cfg.vocab_size // 2],
                f"{who}: W2 {rec['local_w2']}")
        require(rec["k6_v"] == [cfg.vocab_size // 2], f"{who}: K6 at V "
                f"{rec['k6_v']}")
        for k, want in (("lstm_fwd", 10), ("lstm_bwd", 10),
                        ("joint_planes", 1), ("lattice_scan", 1)):
            require(n[k] == want, f"{who}: {k} launched {n[k]} times, want "
                    f"{want}")
        require_warp_k7("tp_two_ranks", n["lattice_scan_by_design"], 1)
    return recs, sum_launches(recs)


def tp_cli_argv(data, out, rank, port, device):
    return ["--mode", "train", "--data_dir", data, "--output_dir", out,
            "--multihost", "--coordinator_address", f"localhost:{port}",
            "--num_processes", "2", "--process_id", str(rank),
            "--model_parallel", "2", "--batch_size", str(TRAIN_BATCH),
            "--n_epochs", "1", "--steps_per_log", "1", "--eval_size", "1",
            "--pad_frames", "256", "--pad_tokens", "64", "--ckpt_backend",
            "npz", "--device", device,
            # a step this small leaves the random joint emitting, so the
            # eval decodes tokens to compare (trained 2 steps at the default
            # rate, it decodes blanks only)
            "--config_override", "learning_rate=1e-7"]


def tp_cli_worker(rank, port, data, seed, device="cuda") -> int:
    """One rank of tp_cli: `run_rnnt --multihost --model_parallel 2` (bf16,
    B=32, TP_STEPS steps, one eval batch with greedy decode, an npz
    checkpoint) on a gloo group this process joins first (two ranks share
    the card); writes its launches, each K6 launch's V, the eval's decoded
    tokens and its W2 shape to data/tp_cli_rank{rank}.json."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from rnnt_tpu_torch.cli import run_rnnt
    from rnnt_tpu_torch.parallel import mesh as mesh_mod

    mesh_mod.init_distributed(f"localhost:{port}", 2, rank, device,
                              timeout_s=DP_WORKER_TIMEOUT_S, backend="gloo")
    try:
        zero_launches()
        with KernelV() as kv, DecodedTokens() as dec:
            state = run_rnnt.main(tp_cli_argv(
                data, os.path.join(data, "run"), rank, port, device))
        launches = read_launches()
        launches.update({f"{k}_by_design": v
                         for k, v in read_designs().items()})
        rec = {"rank": rank, "step": state.step, "k6_v": kv.seen,
               "tokens": dec.tokens,
               "local_w2": list(state.model.joint.w2.shape),
               "launches": launches}
        with open(os.path.join(data, f"tp_cli_rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()
    return 0


def run_tp_cli(cfg, seed, device="cuda"):
    """Two `tp_cli_worker` processes, then one process's `run_rnnt --mode
    eval` on their npz checkpoint: the eval loss within 1e-4 relative of
    the tensor-parallel eval's and the same decoded tokens.  Each rank
    trains TP_STEPS steps and evaluates one batch: per rank 10 K4 (MMA) and
    10 K5 a step, one K6 (WGMMA, V=2048) and one K7 (warp) a step and an
    eval batch.  Returns (the record, the ranks' launches summed, the
    one-process eval's launches)."""
    from rnnt_tpu_torch.cli import run_rnnt
    from rnnt_tpu_torch.train import checkpoint as ckpt_mod

    data = os.path.join(TRAIN_DIR, "tp_cli_data")
    write_train_data(cfg, data, TP_STEPS * TRAIN_BATCH, TRAIN_BATCH, seed + 5)
    out = os.path.join(data, "run")
    recs = spawn_ranks("--tp_cli_worker", "tp_cli", data, seed, device)
    with open(os.path.join(out, "tb", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in logged if "train_loss" in r]
    evals = [r for r in logged if "eval_loss" in r]
    latest = ckpt_mod.latest_checkpoint(out)
    require(len(losses) == TP_STEPS and all(np.isfinite(losses)),
            f"tp_cli train losses {losses}")
    require(len(evals) == 1 and np.isfinite(evals[0]["eval_loss"]),
            f"tp_cli eval lines {evals}")
    require(latest is not None and latest.endswith(
        f"checkpoint_{TP_STEPS:08d}") and os.path.exists(
        os.path.join(latest, "state.npz")), f"tp_cli checkpoint {latest}")
    for rec in recs:
        n, who = rec["launches"], f"tp_cli rank {rec['rank']}"
        require(rec["step"] == TP_STEPS, f"{who}: step {rec['step']}")
        require(rec["local_w2"] == [cfg.joint_size, cfg.vocab_size // 2],
                f"{who}: W2 {rec['local_w2']}")
        require(rec["k6_v"] == [cfg.vocab_size // 2] * (TP_STEPS + 1),
                f"{who}: K6 at V {rec['k6_v']}")
        require(rec["tokens"] == recs[0]["tokens"], f"{who}: decoded tokens "
                "differ from rank 0's")
        require_train_launches(who, n, TP_STEPS, 1, pallas=False)
    zero_launches()
    with DecodedTokens() as dec:
        one = run_rnnt.main(["--mode", "eval", "--data_dir", data,
                             "--checkpoint", out, "--output_dir", out,
                             "--batch_size", str(TRAIN_BATCH),
                             "--pad_frames", "256", "--pad_tokens", "64",
                             "--device", device])
    one_launches = read_launches()
    one_launches.update({f"{k}_by_design": v
                         for k, v in read_designs().items()})
    tp_eval = evals[0]["eval_loss"]
    rel = abs(one["eval_loss"] - tp_eval) / abs(tp_eval)
    rec = {"train_losses": losses, "tp_eval": evals[0], "one_process_eval":
           one, "eval_loss_rel": rel,
           "tokens_equal": dec.tokens == recs[0]["tokens"],
           "decoded": sum(len(t) for b in dec.tokens for t in b),
           "step_seconds": [r["step_seconds"] for r in logged
                            if "step_seconds" in r],
           "checkpoint": os.path.basename(latest)}
    log(f"tp_cli: {json.dumps(rec)}")
    require(rel <= 1e-4, f"tp_cli: one process's eval loss {one['eval_loss']}"
            f" vs the tensor-parallel eval's {tp_eval}")
    require(rec["tokens_equal"] and rec["decoded"] > 0, "tp_cli: one "
            "process decodes other tokens than the tensor-parallel eval, or "
            "none were decoded")
    return rec, sum_launches(recs), one_launches


def drive_tensor_parallel(paths, cfg, seed, smi, device="cuda"):
    """The tensor-parallel phase: K6 on shards, tp_two_ranks, tp_cli (and
    its one-process eval), bench_tp at its defaults and the dry run at
    n=4, each path's launches recorded (a multi-process path's are its
    ranks')."""
    from rnnt_tpu_torch import dryrun
    from rnnt_tpu_torch.cli import bench_tp

    rec = {"card": smi}
    t0 = time.perf_counter()
    rec["k6_shards_rel"], rec["k6_shard_ms"] = check_planes_shards(cfg)
    log(f"K6 shard gates: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["tp_two_ranks"], paths["tp_two_ranks"] = run_tp_two_ranks(cfg, seed,
                                                                  device)
    log(f"path tp_two_ranks with its data: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["tp_cli"], paths["tp_cli"], paths["tp_cli_one_process_eval"] = \
        run_tp_cli(cfg, seed, device)
    require_train_launches("tp_cli one-process eval",
                           paths["tp_cli_one_process_eval"], 0, 1,
                           pallas=False)
    log(f"path tp_cli with its data: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    (out, _), paths["bench_tp"] = drive_path(
        "bench_tp", lambda: run_main("bench_tp", bench_tp.main,
                                     ["--device", device]),
        ("joint_planes", "lattice_scan"))
    line = json.loads(out[-1])
    require(all(np.isfinite(line[k]) and line[k] > 0 for k in (
        "full_ms", "half_ms", "tp_group_of_one_ms", "estimate_2rank_ms")),
        f"bench_tp {line}")
    require_wgmma_k6("bench_tp", paths["bench_tp"]["joint_planes_by_design"],
                     paths["bench_tp"]["joint_planes"])
    rec["bench_tp"] = line
    log(f"path bench_tp: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rec["dryrun"] = dryrun.dryrun_multichip(4, device)
    log(rec["dryrun"])
    require(rec["dryrun"].startswith("dryrun_multichip(4): mesh={'data': 2, "
                                     "'model': 2} processes=4 loss="),
            f"dry run {rec['dryrun']}")
    log(f"dry run: {time.perf_counter() - t0:.1f} s")
    return rec


PHASES = ("serving", "k1_k2", "encoder_greedy", "beam", "stream_kernels",
          "export", "training", "conformer", "bench_entry_points",
          "data_prep", "int8_flac_oracle", "k4_k7", "bench_step", "data_parallel",
          "tensor_parallel")
# what a phase reads from an earlier one: the run directory and the server
# (serving), the train_cli run and its shards (training), the bench's
# timed steps (bench_entry_points)
PHASE_NEEDS = {"k1_k2": ("serving",), "encoder_greedy": ("serving",),
               "beam": ("serving",), "stream_kernels": ("serving",),
               "export": ("serving",), "bench_entry_points": ("serving",),
               "int8_flac_oracle": ("serving", "training"),
               "bench_step": ("serving", "bench_entry_points")}


def select_phases(spec: str) -> list:
    """The phases of a comma list ('all': every phase), with the phases
    they read from, in the script's order."""
    want = set(PHASES) if spec == "all" else set(spec.split(","))
    bad = sorted(want - set(PHASES))
    if bad:
        raise SystemExit(f"unknown phases {bad}; the phases are "
                         f"{', '.join(PHASES)}")
    todo = list(want)
    while todo:
        for dep in PHASE_NEEDS.get(todo.pop(), ()):
            if dep not in want:
                want.add(dep)
                todo.append(dep)
    return [p for p in PHASES if p in want]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--phases", default="all",
                   help="comma list of phases to run (default all: "
                        f"{','.join(PHASES)}); a phase brings the phases it "
                        "reads from")
    p.add_argument("--dp_worker", type=int, default=None,
                   help=argparse.SUPPRESS)  # a rank of dp_two_ranks
    p.add_argument("--dp_port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dp_dir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--dp_device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--tp_worker", type=int, default=None,
                   help=argparse.SUPPRESS)  # a rank of tp_two_ranks
    p.add_argument("--tp_cli_worker", type=int, default=None,
                   help=argparse.SUPPRESS)  # a rank of tp_cli
    p.add_argument("--plain_step", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch

    if args.dp_worker is not None:
        return dp_worker(args.dp_worker, args.dp_port, args.dp_dir, args.seed,
                         args.dp_device)
    if args.tp_worker is not None:
        return tp_worker(args.tp_worker, args.dp_port, args.dp_dir, args.seed,
                         args.dp_device)
    if args.tp_cli_worker is not None:
        return tp_cli_worker(args.tp_cli_worker, args.dp_port, args.dp_dir,
                             args.seed, args.dp_device)
    if args.plain_step is not None:
        return plain_train_step(args.plain_step, args.seed)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "rnnt_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    phases = select_phases(args.phases)
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
        f"{torch.version.cuda}; phases {','.join(phases)}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    build.build_all()
    log(f"built the kernel libraries in {time.perf_counter() - t0:.1f} s")

    cfg = RNNTConfig()
    rng = np.random.default_rng(args.seed)
    audios = [synthetic_audio(s, rng) for s in REQUEST_SECONDS]
    model32 = None
    if "serving" in phases:
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

    phase_s = {}
    t_phase = [time.perf_counter()]

    def end_phase(name):
        phase_s[name] = time.perf_counter() - t_phase[0]
        log(f"phase {name}: {phase_s[name]:.1f} s")
        t_phase[0] = time.perf_counter()

    srv = plain_step = None
    paths, per_request, found = {}, {}, {}
    timed = export_rec = k3_decode = None
    try:
        if "serving" in phases:
            t0 = time.perf_counter()
            write_run_dir(model32, cfg, RUN_DIR)
            log(f"run dir written in {time.perf_counter() - t0:.1f} s")
            srv = start_server()
            served = srv.service.model
            records, paths["greedy_http"] = drive_path(
                "greedy HTTP", lambda: post_requests(srv, audios),
                ("log_mel_frontend", "lstm_seq_infer"))
            beam_records, paths["beam_http"] = drive_path(
                f"beam {BEAM} HTTP", lambda: post_requests(srv, audios,
                                                           f"?beam={BEAM}"),
                ("log_mel_frontend", "lstm_seq_infer", "beam_search"))
            require(all(r["launches"]["beam_search"] == 1
                        for r in beam_records), "one beam launch a request")
            require_streamed_k3("beam_http", paths["beam_http"])
            _, paths["stream_tcp"] = drive_path(
                "stream TCP", lambda: tcp_session(srv, audios[1]),
                ("log_mel_frontend", "lstm_seq_infer"))
            per_request = {"greedy_http": records, "beam_http": beam_records}
            end_phase("serving")
            model32 = model32.cuda()

        if "k1_k2" in phases:
            found["k1"] = check_frontend(cfg, audios)
            mel_long, _ = padded_mel(audios[-1])
            k2 = found["k2"] = check_lstm_layer(served, mel_long)
            k2["designs_by_case"] = check_lstm_cases(cfg.encoder_size,
                                                     cfg.projection_size)
            for audio, secs in zip(audios, REQUEST_SECONDS):
                profile_request(served, *padded_mel(audio), f"{secs:g} s bf16")
                profile_beam(served, *padded_mel(audio), f"{secs:g} s bf16")
            end_phase("k1_k2")

        if "encoder_greedy" in phases:
            for audio in audios:
                mel_p, t = padded_mel(audio)
                check_encoder_and_greedy(model32, mel_p, t, 1e-4, True)
                check_encoder_and_greedy(served, mel_p, t, 2e-2, False)
            end_phase("encoder_greedy")

        if "beam" in phases:
            # three utterances of up to 2 s in the 128-frame bucket
            short = [audios[0], audios[1][: 16000 * 3 // 2],
                     audios[2][:16000]]
            mels = [padded_mel(a) for a in short]
            batch = torch.zeros((3, 128, cfg.input_feat_size), device="cuda")
            for i, (m, t) in enumerate(mels):
                batch[i, :t] = m[0, :t]
            cases = [("B=3 128-bucket", batch,
                      torch.tensor([t for _, t in mels]), False, MAX_TOKENS)]
            mel_p, t = padded_mel(audios[1])
            cases.append(("5 s, joint x8", mel_p, torch.tensor([t]), True,
                          MAX_TOKENS))
            # with --seed 0 the sharp joint emits 6 tokens in the 15 s
            # request's first 60 frames and 16 in all 250 (fp32): a cap of
            # 8 is reached well before the end, then only blanks settle
            mel_p, t = padded_mel(audios[2])
            cases.append(("15 s, joint x8", mel_p, torch.tensor([t]), True, 8))
            for audio, secs in zip(audios, REQUEST_SECONDS):
                mel_p, t = padded_mel(audio)
                cases.append((f"{secs:g} s", mel_p, torch.tensor([t]), False,
                              MAX_TOKENS))
            found["k3"] = check_beam(model32, served, cfg, cases)
            end_phase("beam")

        if "stream_kernels" in phases:
            check_stream_kernels(model32, srv.service.tokenizer, audios[1])
            end_phase("stream_kernels")

        if "export" in phases:
            mel_long, t_long = padded_mel(audios[-1])
            export_rec, paths["export_transcribe"] = drive_path(
                "export_transcribe", lambda: drive_export_transcribe(
                    model32, mel_long, t_long), ("lstm_seq_infer",))
            mel5 = F.preprocess_audio(torch.from_numpy(audios[1]).cuda(), cfg)
            export_rec["streaming"], paths["export_streaming"] = drive_path(
                "export_streaming", lambda: drive_export_streaming(
                    model32, cfg, mel5), ("lstm_seq_infer",))
            for name in ("export_transcribe", "export_streaming"):
                require_fma_k2(name, paths[name])
            export_rec["k2_call_host_us"] = k2_operator_cost(served)
            end_phase("export")
        model32 = None

        if "training" in phases:
            train_kernels = ("lstm_fwd", "lstm_bwd", "lattice_scan")
            data = os.path.join(TRAIN_DIR, "data")
            write_train_data(cfg, data, TRAIN_STEPS * TRAIN_BATCH,
                             TRAIN_BATCH, args.seed)
            _, paths["train_cli"] = drive_path(
                "train_cli (fused loss)", lambda: run_train_cli(
                    data, os.path.join(TRAIN_DIR, "run_fused"), "fused",
                    TRAIN_STEPS),
                train_kernels + ("joint_planes", "lstm_seq_infer"))
            require_train_launches("train_cli", paths["train_cli"],
                                   TRAIN_STEPS, 1, pallas=False)
            require_kernel_bwd("train_cli", paths["train_cli"], TRAIN_STEPS)
            for name in ("greedy_http", "beam_http", "stream_tcp",
                         "train_cli"):
                if name in paths:
                    require_resident_k2(name, paths[name])
            data = os.path.join(TRAIN_DIR, "data_pallas")
            write_train_data(cfg, data, TRAIN_BATCH, TRAIN_BATCH,
                             args.seed + 1)
            _, paths["train_pallas_loss"] = drive_path(
                "train_pallas_loss", lambda: run_train_cli(
                    data, os.path.join(TRAIN_DIR, "run_pallas"), "pallas",
                    1), train_kernels)
            require_train_launches("train_pallas_loss",
                                   paths["train_pallas_loss"], 1, 1,
                                   pallas=True)
            t_banded = time.perf_counter()
            data = os.path.join(TRAIN_DIR, "data_banded")
            write_train_data(cfg, data, BANDED_STEPS * TRAIN_BATCH,
                             TRAIN_BATCH, args.seed + 2)
            _, paths["train_banded"] = drive_path(
                "train_banded", lambda: run_train_cli(
                    data, os.path.join(TRAIN_DIR, "run_banded"), "banded",
                    BANDED_STEPS),
                train_kernels + ("joint_planes", "lstm_seq_infer"))
            require_train_launches("train_banded", paths["train_banded"],
                                   BANDED_STEPS, 1, pallas=False)
            require_resident_k2("train_banded", paths["train_banded"])
            log(f"path train_banded with its data: "
                f"{time.perf_counter() - t_banded:.1f} s")
            end_phase("training")

        if "conformer" in phases:
            found["k10"], found["k11"] = check_conv_module()
            (losses, step_ms, ran, layers), paths["train_conformer"] = \
                drive_path("train_conformer",
                           lambda: run_conformer_steps(args.seed),
                           ("conv_module_fwd", "conv_module_bwd"))
            log(f"path train_conformer: losses {losses}, step ms {step_ms}, "
                f"conv module calls by path {ran}")
            require(all(np.isfinite(losses)),
                    f"train_conformer losses {losses}")
            require_conformer_launches("train_conformer",
                                       paths["train_conformer"], ran, layers,
                                       CONFORMER_STEPS)
            end_phase("conformer")

        if "bench_entry_points" in phases:
            timed, k3_decode = drive_bench_entry_points(paths, cfg, args.seed)
            end_phase("bench_entry_points")

        if "data_prep" in phases:
            check_prep_and_specaug(paths, cfg, args.seed, smi)
            end_phase("data_prep")

        if "k4_k7" in phases:
            # the plain side of the fp32 step gate runs on the host CPU
            # beside the int8 phase's host-bound decodes (or K4-K7's gates)
            plain_step = start_plain_train_step_fp32(cfg, args.seed)
        if "int8_flac_oracle" in phases:
            art = os.path.join(RUN_DIR, "model_int8.npz")
            run_quantize(RUN_DIR, art)
            check_qdot(smi)
            check_quantized_serving(paths, srv, cfg, audios, art, smi)
            check_int8_entry_points(paths, os.path.join(TRAIN_DIR, "data"),
                                    os.path.join(TRAIN_DIR, "run_fused"), art,
                                    smi)
            check_flac(paths, audios[1])
            check_loss_oracle(paths, args.seed)
            end_phase("int8_flac_oracle")

        if "k4_k7" in phases:
            k45 = check_lstm_train(cfg.encoder_size, cfg.projection_size)
            designs = check_lstm_designs(cfg.encoder_size,
                                         cfg.projection_size)
            k5_cases = check_k5_designs(cfg.encoder_size, cfg.projection_size)
            for k in k45:
                k["designs_by_case"] = {case: d[k["name"]]
                                        for case, d in designs.items()
                                        if k["name"] in d}
            found["k4"], found["k5"] = k45
            found["k5"]["cluster_cases"] = k5_cases
            k6, planes32 = check_planes(cfg)
            found["k8"], found["k9"] = check_loss_backward(cfg)
            t_banded = time.perf_counter()
            k6.update(check_banded(cfg))
            k6["train_step_ms_fused_vs_banded"] = time_banded_step(cfg,
                                                                   args.seed)
            log(f"banded loss gates: {time.perf_counter() - t_banded:.1f} s")
            k7 = check_lattice(planes32)
            k7["ms_by_wide_U1"] = check_lattice_wide()
            del planes32
            found["k6"], found["k7"] = k6, k7
            check_train_step_fp32(cfg, args.seed, plain_step)
            end_phase("k4_k7")

        if "bench_step" in phases:
            bench_train_step(smi, timed, args.seed)
            end_phase("bench_step")

        if "data_parallel" in phases:
            dp = drive_data_parallel(paths, cfg, args.seed, smi)
            end_phase("data_parallel")

        if "tensor_parallel" in phases:
            tp = drive_tensor_parallel(paths, cfg, args.seed, smi)
            end_phase("tensor_parallel")
            if "k6" in found:
                found["k6"]["ms_by_v_local"] = tp["k6_shard_ms"]
                found["k6"]["max_rel_err_by_shard_case"] = tp["k6_shards_rel"]

        if "k2" in found and export_rec is not None:
            found["k2"]["export_paths"] = export_rec
        if "k3" in found and k3_decode is not None:
            k3 = found["k3"]
            k3["bench_decode_inputs"] = k3_decode
            k3["max_abs_err"] = max([k3["max_abs_err"]] + [
                r["max_abs_err"] for r in k3_decode.values()])
        kernels = [found[k] for k in ("k1", "k2", "k3", "k4", "k5", "k6",
                                      "k7", "k8", "k9", "k10", "k11")
                   if k in found]
        for k in kernels:
            name = k["name"]
            k["launches"] = sum(p[name] for p in paths.values())
            k["launches_by_path"] = {path: counts[name]
                                     for path, counts in paths.items()}
            k["launches_per_request"] = {
                path: [r["launches"][name] for r in recs]
                for path, recs in per_request.items()}
            designs = {}
            for counts in paths.values():
                for d, n in counts.get(f"{name}_by_design", {}).items():
                    designs[d] = designs.get(d, 0) + n
            if designs:
                k["launches_by_design"] = designs
            if name == "lstm_bwd":
                k["launches_by_cluster"] = {
                    c: sum(counts.get("lstm_bwd_by_cluster", {}).get(c, 0)
                           for counts in paths.values()) for c in (1, 2, 4)}
            log(f"{name}: {k['ms']:.4f} ms (plain {k['plain_ms']}, "
                f"bound {k['bound_ms']:.5f} by {k['bound_by']}, library "
                f"{k['library_ms']}), launches {k['launches_by_path']}")
        if "data_parallel" in phases:
            log("data_parallel " + json.dumps(dp))
        if "tensor_parallel" in phases:
            log("tensor_parallel " + json.dumps(
                {k: v for k, v in tp.items() if k != "k6_shards_rel"}))
    finally:
        if srv is not None:
            srv.shutdown()
        if plain_step is not None and plain_step[1].poll() is None:
            plain_step[1].kill()
            plain_step[1].wait()
        shutil.rmtree(RUN_DIR, ignore_errors=True)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    log(f"phase times (s): {json.dumps(phase_s)}; script "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
