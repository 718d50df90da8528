#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (rnnt_tpu_torch) on one H100.

  python3 chip_smoke.py [--seed 0]

Drives the port's serving paths at the parity width (RNNTConfig(): 8x2048/640
encoder, 2x2048 prediction net, joint 640, V=4096, bf16 parameters, random
weights from --seed) through the entry points a user calls.  Random weights
rarely predict blank, so every greedy request decodes up to
max_output_length (256 tokens): the decode times are those of that worst
case.

1. builds every CUDA kernel from rnnt_tpu_torch/csrc (one nvcc per source,
   in parallel);
2. writes a run directory in the JAX package's on-disk layout (config.json,
   a 4096-piece encoder.subwords, checkpoint_00000000/state.npz) and starts
   rnnt_tpu_torch.serve.Server on it (HTTP and TCP streaming), warmed up;
3. drives three paths, each with every kernel's launch count set to 0 just
   before it and read just after: POSTs of WAVs of 2 s, 5 s and 15 s (the
   128-, 256- and 512-frame buckets) decoded greedily, the same WAVs with
   ?beam=4 (one beam-kernel launch a request), and a TCP streaming session
   of the 5 s WAV in 1024-sample frames; it prints each request's latency
   split into frontend, encoder and decode with its launches, and each
   stream chunk's reply latency (p50, p99, max);
4. holds each kernel against its plain PyTorch version on the card at the
   request shapes: the frontend (K1) in fp32, max |d log-mel| <= 2e-4; the
   LSTM (K2) for random inputs with a carried state at B=1 and B=5 (fp32
   <= 1e-4, bf16 <= 2e-2 relative error, inputs left untouched), and for
   the whole encoder in fp32 (<= 1e-4) and bf16 (<= 2e-2); fp32 greedy
   argmaxes are identical at every joint step up to any step whose top-2
   logit margin on the plain path is below 1e-4; the beam search (K3) at
   each request's encoder output, a B=3 batch at the 128 bucket, the 5 s
   request with a sharpened joint and the 15 s one capped at 8 tokens
   (which it must reach, with merges), in fp32 and in bf16: scores finite
   and sorted, lengths within the cap, token ids in [1, V), every live
   score within 1e-4 (fp32) or 1e-2 (bf16) relative error, the two
   searches' picks identical at every selection up to the first near tie
   (a gap below 1e-4 plus twice the score drift so far), slot-0 tokens and
   lengths identical unless such a tie precedes; the bf16 gate must reject
   a control (the kernel reading W2 with the halves of its 16-byte groups
   swapped); the fp32 stream through the kernels and through the plain
   versions, greedy argmaxes identical up to a near tie (margin < 1e-4);
5. profiles each request's encoder, greedy decode and beam decode with
   torch.profiler: wall time, device ops and device busy time of one
   profiled run, and the idle share 1 - busy / wall from that same run (a
   profiled run whose records miss a launch of the profiled kernel is
   repeated, at most 3 runs);
6. prints a `kernels` JSON line (launches on the driven paths, median kernel
   time, plain and library times, the roofline bound, max error; for K3 also
   the weight traffic of re-reading the weights at every product, and its
   time split over the phases of a search), the card's name and power
   limit, and last the line {"ok": true, "device": {"platform": "gpu", ...}}.

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
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(REPO, ".smoke_run")  # listed in .gitignore
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12      # CUDA cores, fp32
PEAK_BF16_FLOPS = 989e12     # tensor cores, dense bf16
REQUEST_SECONDS = (2.0, 5.0, 15.0)
BEAM, MAX_TOKENS = 4, 256  # the served beam width and max_output_length


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card (CUDA events, after warm-up)."""
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
    return statistics.median(times)


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
    from rnnt_tpu_torch.ops import beam_cuda, features_cuda, lstm_cuda

    return {"log_mel_frontend": features_cuda.log_mel_frontend,
            "lstm_seq_infer": lstm_cuda.lstm_seq_infer,
            "beam_search": beam_cuda.beam_search}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


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
    the JAX package's layout (leaf_0 the step, then the parameters in
    jax.tree_util flatten order, fp32)."""
    from rnnt_tpu_torch.data.tokenizer import SubwordTokenizer
    from rnnt_tpu_torch.train.checkpoint import flatten_order

    shutil.rmtree(path, ignore_errors=True)
    cfg.save(path)
    SubwordTokenizer(synthetic_pieces(cfg.vocab_size)).save(path)
    sd = model.state_dict()
    leaves = {"leaf_0": np.zeros((), np.int32)}
    for i, name in enumerate(flatten_order(sd), start=1):
        leaves[f"leaf_{i}"] = sd[name].float().cpu().numpy()
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


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def check_frontend(cfg, audios):
    """K1 vs its plain version on the card, at each request's audio."""
    import torch

    from rnnt_tpu_torch.ops import features as F
    from rnnt_tpu_torch.ops.features_cuda import dft_matrices, log_mel_frontend

    worst = 0.0
    for audio in audios:
        a = torch.from_numpy(audio).cuda()
        got = F.subtract_mean(log_mel_frontend(a, cfg))
        want = F.subtract_mean(F.log_mel_plain(a, cfg))
        require(got.shape == want.shape, (got.shape, want.shape))
        err = float((got - want).abs().max())
        log(f"K1 frontend {audio.shape[0]} samples -> {tuple(got.shape)}: "
            f"max |d log-mel| {err:.3e}")
        require(err <= 2e-4, f"frontend kernel disagrees: {err}")
        worst = max(worst, err)
    # timing at the longest request
    a = torch.from_numpy(audios[-1]).cuda()
    n_frames = F.num_frames(a.shape[0], cfg)
    L = cfg.frame_length_samples
    nfft = F.next_pow2(L)
    K = nfft // 2 + 1
    M = cfg.mel_bins
    mel_nnz = int(np.count_nonzero(dft_matrices(cfg)[2]))
    # the function's least work a frame: window, real FFT (2.5 N log2 N),
    # magnitude, the sparse mel filters, log; the kernel's matrix DFT does
    # 2 * 2LK instead of the FFT's operations
    flops = n_frames * (L + 2.5 * nfft * np.log2(nfft) + 4 * K
                        + 2 * mel_nnz + M)
    kernel_flops = 2.0 * n_frames * (2 * L * K + K * M)
    nbytes = 4.0 * (a.shape[0] + n_frames * M)  # audio in, log-mel out
    t_flops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {
        "name": "log_mel_frontend",
        "route": "cuda",
        "source": "rnnt_tpu_torch/csrc/frontend.cu",
        "replaces": "rnnt_tpu/ops/features_pallas.py:81",
        "max_abs_err": worst,
        "ms": cuda_ms(lambda: log_mel_frontend(a, cfg), reps=50),
        "plain_ms": cuda_ms(lambda: F.log_mel_plain(a, cfg), reps=20),
        "bound_ms": max(t_flops, t_bytes) * 1e3,
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        "library_ms": None,
        "shape": f"audio [{a.shape[0]}] -> [{n_frames},{M}] f32",
        "kernel_matrix_dft_gflop": kernel_flops / 1e9,
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
    return ref


def check_lstm_cases(H: int, P: int) -> None:
    """K2 vs its plain version on random inputs with a carried state, at
    B=1 T=1 (the prediction-net step) and B=5 T=7 (two batch passes), in
    both weight dtypes; the kernel must leave its inputs untouched."""
    import torch

    from rnnt_tpu_torch.ops import lstm_cuda

    g = torch.Generator(device="cuda").manual_seed(1)

    def rand(shape, scale):
        return (torch.rand(shape, generator=g, device="cuda") - 0.5) * scale

    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for T, B in ((1, 1), (7, 5)):
            args = (rand((T, B, 4 * H), 4.0).to(dt),
                    rand((P, 4 * H), 0.05).to(dt), rand((H, P), 0.1).to(dt),
                    rand((4 * H,), 1.0).to(dt), rand((B, P), 0.5).to(dt),
                    rand((B, H), 0.5))
            before = [a.clone() for a in args]
            h_k, c_k = lstm_cuda.lstm_seq_infer(*args)
            h_p, c_p = lstm_cuda.lstm_seq_infer_plain(*args)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(args, before)),
                    "LSTM kernel wrote into its inputs")
            err = max(rel_err(h_k, h_p), rel_err(c_k, c_p))
            log(f"K2 lstm T={T} B={B} {str(dt)[6:]} with state: rel err "
                f"{err:.3e}")
            require(err <= tol, f"LSTM kernel disagrees: {err}")


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
    nbytes = (esize * (xp.numel() + lstm.wh.numel() + lstm.wp.numel()
                       + lstm.bias.numel() + h0.numel() + T * B * P)
              + 4 * (c0.numel() + B * H))
    flops = 2.0 * T * B * (P * 4 * H + H * P)
    peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_FP32_FLOPS
    t_flops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    # one step, as the prediction net runs it in greedy decoding
    step_args = (xp[:1],) + args[1:]
    step_ms = cuda_ms(lambda: lstm_cuda.lstm_seq_infer(*step_args), reps=50)
    x_tb = x.transpose(0, 1).to(dt).contiguous()
    ref = cudnn_proj_lstm(lstm, x)  # the yardstick only; the port never uses it
    with torch.no_grad():
        library_ms = cuda_ms(lambda: ref(x_tb), reps=10)
    entry = {
        "name": "lstm_seq_infer",
        "route": "cuda",
        "source": "rnnt_tpu_torch/csrc/lstm_infer.cu",
        "replaces": "rnnt_tpu/ops/lstm_pallas.py:135",
        "max_abs_err": max_abs,
        "ms": cuda_ms(lambda: lstm_cuda.lstm_seq_infer(*args), reps=10),
        "plain_ms": cuda_ms(lambda: lstm_cuda.lstm_seq_infer_plain(*args),
                            reps=3, warmup=1),
        "bound_ms": max(t_flops, t_bytes) * 1e3,
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "shape": f"xp [{T},{B},{4 * H}] {str(dt)[6:]}, H={H} P={P}",
        "step_ms": step_ms,
    }
    log(f"K2 one-step launch (prediction-net shape): {step_ms:.4f} ms")
    return entry


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


def device_profile(fn, kernel, symbol, attempts=3):
    """Run fn() once without and then under torch.profiler.  Returns the
    wall ms of the first run, and of the profiled run: its wall ms (profiler
    overhead included), device ops, device busy ms, `kernel`'s launches and
    the number of profiled runs.

    The profiler on the card has dropped every device record of a session
    (a 15 s beam decode recorded 0 ops), so a profiled run is accepted only
    when its records hold each launch of the kernel (device ops whose name
    contains `symbol`), and is repeated otherwise, at most `attempts` times.
    The session is opened 10 ms before fn() starts and closed 10 ms after it
    ends, so that no record falls outside its window."""
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
            time.sleep(0.01)
            n0 = kernel.launches
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = kernel.launches - n0
            time.sleep(0.01)
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        recorded = sum(symbol in e.name for e in device)
        if launches > 0 and recorded == launches:
            break
        log(f"profiled run {attempt}: {len(device)} device ops, {recorded} "
            f"of {launches} {symbol} launches recorded")
    require(launches > 0 and recorded == launches,
            f"the profiler recorded {recorded} of {launches} {symbol} "
            f"launches in {attempts} runs")
    busy_us = sum(e.time_range.end - e.time_range.start for e in device)
    return plain_wall_ms, wall_ms, len(device), busy_us / 1e3, launches, \
        attempt


def profile_request(model, mel_p, t, label):
    """Device ops and idle share of the encoder and of greedy decoding for
    one request (B=1, single stream, so busy time is the sum of op times).
    Wall, busy time and launches all come from the one profiled run."""
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
            plain_wall, wall, ops, busy, launches, runs = device_profile(
                fn, lstm_cuda.lstm_seq_infer, "lstm_infer_kernel")
            what = f"profile {label} {phase}"
            require(busy <= wall, f"{what}: device busy {busy} ms exceeds "
                    f"wall {wall} ms on one stream")
            # in decoding, each joint step advances the 2-layer prediction
            # net once, after one call that consumes the start token
            steps = launches // 2 - 1
            per = (f", {steps} joint steps, {ops / steps:.1f} device ops a "
                   f"step" if phase == "decode" else "")
            log(f"{what}: wall {wall:.2f} ms ({plain_wall:.2f} without the "
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
    return records


def drive_path(name, fn, expect):
    """Run one path with every launch count set to 0 just before it and
    read just after; each kernel in `expect` must have launched.  Returns
    (fn's result, the path's launch counts)."""
    zero_launches()
    t0 = time.perf_counter()
    out = fn()
    launches = read_launches()
    log(f"path {name}: {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps(launches)}")
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
    control = None
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
                want = beam_search_encoded_plain(model, enc, enc_len,
                                                 stats=stats, **kw)
                torch.cuda.synchronize()
            fails, notes, max_abs, rel = gate_beam(
                got, trace, want, stats, enc_len, E, cfg.vocab_size,
                BEAM_SCORE_TOL[dt])
            log(f"K3 beam {label} L={cap} {dt} enc {tuple(enc.shape)}: "
                f"lengths {got[1].tolist()} (plain {want[1].tolist()}), "
                f"scores max |d| {max_abs:.3e} rel {rel:.3e}, merges "
                f"{stats['merges']}, {stats['idx'].shape[0]} selections "
                + ("identical" if not notes and not fails else
                   "; ".join(notes + fails)))
            require(not fails, f"beam kernel {label} {dt}: {fails}")
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
        phase_ns = torch.zeros(len(beam_cuda.PHASES), dtype=torch.int64,
                               device=enc.device)
        beam_cuda.beam_search(served, enc, enc_len, phase_ns=phase_ns, **kw)
    torch.cuda.synchronize()
    phases = {n: v / 1e6 for n, v in zip(beam_cuda.PHASES, phase_ns.tolist())}
    log("K3 phases of block 0 (ms): " + json.dumps(phases))
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
        "phase_ms": phases,
    }
    return entry


def profile_beam(served, mel_p, t, label):
    """Device ops and idle share of one beam decode (the search after the
    encoder), from one profiled run, beside greedy's."""
    import torch

    from rnnt_tpu_torch.decode.beam import default_expansions
    from rnnt_tpu_torch.ops import beam_cuda

    enc_len = served.encoded_length(torch.tensor([t], device=mel_p.device))
    with torch.no_grad():
        enc, _ = served.encode(mel_p)
        plain_wall, wall, ops, busy, launches, runs = device_profile(
            lambda: beam_cuda.beam_search(
                served, enc, enc_len, beam_width=BEAM,
                max_output_length=MAX_TOKENS,
                expansions_per_frame=default_expansions(served.cfg)),
            beam_cuda.beam_search, "beam_kernel")
    what = f"profile {label} beam decode"
    require(launches == 1, f"{what}: {launches} beam launches")
    require(busy <= wall, f"{what}: busy {busy} ms exceeds wall {wall} ms")
    log(f"{what}: wall {wall:.2f} ms ({plain_wall:.2f} without the "
        f"profiler), device busy {busy:.2f} ms ({ops} device ops, "
        f"{launches} beam launch), idle share {1 - busy / wall:.3f}, "
        f"profiled runs {runs}")


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
        _, paths["stream_tcp"] = drive_path(
            "stream TCP", lambda: tcp_session(srv, audios[1]),
            ("log_mel_frontend", "lstm_seq_infer"))
        t_phase = time.perf_counter()

        k1 = check_frontend(cfg, audios)
        mel_long, t_long = padded_mel(audios[-1])
        k2 = check_lstm_layer(served, mel_long)
        check_lstm_cases(cfg.encoder_size, cfg.projection_size)
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
        per_request = {"greedy_http": records, "beam_http": beam_records}
        for k in (k1, k2, k3):
            name = k["name"]
            k["launches"] = sum(p[name] for p in paths.values())
            k["launches_by_path"] = {path: counts[name]
                                     for path, counts in paths.items()}
            k["launches_per_request"] = {
                path: [r["launches"][name] for r in recs]
                for path, recs in per_request.items()}
            log(f"{name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f}, "
                f"bound {k['bound_ms']:.5f} by {k['bound_by']}, library "
                f"{k['library_ms']}), launches {k['launches_by_path']}")
    finally:
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(RUN_DIR, ignore_errors=True)

    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
