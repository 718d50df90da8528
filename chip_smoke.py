#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (rnnt_tpu_torch) on one H100.

  python3 chip_smoke.py [--seed 0]

Drives the port's serving path at the parity width (RNNTConfig(): 8x2048/640
encoder, 2x2048 prediction net, joint 640, V=4096, bf16 parameters, random
weights from --seed) through the entry points a user calls.  Random weights
rarely predict blank, so every request decodes up to max_output_length (256
tokens): the decode times are those of that worst case.

1. builds every CUDA kernel from rnnt_tpu_torch/csrc (one nvcc per source,
   in parallel);
2. writes a run directory in the JAX package's on-disk layout (config.json,
   a 4096-piece encoder.subwords, checkpoint_00000000/state.npz) and starts
   rnnt_tpu_torch.serve.Server on it, warmed up;
3. POSTs WAVs of 2 s, 5 s and 15 s (the 128-, 256- and 512-frame buckets)
   and prints each request's latency split into frontend, encoder and decode,
   with the kernel launch counts of that request;
4. holds each kernel against its plain PyTorch version on the card at the
   request shapes: the frontend (K1) in fp32, max |d log-mel| <= 2e-4; the
   LSTM (K2) for random inputs with a carried state at B=1 and B=5 (fp32
   <= 1e-4, bf16 <= 2e-2 relative error, inputs left untouched), and for
   the whole encoder in fp32 (<= 1e-4) and bf16 (<= 2e-2); fp32 greedy
   argmaxes are identical at every joint step up to any step whose top-2
   logit margin on the plain path is below 1e-4;
5. profiles each request's encoder and greedy decode with torch.profiler:
   wall time, device ops and device busy time of one profiled run, and the
   idle share 1 - busy / wall from that same run;
6. prints a `kernels` JSON line (launches on the served requests, median
   kernel time, plain and library times, the roofline bound, max error), the
   card's name and power limit, and last the line
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
import statistics
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
            tok, n = greedy_decode_encoded(model, enc, enc_len,
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


def device_profile(fn, kernel):
    """Run fn() once without and once under torch.profiler.  Returns the
    wall ms of the first run, and of the profiled run: its wall ms (profiler
    overhead included), device ops, device busy ms and `kernel`'s launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n0 = kernel.launches
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = kernel.launches - n0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.end - e.time_range.start for e in device)
    return plain_wall_ms, wall_ms, len(device), busy_us / 1e3, launches


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
            plain_wall, wall, ops, busy, launches = device_profile(
                fn, lstm_cuda.lstm_seq_infer)
            what = f"profile {label} {phase}"
            require(ops > 0, f"{what}: the profiler recorded no device ops")
            require(busy <= wall, f"{what}: device busy {busy} ms exceeds "
                    f"wall {wall} ms on one stream")
            # in decoding, each joint step advances the 2-layer prediction
            # net once, after one call that consumes the start token
            steps = launches // 2 - 1
            per = (f", {steps} joint steps, {ops / steps:.1f} device ops a "
                   f"step" if phase == "decode" else "")
            log(f"{what}: wall {wall:.2f} ms ({plain_wall:.2f} without the "
                f"profiler), device busy {busy:.2f} ms ({ops} device "
                f"ops{per}), idle share {1 - busy / wall:.3f}")


def serve_requests(cfg, audios):
    """Start the port's Server on the run dir and POST each WAV.  Returns
    (server, per-request records, launch counts over all requests)."""
    from rnnt_tpu_torch.ops import features_cuda, lstm_cuda
    from rnnt_tpu_torch.serve import Server

    t0 = time.perf_counter()
    srv = Server(RUN_DIR, http_port=0, device="cuda", warmup=True)
    log(f"server up in {time.perf_counter() - t0:.1f} s (warmup "
        f"{srv.warmup_seconds:.1f} s), dtype {srv.service.model.dtype}")
    srv.serve_background()
    records = []
    frontend, lstm = features_cuda.log_mel_frontend, lstm_cuda.lstm_seq_infer
    frontend.launches = lstm.launches = 0
    for audio in audios:
        f0, l0 = frontend.launches, lstm.launches
        conn = http.client.HTTPConnection("127.0.0.1", srv.http_port,
                                          timeout=600)
        t0 = time.perf_counter()
        conn.request("POST", "/transcribe", body=wav_bytes(audio))
        r = conn.getresponse()
        reply = json.loads(r.read())
        ms = (time.perf_counter() - t0) * 1e3
        conn.close()
        require(r.status == 200, reply)
        require(isinstance(reply["text"], str), reply)
        tm = dict(srv.service.last_timings)
        rec = {"seconds": audio.shape[0] / 16000, "latency_ms": ms, **tm,
               "frontend_launches": frontend.launches - f0,
               "lstm_launches": lstm.launches - l0,
               "text_chars": len(reply["text"])}
        records.append(rec)
        log("request " + json.dumps(rec))
    launches = {"log_mel_frontend": frontend.launches,
                "lstm_seq_infer": lstm.launches}
    require(all(v > 0 for v in launches.values()), launches)
    return srv, records, launches


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
        srv, records, launches = serve_requests(cfg, audios)
        served = srv.service.model

        k1 = check_frontend(cfg, audios)
        mel_long, t_long = padded_mel(audios[-1])
        k2 = check_lstm_layer(served, mel_long)
        check_lstm_cases(cfg.encoder_size, cfg.projection_size)
        for audio, secs in zip(audios, REQUEST_SECONDS):
            profile_request(served, *padded_mel(audio), f"{secs:g} s bf16")
        model32 = model32.cuda()
        for audio in audios:
            mel_p, t = padded_mel(audio)
            check_encoder_and_greedy(model32, mel_p, t, 1e-4, True)
            check_encoder_and_greedy(served, mel_p, t, 2e-2, False)
        n_req = len(records)
        for k in (k1, k2):
            k["launches"] = launches[k["name"]]
            k["launches_per_request"] = [
                r["frontend_launches" if k is k1 else "lstm_launches"]
                for r in records]
            log(f"{k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f}, "
                f"bound {k['bound_ms']:.5f} by {k['bound_by']}, library "
                f"{k['library_ms']}), {k['launches'] / n_req:.1f} launches "
                f"per request")
    finally:
        if srv is not None:
            srv.shutdown()
        shutil.rmtree(RUN_DIR, ignore_errors=True)

    print(json.dumps({"kernels": [k1, k2]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
