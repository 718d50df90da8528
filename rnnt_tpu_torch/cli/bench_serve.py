"""Serving-layer benchmark on the card: HTTP transcribe latency and
throughput, and TCP streaming (the port of `rnnt_tpu.cli.bench_serve`).

    python -m rnnt_tpu_torch.cli.bench_serve --checkpoint runs/ls100 \\
        [--requests 50] [--concurrency 4] [--seconds 3.0] [--device cuda]

Drives the port's `serve.Server` over loopback sockets, so network framing,
JSON and the device lock are all in the measured path: the device round
trip, cold start (server up with its warm-up, first request, first
`?beam=4` request), sequential latency percentiles, `--concurrency` client
threads (req/s and audio-s/s), and a TCP streaming session in
`--chunk`-sample frames.  The server is shut down before `main` returns.
The flags are the JAX CLI's plus --device; --quantized and --int8_exec are
not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import socket
import struct
import sys
import threading
import time

import numpy as np


def _http_transcribe(port: int, body: bytes, timeout=600, beam=0) -> float:
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        path = f"/transcribe?beam={beam}" if beam else "/transcribe"
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        reply = r.read()
        if r.status != 200:
            raise RuntimeError(f"POST {path}: HTTP {r.status} {reply[:200]!r}")
        json.loads(reply)
    finally:
        conn.close()
    return time.perf_counter() - t0


def _stream_session(port: int, audio: np.ndarray, chunk: int) -> list:
    """One TCP session of `chunk`-sample float32 frames, then the end frame
    and its final reply.  Returns each data frame's round-trip seconds."""
    lats = []
    with socket.create_connection(("127.0.0.1", port), timeout=600) as s:
        def roundtrip(payload: bytes) -> dict:
            t0 = time.perf_counter()
            s.sendall(struct.pack("<I", len(payload)) + payload)
            hdr = s.recv(4, socket.MSG_WAITALL)
            if len(hdr) != 4:
                raise RuntimeError("stream closed before its reply")
            (m,) = struct.unpack("<I", hdr)
            reply = json.loads(s.recv(m, socket.MSG_WAITALL))
            if "error" in reply:
                raise RuntimeError(f"stream error frame: {reply}")
            lats.append(time.perf_counter() - t0)
            return reply

        for off in range(0, len(audio) - chunk, chunk):
            roundtrip(np.asarray(audio[off: off + chunk], "<f4").tobytes())
        final = roundtrip(b"")
        lats.pop()  # the end frame's flush is not a chunk
        if final.get("final") is not True:
            raise RuntimeError(f"no final reply to the end frame: {final}")
    return lats


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--requests", type=int, default=50)
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--seconds", type=float, default=3.0,
                   help="duration of the synthetic benchmark utterance")
    p.add_argument("--chunk", type=int, default=1024,
                   help="streaming chunk size in samples")
    p.add_argument("--no-warmup", dest="warmup", action="store_false")
    p.add_argument("--quantized", default=None, metavar="MODEL_INT8_NPZ",
                   help="not ported yet (refused)")
    p.add_argument("--int8_exec", action="store_true",
                   help="not ported yet (refused)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)
    if args.quantized or args.int8_exec:
        p.error("--quantized/--int8_exec: int8 serving is not ported to "
                "PyTorch yet (ROADMAP.md section A, item 7: the int8 slice)")
    sr = 16000
    if int(args.seconds * sr) <= 3 * args.chunk:
        p.error("--seconds must hold more than 3 chunks of --chunk samples "
                "(2 warm-up chunks are not counted)")

    from rnnt_tpu_torch.cli.benchutil import measure_rtt_ms
    from rnnt_tpu_torch.data.audio_io import write_wav
    from rnnt_tpu_torch.serve import Server

    # measured first and printed with every run, so that a comparison can
    # separate the launch-and-synchronise floor from the stack's time; to
    # the microsecond, since on the card it is below 0.05 ms
    rtt_ms = measure_rtt_ms(args.device)
    print(f"rtt_ms: {rtt_ms:.3f} (p50 of 20 scalar device round-trips; "
          f"subtract from every latency below for on-chip stack time)",
          flush=True)

    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(int(args.seconds * sr)) * 0.1).astype(
        np.float32)
    buf = io.BytesIO()
    write_wav(buf, audio, sr)
    body = buf.getvalue()

    # cold start: construction (+ optional warmup) + first request
    t0 = time.perf_counter()
    srv = Server(args.checkpoint, http_port=0, stream_port=0,
                 device=args.device, warmup=args.warmup)
    try:
        srv.serve_background()
        t_up = time.perf_counter() - t0
        t_first = _http_transcribe(srv.http_port, body)
        print(f"cold start: server up {t_up:.2f}s "
              f"(warmup {srv.warmup_seconds:.2f}s), "
              f"first request {t_first:.2f}s, "
              f"total-to-first-transcription {t_up + t_first:.2f}s",
              flush=True)
        # with warmup, the first beam request pays no first call either
        t_first_beam = _http_transcribe(srv.http_port, body, beam=4)
        print(f"first beam-4 request: {t_first_beam:.2f}s", flush=True)

        lats = [_http_transcribe(srv.http_port, body)
                for _ in range(args.requests)]
        lats_ms = np.sort(np.asarray(lats)) * 1e3
        p50 = float(np.percentile(lats_ms, 50))
        p99 = float(np.percentile(lats_ms, 99))
        print(f"sequential: {args.requests} reqs of {args.seconds:.1f}s "
              f"audio  p50 {p50:.1f} ms  p99 {p99:.1f} ms  "
              f"{1e3 / p50 * args.seconds:.1f}x realtime at p50", flush=True)

        # concurrent throughput: N client threads posting /transcribe
        per_worker = max(4, args.requests // args.concurrency)
        all_lats, errors = [], []

        def worker():
            try:
                for _ in range(per_worker):
                    all_lats.append(_http_transcribe(srv.http_port, body))
            except Exception as ex:  # noqa: BLE001 - raised after the join
                errors.append(ex)

        t0 = time.perf_counter()
        ts = [threading.Thread(target=worker)
              for _ in range(args.concurrency)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        n = args.concurrency * per_worker
        c_ms = np.sort(np.asarray(all_lats)) * 1e3
        print(f"concurrent x{args.concurrency}: {n} reqs in {wall:.2f}s = "
              f"{n / wall:.1f} req/s ({n * args.seconds / wall:.1f} "
              f"audio-s/s)  p50 {float(np.percentile(c_ms, 50)):.1f} ms  "
              f"p99 {float(np.percentile(c_ms, 99)):.1f} ms", flush=True)

        chunk_lats = _stream_session(srv.stream_port, audio, args.chunk)
        cl_ms = np.sort(np.asarray(chunk_lats[2:])) * 1e3  # skip 2 warm-up
        print(f"streaming: {len(chunk_lats)} chunks of "
              f"{args.chunk / sr * 1e3:.0f} ms  "
              f"p50 {float(np.percentile(cl_ms, 50)):.1f} ms  "
              f"p99 {float(np.percentile(cl_ms, 99)):.1f} ms per chunk",
              flush=True)
    finally:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
