"""Streaming decode latency benchmark on the card (the port of
`rnnt_tpu.cli.bench_streaming`).

Feeds fixed-size audio chunks (default 1024 samples @16 kHz = 64 ms)
through the stateful StreamingTranscriber on a randomly initialized
parity-width model with a 31-piece character vocabulary (--tiny: the debug
size) and reports per-chunk latency percentiles; each chunk runs the
frontend (kernel K1), the encoder (K2) and greedy decoding (K2).

  python -m rnnt_tpu_torch.cli.bench_streaming [--chunks 200] [--tiny]

With --checkpoint + --audio_dir it instead measures the QUALITY cost of
streaming: every utterance of --split is decoded offline and chunk-streamed
and the WER delta is reported.

  python -m rnnt_tpu_torch.cli.bench_streaming --checkpoint runs/x \\
      --audio_dir corpus/ --split test-synth

The flags are the JAX CLI's plus --device (cuda by default; cpu runs the
plain PyTorch path).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--chunks", type=int, default=100)
    p.add_argument("--chunk_samples", type=int, default=1024)
    p.add_argument("--tiny", action="store_true",
                   help="debug-size model instead of the parity config")
    p.add_argument("--checkpoint", default=None,
                   help="decode a real model: streamed-vs-offline WER mode")
    p.add_argument("--audio_dir", default=None,
                   help="LibriSpeech-layout corpus root (WER mode)")
    p.add_argument("--split", default="test-synth")
    p.add_argument("--max_utts", type=int, default=0, help="0 = all")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)
    if args.checkpoint and not args.audio_dir:
        p.error("--checkpoint (WER mode) requires --audio_dir")
    if args.chunks <= 3:
        p.error("--chunks must exceed the 3 warm-up chunks")

    import numpy as np
    import torch

    from rnnt_tpu_torch.cli import benchutil
    from rnnt_tpu_torch.config import RNNTConfig, tiny_config
    from rnnt_tpu_torch.data.tokenizer import CharTokenizer
    from rnnt_tpu_torch.decode.streaming import StreamingTranscriber
    from rnnt_tpu_torch.device import resolve_device
    from rnnt_tpu_torch.models.transducer import Transducer

    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    if args.checkpoint:
        import itertools

        from rnnt_tpu_torch.data import librispeech
        from rnnt_tpu_torch.data.tokenizer import (SUBWORD_FILENAME,
                                                    get_tokenizer)
        from rnnt_tpu_torch.decode.streaming import streamed_vs_offline
        from rnnt_tpu_torch.train import checkpoint as ckpt_mod

        cfg = ckpt_mod.load_config(args.checkpoint)
        tok = get_tokenizer(
            ckpt_mod.sidecar_dir(args.checkpoint, SUBWORD_FILENAME),
            cfg.token_type, cfg.vocab_size)
        state = ckpt_mod.restore_checkpoint(args.checkpoint, cfg, dtype, dev)
        utts = librispeech.load_dataset(args.audio_dir, [args.split])
        if args.max_utts:
            utts = itertools.islice(utts, args.max_utts)
        off_wer, str_wer, details = streamed_vs_offline(
            state.model.eval(), tok, utts, chunk_samples=args.chunk_samples)
        print(json.dumps({
            "metric": "streamed_vs_offline_wer_delta",
            "value": round(str_wer - off_wer, 4),
            "unit": "WER",
            "offline_wer": round(off_wer, 4),
            "streamed_wer": round(str_wer, 4),
            "n_utts": len(details),
            "chunk_samples": args.chunk_samples,
            "backend": dev.type,
            "rtt_ms": round(benchutil.measure_rtt_ms(dev), 3),
        }), flush=True)
        return 0

    if args.tiny:
        cfg = tiny_config()
    else:
        cfg = RNNTConfig(token_type="character", vocab_size=31)
    tok = CharTokenizer()
    cfg = cfg.replace(vocab_size=tok.vocab_size)
    model = Transducer(cfg).init_(0).cast_(dtype).to(dev).eval()
    # prime_seconds=0: the benchmark times steady-state per-chunk compute;
    # the quality-priming buffer would turn early timed chunks into
    # near-zero appends and shift the first calls past the warm-up cutoff
    st = StreamingTranscriber(model, tok, prime_seconds=0)

    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(args.chunks * args.chunk_samples)
             .astype(np.float32) * 0.1)

    lat = []
    for i in range(args.chunks):
        chunk = audio[i * args.chunk_samples:(i + 1) * args.chunk_samples]
        t0 = time.perf_counter()
        st.process_chunk(chunk)  # reads its tokens back: waits for the card
        lat.append(time.perf_counter() - t0)

    lat_ms = np.asarray(lat[3:]) * 1e3  # skip the warm-up chunks
    chunk_ms = args.chunk_samples / cfg.sample_rate * 1e3
    print(json.dumps({
        "metric": "streaming_chunk_latency_p50",
        "value": round(float(np.percentile(lat_ms, 50)), 2),
        "unit": "ms",
        "p95_ms": round(float(np.percentile(lat_ms, 95)), 2),
        "chunk_ms": chunk_ms,
        "real_time_factor": round(float(np.percentile(lat_ms, 50)) / chunk_ms,
                                  3),
        "backend": dev.type,
        # the launch-and-synchronise floor inside each chunk's latency (to
        # the microsecond: below 0.05 ms on the card)
        "rtt_ms": round(benchutil.measure_rtt_ms(dev), 3),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
