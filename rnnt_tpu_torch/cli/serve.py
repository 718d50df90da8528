"""Transcription server on the card (PyTorch/CUDA port): HTTP greedy
transcription.

  python -m rnnt_tpu_torch.cli.serve --checkpoint runs/ls100 \\
      [--host 0.0.0.0] [--http_port 8080] [--device cuda]

  curl -s -X POST --data-binary @audio.wav localhost:8080/transcribe
  curl -s localhost:8080/info

The flags are the JAX server's (`rnnt_tpu.cli.serve`) plus --device.  Beam
search, the int8 paths and the TCP streaming port are not ported yet:
--warmup_beam above 0, --quantized and --int8_exec are refused, and
--stream_port is accepted but nothing listens there.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--http_port", type=int, default=8080)
    p.add_argument("--stream_port", type=int, default=8081,
                   help="accepted for compatibility; streaming is not served "
                        "by the port yet")
    p.add_argument("--quantized", default=None, metavar="MODEL_INT8_NPZ",
                   help="not supported by the port yet")
    p.add_argument("--int8_exec", action="store_true",
                   help="not supported by the port yet")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   help="skip building the kernels and running every greedy "
                        "bucket at startup (the first request then pays them "
                        "under the device lock)")
    p.add_argument("--warmup_beam", type=int, default=0,
                   help="beam width to warm up beside greedy; only 0 until "
                        "beam search is ported")
    p.add_argument("--max_frames", type=int, default=512,
                   help="largest frame bucket /transcribe accepts; longer "
                        "utterances get 413")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)
    if args.quantized or args.int8_exec:
        p.error("--quantized/--int8_exec: int8 serving is not ported to "
                "PyTorch yet")
    if args.warmup_beam:
        p.error("--warmup_beam: beam search is not ported to PyTorch yet; "
                "use 0")

    from rnnt_tpu_torch.serve import Server

    srv = Server(args.checkpoint, host=args.host, http_port=args.http_port,
                 device=args.device, warmup=args.warmup,
                 max_t_pad=args.max_frames)
    if srv.warmup_seconds:
        print(f"warmup: built kernels and ran the greedy buckets in "
              f"{srv.warmup_seconds:.1f}s")
    print(f"serving {args.checkpoint} on {srv.service.device}: "
          f"http://{args.host}:{srv.http_port} (POST /transcribe, /info)",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.shutdown()


if __name__ == "__main__":
    main()
