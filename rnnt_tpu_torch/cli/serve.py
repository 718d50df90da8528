"""Transcription server on the card (PyTorch/CUDA port): HTTP requests
(greedy or beam) and TCP streaming sessions.

  python -m rnnt_tpu_torch.cli.serve --checkpoint runs/ls100 \\
      [--host 0.0.0.0] [--http_port 8080] [--stream_port 8081] \\
      [--device cuda]

  curl -s -X POST --data-binary @audio.wav localhost:8080/transcribe
  curl -s -X POST --data-binary @a.wav 'localhost:8080/transcribe?beam=4'
  curl -s localhost:8080/info

Streaming protocol (TCP :8081): send `u32 n | n bytes float32 PCM` frames,
an empty frame ends the stream; every frame is answered with
`u32 m | JSON {"text", "final"}`.  See rnnt_tpu_torch/serve.py.

The flags are the JAX server's (`rnnt_tpu.cli.serve`) plus --device.  An
int8 artifact of the checkpoint (`rnnt_tpu_torch.cli.quantize_model`) is
served with --quantized model_int8.npz: dequantized, or with --int8_exec
the prediction net's and joint's products executed in int8.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--http_port", type=int, default=8080)
    p.add_argument("--stream_port", type=int, default=8081)
    p.add_argument("--quantized", default=None, metavar="MODEL_INT8_NPZ",
                   help="serve the int8 artifact of cli.quantize_model "
                        "(weights dequantized to the serving dtype)")
    p.add_argument("--int8_exec", action="store_true",
                   help="with --quantized: execute the prediction net's and "
                        "joint's products in int8 (beam requests search "
                        "with the XLA beam's counterpart)")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   help="skip building the kernels and running every decode "
                        "bucket and a short stream at startup (the first "
                        "requests then pay them under the device lock)")
    p.add_argument("--warmup_beam", type=int, default=4,
                   help="beam width to warm up beside greedy (0 = greedy "
                        "buckets only)")
    p.add_argument("--max_frames", type=int, default=512,
                   help="largest frame bucket /transcribe accepts; longer "
                        "utterances get 413")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)

    from rnnt_tpu_torch.serve import Server

    srv = Server(args.checkpoint, host=args.host, http_port=args.http_port,
                 stream_port=args.stream_port, device=args.device,
                 warmup=args.warmup,
                 warmup_beams=((0, args.warmup_beam) if args.warmup_beam
                               else (0,)),
                 max_t_pad=args.max_frames, quantized=args.quantized,
                 int8_exec=args.int8_exec)
    if srv.warmup_seconds:
        print(f"warmup: built kernels and ran the decode buckets in "
              f"{srv.warmup_seconds:.1f}s")
    mode = (" int8-exec" if args.int8_exec
            else " int8-dequantized" if args.quantized else "")
    print(f"serving {args.checkpoint}{mode} on {srv.service.device}: "
          f"http://{args.host}:{srv.http_port} (POST /transcribe, /info), "
          f"streaming tcp://{args.host}:{srv.stream_port}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.shutdown()


if __name__ == "__main__":
    main()
