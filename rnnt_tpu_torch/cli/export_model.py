"""Export a trained model as `torch.export` serving artifacts (the port of
`rnnt_tpu.cli.export_model`; see `rnnt_tpu_torch/export.py`).

  python -m rnnt_tpu_torch.cli.export_model --checkpoint runs/ls100 \\
      --output runs/ls100/export --chunk_frames 4 [--device cuda]

Writes streaming_step.pt2 and transcribe.pt2 (with .json metadata
sidecars) into --output.  The checkpoint is read through
`train.checkpoint` and the weights cast to fp32.  A `.pt2` holds the ops of
one device, so the artifacts are exported for --device (the card by
default; cpu when asked), where the JAX CLI takes --platforms.  --check
loads the transcribe artifact again and compares its tokens and lengths
with the live model's greedy decode of random log-mel
(np.random.default_rng(0)); a mismatch exits 1.  `main(argv)` returns the
exit code.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", default=None,
                   help="output dir (default: <checkpoint>/export)")
    p.add_argument("--chunk_frames", type=int, default=4,
                   help="stacked frames per streaming step")
    p.add_argument("--max_tokens_per_chunk", type=int, default=64)
    p.add_argument("--batch", type=int, default=1,
                   help="transcribe artifact batch size")
    p.add_argument("--frames", type=int, default=512,
                   help="transcribe artifact max frames")
    p.add_argument("--max_output_length", type=int, default=200)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the device the artifacts run "
                        "on")
    p.add_argument("--no-freeze", dest="freeze", action="store_false",
                   help="keep the weights as a runtime argument instead of "
                        "storing them in the artifacts")
    p.add_argument("--check", action="store_true",
                   help="load the transcribe artifact again and compare it "
                        "with the live model")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from rnnt_tpu_torch import export as ex
    from rnnt_tpu_torch.device import resolve_device
    from rnnt_tpu_torch.models.transducer import Transducer
    from rnnt_tpu_torch.train import checkpoint as ckpt_mod

    dev = resolve_device(args.device)
    cfg = ckpt_mod.load_config(args.checkpoint)
    _, state_dict = ckpt_mod.restore_params(args.checkpoint, cfg)  # fp32
    model = Transducer(cfg)
    model.load_state_dict(state_dict)
    model = model.to(dev).eval()
    out_dir = args.output or os.path.join(args.checkpoint, "export")

    def write(name, program, meta, t0):
        path = ex.save_artifact(out_dir, name, program, meta)
        print(f"wrote {path} ({os.path.getsize(path) / 2**20:.1f} MB, "
              f"device={dev.type}, {time.perf_counter() - t0:.1f} s)")
        return path

    t0 = time.perf_counter()
    program, meta = ex.export_streaming_step(
        model, cfg, chunk_frames=args.chunk_frames,
        max_tokens_per_chunk=args.max_tokens_per_chunk, device=dev,
        freeze_params=args.freeze)
    write("streaming_step", program, meta, t0)
    t0 = time.perf_counter()
    program, meta = ex.export_transcribe(
        model, cfg, batch=args.batch, frames=args.frames,
        max_output_length=args.max_output_length, device=dev,
        freeze_params=args.freeze)
    path_t = write("transcribe", program, meta, t0)
    del program

    if args.check:
        from rnnt_tpu_torch.decode.greedy import greedy_decode

        rng = np.random.default_rng(0)
        mel = torch.from_numpy(rng.standard_normal(
            (args.batch, args.frames, cfg.input_feat_size)).astype(
                np.float32)).to(dev)
        lens = torch.full((args.batch,), args.frames, dtype=torch.int32,
                          device=dev)
        artifact = ex.load_artifact(path_t).module()
        call = (mel, lens) if args.freeze else (
            {n: p.detach() for n, p in model.named_parameters()}, mel, lens)
        with torch.no_grad():
            got = artifact(*call)
            ref = greedy_decode(model, mel, lens,
                                max_output_length=args.max_output_length)
        ok = all(torch.equal(g, r) for g, r in zip(got, ref))
        print(f"transcribe round-trip parity: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
