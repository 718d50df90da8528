"""Quantize a trained checkpoint to int8 for compact serving (the port of
`rnnt_tpu.cli.quantize_model`).

  python -m rnnt_tpu_torch.cli.quantize_model --checkpoint runs/ls100 \\
      [-o runs/ls100/model_int8.npz] [--device cuda]

Every matmul weight becomes symmetric per-output-channel int8 with fp32
scales (`ops.quantize`); the artifact has the JAX package's layout, so
either package serves it (`cli.serve --quantized`).  The model is restored
onto --device (the card by default; cpu when asked), and the scales are
computed on the host in numpy, as the JAX package computes them.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("-o", "--output", default=None,
                   help="output .npz (default: <checkpoint>/model_int8.npz)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from rnnt_tpu_torch.device import resolve_device
    from rnnt_tpu_torch.models.encoder import require_lstm_encoder
    from rnnt_tpu_torch.models.transducer import Transducer
    from rnnt_tpu_torch.ops.quantize import (quantize_params,
                                             quantized_size_bytes,
                                             save_quantized)
    from rnnt_tpu_torch.train import checkpoint as ckpt_mod

    dev = resolve_device(args.device)
    cfg = ckpt_mod.load_config(args.checkpoint)
    require_lstm_encoder(cfg, "int8 weights")
    _, state_dict = ckpt_mod.restore_params(args.checkpoint, cfg)
    # the parameters at the training dtype, as the JAX CLI restores them
    model = Transducer(cfg)
    model.load_state_dict(state_dict)
    model.to(dev).cast_(torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                else torch.float32)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    fp_bytes = sum(p.numel() * p.element_size() for p in params.values())
    q = quantize_params(params)
    out = args.output or os.path.join(args.checkpoint, "model_int8.npz")
    save_quantized(out, q)
    q_bytes = quantized_size_bytes(q)
    print(f"params: {n_params / 1e6:.1f}M  "
          f"fp: {fp_bytes / 1e6:.1f} MB -> int8: {q_bytes / 1e6:.1f} MB "
          f"({fp_bytes / q_bytes:.2f}x smaller)  wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
