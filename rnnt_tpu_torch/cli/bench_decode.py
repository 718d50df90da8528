"""Decode throughput benchmark on the card: greedy and beam search at the
parity config (the port of `rnnt_tpu.cli.bench_decode`).

    python -m rnnt_tpu_torch.cli.bench_decode [--batch 64] [--frames 128] \\
        [--reps 5] [--device cuda]

Reports ms/batch and audio-s/s, from random encoder outputs, for:
  greedy            decode/greedy.greedy_decode_encoded (kernel K2 steps)
  beam-K cuda E=1   ops/beam_cuda.beam_search, the whole search in kernel K3
  beam-K cuda E=6   the same with 6 label expansions a frame
  beam-K plain E=1  decode/beam.beam_search_encoded_plain, the same search
                    in plain PyTorch ops (the comparison; never served)

With --int8, also (the JAX CLI's int8 rows) on the same model quantized by
`ops.quantize`, after a line of the prediction net's and joint's weight
bytes under int8 execution and dequantized:
  greedy int8-exec          greedy with int8 prediction net and joint
                            (`ops.int8_exec.qdot`, torch._int_mm on the card)
  greedy dequant            greedy on the dequantized weights (K2 steps)
  beam-K xla int8-exec      decode/beam.beam_search_encoded_xla, E=1, the
                            int8 search (the JAX package's XLA beam)
  beam-K cuda dequant E=1   kernel K3 on the dequantized weights

On the CPU (--device cpu) the kernel rows run their wrappers' plain
versions.
"""

from __future__ import annotations

import argparse
import sys
import time


def _time(fn, reps: int, sync) -> float:
    """Seconds per call of fn() over `reps` calls after one warm-up call."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def setup(batch: int, frames: int, bf16: bool, device):
    """(cfg, model, encoder outputs [B, T, P], lengths) of the benchmark:
    the parity model from seed 0 in bf16 or fp32, its blank output bias
    lowered by 2.0 so that the searches emit, and encoder outputs drawn
    as standard normal x 2 from a generator seeded with 1."""
    import torch

    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.models.transducer import Transducer

    cfg = RNNTConfig(compute_dtype="bfloat16" if bf16 else "float32")
    dt = torch.bfloat16 if bf16 else torch.float32
    model = Transducer(cfg).init_(0).cast_(dt).to(device).eval()
    with torch.no_grad():
        model.joint.b2[0] -= 2.0
    gen = torch.Generator().manual_seed(1)
    enc = (torch.randn((batch, frames, cfg.projection_size), generator=gen)
           * 2).to(device=device, dtype=dt)
    lens = torch.full((batch,), frames, dtype=torch.int32, device=device)
    return cfg, model, enc, lens


def int8_models(model):
    """(int8-exec model, dequantized model): copies of `model` with the
    weights of its int8 quantization (`ops.quantize`), the prediction net's
    and joint's kept int8 in the first, all dequantized in the second."""
    import copy

    from rnnt_tpu_torch.ops.quantize import apply_quantized_, quantize_params

    q = quantize_params(model.state_dict())
    return (apply_quantized_(copy.deepcopy(model), q, int8_exec=True),
            apply_quantized_(copy.deepcopy(model), q))


def weight_bytes(model) -> int:
    """Bytes of the prediction net's and the joint's weights as stored (their
    state_dict: an int8 weight's q and s, not the padded copy of q that the
    card's product reads, `QuantWeight.q_mm`)."""
    return sum(t.numel() * t.element_size()
               for sub in (model.prediction, model.joint)
               for t in sub.state_dict().values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--frames", type=int, default=128,
                   help="encoder-output frames per utterance")
    p.add_argument("--beam", type=int, default=4)
    p.add_argument("--max_output_length", type=int, default=200)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--int8", action="store_true",
                   help="also time greedy and beam on the int8-quantized "
                        "model: int8 execution against the dequantized "
                        "weights")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)

    import torch

    from rnnt_tpu_torch.decode.beam import (beam_search_encoded_plain,
                                            beam_search_encoded_xla)
    from rnnt_tpu_torch.decode.greedy import greedy_decode_encoded
    from rnnt_tpu_torch.device import resolve_device
    from rnnt_tpu_torch.ops.beam_cuda import beam_search

    dev = resolve_device(args.device)
    cfg, model, enc, lens = setup(args.batch, args.frames, args.bf16, dev)
    dt = enc.dtype
    B, T = args.batch, args.frames
    # audio seconds represented by one batch: each encoder frame covers
    # frame_step * downsample * time_reduction seconds of audio
    sec_per_frame = (cfg.frame_step * cfg.downsample_factor
                     * cfg.time_reduction_factor)
    audio_s = B * T * sec_per_frame
    K, L = args.beam, args.max_output_length

    def search(fn, E):
        return lambda: fn(model, enc, lens, beam_width=K, max_output_length=L,
                          expansions_per_frame=E)

    runs = {
        "greedy": lambda: greedy_decode_encoded(model, enc, lens,
                                                max_output_length=L),
        f"beam-{K} cuda E=1": search(beam_search, 1),
        f"beam-{K} cuda E=6": search(beam_search, 6),
        f"beam-{K} plain E=1": search(beam_search_encoded_plain, 1),
    }

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if args.int8:
        mixed, deq = int8_models(model)
        print(f"int8 exec: pred+joint weights {weight_bytes(mixed):,} B vs "
              f"dequant {weight_bytes(deq):,} B", flush=True)

        def search_on(m, fn, E):
            return lambda: fn(m, enc, lens, beam_width=K, max_output_length=L,
                              expansions_per_frame=E)

        runs["greedy int8-exec"] = lambda: greedy_decode_encoded(
            mixed, enc, lens, max_output_length=L)
        runs["greedy dequant"] = lambda: greedy_decode_encoded(
            deq, enc, lens, max_output_length=L)
        runs[f"beam-{K} xla int8-exec"] = search_on(
            mixed, beam_search_encoded_xla, 1)
        runs[f"beam-{K} cuda dequant E=1"] = search_on(deq, beam_search, 1)

    print(f"B={B} T'={T} vocab={cfg.vocab_size} "
          f"dtype={str(dt).removeprefix('torch.')} ({audio_s:.0f} "
          f"audio-s/batch) on {dev.type}", flush=True)
    with torch.no_grad():
        for name, fn in runs.items():
            dt_s = _time(fn, args.reps, sync)
            print(f"{name:20s} {dt_s * 1e3:8.2f} ms/batch   "
                  f"{audio_s / dt_s:10.0f} audio-s/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
