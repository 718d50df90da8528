"""Benchmark: training throughput of the flagship RNN-T on one card (the
port of the repository's `bench.py`).

  python -m rnnt_tpu_torch.bench [--device cuda]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"baseline", "device"}.

Metric: audio-seconds of speech trained per second of wall clock per card
(forward, fused RNN-T loss, backward and SGD update) at the parity
configuration (8x LSTM-2048/640 encoder, 2x LSTM-2048 prediction net, joint
640, vocab 4096), bf16, B=96 utterances of T=256 stacked frames and U=64
labels, as `bench.py`.  `vs_baseline` is against the same ~60 audio-s/s
V100 estimate (BASELINE.md).  `device` is the card's name and power limit
as nvidia-smi prints them.  The step time and the peak device memory go to
stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

V100_BASELINE_AUDIO_S_PER_S = 60.0
B, T, U, N_STEPS = 96, 256, 64, 10


def make_batch(cfg, B: int, T: int, U: int, seed: int = 0) -> dict:
    """The batch as numpy arrays, drawn from `default_rng(seed)` (0, as
    `bench.py`) in `bench.py`'s order: bf16 standard-normal mel features (rounded through fp32, as JAX
    casts them, and held as fp32), pred_inp = a zero column then integers in
    [1, V), labels, full lengths."""
    rng = np.random.default_rng(seed)
    mel = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.input_feat_size)).astype(np.float32)).to(torch.bfloat16)
    pred_inp = np.concatenate(
        [np.zeros((B, 1)), rng.integers(1, cfg.vocab_size, (B, U))], 1)
    return {"mel_specs": mel.float().numpy(),
            "pred_inp": pred_inp.astype(np.int32),
            "labels": rng.integers(1, cfg.vocab_size, (B, U)).astype(np.int32),
            "spec_lengths": np.full((B,), T, np.int32),
            "label_lengths": np.full((B,), U, np.int32)}


def setup(device="cuda", *, cfg=None, B: int = B, T: int = T, U: int = U,
          seed: int = 0):
    """(state, batch on the device, train step, generator) of the bench:
    `create_train_state(cfg, bf16, device, seed)`, the batch of
    `make_batch(..., seed)`, the fused-loss step and a generator seeded
    with seed + 1.  The bench itself runs seed 0, as `bench.py`."""
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.train.loop import to_device
    from rnnt_tpu_torch.train.state import create_train_state
    from rnnt_tpu_torch.train.steps import make_train_step

    cfg = cfg or RNNTConfig(compute_dtype="bfloat16")
    state = create_train_state(cfg, torch.bfloat16, device, seed=seed)
    batch = to_device(make_batch(cfg, B, T, U, seed),
                      state.model.joint.w1.device, torch.bfloat16)
    gen = torch.Generator(device=batch["mel_specs"].device).manual_seed(
        seed + 1)
    return state, batch, make_train_step(cfg, loss_impl="fused"), gen


def measure(device="cuda", *, cfg=None, B: int = B, T: int = T, U: int = U,
            n_steps: int = N_STEPS) -> dict:
    """One warm-up step (its loss must be finite), then `n_steps` steps on
    the host clock, synchronised once and the loss read at the end.
    Returns the JSON record; logs the step time and peak device memory on
    stderr."""
    from rnnt_tpu_torch.cli.benchutil import nvidia_smi_line

    state, batch, step, gen = setup(device, cfg=cfg, B=B, T=T, U=U)
    cfg = state.model.cfg
    dev = batch["mel_specs"].device
    on_card = dev.type == "cuda"
    seconds_per_frame = cfg.frame_step * cfg.downsample_factor
    audio_seconds_per_batch = B * T * seconds_per_frame

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    loss = float(step(state, batch, gen)["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"warm-up step loss {loss} is not finite")
    if on_card:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        m = step(state, batch, gen)
    if on_card:
        torch.cuda.synchronize(dev)
    loss = float(m["loss"])
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise RuntimeError(f"timed steps' last loss {loss} is not finite")

    value = audio_seconds_per_batch * n_steps / dt
    peak = (f"{torch.cuda.max_memory_allocated(dev)} B" if on_card
            else "not measured on the CPU")
    print(f"bench: B={B} T={T} U={U} bf16 fused, {n_steps} steps, step "
          f"{dt / n_steps * 1e3:.2f} ms, last loss {loss:.4f}, peak device "
          f"memory {peak}", file=sys.stderr, flush=True)
    return {
        "metric": "train_audio_seconds_per_second_per_chip",
        "value": round(value, 2),
        "unit": "audio-s/s/chip",
        "vs_baseline": round(value / V100_BASELINE_AUDIO_S_PER_S, 3),
        "baseline": "V100 engineering estimate (~60 audio-s/s, reference "
                    "publishes no numbers; see BASELINE.md)",
        "device": nvidia_smi_line() if on_card else "cpu",
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)
    print(json.dumps(measure(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
