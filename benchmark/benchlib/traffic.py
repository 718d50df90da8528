"""The one traffic generator: every mix is a data file of parameters.

Training (`train_batches`): `n` distinct batches of B utterances of T
stacked frames and U labels, made on the device from the seed: standard
normal features in the served type, labels uniform in [1, V), the
prediction net's input the blank then the labels, full lengths.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each of a run's random streams."""
    return (int(seed) * 6364136223846793005 + 1442695040888963407
            * (stream + 1)) % (1 << 63)


def train_batches(m: dict, n: int, B: int, T: int, U: int, seed: int,
                  device, dtype=torch.bfloat16) -> List[Dict]:
    """`n` batches on `device` (ids and lengths int64, features `dtype`)."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 2))
    F = m["mel_bins"] * m["downsample_factor"]
    out = []
    for _ in range(n):
        mel = torch.randn((B, T, F), generator=gen, device=device).to(dtype)
        labels = torch.randint(1, m["vocab_size"], (B, U), generator=gen,
                               device=device)
        out.append({
            "mel_specs": mel, "labels": labels,
            "pred_inp": torch.cat([torch.zeros((B, 1), dtype=labels.dtype,
                                               device=device), labels], 1),
            "spec_lengths": torch.full((B,), T, dtype=torch.long,
                                       device=device),
            "label_lengths": torch.full((B,), U, dtype=torch.long,
                                        device=device)})
    return out


def rows(batch: Dict, lo: int, hi: int) -> Dict:
    """Rows [lo, hi) of a batch (a data-parallel rank's share)."""
    return {k: v[lo:hi] for k, v in batch.items()}


def audio_seconds(m: dict, B: int, T: int) -> float:
    """Audio of a batch: B x T stacked frames x frame step x stacking."""
    return B * T * m["frame_step"] * m["downsample_factor"]

