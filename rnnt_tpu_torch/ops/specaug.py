"""SpecAugment: frequency and time masking of stacked log-mel features, the
port of `rnnt_tpu.ops.specaug`.

The features are in the stacked layout [B, T, mel_bins * stack]: a
frequency mask removes the same mel bin from every stacked copy, and a time
mask removes whole stacked frames inside each utterance's real length
(padding is never masked).  Masked cells are set to 0 in the features'
dtype: the features are mean-subtracted per bin, so 0 is the mean.

Drawing and building are split.  `draw_intervals` takes each mask's width
w ~ U{0..max_width} and a uniform u in [0, 1) from a `torch.Generator`;
`interval_mask` builds the masks from (w, u), as `_interval_mask` does
from its `jax.random` draws: w = min(w, bound) and
start = floor(u * (bound - w + 1)) in float32, bound being the utterance's
real length for time masks and mel_bins for frequency masks.  So a test
can feed JAX's draws to the builder and compare masks bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Intervals(NamedTuple):
    """Draws of n_masks intervals per example: widths w [B, n] (integer)
    and uniforms u [B, n] (float32 in [0, 1))."""
    w: torch.Tensor
    u: torch.Tensor


def draw_intervals(generator: torch.Generator, batch: int, n_masks: int,
                   max_width: int, device) -> Intervals:
    """Widths uniform in 0..max_width inclusive, then the uniforms, both on
    `device` from `generator` (which must live there)."""
    w = torch.randint(0, max_width + 1, (batch, n_masks), generator=generator,
                      device=device, dtype=torch.int32)
    u = torch.rand((batch, n_masks), generator=generator, device=device,
                   dtype=torch.float32)
    return Intervals(w, u)


def interval_mask(draws: Intervals, n_pos: int,
                  limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, n_pos] bool: True where any drawn interval covers the position.
    Each interval's bound is limit[b] (e.g. the real length) or n_pos."""
    w = draws.w.to(torch.int32)
    u = draws.u.to(torch.float32)
    B = w.shape[0]
    bound = (torch.full((B, 1), n_pos, dtype=torch.int32, device=w.device)
             if limit is None else limit.to(torch.int32).reshape(B, 1))
    w = torch.minimum(w, bound)
    # start in [0, bound - w] inclusive; the product in float32, as JAX's
    start = torch.floor(u * (bound - w + 1).to(torch.float32)).to(torch.int32)
    pos = torch.arange(n_pos, device=w.device).reshape(1, 1, n_pos)
    covered = (pos >= start[..., None]) & (pos < (start + w)[..., None])
    return covered.any(dim=1)


def apply_masks(mel: torch.Tensor, spec_lengths: torch.Tensor, *,
                mel_bins: int, freq: Optional[Intervals] = None,
                time: Optional[Intervals] = None) -> torch.Tensor:
    """mel [B, T, mel_bins * stack] with the drawn frequency intervals
    (over the mel bins, tiled across the stack) and time intervals (inside
    spec_lengths) set to zero."""
    B, T, FS = mel.shape
    stack = FS // mel_bins
    keep = torch.ones((B, T, FS), dtype=torch.bool, device=mel.device)
    if freq is not None:
        fmask = interval_mask(freq, mel_bins)
        keep &= ~fmask.repeat(1, stack)[:, None, :]
    if time is not None:
        tmask = interval_mask(time, T, limit=spec_lengths)
        keep &= ~tmask[:, :, None]
    return torch.where(keep, mel, torch.zeros((), dtype=mel.dtype,
                                              device=mel.device))


def spec_augment(generator: torch.Generator, mel: torch.Tensor,
                 spec_lengths: torch.Tensor, *, mel_bins: int,
                 freq_masks: int, freq_width: int, time_masks: int,
                 time_width: int) -> torch.Tensor:
    """Draw the frequency masks, then the time masks, from `generator` on
    mel's device, and apply them (a kind of mask with no masks or width 0
    draws nothing)."""
    B = mel.shape[0]
    freq = time = None
    if freq_masks > 0 and freq_width > 0:
        freq = draw_intervals(generator, B, freq_masks, freq_width,
                              mel.device)
    if time_masks > 0 and time_width > 0:
        time = draw_intervals(generator, B, time_masks, time_width,
                              mel.device)
    return apply_masks(mel, spec_lengths, mel_bins=mel_bins, freq=freq,
                       time=time)
