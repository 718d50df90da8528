"""Edit-distance metrics: the port's own copy of
`rnnt_tpu.metrics.edit_distance` (a Levenshtein DP on the host over decoded
id or string sequences; rates normalised by the longer sequence)."""

from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np

Seq = Union[str, Sequence]


def edit_distance(ref: Seq, hyp: Seq) -> int:
    """Levenshtein distance between two sequences (two-row DP)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1)
    cur = np.empty(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        cur[0] = i
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev, cur = cur, prev
    return int(prev[m])


def error_rate(ref: Seq, hyp: Seq) -> float:
    """Edit distance normalized by max(len(ref), len(hyp)).

    Matches the reference's normalization (utils/metrics.py:11,24 — divide by
    the longer of the two, not the truth length).
    """
    denom = max(len(ref), len(hyp))
    if denom == 0:
        return 0.0
    return edit_distance(ref, hyp) / denom


def accuracy(refs: Iterable[Seq], hyps: Iterable[Seq]) -> float:
    """1 - mean normalized token error (ref: metrics.py:59-73), whole batch."""
    rates = [error_rate(r, h) for r, h in zip(refs, hyps)]
    return 1.0 - float(np.mean(rates)) if rates else 1.0


def cer(refs: Iterable[str], hyps: Iterable[str]) -> float:
    """Character error rate over text pairs."""
    rates = [error_rate(list(r), list(h)) for r, h in zip(refs, hyps)]
    return float(np.mean(rates)) if rates else 0.0


def wer(refs: Iterable[str], hyps: Iterable[str]) -> float:
    """Word error rate via whitespace tokenization (ref: metrics.py:76-92)."""
    rates = [error_rate(r.split(), h.split()) for r, h in zip(refs, hyps)]
    return float(np.mean(rates)) if rates else 0.0
