"""Common Voice corpus adapter: the port of `rnnt_tpu.data.common_voice`.

TSV-driven: `{split}.tsv` rows point at clips/ audio; `.mp3` extensions are
rewritten to `.wav`, the corpus being transcoded first
(`rnnt_tpu_torch.cli.convert_common_voice`).
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from rnnt_tpu_torch.data import audio_io


def _rows(base_path: str, split: str) -> Iterator[Tuple[str, str]]:
    """Yield (wav_path, transcript) from {split}.tsv (common_voice.py:7-19)."""
    path = os.path.join(base_path, f"{split}.tsv")
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        next(reader, None)  # header (common_voice.py:28)
        for row in reader:
            if len(row) < 3:
                continue
            audio_fn, text = row[1], row[2]
            stem, _ = os.path.splitext(audio_fn)
            yield os.path.join(base_path, "clips", stem + ".wav"), text


def iter_utterance_files(base_path: str, split: str
                         ) -> Iterator[Tuple[str, str]]:
    """Yield (wav_path, transcript) for rows whose audio exists (the
    parallel preprocessing path ships these to worker processes)."""
    for wav_path, text in _rows(base_path, split):
        if os.path.exists(wav_path):
            yield wav_path, text


def load_dataset(base_path: str, split: str
                 ) -> Iterator[Tuple[np.ndarray, int, str]]:
    for wav_path, text in iter_utterance_files(base_path, split):
        audio, sr = audio_io.read_audio(wav_path)
        yield audio, sr, text


def texts_generator(base_path: str, splits: Optional[List[str]] = None
                    ) -> Iterator[str]:
    """Train-split transcripts for tokenizer training (common_voice.py:35-44)."""
    for split in splits or ["train"]:
        for _, text in _rows(base_path, split):
            yield text


def missing_samples(base_path: str, split: str) -> List[str]:
    """TSV rows whose converted WAV is absent (the remove_missing_samples.py
    capability, scripts/remove_missing_samples.py:5-22)."""
    return [p for p, _ in _rows(base_path, split) if not os.path.exists(p)]


def remove_missing(base_path: str, split: str) -> int:
    """Rewrite {split}.tsv without rows whose WAV is missing; returns #removed."""
    path = os.path.join(base_path, f"{split}.tsv")
    with open(path, newline="") as f:
        lines = f.readlines()
    header, body = lines[:1], lines[1:]
    kept, removed = [], 0
    for line in body:
        row = line.rstrip("\n").split("\t")
        if len(row) >= 3:
            stem, _ = os.path.splitext(row[1])
            wav = os.path.join(base_path, "clips", stem + ".wav")
            if not os.path.exists(wav):
                removed += 1
                continue
        kept.append(line)
    with open(path, "w") as f:
        f.writelines(header + kept)
    return removed
