"""LibriSpeech corpus adapter (the port of `rnnt_tpu.data.librispeech`).

Walks `base/split/speaker/chapter/{speaker}-{chapter}.trans.txt` files and
yields (audio, sample_rate, transcript) triples.  Audio is read through the
port's own `data.audio_io`: a listed `.flac` is decoded by the native FLAC
decoder, and falls back to a `.wav` beside it where the FLAC is missing
(pre-converted corpora).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from rnnt_tpu_torch.data import audio_io


def get_transcript_files(base_path: str, split_names: Sequence[str]) -> List[str]:
    out = []
    for split in split_names:
        split_dir = os.path.join(base_path, split)
        if not os.path.isdir(split_dir):
            continue
        for speaker in sorted(os.listdir(split_dir)):
            sp_dir = os.path.join(split_dir, speaker)
            if not os.path.isdir(sp_dir):
                continue
            for chapter in sorted(os.listdir(sp_dir)):
                ch_dir = os.path.join(sp_dir, chapter)
                if not os.path.isdir(ch_dir):
                    continue
                out.append(os.path.join(ch_dir, f"{speaker}-{chapter}.trans.txt"))
    return out


def _iter_lines(base_path: str, split_names: Sequence[str]
                ) -> Iterator[Tuple[str, str]]:
    """Yield (audio_path, transcript) for every utterance in the splits."""
    for trans_path in get_transcript_files(base_path, split_names):
        ch_dir = os.path.dirname(trans_path)
        with open(trans_path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                utt_id, _, text = line.partition(" ")
                yield os.path.join(ch_dir, utt_id + ".flac"), text


def iter_utterance_files(base_path: str, split_names: Sequence[str]
                         ) -> Iterator[Tuple[str, str]]:
    """Yield (resolved_audio_path, transcript); .flac falls back to .wav
    (pre-converted corpora), missing files are skipped."""
    for audio_path, text in _iter_lines(base_path, split_names):
        if not os.path.exists(audio_path):
            wav = audio_path[:-5] + ".wav"
            if not os.path.exists(wav):
                continue
            audio_path = wav
        yield audio_path, text


def load_dataset(base_path: str, split_names: Sequence[str]
                 ) -> Iterator[Tuple[np.ndarray, int, str]]:
    """Stream (audio float32, sr, transcript)."""
    for audio_path, text in iter_utterance_files(base_path, split_names):
        audio, sr = audio_io.read_audio(audio_path)
        yield audio, sr, text


def texts_generator(base_path: str, split_names: Sequence[str]) -> Iterator[str]:
    """Transcripts only, for tokenizer training."""
    for _, text in _iter_lines(base_path, split_names):
        yield text
