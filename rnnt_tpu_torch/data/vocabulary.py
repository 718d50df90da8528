"""Character vocabulary: 31 symbols, blank '' at id 0 (the transducer blank).

The port's copy of `rnnt_tpu.data.vocabulary`; the on-disk `vocab.txt`
format is the same.
"""

from __future__ import annotations

from typing import List

BLANK = ""
SPACE = " "


def init_vocab() -> List[str]:
    alphabet = "abcdefghijklmnopqrstuvwxyz'"
    return [BLANK, SPACE, "<s>", "</s>"] + list(alphabet)


def save_vocab(vocab: List[str], filepath: str) -> None:
    """Blank and space are written as the sentinels <blank> and <space>."""
    with open(filepath, "w") as f:
        for c in vocab:
            if c == BLANK:
                c = "<blank>"
            elif c == SPACE:
                c = "<space>"
            f.write(f"{c}\n")


def load_vocab(filepath: str) -> List[str]:
    vocab = []
    with open(filepath) as f:
        for line in f:
            line = line.rstrip("\n").strip()
            if line == "<blank>":
                line = BLANK
            elif line == "<space>":
                line = SPACE
            vocab.append(line)
    return vocab
