"""Tokenizers: the character table and the subword (BPE) piece vocabulary.

The port's copy of the load, save, encode and decode side of
`rnnt_tpu.data.tokenizer`.  The sidecar formats are the same (`vocab.txt`,
and `encoder.subwords` with one JSON string per line), so the port reads a
tokenizer that the JAX package trained.  Training a BPE vocabulary from a
corpus is not part of the port yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from rnnt_tpu_torch.data import vocabulary

WORD_MARK = "▁"  # sentencepiece-style word-start marker
RESERVED_MARK = "\x00"  # prefix of never-matching filler pieces
SUBWORD_FILENAME = "encoder.subwords"


def normalize_text(text: str) -> str:
    return text.lower().replace('"', "")


class CharTokenizer:
    """Character-level tokenizer over the fixed 31-symbol vocabulary."""

    def __init__(self, vocab: Optional[List[str]] = None):
        self.vocab = vocab or vocabulary.init_vocab()
        self._to_id = {c: i for i, c in enumerate(self.vocab)}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> List[int]:
        # out-of-vocabulary characters are dropped: id 0 is the blank
        ids = (self._to_id.get(c) for c in normalize_text(text))
        return [i for i in ids if i is not None]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.vocab[i] for i in ids if 0 < i < len(self.vocab))

    def save(self, directory: str) -> str:
        path = os.path.join(directory, "vocab.txt")
        vocabulary.save_vocab(self.vocab, path)
        return path

    @classmethod
    def load(cls, directory: str) -> "CharTokenizer":
        return cls(vocabulary.load_vocab(os.path.join(directory, "vocab.txt")))


class SubwordTokenizer:
    """Subword piece vocabulary: id 0 is the reserved blank, then pieces.

    Encoding is greedy longest match per word, with WORD_MARK prefixed to
    each word; pieces starting with RESERVED_MARK never match and decode to
    nothing (they pad a vocabulary up to the joint's width).
    """

    def __init__(self, pieces: List[str]):
        if not pieces or pieces[0] != "":
            raise ValueError("id 0 must be the reserved blank piece ''")
        self.pieces = pieces
        self._to_id: Dict[str, int] = {p: i for i, p in enumerate(pieces) if p}
        self._max_len = max((len(p) for p in pieces if p), default=1)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def _encode_word(self, word: str, out: List[int]) -> None:
        s = WORD_MARK + word
        i = 0
        while i < len(s):
            for j in range(min(len(s), i + self._max_len), i, -1):
                tok = self._to_id.get(s[i:j])
                if tok is not None:
                    out.append(tok)
                    i = j
                    break
            else:
                i += 1  # unencodable character: skip it

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for word in normalize_text(text).split():
            self._encode_word(word, out)
        return out

    def decode(self, ids: Sequence[int]) -> str:
        s = "".join(self.pieces[i] for i in ids
                    if 0 < i < len(self.pieces)
                    and not self.pieces[i].startswith(RESERVED_MARK))
        return s.replace(WORD_MARK, " ").strip()

    def save(self, directory: str, filename: str = SUBWORD_FILENAME) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, filename)
        with open(path, "w") as f:
            for p in self.pieces:
                f.write(json.dumps(p, ensure_ascii=False) + "\n")
        return path

    @classmethod
    def load(cls, directory: str,
             filename: str = SUBWORD_FILENAME) -> "SubwordTokenizer":
        with open(os.path.join(directory, filename)) as f:
            lines = f.read().split("\n")
        if lines and lines[-1] == "":
            lines = lines[:-1]
        try:
            pieces = [json.loads(line) for line in lines]
        except json.JSONDecodeError:
            # legacy (pre-JSON) escape format
            pieces = [line.replace("\\n", "\n").replace("\\\\", "\\")
                      for line in lines]
        return cls(pieces)

    @classmethod
    def exists(cls, directory: str, filename: str = SUBWORD_FILENAME) -> bool:
        return os.path.exists(os.path.join(directory, filename))


def get_tokenizer(directory: str, token_type: str, vocab_size: int):
    """Load the tokenizer that travels with a checkpoint."""
    if token_type == "character":
        return CharTokenizer()
    if token_type == "word-piece":
        if not SubwordTokenizer.exists(directory):
            raise FileNotFoundError(f"no {SUBWORD_FILENAME} in {directory}")
        tok = SubwordTokenizer.load(directory)
        if tok.vocab_size != vocab_size:
            import warnings

            warnings.warn(
                f"tokenizer in {directory} has vocab_size {tok.vocab_size}, "
                f"the config asks for {vocab_size}", stacklevel=2)
        return tok
    raise ValueError(f"unknown token_type {token_type!r}")
