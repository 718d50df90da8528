"""Tokenizers: the character table and the subword (BPE) piece vocabulary.

The port's copy of `rnnt_tpu.data.tokenizer`: load, save, encode, decode
and the BPE builder.  The sidecar formats are the same (`vocab.txt`, and
`encoder.subwords` with one JSON string per line), and the builder keeps
every tie-break of the JAX one, so both packages learn byte-identical
`encoder.subwords` from the same corpus and flags.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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

    @property
    def learned_piece_count(self) -> int:
        """Number of LEARNED (merge-produced) pieces.  The alphabet fallback
        is strictly single-character pieces (including the standalone word
        mark), so any non-reserved piece spanning >1 character is a merge,
        WORD_MARK+char pieces included."""
        return sum(1 for p in self.pieces[1:]
                   if len(p) > 1 and not p.startswith(RESERVED_MARK))

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

    # --- training: the BPE builder ---
    #
    # Merge selection is deterministic: highest pair count, ties broken by
    # lexicographically smallest pair.  Both trainers below implement exactly
    # this rule; tests pin them byte-identical.

    @staticmethod
    def _collect_words(corpus: Iterable[str]) -> collections.Counter:
        word_counts: collections.Counter = collections.Counter()
        for line in corpus:
            for w in normalize_text(line).split():
                word_counts[WORD_MARK + w] += 1
        return word_counts

    @staticmethod
    def _learn_target(target_vocab_size: int,
                      learn_vocab_size: Optional[int]) -> int:
        """Effective vocab size the MERGE LEARNING aims for: `learn_vocab_size`
        caps the learned (non-reserved) pieces below the padded width, so the
        piece granularity (letters/syllables vs whole words) is chosen
        independently of the joint-softmax width — e.g. 64 learned pieces
        padded to a V=4096 parity joint."""
        if learn_vocab_size is None or learn_vocab_size <= 0:
            return target_vocab_size
        return min(learn_vocab_size, target_vocab_size)

    @staticmethod
    def _finish_pieces(merges: List[str], alphabet: List[str],
                       target_vocab_size: int, pad_to_target: bool,
                       learn_vocab_size: Optional[int] = None) -> List[str]:
        # Order: blank, merges (by creation = frequency order), then the
        # single-character alphabet.  Truncation drops MERGES, never the
        # alphabet — the any-input-is-encodable invariant must survive small
        # --vocab_size on large alphabets.
        learn = SubwordTokenizer._learn_target(target_vocab_size,
                                               learn_vocab_size)
        keep_merges = max(0, learn - 1 - len(alphabet))
        pieces = [""] + merges[:keep_merges] + alphabet
        if pad_to_target and len(pieces) < target_vocab_size:
            # Reserved never-matching ids so vocab_size hits the requested
            # target even on small corpora (a V=4096 joint at parity scale
            # from a corpus whose BPE saturates earlier).  "\x00" cannot
            # occur in normalized text, so greedy longest-match never
            # produces these and decode() drops them.
            pieces += [f"\x00unused{i}"
                       for i in range(target_vocab_size - len(pieces))]
        return pieces

    @classmethod
    def build_from_corpus(
        cls,
        corpus: Iterable[str],
        target_vocab_size: int,
        max_subword_length: int = 20,
        pad_to_target: bool = False,
        learn_vocab_size: Optional[int] = None,
    ) -> "SubwordTokenizer":
        """Learn BPE merges from a text generator until the vocab is full.

        learn_vocab_size (optional) caps the LEARNED vocab below
        target_vocab_size (the rest is reserved padding when pad_to_target):
        coarse joints, fine pieces — see _learn_target.

        Incremental trainer: pair->count and pair->word-occurrence indices are
        maintained per merge (a lazy max-heap selects the next merge), so cost
        is O(corpus scan + merges x words-touched-per-merge) instead of the
        O(merges x unique-words) full rescan per merge (tfds SubwordTextEncoder
        territory, encoding.py:77-85) — a 4096-piece vocab over a 100k-word
        vocabulary builds in seconds, not hours.
        """
        import heapq

        word_counts = cls._collect_words(corpus)
        # Base alphabet: every character observed (guarantees encodability).
        alphabet = sorted({c for w in word_counts for c in w})
        words: List[List[str]] = [list(w) for w in word_counts]
        counts: List[int] = list(word_counts.values())

        def countable(p: Tuple[str, str]) -> bool:
            return len(p[0]) + len(p[1]) <= max_subword_length

        pair_counts: Dict[Tuple[str, str], int] = {}
        pair_words: Dict[Tuple[str, str], set] = {}
        for wi, sym in enumerate(words):
            c = counts[wi]
            for p in zip(sym, sym[1:]):
                if countable(p):
                    pair_counts[p] = pair_counts.get(p, 0) + c
                    pair_words.setdefault(p, set()).add(wi)

        # Lazy-deletion max-heap: every CURRENT count has a live entry (one is
        # pushed on every count change); stale entries are skipped on pop.
        heap = [(-c, p) for p, c in pair_counts.items()]
        heapq.heapify(heap)

        merges: List[str] = []
        learn = cls._learn_target(target_vocab_size, learn_vocab_size)
        budget = learn - 1 - len(alphabet)  # -1 for blank
        while len(merges) < budget and heap:
            negc, best = heapq.heappop(heap)
            cur = pair_counts.get(best, 0)
            if cur != -negc:
                continue  # stale
            if cur < 2:
                break
            a, b = best
            new_sym = a + b
            merges.append(new_sym)
            for wi in list(pair_words.get(best, ())):
                sym, c = words[wi], counts[wi]
                out: List[str] = []
                i = 0
                while i < len(sym):
                    if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                        out.append(new_sym)
                        i += 2
                    else:
                        out.append(sym[i])
                        i += 1
                old_pairs = list(zip(sym, sym[1:]))
                new_pairs = list(zip(out, out[1:]))
                words[wi] = out
                # count deltas (overlap-exact: multiset difference of the
                # word's adjacent pairs before/after, scaled by word count)
                delta: Dict[Tuple[str, str], int] = {}
                for p in old_pairs:
                    if countable(p):
                        delta[p] = delta.get(p, 0) - c
                for p in new_pairs:
                    if countable(p):
                        delta[p] = delta.get(p, 0) + c
                for p, d in delta.items():
                    if d == 0:
                        continue
                    nc = pair_counts.get(p, 0) + d
                    if nc <= 0:
                        pair_counts.pop(p, None)
                    else:
                        pair_counts[p] = nc
                        heapq.heappush(heap, (-nc, p))
                # occurrence-index deltas
                old_set = {p for p in old_pairs if countable(p)}
                new_set = {p for p in new_pairs if countable(p)}
                for p in old_set - new_set:
                    s = pair_words.get(p)
                    if s is not None:
                        s.discard(wi)
                for p in new_set - old_set:
                    pair_words.setdefault(p, set()).add(wi)
            pair_counts.pop(best, None)
            pair_words.pop(best, None)

        return cls(cls._finish_pieces(merges, alphabet, target_vocab_size,
                                      pad_to_target, learn_vocab_size))

    @classmethod
    def _build_from_corpus_rescan(
        cls,
        corpus: Iterable[str],
        target_vocab_size: int,
        max_subword_length: int = 20,
        pad_to_target: bool = False,
        learn_vocab_size: Optional[int] = None,
    ) -> "SubwordTokenizer":
        """Reference trainer: full pair-count rescan per merge.  O(merges x
        unique-words) — kept as the correctness oracle for the incremental
        trainer (tests pin byte-identical pieces)."""
        word_counts = cls._collect_words(corpus)
        alphabet = sorted({c for w in word_counts for c in w})
        words: Dict[Tuple[str, ...], int] = {
            tuple(w): c for w, c in word_counts.items()
        }

        merges: List[str] = []
        learn = cls._learn_target(target_vocab_size, learn_vocab_size)
        budget = learn - 1 - len(alphabet)  # -1 for blank
        while budget > len(merges):
            pair_counts: collections.Counter = collections.Counter()
            for sym, cnt in words.items():
                for a, b in zip(sym, sym[1:]):
                    if len(a) + len(b) <= max_subword_length:
                        pair_counts[(a, b)] += cnt
            if not pair_counts:
                break
            (a, b), cnt = min(pair_counts.items(),
                              key=lambda kv: (-kv[1], kv[0]))
            if cnt < 2:
                break
            new_sym = a + b
            merges.append(new_sym)
            merged: Dict[Tuple[str, ...], int] = {}
            for sym, c in words.items():
                out = []
                i = 0
                while i < len(sym):
                    if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                        out.append(new_sym)
                        i += 2
                    else:
                        out.append(sym[i])
                        i += 1
                merged[tuple(out)] = merged.get(tuple(out), 0) + c
            words = merged

        return cls(cls._finish_pieces(merges, alphabet, target_vocab_size,
                                      pad_to_target, learn_vocab_size))


def get_tokenizer(
    directory: str,
    token_type: str,
    vocab_size: int,
    corpus: Optional[Iterable[str]] = None,
    pad_to_target: bool = False,
    learn_vocab_size: Optional[int] = None,
):
    """Build or load: the tokenizer persisted in `directory` if there is
    one, else one trained from `corpus` and persisted there."""
    if token_type == "character":
        return CharTokenizer()
    if token_type == "word-piece":
        if SubwordTokenizer.exists(directory):
            tok = SubwordTokenizer.load(directory)
            # A persisted tokenizer always wins (shard ids were written with
            # it), but requested settings that disagree are reported: a new
            # --vocab_size or --bpe_pieces into an existing output directory
            # does not retrain.  Delete the sidecar to rebuild.
            import warnings

            if tok.vocab_size != vocab_size:
                warnings.warn(
                    f"persisted tokenizer in {directory} has vocab_size "
                    f"{tok.vocab_size}, but {vocab_size} was requested; "
                    f"keeping the persisted one — delete {SUBWORD_FILENAME} "
                    f"there to retrain", stacklevel=2)
            elif (learn_vocab_size and learn_vocab_size > 0
                  and tok.learned_piece_count > learn_vocab_size):
                warnings.warn(
                    f"persisted tokenizer in {directory} has "
                    f"{tok.learned_piece_count} learned pieces, above the "
                    f"requested --bpe_pieces cap {learn_vocab_size}; keeping "
                    f"the persisted one — delete {SUBWORD_FILENAME} there to "
                    f"retrain", stacklevel=2)
            return tok
        if corpus is None:
            raise FileNotFoundError(
                f"no {SUBWORD_FILENAME} in {directory} and no corpus given")
        tok = SubwordTokenizer.build_from_corpus(
            corpus, vocab_size, pad_to_target=pad_to_target,
            learn_vocab_size=learn_vocab_size)
        tok.save(directory)
        return tok
    raise ValueError(f"unknown token_type {token_type!r}")
