"""The preprocess CLIs' shared half: their common flags, the tokenizer and
config set-up, and one split's featurisation into record shards
(`preprocess_librispeech`, `preprocess_common_voice`)."""

from __future__ import annotations

import argparse
import os


def add_shared_flags(p: argparse.ArgumentParser) -> None:
    """The flags both preprocess CLIs take."""
    p.add_argument("--token_type", default="word-piece",
                   choices=["word-piece", "character"])
    p.add_argument("--vocab_size", type=int, default=4096)
    p.add_argument("--pad_vocab", action="store_true",
                   help="pad the subword vocab with reserved unused ids up "
                        "to --vocab_size (full-width joint softmax even on "
                        "corpora whose BPE saturates early)")
    p.add_argument("--bpe_pieces", type=int, default=0,
                   help="cap the LEARNED BPE vocab at this many pieces "
                        "(0 = --vocab_size); with --pad_vocab the rest is "
                        "reserved padding. Floor: the single-character "
                        "alphabet (+blank) is always kept for encodability")
    p.add_argument("--max_length", type=float, default=17.0,
                   help="drop utterances longer than this many seconds")
    p.add_argument("--num_shards", type=int, default=8)
    p.add_argument("--workers", type=int, default=1,
                   help="reader processes (decode and tokenise scale with "
                        "host cores; the features are made on --device in "
                        "this process; 1 = in-process)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain frontend")


def prepare(args, corpus):
    """Resolve the device, check --data_dir, build or load the tokenizer
    from `corpus` and save config.json: (device, config, tokenizer)."""
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.data.tokenizer import get_tokenizer
    from rnnt_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if not os.path.isdir(args.data_dir):
        raise SystemExit(f"--data_dir {args.data_dir}: no such directory")
    cfg = RNNTConfig(token_type=args.token_type, vocab_size=args.vocab_size)
    os.makedirs(args.output_dir, exist_ok=True)
    tok = get_tokenizer(
        args.output_dir, args.token_type, args.vocab_size,
        pad_to_target=args.pad_vocab, learn_vocab_size=args.bpe_pieces,
        corpus=corpus)
    cfg = cfg.replace(vocab_size=tok.vocab_size)
    cfg.save(args.output_dir)
    return dev, cfg, tok


def write_split(args, cfg, tok, dev, name, *, files, utterances, hint):
    """Featurise one split (through `args.workers` reader processes when
    above 1: `files()` gives its (path, transcript) pairs, else
    `utterances()` its decoded audio) into `name`'s shards."""
    from rnnt_tpu_torch.data import pipeline, records

    if args.workers > 1:
        stream = pipeline.preprocess_corpus_parallel(
            files(), args.output_dir, cfg, workers=args.workers,
            max_length_seconds=args.max_length, device=dev)
    else:
        stream = pipeline.preprocess_corpus(
            utterances(), tok, cfg, max_length_seconds=args.max_length,
            device=dev)
    pattern = os.path.join(args.output_dir,
                           name + "-{shard:05d}-of-{total:05d}.rnr")
    n = 0

    def counted():
        nonlocal n
        for ex in stream:
            n += 1
            yield ex

    paths = records.write_shards(counted(), pattern, args.num_shards)
    print(f"{name}: wrote {n} examples into {len(paths)} shards")
    if n == 0:
        raise SystemExit(f"{name}: no examples produced — {hint}")
