"""Preprocess LibriSpeech into record shards (the port of
`rnnt_tpu.cli.preprocess_librispeech`).

Builds or loads the tokenizer from the train splits' transcripts, featurises
each split on the card (the frontend kernel, mean subtraction, stacking),
tokenises the transcripts and writes `{split}-NNNNN-of-NNNNN.rnr` shards,
`config.json` and the tokenizer beside them, in the JAX package's layout.

  python -m rnnt_tpu_torch.cli.preprocess_librispeech \\
      --data_dir LibriSpeech --output_dir data/ls \\
      --train_splits train-clean-100 --dev_splits dev-clean \\
      --test_splits test-clean

The flags are the JAX CLI's, plus --device (cuda by default; cpu runs the
plain frontend).
"""

from __future__ import annotations

import argparse

from rnnt_tpu_torch.cli import preprocess as common


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--train_splits", nargs="+", default=["train-clean-100"])
    p.add_argument("--dev_splits", nargs="+", default=["dev-clean"])
    p.add_argument("--test_splits", nargs="+", default=["test-clean"])
    common.add_shared_flags(p)
    args = p.parse_args(argv)

    from rnnt_tpu_torch.data import librispeech

    dev, cfg, tok = common.prepare(
        args, librispeech.texts_generator(args.data_dir, args.train_splits))
    for name, splits in [("train", args.train_splits),
                         ("dev", args.dev_splits),
                         ("test", args.test_splits)]:
        common.write_split(
            args, cfg, tok, dev, name,
            files=lambda: librispeech.iter_utterance_files(args.data_dir,
                                                           splits),
            utterances=lambda: librispeech.load_dataset(args.data_dir, splits),
            hint=f"check --data_dir/splits ({args.data_dir} {splits})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
