"""Preprocess Common Voice into record shards (the port of
`rnnt_tpu.cli.preprocess_common_voice`).

  python -m rnnt_tpu_torch.cli.preprocess_common_voice \\
      --data_dir cv/en --output_dir data/cv

The tokenizer learns from the train split; each of --splits is featurised
on the card (the frontend kernel, mean subtraction, stacking) and written as
`{split}-NNNNN-of-NNNNN.rnr` shards beside `config.json` and the tokenizer.
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
    p.add_argument("--splits", nargs="+", default=["train", "dev", "test"])
    common.add_shared_flags(p)
    args = p.parse_args(argv)

    from rnnt_tpu_torch.data import common_voice

    dev, cfg, tok = common.prepare(
        args, common_voice.texts_generator(args.data_dir))
    for split in args.splits:
        common.write_split(
            args, cfg, tok, dev, split,
            files=lambda: common_voice.iter_utterance_files(args.data_dir,
                                                            split),
            utterances=lambda: common_voice.load_dataset(args.data_dir, split),
            hint=f"check --data_dir ({args.data_dir})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
