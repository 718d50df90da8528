"""Drop Common Voice TSV rows whose converted WAV is missing (the port of
`rnnt_tpu.cli.remove_missing_samples`; the same six default splits).

  python -m rnnt_tpu_torch.cli.remove_missing_samples --data_dir cv/en
"""

from __future__ import annotations

import argparse

from rnnt_tpu_torch.data import common_voice

DEFAULT_SPLITS = ["dev", "invalidated", "other", "test", "train", "validated"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--splits", nargs="+", default=DEFAULT_SPLITS)
    args = p.parse_args(argv)

    for split in args.splits:
        try:
            removed = common_voice.remove_missing(args.data_dir, split)
            print(f"{split}: removed {removed} rows")
        except FileNotFoundError:
            print(f"{split}: no TSV, skipped")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
