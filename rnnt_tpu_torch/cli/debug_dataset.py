"""Validate a preprocessed dataset: no NaN/Inf, no empty tensors, sane
lengths (the port of `rnnt_tpu.cli.debug_dataset`; reads either package's
record shards).

  python -m rnnt_tpu_torch.cli.debug_dataset --data_dir data/ls --split train

Prints "All checks passed. (N examples)" and returns 0, or one FAIL line a
problem and returns 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from rnnt_tpu_torch.data import records

REQUIRED = ["mel_specs", "pred_inp", "labels", "spec_lengths", "label_lengths"]


def check_example(i: int, ex) -> list:
    problems = []
    for key in REQUIRED:
        if key not in ex:
            problems.append(f"example {i}: missing field {key}")
            continue
        arr = np.asarray(ex[key])
        if arr.size == 0:
            problems.append(f"example {i}: {key} is empty")
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            problems.append(f"example {i}: {key} has NaN/Inf")
    if not problems:
        t = int(np.asarray(ex["spec_lengths"]).reshape(()))
        u = int(np.asarray(ex["label_lengths"]).reshape(()))
        if ex["mel_specs"].shape[0] != t:
            problems.append(f"example {i}: spec_lengths {t} != mel rows "
                            f"{ex['mel_specs'].shape[0]}")
        if ex["labels"].shape[0] != u:
            problems.append(f"example {i}: label_lengths {u} != labels "
                            f"{ex['labels'].shape[0]}")
        if ex["pred_inp"].shape[0] != u + 1 or int(ex["pred_inp"][0]) != 0:
            problems.append(f"example {i}: pred_inp must be 0-prefixed labels")
        if (np.asarray(ex["labels"]) == 0).any():
            problems.append(f"example {i}: blank id 0 appears in labels")
    return problems


def save_plots(plot_dir: str, examples, tokenizer=None, n: int = 5) -> None:
    """Dump mel-spectrogram PNGs (+ transcript sidecar) of the stored
    features of the first n examples."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(plot_dir, exist_ok=True)
    with open(os.path.join(plot_dir, "trans.txt"), "w") as trans:
        for i, ex in enumerate(examples):
            if i >= n:
                break
            mel = np.asarray(ex["mel_specs"], np.float32)  # [T, mels*stack]
            plt.figure(figsize=(12, 4))
            plt.imshow(mel.T, origin="lower", aspect="auto", cmap="magma")
            plt.xlabel("frame")
            plt.ylabel("stacked log-mel bin")
            plt.colorbar(format="%+.1f")
            ids = np.asarray(ex["labels"]).tolist()
            text = tokenizer.decode(ids) if tokenizer is not None else str(ids)
            plt.title(text[:80])
            path = os.path.join(plot_dir, f"spec_{i}.png")
            plt.savefig(path, bbox_inches="tight")
            plt.close()
            trans.write(f"spec_{i} {text}\n")
            print(f"wrote {path}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--max_problems", type=int, default=20)
    p.add_argument("--save_plots", default=None, metavar="DIR",
                   help="also dump spectrogram PNGs + transcripts for the "
                        "first --n_plots examples")
    p.add_argument("--n_plots", type=int, default=5)
    args = p.parse_args(argv)

    pattern = os.path.join(args.data_dir, f"{args.split}-*.rnr")

    if args.save_plots:
        from rnnt_tpu_torch.config import RNNTConfig
        from rnnt_tpu_torch.data.tokenizer import get_tokenizer

        tok = None
        try:
            cfg = RNNTConfig.load(args.data_dir)
            tok = get_tokenizer(args.data_dir, cfg.token_type, cfg.vocab_size)
        except (FileNotFoundError, OSError):
            pass  # plots still useful without decoded transcripts
        save_plots(args.save_plots, records.read_shards(pattern), tok,
                   args.n_plots)

    n = 0
    problems = []
    for i, ex in enumerate(records.read_shards(pattern)):
        n += 1
        problems.extend(check_example(i, ex))
        if len(problems) >= args.max_problems:
            break
    for msg in problems[: args.max_problems]:
        print("FAIL:", msg)
    if problems:
        return 1
    print(f"All checks passed. ({n} examples)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
