"""Audio duration statistics of a corpus (the port of
`rnnt_tpu.cli.corpus_stats`): Common Voice clips directories (WAV) and
LibriSpeech split trees (FLAC).

  python -m rnnt_tpu_torch.cli.corpus_stats --dir cv/clips
  python -m rnnt_tpu_torch.cli.corpus_stats --dir LibriSpeech/dev-clean
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from rnnt_tpu_torch.data import audio_io


def audio_files(root: str):
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith((".wav", ".flac")):
                yield os.path.join(dirpath, f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True)
    p.add_argument("--limit", type=int, default=0,
                   help="stop after N files (0 = all)")
    args = p.parse_args(argv)

    durations = []
    for i, path in enumerate(audio_files(args.dir)):
        if args.limit and i >= args.limit:
            break
        try:
            audio, sr = audio_io.read_audio(path)
        except Exception as e:
            print(f"unreadable: {path} ({e})")
            continue
        durations.append(len(audio) / sr)

    if not durations:
        raise SystemExit(f"no audio files under {args.dir}")
    d = np.asarray(durations)
    print(f"files: {len(d)}")
    print(f"total: {d.sum() / 3600:.2f} h")
    print(f"min:   {d.min():.2f} s")
    print(f"max:   {d.max():.2f} s")
    print(f"mean:  {d.mean():.2f} s")
    print(f"p50/p95: {np.percentile(d, 50):.2f} / {np.percentile(d, 95):.2f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
