"""Convert Common Voice mp3 clips to 16 kHz mono PCM WAV (the port of
`rnnt_tpu.cli.convert_common_voice`): a parallel ffmpeg fan-out, 16 kHz
mono s16, the mp3s deleted unless --keep_mp3.  mp3 has no decoder in this
stack, so this shells out to ffmpeg, which must be on PATH.

  python -m rnnt_tpu_torch.cli.convert_common_voice --clips_dir cv/clips -j 8

Returns 0 when every clip converted, else 1.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import shutil
import subprocess
import sys


def convert_one(mp3_path: str, sample_rate: int, delete: bool) -> bool:
    wav_path = os.path.splitext(mp3_path)[0] + ".wav"
    cmd = ["ffmpeg", "-hide_banner", "-loglevel", "error", "-y",
           "-i", mp3_path, "-ar", str(sample_rate), "-ac", "1",
           "-sample_fmt", "s16", wav_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        print(f"ffmpeg failed on {mp3_path}: {e.stderr.decode()[:200]}",
              file=sys.stderr)
        return False
    if delete:
        os.unlink(mp3_path)
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--clips_dir", required=True)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("-j", "--jobs", type=int, default=os.cpu_count())
    p.add_argument("--keep_mp3", action="store_true")
    args = p.parse_args(argv)

    if shutil.which("ffmpeg") is None:
        raise SystemExit("ffmpeg not found on PATH — install it or "
                         "pre-convert the corpus elsewhere")
    mp3s = [os.path.join(args.clips_dir, f)
            for f in sorted(os.listdir(args.clips_dir))
            if f.lower().endswith(".mp3")]
    print(f"converting {len(mp3s)} mp3s with {args.jobs} workers")
    ok = 0
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as ex:
        for good in ex.map(
                lambda m: convert_one(m, args.sample_rate, not args.keep_mp3),
                mp3s):
            ok += bool(good)
    print(f"converted {ok}/{len(mp3s)}")
    return 0 if ok == len(mp3s) else 1


if __name__ == "__main__":
    sys.exit(main())
