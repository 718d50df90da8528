"""Transcribe audio files with a trained checkpoint, on the card (PyTorch/CUDA
port of `rnnt_tpu.cli.transcribe_file`).

Many files decode as one padded batch, greedy or with a K-beam search:

  python -m rnnt_tpu_torch.cli.transcribe_file --checkpoint runs/ls100 \\
      -i a.wav b.wav [--beam 4] [--device cuda]

One file prints its bare transcript; several print `path<TAB>text` lines.
WAV and FLAC input (FLAC through the native decoder, `data.audio_io`).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir with config.json + tokenizer")
    p.add_argument("-i", "--input", required=True, nargs="+",
                   help="WAV or FLAC file(s); several files decode as one padded "
                        "batch")
    p.add_argument("--beam", type=int, default=0,
                   help="beam width; 0 = greedy")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)

    import torch

    from rnnt_tpu_torch.data.audio_io import read_audio
    from rnnt_tpu_torch.decode.beam import beam_search_decode
    from rnnt_tpu_torch.decode.greedy import greedy_decode
    from rnnt_tpu_torch.ops.features import preprocess_audio
    from rnnt_tpu_torch.serve import TranscriptionService

    service = TranscriptionService(args.checkpoint, device=args.device)
    cfg, model, dev = service.cfg, service.model, service.device
    mels = []
    with torch.no_grad():
        for path in args.input:
            audio, sr = read_audio(path)
            if sr != cfg.sample_rate:
                raise SystemExit(f"{path}: expected {cfg.sample_rate} Hz "
                                 f"audio, got {sr}")
            mels.append(preprocess_audio(torch.from_numpy(audio).to(dev),
                                         cfg))
        # pad T to a power-of-two bucket (floor 16), as the JAX CLI does;
        # the true lengths ride alongside
        lengths = [m.shape[0] for m in mels]
        t_pad = max(16, 1 << (max(lengths) - 1).bit_length())
        mel = torch.zeros((len(mels), t_pad, cfg.input_feat_size),
                          device=dev)
        for i, m in enumerate(mels):
            mel[i, : m.shape[0]] = m
        spec_lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
        if args.beam > 0:
            tokens, out_lens, _ = beam_search_decode(
                model, mel, spec_lengths, beam_width=args.beam)
        else:
            tokens, out_lens = greedy_decode(model, mel, spec_lengths)
    tokens, out_lens = tokens.cpu().numpy(), out_lens.cpu().numpy()
    for i, path in enumerate(args.input):
        text = service.tokenizer.decode(
            tokens[i, : int(out_lens[i])].tolist())
        print(text if len(args.input) == 1 else f"{path}\t{text}")


if __name__ == "__main__":
    main()
