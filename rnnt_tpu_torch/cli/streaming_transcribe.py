"""Streaming transcription on the card (PyTorch/CUDA port of
`rnnt_tpu.cli.streaming_transcribe`).

Live microphone mode through pyaudio where it imports, and a
--simulate_file mode that drives the same chunked path from a WAV file:

  python -m rnnt_tpu_torch.cli.streaming_transcribe --checkpoint runs/ls100 \\
      --simulate_file audio.wav [--chunk_samples 1024] [--device cuda]

The transcript is printed whenever it changes, then `FINAL: <text>`.
"""

from __future__ import annotations

import argparse
import sys
import time

CHUNK_SAMPLES = 1024


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--simulate_file", default=None,
                   help="stream this WAV file instead of the microphone")
    p.add_argument("--chunk_samples", type=int, default=CHUNK_SAMPLES)
    p.add_argument("--realtime", action="store_true",
                   help="pace simulated chunks at real time")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain PyTorch path")
    args = p.parse_args(argv)

    from rnnt_tpu_torch.decode.streaming import StreamingTranscriber
    from rnnt_tpu_torch.serve import TranscriptionService

    service = TranscriptionService(args.checkpoint, device=args.device)
    transcriber = StreamingTranscriber(service.model, service.tokenizer)

    if args.simulate_file:
        from rnnt_tpu_torch.data.audio_io import read_audio

        audio, sr = read_audio(args.simulate_file)
        if sr != service.cfg.sample_rate:
            raise SystemExit(f"{args.simulate_file}: expected "
                             f"{service.cfg.sample_rate} Hz audio, got {sr}")
        last = ""
        t0 = time.time()
        for off in range(0, len(audio), args.chunk_samples):
            if args.realtime:
                wait = off / sr - (time.time() - t0)
                if wait > 0:
                    time.sleep(wait)
            text = transcriber.process_chunk(audio[off: off + args.chunk_samples])
            if text != last:  # print on change
                print(text, flush=True)
                last = text
        print("FINAL:", transcriber.flush(), flush=True)
        return

    try:
        import pyaudio  # type: ignore
    except ImportError:
        print("pyaudio not installed; use --simulate_file", file=sys.stderr)
        sys.exit(1)

    import numpy as np

    pa = pyaudio.PyAudio()
    last = [""]

    def callback(in_data, frame_count, time_info, status):
        chunk = np.frombuffer(in_data, dtype=np.int16).astype(
            np.float32) / 32768.0
        text = transcriber.process_chunk(chunk)
        if text != last[0]:
            print(text, flush=True)
            last[0] = text
        return None, pyaudio.paContinue

    stream = pa.open(format=pyaudio.paInt16, channels=1,
                     rate=service.cfg.sample_rate, input=True,
                     frames_per_buffer=args.chunk_samples,
                     stream_callback=callback)
    print("listening (ctrl-c to stop)...")
    try:
        while stream.is_active():
            time.sleep(0.1)
    except KeyboardInterrupt:
        pass
    finally:
        stream.close()
        pa.terminate()


if __name__ == "__main__":
    main()
