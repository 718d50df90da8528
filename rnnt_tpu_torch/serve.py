"""Transcription serving over HTTP, on the card.

The port of the HTTP half of `rnnt_tpu.serve`, with the standard library's
http.server:

- `POST /transcribe`: WAV body -> {"text": ...} by greedy decoding.  Features
  are padded to power-of-two frame buckets floored at 64 frames, as the JAX
  service does; an utterance above the largest bucket (`max_t_pad`) gets 413.
  `?beam=K` with K > 0 gets 400: beam search is not ported yet.
- `GET /healthz`, `GET /info`: liveness and model metadata.
- Bodies above `max_http_body` get 413 before they are read.

The TCP streaming port of the JAX server is not served yet.  One lock
serializes device work across request threads; each request runs the
frontend kernel, the encoder (one LSTM kernel launch per layer) and the
greedy loop (two LSTM kernel launches per prediction-net step) under it.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from io import BytesIO
from typing import Dict

import numpy as np
import torch

from rnnt_tpu_torch.data.audio_io import read_wav
from rnnt_tpu_torch.data.tokenizer import SUBWORD_FILENAME, get_tokenizer
from rnnt_tpu_torch.decode.greedy import greedy_decode_encoded
from rnnt_tpu_torch.device import resolve_device
from rnnt_tpu_torch.models.transducer import Transducer
from rnnt_tpu_torch.ops import features as F
from rnnt_tpu_torch.train import checkpoint as ckpt_mod

MAX_OUTPUT_LENGTH = 256
# 64 MiB of WAV is ~35 min of 16 kHz s16 mono
MAX_HTTP_BODY = 64 << 20


class AudioTooLongError(ValueError):
    """Utterance exceeds the largest supported frame bucket (HTTP 413)."""


class TranscriptionService:
    """Checkpoint -> greedy transcription on one device.

    dtype: parameter dtype; None means bfloat16 on the card (as the JAX
    service picks on a TPU) and float32 on the CPU.  max_t_pad: largest
    frame bucket `transcribe` accepts."""

    def __init__(self, checkpoint_dir: str, device="cuda", dtype=None,
                 max_t_pad: int = 512):
        self.device = resolve_device(device)
        self.cfg = ckpt_mod.load_config(checkpoint_dir)
        self.tokenizer = get_tokenizer(
            ckpt_mod.sidecar_dir(checkpoint_dir, SUBWORD_FILENAME),
            self.cfg.token_type, self.cfg.vocab_size)
        if dtype is None:
            dtype = (torch.bfloat16 if self.device.type == "cuda"
                     else torch.float32)
        self.step, state_dict = ckpt_mod.restore_params(checkpoint_dir,
                                                        self.cfg)
        model = Transducer(self.cfg)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).cast_(dtype).eval()
        self.max_t_pad = int(max_t_pad)
        self._lock = threading.Lock()
        # phase times of the last transcribe() call, in milliseconds
        self.last_timings: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def default_warmup_buckets(self):
        """Every bucket transcribe() can route an accepted utterance to:
        the 64-frame floor and each power of two up to max_t_pad."""
        return sorted(
            {min(64, self.max_t_pad)}
            | {1 << p for p in range(7, self.max_t_pad.bit_length())
               if (1 << p) <= self.max_t_pad})

    def warmup(self, t_pads=None) -> float:
        """Build the CUDA kernels and run every greedy bucket once, so that
        no request pays the build under the device lock.  Returns seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from rnnt_tpu_torch.kernels import build

            build.build_all()
        with self._lock, torch.no_grad():  # the frontend's constants
            F.preprocess_audio(torch.zeros(self.cfg.sample_rate,
                                           device=self.device), self.cfg)
        feat = self.cfg.input_feat_size
        for t_pad in t_pads or self.default_warmup_buckets():
            mel = torch.zeros((1, t_pad, feat), device=self.device)
            with self._lock, torch.no_grad():
                self._decode(mel, t_pad)
                self._sync()
        return time.perf_counter() - t0

    def _decode(self, mel_p: torch.Tensor, t: int):
        """Encoder, then greedy decoding of the first t frames' output."""
        encoded, _ = self.model.encode(mel_p)
        self._sync()
        t_enc = time.perf_counter()
        enc_lengths = self.model.encoded_length(
            torch.tensor([t], dtype=torch.int32, device=self.device))
        tokens, lengths = greedy_decode_encoded(
            self.model, encoded, enc_lengths,
            max_output_length=MAX_OUTPUT_LENGTH)
        return tokens[0, : int(lengths[0])].tolist(), t_enc

    def transcribe(self, audio: np.ndarray, sample_rate: int,
                   beam: int = 0) -> str:
        if beam:
            raise ValueError("beam search (?beam=K) is not supported by the "
                             "PyTorch port yet; use greedy (beam=0)")
        if sample_rate != self.cfg.sample_rate:
            raise ValueError(f"expected {self.cfg.sample_rate} Hz audio, "
                             f"got {sample_rate}")
        with self._lock, torch.no_grad():
            t0 = time.perf_counter()
            samples = torch.from_numpy(
                np.ascontiguousarray(audio, dtype=np.float32)).to(self.device)
            mel = F.preprocess_audio(samples, self.cfg)
            t = max(1, mel.shape[0])
            # power-of-two buckets floored at 64 frames, as the JAX service
            t_pad = max(min(64, self.max_t_pad), 1 << (t - 1).bit_length())
            if t_pad > self.max_t_pad:
                seconds = (self.max_t_pad * self.cfg.frame_step_samples
                           * self.cfg.downsample_factor / self.cfg.sample_rate)
                raise AudioTooLongError(
                    f"utterance of {t} frames exceeds the largest supported "
                    f"bucket ({self.max_t_pad} frames, ~{seconds:.0f}s)")
            mel_p = torch.zeros((1, t_pad, mel.shape[1]), device=self.device)
            mel_p[0, : mel.shape[0]] = mel
            self._sync()
            t1 = time.perf_counter()
            ids, t2 = self._decode(mel_p, t)
            t3 = time.perf_counter()
            self.last_timings = {
                "frames": t, "t_pad": t_pad,
                "frontend_ms": (t1 - t0) * 1e3,
                "encoder_ms": (t2 - t1) * 1e3,
                "decode_ms": (t3 - t2) * 1e3}
        return self.tokenizer.decode(ids)

    def info(self) -> dict:
        return {
            "model": "rnnt",
            "vocab_size": self.cfg.vocab_size,
            "token_type": self.cfg.token_type,
            "sample_rate": self.cfg.sample_rate,
            "step": self.step,
            "quantized": False,
            "int8_exec": False,
            "backend": self.device.type,
            "dtype": str(self.model.dtype).replace("torch.", ""),
        }


def _http_handler(service: TranscriptionService,
                  max_body: int = MAX_HTTP_BODY):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/info":
                self._json(200, service.info())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path != "/transcribe":
                self._json(404, {"error": f"no route {url.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body:
                    # rejected before the read: a hostile length allocates
                    # nothing
                    self._json(413, {"error": f"body {n} bytes exceeds "
                                              f"cap {max_body}"})
                    self.close_connection = True
                    return
                body = self.rfile.read(n)
                beam = int(parse_qs(url.query).get("beam", ["0"])[0])
                audio, sr = read_wav(BytesIO(body))
                text = service.transcribe(audio, sr, beam=beam)
                self._json(200, {"text": text})
            except AudioTooLongError as ex:
                self._json(413, {"error": str(ex)})
            except Exception as ex:  # noqa: BLE001 — reported to the client
                self._json(400, {"error": f"{type(ex).__name__}: {ex}"})

    return Handler


class Server:
    """HTTP server around one TranscriptionService."""

    def __init__(self, checkpoint_dir: str, host: str = "127.0.0.1",
                 http_port: int = 8080, device="cuda",
                 warmup: bool = False, max_http_body: int = MAX_HTTP_BODY,
                 max_t_pad: int = 512):
        self.service = TranscriptionService(checkpoint_dir, device=device,
                                            max_t_pad=max_t_pad)
        self.warmup_seconds = self.service.warmup() if warmup else 0.0
        self.http = ThreadingHTTPServer(
            (host, http_port),
            _http_handler(self.service, max_body=max_http_body))
        self.http_port = self.http.server_address[1]
        self._thread = None

    def serve_background(self) -> None:
        self._thread = threading.Thread(target=self.http.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.http.serve_forever()

    def shutdown(self) -> None:
        if self._thread is not None:
            self.http.shutdown()
            self._thread.join(timeout=30)
        self.http.server_close()
