"""Transcription serving on the card: HTTP requests and TCP streams.

The port of `rnnt_tpu.serve`, with the standard library's http.server and
socketserver:

- `POST /transcribe`: WAV body -> {"text": ...}, by greedy decoding or, with
  `?beam=K`, by a K-beam search (the beam kernel, one launch a request).
  Features are padded to power-of-two frame buckets floored at 64 frames, as
  the JAX service does; an utterance above the largest bucket (`max_t_pad`)
  gets 413.
- `GET /healthz`, `GET /info`: liveness and model metadata.
- TCP streaming port, one connection per stream: the client sends
  `u32 n | n bytes of float32 PCM` frames (little-endian), an empty frame
  (n = 0) ends the stream; after every frame the server replies
  `u32 m | m bytes of UTF-8 JSON {"text": ..., "final": bool}`, or
  `{"error": ..., "final": true}` on a protocol violation, then closes.
  Each connection gets its own `StreamingTranscriber`.

Resource caps, as in the JAX server: HTTP bodies above `max_http_body` get
413 before they are read; a TCP frame above `max_stream_frame`, or not a
whole number of float32 samples, gets an error frame and a close; the first
data frame of a session fixes its chunk size, later frames must match it
(one smaller final data frame is allowed).

An int8 artifact (`cli.quantize_model`) is served with `quantized=`: its
weights dequantized to the serving dtype, or with `int8_exec=True` the
prediction net's and joint's products executed in int8 (`ops.int8_exec`);
beam requests then search with the counterpart of the JAX package's XLA
beam (`decode.beam.search_by_kind`), since kernel K3 reads fp weights.

One lock serializes device work across HTTP requests and every stream.  A
request runs the frontend kernel, the encoder (one LSTM kernel launch per
layer) and greedy decoding (two LSTM kernel launches per prediction-net
step) or the beam kernel under it; a stream chunk the frontend, the encoder
at chunk shapes and greedy decoding with the carried state.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from io import BytesIO
from typing import Dict, Optional

import numpy as np
import torch

from rnnt_tpu_torch.data.audio_io import read_wav
from rnnt_tpu_torch.data.tokenizer import SUBWORD_FILENAME, get_tokenizer
from rnnt_tpu_torch.decode.beam import default_expansions, search_by_kind
from rnnt_tpu_torch.decode.greedy import greedy_decode_encoded
from rnnt_tpu_torch.decode.streaming import StreamingTranscriber
from rnnt_tpu_torch.device import resolve_device
from rnnt_tpu_torch.models.transducer import Transducer
from rnnt_tpu_torch.ops import features as F
from rnnt_tpu_torch.ops.quantize import load_quantized_into_
from rnnt_tpu_torch.train import checkpoint as ckpt_mod

MAX_OUTPUT_LENGTH = 256
# 64 MiB of WAV is ~35 min of 16 kHz s16 mono; 8 MiB of float32 PCM is ~2 min
# of audio in one streaming frame
MAX_HTTP_BODY = 64 << 20
MAX_STREAM_FRAME = 8 << 20


class AudioTooLongError(ValueError):
    """Utterance exceeds the largest supported frame bucket (HTTP 413)."""


class TranscriptionService:
    """Checkpoint -> transcription (greedy, beam, streaming) on one device.

    dtype: parameter dtype; None means bfloat16 on the card (as the JAX
    service picks on a TPU) and float32 on the CPU.  quantized: path of a
    `cli.quantize_model` int8 artifact of this checkpoint's model, served
    dequantized to `dtype`; int8_exec: with `quantized`, keep the prediction
    net's and joint's weights int8 and execute their products in int8.
    max_t_pad: largest frame bucket `transcribe` accepts."""

    def __init__(self, checkpoint_dir: str, device="cuda", dtype=None,
                 quantized: Optional[str] = None, int8_exec: bool = False,
                 max_t_pad: int = 512):
        if int8_exec and not quantized:
            raise ValueError("int8_exec requires a quantized artifact")
        self.quantized = bool(quantized)
        self.int8_exec = bool(int8_exec)
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
        if quantized:
            load_quantized_into_(self.model, quantized, int8_exec)
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

    def warmup(self, t_pads=None, beams=(0, 4),
               stream_chunk: int = 1024) -> float:
        """Build the CUDA kernels, run every (beam, bucket) pair once and
        drive a short stream of `stream_chunk`-sample chunks (0 skips it), so
        that no request pays a build or a first call under the device lock.
        Returns seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from rnnt_tpu_torch.kernels import build

            build.build_all()
        with self._lock, torch.no_grad():  # the frontend's constants
            F.preprocess_audio(torch.zeros(self.cfg.sample_rate,
                                           device=self.device), self.cfg)
        feat = self.cfg.input_feat_size
        for beam in beams:
            for t_pad in t_pads or self.default_warmup_buckets():
                mel = torch.zeros((1, t_pad, feat), device=self.device)
                with self._lock, torch.no_grad():
                    self._decode(mel, t_pad, beam)
                    self._sync()
        if stream_chunk:
            st = self.new_stream()
            # past the priming, to the steady chunk shapes, and the flush
            for _ in range(max(st.prime_samples // stream_chunk + 4, 8)):
                st.process_chunk(np.zeros(stream_chunk, np.float32))
            st.flush()
        return time.perf_counter() - t0

    def _decode(self, mel_p: torch.Tensor, t: int, beam: int = 0):
        """Encoder, then greedy decoding or a `beam`-wide search of the
        first t frames' output.  Returns (token ids, time the encoder was
        done)."""
        encoded, _ = self.model.encode(mel_p)
        self._sync()
        t_enc = time.perf_counter()
        enc_lengths = self.model.encoded_length(
            torch.tensor([t], dtype=torch.int32, device=self.device))
        if beam > 0:  # as the JAX service, beam <= 0 is greedy
            tokens, lengths, _ = search_by_kind(self.model)(
                self.model, encoded, enc_lengths, beam_width=beam,
                max_output_length=MAX_OUTPUT_LENGTH,
                expansions_per_frame=default_expansions(self.cfg))
        else:
            tokens, lengths, _ = greedy_decode_encoded(
                self.model, encoded, enc_lengths,
                max_output_length=MAX_OUTPUT_LENGTH)
        return tokens[0, : int(lengths[0])].tolist(), t_enc

    def transcribe(self, audio: np.ndarray, sample_rate: int,
                   beam: int = 0) -> str:
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
            ids, t2 = self._decode(mel_p, t, beam)
            t3 = time.perf_counter()
            self.last_timings = {
                "frames": t, "t_pad": t_pad, "beam": beam,
                "frontend_ms": (t1 - t0) * 1e3,
                "encoder_ms": (t2 - t1) * 1e3,
                "decode_ms": (t3 - t2) * 1e3}
        return self.tokenizer.decode(ids)

    def new_stream(self) -> StreamingTranscriber:
        """A streaming session on this service's model; it shares the device
        lock with HTTP requests and every other stream."""
        return StreamingTranscriber(self.model, self.tokenizer,
                                    device_lock=self._lock)

    def info(self) -> dict:
        return {
            "model": "rnnt",
            "vocab_size": self.cfg.vocab_size,
            "token_type": self.cfg.token_type,
            "sample_rate": self.cfg.sample_rate,
            "step": self.step,
            "quantized": self.quantized,
            "int8_exec": self.int8_exec,
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


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


def _stream_handler(service: TranscriptionService,
                    max_frame: int = MAX_STREAM_FRAME):
    class Handler(socketserver.BaseRequestHandler):
        def _error(self, conn, msg: str) -> None:
            reply = json.dumps({"error": msg, "final": True}).encode()
            conn.sendall(struct.pack("<I", len(reply)) + reply)

        def handle(self):
            st = service.new_stream()
            conn = self.request
            chunk_bytes = None   # fixed by the first data frame
            tail_seen = False    # one smaller final data frame allowed
            while True:
                hdr = _recv_exact(conn, 4)
                if hdr is None:
                    return  # the client went away
                (n,) = struct.unpack("<I", hdr)
                if n == 0:
                    text, final = st.flush(), True
                else:
                    if n > max_frame:
                        # never allocate a hostile length
                        self._error(conn, f"frame {n} bytes exceeds cap "
                                          f"{max_frame}")
                        return
                    if n % 4:
                        self._error(conn, f"frame {n} bytes is not a whole "
                                          "number of float32 samples")
                        return
                    # chunk-size contract: the first data frame fixes the
                    # size; later frames match it, except one smaller final
                    # frame before the terminator
                    if chunk_bytes is None:
                        chunk_bytes = n
                    elif tail_seen or n > chunk_bytes:
                        self._error(conn, f"chunk size {n} violates session "
                                          f"size {chunk_bytes}")
                        return
                    elif n < chunk_bytes:
                        tail_seen = True
                    payload = _recv_exact(conn, n)
                    if payload is None:
                        return
                    samples = np.frombuffer(payload, dtype="<f4")
                    text, final = st.process_chunk(samples), False
                reply = json.dumps({"text": text, "final": final}).encode()
                conn.sendall(struct.pack("<I", len(reply)) + reply)
                if final:
                    return

    return Handler


class Server:
    """HTTP and streaming-TCP servers sharing one TranscriptionService."""

    def __init__(self, checkpoint_dir: str, host: str = "127.0.0.1",
                 http_port: int = 8080, stream_port: int = 8081,
                 device="cuda", warmup: bool = False, warmup_beams=(0, 4),
                 max_http_body: int = MAX_HTTP_BODY,
                 max_stream_frame: int = MAX_STREAM_FRAME,
                 max_t_pad: int = 512, quantized: Optional[str] = None,
                 int8_exec: bool = False):
        self.service = TranscriptionService(checkpoint_dir, device=device,
                                            quantized=quantized,
                                            int8_exec=int8_exec,
                                            max_t_pad=max_t_pad)
        self.warmup_seconds = (self.service.warmup(beams=warmup_beams)
                               if warmup else 0.0)
        self.http = ThreadingHTTPServer(
            (host, http_port),
            _http_handler(self.service, max_body=max_http_body))
        self.stream = socketserver.ThreadingTCPServer(
            (host, stream_port),
            _stream_handler(self.service, max_frame=max_stream_frame),
            bind_and_activate=False)
        self.stream.daemon_threads = True
        self.stream.allow_reuse_address = True
        try:
            self.stream.server_bind()
            self.stream.server_activate()
        except OSError:
            self.http.server_close()
            self.stream.server_close()
            raise
        self.http_port = self.http.server_address[1]
        self.stream_port = self.stream.server_address[1]
        self._threads = []

    def serve_background(self) -> None:
        for srv in (self.http, self.stream):
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            self._threads.append(th)

    def serve_forever(self) -> None:
        self.serve_background()
        for th in self._threads:
            th.join()

    def shutdown(self) -> None:
        if self._threads:  # shutdown() waits for a running serve_forever
            self.http.shutdown()
            self.stream.shutdown()
            for th in self._threads:
                th.join(timeout=30)
        self.http.server_close()
        self.stream.server_close()
