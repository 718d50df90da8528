"""The port's server (device="cpu") on checkpoints written by the JAX
package: HTTP transcripts identical to rnnt_tpu.serve.TranscriptionService
(greedy, and ?beam=2 on a checkpoint whose joint is sharpened so that the
beam emits), the endpoints' status codes, and TCP streaming sessions equal
to the port's own StreamingTranscriber, with the JAX server's error frames.
Every greedy step's top-2 logit margin is asserted above 1e-3, and the beam
search's smallest selection gap above 1e-5, so the exact text matches do not
rest on a near tie."""

import http.client
import io
import json
import socket
import struct

import jax
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.data.audio_io import read_wav as j_read_wav
from rnnt_tpu.data.tokenizer import CharTokenizer
from rnnt_tpu.serve import TranscriptionService as JService
from rnnt_tpu.train import checkpoint as j_ckpt
from rnnt_tpu.train.state import create_train_state
from rnnt_tpu_torch.decode.beam import (beam_search_encoded_plain,
                                        default_expansions)
from rnnt_tpu_torch.decode.greedy import JointRecorder
from rnnt_tpu_torch.ops import features as TF
from tests.torch_helpers import sharp_train_state, wav_bytes

torch.set_num_threads(1)

CFG = tiny_config()
MAX_T_PAD = 128
SEED = 6  # chosen so that every greedy step's top-2 margin exceeds 1e-3
SHARP_SEED = 3
MAX_FRAME = 1 << 16


def _utterances():
    rng = np.random.default_rng(0)
    out = []
    for seconds in (0.55, 1.1):  # 64- and 128-frame buckets
        n = int(16000 * seconds)
        t = np.arange(n) / 16000.0
        audio = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 900) * t) \
            + 0.05 * rng.standard_normal(n)
        out.append(audio.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from rnnt_tpu_torch.serve import Server

    d = str(tmp_path_factory.mktemp("serve_run"))
    j_ckpt.save_checkpoint(d, create_train_state(jax.random.PRNGKey(SEED),
                                                 CFG), CFG)
    CharTokenizer().save(d)
    srv = Server(d, http_port=0, device="cpu", max_t_pad=MAX_T_PAD,
                 max_http_body=1 << 20)
    srv.serve_background()
    yield d, srv
    srv.shutdown()


@pytest.fixture(scope="module")
def sharp_served(tmp_path_factory):
    from rnnt_tpu_torch.serve import Server

    d = str(tmp_path_factory.mktemp("sharp_run"))
    j_ckpt.save_checkpoint(d, sharp_train_state(CFG, SHARP_SEED, 4.0), CFG)
    CharTokenizer().save(d)
    srv = Server(d, http_port=0, stream_port=0, device="cpu",
                 max_t_pad=MAX_T_PAD, max_stream_frame=MAX_FRAME)
    srv.serve_background()
    yield d, srv
    srv.shutdown()


def _post(port, body, query=""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/transcribe" + query, body=body)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_http_text_matches_jax_service(served):
    d, srv = served
    ref = JService(d, max_t_pad=MAX_T_PAD)
    texts = []
    with JointRecorder(srv.service.model) as rec:
        for audio in _utterances():
            body = wav_bytes(audio, 16000)
            status, reply = _post(srv.http_port, body)
            assert status == 200, reply
            texts.append(reply["text"])
            assert reply["text"] == ref.transcribe(
                *j_read_wav(io.BytesIO(body)))
    assert min(rec.margins) > 1e-3, min(rec.margins)
    assert any(texts), texts  # something was emitted
    assert srv.service.last_timings["t_pad"] == 128


def test_http_routes_and_errors(served):
    _, srv = served
    conn = http.client.HTTPConnection("127.0.0.1", srv.http_port, timeout=120)
    conn.request("GET", "/healthz")
    assert json.loads(conn.getresponse().read()) == {"ok": True}
    conn.request("GET", "/info")
    info = json.loads(conn.getresponse().read())
    assert info["backend"] == "cpu" and info["vocab_size"] == CFG.vocab_size
    assert info["step"] == 0 and info["dtype"] == "float32"
    conn.request("GET", "/nope")
    r = conn.getresponse()
    r.read()
    assert r.status == 404

    audio = _utterances()[0]
    status, reply = _post(srv.http_port, wav_bytes(audio, 16000), "?beam=4")
    assert status == 200 and isinstance(reply["text"], str)
    assert srv.service.last_timings["beam"] == 4
    status, reply = _post(srv.http_port, b"not a wav")
    assert status == 400
    long_audio = np.zeros((MAX_T_PAD + 8) * 160 + 400, np.float32)
    status, reply = _post(srv.http_port, wav_bytes(long_audio, 16000))
    assert status == 413 and "bucket" in reply["error"]

    # over the body cap: refused from the header, before any read
    conn = http.client.HTTPConnection("127.0.0.1", srv.http_port, timeout=120)
    conn.putrequest("POST", "/transcribe")
    conn.putheader("Content-Length", str((1 << 20) + 1))
    conn.endheaders()
    r = conn.getresponse()
    assert r.status == 413 and "cap" in json.loads(r.read())["error"]
    status, _ = _post(srv.http_port, wav_bytes(audio, 16000))
    assert status == 200  # still serving


def test_http_beam_matches_jax_service(sharp_served):
    d, srv = sharp_served
    ref = JService(d, max_t_pad=MAX_T_PAD)
    model = srv.service.model
    texts = []
    for audio in _utterances():
        body = wav_bytes(audio, 16000)
        status, reply = _post(srv.http_port, body, "?beam=2")
        assert status == 200, reply
        texts.append(reply["text"])
        assert reply["text"] == ref.transcribe(
            *j_read_wav(io.BytesIO(body)), beam=2)
        # the search the request ran, again, for its selection gaps
        with torch.no_grad():
            mel = TF.preprocess_audio(torch.from_numpy(audio), CFG)
            t_pad = srv.service.last_timings["t_pad"]
            mel_p = torch.zeros((1, t_pad, mel.shape[1]))
            mel_p[0, : mel.shape[0]] = mel
            enc, _ = model.encode(mel_p)
            stats = {}
            beam_search_encoded_plain(
                model, enc, model.encoded_length(
                    torch.tensor([mel.shape[0]])), beam_width=2,
                max_output_length=256,
                expansions_per_frame=default_expansions(CFG), stats=stats)
        assert stats["min_gap"] > 1e-5, stats
    assert all(texts), texts  # the sharp joint emits


def _session(port, frames):
    """Send the frames (bytes payloads, b"" ends the stream) and return the
    replies until the server's final one or its close."""
    replies = []
    with socket.create_connection(("127.0.0.1", port), timeout=120) as c:
        for payload in frames:
            c.sendall(struct.pack("<I", len(payload)) + payload)
            hdr = c.recv(4, socket.MSG_WAITALL)
            if len(hdr) < 4:
                break
            (m,) = struct.unpack("<I", hdr)
            replies.append(json.loads(c.recv(m, socket.MSG_WAITALL)))
            if replies[-1]["final"]:
                break
    return replies


def test_tcp_session_matches_streaming_transcriber(sharp_served):
    _, srv = sharp_served
    audio = _utterances()[1]
    chunks = [audio[o: o + 1024] for o in range(0, len(audio), 1024)]
    replies = _session(srv.stream_port,
                       [c.astype("<f4").tobytes() for c in chunks] + [b""])
    st = srv.service.new_stream()
    want = [st.process_chunk(c) for c in chunks] + [st.flush()]
    assert [r["text"] for r in replies] == want
    assert [r["final"] for r in replies] == [False] * len(chunks) + [True]
    assert want[-1]  # the sharp joint emits


def test_tcp_protocol_errors(sharp_served):
    _, srv = sharp_served
    chunk = np.zeros(1024, "<f4").tobytes()

    def error_of(frames):
        replies = _session(srv.stream_port, frames)
        assert replies[-1]["final"] and "error" in replies[-1], replies
        return replies[-1]["error"]

    # a frame above the cap is refused from its header
    with socket.create_connection(("127.0.0.1", srv.stream_port),
                                  timeout=120) as c:
        c.sendall(struct.pack("<I", MAX_FRAME + 4))
        (m,) = struct.unpack("<I", c.recv(4, socket.MSG_WAITALL))
        reply = json.loads(c.recv(m, socket.MSG_WAITALL))
    assert reply["final"] and "exceeds cap" in reply["error"]
    assert "float32" in error_of([b"\0" * 6])
    assert "violates" in error_of([chunk, chunk + chunk])
    assert "violates" in error_of([chunk, chunk[:2048], chunk[:2048]])
    # the session size and one smaller tail frame are accepted
    replies = _session(srv.stream_port, [chunk, chunk, chunk[:2048], b""])
    assert [r["final"] for r in replies] == [False, False, False, True]
