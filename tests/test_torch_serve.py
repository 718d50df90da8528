"""The port's HTTP server (device="cpu") on a checkpoint written by the JAX
package: transcripts identical to rnnt_tpu.serve.TranscriptionService, and
the endpoints' status codes.  Every greedy step's top-2 logit margin is
asserted above 1e-3, so the exact text match does not rest on a near tie."""

import http.client
import io
import json

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
from rnnt_tpu_torch.decode.greedy import JointRecorder
from tests.torch_helpers import wav_bytes

torch.set_num_threads(1)

CFG = tiny_config()
MAX_T_PAD = 128
SEED = 6  # chosen so that every greedy step's top-2 margin exceeds 1e-3


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
    assert status == 400 and "beam" in reply["error"]
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
