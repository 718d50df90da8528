"""Port streaming (rnnt_tpu_torch.decode.streaming, CPU) vs the JAX
StreamingTranscriber on the same sharp-joint parameters and audio: the text
after every chunk and after flush() is identical, in 1024-sample chunks and
in an odd chunk size.  Every greedy step's top-2 logit margin on the port is
asserted above 1e-5, ten times the fp32 logit differences between the two
frameworks here (~1e-6), so exactness does not rest on a near tie.  Also the
greedy carry: decoding the encoder output in two calls equals one call."""

import jax
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.data.tokenizer import CharTokenizer
from rnnt_tpu.decode.streaming import StreamingTranscriber as JStream
from rnnt_tpu.models.transducer import init_transducer_params
from rnnt_tpu_torch.data.tokenizer import CharTokenizer as TCharTokenizer
from rnnt_tpu_torch.decode.greedy import JointRecorder, greedy_decode_encoded
from rnnt_tpu_torch.decode.streaming import StreamingTranscriber
from tests.torch_helpers import sharpen_joint, torch_model

torch.set_num_threads(1)

CFG = tiny_config()
SEED = 4


@pytest.fixture(scope="module")
def models():
    params = sharpen_joint(init_transducer_params(jax.random.PRNGKey(SEED),
                                                  CFG))
    return params, torch_model(CFG, params)


def _audio(seconds=1.6, seed=0):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    audio = sum(0.2 * np.sin(2 * np.pi * rng.uniform(150, 2500) * t)
                for _ in range(3)) * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * t))
    return (audio + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _stream(st, audio, chunk):
    texts = [st.process_chunk(audio[o: o + chunk])
             for o in range(0, len(audio), chunk)]
    return texts + [st.flush()]


@pytest.mark.parametrize("chunk", [1024, 777])
def test_stream_text_matches_jax(models, chunk):
    params, tm = models
    audio = _audio()
    want = _stream(JStream(CFG, params, CharTokenizer()), audio, chunk)
    with JointRecorder(tm) as rec:
        got = _stream(StreamingTranscriber(tm, TCharTokenizer()), audio, chunk)
    assert got == want
    assert got[-1], "the sharp model emits"
    assert min(rec.margins) > 1e-5, min(rec.margins)


def test_flush_is_terminal_and_reset_restarts(models):
    _, tm = models
    audio = _audio(seconds=1.0, seed=1)
    st = StreamingTranscriber(tm, TCharTokenizer())
    first = _stream(st, audio, 1024)
    with pytest.raises(RuntimeError, match="flush"):
        st.process_chunk(audio[:1024])
    st.reset()
    assert st.text == ""
    assert _stream(st, audio, 1024) == first


def test_greedy_carry_continues_across_calls(models):
    _, tm = models
    mel = np.random.default_rng(2).standard_normal(
        (2, 24, CFG.input_feat_size)).astype(np.float32)
    with torch.no_grad():
        enc, _ = tm.encode(torch.from_numpy(mel))
        T = enc.shape[1]
        full = torch.full((2,), T, dtype=torch.int32)
        tok, ln, _ = greedy_decode_encoded(tm, enc, full,
                                           max_output_length=1024)
        half = T // 2
        tok1, ln1, carry = greedy_decode_encoded(
            tm, enc[:, :half], torch.full((2,), half, dtype=torch.int32),
            max_output_length=1024)
        tok2, ln2, _ = greedy_decode_encoded(
            tm, enc[:, half:], torch.full((2,), T - half, dtype=torch.int32),
            max_output_length=1024, carry=carry)
    assert int(ln.sum()) > 0
    for b in range(2):
        joined = (tok1[b, : ln1[b]].tolist() + tok2[b, : ln2[b]].tolist())
        assert joined == tok[b, : ln[b]].tolist()
