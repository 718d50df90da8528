"""The port's quality harness and corpus loader against the JAX package's,
on the CPU: `data.librispeech` yields the same (audio, sr, text) sequence
(audio exactly equal) from a synthetic LibriSpeech tree with a `.wav`
fallback, a missing file, two speakers and a blank transcript line; and
`decode.streaming.streamed_vs_offline`, on a tiny model whose JAX
parameters are carried into the port with a sharpened joint, gives the same
offline and streamed WERs and identical transcripts on three utterances,
fp32, in 1024-sample chunks.  Every greedy step's top-2 logit margin on the
port is asserted above 1e-5, ten times the logit differences between the
two frameworks here, so the exact match does not rest on a near tie."""

import os

import jax
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.data import librispeech as j_libri
from rnnt_tpu.data.tokenizer import CharTokenizer
from rnnt_tpu.decode.streaming import streamed_vs_offline as j_svo
from rnnt_tpu.models.transducer import init_transducer_params
from rnnt_tpu_torch.data import librispeech
from rnnt_tpu_torch.data.audio_io import write_wav
from rnnt_tpu_torch.data.tokenizer import CharTokenizer as TCharTokenizer
from rnnt_tpu_torch.decode.greedy import JointRecorder
from rnnt_tpu_torch.decode.streaming import streamed_vs_offline
from tests.torch_helpers import sharpen_joint, torch_model

torch.set_num_threads(1)

CFG = tiny_config()
SEED = 2  # every greedy step's top-2 margin on the port is above 9e-4
SPLIT = "test-synth"


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    audio = sum(0.2 * np.sin(2 * np.pi * rng.uniform(150, 2500) * t)
                for _ in range(3)) * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * t))
    return (audio + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _write_chapter(root, speaker, chapter, utts):
    """utts: [(utt number, seconds or None for a listed but missing file,
    text)]; each file is a .wav while the transcript lists .flac ids."""
    d = os.path.join(root, SPLIT, str(speaker), str(chapter))
    os.makedirs(d, exist_ok=True)
    lines = []
    for k, seconds, text in utts:
        utt_id = f"{speaker}-{chapter}-{k:04d}"
        if seconds is not None:
            write_wav(os.path.join(d, utt_id + ".wav"),
                      _audio(seconds, speaker * 100 + k), 16000)
        lines.append(f"{utt_id} {text}")
    with open(os.path.join(d, f"{speaker}-{chapter}.trans.txt"), "w") as f:
        f.write("\n".join(lines[:1] + [""] + lines[1:]) + "\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("libri"))
    # one length: one offline bucket and one set of chunk shapes for the
    # JAX harness to compile
    _write_chapter(root, 19, 198, [(0, 0.8, "HELLO THERE"),
                                   (1, None, "A MISSING FILE"),
                                   (2, 0.8, "IT'S A TEST")])
    _write_chapter(root, 7, 11, [(0, 0.8, "GOOD MORNING")])
    return root


def test_load_dataset_matches_jax(corpus):
    want = list(j_libri.load_dataset(corpus, [SPLIT, "no-such-split"]))
    got = list(librispeech.load_dataset(corpus, [SPLIT, "no-such-split"]))
    assert len(got) == len(want) == 3
    for (a, sr, text), (ja, jsr, jtext) in zip(got, want):
        assert (sr, text) == (jsr, jtext)
        assert a.dtype == ja.dtype and np.array_equal(a, ja)
    # speakers in sorted-name order ("19" before "7"), the missing file
    # and the blank line skipped
    assert [t for _, _, t in got] == ["HELLO THERE", "IT'S A TEST",
                                      "GOOD MORNING"]
    assert list(librispeech.texts_generator(corpus, [SPLIT])) == list(
        j_libri.texts_generator(corpus, [SPLIT]))
    assert list(librispeech.iter_utterance_files(corpus, [SPLIT])) == list(
        j_libri.iter_utterance_files(corpus, [SPLIT]))


def test_streamed_vs_offline_matches_jax(corpus):
    params = sharpen_joint(init_transducer_params(jax.random.PRNGKey(SEED),
                                                  CFG), 4.0)
    want = j_svo(CFG, params, CharTokenizer(),
                 j_libri.load_dataset(corpus, [SPLIT]))
    tm = torch_model(CFG, params)
    with JointRecorder(tm) as rec:
        got = streamed_vs_offline(tm, TCharTokenizer(),
                                  librispeech.load_dataset(corpus, [SPLIT]))
    off_wer, str_wer, details = got
    assert (off_wer, str_wer) == (want[0], want[1])
    assert details == want[2]
    assert len(details) == 3 and all(off for _, off, _ in details), \
        "the sharp model emits on every utterance"
    assert min(rec.margins) > 1e-5, min(rec.margins)
