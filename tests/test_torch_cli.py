"""The port's CLIs in process with --device cpu, on a checkpoint written by
the JAX package (joint sharpened so that decoding emits): transcribe_file
(greedy and --beam 2, two WAVs in one padded batch) and streaming_transcribe
--simulate_file print exactly what the library calls give; a FLAC
transcribes as its WAV."""

import os

import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.data.tokenizer import CharTokenizer
from rnnt_tpu.train import checkpoint as j_ckpt
from rnnt_tpu_torch.cli import streaming_transcribe, transcribe_file
from rnnt_tpu_torch.data.audio_io import write_wav
from rnnt_tpu_torch.decode.beam import beam_search_decode
from rnnt_tpu_torch.decode.greedy import greedy_decode
from rnnt_tpu_torch.decode.streaming import StreamingTranscriber
from rnnt_tpu_torch.ops import features as TF
from rnnt_tpu_torch.serve import TranscriptionService
from tests.torch_helpers import sharp_train_state

torch.set_num_threads(1)

CFG = tiny_config()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_run"))
    j_ckpt.save_checkpoint(d, sharp_train_state(CFG, 3, 4.0), CFG)
    CharTokenizer().save(d)
    rng = np.random.default_rng(5)
    wavs = []
    for i, seconds in enumerate((0.6, 1.0)):
        n = int(16000 * seconds)
        t = np.arange(n) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 900) * t)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        path = os.path.join(d, f"u{i}.wav")
        write_wav(path, audio, 16000)
        wavs.append(path)
    return d, wavs, TranscriptionService(d, device="cpu")


def _library(service, wavs, beam):
    from rnnt_tpu_torch.data.audio_io import read_wav

    mels = [TF.preprocess_audio(torch.from_numpy(read_wav(p)[0]), CFG)
            for p in wavs]
    lengths = [m.shape[0] for m in mels]
    t_pad = max(16, 1 << (max(lengths) - 1).bit_length())
    mel = torch.zeros((len(mels), t_pad, CFG.input_feat_size))
    for i, m in enumerate(mels):
        mel[i, : m.shape[0]] = m
    spec = torch.tensor(lengths, dtype=torch.int32)
    with torch.no_grad():
        if beam:
            tok, ln, _ = beam_search_decode(service.model, mel, spec,
                                            beam_width=beam)
        else:
            tok, ln = greedy_decode(service.model, mel, spec)
    return [service.tokenizer.decode(tok[i, : ln[i]].tolist())
            for i in range(len(wavs))]


@pytest.mark.parametrize("beam", [0, 2])
def test_transcribe_file(run, capsys, beam):
    d, wavs, service = run
    transcribe_file.main(["--checkpoint", d, "-i", *wavs, "--beam",
                          str(beam), "--device", "cpu"])
    want = _library(service, wavs, beam)
    assert any(want)
    assert capsys.readouterr().out.splitlines() == [
        f"{p}\t{t}" for p, t in zip(wavs, want)]
    # one file prints its bare transcript
    transcribe_file.main(["--checkpoint", d, "-i", wavs[1], "--beam",
                          str(beam), "--device", "cpu"])
    assert capsys.readouterr().out == _library(service, wavs[1:], beam)[0] \
        + "\n"


def test_transcribe_file_refuses_flac(run, tmp_path, capsys):
    """A FLAC of a WAV's samples (tests/flac_fixture.py's encoder)
    transcribes as the WAV does; a truncated FLAC is refused by the
    decoder with ValueError.  (Named for the refusal it asserted before
    this path was ported.)"""
    from rnnt_tpu_torch.data.audio_io import read_wav
    from tests.flac_fixture import encode_flac

    d, wavs, _ = run
    audio, _ = read_wav(wavs[1])
    flac = tmp_path / "u1.flac"
    flac.write_bytes(encode_flac(np.round(audio * 32768.0).astype(np.int64),
                                 blocksize=4096))
    transcribe_file.main(["--checkpoint", d, "-i", wavs[1], "--device",
                          "cpu"])
    want = capsys.readouterr().out
    assert want.strip()
    transcribe_file.main(["--checkpoint", d, "-i", str(flac), "--device",
                          "cpu"])
    assert capsys.readouterr().out == want
    bad = tmp_path / "a.flac"
    bad.write_bytes(b"fLaC")
    with pytest.raises(ValueError, match="FLAC"):
        transcribe_file.main(["--checkpoint", d, "-i", str(bad),
                              "--device", "cpu"])


def test_streaming_transcribe_simulate_file(run, capsys):
    from rnnt_tpu_torch.data.audio_io import read_wav

    d, wavs, service = run
    streaming_transcribe.main(["--checkpoint", d, "--simulate_file", wavs[1],
                               "--device", "cpu"])
    audio, _ = read_wav(wavs[1])
    st = StreamingTranscriber(service.model, service.tokenizer)
    want, last = [], ""
    for o in range(0, len(audio), 1024):
        text = st.process_chunk(audio[o: o + 1024])
        if text != last:
            want.append(text)
            last = text
    final = st.flush()
    assert final
    assert capsys.readouterr().out.splitlines() == want + [f"FINAL: {final}"]
