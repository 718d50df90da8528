"""The port's data preparation on the CPU against the JAX package: the BPE
builder (byte-identical `encoder.subwords`), the preprocess CLIs for
LibriSpeech (WAV + FLAC) and Common Voice (shards equal: ints exact, mels
within 2e-4, the bound of tests/test_torch_features.py), serial against
`--workers 2` (byte-identical shards), and the corpus tools
(`remove_missing_samples`, `convert_common_voice` with a stand-in ffmpeg,
`debug_dataset`, `corpus_stats`)."""

import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from rnnt_tpu.cli import convert_common_voice as j_convert
from rnnt_tpu.cli import corpus_stats as j_stats
from rnnt_tpu.cli import debug_dataset as j_debug
from rnnt_tpu.cli import preprocess_common_voice as j_prep_cv
from rnnt_tpu.cli import preprocess_librispeech as j_prep_ls
from rnnt_tpu.cli import remove_missing_samples as j_remove
from rnnt_tpu.config import RNNTConfig as JConfig
from rnnt_tpu.data import pipeline as j_pipeline
from rnnt_tpu.data import records as j_records
from rnnt_tpu.data.tokenizer import CharTokenizer as JChar
from rnnt_tpu.data.tokenizer import SubwordTokenizer as JSubword
from rnnt_tpu_torch.cli import convert_common_voice, corpus_stats, \
    debug_dataset, preprocess_common_voice, preprocess_librispeech, \
    remove_missing_samples
from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.data import pipeline
from rnnt_tpu_torch.data.audio_io import write_wav
from rnnt_tpu_torch.data.tokenizer import CharTokenizer, SubwordTokenizer, \
    get_tokenizer
from tests.flac_fixture import encode_flac

torch.set_num_threads(1)

MEL_ATOL = 2e-4
WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliet", "kilo", "lima", "oscar", "papa"]


def _sentences(seed, n, words=WORDS, k=(2, 7)):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, int(rng.integers(*k))).tolist())
            for _ in range(n)]


# ------------------------------------------------------------- tokenizer

TOKENIZER_CASES = {
    # name: (corpus, build kwargs)
    "default": (_sentences(0, 60), dict(target_vocab_size=80)),
    "pad_to_target": (_sentences(1, 20, WORDS[:5]),
                      dict(target_vocab_size=200, pad_to_target=True)),
    # a cap below 1 + the alphabet: no merges, only the alphabet is kept
    "learn_below_alphabet_floor": (
        _sentences(2, 30) + ["Ça naïve façade \"quoted\" it's"],
        dict(target_vocab_size=64, pad_to_target=True, learn_vocab_size=6)),
}


def _subwords_bytes(tok, d):
    return open(tok.save(str(d)), "rb").read()


@pytest.mark.parametrize("case", sorted(TOKENIZER_CASES))
def test_bpe_builder_matches_jax(case, tmp_path):
    corpus, kw = TOKENIZER_CASES[case]
    got = SubwordTokenizer.build_from_corpus(iter(corpus), **kw)
    want = JSubword.build_from_corpus(iter(corpus), **kw)
    assert _subwords_bytes(got, tmp_path / "port") == \
        _subwords_bytes(want, tmp_path / "jax")
    assert got.learned_piece_count == want.learned_piece_count
    if kw.get("pad_to_target"):
        assert got.vocab_size == kw["target_vocab_size"]
    if case == "learn_below_alphabet_floor":
        assert got.learned_piece_count == 0
    for line in corpus[:5]:
        assert got.encode(line) == want.encode(line)


@pytest.mark.parametrize("case", sorted(TOKENIZER_CASES))
def test_incremental_builder_matches_its_rescan_oracle(case):
    corpus, kw = TOKENIZER_CASES[case]
    fast = SubwordTokenizer.build_from_corpus(iter(corpus), **kw)
    slow = SubwordTokenizer._build_from_corpus_rescan(iter(corpus), **kw)
    assert fast.pieces == slow.pieces


def test_get_tokenizer_builds_then_loads_and_warns(tmp_path):
    d = str(tmp_path)
    corpus = _sentences(3, 30)
    with pytest.raises(FileNotFoundError, match="no corpus given"):
        get_tokenizer(d, "word-piece", 64)
    tok = get_tokenizer(d, "word-piece", 64, corpus=iter(corpus),
                        pad_to_target=True, learn_vocab_size=40)
    assert tok.vocab_size == 64 and tok.learned_piece_count <= 40
    with pytest.warns(UserWarning, match="vocab_size 64, but 128"):
        again = get_tokenizer(d, "word-piece", 128, corpus=iter(corpus))
    assert again.pieces == tok.pieces
    with pytest.warns(UserWarning, match="above the requested --bpe_pieces"):
        get_tokenizer(d, "word-piece", 64, learn_vocab_size=5)
    assert isinstance(get_tokenizer(d, "character", 31), CharTokenizer)


# ------------------------------------------------------------- corpora

def _audio(rng, seconds):
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    a = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 2500) * t) \
        + 0.05 * rng.standard_normal(n)
    # 16-bit PCM values, so the WAV and the FLAC hold the same samples
    return np.round(np.clip(a, -1, 1) * 32767.0) / 32768.0


def _write_audio(path_no_ext, audio, flac):
    if flac:
        with open(path_no_ext + ".flac", "wb") as f:
            f.write(encode_flac(np.round(audio * 32768.0).astype(np.int64),
                                blocksize=1024))
    else:
        write_wav(path_no_ext + ".wav", audio.astype(np.float32), 16000)


@pytest.fixture(scope="module")
def ls_corpus(tmp_path_factory):
    """LibriSpeech layout, half FLAC, half WAV; one train utterance over
    --max_length, and one empty dev transcript, which tokenises to
    nothing."""
    root = tmp_path_factory.mktemp("ls")
    rng = np.random.default_rng(7)
    for split, n in (("train-mini", 7), ("dev-mini", 2), ("test-mini", 2)):
        for spk, chap in (("19", "198"), ("26", "495")):
            d = root / split / spk / chap
            d.mkdir(parents=True)
            lines = []
            texts = _sentences(int(rng.integers(1 << 30)), n)
            for i, text in enumerate(texts):
                utt = f"{spk}-{chap}-{i:04d}"
                secs = 2.5 if (split, spk, i) == ("train-mini", "19", 3) \
                    else float(rng.uniform(0.3, 0.9))
                _write_audio(str(d / utt), _audio(rng, secs), flac=i % 2 == 0)
                lines.append(f"{utt} {text.upper()}")
            if split == "dev-mini" and spk == "26":
                lines[-1] = lines[-1].split(" ")[0]
            (d / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n")
    return root


LS_FLAGS = ["--train_splits", "train-mini", "--dev_splits", "dev-mini",
            "--test_splits", "test-mini", "--vocab_size", "96", "--pad_vocab",
            "--num_shards", "2", "--max_length", "2.0"]


def _run_jax_cli(main, argv):
    saved = sys.argv
    sys.argv = ["cli"] + argv
    try:
        main()
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def ls_prepared(ls_corpus, tmp_path_factory):
    """The corpus through both packages' preprocess_librispeech."""
    jax_dir = tmp_path_factory.mktemp("ls_jax")
    port_dir = tmp_path_factory.mktemp("ls_port")
    _run_jax_cli(j_prep_ls.main, ["--data_dir", str(ls_corpus),
                                  "--output_dir", str(jax_dir)] + LS_FLAGS)
    assert preprocess_librispeech.main(
        ["--data_dir", str(ls_corpus), "--output_dir", str(port_dir),
         "--device", "cpu"] + LS_FLAGS) == 0
    return str(jax_dir), str(port_dir)


def _examples(d, split):
    return list(j_records.read_shards(os.path.join(d, f"{split}-*.rnr")))


def _assert_same_prepared(jax_dir, port_dir, splits):
    for name in ("config.json", "encoder.subwords"):
        assert open(os.path.join(port_dir, name), "rb").read() == \
            open(os.path.join(jax_dir, name), "rb").read(), name
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    for split in splits:
        want, got = _examples(jax_dir, split), _examples(port_dir, split)
        assert len(got) == len(want) > 0, split
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in ("labels", "pred_inp", "spec_lengths", "label_lengths"):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g["mel_specs"].dtype == np.float32
            assert g["mel_specs"].shape == w["mel_specs"].shape
            np.testing.assert_allclose(g["mel_specs"], w["mel_specs"],
                                       rtol=0, atol=MEL_ATOL)


def test_preprocess_librispeech_matches_jax(ls_prepared):
    jax_dir, port_dir = ls_prepared
    _assert_same_prepared(jax_dir, port_dir, ("train", "dev", "test"))
    # the long utterance and the unencodable transcript were dropped
    assert len(_examples(port_dir, "train")) == 13
    assert len(_examples(port_dir, "dev")) == 3
    cfg = RNNTConfig.load(port_dir)
    assert cfg.vocab_size == 96 and cfg.token_type == "word-piece"


def test_workers_give_byte_identical_shards(ls_corpus, ls_prepared,
                                           tmp_path):
    _, serial = ls_prepared
    par = tmp_path / "par"
    assert preprocess_librispeech.main(
        ["--data_dir", str(ls_corpus), "--output_dir", str(par),
         "--device", "cpu", "--workers", "2"] + LS_FLAGS) == 0
    names = sorted(os.listdir(serial))
    assert sorted(os.listdir(par)) == names
    for name in names:
        assert (par / name).read_bytes() == \
            open(os.path.join(serial, name), "rb").read(), name


def test_unreadable_audio_fails_both_ways(ls_corpus, tmp_path):
    """A corrupt file fails the serial run and the --workers run alike:
    neither skips it."""
    corpus = tmp_path / "corpus"
    shutil.copytree(ls_corpus, corpus)
    wav = sorted(corpus.glob("dev-mini/*/*/*.wav"))[0]
    wav.write_bytes(b"not a wav file")
    for extra in ([], ["--workers", "2"]):
        with pytest.raises(Exception, match="RIFF"):
            preprocess_librispeech.main(
                ["--data_dir", str(corpus), "--output_dir",
                 str(tmp_path / f"out{len(extra)}"), "--device", "cpu"]
                + LS_FLAGS + extra)


def test_preprocess_utterance_drops_as_jax():
    """None for an empty tokenisation and for fewer stacked frames than one;
    otherwise the same example."""
    rng = np.random.default_rng(4)
    cases = [(_audio(rng, 0.5), "hello world"), (_audio(rng, 0.5), "123"),
             (_audio(rng, 0.04), "short"), (np.zeros(0), "empty audio")]
    for audio, text in cases:
        got = pipeline.preprocess_utterance(audio, 16000, text,
                                            CharTokenizer(), RNNTConfig(),
                                            device="cpu")
        want = j_pipeline.preprocess_utterance(audio, 16000, text, JChar(),
                                               JConfig())
        assert (got is None) == (want is None), text
        if got is not None:
            np.testing.assert_array_equal(got["labels"], want["labels"])
            np.testing.assert_allclose(got["mel_specs"], want["mel_specs"],
                                       rtol=0, atol=MEL_ATOL)
    with pytest.raises(ValueError, match="16000 Hz"):
        pipeline.preprocess_utterance(cases[0][0], 8000, "a", CharTokenizer(),
                                      RNNTConfig(), device="cpu")


# ------------------------------------------------------------- Common Voice

@pytest.fixture
def cv_corpus(tmp_path):
    """A TSV + clips corpus: the TSVs name .mp3 clips, the WAVs beside them
    are the converted audio; one train clip is missing."""
    base = tmp_path / "cv"
    clips = base / "clips"
    clips.mkdir(parents=True)
    rng = np.random.default_rng(11)
    for split, n in (("train", 8), ("dev", 2), ("test", 2)):
        lines = ["client_id\tpath\tsentence\tup_votes\tdown_votes"]
        for i, text in enumerate(_sentences(int(rng.integers(1 << 30)), n)):
            name = f"common_voice_en_{split}_{i:03d}"
            lines.append(f"c{i}\t{name}.mp3\t{text.capitalize()}.\t2\t0")
            if (split, i) != ("train", 5):
                write_wav(str(clips / f"{name}.wav"),
                          _audio(rng, float(rng.uniform(0.3, 0.8))).astype(
                              np.float32), 16000)
        lines.append("short row")
        (base / f"{split}.tsv").write_text("\n".join(lines) + "\n")
    return base


def test_preprocess_common_voice_matches_jax(cv_corpus, tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    flags = ["--data_dir", str(cv_corpus), "--vocab_size", "64",
             "--num_shards", "2"]
    _run_jax_cli(j_prep_cv.main, flags + ["--output_dir", str(jax_dir)])
    assert preprocess_common_voice.main(
        flags + ["--output_dir", str(port_dir), "--device", "cpu"]) == 0
    _assert_same_prepared(str(jax_dir), str(port_dir),
                          ("train", "dev", "test"))
    assert len(_examples(str(port_dir), "train")) == 7  # one clip missing


def test_remove_missing_samples_matches_jax(cv_corpus, tmp_path, capsys):
    copies = {}
    for pkg, main in (("jax", j_remove.main),
                      ("port", remove_missing_samples.main)):
        d = tmp_path / pkg
        shutil.copytree(cv_corpus, d)
        capsys.readouterr()
        rc = main(["--data_dir", str(d)])
        assert rc in ((None,) if pkg == "jax" else (0,))
        copies[pkg] = (d, capsys.readouterr().out)
    assert copies["port"][1] == copies["jax"][1]
    assert "train: removed 1 rows" in copies["port"][1]
    assert "validated: no TSV, skipped" in copies["port"][1]
    for split in ("train", "dev", "test"):
        got = (copies["port"][0] / f"{split}.tsv").read_bytes()
        assert got == (copies["jax"][0] / f"{split}.tsv").read_bytes()
    assert b"_train_005" not in (copies["port"][0] / "train.tsv").read_bytes()


# ------------------------------------------------------------- corpus tools

FAKE_FFMPEG = """#!{python}
import json, os, sys, wave
with open(os.environ["FFMPEG_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
with wave.open(sys.argv[-1], "wb") as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(16000)
    w.writeframes(b"\\0\\0" * 160)
"""


@pytest.mark.parametrize("keep", [False, True], ids=["delete", "keep_mp3"])
def test_convert_common_voice_matches_jax(keep, tmp_path, monkeypatch,
                                          capsys):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    ffmpeg = bin_dir / "ffmpeg"
    ffmpeg.write_text(FAKE_FFMPEG.format(python=sys.executable))
    ffmpeg.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    runs = {}
    for pkg, main in (("jax", j_convert.main),
                      ("port", convert_common_voice.main)):
        clips = tmp_path / pkg / "clips"
        clips.mkdir(parents=True)
        for name in ("b.mp3", "a.mp3", "notes.txt"):
            (clips / name).write_bytes(b"ID3 not really an mp3")
        log = tmp_path / f"{pkg}.log"
        monkeypatch.setenv("FFMPEG_LOG", str(log))
        capsys.readouterr()
        rc = main(["--clips_dir", str(clips), "-j", "2"]
                  + (["--keep_mp3"] if keep else []))
        assert rc in ((None,) if pkg == "jax" else (0,))
        calls = sorted(repr(json.loads(line)).replace(str(clips), "C")
                       for line in log.read_text().splitlines())
        runs[pkg] = (calls, sorted(os.listdir(clips)),
                     capsys.readouterr().out.replace(str(clips), "C"))
    assert runs["port"] == runs["jax"]
    calls, files, _ = runs["port"]
    assert len(calls) == 2 and "'-ar', '16000', '-ac', '1'" in calls[0]
    want = {"a.wav", "b.wav", "notes.txt"}
    if keep:
        want |= {"a.mp3", "b.mp3"}
    assert set(files) == want


def test_convert_common_voice_needs_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(SystemExit, match="ffmpeg not found"):
        convert_common_voice.main(["--clips_dir", str(tmp_path)])


def test_debug_dataset_prints_as_jax(ls_prepared, tmp_path, capsys):
    jax_dir, port_dir = ls_prepared
    for d in (jax_dir, port_dir):
        for split in ("train", "dev"):
            capsys.readouterr()
            assert j_debug.main(["--data_dir", d, "--split", split]) is None
            want = capsys.readouterr().out
            assert debug_dataset.main(["--data_dir", d, "--split", split]) == 0
            assert capsys.readouterr().out == want
            assert want.startswith("All checks passed.")
    # a broken example: both fail on the same lines
    bad = tmp_path / "bad"
    ex = _examples(port_dir, "dev")[0]
    ex["labels"] = np.concatenate([ex["labels"], [0]]).astype(np.int32)
    j_records.write_shards([ex], str(bad / "dev-{shard:05d}.rnr"), 1)
    with pytest.raises(SystemExit):
        j_debug.main(["--data_dir", str(bad), "--split", "dev"])
    want = capsys.readouterr().out
    assert debug_dataset.main(["--data_dir", str(bad), "--split", "dev"]) == 1
    assert capsys.readouterr().out == want and "FAIL:" in want


def test_corpus_stats_prints_as_jax(ls_corpus, capsys):
    for sub in ("train-mini", "dev-mini"):
        capsys.readouterr()
        assert j_stats.main(["--dir", str(ls_corpus / sub)]) is None
        want = capsys.readouterr().out
        assert corpus_stats.main(["--dir", str(ls_corpus / sub)]) == 0
        got = capsys.readouterr().out
        assert got == want and got.startswith("files: ")
    assert glob.glob(str(ls_corpus / "train-mini" / "*" / "*" / "*.flac"))
