"""The port's measurement entry points on the CPU (--device cpu, tiny sizes):
`rnnt_tpu_torch.bench` draws `bench.py`'s batch element for element and
prints its one JSON line; `cli.bench_loss` (all three losses),
`cli.bench_decode` (its four rows), `cli.bench_streaming` (latency and WER
modes) and `cli.bench_serve` (against a run dir written by the JAX package,
no server thread left behind) return 0 and print their JAX counterparts'
line formats.  A failing loss makes bench_loss return non-zero, the int8
flags run (bench_decode --int8, bench_serve --quantized --int8_exec; a
lone --int8_exec fails), and without CUDA every entry point raises instead
of running on the CPU."""

import json
import math
import os
import re
import threading
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.data.tokenizer import CharTokenizer
from rnnt_tpu.train import checkpoint as j_ckpt
from rnnt_tpu_torch import bench
from rnnt_tpu_torch.cli import (bench_decode, bench_loss, bench_serve,
                                bench_streaming)
from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.config import tiny_config as t_tiny_config
from rnnt_tpu_torch.data.audio_io import write_wav
from tests.torch_helpers import sharp_train_state

torch.set_num_threads(1)

CFG = tiny_config()
NUM = r"[0-9.]+"


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny run dir written by the JAX package (sharp joint, character
    tokenizer) and a 3-utterance LibriSpeech-layout corpus beside it."""
    d = str(tmp_path_factory.mktemp("bench_run"))
    j_ckpt.save_checkpoint(d, sharp_train_state(CFG, 3, 4.0), CFG)
    CharTokenizer().save(d)
    corpus = os.path.join(d, "corpus")
    chapter = os.path.join(corpus, "test-synth", "1", "10")
    os.makedirs(chapter)
    rng = np.random.default_rng(0)
    lines = []
    for i, seconds in enumerate((0.5, 0.7, 0.6)):
        n = int(16000 * seconds)
        audio = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 900)
                             * np.arange(n) / 16000.0)
        write_wav(os.path.join(chapter, f"1-10-{i:04d}.wav"),
                  audio.astype(np.float32), 16000)
        lines.append(f"1-10-{i:04d} WORD NUMBER {i}")
    with open(os.path.join(chapter, "1-10.trans.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return d, corpus


@pytest.mark.parametrize("seed", [0, 3])
def test_bench_batch_matches_bench_py_draws(seed):
    cfg = RNNTConfig(compute_dtype="bfloat16")
    B, T, U = 3, 5, 4
    # bench.py's own draws, in its order (bench.py itself draws seed 0)
    rng = np.random.default_rng(seed)
    want = {
        "mel_specs": jnp.asarray(
            rng.standard_normal((B, T, cfg.input_feat_size)), jnp.bfloat16),
        "pred_inp": jnp.asarray(
            np.concatenate([np.zeros((B, 1)), rng.integers(
                1, cfg.vocab_size, (B, U))], 1), jnp.int32),
        "labels": jnp.asarray(rng.integers(1, cfg.vocab_size, (B, U)),
                              jnp.int32),
        "spec_lengths": jnp.full((B,), T, jnp.int32),
        "label_lengths": jnp.full((B,), U, jnp.int32),
    }
    got = (bench.make_batch(cfg, B, T, U) if seed == 0
           else bench.make_batch(cfg, B, T, U, seed))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w.astype(jnp.float32) if k == "mel_specs" else w)
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k


def test_bench_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "measure", partial(
        bench.measure, cfg=t_tiny_config(compute_dtype="bfloat16"), B=2, T=8,
        U=3, n_steps=2))
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "baseline",
                        "device"}
    assert rec["metric"] == "train_audio_seconds_per_second_per_chip"
    assert rec["unit"] == "audio-s/s/chip" and rec["device"] == "cpu"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    # both are rounded from the unrounded rate
    assert abs(rec["vs_baseline"] - rec["value"] / 60.0) < 1e-3
    assert re.search(r"bench: B=2 T=8 U=3 bf16 fused, 2 steps, step "
                     r"[0-9.]+ ms", err)


def test_bench_loss_all_impls(capsys):
    assert bench_loss.main(["--B", "2", "--T", "4", "--U", "3", "--V", "16",
                            "--J", "8", "--iters", "2", "--device",
                            "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "backend=cpu B=2 T=4 U=3 V=16 J=8"
    assert len(lines) == 4
    for impl, line in zip(("ref", "pallas", "fused"), lines[1:]):
        extra = rf"  fwd {NUM} TFLOP/s" if impl == "fused" else ""
        assert re.fullmatch(rf"{impl:8s} fwd +{NUM} ms   fwd\+bwd +{NUM} "
                            rf"ms{extra}", line), line


def test_bench_loss_failing_impl_returns_nonzero(monkeypatch, capsys):
    from rnnt_tpu_torch.ops import lattice_cuda

    def boom(*a, **k):
        raise RuntimeError("lattice kernel failed")

    monkeypatch.setattr(lattice_cuda, "rnnt_loss_pallas", boom)
    assert bench_loss.main(["--B", "1", "--T", "3", "--U", "2", "--V", "8",
                            "--J", "4", "--iters", "1", "--device",
                            "cpu"]) == 1
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert lines[2] == ("pallas   failed: RuntimeError: lattice kernel "
                        "failed")
    # the impls after the failed one still run and report
    assert lines[1].startswith("ref      fwd") and len(lines) == 4
    assert lines[3].startswith("fused    fwd")
    assert "Traceback" in err


def test_bench_decode_rows(capsys):
    assert bench_decode.main(["--batch", "1", "--frames", "3", "--reps", "1",
                              "--max_output_length", "4", "--beam", "2",
                              "--no-bf16", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(rf"B=1 T'=3 vocab=4096 dtype=float32 \({NUM} "
                        r"audio-s/batch\) on cpu", lines[0]), lines[0]
    names = ["greedy", "beam-2 cuda E=1", "beam-2 cuda E=6",
             "beam-2 plain E=1"]
    assert len(lines) == 1 + len(names)
    for name, line in zip(names, lines[1:]):
        assert re.fullmatch(rf"{re.escape(f'{name:20s}')} +{NUM} ms/batch   "
                            rf" *[0-9]+ audio-s/s", line), line


@pytest.mark.parametrize("case", ["bench_decode_int8", "bench_serve_int8",
                                  "int8_exec_without_quantized"])
def test_int8_flags_refused_naming_the_slice(case, run_dir, tmp_path, capsys):
    """The int8 flags, once refused, now run: bench_decode --int8 prints the
    weight-bytes line and the JAX CLI's four int8 rows after its own,
    bench_serve serves an int8 artifact with --quantized --int8_exec, and
    --int8_exec without --quantized still fails, as the JAX server
    raises.  (Named for the refusal it asserted before
    this path was ported.)"""
    if case == "bench_decode_int8":
        assert bench_decode.main(["--batch", "1", "--frames", "3", "--reps",
                                  "1", "--max_output_length", "4", "--beam",
                                  "2", "--no-bf16", "--int8", "--device",
                                  "cpu"]) == 0
        lines = capsys.readouterr().out.splitlines()
        m = re.fullmatch(r"int8 exec: pred\+joint weights ([0-9,]+) B vs "
                         r"dequant ([0-9,]+) B", lines[0])
        assert m, lines[0]
        mixed, deq = (int(g.replace(",", "")) for g in m.groups())
        assert 3.5 < deq / mixed < 4.0  # int8 matmul weights, fp32 rest
        names = ["greedy", "beam-2 cuda E=1", "beam-2 cuda E=6",
                 "beam-2 plain E=1", "greedy int8-exec", "greedy dequant",
                 "beam-2 xla int8-exec", "beam-2 cuda dequant E=1"]
        assert len(lines) == 2 + len(names)
        for name, line in zip(names, lines[2:]):
            assert re.fullmatch(rf"{re.escape(f'{name:20s}')} +{NUM} "
                                rf"ms/batch    *[0-9]+ audio-s/s", line), line
    elif case == "bench_serve_int8":
        from rnnt_tpu_torch.cli import quantize_model

        d, _ = run_dir
        art = str(tmp_path / "model_int8.npz")
        assert quantize_model.main(["--checkpoint", d, "-o", art,
                                    "--device", "cpu"]) == 0
        capsys.readouterr()
        assert bench_serve.main(["--checkpoint", d, "--requests", "2",
                                 "--concurrency", "2", "--seconds", "0.5",
                                 "--quantized", art, "--int8_exec",
                                 "--device", "cpu"]) == 0
        lines = capsys.readouterr().out.splitlines()
        heads = ("rtt_ms: ", "cold start: ", "first beam-4 request: ",
                 "sequential: 2 reqs", "concurrent x2: 8 reqs",
                 "streaming: 7 chunks")
        assert len(lines) == len(heads)
        assert all(line.startswith(h) for h, line in zip(heads, lines))
    else:
        d, _ = run_dir
        with pytest.raises(ValueError, match="requires a quantized"):
            bench_serve.main(["--checkpoint", d, "--int8_exec", "--device",
                              "cpu"])


def test_bench_streaming_latency(capsys):
    assert bench_streaming.main(["--tiny", "--chunks", "6", "--device",
                                 "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == ["metric", "value", "unit", "p95_ms", "chunk_ms",
                         "real_time_factor", "backend", "rtt_ms"]
    assert rec["metric"] == "streaming_chunk_latency_p50"
    assert rec["backend"] == "cpu" and rec["chunk_ms"] == 64.0
    assert rec["value"] > 0 and rec["p95_ms"] >= rec["value"]


def test_bench_streaming_wer(run_dir, capsys):
    d, corpus = run_dir
    assert bench_streaming.main(["--checkpoint", d, "--audio_dir", corpus,
                                 "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == ["metric", "value", "unit", "offline_wer",
                         "streamed_wer", "n_utts", "chunk_samples", "backend",
                         "rtt_ms"]
    assert rec["metric"] == "streamed_vs_offline_wer_delta"
    assert rec["n_utts"] == 3 and rec["backend"] == "cpu"
    assert math.isfinite(rec["offline_wer"])
    assert math.isfinite(rec["streamed_wer"])
    # all three are rounded from the unrounded WERs
    assert abs(rec["value"] - (rec["streamed_wer"] - rec["offline_wer"])) \
        < 2e-4


def test_bench_serve(run_dir, capsys):
    d, _ = run_dir
    before = set(threading.enumerate())
    assert bench_serve.main(["--checkpoint", d, "--requests", "2",
                             "--concurrency", "2", "--seconds", "0.5",
                             "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    patterns = [
        rf"rtt_ms: {NUM} \(p50 of 20 scalar device round-trips; .*\)",
        rf"cold start: server up {NUM}s \(warmup {NUM}s\), first request "
        rf"{NUM}s, total-to-first-transcription {NUM}s",
        rf"first beam-4 request: {NUM}s",
        rf"sequential: 2 reqs of 0.5s audio  p50 {NUM} ms  p99 {NUM} ms  "
        rf"{NUM}x realtime at p50",
        rf"concurrent x2: 8 reqs in {NUM}s = {NUM} req/s \({NUM} audio-s/s\)"
        rf"  p50 {NUM} ms  p99 {NUM} ms",
        rf"streaming: 7 chunks of 64 ms  p50 {NUM} ms  p99 {NUM} ms per chunk",
    ]
    assert len(lines) == len(patterns)
    for pat, line in zip(patterns, lines):
        assert re.fullmatch(pat, line), line
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10)  # a handler may still be closing its socket
    left = set(threading.enumerate()) - before
    assert not left, left


@pytest.mark.parametrize("name", ["bench", "bench_loss", "bench_decode",
                                  "bench_streaming", "bench_streaming_wer",
                                  "bench_serve"])
def test_entry_points_need_cuda_by_default(name, monkeypatch, tmp_path):
    argv = {"bench": [], "bench_loss": ["--B", "1"], "bench_decode": [],
            "bench_streaming": ["--tiny"],
            "bench_streaming_wer": ["--checkpoint", str(tmp_path),
                                    "--audio_dir", str(tmp_path)],
            "bench_serve": ["--checkpoint", str(tmp_path)]}[name]
    main = {"bench": bench.main, "bench_loss": bench_loss.main,
            "bench_decode": bench_decode.main,
            "bench_streaming": bench_streaming.main,
            "bench_streaming_wer": bench_streaming.main,
            "bench_serve": bench_serve.main}[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
