"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless asked for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = f"""
import sys
sys.path.insert(0, {REPO!r})
assert "jax" not in sys.modules
import rnnt_tpu_torch, rnnt_tpu_torch.serve, rnnt_tpu_torch.cli.serve
import rnnt_tpu_torch.ops.features_cuda, rnnt_tpu_torch.ops.lstm_cuda
import rnnt_tpu_torch.decode.beam, rnnt_tpu_torch.ops.beam_cuda
import rnnt_tpu_torch.decode.streaming
import rnnt_tpu_torch.cli.transcribe_file
import rnnt_tpu_torch.cli.streaming_transcribe
import rnnt_tpu_torch.cli.run_rnnt, rnnt_tpu_torch.train.loop
import rnnt_tpu_torch.train.steps, rnnt_tpu_torch.train.state
import rnnt_tpu_torch.train.checkpoint, rnnt_tpu_torch.train.observe
import rnnt_tpu_torch.ops.rnnt_loss, rnnt_tpu_torch.ops.rnnt_loss_ref
import rnnt_tpu_torch.ops.lattice_cuda, rnnt_tpu_torch.ops.planes_cuda
import rnnt_tpu_torch.ops.joint_loss_fused, rnnt_tpu_torch.ops.matmul
import rnnt_tpu_torch.data.records, rnnt_tpu_torch.data.pipeline
import rnnt_tpu_torch.metrics.edit_distance, rnnt_tpu_torch.kernels.lstm_ab
import rnnt_tpu_torch.kernels.beam_ab
import rnnt_tpu_torch.bench, rnnt_tpu_torch.cli.benchutil
import rnnt_tpu_torch.cli.bench_decode, rnnt_tpu_torch.cli.bench_loss
import rnnt_tpu_torch.cli.bench_streaming, rnnt_tpu_torch.cli.bench_serve
import rnnt_tpu_torch.data.librispeech
import rnnt_tpu_torch.ops.int8_exec, rnnt_tpu_torch.ops.quantize
import rnnt_tpu_torch.native, rnnt_tpu_torch.native.build
import rnnt_tpu_torch.native.flac, rnnt_tpu_torch.native.loss
import rnnt_tpu_torch.cli.quantize_model
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "rnnt_tpu" or m.startswith("rnnt_tpu."))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_jax_package():
    # -I: no user site and no PYTHONPATH, so nothing imports JAX for us
    r = subprocess.run([sys.executable, "-I", "-c", _PROBE],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from rnnt_tpu_torch.cli import run_rnnt, streaming_transcribe, \
        transcribe_file
    from rnnt_tpu_torch.config import tiny_config
    from rnnt_tpu_torch.serve import Server, TranscriptionService
    from rnnt_tpu_torch.train.checkpoint import init_from_checkpoint, \
        restore_checkpoint
    from rnnt_tpu_torch.train.state import create_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TranscriptionService(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(str(tmp_path), http_port=0, stream_port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transcribe_file.main(["--checkpoint", str(tmp_path), "-i", "a.wav"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        streaming_transcribe.main(["--checkpoint", str(tmp_path),
                                   "--simulate_file", "a.wav"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_rnnt.main(["--data_dir", str(tmp_path)])
    from rnnt_tpu_torch.cli import quantize_model

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quantize_model.main(["--checkpoint", str(tmp_path)])
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_checkpoint(str(tmp_path), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_from_checkpoint(str(tmp_path), cfg)
