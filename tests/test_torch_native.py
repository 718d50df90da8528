"""The port's native C++ pieces (rnnt_tpu_torch.native, its own copies of
the sources, built by its own build.py) vs the JAX package's on the CPU:
FLAC decoding of each subframe type of tests/flac_fixture.py's encoder
gives the JAX decoder's samples exactly, `data.audio_io.read_audio` reads
.flac through it, and the OpenMP RNN-T loss oracle agrees with the JAX
package's oracle and with the port's plain lattice (`ops.rnnt_loss_ref`)
at the tolerances of tests/test_native.py (loss rtol = atol = 1e-4,
gradient rtol 1e-3, atol 1e-4)."""

import os

import numpy as np
import pytest
import torch

from tests.flac_fixture import encode_flac

torch.set_num_threads(1)


def _samples(kind, n=1000):
    rng = np.random.default_rng(42)
    if kind == "constant":
        return np.full(n, -1234, np.int64)
    if kind == "fixed2":
        t = np.arange(n)
        return (100 * np.sin(t / 25) * 50
                + rng.integers(-20, 20, n)).astype(np.int64)
    return rng.integers(-30000, 30000, n).astype(np.int64)


@pytest.mark.parametrize("kind", ["verbatim", "constant", "fixed2"])
def test_flac_matches_the_jax_decoder(tmp_path, kind):
    from rnnt_tpu.native.flac import read_flac as j_read_flac
    from rnnt_tpu_torch.native.flac import read_flac

    samples = _samples(kind)
    path = str(tmp_path / f"{kind}.flac")
    with open(path, "wb") as f:
        f.write(encode_flac(samples, subframe_type=kind))
    audio, sr = read_flac(path)
    want, want_sr = j_read_flac(path)
    assert sr == want_sr == 16000
    assert audio.dtype == np.float32 and audio.shape == (len(samples),)
    np.testing.assert_array_equal(audio, want)
    np.testing.assert_array_equal(audio, (samples / 32768.0).astype(
        np.float32))


def test_read_audio_reads_flac(tmp_path):
    from rnnt_tpu_torch.data.audio_io import read_audio, write_wav

    samples = np.random.default_rng(0).integers(-1000, 1000, 500)
    path = str(tmp_path / "x.FLAC")
    with open(path, "wb") as f:
        f.write(encode_flac(samples))
    audio, sr = read_audio(path)
    assert sr == 16000
    np.testing.assert_array_equal(audio, (samples / 32768.0).astype(
        np.float32))
    wav = str(tmp_path / "x.wav")
    write_wav(wav, audio, 16000)
    assert read_audio(wav)[1] == 16000


def test_flac_decode_errors_raise(tmp_path):
    from rnnt_tpu_torch.native.flac import read_flac

    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"RIFF0000WAVE")
    with pytest.raises(ValueError, match="FLAC decode failed"):
        read_flac(str(bad))
    with pytest.raises(ValueError, match="FLAC decode failed"):
        read_flac(str(tmp_path / "missing.flac"))


def test_native_build_is_the_ports_own():
    from rnnt_tpu_torch.native import build

    path = build.build()
    assert os.path.exists(path)
    assert os.sep + os.path.join("rnnt_tpu_torch", "_build", "native") \
        in path
    here = os.path.dirname(build.__file__)
    for src in build._SOURCES:
        assert os.path.exists(os.path.join(here, src))


def _lattice(seed, B, T, U, V):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    fl = np.array([T, T - 2, T - 1][:B], np.int32)
    yl = np.array([U, U - 1, 0][:B], np.int32)
    return logits, labels, fl, yl


@pytest.mark.parametrize("B, T, U, V", [(3, 7, 4, 9), (2, 5, 3, 6)])
def test_loss_oracle_matches_jax_oracle_and_plain_lattice(B, T, U, V):
    from rnnt_tpu.native.loss import rnnt_loss_cpu as j_loss_cpu
    from rnnt_tpu_torch.native.loss import rnnt_loss_cpu
    from rnnt_tpu_torch.ops.rnnt_loss_ref import rnnt_loss_ref

    logits, labels, fl, yl = _lattice(B + T, B, T, U, V)
    loss, grad = rnnt_loss_cpu(logits, labels, fl, yl, with_grad=True)
    j_loss, j_grad = j_loss_cpu(logits, labels, fl, yl, with_grad=True)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(grad, j_grad, rtol=1e-3, atol=1e-4)
    x = torch.from_numpy(logits).requires_grad_(True)
    ref = rnnt_loss_ref(x, torch.from_numpy(labels).long(),
                        torch.from_numpy(fl).long(),
                        torch.from_numpy(yl).long())
    ref.sum().backward()
    np.testing.assert_allclose(loss, ref.detach().numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(grad, x.grad.numpy(), rtol=1e-3, atol=1e-4)
    # without a gradient the same losses
    alone, none = rnnt_loss_cpu(logits, labels, fl, yl)
    assert none is None
    np.testing.assert_array_equal(alone, loss)


def test_loss_oracle_checks_label_shape():
    from rnnt_tpu_torch.native.loss import rnnt_loss_cpu

    logits, labels, fl, yl = _lattice(0, 2, 5, 3, 6)
    with pytest.raises(ValueError, match="labels"):
        rnnt_loss_cpu(logits, labels[:, :2], fl, yl)
