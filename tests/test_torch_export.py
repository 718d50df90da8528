"""Port export (rnnt_tpu_torch.export, cli.export_model, the registered K2
operator of ops.library and decode.greedy.greedy_decode_encoded_graph) vs
the JAX package, on the CPU at the JAX export test's tiny config with a
sharpened joint (so that the model emits): the port's transcribe artifact,
exported, saved, loaded and called, gives the JAX transcribe artifact's
tokens and lengths exactly, frozen and with the weights as a runtime
argument; the streaming artifact, chunk by chunk, gives JAX's live chunked
decode's tokens and n exactly and its states within 1e-5; the graph-form
greedy equals the eager loop; the CLI's --check passes on a port
checkpoint; the operator's fake implementation gives the real outputs'
shapes and dtypes.  Every greedy step's top-2 logit margin on the port is
asserted above 1e-4, so exactness does not rest on a near tie."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu import export as jex
from rnnt_tpu.config import tiny_config
from rnnt_tpu.decode.greedy import greedy_decode_encoded as j_greedy_encoded
from rnnt_tpu.models.transducer import Transducer as JTransducer
from rnnt_tpu.models.transducer import init_transducer_params
from rnnt_tpu_torch import export as ex
from rnnt_tpu_torch.decode.greedy import (JointRecorder, greedy_decode,
                                          greedy_decode_encoded,
                                          greedy_decode_encoded_graph)
from rnnt_tpu_torch.ops import library, lstm_cuda

from torch_helpers import sharpen_joint, torch_model

torch.set_num_threads(1)

CFG = tiny_config(
    vocab_size=16, encoder_layers=2, encoder_size=24, projection_size=16,
    pred_net_layers=1, pred_net_size=24, joint_size=16, embedding_size=8,
    mel_bins=6)
MAX_OUT = 6


@pytest.fixture(scope="module")
def models():
    params = sharpen_joint(init_transducer_params(jax.random.PRNGKey(0), CFG))
    return params, torch_model(CFG, params)


def _mel(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _require_margins(model, fn):
    """fn() under a JointRecorder; every step's top-2 margin above 1e-4."""
    with JointRecorder(model) as rec, torch.no_grad():
        out = fn()
    assert rec.margins and min(rec.margins) > 1e-4, min(rec.margins)
    return out


@pytest.mark.parametrize("freeze", [True, False])
def test_transcribe_artifact_matches_jax(models, freeze, tmp_path):
    params, tm = models
    mel = _mel(1, (2, 12, CFG.input_feat_size))
    lens = np.asarray([12, 8], np.int32)
    blob, meta = jex.export_transcribe(
        params, CFG, batch=2, frames=12, max_output_length=MAX_OUT,
        platforms=["cpu"], freeze_params=freeze)
    jexp = jex.load_artifact(jex.save_artifact(str(tmp_path), "j", blob,
                                               meta))
    jargs = (jnp.asarray(mel), jnp.asarray(lens))
    want = jexp.call(*jargs) if freeze else jexp.call(params, *jargs)

    program, tmeta = ex.export_transcribe(
        tm, CFG, batch=2, frames=12, max_output_length=MAX_OUT, device="cpu",
        freeze_params=freeze)
    path = ex.save_artifact(str(tmp_path), "transcribe", program, tmeta)
    assert path.endswith("transcribe.pt2")
    side = json.load(open(os.path.join(str(tmp_path), "transcribe.json")))
    assert side["device"] == "cpu" and side["frozen_params"] == freeze
    assert side["calling_convention"] == meta["calling_convention"]
    # frozen: the weights travel in the artifact; unfrozen: none do
    assert bool(program.state_dict) == freeze
    assert "rnnt_tpu_torch.lstm_seq_infer" in str(program.graph_module.code)
    targs = (torch.from_numpy(mel), torch.from_numpy(lens))
    if not freeze:
        targs = ({n: p.detach() for n, p in tm.named_parameters()},) + targs
    artifact = ex.load_artifact(path).module()
    before = lstm_cuda.lstm_seq_infer.launches
    got = artifact(*targs)
    assert lstm_cuda.lstm_seq_infer.launches == before  # plain on the CPU
    _require_margins(tm, lambda: greedy_decode(
        tm, *targs[-2:], max_output_length=MAX_OUT))
    assert int(np.asarray(want[1]).sum()) > 0, "the sharp model emits"
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_streaming_artifact_matches_jax_live_decode(models, tmp_path):
    params, tm = models
    r = CFG.time_reduction_factor if CFG.time_reduction_index >= 0 else 1
    chunk, n_chunks = 2 * r, 4
    mel = _mel(2, (chunk * n_chunks, CFG.input_feat_size))
    program, meta = ex.export_streaming_step(
        tm, CFG, chunk_frames=chunk, max_tokens_per_chunk=8, device="cpu")
    assert meta["kind"] == "streaming_step" and meta["chunk_frames"] == chunk
    step = ex.load_artifact(ex.save_artifact(
        str(tmp_path), "streaming_step", program, meta)).module()
    jm = JTransducer(CFG)
    enc_state, pred_state = ex.streaming_init_state(CFG, device="cpu")
    carry = ex.start_carry(tm, pred_state)
    j_enc, j_pred = jex.streaming_init_state(CFG)
    j_carry = jm.predict_step(params, jnp.zeros((1,), jnp.int32), j_pred)
    emitted = 0
    for off in range(0, len(mel), chunk):
        tokens, n, enc_state, carry = step(
            torch.from_numpy(mel[off: off + chunk]), enc_state, carry)
        e, j_enc = jm.encode(params, jnp.asarray(mel[None, off: off + chunk]),
                             state=j_enc)
        j_tok, j_n, j_carry = j_greedy_encoded(
            jm, params, e, jnp.full((1,), e.shape[1], jnp.int32),
            max_output_length=8, carry=j_carry)
        assert int(n) == int(j_n[0])
        assert tokens[: int(n)].tolist() == np.asarray(j_tok)[
            0, : int(n)].tolist()
        emitted += int(n)
        got = jax.tree_util.tree_leaves(
            (enc_state, carry), is_leaf=lambda x: isinstance(x, torch.Tensor))
        for a, b in zip(got, jax.tree_util.tree_leaves((j_enc, j_carry))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
    assert emitted > 0


@pytest.mark.parametrize("with_carry", [False, True])
def test_graph_greedy_equals_eager(models, with_carry):
    _, tm = models
    mel = torch.from_numpy(_mel(3, (3, 16, CFG.input_feat_size)))
    enc_len = torch.tensor([8, 5, 1])
    with torch.no_grad():
        enc, _ = tm.encode(mel)
        carry = None
        if with_carry:  # continue from the first half's carry
            _, _, carry = greedy_decode_encoded(tm, enc[:, :4], enc_len,
                                                max_output_length=4)
        want = _require_margins(tm, lambda: greedy_decode_encoded(
            tm, enc, enc_len, max_output_length=10, carry=carry))
        got = greedy_decode_encoded_graph(tm, enc, enc_len,
                                          max_output_length=10, carry=carry)
    assert int(want[1].sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flat = [x for st in got[2][1] for x in st]
    for a, b in zip([got[2][0], *flat],
                    [want[2][0], *(x for st in want[2][1] for x in st)]):
        assert torch.equal(a, b)


def test_cli_export_check_on_a_port_checkpoint(tmp_path):
    from rnnt_tpu_torch.cli import export_model
    from rnnt_tpu_torch.config import RNNTConfig as TorchConfig
    from rnnt_tpu_torch.train.checkpoint import save_checkpoint
    from rnnt_tpu_torch.train.state import create_train_state

    tcfg = TorchConfig(**CFG.__dict__)
    run = str(tmp_path / "run")
    save_checkpoint(run, create_train_state(tcfg, device="cpu", seed=1), tcfg)
    out = str(tmp_path / "export")
    rc = export_model.main(["--checkpoint", run, "--output", out, "--device",
                            "cpu", "--batch", "2", "--frames", "12",
                            "--max_output_length", "6", "--check"])
    assert rc == 0
    for name in ("streaming_step", "transcribe"):
        assert os.path.getsize(os.path.join(out, f"{name}.pt2")) > 0
        meta = json.load(open(os.path.join(out, f"{name}.json")))
        assert meta["kind"] == name and meta["device"] == "cpu"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operator_fake_matches_real(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    T, B, H, P = 3, 2, 12, 8
    rng = np.random.default_rng(4)

    def t(shape, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dt)

    args = (t((T, B, 4 * H)), t((P, 4 * H)), t((H, P)), t((4 * H,)),
            t((B, P)), t((B, H), torch.float32))
    real = library.lstm_seq_infer(*args)
    with FakeTensorMode() as mode:
        fake = library.lstm_seq_infer(*(mode.from_tensor(a) for a in args))
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype, r.device) == (f.shape, f.dtype, f.device)
    assert real[0].dtype == dtype and real[1].dtype == torch.float32
    want = lstm_cuda.lstm_seq_infer_plain(*args)
    for r, w in zip(real, want):
        assert torch.equal(r, w)
    # no output aliases an input, also where the plain version runs no step
    empty = library.lstm_seq_infer(args[0][:0], *args[1:])
    assert empty[0].shape == (0, B, P) and empty[1] is not args[5]
    assert torch.equal(empty[1], args[5])
