"""int8 execution in the port's model and decoders vs the JAX package on the
CPU: the JAX Transducer on `int8_exec_params` against the port's Transducer
loaded with the port's `int8_exec_params` of the same quantized weights
(the prediction net and joint int8, the encoder fp).

- the prediction net's and joint's lattice logits from the JAX encoder's
  output: rtol = atol = 1e-5 in fp32, 2e-2 in bf16; in fp32 also the whole
  model's `apply`;
- greedy tokens identical: in fp32 free-running, with every step's top-2
  margin on the port's side asserted above 1e-3 so that exactness rests on
  no near tie; in bf16 in lockstep (each step on JAX's inputs), for the
  reason `test_greedy_tokens_match_jax_bf16_lockstep` gives;
- the int8 beam (`decode.beam.beam_search_encoded_xla`) against the JAX XLA
  beam on the same mixed tree (vocabulary unpruned), fp32: slot-0 tokens
  and lengths exact and scores rtol = atol = 1e-4, `test_torch_beam.py`'s
  bound; the port's smallest selection gap is asserted above 1e-5, so no
  pick rests on a near tie;
- `TranscriptionService(quantized=..., int8_exec=...)` transcribes as the
  JAX service does, greedy and beam, and `int8_exec` without `quantized`
  raises; on the sharpened model its greedy text equals JAX's greedy
  decode run free on JAX's own steps, for all 256 tokens;

Only qdot itself is bitwise across the packages (tests/test_torch_int8.py):
the elementwise functions around it differ by ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.decode.beam import beam_search_encoded as j_beam
from rnnt_tpu.decode.greedy import greedy_decode_encoded as j_greedy
from rnnt_tpu.models.transducer import Transducer as JTransducer
from rnnt_tpu.ops import quantize as JQ
from rnnt_tpu_torch.decode import beam as TB
from rnnt_tpu_torch.decode.greedy import (JointRecorder,
                                          greedy_decode_encoded)
from rnnt_tpu_torch.ops import int8_exec as TI
from rnnt_tpu_torch.ops import quantize as TQ
from tests.torch_helpers import sharpen_joint, torch_model

torch.set_num_threads(1)

CFG = tiny_config(encoder_layers=2, pred_net_layers=2)
SEED = 5
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BN = ("encoder.bn.mean", "encoder.bn.var")


def _pair(params, dtype):
    """(JAX mixed tree, port model) of `params` quantized, in `dtype`."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jtemplate = jax.tree_util.tree_map(lambda x: x.astype(jdt), params)
    jtemplate["encoder"]["bn"] = dict(params["encoder"]["bn"])
    mixed = JQ.int8_exec_params(JQ.quantize_params(params), jdt,
                                template=jtemplate)
    tm = torch_model(CFG, params)
    q = TQ.quantize_params(tm.state_dict())
    tm.cast_(tdt)
    tm.load_params_(TQ.int8_exec_params(q, tdt, template=tm.state_dict()))
    return mixed, tm


@pytest.fixture(scope="module")
def params():
    return JTransducer(CFG).init(jax.random.PRNGKey(SEED))


def test_model_holds_int8_where_jax_does(params):
    mixed, tm = _pair(params, "bfloat16")
    names = tm.int8_names()
    assert "prediction.embed" in names and "joint.w2" in names
    assert not any(n.startswith("encoder.") for n in names)
    assert tm.dtype == torch.bfloat16
    assert TI.is_quant(tm.prediction.layers[1].lstm.wh)
    assert tm.joint.b2.dtype == torch.bfloat16
    assert tm.encoder.bn.mean.dtype == torch.float32
    # a tree of plain tensors turns the int8 weights back into parameters
    tm.load_params_(TQ.dequantize_params(TQ.quantize_params(
        torch_model(CFG, params).state_dict()), torch.float32))
    assert tm.int8_names() == [] and TI.is_quant(mixed["joint"]["w2"]) is \
        False


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax(params, dtype):
    """The lattice logits of the int8 prediction net and joint from the JAX
    encoder's output (in fp32 also the whole model's `apply`)."""
    mixed, tm = _pair(params, dtype)
    jm = JTransducer(CFG)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 12, CFG.input_feat_size)).astype(
        np.float32)
    pred_inp = np.concatenate([np.zeros((2, 1), np.int32), rng.integers(
        1, CFG.vocab_size, (2, 4)).astype(np.int32)], axis=1)
    enc, _ = jm.encode(mixed, jnp.asarray(mel))
    from rnnt_tpu.models import joint as JJ
    from rnnt_tpu.models import prediction as JP
    from rnnt_tpu_torch.models import joint as TJ

    jpred, _ = JP.predict(mixed["prediction"], CFG, jnp.asarray(pred_inp))
    want = JJ.joint_logits(mixed["joint"], enc, jpred)
    with torch.no_grad():
        tpred, _ = tm.prediction(torch.from_numpy(pred_inp).long())
        got = TJ.joint_logits(tm.joint, _to_torch(enc, dtype), tpred)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(tpred.float().numpy(),
                               np.asarray(jpred, np.float32), **TOL[dtype])
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])
    if dtype == "float32":
        want, _ = jm.apply(mixed, jnp.asarray(mel), jnp.asarray(pred_inp))
        with torch.no_grad():
            got, _ = tm.apply(torch.from_numpy(mel),
                              torch.from_numpy(pred_inp).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL[dtype])


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(
        jnp.float32))).to(getattr(torch, dtype))


def test_greedy_tokens_match_jax_fp32(params):
    """fp32: the port's greedy decoding, free-running, emits JAX's tokens."""
    mixed, tm = _pair(params, "float32")
    jm = JTransducer(CFG)
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((3, 16, CFG.input_feat_size)).astype(
        np.float32)
    enc, _ = jm.encode(mixed, jnp.asarray(mel))
    lens = np.array([8, 5, 8], np.int32)
    want_tok, want_len, _ = j_greedy(jm, mixed, enc, jnp.asarray(lens),
                                     max_output_length=24)
    with torch.no_grad(), JointRecorder(tm) as rec:
        tok, ln, _ = greedy_decode_encoded(
            tm, _to_torch(enc, "float32"), torch.from_numpy(lens),
            max_output_length=24)
    assert min(rec.margins) > 1e-3
    np.testing.assert_array_equal(ln.numpy(), np.asarray(want_len))
    assert ln.sum() > 0
    for b in range(3):
        np.testing.assert_array_equal(tok[b, : ln[b]].numpy(),
                                      np.asarray(want_tok)[b, : ln[b]])


def test_greedy_tokens_match_jax_bf16_lockstep(params):
    """bf16: at every step of a greedy decode driven by JAX's steps, the
    port's joint_step and predict_step on JAX's own inputs (encoder frame,
    prediction output and state) agree to 2e-2 and pick JAX's token
    wherever JAX's top-2 margin exceeds twice their difference.  A
    free-running comparison is not exact in bf16: XLA's tanh differs from
    PyTorch's by an ulp on most fp32 inputs, which in time flips a bf16
    rounding of the recurrent h, and the next int8 requantization turns
    that flip into logit changes of ~1e-2 (with this seed after 17 steps).
    JAX's own jitted greedy decode parts from its eager steps here for the
    same reason (XLA's fusion), so the reference is the eager steps."""
    mixed, tm = _pair(params, "bfloat16")
    jm = JTransducer(CFG)
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((3, 16, CFG.input_feat_size)).astype(
        np.float32)
    # bf16 activations on both sides, as the port's bf16 encoder gives them
    enc = jm.encode(mixed, jnp.asarray(mel))[0].astype(jnp.bfloat16)
    lens = np.array([8, 5, 8], np.int32)
    L = 24
    tol = TOL["bfloat16"]
    steps = emitted = 0
    for b in range(3):
        state = jm.prediction_zero_state(1, enc.dtype)
        out, state = jm.predict_step(mixed, jnp.zeros((1,), jnp.int32),
                                     state)
        tokens = []
        for t in range(int(lens[b])):
            enc_t = enc[b: b + 1, t]
            for _ in range(CFG.max_symbols_per_frame):
                want = np.asarray(jm.joint_step(mixed, enc_t, out))
                with torch.no_grad():
                    got = tm.joint_step(_to_torch(enc_t, "bfloat16"),
                                        _to_torch(out, "bfloat16")).numpy()
                np.testing.assert_allclose(got, want, **tol)
                k = int(np.argmax(want))
                top2 = np.sort(want[0])[-2:]
                if top2[1] - top2[0] > 2 * np.abs(got - want).max():
                    assert int(np.argmax(got)) == k
                steps += 1
                if k == 0 or len(tokens) == L:
                    break
                tokens.append(k)
                ids = jnp.asarray([k], jnp.int32)
                new_out, new_state = jm.predict_step(mixed, ids, state)
                with torch.no_grad():
                    t_out, t_state = tm.predict_step(
                        torch.tensor([k]),
                        [(_to_torch(c, "float32"), _to_torch(h, "bfloat16"))
                         for c, h in state])
                np.testing.assert_allclose(t_out.float().numpy(),
                                           np.asarray(new_out, np.float32),
                                           **tol)
                for (tc, th), (jc, jh) in zip(t_state, new_state):
                    np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                               **tol)
                    np.testing.assert_allclose(
                        th.float().numpy(), np.asarray(jh, np.float32),
                        **tol)
                out, state = new_out, new_state
        emitted += len(tokens)
    assert steps > 30 and emitted > 0


@pytest.mark.parametrize("K, E", [(2, 1), (4, 3)])
def test_int8_beam_matches_jax_xla_beam(params, K, E):
    sharp = sharpen_joint(params, 4.0)
    mixed, tm = _pair(sharp, "float32")
    jm = JTransducer(CFG)
    lens = np.array([9, 4, 1, 9], np.int32)
    enc = (np.random.default_rng(7).standard_normal(
        (len(lens), 9, CFG.projection_size)) * 2.0).astype(np.float32)
    want = j_beam(jm, mixed, jnp.asarray(enc), jnp.asarray(lens),
                  beam_width=K, max_output_length=8, expansions_per_frame=E,
                  prune_vocab=CFG.vocab_size)
    stats = {}
    tok, ln, sc = TB.beam_search_encoded_xla(
        tm, torch.from_numpy(enc), torch.from_numpy(lens), beam_width=K,
        max_output_length=8, expansions_per_frame=E, stats=stats)
    assert stats["min_gap"] > 1e-5
    wtok, wln, wsc = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ln.numpy(), wln)
    assert ln.sum() > 0
    for b in range(len(lens)):
        np.testing.assert_array_equal(tok[b, : ln[b]].numpy(),
                                      wtok[b, : ln[b]])
    np.testing.assert_allclose(sc.numpy(), wsc, rtol=1e-4, atol=1e-4)
    # the same search through beam_search_decode's choice by weight kind
    assert TB.search_by_kind(tm) is TB.beam_search_encoded_xla


def test_int8_beam_is_never_a_route_for_fp_weights(params):
    tm = torch_model(CFG, params)
    enc = torch.zeros((1, 3, CFG.projection_size))
    lens = torch.tensor([3])
    with pytest.raises(ValueError, match="int8 search"):
        TB.beam_search_encoded_xla(tm, enc, lens, beam_width=2,
                                   max_output_length=4,
                                   expansions_per_frame=1)
    assert TB.search_by_kind(tm) is not TB.beam_search_encoded_xla
    _, mixed = _pair(params, "float32")
    from rnnt_tpu_torch.ops.beam_cuda import beam_search

    with pytest.raises(ValueError, match="int8"):  # K3 reads fp weights
        beam_search(mixed, enc, lens, beam_width=2, max_output_length=4,
                    expansions_per_frame=1)
    with pytest.raises(ValueError, match="int8"):  # so does the loss
        from rnnt_tpu_torch.train.steps import batch_loss

        batch_loss(mixed, mixed.cfg, {
            "mel_specs": torch.zeros((1, 4, CFG.input_feat_size)),
            "pred_inp": torch.zeros((1, 2), dtype=torch.long),
            "labels": torch.ones((1, 1), dtype=torch.long),
            "spec_lengths": torch.tensor([4]),
            "label_lengths": torch.tensor([1])}, training=False)


@pytest.fixture(scope="module")
def served_int8(tmp_path_factory):
    """Two run dirs written by the JAX package with their int8 artifacts: a
    random model (seed 6, long greedy decodes) and one whose joint is
    sharpened 4x (so that beam hypotheses emit)."""
    from rnnt_tpu.data.tokenizer import CharTokenizer
    from rnnt_tpu.train import checkpoint as j_ckpt
    from rnnt_tpu.train.state import create_train_state
    from tests.torch_helpers import sharp_train_state

    cfg = tiny_config()
    runs = {}
    for name, state in (
            ("random", create_train_state(jax.random.PRNGKey(6), cfg)),
            ("sharp", sharp_train_state(cfg, 3, 4.0))):
        d = str(tmp_path_factory.mktemp(f"int8_{name}"))
        j_ckpt.save_checkpoint(d, state, cfg)
        CharTokenizer().save(d)
        art = str(tmp_path_factory.mktemp(f"int8_{name}_art")
                  / "model_int8.npz")
        JQ.save_quantized(art, JQ.quantize_params(state.params))
        runs[name] = (d, art)
    rng = np.random.default_rng(4)
    audios = []
    for seconds in (0.55, 1.1):
        n = int(16000 * seconds)
        t = np.arange(n) / 16000.0
        audios.append((0.3 * np.sin(2 * np.pi * rng.uniform(200, 900) * t)
                       + 0.05 * rng.standard_normal(n)).astype(np.float32))
    return runs, audios


@pytest.mark.parametrize("int8_exec", [False, True])
def test_service_transcribes_as_jax(served_int8, int8_exec):
    """Greedy on the random model (decodes of 346 and 436 characters) and
    ?beam=2 on the sharpened one, each equal to the JAX service's text.
    Greedy on the sharpened model: `test_service_sharpened_greedy_matches_
    jax_steps`."""
    from rnnt_tpu.serve import TranscriptionService as JService
    from rnnt_tpu_torch.serve import TranscriptionService

    runs, audios = served_int8
    texts = []
    for name, beam in (("random", 0), ("sharp", 2)):
        d, art = runs[name]
        js = JService(d, quantized=art, int8_exec=int8_exec, max_t_pad=128)
        ts = TranscriptionService(d, device="cpu", quantized=art,
                                  int8_exec=int8_exec, max_t_pad=128)
        assert ts.info()["quantized"] is True
        assert ts.info()["int8_exec"] is int8_exec
        assert bool(ts.model.int8_names()) is int8_exec
        for audio in audios:
            want = js.transcribe(audio, 16000, beam=beam)
            assert ts.transcribe(audio, 16000, beam=beam) == want
            texts.append(want)
        st = ts.new_stream()  # the TCP port's transcriber, the same model
        for o in range(0, len(audios[1]), 1024):
            st.process_chunk(audios[1][o: o + 1024])
        assert isinstance(st.flush(), str)
    assert all(texts)


def test_int8_exec_without_quantized_raises(served_int8):
    from rnnt_tpu_torch.serve import Server, TranscriptionService

    d, _ = served_int8[0]["random"]
    with pytest.raises(ValueError, match="requires a quantized artifact"):
        TranscriptionService(d, device="cpu", int8_exec=True)
    with pytest.raises(ValueError, match="requires a quantized artifact"):
        Server(d, http_port=0, stream_port=0, device="cpu", int8_exec=True)


def _jax_step_greedy(js, tm, audio):
    """JAX's greedy decode of one request as its service pads it, run free on
    the JAX model's own joint_step and predict_step, each jitted alone.
    Returns
    (text, smallest top-2 margin of JAX's logits over the steps, largest
    |difference| of the port's `tm.joint_step` on the same inputs, the
    lockstep gap)."""
    from rnnt_tpu.ops import features as JF

    cfg, jm, params = js.cfg, js.model, js.state.params
    joint_step, predict_step = jax.jit(jm.joint_step), jax.jit(
        jm.predict_step)
    mel = np.asarray(JF.preprocess_audio(jnp.asarray(audio), cfg))
    t = mel.shape[0]
    mel_p = np.zeros((1, max(64, 1 << (t - 1).bit_length()), mel.shape[1]),
                     np.float32)
    mel_p[0, :t] = mel
    enc, _ = jm.encode(params, jnp.asarray(mel_p))
    out, state = predict_step(params, jnp.zeros((1,), jnp.int32),
                              jm.prediction_zero_state(1, enc.dtype))
    ids, margin, gap = [], np.inf, 0.0
    for ti in range(int(jm.encoded_length(jnp.asarray([t]))[0])):
        for _ in range(cfg.max_symbols_per_frame):
            want = np.asarray(joint_step(params, enc[:, ti], out))
            with torch.no_grad():
                got = tm.joint_step(_to_torch(enc[:, ti], "float32"),
                                    _to_torch(out, "float32")).numpy()
            top2 = np.sort(want[0])[-2:]
            margin = min(margin, float(top2[1] - top2[0]))
            gap = max(gap, float(np.abs(got - want).max()))
            k = int(np.argmax(want))
            if k == 0 or len(ids) == 256:  # the service's max_output_length
                break
            ids.append(k)
            out, state = predict_step(params, jnp.asarray([k], jnp.int32),
                                      state)
    return js.tokenizer.decode(ids), margin, gap


@pytest.mark.parametrize("int8_exec", [False, True])
def test_service_sharpened_greedy_matches_jax_steps(served_int8, int8_exec):
    """Greedy on the sharpened model (256-token decodes): the port's service
    text equals JAX's greedy decode run free on JAX's own steps, every
    step's JAX top-2 margin above twice the lockstep gap (the port's
    joint_step against JAX's on JAX's inputs), so no token rests on a near
    tie.  The JAX service's jitted decode is held up to the first character
    where it parts from those steps: under int8 execution it does so on the
    0.55 s request at character 110, by XLA's fusion of the loop (a JAX-only
    difference, as `test_greedy_tokens_match_jax_bf16_lockstep` finds)."""
    from rnnt_tpu.serve import TranscriptionService as JService
    from rnnt_tpu_torch.serve import TranscriptionService

    runs, audios = served_int8
    d, art = runs["sharp"]
    js = JService(d, quantized=art, int8_exec=int8_exec, max_t_pad=128)
    ts = TranscriptionService(d, device="cpu", quantized=art,
                              int8_exec=int8_exec, max_t_pad=128)
    for audio in audios:
        got = ts.transcribe(audio, 16000)
        steps, margin, gap = _jax_step_greedy(js, ts.model, audio)
        assert margin > 2 * gap and len(steps) == 256
        assert got == steps
        jit = js.transcribe(audio, 16000)
        n = next((i for i, (a, b) in enumerate(zip(jit, steps)) if a != b),
                 len(jit))
        assert n >= 100 and got[:n] == jit[:n]
