"""Port Transducer pieces and greedy decoding vs the JAX Transducer at
tiny_config(), parameters carried by params_from_numpy.  fp32 on the CPU:
rtol = atol = 1e-5; greedy tokens exact, with every step's top-2 logit
margin asserted above 1e-3 so that exactness does not rest on a near tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.decode.greedy import greedy_decode as j_greedy
from rnnt_tpu.models import joint as JJ
from rnnt_tpu.models.transducer import Transducer as JTransducer
from rnnt_tpu_torch.decode.greedy import JointRecorder
from rnnt_tpu_torch.decode.greedy import greedy_decode as t_greedy
from rnnt_tpu_torch.models import joint as TJ
from tests.torch_helpers import torch_model

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = tiny_config()
SEED = 9  # chosen so that every greedy step's top-2 margin exceeds 1e-3


@pytest.fixture(scope="module")
def models():
    jm = JTransducer(CFG)
    params = jm.init(jax.random.PRNGKey(SEED))
    return jm, params, torch_model(CFG, params)


def _mel(b, t, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, t, CFG.input_feat_size)).astype(np.float32)


@pytest.mark.parametrize("t", [9, 16])  # odd T exercises the TR zero pad
def test_encode_parity(models, t):
    jm, params, tm = models
    mel = _mel(2, t)
    want, want_state = jm.encode(params, jnp.asarray(mel))
    with torch.no_grad():
        got, got_state = tm.encode(torch.from_numpy(mel))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for (tc, th), (jc, jh) in zip(got_state, want_state):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    lens = np.array([t, t - 3], np.int32)
    np.testing.assert_array_equal(
        tm.encoded_length(torch.from_numpy(lens)).numpy(),
        np.asarray(jm.encoded_length(jnp.asarray(lens))))


def test_predict_and_joint_parity(models):
    jm, params, tm = models
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, CFG.vocab_size, 4).astype(np.int32)
    jout, jstate = jm.predict_step(params, jnp.asarray(tokens),
                                   jm.prediction_zero_state(4))
    jout2, _ = jm.predict_step(params, jnp.asarray(tokens[::-1].copy()),
                               jstate)
    with torch.no_grad():
        tout, tstate = tm.predict_step(torch.from_numpy(tokens).long(),
                                       tm.prediction_zero_state(4))
        tout2, _ = tm.predict_step(
            torch.from_numpy(tokens[::-1].copy()).long(), tstate)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tout2.numpy(), np.asarray(jout2), **TOL)

    enc = rng.standard_normal((4, CFG.projection_size)).astype(np.float32)
    with torch.no_grad():
        got = tm.joint_step(torch.from_numpy(enc), tout)
    want = jm.joint_step(params, jnp.asarray(enc), jout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    enc3 = rng.standard_normal((2, 5, CFG.projection_size)).astype(np.float32)
    pred3 = rng.standard_normal((2, 3, CFG.projection_size)).astype(np.float32)
    with torch.no_grad():
        got = TJ.joint_logits(tm.joint, torch.from_numpy(enc3),
                              torch.from_numpy(pred3))
    want = JJ.joint_logits(params["joint"], jnp.asarray(enc3),
                           jnp.asarray(pred3))
    assert tuple(got.shape) == want.shape == (2, 5, 3, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_greedy_tokens_match_jax(models):
    jm, params, tm = models
    mel = _mel(3, 24, seed=2)
    lens = np.array([24, 17, 9], np.int32)
    want_tok, want_len = j_greedy(jm, params, jnp.asarray(mel),
                                  jnp.asarray(lens), max_output_length=64)
    with torch.no_grad(), JointRecorder(tm) as rec:
        got_tok, got_len = t_greedy(tm, torch.from_numpy(mel),
                                    torch.from_numpy(lens),
                                    max_output_length=64)
    assert min(rec.margins) > 1e-3, min(rec.margins)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    assert len(set(got_len.tolist())) > 1  # unequal lengths really decoded
