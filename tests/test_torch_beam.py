"""Port beam search (rnnt_tpu_torch.decode.beam, the plain version of the
CUDA kernel, on the CPU) vs the JAX searches: the XLA search
(beam_search_encoded, vocabulary unpruned) and the Pallas kernel in
interpret mode.  fp32 on the CPU.  Slot-0 tokens and lengths exact; all K
beam scores rtol = atol = 1e-4, the JAX package's own bound between its two
searches.  The exact token comparison rests on no selection being a near
tie: the port's smallest gap between consecutive candidates is asserted
above 1e-5.

The model is the JAX ragged-length test's random model with its joint output
layer sharpened 8x, so every utterance emits a few tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.decode.beam import beam_search_encoded as j_beam
from rnnt_tpu.models.transducer import Transducer, init_transducer_params
from rnnt_tpu.ops.beam_pallas import beam_search_encoded_pallas as j_pallas
from rnnt_tpu_torch.decode import beam as TB
from tests.torch_helpers import sharpen_joint, torch_model

torch.set_num_threads(1)

CFG = tiny_config(vocab_size=24, encoder_layers=2, encoder_size=16,
                  projection_size=8, pred_net_layers=2, pred_net_size=16,
                  joint_size=8, embedding_size=8, mel_bins=4)
LENS = np.array([9, 4, 1, 9, 6], np.int32)
L = 8
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def sharp():
    params = sharpen_joint(init_transducer_params(jax.random.PRNGKey(3), CFG))
    enc = (np.random.default_rng(7).standard_normal(
        (len(LENS), 9, CFG.projection_size)) * 2.0).astype(np.float32)
    return Transducer(CFG), params, torch_model(CFG, params), enc


def _port(tm, enc, lens, K, E, merge, length=L):
    stats = {}
    tok, ln, sc = TB.beam_search_encoded_plain(
        tm, torch.from_numpy(enc), torch.from_numpy(lens), beam_width=K,
        max_output_length=length, expansions_per_frame=E,
        merge_duplicates=merge, stats=stats)
    return tok.numpy(), ln.numpy(), sc.numpy(), stats


def _same(got, want):
    tok, ln, sc = got
    wtok, wln, wsc = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ln, wln)
    for b in range(len(ln)):
        np.testing.assert_array_equal(tok[b, : ln[b]], wtok[b, : ln[b]])
    np.testing.assert_allclose(sc, wsc, **TOL)


@pytest.mark.parametrize("K,E,merge", [
    (2, 1, True), (4, 1, True), (3, 3, True), (4, 1, False), (3, 3, False)])
def test_plain_matches_xla_search(sharp, K, E, merge):
    jm, params, tm, enc = sharp
    tok, ln, sc, stats = _port(tm, enc, LENS, K, E, merge)
    want = j_beam(jm, params, jnp.asarray(enc), jnp.asarray(LENS),
                  beam_width=K, max_output_length=L, expansions_per_frame=E,
                  prune_vocab=CFG.vocab_size - 1, merge_duplicates=merge)
    _same((tok, ln, sc), want)
    assert stats["min_gap"] > 1e-5, stats
    assert ln.sum() > 0  # the sharp model emits


@pytest.mark.parametrize("K,E", [(4, 1), (3, 3)])
def test_plain_matches_pallas_kernel(sharp, K, E):
    jm, params, tm, enc = sharp
    tok, ln, sc, stats = _port(tm, enc, LENS, K, E, True)
    want = j_pallas(jm, params, jnp.asarray(enc), jnp.asarray(LENS),
                    beam_width=K, max_output_length=L, expansions_per_frame=E,
                    merge_duplicates=True, interpret=True)
    _same((tok, ln, sc), want)
    assert stats["min_gap"] > 1e-5, stats


def test_merges_happen(sharp):
    _, _, tm, enc = sharp
    merged = sum(_port(tm, enc, LENS, K, E, True)[3]["merges"]
                 for K, E in ((4, 1), (3, 3)))
    assert merged > 0


def test_length_cap(sharp):
    # a cap of one token: label moves stop, blanks still settle
    jm, params, tm, enc = sharp
    tok, ln, sc, _ = _port(tm, enc, LENS, 2, 1, True, length=1)
    # every utterance of more than one frame reaches the cap
    np.testing.assert_array_equal(ln[LENS > 1], 1)
    assert ln.max() == 1
    want = j_beam(jm, params, jnp.asarray(enc), jnp.asarray(LENS),
                  beam_width=2, max_output_length=1, expansions_per_frame=1,
                  prune_vocab=CFG.vocab_size - 1)
    _same((tok, ln, sc), want)


def test_all_blank_model_decodes_empty(sharp):
    jm, params, _, enc = sharp
    blank = dict(params, joint=dict(params["joint"],
                                    b2=params["joint"]["b2"].at[0].set(100.0)))
    _, ln, _, _ = _port(torch_model(CFG, blank), enc, LENS, 2, 2, True)
    np.testing.assert_array_equal(ln, 0)


def test_single_utterance_equals_row_of_batch(sharp):
    _, _, tm, enc = sharp
    tok, ln, sc, _ = _port(tm, enc, LENS, 4, 2, True)
    tok1, ln1, sc1, _ = _port(tm, enc[:1], LENS[:1], 4, 2, True)
    assert ln1[0] == ln[0]
    np.testing.assert_array_equal(tok1[0, : ln1[0]], tok[0, : ln[0]])
    np.testing.assert_array_equal(sc1[0], sc[0])


def test_decode_defaults_and_dispatch(sharp):
    # beam_search_decode: E = min(max_symbols_per_frame, 6), merge on; a CPU
    # tensor takes the plain search
    _, _, tm, _ = sharp
    mel = np.random.default_rng(1).standard_normal(
        (2, 12, CFG.input_feat_size)).astype(np.float32)
    lens = torch.tensor([12, 7])
    with torch.no_grad():
        tok, ln, sc = TB.beam_search_decode(tm, torch.from_numpy(mel), lens,
                                            beam_width=3, max_output_length=L)
        enc, _ = tm.encode(torch.from_numpy(mel))
        want = TB.beam_search_encoded_plain(
            tm, enc, tm.encoded_length(lens), beam_width=3,
            max_output_length=L,
            expansions_per_frame=min(CFG.max_symbols_per_frame, 6))
    for got, w in zip((tok, ln, sc), want):
        assert torch.equal(got, w)
    assert tok.dtype == torch.int32 and sc.shape == (2, 3)



def test_trace_records_every_selection(sharp):
    # E * 2 selections a frame (labels, then the pool); an utterance's last
    # pool selection is its final beam; blank is never a label
    _, _, tm, enc = sharp
    K, E = 3, 2
    tok, ln, sc, stats = _port(tm, enc, LENS, K, E, True)
    S = LENS.max() * E * 2
    assert stats["idx"].shape == (S, len(LENS), K)
    assert stats["val"].shape == (S, len(LENS), K)
    assert stats["gap"].shape == (S, len(LENS))
    for b, n in enumerate(LENS):
        np.testing.assert_array_equal(stats["val"][n * E * 2 - 1, b], sc[b])
    labels = stats["idx"][0::2]
    live = stats["val"][0::2] > TB.NEG / 2
    assert bool((labels[live] % CFG.vocab_size != 0).all())
    assert stats["min_gap"] == float(stats["gap"].min())


def test_trace_divergence_finds_first_differing_pick(sharp):
    _, _, tm, enc = sharp
    stats = _port(tm, enc, LENS, 3, 2, True)[3]
    lens = torch.from_numpy(LENS)
    assert TB.trace_divergence(stats, stats, lens, 2) == [(None, 0.0)] * 5
    other = {k: stats[k].clone() for k in ("idx", "val")}
    other["idx"][5, 3, 1] += 1      # a different pick at selection 5
    other["val"][2, 3, 0] += 0.25   # a shared pick scored otherwise before it
    other["idx"][30, 1, 0] += 1     # past utterance 1's 4 frames: ignored
    div = TB.trace_divergence(other, stats, lens, 2)
    assert div[3] == (5, pytest.approx(0.25))
    assert div[1] == (None, 0.0)


def test_beam_gate_holds_plain_and_rejects_swapped_w2(sharp):
    # the chip smoke's K3 gate: the plain search passes against itself; the
    # search on W2 with its 16-byte groups' halves swapped fails
    import chip_smoke

    _, _, tm, enc = sharp
    e, lens = torch.from_numpy(enc), torch.from_numpy(LENS)
    kw = dict(beam_width=3, max_output_length=L, expansions_per_frame=2)
    stats2, stats3 = {}, {}
    got = TB.beam_search_encoded_plain(tm, e, lens, stats=stats2, **kw)
    want, stats = chip_smoke.plain_along(tm, e, lens, stats2, kw)
    V = CFG.vocab_size
    fails, notes, _, rel = chip_smoke.gate_beam(got, stats2, want, stats,
                                                lens, 2, V, 1e-4)
    assert fails == [] and notes == [] and rel == 0.0
    with chip_smoke.swapped_w2_halves(tm):
        bad = TB.beam_search_encoded_plain(tm, e, lens, stats=stats3, **kw)
    want, stats = chip_smoke.plain_along(tm, e, lens, stats3, kw)
    fails, _, _, _ = chip_smoke.gate_beam(bad, stats3, want, stats, lens, 2,
                                          V, 1e-2)
    assert any("not a near tie" in f for f in fails), fails


@pytest.mark.parametrize("K,E", [(4, 1), (3, 3)])
def test_follow_scores_another_searchs_path(sharp, K, E):
    """`follow`: along its own trace the search reproduces itself (slack
    0); along the trace of a search on other weights it takes that search's
    picks and tokens, scores them on its own weights, and its slack shows
    the selections where they leave its own top K."""
    jm, params, tm, enc = sharp
    tok, ln, sc, stats = _port(tm, enc, LENS, K, E, True)
    kw = dict(beam_width=K, max_output_length=L, expansions_per_frame=E)
    again = {}
    tok2, ln2, sc2 = TB.beam_search_encoded_plain(
        tm, torch.from_numpy(enc), torch.from_numpy(LENS), stats=again,
        follow=stats, **kw)
    np.testing.assert_array_equal(tok2.numpy(), tok)
    np.testing.assert_array_equal(sc2.numpy(), sc)
    assert torch.equal(again["idx"], stats["idx"])
    assert torch.equal(again["own"], stats["idx"])
    assert float(again["slack"].max()) == 0.0

    other = TB.beam_search_encoded_plain  # the same search, other weights
    tm2 = torch_model(CFG, sharpen_joint(init_transducer_params(
        jax.random.PRNGKey(4), CFG)))
    theirs = {}
    tok3, ln3, _ = other(tm2, torch.from_numpy(enc), torch.from_numpy(LENS),
                         stats=theirs, **kw)
    mine = {}
    tok4, ln4, _ = TB.beam_search_encoded_plain(
        tm, torch.from_numpy(enc), torch.from_numpy(LENS), stats=mine,
        follow=theirs, **kw)
    np.testing.assert_array_equal(ln4.numpy(), ln3.numpy())
    np.testing.assert_array_equal(tok4.numpy(), tok3.numpy())
    assert torch.equal(mine["idx"], theirs["idx"])
    assert float(mine["slack"].max()) > 0.1
    assert not torch.equal(mine["own"], mine["idx"])
