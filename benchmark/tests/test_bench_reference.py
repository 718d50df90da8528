"""The frozen reference against the program's plain CPU path (tiny model,
fp32), and the leaf comparison on cases worked by hand."""

import torch

from benchlib import traffic as trafmod
from benchlib.weights import layout, make_weights
from conftest import tiny_model
from reference import transducer as ref

CPU = torch.device("cpu")


def program_model(m, seed=3):
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.models.transducer import Transducer

    model = Transducer(RNNTConfig(**m))
    w = make_weights(m, seed, CPU, torch.float32)
    model.load_state_dict(w)
    return model.eval(), w


def test_layout_names_the_programs_parameters():
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.models.transducer import Transducer

    for m in (tiny_model(), tiny_model(vocab_size=40, pred_net_layers=2)):
        with torch.device("meta"):
            sd = Transducer(RNNTConfig(**m)).state_dict()
        assert {n: tuple(t.shape) for n, t in sd.items()} == {
            n: s for n, s, _ in layout(m)}


def test_encoder_prediction_joint_match_the_program():
    m = tiny_model()
    model, wf = program_model(m)
    g = torch.Generator().manual_seed(0)
    mel = torch.randn((2, 10, m["mel_bins"]), generator=g)
    ids = torch.randint(1, m["vocab_size"], (2, 6), generator=g)
    ids[:, 0] = 0
    with torch.no_grad():
        enc_p, _ = model.encode(mel)
        pred_p, _ = model.prediction(ids)
        lg_p = model.joint_step(enc_p[:, 3], pred_p[:, 2])
        enc_r = ref.encoder(mel, wf, m)
        pred_r = ref.prediction(ids, wf, m)
        lg_r = ref.joint(enc_r[:, 3:4, None], pred_r[:, None, 2:3], wf, False)
    assert torch.allclose(enc_p, enc_r, atol=1e-5)
    assert torch.allclose(pred_p, pred_r, atol=1e-5)
    assert torch.allclose(lg_p, lg_r[:, 0, 0], atol=1e-5)


def test_training_forward_matches_the_programs_loss():
    from rnnt_tpu_torch.config import RNNTConfig
    from rnnt_tpu_torch.train.steps import batch_loss

    m = tiny_model()
    model, w = program_model(m)
    b = trafmod.train_batches(m, 1, 3, 8, 4, 11, CPU, torch.float32)[0]
    with torch.no_grad():
        loss, (nll, _) = batch_loss(model, RNNTConfig(**m), b, training=True,
                                    loss_impl="ref")
    want, _ = ref.loss_and_grads(w, b, m)
    assert abs(float(loss) - want) < 1e-4 * abs(want)


def test_rnnt_nll_matches_the_programs_plain_lattice():
    from rnnt_tpu_torch.ops.rnnt_loss_ref import rnnt_loss_ref

    g = torch.Generator().manual_seed(1)
    logits = torch.randn((2, 5, 4, 7), generator=g)
    labels = torch.randint(1, 7, (2, 3), generator=g)
    want = rnnt_loss_ref(logits, labels, torch.tensor([5, 5]),
                         torch.tensor([3, 3]))
    assert torch.allclose(ref.rnnt_nll(logits, labels).float(), want,
                          atol=1e-5)


def test_worst_leaf_gap_and_moved_leaves():
    want = {"a": 1.0, "b": 2.0, "c": 1e-6}
    gap, leaf = ref.worst_leaf_gap({"a": 1.1, "b": 2.0, "c": 1e-3}, want)
    assert leaf == "a" and abs(gap - 0.1) < 1e-12
    # against its own norm alone, the tiny leaf's 1e-3 reads 999
    gap, leaf = ref.worst_leaf_gap({"a": 1.1, "b": 2.0, "c": 1e-3}, want,
                                   floor=False)
    assert leaf == "c" and abs(gap - 999.0) < 1e-6
    own = ref.own_norm_gaps({"a": 1.0, "b": 2.2, "c": 1e-6},
                            {"a": 1.1, "b": 2.0, "c": 1.0},
                            {"grad_norms": want,
                             "change_norms": {"a": 1.0, "b": 2.0, "c": 0.5}},
                            {"a", "b"})
    assert abs(own["grad_gap_own_norm"] - 0.1) < 1e-12
    assert own["grad_gap_own_norm_leaf"] == "b"
    assert abs(own["change_gap_own_norm"] - 0.1) < 1e-12
    assert own["change_gap_own_norm_leaf"] == "a"
    assert ref.moved_leaves(want) == {"a", "b"}
