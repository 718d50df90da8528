"""Operation and byte counts against hand counts at small shapes."""

import pytest

from benchlib import flops


def test_lstm_cost_by_hand():
    # T=2 B=3 H=4 P=5, bf16: products 2*T*B*(P*4H + H*P) = 12*(80+20)
    nbytes, ops = flops.lstm_cost(2, 3, 4, 5, 2, False)
    assert ops == 1200.0
    weights = 2 * (5 * 16 + 4 * 5)
    assert nbytes == weights + 2 * (16 + 15) + 2 * 6 * (32 + 5 + 4) + 4 * 24
    nbytes, ops = flops.lstm_cost(2, 3, 4, 5, 2, True)
    assert ops == 1200.0
    assert nbytes == weights + 2 * 2 * 6 * (16 + 5 + 2) + 4 * 24 + 4 * 15


def test_planes_cost_by_hand():
    nbytes, ops = flops.planes_cost(2, 3, 4, 5, 6, 2)
    cells = 24
    assert ops == 2.0 * cells * 5 * 6
    assert nbytes == 2 * (30 + 40 + 30 + 5 + 6) + 4 * 8 + 12 * cells


def test_least_time_takes_the_larger_bound():
    assert flops.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert flops.least_s(0, 989e12) == pytest.approx(1.0)
    assert flops.least_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


M = dict(mel_bins=2, downsample_factor=3, encoder_layers=3,
         encoder_size=4, projection_size=5, time_reduction_index=0,
         time_reduction_factor=2, pred_net_layers=2, pred_net_size=7,
         embedding_size=3, joint_size=6, vocab_size=9)


def test_encoder_and_prediction_flops_by_hand():
    # layer 0: 6 inputs over T=5; layer 1: 10 (=5x2) over 3; layer 2: 5
    def layer(t, n_in, H, P):
        return 2.0 * t * (n_in * 4 * H + P * 4 * H + H * P)
    assert flops.encoder_flops(M, 1, 5) == (layer(5, 6, 4, 5)
                                            + layer(3, 10, 4, 5)
                                            + layer(3, 5, 4, 5))
    assert flops.prediction_flops(M, 2, 4) == 2 * (layer(4, 3, 7, 5)
                                                   + layer(4, 5, 7, 5))


def test_train_step_flops_by_hand():
    B, T, U = 2, 5, 3
    fwd = (flops.encoder_flops(M, B, T) + flops.prediction_flops(M, B, U + 1)
           + 2.0 * B * (3 + 4) * 5 * 6 + 2.0 * B * 3 * 4 * 6 * 9)
    assert flops.train_step_flops(M, B, T, U) == 3 * fwd


def test_lstm_calls_cover_every_layer():
    calls = flops.lstm_calls(M, 2, 5, 4)
    assert calls == [(5, 2, 4, 5), (3, 2, 4, 5), (3, 2, 4, 5),
                     (4, 2, 7, 5), (4, 2, 7, 5)]

