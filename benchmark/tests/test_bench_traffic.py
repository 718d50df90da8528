"""Seeded traffic: the same per seed, different across seeds, the same
work in every seed."""

import pytest
import torch

from benchlib import traffic as trafmod
from conftest import tiny_model


def test_train_batches_per_seed():
    m = tiny_model()
    a = trafmod.train_batches(m, 2, 3, 6, 4, 9, "cpu", torch.float32)
    b = trafmod.train_batches(m, 2, 3, 6, 4, 9, "cpu", torch.float32)
    c = trafmod.train_batches(m, 2, 3, 6, 4, 10, "cpu", torch.float32)
    assert torch.equal(a[1]["mel_specs"], b[1]["mel_specs"])
    assert not torch.equal(a[1]["mel_specs"], c[1]["mel_specs"])
    assert not torch.equal(a[0]["labels"], a[1]["labels"])
    x = a[0]
    assert torch.equal(x["pred_inp"][:, 1:], x["labels"])
    assert (x["pred_inp"][:, 0] == 0).all()
    assert int(x["labels"].min()) >= 1
    assert int(x["labels"].max()) < m["vocab_size"]
    rows = trafmod.rows(x, 1, 3)
    assert torch.equal(rows["labels"], x["labels"][1:3])


def test_audio_seconds():
    m = tiny_model(frame_step=0.01, downsample_factor=3)
    assert trafmod.audio_seconds(m, 96, 256) == pytest.approx(737.28)
