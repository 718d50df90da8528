"""Port record shards and batching (rnnt_tpu_torch.data.records, .pipeline)
vs the JAX package: shards written by either package read identically in
the other, and the same shards give the same bucketed, padded batches
(exact equality: the port keeps the JAX package's format and order)."""

import numpy as np
import pytest

from rnnt_tpu.data import pipeline as JP
from rnnt_tpu.data import records as JR
from rnnt_tpu_torch.data import pipeline as TP
from rnnt_tpu_torch.data import records as TR


def _examples(n, seed=0, feat=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t, u = int(rng.integers(20, 140)), int(rng.integers(1, 40))
        labels = rng.integers(1, 30, u).astype(np.int32)
        out.append({"mel_specs": rng.standard_normal((t, feat)).astype(
                        np.float32),
                    "pred_inp": np.concatenate([[0], labels]).astype(np.int32),
                    "labels": labels, "spec_lengths": np.int32(t),
                    "label_lengths": np.int32(u)})
    return out


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("writer,reader", [(JR, TR), (TR, JR)])
def test_shards_cross_read(tmp_path, writer, reader):
    exs = _examples(7)
    writer.write_shards(exs, str(tmp_path / "train-{shard:05d}.rnr"),
                        num_shards=3)
    got = list(reader.read_shards(str(tmp_path / "train-*.rnr")))
    assert len(got) == 7
    # round-robin into 3 shards, read shard by shard
    order = [i for s in range(3) for i in range(s, 7, 3)]
    for i, ex in zip(order, got):
        _same(ex, exs[i])


@pytest.mark.parametrize("shuffle", [0, 8])
def test_bucketed_batches_match_jax(tmp_path, shuffle):
    JR.write_shards(_examples(37, seed=1),
                    str(tmp_path / "train-{shard:05d}.rnr"), num_shards=2)
    kw = dict(shuffle_buffer=shuffle, seed=5)
    pattern = str(tmp_path / "train-*.rnr")
    want = list(JP.batches_from_shards(pattern, 4, **kw))
    got = list(TP.prefetch(TP.batches_from_shards(pattern, 4, **kw), depth=2))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        _same(a, b)
    partial = [b for b in got if "num_real" in b]
    assert partial, "expected repeat-padded partial buckets"
    for b in partial:
        n = int(b["num_real"])
        assert (b["loss_weight"][:n] == 1).all()
        assert (b["loss_weight"][n:] == 0).all()
        assert (b["label_lengths"][n:] == 0).all()


def test_prefetch_reraises_producer_errors():
    def bad():
        yield 1
        raise RuntimeError("boom")

    it = TP.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
