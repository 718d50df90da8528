"""The port's mesh helpers (rnnt_tpu_torch.parallel.mesh) and metadata scan
(rnnt_tpu_torch.data.records.scan_lengths) against the JAX package's, in
one process: the (data, model) grid and its refusals, the read groups of
five process layouts (seen from process 0, as the JAX functions see them
here), and the scan on the same shards."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rnnt_tpu.data import records as JR
from rnnt_tpu.parallel import mesh as jmesh
from rnnt_tpu_torch.data import records as TR
from rnnt_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)


def test_make_mesh_shapes():
    m = tmesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.group is None
    assert (m.rank, m.size, m.reduces) == (0, 1, False)
    m = tmesh.make_mesh(ranks=range(4))
    assert m.shape == {"data": 4, "model": 1}
    assert [d.process_index for d in m.devices.ravel()] == [0, 1, 2, 3]
    assert tmesh.make_mesh(data=4, ranks=range(4)).shape["data"] == 4


@pytest.mark.parametrize("kw,exc,match", [
    (dict(model=2), ValueError, r"mesh 0x2 != 1 ranks"),
    (dict(data=2, ranks=range(4)), ValueError, r"mesh 2x1 != 4 ranks"),
    (dict(data=3), ValueError, r"mesh 3x1 != 1 ranks")])
def test_make_mesh_refusals(kw, exc, match):
    with pytest.raises(exc, match=match):
        tmesh.make_mesh(**kw)


def _mesh(rows):
    """A duck-typed mesh: `.devices[r, c].process_index` only."""
    dev = np.empty((len(rows), len(rows[0])), dtype=object)
    for r, row in enumerate(rows):
        for c, p in enumerate(row):
            dev[r, c] = SimpleNamespace(process_index=p)
    return SimpleNamespace(devices=dev)


LAYOUTS = {
    "pure_dp_4x1": [[0], [1], [2], [3]],
    "model_spans_processes_2x2": [[0, 1], [2, 3]],
    "process_holds_rows_2x2": [[0, 0], [1, 1]],
}
BAD_LAYOUTS = {
    "partial_overlap": ([[0, 0], [0, 1]], "partially overlap"),
    "non_contiguous": ([[0], [1], [0], [1]], "not a contiguous block"),
    "unequal": ([[0], [0], [1]], "unequal row counts"),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_read_groups_equal_jax(name):
    mesh = _mesh(LAYOUTS[name])
    assert tmesh.data_read_group(mesh) == jmesh.data_read_group(mesh)
    assert (tmesh.read_group_process_count(mesh)
            == jmesh.read_group_process_count(mesh))


def test_read_groups_of_other_processes():
    mesh = _mesh(LAYOUTS["model_spans_processes_2x2"])
    assert [tmesh.data_read_group(mesh, p) for p in range(4)] == [
        (0, 2), (0, 2), (1, 2), (1, 2)]
    assert tmesh.read_group_process_count(mesh, 3) == 2
    assert tmesh.data_read_group(mesh, 7) == (0, 1)  # holds no device


@pytest.mark.parametrize("name", sorted(BAD_LAYOUTS))
def test_read_group_refusals_equal_jax(name):
    rows, match = BAD_LAYOUTS[name]
    mesh = _mesh(rows)
    with pytest.raises(ValueError, match=match) as want:
        jmesh.data_read_group(mesh)
    with pytest.raises(ValueError, match=match) as got:
        tmesh.data_read_group(mesh)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("scan")
    rng = np.random.default_rng(0)

    def examples(n):
        for _ in range(n):
            t, u = int(rng.integers(5, 90)), int(rng.integers(1, 20))
            yield {"mel_specs": rng.standard_normal((t, 8)).astype(np.float32),
                   "labels": rng.integers(1, 30, u).astype(np.int32),
                   "spec_lengths": np.int32(t), "label_lengths": np.int32(u)}

    return str(JR.write_shards(examples(23), str(d / "train-{shard:05d}.rnr"),
                               3)[0]).replace("00000", "*")


@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_scan_lengths_equal_jax(shards, index, count):
    kw = dict(process_index=index, process_count=count)
    got = list(TR.scan_lengths(shards, **kw))
    assert got == list(JR.scan_lengths(shards, **kw))
    assert got == [{"spec_lengths": int(ex["spec_lengths"].item()),
                    "label_lengths": int(ex["label_lengths"].item())}
                   for ex in TR.read_shards(shards, **kw)]
    assert list(TR.scan_lengths(shards, fields=("labels",), **kw)) == list(
        JR.scan_lengths(shards, fields=("labels",), **kw))


def test_scan_lengths_missing_shards(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(TR.scan_lengths(str(tmp_path / "none-*.rnr")))


def test_all_reduce_helpers_without_a_group():
    m = tmesh.make_mesh()
    t = torch.arange(3.0)
    tmesh.all_reduce_sum_([t], m)
    assert torch.equal(t, torch.arange(3.0))
    assert tmesh.all_gather_ints(5, m) == [5]
    tmesh.barrier(m)
    tmesh.broadcast_module_(torch.nn.Linear(2, 2), m)


def test_new_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from rnnt_tpu_torch.cli import bench_scaling, run_rnnt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.init_distributed()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_scaling.main(["--devices", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_rnnt.main(["--data_dir", str(tmp_path), "--multihost",
                       "--pad_frames", "64", "--pad_tokens", "8"])
    assert not torch.distributed.is_initialized()
