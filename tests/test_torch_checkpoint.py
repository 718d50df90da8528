"""The port reads the JAX package's npz checkpoints without JAX: a run dir
written by rnnt_tpu.train.checkpoint.save_checkpoint, restored leaf by leaf
(exact), plus the sidecar resolution of pinned step directories."""

import os

import jax
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.train import checkpoint as j_ckpt
from rnnt_tpu.train.state import create_train_state
from rnnt_tpu_torch.config import RNNTConfig as TConfig
from rnnt_tpu_torch.models.transducer import Transducer as TTransducer
from rnnt_tpu_torch.train import checkpoint as t_ckpt
from tests.torch_helpers import numpy_tree

torch.set_num_threads(1)

CFG = tiny_config(optimizer="adam", warmup_steps=10)  # opt leaves follow


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_run"))
    state = create_train_state(jax.random.PRNGKey(4), CFG)
    state = state._replace(step=state.step + 7)
    j_ckpt.save_checkpoint(d, state, CFG)
    return d, state


def test_restore_params_every_leaf_equal(run_dir):
    d, state = run_dir
    cfg = t_ckpt.load_config(d)
    assert cfg == TConfig(**CFG.__dict__)
    step, sd = t_ckpt.restore_params(d, cfg)
    assert step == 7
    want = t_ckpt.params_from_numpy(numpy_tree(state.params))
    assert sd.keys() == want.keys()
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    # and the names fit the port's model exactly
    TTransducer(cfg).load_state_dict(sd, strict=True)


def test_flatten_order_is_jax_order(run_dir):
    _, state = run_dir
    paths = jax.tree_util.tree_flatten_with_path(state.params)[0]
    want = [".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path) for path, _ in paths]
    assert t_ckpt.flatten_order(reversed(want)) == want


def test_pinned_step_dir_finds_parent_sidecars(run_dir, tmp_path):
    d, _ = run_dir
    pinned = os.path.join(d, "checkpoint_00000007")
    assert t_ckpt.sidecar_dir(pinned) == d
    step, _ = t_ckpt.restore_params(pinned, t_ckpt.load_config(pinned))
    assert step == 7
    # a directory that is not a step directory never falls back
    other = tmp_path / "export"
    other.mkdir()
    (tmp_path / "config.json").write_text("{}")
    assert t_ckpt.sidecar_dir(str(other)) == str(other)


def test_shape_mismatch_and_orbax_refused(run_dir, tmp_path):
    d, _ = run_dir
    with pytest.raises(ValueError, match="config mismatch"):
        t_ckpt.restore_params(d, TConfig(**CFG.replace(
            encoder_size=72).__dict__))
    (tmp_path / "checkpoint_00000001.orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        t_ckpt.restore_params(str(tmp_path), TConfig(**CFG.__dict__))


def test_dcp_round_trip_at_world_one(run_dir, tmp_path):
    """A .dcp checkpoint needs no process group at world 1: every leaf
    comes back bitwise in its own dtype, and the run dir's listing, latest
    step, pinned-step sidecars and pruning know .dcp steps."""
    from rnnt_tpu_torch.train.state import Optimizer

    d, _ = run_dir
    cfg = t_ckpt.load_config(d)
    state = t_ckpt.restore_checkpoint(d, cfg, torch.bfloat16, "cpu")
    out = str(tmp_path / "run")
    for step in (7, 8, 9):
        state.step = step
        path = t_ckpt.save_checkpoint(out, state, cfg, keep=2,
                                      backend="dcp")
    assert path.endswith("checkpoint_00000009.dcp")
    assert t_ckpt.list_checkpoint_steps(out) == [8, 9]
    assert t_ckpt.latest_checkpoint(out) == path
    assert t_ckpt.sidecar_dir(path) == out
    back = t_ckpt.restore_checkpoint(out, cfg, torch.bfloat16, "cpu")
    assert back.step == 9
    for k, v in state.model.state_dict().items():
        assert back.model.state_dict()[k].dtype == v.dtype
        assert torch.equal(back.model.state_dict()[k], v), k
    for (c, k), (bc, bk) in zip(Optimizer.slots(state.opt_state),
                                Optimizer.slots(back.opt_state)):
        if isinstance(c[k], torch.Tensor):
            assert torch.equal(bc[bk], c[k]), k
        else:
            assert bc[bk] == c[k], k
    step, sd = t_ckpt.restore_params(path, cfg)
    assert step == 9 and torch.equal(
        sd["joint.w2"], state.model.joint.w2.float())
    assert t_ckpt.resolve_backend("auto") == "npz"
    with pytest.raises(ValueError, match="use dcp"):
        t_ckpt.resolve_backend("orbax")


def test_params_from_numpy_names():
    tree = {"joint": {"w1": np.ones((2, 3))},
            "encoder": {"layers": [{"ln": {"scale": np.zeros(4)}}]}}
    sd = t_ckpt.params_from_numpy(tree)
    assert set(sd) == {"joint.w1", "encoder.layers.0.ln.scale"}
    assert sd["joint.w1"].dtype == torch.float32
