"""The port's int8 pieces (rnnt_tpu_torch.ops.int8_exec, ops.quantize) vs
the JAX package's (rnnt_tpu.ops.int8_exec, ops.quantize) on the CPU.

qdot follows JAX's operations in order (fp32 activations, absmax / 127
clamped at 1e-12, half-to-even rounding to int8, an exact int32 product,
y = yi * a_scale * s), so its int32 products are equal and its fp32 outputs
agree to 1e-6; qtake likewise.  The padding that fits `torch._int_mm`'s CUDA
constraints (rows > 16, K a multiple of 8) is held against the exact plain
product at K = 500 and one row (torch._int_mm runs on the CPU too).
Quantized leaves are bitwise equal to JAX's, dequantized and int8-exec
leaves equal after the same cast, and each package loads the other's
artifact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.models.transducer import init_transducer_params
from rnnt_tpu.ops import int8_exec as JI
from rnnt_tpu.ops import quantize as JQ
from rnnt_tpu_torch.ops import int8_exec as TI
from rnnt_tpu_torch.ops import quantize as TQ
from rnnt_tpu_torch.train.checkpoint import params_from_numpy
from tests.torch_helpers import numpy_tree

torch.set_num_threads(1)

CFG = tiny_config(encoder_layers=2, pred_net_layers=2)


def _quant_pair(w):
    """One weight quantized by JAX: (JAX {"q","s"} leaf, port QuantWeight)."""
    leaf = JQ.quantize_params({"w": {"wx": jnp.asarray(w)}})["w"]["wx"]
    return ({"q": jnp.asarray(leaf["q"]), "s": jnp.asarray(leaf["s"])},
            TI.QuantWeight(torch.from_numpy(np.array(leaf["q"])),
                           torch.from_numpy(np.array(leaf["s"]))))


def _named(tree):
    """A JAX tree (quantized or not) as {dotted name: leaf}, an int8
    {"q","s"} dict counted as one leaf."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict) and set(node) == {"q", "s"}:
            out[prefix] = {"q": np.asarray(node["q"]),
                           "s": np.asarray(node["s"])}
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
        else:
            out[prefix] = node
    walk(tree, "")
    return out


def _same_leaf(got, want, dtype=None):
    if TQ.is_quant_leaf(want):
        assert TQ.is_quant_leaf(got) or TI.is_quant(got)
        q = got.q if TI.is_quant(got) else torch.from_numpy(np.asarray(
            got["q"]))
        s = got.s if TI.is_quant(got) else torch.from_numpy(np.asarray(
            got["s"]))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), want["q"])
        np.testing.assert_array_equal(s.numpy(), want["s"])
        return
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        if dtype is not None:
            assert got.dtype == dtype, (got.dtype, dtype)
        got = got.float().numpy()
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  want.astype(np.float32))


@pytest.mark.parametrize("rows, dtype", [(5, "float32"), (1, "bfloat16"),
                                         (33, "bfloat16")])
def test_qdot_matches_jax(rows, dtype):
    rng = np.random.default_rng(rows)
    K, N = 40, 24
    x = rng.standard_normal((rows, K)).astype(np.float32)
    x[0] = 0.0  # a zero row: zeros out, no NaN
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jw, tw = _quant_pair(rng.standard_normal((K, N)).astype(np.float32))
    want = np.asarray(JI.qdot(jx, jw))
    got = TI.qdot(tx, tw)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
    # the int32 products themselves
    xi, _ = TI.quantize_rows(tx)
    xf = jx.astype(jnp.float32)
    a_scale = jnp.maximum(jnp.max(jnp.abs(xf), -1, keepdims=True),
                          1e-12) / 127.0
    jxi = jnp.round(xf / a_scale).astype(jnp.int8)
    np.testing.assert_array_equal(xi.numpy(), np.asarray(jxi))
    jyi = jax.lax.dot_general(jxi, jw["q"], (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(TI.int_mm(xi, tw.q).numpy(),
                                  np.asarray(jyi))


def test_qdot_and_qtake_fp_passthrough():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    torch.testing.assert_close(TI.qdot(x, w), x @ w)
    ids = torch.tensor([2, 0, 2])
    torch.testing.assert_close(TI.qtake(w, ids), w[ids])
    assert TI.act_dtype(w) == torch.float32 and not TI.is_quant(w)
    assert TI.weight_shape(w) == (8, 4)


def test_qtake_matches_jax():
    rng = np.random.default_rng(1)
    jw, tw = _quant_pair(rng.standard_normal((32, 24)).astype(np.float32))
    ids = np.array([0, 5, 31, 5], np.int32)
    want = np.asarray(JI.qtake(jw, jnp.asarray(ids)))
    got = TI.qtake(tw, torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6
    assert TI.weight_shape(tw) == (32, 24) and TI.act_dtype(tw) == \
        torch.float32


@pytest.mark.parametrize("rows, K, N", [(1, 500, 64), (1, 640, 8),
                                        (3, 500, 16), (32, 500, 8),
                                        (1, 500, 31), (20, 640, 31)])
def test_int_mm_padding_is_exact(rows, K, N):
    """The card's product (`padded_int_mm`, torch._int_mm, which also runs
    on the CPU) on a QuantWeight's padded operand equals the exact plain
    product, and qdot through it equals qdot through the plain one."""
    rng = np.random.default_rng(K + rows + N)
    a = torch.from_numpy(rng.integers(-127, 128, (rows, K)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    w = TI.QuantWeight(b, torch.from_numpy(
        rng.uniform(1e-5, 1e-3, N).astype(np.float32)))
    assert (w.q_mm is not None) == bool(K % 8 or N % 8)
    Kp, Np = w.operand.shape
    assert Kp % 8 == 0 and Np % 8 == 0 and Kp >= K and Np >= N
    assert torch.equal(w.operand[:K, :N], b) and not w.operand[K:].any() \
        and not w.operand[:, N:].any()
    want = TI.plain_int_mm(a, w.operand)
    assert want.dtype == torch.int32 and tuple(want.shape) == (rows, Np)
    np.testing.assert_array_equal(
        want[:, :N].numpy(),
        a.numpy().astype(np.int64) @ b.numpy().astype(np.int64))
    got = TI.padded_int_mm(a, w.operand)
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows, Np)
    assert torch.equal(got, want)
    # the CPU wrapper runs the plain product and counts no card launch
    before = TI.int_mm.launches
    assert torch.equal(TI.int_mm(a, w.operand), want)
    assert TI.int_mm.launches == before
    x = torch.from_numpy(rng.standard_normal((rows, K)).astype(np.float32))
    y_plain = TI.qdot(x, w)
    assert tuple(y_plain.shape) == (rows, N)
    card, TI.int_mm = TI.int_mm, TI.padded_int_mm
    try:
        assert torch.equal(TI.qdot(x, w), y_plain)
    finally:
        TI.int_mm = card


def test_quant_weight_padding_is_not_saved():
    """Only a matmul weight gets the padded copy, and a state_dict holds q
    and s alone."""
    q = torch.ones((500, 31), dtype=torch.int8)
    s = torch.ones(31)
    assert TI.QuantWeight(q, s).q_mm.shape == (504, 32)
    assert TI.QuantWeight(q, s, matmul=False).q_mm is None
    assert TI.QuantWeight(torch.ones((16, 8), dtype=torch.int8),
                          torch.ones(8)).q_mm is None
    assert set(TI.QuantWeight(q, s).state_dict()) == {"q", "s"}


def test_int_mm_refuses_unaligned_n():
    a = torch.zeros((1, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="N % 8"):
        TI.padded_int_mm(a, torch.zeros((8, 12), dtype=torch.int8))


@pytest.fixture(scope="module")
def params():
    return init_transducer_params(jax.random.PRNGKey(4), CFG)


def _port_sd(params, dtype=torch.float32):
    sd = params_from_numpy(numpy_tree(params))
    return {k: (v if k in ("encoder.bn.mean", "encoder.bn.var")
                else v.to(dtype)) for k, v in sd.items()}


def test_quantize_params_bitwise(params):
    want = _named(JQ.quantize_params(params))
    got = TQ.quantize_params(_port_sd(params))
    assert set(got) == set(want)
    quant = sorted(k for k, v in want.items() if TQ.is_quant_leaf(v))
    assert quant == sorted(k for k, v in got.items() if TQ.is_quant_leaf(v))
    assert "prediction.embed" in quant and "joint.b2" not in quant
    for name in want:
        _same_leaf(got[name], want[name])
    assert TQ.quantized_size_bytes(got) == JQ.quantized_size_bytes(
        JQ.quantize_params(params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_and_int8_exec_params_match_jax(params, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jtemplate = jax.tree_util.tree_map(lambda x: x.astype(jdt), params)
    jtemplate["encoder"]["bn"] = dict(params["encoder"]["bn"])  # fp32 stats
    q = JQ.quantize_params(params)
    template = _port_sd(params, tdt)
    tq = TQ.quantize_params(_port_sd(params))
    for jfn, tfn in ((JQ.dequantize_params, TQ.dequantize_params),
                     (JQ.int8_exec_params, TQ.int8_exec_params)):
        want = _named(jfn(q, jdt, template=jtemplate))
        got = tfn(tq, tdt, template=template)
        assert set(got) == set(want)
        for name, leaf in want.items():
            _same_leaf(got[name], leaf,
                       dtype=None if TQ.is_quant_leaf(leaf)
                       else template[name].dtype)
    mixed = TQ.int8_exec_params(tq, tdt, template=template)
    assert TI.is_quant(mixed["joint.w2"]) and TI.is_quant(
        mixed["prediction.embed"])
    # w2 [32, 31] is padded once for the card's product; the table is not
    assert mixed["joint.w2"].q_mm.shape == (32, 32)
    assert mixed["prediction.embed"].q_mm is None
    assert not any(TI.is_quant(v) for k, v in mixed.items()
                   if k.startswith("encoder."))
    # without a template the int8 leaves take `dtype`, the rest keep theirs
    deq = TQ.dequantize_params(tq, tdt)
    assert deq["joint.w1"].dtype == tdt and deq["joint.b1"].dtype == \
        torch.float32


@pytest.mark.parametrize("writer", ["jax", "jax_bf16", "torch"])
def test_artifact_loads_across_packages(params, tmp_path, writer):
    """Each package loads the other's artifact; a JAX artifact of bf16
    parameters holds its passthrough leaves as raw bfloat16 bytes, which
    the port reads as bfloat16 values."""
    path = str(tmp_path / "model_int8.npz")
    if writer == "jax_bf16":
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                        params)
    jq = JQ.quantize_params(params)
    template = _port_sd(params)
    if writer.startswith("jax"):
        JQ.save_quantized(path, jq)
        got = TQ.load_quantized(path, template)
        want = _named(jq)
        assert set(got) == set(want)
        for name, leaf in want.items():
            _same_leaf(got[name], leaf)
    else:
        TQ.save_quantized(path, TQ.quantize_params(template))
        got = _named(JQ.load_quantized(path, params))
        want = _named(jq)
        assert set(got) == set(want)
        for name, leaf in want.items():
            _same_leaf(got[name], leaf)


def test_load_quantized_checks_the_model(params, tmp_path):
    path = str(tmp_path / "q.npz")
    TQ.save_quantized(path, TQ.quantize_params(_port_sd(params)))
    other = init_transducer_params(jax.random.PRNGKey(0), tiny_config(
        encoder_layers=2, pred_net_layers=2, joint_size=24))
    with pytest.raises(ValueError, match="shape"):
        TQ.load_quantized(path, _port_sd(other))
    fewer = init_transducer_params(jax.random.PRNGKey(0), tiny_config(
        encoder_layers=2, pred_net_layers=1))
    with pytest.raises(ValueError, match="leaves"):
        TQ.load_quantized(path, _port_sd(fewer))


def test_quantize_model_cli_writes_the_jax_artifact(params, tmp_path,
                                                    capsys):
    """The port's CLI on a checkpoint written by the JAX package writes the
    artifact the JAX package would quantize from the same parameters, and
    prints the JAX CLI's size line."""
    import re

    from rnnt_tpu.data.tokenizer import CharTokenizer
    from rnnt_tpu.train import checkpoint as j_ckpt
    from rnnt_tpu.train.state import create_train_state
    from rnnt_tpu_torch.cli import quantize_model

    d = str(tmp_path / "run")
    state = create_train_state(jax.random.PRNGKey(2), CFG)
    j_ckpt.save_checkpoint(d, state, CFG)
    CharTokenizer().save(d)
    assert quantize_model.main(["--checkpoint", d, "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    art = f"{d}/model_int8.npz"
    assert re.fullmatch(r"params: [0-9.]+M  fp: [0-9.]+ MB -> int8: [0-9.]+ "
                        r"MB \([0-9.]+x smaller\)  wrote " + re.escape(art),
                        line), line
    got = _named(JQ.load_quantized(art, state.params))
    want = _named(JQ.quantize_params(state.params))
    assert set(got) == set(want)
    for name, leaf in want.items():
        _same_leaf(got[name], leaf)
