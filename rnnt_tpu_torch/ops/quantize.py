"""Post-training int8 weight quantization: the port of
`rnnt_tpu.ops.quantize`.

Every matmul weight (the leaves named wx, wh, wp, embed, w1, w2, of rank 2
or more) becomes symmetric per-output-channel int8 with fp32 scales; the
other leaves (biases, norms, BatchNorm statistics) pass through.  A
quantized tree is a dict of dotted parameter names (as
`Transducer.state_dict()` names them) to either a numpy array or a
{"q": int8 array, "s": fp32 array} leaf, computed on the host in numpy
exactly as the JAX package computes it.

- `dequantize_params` turns it back into fp tensors (q * s on the host in
  fp32, then cast to the live model's dtypes);
- `int8_exec_params` keeps the int8 leaves under `prediction` and `joint`
  as `ops.int8_exec.QuantWeight`s, executed by `qdot` / `qtake`, and
  dequantizes the rest (the encoder runs kernel K2, which reads fp
  weights);
- `save_quantized` / `load_quantized` use the JAX package's artifact layout:
  `q_{i}` / `s_{i}` for int8 leaves, `w_{i}` for the others and
  `__kinds__`, indexed in `jax.tree_util` flatten order of the parameter
  tree (`train.checkpoint.flatten_order`), so either package loads the
  other's artifact.  Passthrough leaves are written in fp32 (numpy holds no
  bfloat16); raw bfloat16 bytes in an artifact are read as bfloat16.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from rnnt_tpu_torch.models.encoder import require_lstm_encoder
from rnnt_tpu_torch.ops.int8_exec import QuantWeight
from rnnt_tpu_torch.train.checkpoint import flatten_order

# weight leaves quantized per output channel (the last dimension)
_QUANT_KEYS = {"wx", "wh", "wp", "embed", "w1", "w2"}

# the top-level modules whose int8 leaves int8 execution keeps int8: the
# encoder stays fp, since kernel K2 reads fp weights
INT8_EXEC_SCOPE = ("prediction", "joint")

QLeaf = Union[np.ndarray, Dict[str, np.ndarray]]


def is_quant_leaf(leaf) -> bool:
    """True for a host-side int8 leaf {"q", "s"}."""
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def _host(x) -> np.ndarray:
    """A tensor or array as a numpy array, bfloat16 widened to fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.kind == "V" and x.dtype.itemsize == 2:  # raw bfloat16 bits
        return (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return x


def quantize_params(params: Mapping[str, object]) -> Dict[str, QLeaf]:
    """fp parameters (name -> tensor or array) -> quantized tree."""
    out: Dict[str, QLeaf] = {}
    for name, leaf in params.items():
        a = _host(leaf)
        if name.rsplit(".", 1)[-1] not in _QUANT_KEYS or a.ndim < 2:
            out[name] = np.asarray(a, np.float32) if a.dtype.kind == "f" \
                else a
            continue
        w = np.asarray(a, np.float32)
        scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) / 127.0
        scale = np.maximum(scale, 1e-12)
        qw = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        out[name] = {"q": qw, "s": scale.astype(np.float32)}
    return out


def _passthrough(leaf, name, template) -> torch.Tensor:
    """A raw leaf as a tensor: floats in the template's dtype for `name`,
    if a template is given, else as stored."""
    t = torch.from_numpy(np.array(_host(leaf)))
    if template is not None and t.is_floating_point():
        t = t.to(template[name].dtype)
    return t


def dequantize_params(qparams: Mapping[str, QLeaf], dtype=torch.bfloat16,
                      template=None) -> Dict[str, torch.Tensor]:
    """Quantized tree -> fp tensors (on the host).  An int8 leaf becomes
    q * s computed in fp32, cast to the dtype of the template's tensor of
    that name (a state_dict of the live model) or else to `dtype`; a
    passthrough float leaf takes the template's dtype, or else keeps its
    stored dtype."""
    out = {}
    for name, leaf in qparams.items():
        if is_quant_leaf(leaf):
            w = np.asarray(leaf["q"], np.float32) * np.asarray(leaf["s"],
                                                               np.float32)
            out[name] = torch.from_numpy(w).to(
                template[name].dtype if template is not None else dtype)
        else:
            out[name] = _passthrough(leaf, name, template)
    return out


def int8_exec_params(qparams: Mapping[str, QLeaf], dtype=torch.bfloat16,
                     template=None) -> Dict:
    """Quantized tree -> the mixed tree that int8 execution loads: under
    INT8_EXEC_SCOPE every int8 leaf becomes a `QuantWeight` and the float
    leaves take the template's dtype (or keep their own); everything else
    is dequantized as `dequantize_params` does."""
    out = {}
    rest = {}
    for name, leaf in qparams.items():
        if name.split(".", 1)[0] not in INT8_EXEC_SCOPE:
            rest[name] = leaf
        elif is_quant_leaf(leaf):
            out[name] = QuantWeight(
                torch.from_numpy(np.array(leaf["q"], np.int8)),
                torch.from_numpy(np.array(leaf["s"], np.float32)),
                matmul=name.rsplit(".", 1)[-1] != "embed")
        else:
            out[name] = _passthrough(leaf, name, template)
    out.update(dequantize_params(rest, dtype, template))
    return {name: out[name] for name in qparams}


def quantized_size_bytes(qparams: Mapping[str, QLeaf]) -> int:
    total = 0
    for leaf in qparams.values():
        if is_quant_leaf(leaf):
            total += leaf["q"].nbytes + leaf["s"].nbytes
        else:
            total += np.asarray(leaf).nbytes
    return total


def save_quantized(path: str, qparams: Mapping[str, QLeaf]) -> None:
    """Write the artifact in the JAX package's layout (module docstring)."""
    arrs: Dict[str, np.ndarray] = {}
    kinds = []
    for i, name in enumerate(flatten_order(qparams)):
        leaf = qparams[name]
        if is_quant_leaf(leaf):
            arrs[f"q_{i}"] = np.asarray(leaf["q"], np.int8)
            arrs[f"s_{i}"] = np.asarray(leaf["s"], np.float32)
            kinds.append("quant")
        else:
            arrs[f"w_{i}"] = np.asarray(leaf)
            kinds.append("raw")
    arrs["__kinds__"] = np.array(kinds)
    np.savez_compressed(path, **arrs)


def load_quantized(path: str, template: Mapping) -> Dict[str, QLeaf]:
    """Read an artifact into a quantized tree over the template's names (a
    state_dict of the model it belongs to): leaf i is the i-th name in
    flatten order.  The leaf count and every shape must match the
    template's; raw bfloat16 bytes are read as bfloat16 values."""
    names = flatten_order(template)
    out: Dict[str, QLeaf] = {}
    with np.load(path, allow_pickle=False) as data:
        kinds = [str(k) for k in data["__kinds__"]]
        if len(kinds) != len(names):
            raise ValueError(f"{path}: {len(kinds)} leaves, the model has "
                             f"{len(names)} parameters (config mismatch?)")
        for i, (name, kind) in enumerate(zip(names, kinds)):
            if kind == "quant":
                out[name] = {"q": data[f"q_{i}"], "s": data[f"s_{i}"]}
                shape = out[name]["q"].shape
            else:
                out[name] = _host(data[f"w_{i}"])
                shape = out[name].shape
            if tuple(shape) != tuple(template[name].shape):
                raise ValueError(
                    f"{path}: leaf {i} ({name}) shape {tuple(shape)} != "
                    f"model {tuple(template[name].shape)} (config mismatch?)")
    return out


def apply_quantized_(model, qparams: Mapping[str, QLeaf],
                     int8_exec: bool = False):
    """Replace a live `Transducer`'s weights by a quantized tree's (over its
    state_dict's names): dequantized to the model's own dtypes, or with
    int8_exec the prediction net's and the joint's matmul weights kept int8
    (`int8_exec_params`).  Returns the model."""
    require_lstm_encoder(model.cfg, "int8 weights")
    convert = int8_exec_params if int8_exec else dequantize_params
    return model.load_params_(convert(qparams, model.dtype,
                                      template=model.state_dict()))


def load_quantized_into_(model, path: str, int8_exec: bool = False):
    """`apply_quantized_` of the artifact at `path`."""
    return apply_quantized_(model, load_quantized(path, model.state_dict()),
                            int8_exec)
