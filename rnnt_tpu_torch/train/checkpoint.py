"""Read side of the JAX package's checkpoints, without JAX.

A run directory written by `rnnt_tpu.train.checkpoint.save_checkpoint`:

  run/
    config.json                    RNNTConfig sidecar
    encoder.subwords | vocab.txt   tokenizer sidecar
    checkpoint_{step:08d}/state.npz

`state.npz` holds the TrainState leaves in `jax.tree_util` flatten order as
`leaf_{i}`: leaf_0 is the step, then the parameters (dict keys sorted, lists
in order), then the optimizer state, which serving ignores.  bf16 leaves
were stored as fp32.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from rnnt_tpu_torch.config import RNNTConfig

_CKPT_RE = re.compile(r"^checkpoint_(\d+)$")
_ORBAX_RE = re.compile(r"^checkpoint_(\d+)\.orbax$")


def sidecar_dir(ckpt_dir: str, filename: str = "config.json") -> str:
    """The directory that owns a checkpoint's sidecars: the directory itself,
    or, for a pinned step directory `checkpoint_NNNNNNNN` without them, its
    run directory.  Any other directory never falls back to its parent."""
    if not os.path.exists(os.path.join(ckpt_dir, filename)):
        path = os.path.abspath(ckpt_dir)
        parent = os.path.dirname(path)
        if (_CKPT_RE.match(os.path.basename(path))
                and os.path.exists(os.path.join(parent, filename))):
            return parent
    return ckpt_dir


def load_config(ckpt_dir: str) -> RNNTConfig:
    return RNNTConfig.load(sidecar_dir(ckpt_dir))


def _sort_key(name: str):
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def flatten_order(names: Iterable[str]) -> List[str]:
    """Dotted parameter names in `jax.tree_util` flatten order of the nested
    tree they name (dict keys sorted, list items in index order)."""
    return sorted(names, key=_sort_key)


def params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree of nested dicts and lists of numpy arrays ->
    a state_dict for `models.transducer.Transducer` (dotted names)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = torch.from_numpy(
                np.array(node, dtype=np.float32, copy=True))
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    return out


def _latest_step_dir(run_dir: str) -> str:
    steps = []
    if os.path.isdir(run_dir):
        for name in os.listdir(run_dir):
            m = _CKPT_RE.match(name)
            if m and os.path.exists(os.path.join(run_dir, name, "state.npz")):
                steps.append(int(m.group(1)))
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {run_dir}")
    return os.path.join(run_dir, f"checkpoint_{max(steps):08d}")


def restore_params(path_or_dir: str,
                   cfg: RNNTConfig) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Read a `state.npz` checkpoint: a step directory, or a run directory
    (its latest step).  Returns (step, state_dict) with fp32 tensors named
    as `Transducer.state_dict()`; every leaf's shape is checked against
    `cfg`.  Orbax checkpoints are refused."""
    from rnnt_tpu_torch.models.transducer import Transducer

    path = path_or_dir
    if (path.endswith(".orbax") or os.path.isdir(path + ".orbax")
            or (os.path.isdir(path) and any(
                _ORBAX_RE.match(n) for n in os.listdir(path)))):
        raise ValueError(
            f"{path_or_dir}: orbax checkpoints are not readable by the "
            "PyTorch port; save with backend='npz'")
    if not os.path.exists(os.path.join(path, "state.npz")):
        path = _latest_step_dir(path)
    with torch.device("meta"):  # shapes only, no storage
        shapes = {k: tuple(v.shape)
                  for k, v in Transducer(cfg).state_dict().items()}
    names = flatten_order(shapes)
    sd: Dict[str, torch.Tensor] = {}
    with np.load(os.path.join(path, "state.npz")) as data:
        n_leaves = len(data.files)
        if n_leaves < 1 + len(names):
            raise ValueError(f"{path}: {n_leaves} leaves, the model needs "
                             f"1 + {len(names)} (config mismatch?)")
        step = int(data["leaf_0"])
        for i, name in enumerate(names, start=1):
            arr = data[f"leaf_{i}"]
            if arr.dtype.kind == "V":
                raise ValueError(f"{path}: leaf {i} holds raw bfloat16 bytes "
                                 "(legacy layout), re-save it as fp32")
            if arr.shape != shapes[name]:
                raise ValueError(
                    f"leaf {i} ({name}): checkpoint shape {arr.shape} != "
                    f"model {shapes[name]} (config mismatch?)")
            sd[name] = torch.from_numpy(arr.astype(np.float32))
    return step, sd
