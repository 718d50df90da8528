"""Checkpoints in the JAX package's npz layout, without JAX: the port of
`rnnt_tpu.train.checkpoint`.

A run directory, as `rnnt_tpu.train.checkpoint.save_checkpoint` writes it
and as `save_checkpoint` here writes it:

  run/
    config.json                    RNNTConfig sidecar
    encoder.subwords | vocab.txt   tokenizer sidecar
    checkpoint_{step:08d}/state.npz

`state.npz` holds the TrainState leaves in `jax.tree_util` flatten order as
`leaf_{i}`: leaf_0 is the step, then the parameters (dict keys sorted, lists
in order), then the optimizer state (`train.state.Optimizer.slots`).  bf16
leaves are stored as fp32.  So either package resumes the other's
checkpoints with the optimizer state.  Writes publish atomically (a
temporary file renamed into place) and keep the newest `keep` steps.

A multi-process run writes the same leaves collectively with
`torch.distributed.checkpoint` (backend "dcp", the counterpart of the JAX
package's orbax backend, which the port cannot import) as
`checkpoint_{step:08d}.dcp/`, each leaf in its own dtype; every rank takes
part in the save and the restore.  Only the port reads these; npz stays
the format both packages read.

Where the mesh shards the vocabulary (`parallel.mesh.Mesh.vocab_shard`),
W2, b2 and their optimizer leaves are gathered over the model group before
either write, so a tensor-parallel run's checkpoint holds the same leaves
and shapes as a one-process run's; a restore reads them whole, and the
caller cuts them to its shard (`parallel.mesh.shard_state_`).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.device import resolve_device
from rnnt_tpu_torch.parallel import mesh as mesh_mod

_CKPT_RE = re.compile(r"^checkpoint_(\d+)$")
_DCP_RE = re.compile(r"^checkpoint_(\d+)\.dcp$")
_ORBAX_RE = re.compile(r"^checkpoint_(\d+)\.orbax$")
BACKENDS = ("auto", "npz", "dcp")


def sidecar_dir(ckpt_dir: str, filename: str = "config.json") -> str:
    """The directory that owns a checkpoint's sidecars: the directory itself,
    or, for a pinned step directory (`checkpoint_NNNNNNNN` or its `.dcp`)
    without them, its run directory.  Any other directory never falls back
    to its parent."""
    if not os.path.exists(os.path.join(ckpt_dir, filename)):
        path = os.path.abspath(ckpt_dir)
        parent = os.path.dirname(path)
        name = os.path.basename(path)
        if ((_CKPT_RE.match(name) or _DCP_RE.match(name))
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


def _is_dcp(path: str) -> bool:
    return os.path.exists(os.path.join(path, ".metadata"))


def _published_steps(ckpt_dir: str) -> Dict[int, str]:
    """step -> its published step directory (npz over dcp for one step)."""
    out: Dict[int, str] = {}
    if os.path.isdir(ckpt_dir):
        for name in sorted(os.listdir(ckpt_dir), reverse=True):
            path = os.path.join(ckpt_dir, name)
            m = _CKPT_RE.match(name)
            if m and os.path.exists(os.path.join(path, "state.npz")):
                out[int(m.group(1))] = path
            m = _DCP_RE.match(name)
            if m and _is_dcp(path):
                out.setdefault(int(m.group(1)), path)
    return out


def list_checkpoint_steps(ckpt_dir: str) -> List[int]:
    """Steps with a published checkpoint (state.npz or a .dcp directory)
    under a run directory."""
    return sorted(_published_steps(ckpt_dir))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    steps = _published_steps(ckpt_dir)
    return steps[max(steps)] if steps else None


def has_orbax(path: str) -> bool:
    return (path.endswith(".orbax") or os.path.isdir(path + ".orbax")
            or (os.path.isdir(path) and any(
                _ORBAX_RE.match(n) for n in os.listdir(path))))


def _resolve_step_dir(path_or_dir: str) -> str:
    """The step directory to read: the path itself when it holds a
    checkpoint, else its latest step.  Orbax checkpoints are refused."""
    if has_orbax(path_or_dir):
        raise ValueError(
            f"{path_or_dir}: orbax checkpoints are not readable by the "
            "PyTorch port; save with backend='npz' or, across processes, "
            "backend='dcp'")
    if (os.path.exists(os.path.join(path_or_dir, "state.npz"))
            or _is_dcp(path_or_dir)):
        return path_or_dir
    latest = latest_checkpoint(path_or_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {path_or_dir}")
    return latest


def _load_leaves(path: str, count: Optional[int] = None,
                 mesh=None) -> List[torch.Tensor]:
    """The first `count` (None: all) `leaf_{i}` of a step directory as CPU
    tensors: an npz's as stored (fp32, int32), a .dcp's in their saved
    dtypes (a collective load over the mesh's group, or the default group
    when one exists)."""
    if not _is_dcp(path):
        with np.load(os.path.join(path, "state.npz")) as data:
            n = len(data.files) if count is None else min(count,
                                                          len(data.files))
            arrs = [data[f"leaf_{i}"] for i in range(n)]
        for i, a in enumerate(arrs):
            if a.dtype.kind == "V":
                raise ValueError(f"{path}: leaf {i} holds raw bfloat16 bytes "
                                 "(legacy layout), re-save it as fp32")
        return [torch.from_numpy(np.asarray(a)) for a in arrs]
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    n = len(meta) if count is None else min(count, len(meta))
    leaves = {}
    for i in range(n):
        m = meta[f"leaf_{i}"]
        leaves[f"leaf_{i}"] = torch.empty(tuple(m.size),
                                          dtype=m.properties.dtype)
    dcp.load(leaves, checkpoint_id=path,
             process_group=mesh.group if mesh is not None else None,
             no_dist=not dist.is_initialized())
    return [leaves[f"leaf_{i}"] for i in range(n)]


def restore_params(path_or_dir: str, cfg: RNNTConfig, mesh=None
                   ) -> Tuple[int, Dict[str, torch.Tensor]]:
    """Read a checkpoint's parameters: a step directory (npz or .dcp), or a
    run directory (its latest step).  Returns (step, state_dict) with fp32
    tensors named as `Transducer.state_dict()`; every leaf's shape is
    checked against `cfg`.  Orbax checkpoints are refused."""
    from rnnt_tpu_torch.models.transducer import Transducer

    path = _resolve_step_dir(path_or_dir)
    with torch.device("meta"):  # shapes only, no storage
        shapes = {k: tuple(v.shape)
                  for k, v in Transducer(cfg).state_dict().items()}
    names = flatten_order(shapes)
    leaves = _load_leaves(path, 1 + len(names), mesh)
    if len(leaves) < 1 + len(names):
        raise ValueError(f"{path}: {len(leaves)} leaves, the model needs "
                         f"1 + {len(names)} (config mismatch?)")
    sd: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(names, start=1):
        if tuple(leaves[i].shape) != shapes[name]:
            raise ValueError(
                f"leaf {i} ({name}): checkpoint shape "
                f"{tuple(leaves[i].shape)} != model {shapes[name]} "
                "(config mismatch?)")
        sd[name] = leaves[i].float()
    return int(leaves[0]), sd


# ---------------------------------------------------------------- training


def state_arrays(step: int, sd: Dict[str, torch.Tensor],
                 opt_state: Dict) -> Dict[str, np.ndarray]:
    """A TrainState's leaves (step, model state_dict, optimizer state) as
    `leaf_{i}` numpy arrays in flatten order: bf16 as fp32, counts as int32
    scalars."""
    from rnnt_tpu_torch.train.state import Optimizer

    leaves = [np.asarray(step, np.int32)]
    leaves += [sd[n] for n in flatten_order(sd)]
    leaves += [c[k] for c, k in Optimizer.slots(opt_state)]
    out = {}
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        elif not isinstance(x, np.ndarray):
            x = np.asarray(x, np.int32)
        out[f"leaf_{i}"] = x
    return out


def state_tensors(step: int, sd: Dict[str, torch.Tensor],
                  opt_state: Dict) -> Dict[str, torch.Tensor]:
    """The leaves of `state_arrays` as tensors in their own dtypes (where
    they live; counts as int32 scalars on the host), for a .dcp save."""
    from rnnt_tpu_torch.train.state import Optimizer

    leaves = [step] + [sd[n] for n in flatten_order(sd)]
    leaves += [c[k] for c, k in Optimizer.slots(opt_state)]
    return {f"leaf_{i}": (x.detach() if isinstance(x, torch.Tensor)
                          else torch.tensor(int(x), dtype=torch.int32))
            for i, x in enumerate(leaves)}


def _prune(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest `keep` steps (npz and .dcp alike)."""
    for s in list_checkpoint_steps(ckpt_dir)[:-keep]:
        for name in (f"checkpoint_{s:08d}", f"checkpoint_{s:08d}.dcp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def resolve_backend(backend: str, mesh=None) -> str:
    """'auto' is dcp across more than one process and npz otherwise.  npz
    has one writer: one process, or the first rank of a mesh that is one
    model group (data axis 1), after the vocab shards are gathered to it;
    across data replicas it is refused (each would write the same
    file)."""
    if backend not in BACKENDS:
        raise ValueError(
            f"checkpoint backend {backend!r}: the PyTorch port writes "
            f"{', '.join(BACKENDS)} (orbax is the JAX package's; use dcp)")
    multi = mesh is not None and mesh.size > 1
    if backend == "auto":
        return "dcp" if multi else "npz"
    if backend == "npz" and multi and mesh.shape["data"] > 1:
        raise ValueError(
            "backend='npz' cannot save from several data-parallel "
            "processes; use backend='dcp' (ckpt_backend='auto' picks it)")
    return backend


def _full_state(state, cfg: RNNTConfig, mesh):
    """(step, state_dict, optimizer state) with the vocab-sharded tensors
    gathered (collective over the model group where the mesh shards)."""
    tp = mesh.vocab_shard(cfg.vocab_size) if mesh is not None else None
    sd, opt = mesh_mod.full_state(state, tp)
    return int(state.step), sd, opt


def _write_dcp(ckpt_dir: str, tensors: Dict[str, torch.Tensor],
               cfg: RNNTConfig, *, keep: int, step: int, mesh=None) -> str:
    """Write checkpoint_{step}.dcp collectively (every rank of the mesh's
    group calls this) into a temporary directory that the first rank
    renames into place, then prunes."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.join(ckpt_dir, f"checkpoint_{step:08d}.dcp")
    tmp = path + ".tmp"
    first = mesh is None or mesh.rank == 0
    if first:
        cfg.save(ckpt_dir)
        shutil.rmtree(tmp, ignore_errors=True)
    mesh_mod.barrier(mesh)
    dcp.save(tensors, checkpoint_id=tmp,
             process_group=mesh.group if mesh is not None else None,
             no_dist=not dist.is_initialized())
    mesh_mod.barrier(mesh)
    if first:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        _prune(ckpt_dir, keep)
    mesh_mod.barrier(mesh)
    return path


def _write_npz(ckpt_dir: str, arrays: Dict[str, np.ndarray], cfg: RNNTConfig,
               *, keep: int, step: int) -> str:
    """Write checkpoint_{step}/state.npz with an atomic publish, then prune
    all but the newest `keep` steps."""
    path = os.path.join(ckpt_dir, f"checkpoint_{step:08d}")
    cfg.save(ckpt_dir)
    os.makedirs(path, exist_ok=True)
    # a preemption mid-write must never leave a truncated state.npz that
    # list_checkpoint_steps would take for a checkpoint
    tmp = os.path.join(path, ".state.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, "state.npz"))
    _prune(ckpt_dir, keep)
    return path


def save_checkpoint(ckpt_dir: str, state, cfg: RNNTConfig, *,
                    keep: int = 5, backend: str = "npz", mesh=None) -> str:
    """Write checkpoint_{step} (synchronously; backend 'dcp': the
    collective checkpoint_{step}.dcp); prunes beyond `keep`.  Every rank
    of a mesh calls this; an npz is written by the mesh's first rank."""
    backend = resolve_backend(backend, mesh)
    step, sd, opt = _full_state(state, cfg, mesh)
    if backend == "dcp":
        return _write_dcp(ckpt_dir, state_tensors(step, sd, opt), cfg,
                          keep=keep, step=step, mesh=mesh)
    path = os.path.join(ckpt_dir, f"checkpoint_{step:08d}")
    if mesh is None or mesh.rank == 0:
        path = _write_npz(ckpt_dir, state_arrays(step, sd, opt), cfg,
                          keep=keep, step=step)
    return path


class AsyncSaver:
    """Checkpointing off the training thread.  save() snapshots the state on
    its device (copies queued on the current stream, so the next steps
    cannot change them), and a thread moves the copies to the host and runs
    the same atomic npz write as save_checkpoint.  One save is in flight at
    a time; wait() joins it and re-raises a writer error.  A 'dcp' save is
    collective and runs on the calling thread; so does the gather of the
    vocab shards, and then only the mesh's first rank writes the npz."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._last_path: Optional[str] = None

    def wait(self) -> Optional[str]:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
        return self._last_path

    def save(self, ckpt_dir: str, state, cfg: RNNTConfig, *,
             keep: int = 5, backend: str = "npz", mesh=None) -> str:
        self.wait()
        if resolve_backend(backend, mesh) == "dcp":
            self._last_path = save_checkpoint(ckpt_dir, state, cfg, keep=keep,
                                              backend="dcp", mesh=mesh)
            return self._last_path
        step, sd, opt = _full_state(state, cfg, mesh)
        if mesh is not None and mesh.rank != 0:
            return os.path.join(ckpt_dir, f"checkpoint_{step:08d}")
        sd = {k: v.detach().clone() for k, v in sd.items()}
        opt = {k: ({n: t.detach().clone() for n, t in v.items()}
                   if isinstance(v, dict) else v)
               for k, v in opt.items()}

        def work():
            try:
                self._last_path = _write_npz(
                    ckpt_dir, state_arrays(step, sd, opt), cfg, keep=keep,
                    step=step)
            except BaseException as e:  # re-raised on the caller in wait()
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"ckpt-save-{step}")
        self._thread.start()
        return os.path.join(ckpt_dir, f"checkpoint_{step:08d}")


def _template_state(cfg: RNNTConfig, dtype, device):
    from rnnt_tpu_torch.models.transducer import Transducer
    from rnnt_tpu_torch.train.state import Optimizer, TrainState

    model = Transducer(cfg).cast_(dtype).to(device).make_trainable_()
    return TrainState(step=0, model=model, opt_state=Optimizer(cfg).init(model))


def restore_checkpoint(path_or_dir: str, cfg: RNNTConfig, dtype=None,
                       device="cuda", mesh=None):
    """Full resume (parameters, optimizer state and step) from a step
    directory or a run directory's latest step (npz, written by either
    package, or the port's .dcp, read collectively: every rank of the mesh
    calls this), onto `device` (the card unless 'cpu' is asked for), whole
    (W2 and b2 unsharded: `parallel.mesh.shard_state_` cuts them).
    dtype: the parameter dtype (None: cfg.compute_dtype); leaf shapes and
    the leaf count are checked against `cfg`."""
    from rnnt_tpu_torch.train.state import Optimizer

    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
            else torch.float32
    path = _resolve_step_dir(path_or_dir)
    state = _template_state(cfg, dtype, device)
    sd = state.model.state_dict()
    names = flatten_order(sd)
    slots = Optimizer.slots(state.opt_state)
    arrs = _load_leaves(path, mesh=mesh)
    n = len(arrs)
    if n != 1 + len(names) + len(slots):
        raise ValueError(
            f"{path}: {n} leaves, the config's train state has "
            f"{1 + len(names) + len(slots)} (config mismatch?)")
    state.step = int(arrs[0])
    with torch.no_grad():
        for i, name in enumerate(names, start=1):
            if tuple(arrs[i].shape) != tuple(sd[name].shape):
                raise ValueError(
                    f"leaf {i} ({name}): checkpoint shape "
                    f"{tuple(arrs[i].shape)} != model "
                    f"{tuple(sd[name].shape)} (config mismatch?)")
            sd[name].copy_(arrs[i])
        for (c, k), a in zip(slots, arrs[1 + len(names):]):
            if isinstance(c[k], torch.Tensor):
                if tuple(a.shape) != tuple(c[k].shape):
                    raise ValueError(
                        f"optimizer leaf {k}: shape {tuple(a.shape)} != "
                        f"{tuple(c[k].shape)} (config mismatch?)")
                c[k].copy_(a)
            else:
                c[k] = int(a)
    return state


def init_from_checkpoint(path_or_dir: str, cfg: RNNTConfig, dtype=None,
                         device="cuda", mesh=None):
    """Warm start: the parameters of a checkpoint (read under its own
    sidecar config when it has one, since the optimizer layout follows the
    config), fresh optimizer state and step 0 under `cfg`, on `device`
    (the card unless 'cpu' is asked for)."""
    from rnnt_tpu_torch.train.state import Optimizer

    device = resolve_device(device)
    src_cfg = cfg
    sc = sidecar_dir(path_or_dir)
    if os.path.exists(os.path.join(sc, "config.json")):
        src_cfg = RNNTConfig.load(sc)
    old = restore_checkpoint(path_or_dir, src_cfg, dtype, device, mesh)
    fresh = _template_state(cfg, old.model.dtype, device)
    mine = fresh.model.state_dict()
    with torch.no_grad():
        for name, t in old.model.state_dict().items():
            if tuple(t.shape) != tuple(mine[name].shape):
                raise ValueError(f"init_from geometry mismatch at {name}: "
                                 f"checkpoint {tuple(t.shape)} vs model "
                                 f"{tuple(mine[name].shape)}")
            mine[name].copy_(t)
    fresh.opt_state = Optimizer(cfg).init(fresh.model)
    return fresh
