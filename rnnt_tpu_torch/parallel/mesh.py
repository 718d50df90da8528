"""Data and vocab tensor parallelism over `torch.distributed`: the port of
`rnnt_tpu.parallel.mesh`.

The JAX package runs one SPMD program over a ('data', 'model') device mesh
and lets GSPMD insert the collectives.  The port runs one process per
device, in PyTorch's idiom, and issues the collectives itself:

- `init_distributed` joins the process group (NCCL for the card, gloo for
  the CPU), from flags or from the torchrun environment.
- `make_mesh` lays the ranks out as a (data, model) grid.  A rank's data
  group is its model column (the ranks holding the same vocabulary shard
  and other batch rows), its model group its data row (the ranks holding
  the same batch rows and the other shards).
- On a model axis of mp > 1 the joint's vocabulary projection W2 and b2
  (`VOCAB_SHARDED`) are column-sharded when mp divides V: shard k holds
  columns [k V/mp, (k+1) V/mp), as the JAX rules lay them out
  (`Mesh.vocab_shard`, `shard_state_`); every other parameter is
  replicated.  `gather_vocab` rebuilds the full columns over the model
  group (checkpoints, decoding).
- `data_read_group` and `read_group_process_count` split the input stream
  by data-row ownership, as the JAX functions do, with their three refusals.
- `all_reduce_sum_` sums a list of tensors across the data group in one
  flat bucket, `all_reduce_sum` is the differentiable sum the global
  BatchNorm needs, `all_reduce_` any reduction over any group,
  `all_gather_ints` gathers small counts, `broadcast_module_` copies rank
  0's parameters and buffers to every rank (`shard_params` on the data
  axis).

The gloo backend reduces host tensors: with tensors on the card (two ranks
sharing one card, where NCCL cannot run) the helpers copy each bucket to the
host, reduce it there and copy it back.  That is staging, not a fallback:
every kernel still runs on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rnnt_tpu_torch.trace import spanned


@dataclasses.dataclass(frozen=True)
class Device:
    """One rank's device in the grid (the field `data_read_group` reads)."""
    process_index: int


class Mesh:
    """A (data, model) grid of ranks.  `group` is the process group of all
    its ranks (None without `torch.distributed`), `rank` this process's
    index in it, `size` its size and `device` this process's device.
    `data_group` sums over this rank's model column (the whole mesh when
    the model axis is 1; None when the data axis is 1: nothing to sum) and
    `model_group` over its data row (None when the model axis is 1);
    `data_index` and `shard_index` are this rank's row and column,
    `shard_count` the model axis."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray, group=None, device=None,
                 data_group=None, model_group=None):
        self.devices = devices
        self.group = group
        self.data_group = data_group
        self.model_group = model_group
        self.device = torch.device(device) if device is not None else None
        ranks = [d.process_index for d in devices.ravel()]
        me = dist.get_rank() if dist.is_initialized() else 0
        self.rank = ranks.index(me) if me in ranks else -1
        self.size = len(ranks)
        self.shard_count = devices.shape[1]
        self.data_index, self.shard_index = (
            divmod(self.rank, self.shard_count) if self.rank >= 0 else (0, 0))

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def reduces(self) -> bool:
        """Whether this mesh's steps run collectives (a process group)."""
        return self.group is not None

    def vocab_shard(self, vocab_size: int) -> Optional["VocabShard"]:
        """This rank's vocabulary shard, or None where W2 stays replicated:
        a model axis of 1, or one that does not divide `vocab_size` (the
        JAX rules' divisibility guard, e.g. 31 characters at mp=2)."""
        if (self.model_group is None or self.shard_count == 1
                or vocab_size % self.shard_count):
            return None
        return VocabShard(self.model_group, self.shard_index,
                          self.shard_count)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """Columns [index V/count, (index+1) V/count) of the vocabulary on this
    rank; `group` is the model group that holds the other shards (a group
    of one runs the same code path with no one to exchange with)."""
    group: object
    index: int
    count: int


# parameter name -> the dimension split over the model axis (the JAX rules'
# `joint/w2` P(None, 'model') and `joint/b2` P('model'))
VOCAB_SHARDED = {"joint.w2": 1, "joint.b2": 0}


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda", timeout_s: float = 1800.0,
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this process's device.

    coordinator_address ("host:port" of rank 0), num_processes and
    process_id are the JAX CLI's flags; without them the torchrun
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK)
    gives them, and without that a single process joins a group of one on
    a free local port.  The backend is NCCL for 'cuda' and gloo for 'cpu'
    unless `backend` names one (gloo with 'cuda' lets several ranks share a
    card, which NCCL refuses); on the card each process takes the device
    LOCAL_RANK (or process_id) modulo the device count.  A group that
    already exists is reused."""
    from rnnt_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError("--num_processes > 1 needs --coordinator_address "
                             "(or torchrun's environment)")
        coordinator_address = f"localhost:{free_port()}"
        num_processes, process_id = 1, 0
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator_address needs --num_processes and "
                         "--process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} outside 0..{num_processes - 1}")
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise ValueError(f"a process group of {dist.get_world_size()} "
                             f"exists, {num_processes} were asked for")
        return dev
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(data: int = -1, model: int = 1, *,
              ranks: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A ('data', 'model') grid over `ranks` (all ranks of the process
    group by default; one rank, no group, without torch.distributed),
    row-major: rank i of `ranks` sits at (i // model, i % model).  data=-1
    means all remaining ranks.  A sub-list of ranks gets a new group, and a
    model axis above 1 a group for each column with more than one row and
    for each row; every rank of the world creates every one of them, in
    the same order, members or not."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if ranks is None else list(ranks)
    n = len(ranks)
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    group = data_group = model_group = None
    grid = np.asarray(ranks, dtype=np.int64).reshape(data, model)
    if dist.is_initialized():
        group = (dist.group.WORLD if ranks == list(range(world))
                 else dist.new_group(ranks))
        data_group = group
        if model > 1:
            me = dist.get_rank()
            data_group = None
            if data > 1:
                for c in range(model):
                    g = dist.new_group(grid[:, c].tolist())
                    if me in grid[:, c]:
                        data_group = g
            for r in range(data):
                g = dist.new_group(grid[r].tolist())
                if me in grid[r]:
                    model_group = g
    devices = np.empty((data, model), dtype=object)
    for i, r in enumerate(ranks):
        devices.flat[i] = Device(r)
    return Mesh(devices, group, device, data_group, model_group)


def _process_rows(mesh):
    rows = {}  # process_index -> row-index set
    dev = mesh.devices
    for r in range(dev.shape[0]):
        for d in np.ravel(dev[r]):
            rows.setdefault(d.process_index, set()).add(r)
    return rows


def _me(process_index):
    if process_index is not None:
        return process_index
    return dist.get_rank() if dist.is_initialized() else 0


def data_read_group(mesh, process_index: Optional[int] = None):
    """(group_index, group_count): this process's slice of the input stream.

    Input is split by data-row ownership, not by process: processes whose
    devices sit in the same rows of the data axis hold replicas of the same
    batch rows (a model axis spanning processes) and must read identical
    data.  Processes covering the same rows share one read group; groups
    own disjoint, contiguous, equal row blocks, else ValueError (a partial
    overlap would feed replicas different data; an interleaved or unequal
    layout would mispair eval hypotheses with their references).  Reads
    `mesh.devices[r, c].process_index` only."""
    rows = _process_rows(mesh)
    groups = {}
    for p, rs in sorted(rows.items()):
        groups.setdefault(tuple(sorted(rs)), []).append(p)
    ordered = sorted(groups)
    for i, a in enumerate(ordered):
        for b in ordered[i + 1:]:
            if set(a) & set(b):
                raise ValueError(
                    f"unsupported mesh/process layout: data rows {a} and {b} "
                    f"partially overlap across processes — choose "
                    f"model_parallel so each data row lives in one process, "
                    f"or so whole rows are shared")
    for key in ordered:
        ks = list(key)
        if ks != list(range(ks[0], ks[0] + len(ks))):
            raise ValueError(
                f"unsupported mesh/process layout: read group rows {key} are "
                f"not a contiguous block — reorder the mesh devices so each "
                f"process group covers consecutive data rows")
    if len({len(k) for k in ordered}) > 1:
        raise ValueError(
            f"unsupported mesh/process layout: read groups own unequal row "
            f"counts {[len(k) for k in ordered]} — eval row pairing assumes "
            f"equal per-group batch shares")
    me = _me(process_index)
    for gi, key in enumerate(ordered):
        if me in groups[key]:
            return gi, len(ordered)
    return 0, 1  # this process holds no device of the mesh


def read_group_process_count(mesh, process_index: Optional[int] = None
                             ) -> int:
    """The number of processes sharing this process's read group (1 on the
    data axis alone); eval statistics computed identically by every member
    are down-weighted by it before a cross-process sum."""
    rows = _process_rows(mesh)
    mine = rows.get(_me(process_index))
    if mine is None:
        return 1
    return sum(1 for rs in rows.values() if rs == mine)


# ------------------------------------------------------------- collectives


def _collective_(op, t: torch.Tensor, group) -> None:
    """op(t) in place; gloo works on a host copy of a card tensor (see the
    module docstring)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        op(host)
        t.copy_(host)
    else:
        op(t)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """In-place reduction (a sum unless `op` says otherwise) across the
    process group."""
    _collective_(lambda x: dist.all_reduce(x, op=op, group=group), t, group)


@spanned("rnnt.parallel.all_reduce")
def all_reduce_sum_(tensors: Sequence[torch.Tensor], mesh: Mesh,
                    group=None) -> None:
    """Sum each tensor across the mesh's data group (or `group`), in place,
    through one flat bucket in the widest of their dtypes (at least fp32:
    bf16 gradients are summed in fp32 and rounded once).  No-op without a
    group."""
    if group is None and mesh is not None:
        group = mesh.data_group
    if not tensors or group is None:
        return
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    bucket = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    all_reduce_(bucket, group)
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(bucket[off: off + n].view(t.shape))
            off += n


class _AllReduceSum(torch.autograd.Function):
    """Sum across the group; its backward is the same sum of the incoming
    gradients (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        all_reduce_(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        all_reduce_(g, ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A differentiable sum of `t` across the mesh's data group (a new
    tensor)."""
    return _AllReduceSum.apply(t, mesh.data_group)


def all_gather_ints(value: int, mesh: Optional[Mesh]) -> List[int]:
    """Every rank's `value`, in rank order ([value] without a group)."""
    if mesh is None or mesh.group is None:
        return [int(value)]
    dev = mesh.device if (mesh.device is not None and dist.get_backend(
        mesh.group) == "nccl") else torch.device("cpu")
    mine = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    out = [torch.zeros_like(mine) for _ in range(mesh.size)]
    dist.all_gather(out, mine, group=mesh.group)
    return [int(t.item()) for t in out]


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh (no-op without a group)."""
    if mesh is not None and mesh.group is not None:
        if dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def broadcast_module_(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Rank 0's parameters and buffers on every rank (after init, restore or
    a warm start, before `shard_state_`), in place.  No-op without a
    group."""
    if mesh is None or mesh.group is None:
        return
    src = mesh.devices.flat[0].process_index
    with torch.no_grad():
        for _, t in sorted(module.state_dict().items()):
            _collective_(
                lambda x: dist.broadcast(x, src=src, group=mesh.group), t,
                mesh.group)


# ------------------------------------------------------ vocab sharding


def shard_columns(t: torch.Tensor, dim: int, tp: VocabShard) -> torch.Tensor:
    """This shard's slice of a full tensor along `dim` (a contiguous
    copy)."""
    n = t.shape[dim] // tp.count
    return t.narrow(dim, tp.index * n, n).contiguous()


def gather_columns(t: torch.Tensor, dim: int, tp: VocabShard) -> torch.Tensor:
    """The full tensor from every shard's slice along `dim`, over the model
    group (in shard order; gloo gathers host copies of card tensors)."""
    if tp.count == 1:
        return t.clone()
    src = t.contiguous()
    host = src.is_cuda and dist.get_backend(tp.group) == "gloo"
    if host:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(tp.count)]
    dist.all_gather(parts, src, group=tp.group)
    return torch.cat(parts, dim).to(t.device)


def _sharded_leaves(state):
    """(container, key, dim) of every vocab-sharded tensor of a train
    state: the parameters, then the optimizer state's per-parameter
    leaves (momentum, Adam's mu and nu)."""
    params = dict(state.model.named_parameters())
    out = [(params[n], None, d) for n, d in VOCAB_SHARDED.items()]
    for v in state.opt_state.values():
        if isinstance(v, dict):
            out += [(v, n, d) for n, d in VOCAB_SHARDED.items() if n in v]
    return out


@torch.no_grad()
def shard_state_(state, tp: Optional[VocabShard]) -> None:
    """Cut W2, b2 and their optimizer leaves of a full train state to this
    rank's shard, in place (the same Parameter objects; the JAX
    `shard_params`).  No-op for tp None."""
    if tp is None:
        return
    for c, k, dim in _sharded_leaves(state):
        if k is None:
            c.data = shard_columns(c.data, dim, tp)
        else:
            c[k] = shard_columns(c[k], dim, tp)


def gather_vocab(model, tp: Optional[VocabShard]) -> dict:
    """{name: the full tensor} of the model's vocab-sharded parameters,
    gathered over the model group ({} for tp None)."""
    if tp is None:
        return {}
    params = dict(model.named_parameters())
    return {n: gather_columns(params[n].detach(), d, tp)
            for n, d in VOCAB_SHARDED.items()}


def full_state(state, tp: Optional[VocabShard]):
    """(state_dict, optimizer state) of a train state with every
    vocab-sharded tensor gathered to its full columns (what a one-process
    run holds; the state's own tensors where nothing is sharded).  Every
    rank of the model group calls this."""
    sd = state.model.state_dict()
    opt = dict(state.opt_state)
    if tp is None:
        return sd, opt
    sd = dict(sd)
    sd.update(gather_vocab(state.model, tp))
    for k, v in opt.items():
        if isinstance(v, dict):
            opt[k] = dict(v)
            for n, d in VOCAB_SHARDED.items():
                if n in v:
                    opt[k][n] = gather_columns(v[n], d, tp)
    return sd, opt


@contextlib.contextmanager
def full_vocab(model, full: dict):
    """The model with `full` (`gather_vocab`'s tensors) in place of its
    vocab-sharded parameters for the block, e.g. to decode; the shards
    return after it."""
    if not full:
        yield model
        return
    params = dict(model.named_parameters())
    local = {n: params[n].data for n in full}
    try:
        for n, t in full.items():
            params[n].data = t
        yield model
    finally:
        for n, t in local.items():
            params[n].data = t
