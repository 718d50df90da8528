"""Train state: the model (parameters and BatchNorm statistics), the
optimizer state and the step; the port of `rnnt_tpu.train.state`.

The optimizer follows the JAX package's optax chain, with its semantics and
dtypes:

  [clip_by_global_norm(grad_clip_norm)]           when grad_clip_norm > 0
  trace(momentum, nesterov=False)                 optimizer "sgd": the
                                                  momentum in the param dtype
  | scale_by_adam(0.9, 0.98, eps=1e-9, mu fp32)   optimizer "adam"
  scale(-lr) | scale_by_schedule(-schedule)       the latter when warmup or
                                                  a non-constant schedule

The optimizer state's leaves come in optax's flatten order (momentum per
trainable parameter; or Adam's count, mu, nu; then the schedule's count),
which `train.checkpoint` writes after the parameters.  Global norms are
summed in fp32; under vocab tensor parallelism the squares of the sharded
W2 and b2 are summed over the model group (JAX's `optax.global_norm` of
the sharded tree), the replicated leaves counted once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import torch

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.device import resolve_device
from rnnt_tpu_torch.models.transducer import Transducer, fp32_leaf
from rnnt_tpu_torch.parallel import mesh as mesh_mod
from rnnt_tpu_torch.train.checkpoint import flatten_order

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.98, 1e-9


@dataclasses.dataclass
class TrainState:
    step: int
    model: Transducer
    opt_state: Dict


def trainable_names(model: Transducer) -> List[str]:
    """Trainable parameter names in flatten order (all but the BatchNorm
    running statistics)."""
    return flatten_order(n for n, _ in model.named_parameters()
                         if not fp32_leaf(n))


def lr_schedule(cfg: RNNTConfig) -> Callable[[int], float]:
    """Step -> learning rate: constant, or cosine decay to
    lr_final_factor x lr over decay_steps, after an optional linear warmup
    from 0 over warmup_steps (optax's linear, cosine_decay and
    join_schedules)."""
    lr = cfg.learning_rate
    if cfg.lr_schedule not in ("constant", "cosine"):
        raise ValueError(f"lr_schedule={cfg.lr_schedule!r} "
                         "(want 'constant' or 'cosine')")
    if cfg.lr_schedule == "cosine" and cfg.decay_steps > 0:
        def base(count):
            count = min(count, cfg.decay_steps)
            cos = 0.5 * (1 + math.cos(math.pi * count / cfg.decay_steps))
            return lr * ((1 - cfg.lr_final_factor) * cos + cfg.lr_final_factor)
    else:
        def base(count):
            return lr
    if cfg.warmup_steps <= 0:
        return base
    w = cfg.warmup_steps

    def sched(count):
        if count < w:
            frac = 1 - min(max(count, 0), w) / w
            return (0.0 - lr) * frac + lr
        return base(count - w)
    return sched


def has_schedule(cfg: RNNTConfig) -> bool:
    """Whether the chain ends in scale_by_schedule (with a count leaf)."""
    return cfg.warmup_steps > 0 or cfg.lr_schedule != "constant"


def _square_sum(ts: List[torch.Tensor]) -> torch.Tensor:
    """The sum of squares of every element, in fp32: each tensor's norm in
    one multi-tensor reduction, then their squares summed."""
    norms = torch._foreach_norm(ts, 2, dtype=torch.float32)
    return torch.stack(norms).square().sum()


def global_norm(grads: Dict[str, torch.Tensor], tp=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element of named tensors, in
    fp32.  Under `tp` the vocab-sharded ones (`VOCAB_SHARDED`) are this
    rank's columns: their squares are summed over the model group, the
    replicated tensors' counted once."""
    shd = mesh_mod.VOCAB_SHARDED if tp is not None else {}
    rep = [g for n, g in grads.items() if n not in shd]
    sq = _square_sum(rep) if rep else 0
    part = [g for n, g in grads.items() if n in shd]
    if part:
        part = _square_sum(part)
        mesh_mod.all_reduce_(part, tp.group)
        sq = sq + part
    return torch.sqrt(sq)


class Optimizer:
    """The optax chain above, applied in place to the model's parameters."""

    def __init__(self, cfg: RNNTConfig, tp=None):
        """tp: the model's W2 and b2 are vocab-sharded (clipping reads the
        global norm over the model group)."""
        if cfg.optimizer not in ("sgd", "adam"):
            raise ValueError(f"optimizer={cfg.optimizer!r} "
                             "(want 'sgd' or 'adam')")
        self.cfg = cfg
        self.tp = tp
        self.schedule = lr_schedule(cfg)

    def init(self, model: Transducer) -> Dict:
        params = dict(model.named_parameters())
        names = trainable_names(model)
        state: Dict = {}
        if self.cfg.optimizer == "adam":
            state["count"] = 0
            state["mu"] = {n: torch.zeros_like(params[n], dtype=torch.float32)
                           for n in names}
            state["nu"] = {n: torch.zeros_like(params[n]) for n in names}
        else:
            state["trace"] = {n: torch.zeros_like(params[n]) for n in names}
        if has_schedule(self.cfg):
            state["sched_count"] = 0
        return state

    @staticmethod
    def slots(opt_state: Dict) -> List:
        """(container, key) of each optimizer-state leaf, in optax's flatten
        order (counts are Python ints, the rest tensors)."""
        out: List = []
        if "count" in opt_state:
            out.append((opt_state, "count"))
            for k in ("mu", "nu"):
                out += [(opt_state[k], n) for n in flatten_order(opt_state[k])]
        else:
            tr = opt_state["trace"]
            out += [(tr, n) for n in flatten_order(tr)]
        if "sched_count" in opt_state:
            out.append((opt_state, "sched_count"))
        return out

    @torch.no_grad()
    def apply_(self, model: Transducer, grads: Dict[str, torch.Tensor],
                opt_state: Dict) -> None:
        """One update of the trainable parameters from `grads` (by name)."""
        cfg = self.cfg
        params = dict(model.named_parameters())
        names = list(grads)
        g = dict(grads)
        if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
            norm = global_norm(g, self.tp)
            keep = norm < cfg.grad_clip_norm  # on the device: no host sync
            g = {n: torch.where(keep, t, (t / norm.to(t.dtype))
                                * cfg.grad_clip_norm)
                 for n, t in g.items()}
        if cfg.optimizer == "adam":
            self._adam_(model, g, opt_state)
            return
        upd = {}
        for n in names:
            m = g[n] + cfg.momentum * opt_state["trace"][n]
            opt_state["trace"][n] = m.to(opt_state["trace"][n].dtype)
            upd[n] = opt_state["trace"][n]
        if "sched_count" in opt_state:
            scale = -self.schedule(opt_state["sched_count"])
            opt_state["sched_count"] += 1
        else:
            scale = -cfg.learning_rate
        for n in names:
            u = upd[n]
            u = torch.tensor(scale, dtype=u.dtype, device=u.device) * u
            p = params[n]
            p.copy_((p + u).to(p.dtype))


    def _adam_(self, model: Transducer, g: Dict[str, torch.Tensor],
               opt_state: Dict) -> None:
        """The Adam branch of `apply_` over every leaf at once, in place:
        mu (fp32) and nu (the parameter dtype) are updated where they lie
        and each parameter takes lr mu_hat / (sqrt(nu_hat) + eps), computed
        in fp32 and rounded once, through a few multi-tensor operations
        (`torch._foreach_*`) in place of ~15 launches a leaf."""
        params = dict(model.named_parameters())
        names = list(g)
        count = opt_state["count"] + 1
        c1 = float(1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** count)
        c2 = float(1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** count)
        gs = [g[n] for n in names]
        mu = [opt_state["mu"][n] for n in names]
        nu = [opt_state["nu"][n] for n in names]
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, gs, alpha=1 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - ADAM_B2)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        opt_state["count"] = count
        if "sched_count" in opt_state:
            scale = -self.schedule(opt_state["sched_count"])
            opt_state["sched_count"] += 1
        else:
            scale = -self.cfg.learning_rate
        torch._foreach_addcdiv_([params[n] for n in names], mu, den,
                                value=scale / c1)


def create_train_state(cfg: RNNTConfig, dtype=None, device="cuda",
                       seed: int = 0) -> TrainState:
    """Fresh state: random parameters from `seed` (numpy), cast to `dtype`
    (None: cfg.compute_dtype), on `device` (the card unless 'cpu' is
    asked for), trainable; zero optimizer state; step 0."""
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
            else torch.float32
    model = Transducer(cfg).init_(seed).cast_(dtype).to(device)
    model.make_trainable_()
    return TrainState(step=0, model=model, opt_state=Optimizer(cfg).init(model))
