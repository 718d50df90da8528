"""The Conformer's convolution module between its two pointwise products on
kernels K10 and K11 (`csrc/conv_module.cu`), and their plain PyTorch
versions.

From u, pw1's output [B, T, 2D], and the padding mask `valid` [B, T]:
a = u[..., :D] sigmoid(u[..., D:]) zeroed at padded frames; the depthwise
convolution y[t] = bias + sum_k w[:, k] a[t + k - (K - 1) // 2] over
(K - 1) // 2 frames of zeros before and K // 2 after; BatchNorm with the
valid frames' statistics in training (mean and E[y^2] - mean^2, eps, the
updated running statistics 0.99 running + 0.01 batch returned) or the
running ones in eval; s = silu(z), z = y A + Bs, A = gamma / sqrt(var +
eps), Bs = beta - mean A.  Layout [B, T, C], channels contiguous.

K10 (`conv_module_fwd`) in training: one pass over u that writes y in bf16
and each block's partial sums of y and y^2 (a block: CT channels of one
utterance's chunk of CHUNK frames), the statistics from those partial rows
in a fixed order, and one pass y -> s.  In eval one pass u -> s.  K11
(`conv_module_bwd`) from ds, s's gradient: the partial sums of dz = ds
silu'(z) and dz yhat over every frame (yhat = (y - mean) / sqrt(var +
eps)), dgamma and dbeta from them, then one pass that recomputes dy = P dz
- m (Q + yhat R) (P = gamma / sqrt(var + eps), Q = P dbeta / n, R = P
dgamma / n, m the mask, n the valid frames) and a with their halos and
writes du [B, T, 2D] (the depthwise convolution's input gradient, GLU's
backward, the mask) and each block's partial dW and db, summed in a fixed
order.  Between a load and a store everything is fp32; y, s and du are
rounded to u's dtype, the parameter gradients to the parameters'.

The plain versions follow the kernels' passes, partial rows and points of
rounding; on a CPU tensor each wrapper runs its plain version, on a CUDA
tensor it launches its kernels or raises.  `models.conformer.ConvModule`
routes here bf16 CUDA tensors whose BatchNorm statistics are the rank's
own (`fits`), and keeps its formula on the CPU, in fp32 and under a data
mesh of more than one row; `fits` raises for a bf16 CUDA module that the
kernels do not take (D not a multiple of CT, K > KMAX, eval with a
gradient asked for) rather than send it to the formula on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as Fn

CT = 64       # channels a block (csrc/conv_module.cu)
TT = 64       # frames a tile
TPC = 4       # tiles a block's chunk
CHUNK = TT * TPC
KMAX = 32     # the longest kernel the kernels take
MOMENTUM = 0.99
# rows of the statistics tensor K10 returns
MEAN, VAR, RSTD, SCALE, SHIFT, COUNT = range(6)


def fits(u, w, b, gamma, beta, mesh, training) -> bool:
    """Whether the module runs on K10 and K11: u and the parameters bf16 on
    the card and the BatchNorm statistics the rank's own (no mesh, or one
    data row).  Such a module that the kernels do not take raises
    ValueError: D not a multiple of CT, K > KMAX, or eval with a gradient
    asked for (the eval form keeps nothing for a backward)."""
    if not u.is_cuda or any(t.dtype != torch.bfloat16
                            for t in (u, w, b, gamma, beta)):
        return False
    if mesh is not None and mesh.shape["data"] > 1:
        return False
    D, K = u.shape[-1] // 2, w.shape[1]
    if D % CT or K > KMAX:
        raise ValueError(f"K10/K11 take D a multiple of {CT} and kernels of "
                         f"at most {KMAX} taps, not D={D}, K={K}")
    if not training and torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, w, b, gamma, beta)):
        raise ValueError("K10's eval form keeps nothing for a backward: "
                         "run eval under torch.no_grad()")
    return True


def chunks(T: int) -> int:
    """A block's chunks of CHUNK frames in an utterance of T frames."""
    return -(-T // CHUNK)


def chunk_sums(x: torch.Tensor) -> torch.Tensor:
    """[B, T, ...] -> [B * chunks(T), ...]: sums over each chunk's frames
    (the kernels' partial rows, row b * chunks + chunk)."""
    B, T = x.shape[:2]
    n = chunks(T)
    x = Fn.pad(x, (0, 0) * (x.dim() - 2) + (0, n * CHUNK - T))
    return x.reshape(B, n, CHUNK, *x.shape[2:]).sum(2).reshape(
        B * n, *x.shape[2:])


def glu_plain(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """a [B, T, D] fp32: GLU of u, zero at padded frames."""
    uf = u.float()
    D = uf.shape[-1] // 2
    a = uf[..., :D] * torch.sigmoid(uf[..., D:])
    return torch.where(valid[..., None], a, 0.0)


def taps_plain(x: torch.Tensor, w: torch.Tensor, left: int,
               init=None) -> torch.Tensor:
    """init + sum_k w[:, k] x[t + k - left] over zeros outside [0, T): x
    [B, T, D] fp32, w [D, K] fp32, init [D] fp32 or None (0), taps in
    order."""
    T, K = x.shape[1], w.shape[1]
    xp = Fn.pad(x, (0, 0, left, K - 1 - left))
    out = torch.zeros_like(x) if init is None else init.expand_as(x)
    for k in range(K):
        out = out + xp[:, k:k + T] * w[:, k]
    return out


def dz_plain(ds, y, stats):
    """(dz = ds silu'(z), yhat) in fp32 from y and K10's statistics."""
    yf = y.float()
    z = yf * stats[SCALE] + stats[SHIFT]
    sg = torch.sigmoid(z)
    dz = ds.float() * (sg * (1.0 + z * (1.0 - sg)))
    return dz, (yf - stats[MEAN]) * stats[RSTD]


def conv_module_fwd_plain(u, valid, w, b, gamma, beta, mean, var, eps,
                          training):
    """Plain version of K10: (s, y, stats [6, D], new mean, new var) in
    training (y, s in u's dtype; the rest fp32), (s, None, None, None,
    None) in eval."""
    K = w.shape[1]
    y = taps_plain(glu_plain(u, valid), w.float(), (K - 1) // 2,
                   b.float()).to(u.dtype)
    if not training:
        A = torch.rsqrt(var.float() + eps) * gamma.float()
        Bs = beta.float() - mean.float() * A
        return Fn.silu(y.float() * A + Bs).to(u.dtype), None, None, None, None
    yv = torch.where(valid[..., None], y.float(), 0.0)
    part = torch.stack([chunk_sums(yv), chunk_sums(yv * yv)], 1)
    s1, s2 = part.sum(0)
    n = valid.sum().float()
    mu = s1 / n
    v = s2 / n - mu * mu
    rstd = torch.rsqrt(v + eps)
    A = rstd * gamma.float()
    stats = torch.stack([mu, v, rstd, A, beta.float() - mu * A,
                         n.expand_as(mu)])
    s = Fn.silu(y.float() * A + stats[SHIFT]).to(u.dtype)
    return (s, y, stats, MOMENTUM * mean.float() + 0.01 * mu,
            MOMENTUM * var.float() + 0.01 * v)


def conv_module_bwd_plain(ds, u, valid, w, y, stats, gamma):
    """Plain version of K11: (du [B, T, 2D] in u's dtype, dw, db, dgamma,
    dbeta in the parameters' dtype)."""
    K = w.shape[1]
    dz, yhat = dz_plain(ds, y, stats)
    sums = torch.stack([chunk_sums(dz), chunk_sums(dz * yhat)], 1).sum(0)
    P = stats[RSTD] * gamma.float()
    Q, R = P * sums[0] / stats[COUNT], P * sums[1] / stats[COUNT]
    dy = P * dz - valid[..., None] * (Q + yhat * R)
    da = taps_plain(dy, w.float().flip(1), K // 2)
    da = torch.where(valid[..., None], da, 0.0)
    uf = u.float()
    D = uf.shape[-1] // 2
    sg = torch.sigmoid(uf[..., D:])
    du = torch.cat([da * sg, da * uf[..., :D] * sg * (1.0 - sg)], -1)
    a = Fn.pad(glu_plain(u, valid), (0, 0, (K - 1) // 2, K // 2))
    T = u.shape[1]
    dwp = torch.stack([chunk_sums(dy * a[:, k:k + T]) for k in range(K)], -1)
    pdt = w.dtype
    return (du.to(u.dtype), dwp.sum(0).to(pdt), chunk_sums(dy).sum(0).to(pdt),
            sums[1].to(pdt), sums[0].to(pdt))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the library's entry points."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.conv_module_fwd.restype = i
    lib.conv_module_fwd.argtypes = [vp] * 8 + [f] + [vp] * 6 + [i] * 5 + [vp]
    lib.conv_module_bwd.restype = i
    lib.conv_module_bwd.argtypes = [vp] * 15 + [i] * 4 + [vp]
    lib.conv_module_chunk_frames.restype = i
    lib.conv_module_chunk_frames.argtypes = []
    if lib.conv_module_chunk_frames() != CHUNK:
        raise RuntimeError("csrc/conv_module.cu's chunk differs from CHUNK")
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    from rnnt_tpu_torch.kernels import build

    return bind(build.load("conv_module"))


def _check(tensors, dtypes):
    """`build.check_operands`, and every operand 16-byte aligned (the
    kernels' vector loads)."""
    from rnnt_tpu_torch.kernels import build

    build.check_operands(tensors, dtypes)
    for i, a in enumerate(tensors):
        if a.data_ptr() % 16:
            raise ValueError(f"operand {i} is not 16-byte aligned")


def conv_module_fwd(u, valid, w, b, gamma, beta, mean, var, eps, training):
    """K10: u [B, T, 2D], valid [B, T] bool, w [D, K], b, gamma, beta [D],
    the running mean and var [D] fp32 -> (s, y, stats, new mean, new var)
    as `conv_module_fwd_plain`."""
    if not u.is_cuda:
        return conv_module_fwd_plain(u, valid, w, b, gamma, beta, mean, var,
                                     eps, training)
    from rnnt_tpu_torch.kernels import build

    bf, f32 = torch.bfloat16, torch.float32
    B, T, D2 = u.shape
    D, K = w.shape
    _check((u, valid, w, b, gamma, beta, mean, var),
           (bf, torch.bool, bf, bf, bf, bf, f32, f32))
    if D2 != 2 * D or valid.shape != (B, T) or b.shape != (D,):
        raise ValueError("K10 operands do not fit one convolution module")
    lib, dev = _lib(), u.device
    s = torch.empty((B, T, D), dtype=bf, device=dev)
    y = part = stats = new_mean = new_var = None
    if training:
        y = torch.empty_like(s)
        part = torch.empty((B * chunks(T), 2, D), dtype=f32, device=dev)
        stats = torch.empty((6, D), dtype=f32, device=dev)
        new_mean, new_var = torch.empty_like(mean), torch.empty_like(var)
    ptr = [0 if a is None else a.data_ptr()
           for a in (y, s, part, stats, new_mean, new_var)]
    with torch.cuda.device(dev):
        err = lib.conv_module_fwd(
            *(a.data_ptr() for a in (u, valid, w, b, gamma, beta, mean, var)),
            float(eps), *ptr, B, T, D, K, int(training),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "conv_module_fwd")
    conv_module_fwd.launches += 1
    return s, y, stats, new_mean, new_var


def conv_module_bwd(ds, u, valid, w, y, stats, gamma):
    """K11: ds [B, T, D] (s's gradient), u, valid, w as K10, y and stats
    from K10's training form -> (du, dw, db, dgamma, dbeta) as
    `conv_module_bwd_plain`."""
    if not ds.is_cuda:
        return conv_module_bwd_plain(ds, u, valid, w, y, stats, gamma)
    from rnnt_tpu_torch.kernels import build

    bf, f32 = torch.bfloat16, torch.float32
    B, T, D2 = u.shape
    D, K = w.shape
    _check((ds, u, valid, w, y, stats, gamma),
           (bf, bf, torch.bool, bf, bf, f32, bf))
    if ds.shape != (B, T, D) or y.shape != ds.shape or stats.shape != (6, D):
        raise ValueError("K11 operands do not fit one convolution module")
    lib, dev = _lib(), ds.device
    rows = B * chunks(T)
    part1 = torch.empty((rows, 2, D), dtype=f32, device=dev)
    coef = torch.empty((3, D), dtype=f32, device=dev)
    part2 = torch.empty((rows, D * K + D), dtype=f32, device=dev)
    du = torch.empty_like(u)
    dw, db = torch.empty_like(w), torch.empty_like(gamma)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(gamma)
    with torch.cuda.device(dev):
        err = lib.conv_module_bwd(
            *(a.data_ptr() for a in (ds, u, valid, w, y, stats, gamma, part1,
                                     coef, part2, du, dw, db, dgamma,
                                     dbeta)),
            B, T, D, K, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "conv_module_bwd")
    conv_module_bwd.launches += 1
    return du, dw, db, dgamma, dbeta


conv_module_fwd.launches = 0
conv_module_bwd.launches = 0


class _ConvModule(torch.autograd.Function):
    """K10's training form forward, K11 backward; saves u, y and the
    statistics."""

    @staticmethod
    def forward(ctx, u, valid, w, b, gamma, beta, mean, var, eps):
        s, y, stats, new_mean, new_var = conv_module_fwd(
            u, valid, w, b, gamma, beta, mean, var, eps, True)
        ctx.save_for_backward(u, valid, w, y, stats, gamma)
        ctx.mark_non_differentiable(new_mean, new_var)
        return s, new_mean, new_var

    @staticmethod
    def backward(ctx, ds, _dmean, _dvar):
        u, valid, w, y, stats, gamma = ctx.saved_tensors
        du, dw, db, dgamma, dbeta = conv_module_bwd(
            ds.contiguous(), u, valid, w, y, stats, gamma)
        return du, None, dw, db, dgamma, dbeta, None, None, None


def conv_module(u, valid, w, b, gamma, beta, mean, var, eps, training):
    """s = silu(BatchNorm(depthwise(GLU(u) masked))) [B, T, D] (module
    docstring) with autograd in training, and (the updated running mean,
    var) in training, else None."""
    if training:
        s, new_mean, new_var = _ConvModule.apply(u, valid, w, b, gamma, beta,
                                                 mean, var, eps)
        return s, (new_mean, new_var)
    return conv_module_fwd(u, valid, w, b, gamma, beta, mean, var, eps,
                           False)[0], None
