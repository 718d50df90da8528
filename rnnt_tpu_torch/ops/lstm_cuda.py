"""Wrappers of the projected-LSTM sequence kernels, their plain PyTorch
versions, and the differentiable sequence op `lstm_seq`.

- `lstm_seq_infer` (K2, `csrc/lstm_infer.cu`) replaces
  `rnnt_tpu/ops/lstm_pallas.py::_fwd_infer_kernel`: the recurrence without
  residuals, for inference.
- `lstm_fwd` (K4, the same source with residuals) replaces `::_fwd_kernel`:
  also z_seq [T, B, 4H] and c_seq [T, B, H] in the weight dtype.
- `lstm_bwd` (K5, `csrc/lstm_bwd.cu`) replaces `::_bwd_kernel`: the
  reverse-time BPTT, dz_seq [T, B, 4H] and dh_total_seq [T, B, P] in the
  weight dtype, dh0 [B, P] and dc0 [B, H] in fp32.

Each launch runs a whole sequence: one persistent cooperative launch, one
block per SM (at most H; fewer with `set_block_cap`), two grid-wide
exchanges a step.  The steps are a sequential chain, so what sets the pace
is the latency of a step: its products, its grid-wide exchange (h and hid
in the forward, dh_total and dz in the backward), and the barriers.  Three
designs fill that structure, and the launcher picks one from the shape's
shared-memory plan before it launches, never after a failed launch:

- LAT (bf16 K2 at B <= 8, the serving batch, where its plan fits): the
  weight slices resident as in MMA, K of both products split over all 16
  warps with the batch rows as the MMA's N, and an exchange of tagged
  words (value and step tag in one 32-bit store) polled straight into the
  MMA fragments: no grid barrier.  The parity width fits on 114 to 132
  SMs; H=3072, P=768 does not (FMA).
- MMA (bf16 K4 and K5, and bf16 K2 above LAT's batch, where the plan
  fits): each block keeps its weight
  slices in shared memory for the whole launch, runs both step products on
  the tensor cores (mma.sync m16n8k16, fp32 accumulation, batch rows as M
  in passes of up to 64) and streams the bf16 exchange through a cp.async
  ring.  At the parity width on 132 SMs K4 holds 84 KB + 21 KB of weights,
  K5 82 KB + 21 KB.  K4's plan takes any number of units a block within the
  shared memory (so also 114 SMs at the parity width); K5's takes at most
  16 units and 8 P columns a block (128 SMs or more at the parity width).
- FMA (fp32 K2, K4 and K5; bf16 outside the plans, e.g. H=3072, P=768):
  block_dots on the FMA units, the weights re-read from L2 every pass of 4
  batch rows (8 in bf16), an fp32 exchange.  fp32 stays here: TF32 tensor
  cores would break the 1e-4 agreement with the plain version.

`lstm_seq_infer.launches_by_design`, `lstm_fwd.launches_by_design` and
`lstm_bwd.launches_by_design` count the launches of each design beside
`launches`.  The scratch buffers hold 4 bytes a padded value (rows padded
to a multiple of 16), which fits every design's exchange; K2's hid scratch
also holds the h words of LAT's exchange, which the launcher zeroes.

Inputs follow the TPU kernels: xp [T, B, 4H] in the weight dtype, Wh
[P, 4H], Wp [H, P], bias [4H], h0 [B, P], c0 [B, H] (fp32).  On a CPU
tensor each wrapper runs its plain version; on a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rnnt_tpu_torch.ops.matmul import matmul_f32, matmul_to
from rnnt_tpu_torch.trace import spanned

_DT = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_shapes(xp, wh, wp):
    T, B, H4 = xp.shape
    P, H = wh.shape[0], wp.shape[0]
    if wh.shape != (P, H4) or wp.shape != (H, P) or H4 != 4 * H:
        raise ValueError(f"shapes xp {tuple(xp.shape)}, wh {tuple(wh.shape)}, "
                         f"wp {tuple(wp.shape)} do not fit one LSTM")
    return T, B, H, P


def _check_dtype(dt):
    if dt not in _DT:
        raise TypeError(f"the LSTM kernels take float32 or bfloat16 weights, "
                        f"not {dt}")


def lstm_fwd_plain(xp, wh, wp, bias, h0, c0):
    """Plain version of K4: a Python loop over T with the kernel's rounding
    points (h to the weight dtype before @Wh, hid before @Wp; fp32
    accumulation and cell state).  Returns (h_seq, z_seq, c_seq, c_fin)."""
    dt = wh.dtype
    T, B, H4 = xp.shape
    H = H4 // 4
    wh32, wp32, bias32 = wh.float(), wp.float(), bias.float()
    h = h0.to(dt)
    c = c0.float()
    out = torch.empty((T, B, wp.shape[1]), dtype=dt, device=xp.device)
    z_seq = torch.empty((T, B, H4), dtype=dt, device=xp.device)
    c_seq = torch.empty((T, B, H), dtype=dt, device=xp.device)
    for t in range(T):
        z = xp[t].float() + bias32 + h.float() @ wh32
        i, g, f, o = torch.split(z, H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hid = (torch.sigmoid(o) * torch.tanh(c)).to(dt)
        h = (hid.float() @ wp32).to(dt)
        out[t] = h
        z_seq[t] = z
        c_seq[t] = c
    return out, z_seq, c_seq, c


def lstm_seq_infer_plain(xp, wh, wp, bias, h0, c0) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """Plain version of K2: K4's loop without the residuals' use."""
    h_seq, _, _, c_fin = lstm_fwd_plain(xp, wh, wp, bias, h0, c0)
    return h_seq, c_fin


def lstm_bwd_plain(z_seq, c_seq, c0, dout, whT, wpT):
    """Plain version of K5: the reverse-time loop of the TPU backward kernel
    (dh_total and dz rounded to the weight dtype before their products, dh
    and dc carried in fp32).  Returns (dz_seq, dh_total_seq, dh0, dc0)."""
    dt = whT.dtype
    T, B, H4 = z_seq.shape
    H = H4 // 4
    whT32, wpT32 = whT.float(), wpT.float()
    dh = torch.zeros((B, whT.shape[1]), dtype=torch.float32,
                     device=z_seq.device)
    dc = torch.zeros((B, H), dtype=torch.float32, device=z_seq.device)
    dz_seq = torch.empty_like(z_seq, dtype=dt)
    dht_seq = torch.empty_like(dout, dtype=dt)
    for t in range(T - 1, -1, -1):
        zi, zg, zf, zo = torch.split(z_seq[t].float(), H, dim=-1)
        i, g = torch.sigmoid(zi), torch.tanh(zg)
        f, o = torch.sigmoid(zf), torch.sigmoid(zo)
        c_t = c_seq[t].float()
        c_prev = c0.float() if t == 0 else c_seq[t - 1].float()
        dht = (dout[t].float() + dh).to(dt)
        dhid = dht.float() @ wpT32
        tanh_c = torch.tanh(c_t)
        dc = dc + dhid * o * (1.0 - tanh_c * tanh_c)
        dz = torch.cat([dc * g * i * (1.0 - i), dc * i * (1.0 - g * g),
                        dc * c_prev * f * (1.0 - f),
                        dhid * tanh_c * o * (1.0 - o)], dim=-1).to(dt)
        dc = dc * f
        dz_seq[t] = dz
        dht_seq[t] = dht
        dh = dz.float() @ whT32
    return dz_seq, dht_seq, dh, dc


@functools.lru_cache(maxsize=None)
def _lib(entry):
    from rnnt_tpu_torch.kernels import build

    lib = build.load("lstm_bwd" if entry.startswith("lstm_bwd")
                     else "lstm_infer")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    n_ptr = {"lstm_infer": 10, "lstm_fwd": 12, "lstm_bwd": 13}[
        entry.rsplit("_", 1)[0]]
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.lstm_last_design.restype = ctypes.c_int
    lib.lstm_last_design.argtypes = []
    return lib, fn


_DESIGNS = ("fma", "mma", "lat")  # lstm_last_design(): 0, 1, 2
_LIBS = ("lstm_infer", "lstm_bwd")


def set_block_cap(cap: int) -> None:
    """Caps the grid of every later LSTM kernel launch (K2, K4, K5) at `cap`
    blocks; 0 restores one block per SM.  This lets one card run the
    kernels as a card with fewer SMs would (e.g. 114 on an H100 PCIe)."""
    from rnnt_tpu_torch.kernels import build

    for name in _LIBS:
        fn = build.load(name).lstm_set_block_cap
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int]
        fn(int(cap))


def _count(wrapper, lib):
    """One launch of `wrapper`, under the design its launcher picked."""
    wrapper.launches += 1
    wrapper.launches_by_design[_DESIGNS[lib.lstm_last_design()]] += 1


def _round16(n):
    return -(-n // 16) * 16


def _forward_launch(kind, xp, wh, wp, bias, h0, c0, residuals: bool):
    """Launch K2 (residuals=False) or K4 on CUDA tensors."""
    from rnnt_tpu_torch.kernels import build

    T, B, H, P = _check_shapes(xp, wh, wp)
    dt = wh.dtype
    _check_dtype(dt)
    dev = xp.device
    if any(a.device != dev for a in (wh, wp, bias, h0, c0)):
        raise ValueError("all LSTM inputs must be on one device")
    xp = xp.to(dt).contiguous()
    wh, wp, bias = wh.contiguous(), wp.contiguous(), bias.to(dt).contiguous()
    c0 = c0.float().contiguous()
    # the kernel's own h buffer: h0 rounded to dt (a copy, never the
    # caller's), then room for the MMA design's padded bf16 exchange;
    # 4 bytes a padded value of hid and h (LAT's tagged words of both)
    off = -(-B * P // 4) * 4
    hbuf = torch.empty((off + B * _round16(P),), dtype=torch.float32,
                       device=dev)
    hbuf[:B * P].copy_(h0.to(dt).reshape(-1))  # one device op
    hidbuf = torch.empty((B * (_round16(H) + _round16(P)),),
                         dtype=torch.float32, device=dev)
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    h_seq = torch.empty((T, B, P), dtype=dt, device=dev)
    c_fin = torch.empty((B, H), dtype=torch.float32, device=dev)
    ptrs = [xp, wh, wp, bias, c0, hbuf, hidbuf, h_seq, c_fin]
    extra = ()
    if residuals:
        extra = (torch.empty((T, B, 4 * H), dtype=dt, device=dev),
                 torch.empty((T, B, H), dtype=dt, device=dev))
    entry = f"{kind}_{_DT[dt]}"
    lib, fn = _lib(entry)
    # the launcher sizes the grid for, and launches on, the current device
    with torch.cuda.device(dev):
        err = fn(*(a.data_ptr() for a in (*ptrs, *extra, bar)), T, B, H, P,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, entry)
    return lib, (h_seq, *extra, c_fin)


def lstm_seq_infer(xp, wh, wp, bias, h0, c0) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """K2: projected-LSTM recurrence over T, no residuals.  Returns (h_seq
    [T, B, P] in the weight dtype, c_fin [B, H] fp32); h_fin is h_seq[-1]."""
    _check_shapes(xp, wh, wp)
    if not xp.is_cuda:
        return lstm_seq_infer_plain(xp, wh, wp, bias, h0, c0)
    lib, out = _forward_launch("lstm_infer", xp, wh, wp, bias, h0, c0, False)
    _count(lstm_seq_infer, lib)
    return out


lstm_seq_infer.launches = 0
lstm_seq_infer.launches_by_design = {"lat": 0, "mma": 0, "fma": 0}


def lstm_fwd(xp, wh, wp, bias, h0, c0):
    """K4: the recurrence with residuals.  Returns (h_seq, z_seq, c_seq in
    the weight dtype, c_fin fp32)."""
    _check_shapes(xp, wh, wp)
    if not xp.is_cuda:
        return lstm_fwd_plain(xp, wh, wp, bias, h0, c0)
    lib, out = _forward_launch("lstm_fwd", xp, wh, wp, bias, h0, c0, True)
    _count(lstm_fwd, lib)
    return out


lstm_fwd.launches = 0
lstm_fwd.launches_by_design = {"mma": 0, "fma": 0}


def lstm_bwd(z_seq, c_seq, c0, dout, whT, wpT):
    """K5: reverse-time BPTT from the residuals and the output gradient
    dout [T, B, P] (weight dtype), with whT [4H, P] and wpT [P, H].
    Returns (dz_seq, dh_total_seq, dh0, dc0)."""
    T, B, H4 = z_seq.shape
    H, P = H4 // 4, whT.shape[1]
    if (c_seq.shape != (T, B, H) or dout.shape != (T, B, P)
            or whT.shape != (H4, P) or wpT.shape != (P, H)):
        raise ValueError(f"shapes z {tuple(z_seq.shape)}, c "
                         f"{tuple(c_seq.shape)}, dout {tuple(dout.shape)}, "
                         f"whT {tuple(whT.shape)}, wpT {tuple(wpT.shape)} do "
                         "not fit one LSTM")
    if not z_seq.is_cuda:
        return lstm_bwd_plain(z_seq, c_seq, c0, dout, whT, wpT)
    from rnnt_tpu_torch.kernels import build

    dt = whT.dtype
    _check_dtype(dt)
    dev = z_seq.device
    args = [a.contiguous() for a in (z_seq.to(dt), c_seq.to(dt), c0.float(),
                                     dout.to(dt), whT, wpT.to(dt))]
    if any(a.device != dev for a in args):
        raise ValueError("all LSTM inputs must be on one device")
    # 4 bytes a padded value: fp32 [B, P] and [B, 4H] (FMA) or bf16 rows
    # padded to 16 (MMA), whichever design the launcher picks
    dhtot = torch.empty((B * _round16(P),), dtype=torch.float32, device=dev)
    dzbuf = torch.empty((B * _round16(H4),), dtype=torch.float32, device=dev)
    dz_seq = torch.empty((T, B, H4), dtype=dt, device=dev)
    dht_seq = torch.empty((T, B, P), dtype=dt, device=dev)
    dh0 = torch.empty((B, P), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    entry = f"lstm_bwd_{_DT[dt]}"
    lib, fn = _lib(entry)
    with torch.cuda.device(dev):
        err = fn(*(a.data_ptr() for a in (*args, dhtot, dzbuf, dz_seq,
                                          dht_seq, dh0, dc0, bar)),
                 T, B, H, P, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, entry)
    _count(lstm_bwd, lib)
    return dz_seq, dht_seq, dh0, dc0


lstm_bwd.launches = 0
lstm_bwd.launches_by_design = {"mma": 0, "fma": 0}


class _LSTMSeq(torch.autograd.Function):
    """x [B, T, F] -> (h_seq [T, B, P], c_fin [B, H]) through K4, with K5 in
    the backward (the JAX `lstm_seq` custom_vjp)."""

    @staticmethod
    @spanned("rnnt.lstm")
    def forward(ctx, x, wx, wh, bias, wp, c0, h0):
        B, T, F = x.shape
        dt = wh.dtype
        xp = matmul_to(x.reshape(B * T, F), wx, dt).reshape(B, T, -1)
        xp = xp.transpose(0, 1).contiguous()
        h_seq, z_seq, c_seq, c_fin = lstm_fwd(xp, wh, wp, bias, h0.to(dt),
                                              c0.float())
        ctx.save_for_backward(x, wx, wh, bias, wp, z_seq, c_seq, h_seq, c0,
                              h0)
        return h_seq, c_fin

    @staticmethod
    @spanned("rnnt.lstm.bwd")
    def backward(ctx, d_hseq, d_cfin):
        # the final-c cotangent is ignored, as in the JAX package: training
        # discards the state and decoding never differentiates
        x, wx, wh, bias, wp, z_seq, c_seq, h_seq, c0, h0 = ctx.saved_tensors
        B, T, F = x.shape
        dt = wh.dtype
        H4 = wh.shape[1]
        H, P = H4 // 4, wh.shape[0]
        if d_hseq is None:
            d_hseq = torch.zeros_like(h_seq)
        dz_seq, dht_seq, dh0, dc0 = lstm_bwd(
            z_seq, c_seq, c0.float(), d_hseq.to(dt).contiguous(),
            wh.t().contiguous(), wp.t().contiguous())
        dz = dz_seq.reshape(T * B, H4)
        x_flat = x.transpose(0, 1).reshape(T * B, F).to(dt)
        h_prev = torch.cat([h0.to(dt)[None], h_seq[:-1]], 0).reshape(T * B, P)
        # hid recomputed from the ROUNDED residuals, as the JAX backward does
        hid = (torch.sigmoid(z_seq[..., 3 * H:].float())
               * torch.tanh(c_seq.float())).to(dt).reshape(T * B, H)
        dwx = matmul_f32(x_flat.t(), dz)
        dwh = matmul_f32(h_prev.t(), dz)
        dwp = matmul_f32(hid.t(), dht_seq.reshape(T * B, P))
        dbias = dz.float().sum(0)
        dx = matmul_f32(dz, wx.t().to(dt)).reshape(T, B, F).transpose(0, 1)
        return (dx.to(x.dtype), dwx.to(wx.dtype), dwh.to(wh.dtype),
                dbias.to(bias.dtype), dwp.to(wp.dtype), dc0.to(c0.dtype),
                dh0.to(h0.dtype))


def lstm_seq(x, wx, wh, bias, wp, c0, h0):
    """Differentiable projected LSTM over x [B, T, F] (the JAX `lstm_seq`):
    returns (h_seq [B, T, P], (c_fin, h_fin)).  The input projection x @ Wx
    is one product outside the kernel with fp32 accumulation, rounded to
    the weight dtype (`matmul_to`, as at inference); the recurrence runs in K4 and its backward in K5."""
    h_seq, c_fin = _LSTMSeq.apply(x, wx, wh, bias, wp, c0, h0)
    return h_seq.transpose(0, 1), (c_fin, h_seq[-1].to(h0.dtype))
