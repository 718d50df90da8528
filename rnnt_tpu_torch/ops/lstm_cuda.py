"""Wrapper of the projected-LSTM inference sequence kernel
(`csrc/lstm_infer.cu`), and its plain PyTorch version.

Replaces `rnnt_tpu/ops/lstm_pallas.py::_fwd_infer_kernel`.  One launch runs
the whole recurrence over T; the kernel's bound on the H100 is streaming
Wh + Wp (13.1 MB in bf16 at the parity width) once per step, and the
sequential chain of steps; see the source note.

Inputs follow the TPU kernel: xp [T, B, 4H] in the weight dtype, Wh [P, 4H],
Wp [H, P], bias [4H], h0 [B, P], c0 [B, H] (fp32).  Returns
(h_seq [T, B, P] in the weight dtype, c_fin [B, H] fp32); h_fin is
h_seq[-1].  On a CPU tensor the wrapper runs `lstm_seq_infer_plain`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

_ENTRY = {torch.float32: "lstm_infer_f32", torch.bfloat16: "lstm_infer_bf16"}


def lstm_seq_infer_plain(xp, wh, wp, bias, h0, c0) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """Plain version: a Python loop over T with the kernel's rounding
    points (h to the weight dtype before @Wh, hid before @Wp; fp32
    accumulation and cell state)."""
    dt = wh.dtype
    T, B, H4 = xp.shape
    H = H4 // 4
    wh32, wp32, bias32 = wh.float(), wp.float(), bias.float()
    h = h0.to(dt)
    c = c0.float()
    out = torch.empty((T, B, wp.shape[1]), dtype=dt, device=xp.device)
    for t in range(T):
        z = xp[t].float() + bias32 + h.float() @ wh32
        i, g, f, o = torch.split(z, H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hid = (torch.sigmoid(o) * torch.tanh(c)).to(dt)
        h = (hid.float() @ wp32).to(dt)
        out[t] = h
    return out, c


@functools.lru_cache(maxsize=None)
def _lib(dtype):
    from rnnt_tpu_torch.kernels import build

    lib = build.load("lstm_infer")
    fn = getattr(lib, _ENTRY[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return lib, fn


def lstm_seq_infer(xp, wh, wp, bias, h0, c0) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Projected-LSTM recurrence over T: kernel on CUDA, plain on CPU."""
    T, B, H4 = xp.shape
    P, H = wh.shape[0], wp.shape[0]
    if wh.shape != (P, H4) or wp.shape != (H, P) or H4 != 4 * H:
        raise ValueError(f"shapes xp {tuple(xp.shape)}, wh {tuple(wh.shape)}, "
                         f"wp {tuple(wp.shape)} do not fit one LSTM")
    if not xp.is_cuda:
        return lstm_seq_infer_plain(xp, wh, wp, bias, h0, c0)
    from rnnt_tpu_torch.kernels import build

    dt = wh.dtype
    if dt not in _ENTRY:
        raise TypeError(f"the LSTM kernel takes float32 or bfloat16 weights, "
                        f"not {dt}")
    dev = xp.device
    if any(a.device != dev for a in (wh, wp, bias, h0, c0)):
        raise ValueError("all LSTM inputs must be on one device")
    xp = xp.to(dt).contiguous()
    wh, wp, bias = wh.contiguous(), wp.contiguous(), bias.to(dt).contiguous()
    c0 = c0.float().contiguous()
    # the kernel's own h buffer (rounded to dt); a copy, never the caller's
    hbuf = h0.to(dt).to(torch.float32, copy=True).contiguous()
    hidbuf = torch.empty((B, H), dtype=torch.float32, device=dev)
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    h_seq = torch.empty((T, B, P), dtype=dt, device=dev)
    c_fin = torch.empty((B, H), dtype=torch.float32, device=dev)
    lib, fn = _lib(dt)
    # the launcher sizes the grid for, and launches on, the current device
    with torch.cuda.device(dev):
        err = fn(xp.data_ptr(), wh.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                 c0.data_ptr(), hbuf.data_ptr(), hidbuf.data_ptr(),
                 h_seq.data_ptr(), c_fin.data_ptr(), bar.data_ptr(), T, B, H,
                 P, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, _ENTRY[dt])
    lstm_seq_infer.launches += 1
    return h_seq, c_fin


lstm_seq_infer.launches = 0
