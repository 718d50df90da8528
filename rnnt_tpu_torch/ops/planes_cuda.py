"""Wrapper of the fused joint-plane kernel K6 (`csrc/joint_planes.cu`), and
its plain PyTorch version.

Replaces `rnnt_tpu/ops/joint_loss_fused.py::_plane_kernel`.  For every
lattice cell (b, t, u) it reduces the joint's logits
tanh(f[b,t] + g[b,u] + b1) @ W2 + b2 over V to three fp32 planes
[B, T, U+1]: the logsumexp denominator, the blank logit (column 0) and the
emit logit (column labels_pad[b,u]), without writing the [B, T, U+1, V]
logits.  The kernel computes its own [cells, J] x [J, V] product (tensor-core
MMA for bf16, fp32 FMA for fp32); see the source note for its bound.  On a
CPU tensor the wrapper runs `joint_planes_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as Fn

from rnnt_tpu_torch.ops.matmul import matmul_f32
from rnnt_tpu_torch.ops.rnnt_loss_ref import NEG

_ENTRY = {torch.float32: "joint_planes_f32",
          torch.bfloat16: "joint_planes_bf16"}
_VT = 128  # the kernel's V chunk: W2 and b2 are padded to a multiple


def joint_planes_plain(f, g, labels_pad, b1, w2, b2):
    """Plain version: the logits of 4 batch rows at a time, with the
    kernel's rounding points (h in fp32, rounded to W2's dtype before the
    product; fp32 logits)."""
    rows = 4
    B, T, _ = f.shape
    U1 = g.shape[1]
    out = [torch.empty((B, T, U1), dtype=torch.float32, device=f.device)
           for _ in range(3)]
    for r0 in range(0, B, rows):
        sl = slice(r0, r0 + rows)
        h = torch.tanh(f[sl].float()[:, :, None, :] + g[sl].float()[:, None]
                       + b1.float())
        logits = matmul_f32(h.to(w2.dtype), w2) + b2.float()
        out[0][sl] = torch.logsumexp(logits, -1)
        out[1][sl] = logits[..., 0]
        idx = labels_pad[sl].long()[:, None, :, None].expand(-1, T, U1, 1)
        out[2][sl] = torch.gather(logits, -1, idx)[..., 0]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _lib(dtype):
    from rnnt_tpu_torch.kernels import build

    lib = build.load("joint_planes")
    fn = getattr(lib, _ENTRY[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return lib, fn


def joint_planes(f, g, labels_pad, b1, w2, b2):
    """f [B, T, J], g [B, U+1, J] (the weight dtype), labels_pad [B, U+1],
    b1 [J], w2 [J, V], b2 [V] -> (denom, blank, emit) [B, T, U+1] fp32."""
    B, T, J = f.shape
    U1 = g.shape[1]
    V = w2.shape[1]
    if g.shape != (B, U1, J) or w2.shape[0] != J or labels_pad.shape != (
            B, U1):
        raise ValueError(f"shapes f {tuple(f.shape)}, g {tuple(g.shape)}, "
                         f"labels {tuple(labels_pad.shape)}, "
                         f"w2 {tuple(w2.shape)} do not fit one joint")
    if not f.is_cuda:
        return joint_planes_plain(f, g, labels_pad, b1, w2, b2)
    from rnnt_tpu_torch.kernels import build

    dt = w2.dtype
    if dt not in _ENTRY:
        raise TypeError(f"the plane kernel takes float32 or bfloat16 "
                        f"weights, not {dt}")
    dev = f.device
    if any(a.device != dev for a in (g, labels_pad, b1, w2, b2)):
        raise ValueError("all joint-plane inputs must be on one device")
    # zero-padded J (to whole 16-deep MMA steps) adds tanh(0) * 0 = 0
    jp = (-J) % 16 if dt == torch.bfloat16 else 0
    vp = (-V) % _VT
    f = Fn.pad(f.to(dt), (0, jp)).contiguous()
    g = Fn.pad(g.to(dt), (0, jp)).contiguous()
    b1 = Fn.pad(b1.to(dt), (0, jp)).contiguous()
    w2 = Fn.pad(w2, (0, vp, 0, jp)).contiguous()
    b2 = Fn.pad(b2.float(), (0, vp), value=NEG).contiguous()
    y = labels_pad.to(torch.int32).contiguous()
    planes = [torch.empty((B, T, U1), dtype=torch.float32, device=dev)
              for _ in range(3)]
    lib, fn = _lib(dt)
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), g.data_ptr(), y.data_ptr(), b1.data_ptr(),
                 w2.data_ptr(), b2.data_ptr(), *(p.data_ptr() for p in planes),
                 B, T, U1, J + jp, V, V + vp,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, _ENTRY[dt])
    joint_planes.launches += 1
    return tuple(planes)


joint_planes.launches = 0
