"""Wrappers of the fused loss's backward kernels K8 and K9
(`csrc/joint_loss_bwd.cu`), and their plain PyTorch versions.

K8 (`joint_dlogits`) recomputes a batch chunk's logits on K6's WGMMA
design from the packed W2 that the forward's K6 launch left, and turns
each 128-cell, 128-column tile into d loss / d logits in registers: the
softmax times the occupancy, less the blank and emit occupancies, in fp32,
summed into db2's partial rows and stored in bf16.  It also writes hb, the
tanh tile in bf16.  K9 (`tanh_grads`) reads the dh product, recomputes h
in fp32 and writes only the sums of dh (1 - h^2): df over u, dg over t
(two stages) and db1's partial sums.  Every sum has a fixed order (see the
source note), so runs repeat bit for bit.

The plain versions follow the kernels' schedules step by step, tile by
tile and chunk by chunk, with the same orders of summation, so the CPU
tests hold the schedules to `joint_loss_fused._chunk_grads`.  On a CPU
tensor each wrapper runs its plain version; on a CUDA tensor it launches
the kernel or raises.  The fused loss routes here only bf16 CUDA joints
that fit K6's WGMMA plan (`fits`); everything else keeps the plain chain.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as Fn

from rnnt_tpu_torch.ops import planes_cuda
from rnnt_tpu_torch.ops.matmul import matmul_f32

CELLS, NV = planes_cuda.CELLS, planes_cuda._VT  # a K8 tile: cells, columns
WARPS = 8   # K8's consumer warps a CTA: db2 partial rows a CTA, 16 cells each
TG = 4      # t rows of one of dg's first-stage sums (K9)
UG = 8      # u rows of one of db1's partial sums (K9)
CHUNK_BYTES = 2 ** 30  # a chunk's dlogits, hb, dh and dg partial sums


def fits(f, g, b1, w2) -> bool:
    """Whether the backward runs on K8 and K9: CUDA tensors, all bf16, and
    the padded J within K6's WGMMA plan (J <= 704 on an H100)."""
    if not f.is_cuda or any(a.dtype != torch.bfloat16
                            for a in (f, g, b1, w2)):
        return False
    lib = planes_cuda._lib()
    optin = planes_cuda._card(lib, f.device.index)[1]
    return planes_cuda.wgmma_stages(w2.dtype, w2.shape[0], optin) > 0


def ctas(device) -> int:
    """K8's grid at most: one CTA an SM of `device`."""
    return planes_cuda._card(planes_cuda._lib(), device.index)[0]


def chunk_rows(B: int, T: int, U1: int, Jp: int, Vp: int) -> int:
    """Batch rows a chunk of the kernel backward: the largest divisor of B
    whose dlogits [cells, Vp] and hb [cells, Jp] in bf16, dh [cells, Jp]
    and dg's partial sums in fp32 fit CHUNK_BYTES (at least 1)."""
    per_row = T * U1 * (2 * Vp + 2 * Jp + 4 * Jp + 4 * Jp // TG)
    return next((c for c in range(B, 0, -1)
                 if B % c == 0 and c * per_row <= CHUNK_BYTES), 1)


def joint_dlogits_plain(f, g, y, b1, w2, b2, den, occ, gbl, gem, db2p, V,
                        blank_own, ctas):
    """Plain version of K8 on padded operands (`planes_cuda.pad_operands`
    with wgmma=True; w2 [Jp, V] padded in J): returns (dlogits [cells, Vp]
    bf16, columns >= V zero; hb [cells, Jp] bf16) and adds each warp's
    column sums into db2p [ctas * WARPS, Vp] tile after tile, as the
    kernel's `dlogits_chunk` does (tile i on CTA i % ctas)."""
    B, T, Jp = f.shape
    U1, Vp = g.shape[1], b2.shape[0]
    N = B * T * U1
    dev = f.device
    h = torch.tanh(f.float()[:, :, None, :] + g.float()[:, None] + b1.float())
    hb = h.to(w2.dtype).reshape(N, Jp)
    w2v = Fn.pad(w2, (0, Vp - V))
    yc = y.long()[:, None, :].expand(B, T, U1).reshape(N)
    yc = torch.where((yc >= 0) & (yc < V), yc, -1)
    rows = [a.reshape(N) for a in (den, occ, gbl, gem)]
    dl = torch.zeros((N, Vp), dtype=torch.bfloat16, device=dev)
    col = torch.arange(NV, device=dev)
    for tile in range(-(-N // CELLS)):
        n = slice(tile * CELLS, min(N, (tile + 1) * CELLS))
        dn, oc, gb, ge = (r[n][:, None] for r in rows)
        for v0 in range(0, Vp, NV):
            c = v0 + col
            x = matmul_f32(hb[n], w2v[:, v0:v0 + NV]) + b2[v0:v0 + NV]
            p = torch.exp(x - dn) * oc
            if blank_own:
                p = p - torch.where(c == 0, gb, 0.0)
            p = p - torch.where(c == yc[n][:, None], ge, 0.0)
            dl[n, v0:v0 + NV] = torch.where(c < V, p, 0.0).to(dl.dtype)
            p = Fn.pad(p, (0, 0, 0, CELLS - (n.stop - n.start)))
            # warp w: rows 16 w + k and 16 w + k + 8, then a tree over k
            s = p.reshape(WARPS, 2, 8, NV)
            s = s[:, 0] + s[:, 1]
            s = s[:, 0::2] + s[:, 1::2]
            s = s[:, 0::2] + s[:, 1::2]
            s = s[:, 0] + s[:, 1]
            r0 = (tile % ctas) * WARPS
            db2p[r0:r0 + WARPS, v0:v0 + NV] += s
    return dl, hb


def tanh_grads_plain(dh, f, g, b1, df, dg, db1p):
    """Plain version of K9: dh [B, T, U+1, J] fp32, f, g, b1 bf16 (J
    padded) -> df [B, T, J] (the sum over u in order), dg [B, U+1, J] (over
    t in groups of TG in order, then over the groups in order) and db1p
    [B, ceil((U+1)/UG), J] (dg's rows in groups of UG, in order), written
    into the given tensors."""
    B, T, U1, J = dh.shape
    h = torch.tanh(f.float()[:, :, None, :] + g.float()[:, None] + b1.float())
    dpre = dh.reshape(B, T, U1, J) * (1.0 - h * h)
    acc = torch.zeros((B, T, J), dtype=torch.float32, device=dh.device)
    for u in range(U1):
        acc = acc + dpre[:, :, u]
    df.copy_(acc)
    parts = []
    for t0 in range(0, T, TG):
        acc = torch.zeros((B, U1, J), dtype=torch.float32, device=dh.device)
        for t in range(t0, min(T, t0 + TG)):
            acc = acc + dpre[:, t]
        parts.append(acc)
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    dg.copy_(acc)
    for k, u0 in enumerate(range(0, U1, UG)):
        acc = torch.zeros((B, J), dtype=torch.float32, device=dh.device)
        for u in range(u0, min(U1, u0 + UG)):
            acc = acc + dg[:, u]
        db1p[:, k] = acc


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the backward library's entry points."""
    lib.loss_bwd_dlogits.restype = ctypes.c_int
    lib.loss_bwd_dlogits.argtypes = [ctypes.c_void_p] * 13 + [
        ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.loss_bwd_tanh.restype = ctypes.c_int
    lib.loss_bwd_tanh.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    from rnnt_tpu_torch.kernels import build

    return bind(build.load("joint_loss_bwd"))


def joint_dlogits(f, g, y, b1, w2, w2p, b2, den, occ, gbl, gem, db2p, V,
                  blank_own, ctas):
    """K8 on one batch chunk: f [B, T, Jp], g [B, U+1, Jp], b1 [Jp] bf16
    (J padded as `planes_cuda.pad_operands` pads it for WGMMA), y [B, U+1]
    int32 (labels in this shard's columns), w2 [Jp, V], w2p its packed
    tiles (`planes_cuda.pack_w2`, the forward's K6 launch), b2 [Vp] fp32
    padded with NEG, den, occ, gbl, gem [B, T, U+1] fp32, db2p
    [ctas * WARPS, Vp] fp32, added into.  Returns (dlogits [cells, Vp]
    bf16, valid in columns < V; hb [cells, Jp] bf16)."""
    if not f.is_cuda:
        return joint_dlogits_plain(f, g, y, b1, w2, b2, den, occ, gbl, gem,
                                   db2p, V, blank_own, ctas)
    from rnnt_tpu_torch.kernels import build

    B, T, Jp = f.shape
    U1, Vp = g.shape[1], b2.shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    build.check_operands(
        (f, g, y, b1, w2p, b2, den, occ, gbl, gem, db2p),
        (bf, bf, torch.int32, bf, bf, f32, f32, f32, f32, f32, f32))
    if (g.shape != (B, U1, Jp) or y.shape != (B, U1) or w2p.numel() != Jp * Vp
            or den.shape != (B, T, U1) or db2p.shape != (ctas * WARPS, Vp)):
        raise ValueError("K8 operands do not fit one joint chunk")
    lib, dev = _lib(), f.device
    stages = planes_cuda.wgmma_stages(
        bf, Jp, planes_cuda._card(planes_cuda._lib(), dev.index)[1])
    N = B * T * U1
    dl = torch.empty((N, Vp), dtype=bf, device=dev)
    hb = torch.empty((N, Jp), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        err = lib.loss_bwd_dlogits(
            *(a.data_ptr() for a in (f, g, y, b1, w2p, b2, den, occ, gbl,
                                     gem, dl, hb, db2p)),
            B, T, U1, Jp, V, Vp, Vp, stages, int(blank_own), db2p.shape[0],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "loss_bwd_dlogits")
    joint_dlogits.launches += 1
    return dl, hb


def tanh_grads(dh, f, g, b1, df, dg, db1p):
    """K9 on one batch chunk: dh [cells, Jp] fp32 (cells = B T (U+1)), f
    [B, T, Jp], g [B, U+1, Jp], b1 [Jp] bf16 -> written into df [B, T, Jp],
    dg [B, U+1, Jp] and db1p [B, ceil((U+1)/UG), Jp] fp32."""
    B, T, Jp = f.shape
    U1 = g.shape[1]
    if not dh.is_cuda:
        return tanh_grads_plain(dh.reshape(B, T, U1, Jp), f, g, b1, df, dg,
                                db1p)
    from rnnt_tpu_torch.kernels import build

    bf, f32 = torch.bfloat16, torch.float32
    build.check_operands((dh, f, g, b1, df, dg, db1p),
                         (f32, bf, bf, bf, f32, f32, f32))
    if (dh.shape != (B * T * U1, Jp) or dg.shape != (B, U1, Jp)
            or df.shape != (B, T, Jp) or db1p.shape != (B, -(-U1 // UG), Jp)):
        raise ValueError("K9 operands do not fit one joint chunk")
    lib, dev = _lib(), dh.device
    dgp = torch.empty((B, -(-T // TG), U1, Jp), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.loss_bwd_tanh(
            *(a.data_ptr() for a in (dh, f, g, b1, df, dgp, dg, db1p)),
            B, T, U1, Jp, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "loss_bwd_tanh")
    tanh_grads.launches += 1


joint_dlogits.launches = 0
tanh_grads.launches = 0
