"""Wrapper of the RNN-T lattice kernel K7 (`csrc/rnnt_lattice.cu`), and the
loss over materialised logits that uses it.

Replaces `rnnt_tpu/ops/rnnt_loss_pallas.py::_lattice_kernel`.  One launch
walks alpha and beta over T for every batch row.  Up to U+1 = 256 it runs the
warp design: one warp a (batch row, direction), alpha and beta side by side,
each lane owning a run of ceil((U+1) / 32) positions, the scan over the lanes
by shuffles and the previous row in registers.  Above it runs the block
design: one block a row, a doubling scan through shared memory, runs of
ceil((U+1) / 1024) positions a thread above U+1 = 1024, so any U+1 runs.  See
the source note for the bound.  `lattice_scan.launches_by_design` counts the
launches of each design (`lattice_last_design()` in the library).  On a CPU
tensor `lattice_scan` runs the plain scans of `ops.rnnt_loss_ref`; on a CUDA
tensor it launches the kernel or raises.

`rnnt_loss_pallas` is the port of `rnnt_tpu.ops.rnnt_loss_pallas`: the
log-softmax planes in PyTorch, the lattice in K7, the analytic backward of
`ops.rnnt_loss_ref`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rnnt_tpu_torch.ops import rnnt_loss_ref as ref

DESIGNS = ("warp", "block")  # lattice_last_design(): 0, 1
WARP_MAX_U1 = 256            # the warp design's U+1: 32 lanes x 8 positions


@functools.lru_cache(maxsize=None)
def _lib():
    from rnnt_tpu_torch.kernels import build

    lib = build.load("rnnt_lattice")
    fn = lib.rnnt_lattice
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.lattice_last_design.restype = ctypes.c_int
    lib.lattice_last_design.argtypes = []
    return lib, fn


def lattice_scan(b: torch.Tensor, e: torch.Tensor, logit_lengths: torch.Tensor,
                 label_lengths: torch.Tensor):
    """(alpha, beta [B, T, U+1] fp32, ll [B]) from the blank/emit planes b, e
    [B, T, U+1] (emit pre-masked with NEG from u = U_b on)."""
    if b.shape != e.shape or b.dim() != 3:
        raise ValueError(f"planes b {tuple(b.shape)} and e {tuple(e.shape)} "
                         "must both be [B, T, U+1]")
    if not b.is_cuda:
        return ref.lattice_scan_plain(b, e, logit_lengths, label_lengths)
    from rnnt_tpu_torch.kernels import build

    B, T, U1 = b.shape
    dev = b.device
    b = b.float().contiguous()
    e = e.float().contiguous()
    fl = logit_lengths.to(dev, torch.int32).contiguous()
    yl = label_lengths.to(dev, torch.int32).contiguous()
    alpha = torch.empty_like(b)
    beta = torch.empty_like(b)
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    lib, fn = _lib()
    with torch.cuda.device(dev):
        err = fn(b.data_ptr(), e.data_ptr(), fl.data_ptr(), yl.data_ptr(),
                 alpha.data_ptr(), beta.data_ptr(), ll.data_ptr(), B, T, U1,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "rnnt_lattice")
    lattice_scan.launches += 1
    lattice_scan.launches_by_design[DESIGNS[lib.lattice_last_design()]] += 1
    return alpha, beta, ll


lattice_scan.launches = 0
lattice_scan.launches_by_design = dict.fromkeys(DESIGNS, 0)


def rnnt_loss_pallas(logits, labels, logit_lengths, label_lengths):
    """Per-example RNN-T NLL with the lattice in K7 (plain scans on the
    CPU); the gradient is `ops.rnnt_loss_ref`'s."""
    return ref.rnnt_loss_with_lattice(
        logits, labels, logit_lengths, label_lengths, lattice_scan)
