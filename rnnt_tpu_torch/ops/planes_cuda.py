"""Wrapper of the fused joint-plane kernel K6 (`csrc/joint_planes.cu`), and
its plain PyTorch version.

Replaces `rnnt_tpu/ops/joint_loss_fused.py::_plane_kernel`.  For every
lattice cell (b, t, u) it reduces the joint's logits
tanh(f[b,t] + g[b,u] + b1) @ W2 + b2 over V to three fp32 planes
[B, T, U+1]: the logsumexp denominator, the blank logit (column 0) and the
emit logit (column labels_pad[b,u]), without writing the [B, T, U+1, V]
logits.  The kernel computes its own [cells, J] x [J, V] product; see the
source note for its bound.  Its launcher runs one of three designs, which
`joint_planes.launches_by_design` counts: bf16 within `wgmma_stages`'s
plan `wgmma` (128-cell tiles on `wgmma.mma_async`; W2 packed on the card
as `pack_w2` packs it, then streamed by TMA bulk copies through a ring),
other bf16 shapes `wmma`, fp32 `fma`.  On a CPU tensor the wrapper runs
`joint_planes_plain`; on a CUDA tensor it launches the kernel or raises.
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
_WGMMA = "joint_planes_bf16_wgmma"
DESIGNS = ("wgmma", "wmma", "fma")  # planes_last_design(): 0, 1, 2
_VT = 128  # the kernel's V chunk: W2 and b2 are padded to a multiple
# the WGMMA design (csrc/joint_planes.cu, namespace wg)
KB = 64                    # k of a W2 tile and of an h k-block
CELLS = 128                # cells a tile
STAGE_BYTES = _VT * KB * 2  # one ring stage: a [128 v x 64 k] bf16 tile
MAX_STAGES = 4
_ALIGN, _BAR_BYTES = 1024, 2 * MAX_STAGES * 8


def padded_j(J: int) -> int:
    """J padded for the WGMMA design: whole 64-deep k-blocks, at least two
    (a chunk is folded while the next one's second k-block runs)."""
    return max(2 * KB, -(-J // KB) * KB)


def padded_v(V: int) -> int:
    """V padded to whole 128-column chunks (every design)."""
    return -(-V // _VT) * _VT


def wgmma_stages(dtype, J: int, optin: int) -> int:
    """Ring stages of the WGMMA design (3 or 4), or 0 where the shape runs
    another design: bf16 only, and the h tile of 128 cells at the padded J,
    at least 3 W2 stages, the alignment slack and the barriers within the
    `optin` bytes of shared memory a block may use (J <= 704 on an H100)."""
    if dtype != torch.bfloat16:
        return 0
    free = optin - _ALIGN - _BAR_BYTES - padded_j(J) // KB * CELLS * KB * 2
    stages = min(MAX_STAGES, free // STAGE_BYTES)
    return stages if stages >= 3 else 0


def pack_w2(w2: torch.Tensor) -> torch.Tensor:
    """Plain version of the WGMMA launch's first kernel (`pack_w2_kernel`):
    W2 [J, V] zero-padded to [padded_j(J), padded_v(V)] and laid out in the
    order the design streams it: [128 v x 64 k] tiles, V
    chunk by V chunk, k-block by k-block within a chunk, each tile K-major
    (its row n holds W2[k0:k0+64, v0+n]) with the 128-byte swizzle applied:
    the 16-byte group c of row n sits at position c ^ (n % 8).  One flat
    tensor.  The launch packs on every call: in training W2 changes every
    step, so a cached copy would never be reused there, and none can go
    stale; the fused loss keeps the forward's copy for its backward (K8).
    """
    (J, V), Jp, Vp = w2.shape, padded_j(w2.shape[0]), padded_v(w2.shape[1])
    w2p = Fn.pad(w2, (0, Vp - V, 0, Jp - J))
    tiles = w2p.t().reshape(Vp // _VT, _VT, Jp // KB, 8, 8).permute(
        0, 2, 1, 3, 4)  # [chunk, k-block, n, 16-byte group, 8]
    n = torch.arange(_VT, device=w2.device)[:, None]
    group = torch.arange(8, device=w2.device)[None, :] ^ (n % 8)
    return tiles[:, :, n, group].reshape(-1)


def joint_planes_plain(f, g, labels_pad, b1, w2, b2):
    """Plain version: the logits of 4 batch rows at a time, with the
    kernel's rounding points (h in fp32, rounded to W2's dtype before the
    product; fp32 logits).  A label outside [0, V) (another vocabulary
    shard's, shifted into this shard's coordinates) matches no column: its
    emit is NEG, as in the kernel."""
    rows = 4
    B, T, _ = f.shape
    U1 = g.shape[1]
    V = w2.shape[1]
    out = [torch.empty((B, T, U1), dtype=torch.float32, device=f.device)
           for _ in range(3)]
    for r0 in range(0, B, rows):
        sl = slice(r0, r0 + rows)
        h = torch.tanh(f[sl].float()[:, :, None, :] + g[sl].float()[:, None]
                       + b1.float())
        logits = matmul_f32(h.to(w2.dtype), w2) + b2.float()
        out[0][sl] = torch.logsumexp(logits, -1)
        out[1][sl] = logits[..., 0]
        y = labels_pad[sl].long()
        idx = y.clamp(0, V - 1)[:, None, :, None].expand(-1, T, U1, 1)
        out[2][sl] = torch.where(((y >= 0) & (y < V))[:, None, :],
                                 torch.gather(logits, -1, idx)[..., 0], NEG)
    return tuple(out)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a K6 library's entry points (the package's
    build, or a copy that `kernels/lstm_ab.py --kernel planes` built; an
    older copy exports only the first two)."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    if hasattr(lib, _WGMMA):
        fn = getattr(lib, _WGMMA)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        lib.planes_card.restype = ctypes.c_int
        lib.planes_card.argtypes = [ctypes.c_void_p]
        lib.planes_pack_w2.restype = ctypes.c_int
        lib.planes_pack_w2.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.planes_last_design.restype = ctypes.c_int
        lib.planes_last_design.argtypes = []
    return lib


@functools.lru_cache(maxsize=None)
def _card(lib, device_index: int) -> tuple:
    """(SMs, opt-in shared memory a block may use) of a device."""
    out = (ctypes.c_int * 2)()
    from rnnt_tpu_torch.kernels import build

    with torch.cuda.device(device_index):
        build.check(lib, lib.planes_card(out), "planes_card")
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _lib():
    from rnnt_tpu_torch.kernels import build

    return bind(build.load("joint_planes"))


def joint_planes(f, g, labels_pad, b1, w2, b2, packed=None):
    """f [B, T, J], g [B, U+1, J] (the weight dtype), labels_pad [B, U+1]
    (ids outside [0, V) emit NEG), b1 [J], w2 [J, V], b2 [V] -> (denom,
    blank, emit) [B, T, U+1] fp32.  `packed` (CUDA, WGMMA design only): a
    flat tensor of padded_j(J) * padded_v(V) values of W2's dtype that the
    launch packs W2 into (`pack_w2`) and the caller keeps."""
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
    lib = _lib()
    planes = launch(lib, f, g, labels_pad, b1, w2, b2, packed)
    joint_planes.launches += 1
    joint_planes.launches_by_design[DESIGNS[lib.planes_last_design()]] += 1
    return planes


def launch(lib, f, g, labels_pad, b1, w2, b2, packed=None):
    """One launch of library `lib`'s kernel on CUDA tensors (shapes as
    `joint_planes` checks them; `packed` as there)."""
    from rnnt_tpu_torch.kernels import build

    B, T, J = f.shape
    U1 = g.shape[1]
    V = w2.shape[1]
    dt = w2.dtype
    if dt not in _ENTRY:
        raise TypeError(f"the plane kernel takes float32 or bfloat16 "
                        f"weights, not {dt}")
    dev = f.device
    if any(a.device != dev for a in (g, labels_pad, b1, w2, b2)):
        raise ValueError("all joint-plane inputs must be on one device")
    stages = 0
    if hasattr(lib, _WGMMA):  # an older copy has only the WMMA design
        stages = wgmma_stages(dt, J, _card(lib, dev.index)[1])
    f, g, y, b1, w2, b2 = pad_operands(f, g, labels_pad, b1, w2, b2,
                                       wgmma=stages > 0)
    Jp, Vp = f.shape[2], b2.shape[0]
    if packed is not None and not (
            stages and packed.shape == (Jp * Vp,) and packed.dtype == dt
            and packed.device == dev):
        raise ValueError(f"a packed W2 takes the WGMMA design and "
                         f"{Jp * Vp} values of {dt} on {dev}")
    planes = [torch.empty((B, T, U1), dtype=torch.float32, device=dev)
              for _ in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if stages:  # the launch packs W2 into `packed` first
            entry = _WGMMA
            if packed is None:
                packed = torch.empty((Jp * Vp,), dtype=dt, device=dev)
            err = lib.joint_planes_bf16_wgmma(
                f.data_ptr(), g.data_ptr(), y.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), packed.data_ptr(),
                *(p.data_ptr() for p in planes), B, T, U1, Jp, J, V, Vp,
                stages, stream)
        else:
            entry = _ENTRY[dt]
            err = getattr(lib, entry)(
                f.data_ptr(), g.data_ptr(), y.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), *(p.data_ptr() for p in planes),
                B, T, U1, Jp, V, Vp, stream)
    build.check(lib, err, entry)
    return tuple(planes)


def pack_w2_cuda(w2, lib=None) -> torch.Tensor:
    """The WGMMA launch's packing of W2 alone, on the card (what `pack_w2`
    computes; `chip_smoke.py` holds the two to equality)."""
    from rnnt_tpu_torch.kernels import build

    lib = _lib() if lib is None else lib
    w2 = w2.contiguous()
    (J, V), Jp, Vp = w2.shape, padded_j(w2.shape[0]), padded_v(w2.shape[1])
    packed = torch.empty((Jp * Vp,), dtype=w2.dtype, device=w2.device)
    with torch.cuda.device(w2.device):
        err = lib.planes_pack_w2(
            w2.data_ptr(), packed.data_ptr(), Jp, J, V, Vp,
            torch.cuda.current_stream(w2.device).cuda_stream)
    build.check(lib, err, "planes_pack_w2")
    return packed


def pad_operands(f, g, labels_pad, b1, w2, b2, wgmma: bool):
    """The kernel's operands: f, g, b1 in W2's dtype, zero-padded in J (to
    whole k-blocks for the WGMMA design, to whole 16-deep MMA steps in bf16
    otherwise), which adds tanh(0) * 0 = 0; b2 in fp32 padded with NEG to a
    multiple of 128 columns, so padded columns never win the max nor add to
    the sum; the labels in int32; W2 zero-padded to those J rows and 128
    columns, except for the WGMMA design, which packs (and pads) it from
    its own rows; all contiguous."""
    dt, (J, V) = w2.dtype, w2.shape
    jp = (padded_j(J) - J if wgmma
          else (-J) % 16 if dt == torch.bfloat16 else 0)
    vp = padded_v(V) - V
    f, g, b1 = (a.to(dt) for a in (f, g, b1))
    if jp:
        f, g, b1 = (Fn.pad(a, (0, jp)) for a in (f, g, b1))
    return (f.contiguous(), g.contiguous(),
            labels_pad.to(torch.int32).contiguous(), b1.contiguous(),
            w2.contiguous() if wgmma
            else Fn.pad(w2, (0, vp, 0, jp)).contiguous(),
            Fn.pad(b2.float(), (0, vp), value=NEG).contiguous())


joint_planes.launches = 0
joint_planes.launches_by_design = dict.fromkeys(DESIGNS, 0)
