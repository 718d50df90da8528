"""Wrapper of the beam-search kernel (`csrc/beam_search.cu`).

Replaces `rnnt_tpu/ops/beam_pallas.py::_beam_kernel`: one launch runs the
whole K-beam search over every encoder frame, with the semantics and the
rounding points of `decode.beam.beam_search_encoded_plain`, its plain
version.  The wrapper prepares the initial beam as the TPU wrapper does (the
start token 0 through `model.predict_step`, scores [0, NEG, ...]), hands the
kernel the weights where the model keeps them, allocates every output and
the workspace with `torch.empty`, launches, checks the error code and counts
the launch.  The CUDA kernel needs no batch or vocabulary padding (the TPU
kernel's are tiling needs), so B = 1 runs as it is.

In bf16 the advance's prediction-net products run on streamed weight
slices where `stream_plan` admits the shape (the "stream" design; the rest,
fp32 among them, runs the "fma" design): the wrapper packs each layer's
gate and Wp columns once into per-block runs (`packed_slices`, kept with
the model until a weight changes) and the kernel streams them into shared
memory.  The launcher reports the design it ran; `beam_search` counts
launches by design.

On a CPU tensor `beam_search` runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from rnnt_tpu_torch.decode import beam as beam_mod
from rnnt_tpu_torch.models.encoder import require_lstm_encoder

_ENTRY = {torch.float32: "beam_search_f32", torch.bfloat16: "beam_search_bf16"}
MAX_LAYERS = 4  # prediction-net layers the launcher takes
SLICE = 8  # H, P, J and V are cut into column groups of 8 (SLICE in the source)
_N_PTRS = 8 + 8 * MAX_LAYERS + 8 + 2 * MAX_LAYERS
DESIGNS = ("fma", "stream")  # beam_last_design(): 0, 1
# the timeline phases whose nanoseconds each block adds to its row of
# `phase_ns` (enum Phase in the source)
PHASES = ("fj_joint", "logits", "lse", "candidates", "choose", "gates",
          "proj", "joint", "merge", "gather", "barrier", "stage", "ring_wait",
          "warp_sync", "cell")


def grid_blocks(device) -> int:
    """Blocks of a launch on `device`: one per SM, as the launcher sizes
    the grid (the rows of `phase_ns`)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def phase_split(phase_ns: torch.Tensor) -> dict:
    """Milliseconds by phase from a timed launch's `phase_ns` [blocks,
    PHASES]: block 0's row, the row of the block that spends the most time
    outside the barrier wait (the pace setter), and each phase's maximum
    over blocks."""
    ms = phase_ns.double().cpu() / 1e6
    busy = ms.sum(1) - ms[:, PHASES.index("barrier")]
    heavy = int(busy.argmax())

    def named(row):  # a build with fewer phases fills the first ones
        return {n: float(v) for n, v in zip(PHASES, row)}
    return {"block0": named(ms[0]), "heaviest_block": heavy,
            "heaviest": named(ms[heavy]), "max": named(ms.max(0).values)}


# ---- the streamed advance: its plan and the packed weight slices ----
# Constants of the source: threads and warps a block, rows a block_dots
# pass, bytes of 8 rows of a k16 slice, the most rows of a block's slice of
# a product and hypothesis rows.
NT, NWARP, BCH, HALF = 512, 16, 4, 256
MAXR, MAXN = 64, 16
# Ring slots a warp: 2 (64 KB a block at the parity width).  A deeper ring
# prefetches more, but the shared memory it takes comes out of L1, where
# the kernel's stack lives: 4 slots ran the 15 s search 5% slower on the
# H100 (PERF.md).
RING_SLOTS = 2


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def slice8(i: int, n: int, parts: int) -> int:
    """First column of block i's slice of n columns (groups of SLICE)."""
    return i * (n // SLICE) // parts * SLICE


def slice_max(n: int, parts: int) -> int:
    """Widest slice of n columns a block owns."""
    return -(-(n // SLICE) // parts) * SLICE


def gate_k(D: int, P: int, layer: int) -> int:
    """k of a layer's packed gate product: x (din padded to 16), then h."""
    return _r16(D if layer == 0 else P) + _r16(P)


def slot_bytes(H: int, P: int, nblk: int) -> int:
    """Bytes of a ring slot: one k16 slice of the widest block slice."""
    return max(4 * slice_max(H, nblk), slice_max(P, nblk)) // 8 * HALF


def xb_stride(D: int, P: int, H: int, n_layers: int) -> int:
    """Row stride (values) of the staged bf16 hypothesis rows: the widest
    k of any product rounded to 64, plus 16 (`xb_stride` in the source)."""
    k = max([_r16(H)] + [gate_k(D, P, i) for i in range(min(n_layers, 2))])
    return -(-k // 64) * 64 + 16


def smem_bytes(B, K, nblk, *, V, P, J, D, H, n_layers, slots) -> int:
    """A block's shared memory (`carve_smem` in the source); slots = 0 is
    the FMA design's layout."""
    N = B * K
    kx = max(D, P, J) if slots else max(D, P, H, J)
    ncmax = max(4 * slice_max(H, nblk), slice_max(P, nblk),
                slice_max(J, nblk), slice_max(V, nblk))
    ncand = min(B, 8) * nblk * K
    w = (NT * SLICE * BCH + ncmax * BCH + BCH * kx + (0 if slots else BCH * P)
         + B * slice_max(J, nblk) + N * slice_max(V, nblk) + 2 * ncand
         + 2 * BCH + 14 * N + N * K)
    if slots:
        w = -(-w // 4) * 4 + N * xb_stride(D, P, H, n_layers) // 2
        w = -(-w // 2) * 2 + 2 * NWARP * slots
        w = -(-w // 32) * 32 + NWARP * slots * slot_bytes(H, P, nblk) // 4
    return 4 * w


def stream_plan(dtype, B, K, nblk, optin, *, V, P, J, D, H,
                n_layers) -> int:
    """Ring slots a warp for the streamed advance (RING_SLOTS), or 0 where
    the shape runs the FMA design.  The plan takes bf16 only; every block's
    slices whole 16-byte vectors (H, P multiples of SLICE); at most MAXN
    hypothesis rows (N = B K) and MAXR rows a block's gate or Wp slice (two
    a lane); and the ring in the `optin` bytes of shared memory a block may
    use."""
    if dtype != torch.bfloat16 or H % SLICE or P % SLICE:
        return 0
    if B * K > MAXN or max(4 * slice_max(H, nblk), slice_max(P, nblk)) > MAXR:
        return 0
    fits = smem_bytes(B, K, nblk, V=V, P=P, J=J, D=D, H=H, n_layers=n_layers,
                      slots=RING_SLOTS) <= optin
    return RING_SLOTS if fits else 0


def _gate_rows(wx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """[Wx; Wh] as rows 4u + gate over k: x padded to 16, then h."""
    din, P = wx.shape[0], wh.shape[0]
    H = wx.shape[1] // 4
    kx, kh = _r16(din), _r16(P)
    w = wx.new_zeros((kx + kh, 4 * H))
    w[:din] = wx
    w[kx:kx + P] = wh
    return w.reshape(kx + kh, 4, H).permute(2, 1, 0).reshape(4 * H, kx + kh)


def slice_order(segments) -> list:
    """A product's k16 slices in warp order (`warp_share` in the source):
    the warps dealt evenly to the segments (a layer's x and h, or Wp's one),
    the lw-th of a segment's ws warps taking its slices lw, lw + ws, ..."""
    ws, order, base = NWARP // len(segments), [], 0
    for n in segments:
        for lw in range(ws):
            order += range(base + lw, base + n, ws)
        base += n
    return order


def pack_rows(a: torch.Tensor, bounds, segments) -> torch.Tensor:
    """Rows of a [R, k] (k a multiple of 16, its k16 slices in `segments`),
    cut into blocks at `bounds` (multiples of 8), in the kernel's packed
    order: block by block, its k16 slices in `slice_order`, each slice its
    rows in order, 16 values a row."""
    nsl = a.shape[1] // 16
    order = torch.tensor(slice_order(segments), device=a.device)
    runs = []
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        if r1 > r0:
            blk = a[r0:r1].reshape(r1 - r0, nsl, 16).permute(1, 0, 2)
            runs.append(blk[order].reshape(-1))
    return torch.cat(runs)


def pack_layer(wx, wh, wp, nblk: int):
    """One layer's packed (gate slices, Wp slices) for a grid of nblk
    blocks: block b owns units slice8(b, H) .. (rows 4u + gate) and Wp
    columns slice8(b, P) ..."""
    H, P = wp.shape
    wpt = wp.new_zeros((P, _r16(H)))
    wpt[:, :H] = wp.t()
    return (pack_rows(_gate_rows(wx, wh),
                      [4 * slice8(b, H, nblk) for b in range(nblk + 1)],
                      (_r16(wx.shape[0]) // 16, _r16(P) // 16)),
            pack_rows(wpt, [slice8(b, P, nblk) for b in range(nblk + 1)],
                      (_r16(H) // 16,)))


_PACKED = weakref.WeakKeyDictionary()  # model -> (key, packed layers)


def packed_slices(model, nblk: int):
    """Each prediction-net layer's `pack_layer`, made once and kept with
    the model.  The key holds every weight's data_ptr and version counter,
    which an in-place update (an optimizer step, a copy_) bumps, so a
    changed weight gives a new copy and a stale one is never used (~45 MB
    of device memory at the parity width)."""
    ws = [(blk.lstm.wx, blk.lstm.wh, blk.lstm.wp)
          for blk in model.prediction.layers]
    key = (nblk, tuple((t.device, t.dtype, tuple(t.shape), t.data_ptr(),
                        t._version) for w in ws for t in w))
    hit = _PACKED.get(model)
    if hit is not None and hit[0] == key:
        return hit[1]
    _PACKED.pop(model, None)  # free the stale copy first
    with torch.no_grad():
        packed = [pack_layer(*w, nblk) for w in ws]
    _PACKED[model] = (key, packed)
    return packed


@functools.lru_cache(maxsize=None)
def _lib(dtype):
    from rnnt_tpu_torch.kernels import build

    lib = build.load("beam_search")
    fn = getattr(lib, _ENTRY[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.beam_workspace_words.restype = ctypes.c_int
    lib.beam_workspace_words.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.beam_card.restype = ctypes.c_int
    lib.beam_card.argtypes = [ctypes.c_void_p]
    lib.beam_last_design.restype = ctypes.c_int
    lib.beam_last_design.argtypes = []
    return lib, fn


def _card(lib) -> tuple:
    """(SMs, opt-in shared memory a block may use) of the current device,
    as the launcher reads them."""
    from rnnt_tpu_torch.kernels import build

    out = (ctypes.c_int * 2)()
    build.check(lib, lib.beam_card(out), "beam_card")
    return out[0], out[1]


def beam_search(model, encoded: torch.Tensor, enc_lengths: torch.Tensor, *,
                beam_width: int, max_output_length: int,
                expansions_per_frame: int, merge_duplicates: bool = True,
                phase_ns=None, trace=None, library=None):
    """Beam search from encoder output [B, T', P] and lengths [B]: the
    kernel on CUDA, the plain version on CPU.  Returns (best tokens [B, L]
    int32, best lengths [B] int32, beam scores [B, K] fp32).

    phase_ns: optionally a zeroed int64 CUDA tensor [grid_blocks(device),
    len(PHASES)]: the kernel's timed build adds each block's nanoseconds in
    each phase of its timeline to the block's row (a diagnostic of where a
    search's time goes, `phase_split`; off on the serving path).
    trace: optionally a dict that receives the search's trace, "idx" and
    "val" [S, B, K] (see `decode.beam.trace_divergence`); on a CPU tensor
    the plain version's whole `stats`.  Off on the serving path.
    library: optionally (CDLL, entry) of another build of the source to
    launch in place of the package's (`kernels/beam_ab.py` times copies).
    int8 weights raise (`decode.beam.search_by_kind` sends them to the
    XLA beam's counterpart)."""
    require_lstm_encoder(model.cfg, "beam search")
    beam_mod.refuse_int8(model, "the beam kernel K3")
    if not encoded.is_cuda:
        return beam_mod.beam_search_encoded_plain(
            model, encoded, enc_lengths, beam_width=beam_width,
            max_output_length=max_output_length,
            expansions_per_frame=expansions_per_frame,
            merge_duplicates=merge_duplicates, stats=trace)
    from rnnt_tpu_torch.kernels import build

    cfg = model.cfg
    dt = model.dtype
    if dt not in _ENTRY:
        raise TypeError(f"the beam kernel takes float32 or bfloat16 weights, "
                        f"not {dt}")
    layers = model.prediction.layers
    B, T, P = encoded.shape
    K, L, E = beam_width, max_output_length, expansions_per_frame
    if not (1 <= len(layers) <= MAX_LAYERS) or K < 1 or L < 1 or E < 1 \
            or cfg.vocab_size < 2:
        raise ValueError(f"the beam kernel takes 1..{MAX_LAYERS} "
                         f"prediction-net layers, K, L, E >= 1 and V >= 2; "
                         f"got {len(layers)}, {K}, {L}, {E}, {cfg.vocab_size}")
    widths = (cfg.pred_net_size, P, cfg.joint_size, cfg.vocab_size)
    if any(n % SLICE for n in widths):
        raise ValueError(f"the beam kernel reads weights in 16-byte vectors: "
                         f"pred_net_size, projection_size, joint_size and "
                         f"vocab_size must be multiples of {SLICE}, not "
                         f"{widths}")
    dev = encoded.device
    rows = (grid_blocks(dev), len(PHASES))
    if phase_ns is not None and (phase_ns.device != dev or phase_ns.dtype
                                 != torch.int64 or tuple(phase_ns.shape)
                                 != rows or not phase_ns.is_contiguous()):
        raise ValueError(f"phase_ns must be a contiguous int64 tensor "
                         f"{list(rows)} on {dev}")
    if model.joint.w1.device != dev:
        raise ValueError("the model and the encoder output must be on one "
                         "device")
    with torch.no_grad():
        pred0, state0, _ = beam_mod.initial_beam(model, B, K, dev)
    enc = encoded.transpose(0, 1).to(dt).contiguous()      # [T', B, P]
    lens = enc_lengths.to(device=dev, dtype=torch.int32).contiguous()
    keep = [enc, lens, pred0.float().contiguous()]         # alive until done
    jw = model.joint
    weights = [model.prediction.embed, jw.w1, jw.b1, jw.w2, jw.b2]
    layer_ptrs = []
    for i in range(MAX_LAYERS):
        if i < len(layers):
            lstm, ln = layers[i].lstm, layers[i].ln
            c0, h0 = state0[i]
            c0, h0 = c0.float().contiguous(), h0.float().contiguous()
            keep += [c0, h0]
            ts = [lstm.wx, lstm.wh, lstm.bias, lstm.wp, ln.scale, ln.bias]
            if any(x.dtype != dt or not x.is_contiguous() for x in ts):
                raise ValueError("prediction-net weights must be contiguous "
                                 f"{dt}")
            layer_ptrs += [x.data_ptr() for x in ts] + [c0.data_ptr(),
                                                        h0.data_ptr()]
        else:
            layer_ptrs += [0] * 8
    if any(x.dtype != dt or not x.is_contiguous() for x in weights):
        raise ValueError(f"joint and embedding weights must be contiguous {dt}")
    D, J, H = cfg.embedding_size, cfg.joint_size, cfg.pred_net_size
    tokens = torch.empty((B, L), dtype=torch.int32, device=dev)
    lengths = torch.empty((B,), dtype=torch.int32, device=dev)
    scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    bar = torch.empty((1,), dtype=torch.int32, device=dev)
    if trace is not None:
        n_sel = min(T, int(lens.max())) * E * 2 if B else 0
        trace["idx"] = torch.empty((n_sel, B, K), dtype=torch.int32,
                                   device=dev)
        trace["val"] = torch.empty((n_sel, B, K), dtype=torch.float32,
                                   device=dev)
    lib, fn = _lib(dt) if library is None else library
    # the launcher sizes the grid for, and launches on, the current device
    with torch.cuda.device(dev):
        slots, pk_ptrs = 0, [0] * (2 * MAX_LAYERS)
        # a build without the streamed design (an older copy of the source
        # that kernels/beam_ab.py times) exports no beam_card
        if hasattr(lib, "beam_card"):
            nblk, optin = _card(lib)
            slots = stream_plan(dt, B, K, nblk, optin, V=cfg.vocab_size, P=P,
                                J=J, D=D, H=H, n_layers=len(layers))
        if slots:
            packed = packed_slices(model, nblk)
            pk_ptrs = [t.data_ptr() for layer in packed for t in layer]
            pk_ptrs += [0] * (2 * MAX_LAYERS - len(pk_ptrs))
        dims = (ctypes.c_int * 14)(B, T, K, L, E, int(bool(merge_duplicates)),
                                   cfg.vocab_size, P, J, D, H, len(layers),
                                   1 if slots else 0, slots)
        words = ctypes.c_longlong(0)
        build.check(lib, lib.beam_workspace_words(dims, ctypes.byref(words)),
                    "beam_workspace_words")
        ws = torch.empty((words.value,), dtype=torch.float32, device=dev)
        ptrs = (ctypes.c_void_p * _N_PTRS)(
            enc.data_ptr(), lens.data_ptr(),
            *[x.data_ptr() for x in weights], keep[2].data_ptr(),
            *layer_ptrs, tokens.data_ptr(), lengths.data_ptr(),
            scores.data_ptr(), ws.data_ptr(), bar.data_ptr(),
            0 if phase_ns is None else phase_ns.data_ptr(),
            *([0, 0] if trace is None else [trace["idx"].data_ptr(),
                                            trace["val"].data_ptr()]),
            *pk_ptrs)
        err = fn(ptrs, dims, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, _ENTRY[dt])
    design = (DESIGNS[lib.beam_last_design()]
              if hasattr(lib, "beam_last_design") else "fma")
    beam_search.launches += 1
    beam_search.launches_by_design[design] += 1
    beam_search.last_design = design
    return tokens, lengths, scores


beam_search.launches = 0
beam_search.launches_by_design = dict.fromkeys(DESIGNS, 0)
beam_search.last_design = None
