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

On a CPU tensor `beam_search` runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rnnt_tpu_torch.decode import beam as beam_mod

_ENTRY = {torch.float32: "beam_search_f32", torch.bfloat16: "beam_search_bf16"}
MAX_LAYERS = 4  # prediction-net layers the launcher takes
SLICE = 8  # H, P, J and V are cut into column groups of 8 (SLICE in the source)
_N_PTRS = 8 + 8 * MAX_LAYERS + 8
# block 0's timeline phases that `phase_ns` receives (enum Phase in the source)
PHASES = ("fj_joint", "logits", "lse", "candidates", "choose", "gates",
          "proj", "joint", "merge", "gather", "barrier")


@functools.lru_cache(maxsize=None)
def _lib(dtype):
    from rnnt_tpu_torch.kernels import build

    lib = build.load("beam_search")
    fn = getattr(lib, _ENTRY[dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.beam_workspace_words.restype = ctypes.c_int
    lib.beam_workspace_words.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, fn


def beam_search(model, encoded: torch.Tensor, enc_lengths: torch.Tensor, *,
                beam_width: int, max_output_length: int,
                expansions_per_frame: int, merge_duplicates: bool = True,
                phase_ns=None, trace=None):
    """Beam search from encoder output [B, T', P] and lengths [B]: the
    kernel on CUDA, the plain version on CPU.  Returns (best tokens [B, L]
    int32, best lengths [B] int32, beam scores [B, K] fp32).

    phase_ns: optionally a zeroed int64 CUDA tensor [len(PHASES)] to which
    the kernel adds block 0's nanoseconds in each phase of its timeline (a
    diagnostic of where a search's time goes; off on the serving path).
    trace: optionally a dict that receives the search's trace, "idx" and
    "val" [S, B, K] (see `decode.beam.trace_divergence`); on a CPU tensor
    the plain version's whole `stats`.  Off on the serving path."""
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
    if phase_ns is not None and (phase_ns.device != dev or phase_ns.dtype
                                 != torch.int64 or phase_ns.numel()
                                 != len(PHASES)):
        raise ValueError(f"phase_ns must be an int64 tensor of "
                         f"{len(PHASES)} on {dev}")
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
    dims = (ctypes.c_int * 12)(B, T, K, L, E, int(bool(merge_duplicates)),
                               cfg.vocab_size, P, J, D, H, len(layers))
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
    lib, fn = _lib(dt)
    # the launcher sizes the grid for, and launches on, the current device
    with torch.cuda.device(dev):
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
                                            trace["val"].data_ptr()]))
        err = fn(ptrs, dims, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, _ENTRY[dt])
    beam_search.launches += 1
    return tokens, lengths, scores


beam_search.launches = 0
