"""Seeded weights of the Conformer-Transducer, made on the device in one
draw: the scheme of `weights.py` for the Conformer's leaves.

Every weight matrix and convolution filter is Glorot-uniform (a filter's
fans are its input and output channels times its taps; a depthwise
filter's both its taps), the position biases u and v Glorot over [H, d],
the embedding uniform in [-0.05, 0.05), every bias zero (the LSTM's forget
gate at 1), LayerNorm and BatchNorm at unit scale and zero shift, the
BatchNorm statistics at mean 0 and variance 1.  The blank's column of W2
is zero and its output bias the configuration's `init_blank_bias`.  One
`torch.rand` over every random element, from a generator seeded with the
run's seed on the weights' device, then each leaf is cut from it and cast
to the served type (the statistics stay fp32).

Names and layouts are the program's (`rnnt_tpu_torch.models.conformer`):
Dense weights [in, out], Conv2d filters [out, in, 3, 3], the depthwise
filter [D, K].
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchlib.weights import lstm_leaves


def is_stat(name: str) -> bool:
    return name.endswith((".bn.mean", ".bn.var"))


def _ln(prefix: str, D: int):
    return [(f"{prefix}.scale", (D,), "one", None),
            (f"{prefix}.bias", (D,), "zero", None)]


def _dense(prefix: str, n_in: int, n_out: int, bias: bool = True):
    out = [(f"{prefix}.w", (n_in, n_out), "glorot", (n_in, n_out))]
    return out + ([(f"{prefix}.b", (n_out,), "zero", None)] if bias else [])


def layout(m: dict) -> List[Tuple[str, tuple, str, tuple]]:
    """(name, shape, init, (fan_in, fan_out)) of every leaf of the
    Conformer-Transducer of RNNTConfig fields `m`, in a fixed order."""
    F = m["mel_bins"] * m["downsample_factor"]
    D = C = m["conformer_dim"]
    H, K, Dff = m["conformer_heads"], m["conformer_kernel_size"], \
        m["conformer_ffn_size"]
    F2 = -(-(-(-F // 2)) // 2)
    s = "encoder.subsample"
    out = [(f"{s}.conv1_w", (C, 1, 3, 3), "glorot", (9, 9 * C)),
           (f"{s}.conv1_b", (C,), "zero", None),
           (f"{s}.conv2_w", (C, C, 3, 3), "glorot", (9 * C, 9 * C)),
           (f"{s}.conv2_b", (C,), "zero", None)]
    out += _dense(f"{s}.out", C * F2, D)
    for i in range(m["encoder_layers"]):
        p = f"encoder.blocks.{i}"
        for f in ("ffn1", "ffn2"):
            out += (_ln(f"{p}.{f}.ln", D) + _dense(f"{p}.{f}.up", D, Dff)
                    + _dense(f"{p}.{f}.down", Dff, D))
        a = f"{p}.mhsa"
        out += _ln(f"{a}.ln", D)
        out.append((f"{a}.qkv_w", (D, 3 * D), "glorot", (D, 3 * D)))
        out += [(f"{a}.{b}", (D,), "zero", None) for b in ("q_b", "k_b",
                                                           "v_b")]
        out += _dense(f"{a}.pos", D, D, bias=False)
        out += [(f"{a}.{u}", (H, D // H), "glorot", (H, D // H))
                for u in ("pos_u", "pos_v")]
        out += _dense(f"{a}.out", D, D)
        c = f"{p}.conv"
        out += _ln(f"{c}.ln", D) + _dense(f"{c}.pw1", D, 2 * D)
        out += [(f"{c}.dw_w", (D, K), "glorot", (K, K)),
                (f"{c}.dw_b", (D,), "zero", None)]
        out += _ln(f"{c}.bn", D)
        out += [(f"{c}.bn.mean", (D,), "zero", None),
                (f"{c}.bn.var", (D,), "one", None)]
        out += _dense(f"{c}.pw2", D, D)
        out += _ln(f"{p}.ln", D)
    P = m["projection_size"]
    out.append(("prediction.embed", (m["vocab_size"], m["embedding_size"]),
                "embed", None))
    n_in = m["embedding_size"]
    for i in range(m["pred_net_layers"]):
        out += [(n, shp, kind, shp if kind == "glorot" else None)
                for n, shp, kind in lstm_leaves(f"prediction.layers.{i}",
                                                n_in, m["pred_net_size"], P)]
        n_in = P
    J, V = m["joint_size"], m["vocab_size"]
    out += [("joint.w1", (D, J), "glorot", (D, J)),
            ("joint.w1p", (P, J), "glorot", (P, J)),
            ("joint.b1", (J,), "zero", None),
            ("joint.w2", (J, V), "glorot", (J, V)),
            ("joint.b2", (V,), "blank_bias", None)]
    return out


def make_weights(m: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """name -> tensor on `device`: the statistics fp32, the rest `dtype`."""
    leaves = layout(m)
    numel = {n: int(torch.tensor(s).prod()) for n, s, _, _ in leaves}
    n_rand = sum(numel[n] for n, _, kind, _ in leaves
                 if kind in ("glorot", "embed"))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(n_rand, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind, fans in leaves:
        n = numel[name]
        if kind in ("glorot", "embed"):
            lim = ((6.0 / (fans[0] + fans[1])) ** 0.5 if kind == "glorot"
                   else 0.05)
            t = (u[off: off + n] * (2 * lim) - lim).view(shape)
            off += n
            if name == "joint.w2":
                t[:, 0] = 0.0   # the blank's logit is its bias alone
        elif kind == "one":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
            if kind == "lstm_bias":
                Hh = shape[0] // 4
                t[2 * Hh: 3 * Hh] = 1.0
            elif kind == "blank_bias":
                t[0] = float(m["init_blank_bias"])
        out[name] = t if is_stat(name) else t.to(dtype)
    del u
    return out
