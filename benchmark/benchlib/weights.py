"""Seeded weights of the transducer, made on the device in one draw.

The benchmark's own weights: the program and the plain reference both take
them, and neither makes its own.  Every weight matrix is Glorot-uniform,
the embedding uniform in [-0.05, 0.05), LSTM biases zero with the forget
gate at 1, LayerNorm and BatchNorm at unit scale and zero shift, the
BatchNorm statistics at mean 0 and variance 1 (the scheme of the model's
own initialiser).  The blank's column of W2 is zero and its output bias
the configuration's `init_blank_bias`: the blank's logit is then the same
constant at every seed, and so is the emission rate that constant sets
(with a random column one bias gave 0.01 to 0.15 symbols a frame over
four seeds).  One `torch.rand` over every random element, from a
generator seeded with the run's seed on the weights' device, then each
leaf is cut from it and cast to the served type.  The same seed on the
same kind of device gives the same weights.

Parameter names and layouts are the model's (`wx [F, 4H]`, `wh [P, 4H]`,
`bias [4H]`, `wp [H, P]`, gates i, g, f, o).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# leaves kept in fp32 whatever the served type (the running statistics)
FP32_LEAVES = ("encoder.bn.mean", "encoder.bn.var")


def lstm_leaves(prefix: str, n_in: int, H: int, P: int):
    return [(f"{prefix}.lstm.wx", (n_in, 4 * H), "glorot"),
            (f"{prefix}.lstm.wh", (P, 4 * H), "glorot"),
            (f"{prefix}.lstm.bias", (4 * H,), "lstm_bias"),
            (f"{prefix}.lstm.wp", (H, P), "glorot"),
            (f"{prefix}.ln.scale", (P,), "one"),
            (f"{prefix}.ln.bias", (P,), "zero")]


def layout(m: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every leaf of the model of RNNTConfig fields
    `m`, in a fixed order."""
    F = m["mel_bins"] * m["downsample_factor"]
    H, P = m["encoder_size"], m["projection_size"]
    out = [("encoder.bn.scale", (F,), "one"), ("encoder.bn.bias", (F,), "zero"),
           ("encoder.bn.mean", (F,), "zero"), ("encoder.bn.var", (F,), "one")]
    n_in = F
    for i in range(m["encoder_layers"]):
        out += lstm_leaves(f"encoder.layers.{i}", n_in, H, P)
        n_in = P * (m["time_reduction_factor"]
                    if i == m["time_reduction_index"] else 1)
    out.append(("prediction.embed", (m["vocab_size"], m["embedding_size"]),
                "embed"))
    n_in = m["embedding_size"]
    for i in range(m["pred_net_layers"]):
        out += lstm_leaves(f"prediction.layers.{i}", n_in, m["pred_net_size"],
                           P)
        n_in = P
    J, V = m["joint_size"], m["vocab_size"]
    out += [("joint.w1", (P, J), "glorot"), ("joint.b1", (J,), "zero"),
            ("joint.w2", (J, V), "glorot"), ("joint.b2", (V,), "blank_bias")]
    return out


def make_weights(m: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """name -> tensor on `device`: the statistics fp32, the rest `dtype`."""
    leaves = layout(m)
    n_rand = sum(int(torch.tensor(s).prod()) for _, s, kind in leaves
                 if kind in ("glorot", "embed"))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(n_rand, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in leaves:
        n = int(torch.tensor(shape).prod())
        if kind in ("glorot", "embed"):
            lim = ((6.0 / (shape[0] + shape[1])) ** 0.5 if kind == "glorot"
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
                H = shape[0] // 4
                t[2 * H: 3 * H] = 1.0
            elif kind == "blank_bias":
                t[0] = float(m["init_blank_bias"])
        out[name] = t if name in FP32_LEAVES else t.to(dtype)
    del u
    return out
