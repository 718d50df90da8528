"""Operations and bytes of the Conformer-Transducer, from shapes: the
yardstick of `conformer_mfu.train` and of the Conformer modules' rooflines.

Peaks as `flops.py` (one H100 SXM at 700 W: 989 TFLOP/s bf16, 3.35 TB/s).
A module's forward reads its input and weights once and writes its output
once (2 bytes a value, bf16), plus the intermediates that its published
form has to hold: the attention's position term [B, H, T', 2T' - 1]
written once and its scores [B, H, T', T'] written and read once.  Its
operations are its products (2 a multiply-add).  Its backward takes twice
the forward's products (the input's and the weight's gradients; the
subsampling's first convolution has no input gradient) and twice its
bytes (each tensor once more as its gradient).  A module's least time is
`flops.least_s` of its forward plus that of its backward.

Shapes: B utterances of T frames of F features, C = D = conformer_dim, H
heads of d = D / H, T1 = ceil(T / 2), T' = ceil(T1 / 2), F1 = ceil(F / 2),
F'' = ceil(F1 / 2), N = B T' frames through each block.
"""

from __future__ import annotations

from benchlib.flops import least_s, prediction_flops

ESIZE = 2  # bf16


def _half(n: int) -> int:
    return -(-n // 2)


def shapes(m: dict, B: int, T: int) -> dict:
    F = m["mel_bins"] * m["downsample_factor"]
    D = m["conformer_dim"]
    return {"B": B, "T1": _half(T), "Tp": _half(_half(T)), "F": F,
            "F1": _half(F), "F2": _half(_half(F)), "D": D, "C": D,
            "H": m["conformer_heads"], "Dff": m["conformer_ffn_size"],
            "K": m["conformer_kernel_size"], "T": T}


def subsample_cost(m: dict, B: int, T: int):
    """(bytes, operations) of the subsampling's forward."""
    s = shapes(m, B, T)
    C, D, Tp = s["C"], s["D"], s["Tp"]
    a1 = B * C * s["T1"] * s["F1"]          # conv1's output
    a2 = B * C * Tp * s["F2"]               # conv2's output
    ops = (2.0 * a1 * 9 + 2.0 * a2 * C * 9 + 2.0 * B * Tp * C * s["F2"] * D)
    weights = C * 9 + C * C * 9 + C * s["F2"] * D + 2 * C + D
    nbytes = ESIZE * (B * T * s["F"] + a1 * 2 + a2 * 2 + B * Tp * D
                      + weights)
    return nbytes, ops


def mhsa_cost(m: dict, B: int, T: int):
    """(bytes, operations) of one attention module's forward: the q, k, v
    and output projections, the position projection, q.k^T, the position
    term, the scores' softmax and A.V."""
    s = shapes(m, B, T)
    D, H, Tp = s["D"], s["H"], s["Tp"]
    d, N, W = D // H, B * Tp, 2 * Tp - 1
    ops = (2.0 * N * D * 3 * D + 2.0 * W * D * D
           + 2.0 * B * H * Tp * W * d + 2.0 * 2 * B * H * Tp * Tp * d
           + 2.0 * N * D * D)
    nbytes = ESIZE * (2 * N * D + 5 * D * D + 5 * D + B * H * Tp * W
                      + 2 * B * H * Tp * Tp)
    return nbytes, ops


def conv_cost(m: dict, B: int, T: int):
    """(bytes, operations) of one convolution module's forward."""
    s = shapes(m, B, T)
    D, K, N = s["D"], s["K"], B * s["Tp"]
    ops = 2.0 * N * D * 2 * D + 2.0 * N * D * K + 2.0 * N * D * D
    nbytes = ESIZE * (2 * N * D + 3 * D * D + D * K + 10 * D)
    return nbytes, ops


def ffn_cost(m: dict, B: int, T: int):
    """(bytes, operations) of one feed-forward module's forward."""
    s = shapes(m, B, T)
    D, Dff, N = s["D"], s["Dff"], B * s["Tp"]
    return (ESIZE * (2 * N * D + 2 * D * Dff + Dff + 3 * D),
            2.0 * 2 * N * D * Dff)


def train_least_s(cost, m: dict, B: int, T: int, calls: int = 1,
                  input_grad: bool = True) -> float:
    """Least time of `calls` forwards and backwards of a module whose
    forward costs `cost(m, B, T)`."""
    nbytes, ops = cost(m, B, T)
    if input_grad:
        bwd_ops = 2.0 * ops
    else:  # the subsampling: conv1 takes no input gradient
        s = shapes(m, B, T)
        bwd_ops = 2.0 * ops - 2.0 * B * s["C"] * s["T1"] * s["F1"] * 9
    return calls * (least_s(nbytes, ops) + least_s(2.0 * nbytes, bwd_ops))


def module_least_s(module: str, m: dict, B: int, T: int) -> float:
    """Least time a training step of the modules `module` ("subsample",
    "mhsa", "conv", "ffn": every block's) takes."""
    L = m["encoder_layers"]
    if module == "subsample":
        return train_least_s(subsample_cost, m, B, T, 1, input_grad=False)
    cost = {"mhsa": mhsa_cost, "conv": conv_cost, "ffn": ffn_cost}[module]
    return train_least_s(cost, m, B, T, L * (2 if module == "ffn" else 1))


def forward_flops(m: dict, B: int, T: int, U: int) -> float:
    """Products of a training forward: the subsampling, every block, the
    prediction net and the joint (both first-Dense projections and the
    [B, T', U+1, J] x [J, V] lattice product)."""
    s = shapes(m, B, T)
    L, Tp, U1 = m["encoder_layers"], s["Tp"], U + 1
    J, P = m["joint_size"], m["projection_size"]
    blocks = L * (2 * ffn_cost(m, B, T)[1] + mhsa_cost(m, B, T)[1]
                  + conv_cost(m, B, T)[1])
    return (subsample_cost(m, B, T)[1] + blocks + prediction_flops(m, B, U1)
            + 2.0 * B * (Tp * s["D"] + U1 * P) * J
            + 2.0 * B * Tp * U1 * J * m["vocab_size"])


def train_step_flops(m: dict, B: int, T: int, U: int) -> float:
    """3 x the forward's products (the loss backward's recomputation not
    counted)."""
    return 3.0 * forward_flops(m, B, T, U)
