"""Operations and bytes, from shapes: the yardstick of the roofline and
utilisation metrics.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM.  A kernel's least
time is the larger of its operations over the compute peak and its bytes
over the bandwidth; each input byte is counted read once and each output
byte written once.  The per-call counts of the LSTM (K4 forward, K5
backward) and joint-plane (K6) kernels are the chip smoke test's bound
functions, copied.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12       # bf16 dense, tensor cores
PEAK_BYTES_PER_S = 3.35e12


def least_s(nbytes: float, flops: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def lstm_cost(T, B, H, P, esize, backward):
    """(bytes, operations) of one LSTM sequence call: each input read once,
    each output written once; the recurrent products' operations."""
    weights = esize * (P * 4 * H + H * P)
    if backward:  # z, c, dout, Wh^T, Wp^T, c0 in; dz, dh_total, dh0, dc0 out
        nbytes = (weights + esize * 2 * T * B * (4 * H + P + H // 2)
                  + 4 * 2 * B * H + 4 * B * P)
    else:  # xp, Wh, Wp, bias, h0, c0 in; h, z, c, c_fin out
        nbytes = (weights + esize * (4 * H + B * P)
                  + esize * T * B * (2 * 4 * H + P + H) + 4 * 2 * B * H)
    return nbytes, 2.0 * T * B * (P * 4 * H + H * P)


def planes_cost(B, T, U1, J, V, esize):
    """(bytes, operations) of one K6 call: f, g, b1, W2, b2 in the weight
    type and the labels, each read once, three fp32 planes written once;
    the [cells, J] x [J, V] product."""
    C = B * T * U1
    nbytes = (esize * (B * T * J + B * U1 * J + J * V + J + V) + 4 * B * U1
              + 3 * 4 * C)
    return nbytes, 2.0 * C * J * V


def reduced_frames(m: dict, T: int) -> int:
    f = m["time_reduction_factor"]
    return -(-T // f) if m["time_reduction_index"] >= 0 else T


def lstm_calls(m: dict, B: int, T: int, U1: int):
    """(T, B, H, P) of each LSTM sequence call of a training forward:
    the encoder's layers (those after the reduction at T') and the
    prediction net's over U+1 steps."""
    calls = []
    t = T
    for i in range(m["encoder_layers"]):
        calls.append((t, B, m["encoder_size"], m["projection_size"]))
        if i == m["time_reduction_index"]:
            t = reduced_frames(m, T)
    calls += [(U1, B, m["pred_net_size"], m["projection_size"])
              ] * m["pred_net_layers"]
    return calls


def lstm_least_s(m: dict, B: int, T: int, U1: int, backward: bool,
                 esize: int = 2) -> float:
    """Least time of a training step's K4 (or K5) calls."""
    return sum(least_s(*lstm_cost(t, b, h, p, esize, backward))
               for t, b, h, p in lstm_calls(m, B, T, U1))


def planes_least_s(m: dict, B: int, T: int, U1: int, esize: int = 2) -> float:
    return least_s(*planes_cost(B, reduced_frames(m, T), U1,
                                m["joint_size"], m["vocab_size"], esize))


def lstm_layer_flops(T, B, n_in, H, P) -> float:
    """A projected LSTM's forward products: input, recurrent, projection."""
    return 2.0 * T * B * (n_in * 4 * H + P * 4 * H + H * P)


def encoder_flops(m: dict, B: int, T: int) -> float:
    """The encoder's forward products over T stacked frames."""
    F = m["mel_bins"] * m["downsample_factor"]
    H, P = m["encoder_size"], m["projection_size"]
    total, t, n_in = 0.0, T, F
    for i in range(m["encoder_layers"]):
        total += lstm_layer_flops(t, B, n_in, H, P)
        n_in = P
        if i == m["time_reduction_index"]:
            t = reduced_frames(m, T)
            n_in = P * m["time_reduction_factor"]
    return total


def prediction_flops(m: dict, B: int, U1: int) -> float:
    H, P = m["pred_net_size"], m["projection_size"]
    total, n_in = 0.0, m["embedding_size"]
    for _ in range(m["pred_net_layers"]):
        total += lstm_layer_flops(U1, B, n_in, H, P)
        n_in = P
    return total


def train_step_flops(m: dict, B: int, T: int, U: int) -> float:
    """Model operations of a training step: 3 x the forward's products of
    the encoder, the prediction net and the joint (both W1 projections and
    the [B, T', U+1, J] x [J, V] lattice product).  The loss backward's
    recomputation is not counted."""
    U1, P, J = U + 1, m["projection_size"], m["joint_size"]
    Tr = reduced_frames(m, T)
    fwd = (encoder_flops(m, B, T) + prediction_flops(m, B, U1)
           + 2.0 * B * (Tr + U1) * P * J
           + 2.0 * B * Tr * U1 * J * m["vocab_size"])
    return 3.0 * fwd

