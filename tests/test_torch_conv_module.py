"""The Conformer convolution module's kernels K10 and K11
(`ops/conv_module_cuda.py`) through their plain versions on the CPU, in
fp32, held to the module's formula (`ConvModule.formula`: GLU, mask,
PyTorch's depthwise Conv1d, the masked BatchNorm and Swish, with autograd):
the output, the BatchNorm statistics and the gradients of u, the depthwise
weight and bias and BatchNorm's scale and bias, at uneven lengths, a T
shorter than the kernel, the even kernel's (K - 1) // 2 and K // 2 frames
of zeros and an odd kernel, two chunks of frames, and eval with running
statistics.  The routing (`conv_module_cuda.fits`: the formula on the
CPU, in fp32 and under a data mesh of more than one row, a ValueError for
a bf16 CUDA module the kernels do not take) and the module's counter,
which counts `plain` on the CPU."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rnnt_tpu_torch.config import tiny_config
from rnnt_tpu_torch.models import conformer
from rnnt_tpu_torch.models.transducer import Transducer
from rnnt_tpu_torch.ops import conv_module_cuda as C

torch.set_num_threads(1)

# name: (lengths, T, K, D, training)
CASES = {
    "uneven K=32": ((37, 30, 21), 37, 32, 16, True),
    "T shorter than K": ((10, 7, 3), 10, 32, 16, True),
    "odd K=7": ((23, 17), 23, 7, 8, True),
    "two chunks": ((300, 261), 300, 32, 8, True),
    "every frame valid": ((19, 19), 19, 4, 8, True),
    "eval uneven K=32": ((37, 30, 21), 37, 32, 16, False),
    "eval T shorter than K": ((10, 7, 3), 10, 32, 16, False),
}
NAMES = ("u", "dw_w", "dw_b", "bn.scale", "bn.bias")


def _problem(lengths, T, K, D, seed=7):
    rng = np.random.default_rng(seed)
    m = conformer.ConvModule(D, K)
    m.reset_(rng)
    with torch.no_grad():
        m.dw_b.copy_(torch.from_numpy(rng.normal(0, 0.3, D)))
        m.bn.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, D)))
        m.bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, D)))
        m.bn.mean.copy_(torch.from_numpy(rng.normal(0, 0.2, D)))
        m.bn.var.copy_(torch.from_numpy(rng.uniform(0.3, 2.0, D)))
    for p in (m.dw_w, m.dw_b, m.bn.scale, m.bn.bias):
        p.requires_grad_(True)
    B = len(lengths)
    u = torch.from_numpy(rng.normal(0, 1, (B, T, 2 * D)).astype(np.float32))
    ds = torch.from_numpy(rng.normal(0, 1, (B, T, D)).astype(np.float32))
    valid = conformer.frame_mask(torch.tensor(lengths), T)
    return m, u.requires_grad_(True), ds, valid


def _leaves(m, u):
    return [u, m.dw_w, m.dw_b, m.bn.scale, m.bn.bias]


def _close(got, want, rel, what, scale=None):
    want = want.detach()
    scale = scale or float(want.abs().max()) or 1.0
    err = float((got - want).abs().max()) / scale
    assert err <= rel, (what, err)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_kernels_equal_the_formula(case):
    lengths, T, K, D, training = CASES[case]
    m, u, ds, valid = _problem(lengths, T, K, D)
    bn = m.bn
    want, want_stats = m.formula(u, valid, training, None)
    got, got_stats = C.conv_module(u, valid, m.dw_w, m.dw_b, bn.scale,
                                   bn.bias, bn.mean, bn.var,
                                   conformer.NORM_EPS, training)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got, want, 2e-6, "s")
    if not training:
        assert want_stats is None and got_stats is None
        return
    for g, w, n in zip(got_stats, want_stats, ("mean", "var")):
        assert not g.requires_grad
        _close(g, w, 2e-6, n)
    want_g = torch.autograd.grad((want * ds).sum(), _leaves(m, u))
    got_g = torch.autograd.grad((got * ds).sum(), _leaves(m, u))
    # the depthwise bias's gradient is zero but for rounding (BatchNorm
    # subtracts the mean the bias shifts, at every frame): it is held to the
    # weight gradient's scale
    dw_scale = float(want_g[1].abs().max())
    for g, w, n in zip(got_g, want_g, NAMES):
        assert g.shape == w.shape and g.dtype == w.dtype, n
        _close(g, w, 2e-5, n, dw_scale if n == "dw_b" else None)


def test_padded_frames_reach_no_valid_frame():
    """A change of u at padded frames moves neither the output at valid
    frames nor the statistics (the mask comes before the convolution)."""
    m, u, _, valid = _problem((37, 30, 21), 37, 32, 16)
    bn = m.bn
    args = (m.dw_w, m.dw_b, bn.scale, bn.bias, bn.mean, bn.var,
            conformer.NORM_EPS, True)
    with torch.no_grad():
        s, st = C.conv_module(u, valid, *args)
        u2 = torch.where(valid[..., None], u, u + 5.0)
        s2, st2 = C.conv_module(u2, valid, *args)
    assert torch.equal(s[valid], s2[valid])
    assert all(torch.equal(a, b) for a, b in zip(st, st2))


def test_chunk_sums_are_the_kernels_partial_rows():
    x = torch.arange(2 * 300 * 3, dtype=torch.float32).reshape(2, 300, 3)
    part = C.chunk_sums(x)
    assert part.shape == (2 * C.chunks(300), 3)
    assert torch.equal(part[1], x[0, C.CHUNK:].sum(0))
    assert torch.equal(part[2], x[1, :C.CHUNK].sum(0))
    assert torch.equal(part.sum(0), x.sum((0, 1)))


def _operand(dtype=torch.bfloat16, cuda=True, shape=(2, 5, 128),
             requires_grad=False):
    return SimpleNamespace(is_cuda=cuda, dtype=dtype, shape=shape,
                           requires_grad=requires_grad)


# name: (changes to the operands, mesh rows, training, grad enabled, fits;
# ValueError: refused)
ROUTES = {
    "bf16 on the card": ({}, None, True, True, True),
    "one data row": ({}, 1, True, True, True),
    "two data rows": ({}, 2, True, True, False),
    "fp32": ({"dtype": torch.float32}, None, True, True, False),
    "on the cpu": ({"cuda": False}, None, True, True, False),
    "D not a multiple of CT": ({"shape": (2, 5, 96)}, None, True, True,
                               ValueError),
    "D not a multiple of CT, two data rows": ({"shape": (2, 5, 96)}, 2, True,
                                              True, False),
    "D not a multiple of CT, fp32": ({"shape": (2, 5, 96),
                                      "dtype": torch.float32}, None, True,
                                     True, False),
    "eval without grad": ({}, None, False, False, True),
    "eval with grad": ({"requires_grad": True}, None, False, True,
                       ValueError),
    "eval with grad on the cpu": ({"requires_grad": True, "cuda": False},
                                  None, False, True, False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_fits_routes_on_the_input(route):
    change, rows, training, grad, want = ROUTES[route]
    u = _operand(**change)
    w = _operand(dtype=u.dtype, cuda=u.is_cuda, shape=(64, 32))
    vec = _operand(dtype=u.dtype, cuda=u.is_cuda, shape=(64,))
    mesh = None if rows is None else SimpleNamespace(shape={"data": rows})
    with torch.set_grad_enabled(grad):
        if want is ValueError:
            with pytest.raises(ValueError):
                C.fits(u, w, vec, vec, vec, mesh, training)
        else:
            assert C.fits(u, w, vec, vec, vec, mesh, training) is want


def test_fits_refuses_a_kernel_past_kmax():
    u = _operand()
    vec = _operand(shape=(64,))
    assert C.fits(u, _operand(shape=(64, C.KMAX)), vec, vec, vec, None, True)
    with pytest.raises(ValueError, match=f"at most {C.KMAX} taps"):
        C.fits(u, _operand(shape=(64, C.KMAX + 1)), vec, vec, vec, None,
               True)


def test_counter_counts_plain_on_the_cpu():
    cfg = tiny_config(encoder_type="conformer", time_reduction_index=-1,
                      encoder_layers=2, conformer_dim=32, conformer_heads=4,
                      conformer_ffn_size=64, conformer_kernel_size=8)
    model = Transducer(cfg).init_(3)
    before = dict(conformer.conv_module_launches_by_path)
    mel = torch.randn(2, 29, cfg.input_feat_size)
    model.encoder.encode_train(mel, torch.tensor([29, 20]))
    with torch.no_grad():
        model.encoder.encode(mel)
    after = conformer.conv_module_launches_by_path
    assert after["plain"] - before["plain"] == 2 * cfg.encoder_layers
    assert after["kernel"] == before["kernel"]
