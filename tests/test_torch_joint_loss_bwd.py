"""The fused loss's backward kernels K8 and K9 (ops.loss_bwd_cuda), by
their plain versions, which follow the kernels' schedules: 128-cell tiles
walked by a grid of CTAs, 128-column chunks, db2's per-warp partial rows
summed in a fixed order, dg's two-stage sum over groups of t rows and db1's
over groups of u rows.  `joint_loss_fused._kernel_grads` runs them on the
CPU; it is held to the plain chain `_chunk_grads` (`_plain_grads`) on the
same occupancies, in bf16 as on the card.  The two differ only in the order
of fp32 sums and where that flips a bf16 rounding of a logit's gradient, so
each gradient is held to 1e-4 of its largest magnitude."""

import numpy as np
import pytest
import torch

from rnnt_tpu_torch.ops import joint_loss_fused as TF, loss_bwd_cuda as LB
from rnnt_tpu_torch.ops import planes_cuda
from rnnt_tpu_torch.ops.rnnt_loss_ref import (lattice_scan_plain,
                                              occupancies, pad_labels)

torch.set_num_threads(1)

BF = torch.bfloat16
NAMES = ("df", "dg", "db1", "dw2", "db2")


def _problem(seed, B, T, U, J, V, shards=1):
    """bf16 joint inputs for a vocabulary of V * shards columns, ragged
    lengths, and the forward's denominator and occupancies over the full
    vocabulary (the chain's inputs), from the plain forward."""
    rng = np.random.default_rng(seed)
    Vt = V * shards

    def t(shape, scale):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to(BF)

    f, g = t((B, T, J), 0.5), t((B, U + 1, J), 0.5)
    b1, w2, b2 = t((J,), 0.1), t((J, Vt), (6.0 / (J + Vt)) ** 0.5), t(
        (Vt,), 0.1)
    labels = torch.from_numpy(rng.integers(1, Vt, (B, U)))
    fl = torch.from_numpy(rng.integers(max(1, T // 2), T + 1, (B,)))
    yl = torch.from_numpy(rng.integers(0, U + 1, (B,)))
    fl[0], yl[0] = T, U
    den, b, e = TF.planes(f, g, b1, w2, b2, labels, yl)
    alpha, beta, ll = lattice_scan_plain(b, e, fl, yl)
    ct = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32))
    occ, gbl, gem = occupancies(alpha, beta, b, e, ll, fl, yl, ct)
    return f, g, b1, w2, b2, pad_labels(labels), den, occ, gbl, gem


def _close(got, want, what):
    for n, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, (what, n)
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        assert err <= 1e-4, f"{what}: {n} off by {err:.3e} of its largest"


# (B, T, U, J, V, ctas, one row a chunk): ragged lengths in every case;
# odd B, also in batch chunks of one row (db2's rows carried across
# chunks); J not a multiple of 64 (padded to whole k-blocks); V not a
# multiple of 128 (a partial last chunk); V=31 (one chunk, as char31); more
# tiles than CTAs
CASES = {
    "ragged": (3, 7, 4, 64, 256, 4, False),
    "odd_B": (5, 9, 6, 64, 128, 2, False),
    "odd_B_row_chunks": (5, 9, 6, 64, 128, 2, True),
    "J_40": (2, 11, 5, 40, 256, 3, False),
    "V_300": (2, 8, 5, 64, 300, 2, False),
    "V_31": (4, 9, 7, 72, 31, 3, False),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_kernel_schedule_matches_chain(case, monkeypatch):
    B, T, U, J, V, ctas, row_chunks = CASES[case]
    if row_chunks:
        monkeypatch.setattr(LB, "CHUNK_BYTES", 1)
        assert LB.chunk_rows(B, T, U + 1, 128, 128) == 1
    f, g, b1, w2, b2, y, den, occ, gbl, gem = _problem(
        sum(map(ord, case)), B, T, U, J, V)
    want = TF._plain_grads(f, g, b1, w2, b2, occ, gbl, gem, den, y, True)
    got = TF._kernel_grads(f, g, b1, w2, b2, None, occ, gbl, gem, den, y,
                           True, ctas)
    _close(got, want, case)


@pytest.mark.parametrize("index", [1, 2])
def test_kernel_schedule_on_a_shard_without_the_blank(index):
    """Shard `index` of 3 (V_local 100, not a whole chunk) holds no blank;
    its labels are shifted into its columns, and the ids of other shards
    fall outside [0, V_local) and scatter nothing."""
    B, T, U, J, V = 3, 8, 6, 64, 100
    f, g, b1, w2, b2, y, den, occ, gbl, gem = _problem(7 + index, B, T, U,
                                                       J, V, shards=3)
    cols = slice(index * V, (index + 1) * V)
    ys = y - index * V
    assert bool(((ys < 0) | (ys >= V)).any()) and bool(
        ((ys >= 0) & (ys < V)).any())
    args = (f, g, b1, w2[:, cols], b2[cols])
    want = TF._plain_grads(*args, occ, gbl, gem, den, ys, False)
    got = TF._kernel_grads(*args, None, occ, gbl, gem, den, ys, False, 2)
    _close(got, want, f"shard {index}")


def test_db2_rows_are_per_cta_warp_in_tile_order():
    """K8's db2 partial rows: tile i adds into the 8 rows of CTA i % ctas,
    warp w's row the tree sum of the tile's rows 16 w .. 16 w + 15; rows of
    CTAs without a tile stay zero; their sum is the chain's db2."""
    B, T, U, J, V, ctas = 3, 11, 9, 128, 200, 4  # 330 cells: 3 tiles
    f, g, b1, w2, b2, y, den, occ, gbl, gem = _problem(3, B, T, U, J, V)
    fp, gp, yp, b1p, _, b2p = planes_cuda.pad_operands(f, g, y, b1, w2, b2,
                                                       wgmma=True)
    Vp = b2p.shape[0]
    db2p = torch.zeros((ctas * LB.WARPS, Vp))
    dl, hb = LB.joint_dlogits(fp, gp, yp, b1p, w2, None, b2p, den, occ, gbl,
                              gem, db2p, V, True, ctas)
    assert dl.shape == (B * T * (U + 1), Vp) and hb.shape == (B * T * (U + 1),
                                                              J)
    assert not db2p[3 * LB.WARPS:].any()
    for w in range(LB.WARPS):  # tile 1 sits alone on CTA 1
        rows = dl[128 + 16 * w:128 + 16 * w + 16].float()  # bf16-rounded
        tol = 16 * float(rows.abs().max()) * 2.0 ** -8 + 1e-6
        assert float((db2p[LB.WARPS + w] - rows.sum(0)).abs().max()) <= tol
    want = TF._plain_grads(f, g, b1, w2, b2, occ, gbl, gem, den, y, True)[4]
    got = db2p.sum(0)[:V]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("T,U1", [(16, 8), (13, 11)])
def test_tanh_grads_two_stage_sums(T, U1):
    """K9's plain version against dh (1 - h^2) summed directly: df over u,
    dg over t (groups of TG, then the groups), db1's partial rows over
    groups of UG u rows, T and U+1 whole groups or not."""
    B, J = 2, 64
    rng = np.random.default_rng(T * U1)
    f, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        BF) for s in ((B, T, J), (B, U1, J)))
    b1 = torch.from_numpy(rng.standard_normal(J).astype(np.float32)).to(BF)
    dh = torch.from_numpy(rng.standard_normal((B * T * U1, J)).astype(
        np.float32))
    df, dg = torch.empty((B, T, J)), torch.empty((B, U1, J))
    db1p = torch.empty((B, -(-U1 // LB.UG), J))
    LB.tanh_grads(dh, f, g, b1, df, dg, db1p)
    h = torch.tanh(f.float()[:, :, None] + g.float()[:, None] + b1.float())
    dpre = dh.reshape(B, T, U1, J) * (1 - h * h)
    for got, want in ((df, dpre.sum(2)), (dg, dpre.sum(1)),
                      (db1p.sum((0, 1)), dpre.sum((0, 1, 2)))):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_backward_takes_the_plain_chain(dtype):
    """On the CPU the fused loss's backward runs `_chunk_grads`, one
    `plain` a chunk, and launches neither kernel: the `kernel` count and
    the kernels' own counts stay untouched."""
    B, T, U, J, V = 9, 6, 3, 16, 20  # 9 rows: 3 chunks of 3
    f, g, b1, w2, b2, y, *_ = _problem(11, B, T, U, J, V)
    rng = np.random.default_rng(12)
    labels = torch.from_numpy(rng.integers(1, V, (B, U)))
    fl = torch.full((B,), T)
    yl = torch.full((B,), U)
    params = [a.to(dtype).requires_grad_() for a in (f, g, b1, w2, b2)]
    assert not LB.fits(*params[:4])
    before = dict(TF.backward_launches_by_design)
    k8, k9 = LB.joint_dlogits.launches, LB.tanh_grads.launches
    TF.rnnt_loss_fused(*params, labels, fl, yl).sum().backward()
    after = TF.backward_launches_by_design
    assert after["kernel"] == before["kernel"]
    assert after["plain"] == before["plain"] + 3
    assert (LB.joint_dlogits.launches, LB.tanh_grads.launches) == (k8, k9)
    assert all(p.grad is not None for p in params)


def test_chunk_rows_keep_a_chunk_under_its_budget():
    """The cells' shapes: wp4096 (B=96, T'=128, U+1=65, J=640, V=4096) in
    chunks of 8 rows, char31 (U+1=116, V=31 padded to 128) of 12, each
    chunk's tensors under 1 GiB (the plain chain's fp32 logits chunk and
    its temporaries take more); odd B takes a divisor, a prime B above 10
    rows one row a chunk."""
    assert LB.chunk_rows(96, 128, 65, 640, 4096) == 8
    assert LB.chunk_rows(96, 128, 116, 640, 128) == 12
    assert LB.chunk_rows(35, 128, 65, 640, 4096) == 7
    assert LB.chunk_rows(29, 128, 65, 640, 4096) == 1
    assert LB.chunk_rows(9, 8, 5, 64, 128) == 9
