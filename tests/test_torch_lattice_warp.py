"""The lattice kernel's schedules (`csrc/rnnt_lattice.cu`), emulated step by
step in fp32 numpy: the warp design (U+1 <= 256: 32 lanes owning runs of q
consecutive positions, each run folded into the composites of its
prefixes, the doubling scan over the lanes' composites as the shuffles run
it, each position of a run from the previous lane's scanned value and its
prefix composite, the previous row carried per lane, the terminal row
injected at T_b - 1) and, above it, the block design (the fold, the doubling
over a block of up to 1024 threads, a sequential walk of each run).  The
emulation computes in natural logarithms with numpy's exact exp and log1p;
the warp design's base-2 MUFU arithmetic is not reproduced bit for bit.
Held within 1e-5 relative (the kernel's gate on the card; the order of
combination and the rounding differ) against the port's plain scans and the
JAX Pallas lattice kernel in interpret mode, over the valid cells and for
ll."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.ops.rnnt_loss_pallas import lattice_scan_pallas
from rnnt_tpu_torch.ops import lattice_cuda
from rnnt_tpu_torch.ops import rnnt_loss_ref as TR

torch.set_num_threads(1)

f32 = np.float32
NEG = f32(TR.NEG)


def lae(a, b):
    """logaddexp as max + log1p(exp(-|a - b|)), in fp32."""
    return np.maximum(a, b) + np.log1p(np.exp(-np.abs(a - b)))


def solve_row(c, w, direction, warp):
    """One row: c, w [lanes, q] by scan order -> (values [lanes, q] by scan
    order, each lane's scanned value).  direction 1 scans from lane 0 up,
    -1 from the last lane down.  The warp design skips a scan step where the
    source lane is out of range and finds each position from its prefix
    composite; the block design combines with log 0 there and walks the run
    sequentially."""
    n, q = c.shape
    lanes = np.arange(n)
    Cf, Wf = [c[:, 0].copy()], [w[:, 0].copy()]
    for k in range(1, q):  # fold the run, keeping its prefixes' composites
        Cf.append(lae(c[:, k], w[:, k] + Cf[-1]))
        Wf.append(Wf[-1] + w[:, k])
    C, W = Cf[-1], Wf[-1]
    s = 1
    while s < n:  # doubling over the lanes' composites
        src = lanes - s if direction > 0 else lanes + s
        ok = (src >= 0) & (src < n)
        cp = np.where(ok, C[np.clip(src, 0, n - 1)], NEG)
        wp = np.where(ok, W[np.clip(src, 0, n - 1)], f32(0))
        C_new = lae(C, W + cp)
        C = np.where(ok, C_new, C) if warp else C_new
        W = W + wp
        s *= 2
    src = lanes - 1 if direction > 0 else lanes + 1
    v = np.where((src >= 0) & (src < n), C[np.clip(src, 0, n - 1)], NEG)
    x = np.empty_like(c)
    for k in range(q - 1):  # the run from the previous lane's value
        if warp:
            x[:, k] = lae(Cf[k], Wf[k] + v)
        else:
            v = lae(c[:, k], w[:, k] + v)
            x[:, k] = v
    x[:, q - 1] = C
    return x, C


def emulate_lattice(b, e, fl, yl):
    """(alpha, beta, ll) by the schedule of the design the kernel runs."""
    B, T, U1 = b.shape
    warp = U1 <= lattice_cuda.WARP_MAX_U1
    n = 32 if warp else min(1024, max(32, 1 << (U1 - 1).bit_length()))
    q = -(-U1 // n)
    up = np.arange(n)[:, None] * q + np.arange(q)[None, :]  # alpha's order
    down = up[:, ::-1]                                       # beta's order
    alpha, beta = np.zeros_like(b), np.zeros_like(b)
    ll = np.zeros(B, f32)

    def at(plane, pos):
        return np.where(pos < U1, plane[np.minimum(pos, U1 - 1)], NEG)

    for r in range(B):
        prev = np.full((n, q), NEG, f32)
        for t in range(T):
            w = np.where(up >= 1, at(e[r, t], np.maximum(up - 1, 0)), NEG)
            c = (np.where(up == 0, f32(0), NEG) if t == 0
                 else prev + at(b[r, t - 1], up))
            prev, _ = solve_row(c, w, 1, warp)
            alpha[r, t, up[up < U1]] = prev[up < U1]
        prev = np.full((n, q), NEG, f32)
        for t in range(T - 1, -1, -1):
            if t == fl[r] - 1:
                below = np.where(down == yl[r], f32(0), NEG)
            else:
                below = prev if t < T - 1 else np.full_like(prev, NEG)
            c = at(b[r, t], down) + below
            prev, C = solve_row(c, at(e[r, t], down), -1, warp)
            beta[r, t, down[down < U1]] = prev[down < U1]
        ll[r] = C[0]
    return alpha, beta, ll


def _planes(U1, T=9, B=4, seed=0):
    rng = np.random.default_rng(seed + U1)
    b = (-3.0 * rng.random((B, T, U1)) - 0.05).astype(f32)
    e = (-3.0 * rng.random((B, T, U1)) - 0.05).astype(f32)
    # ragged: one row full, one at fl = 1 and yl = 0, two random
    fl = np.array([T, 1, *rng.integers(1, T + 1, B - 2)], np.int32)
    yl = np.array([U1 - 1, 0, *rng.integers(0, U1, B - 2)], np.int32)
    u = np.arange(U1)[None, None, :]
    e = np.where(u < yl[:, None, None], e, NEG).astype(f32)
    return b, e, fl, yl


def _assert_close(got, want, valid):
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g[valid], w[valid], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("U1", [1, 2, 31, 32, 33, 65, 97, 257, 1025])
def test_schedule_matches_plain_and_pallas(U1):
    b, e, fl, yl = _planes(U1)
    got = emulate_lattice(b, e, fl, yl)
    _, T, _ = b.shape
    valid = ((np.arange(T)[None, :, None] < fl[:, None, None])
             & (np.arange(U1)[None, None, :] <= yl[:, None, None]))
    plain = [x.numpy() for x in TR.lattice_scan_plain(
        *(torch.from_numpy(a) for a in (b, e, fl, yl)))]
    _assert_close(got, plain, valid)
    pallas = [np.asarray(x) for x in lattice_scan_pallas(
        *(jnp.asarray(a) for a in (b, e, fl, yl)), interpret=True)]
    _assert_close(got, pallas, valid)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
