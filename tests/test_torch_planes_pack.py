"""The joint-plane kernel's WGMMA design (K6, `csrc/joint_planes.cu`), as far
as it runs without a card: the plan admits the parity and bench shapes and
refuses fp32 and a too-wide joint; the operands' padding (J rows zero, b2
columns -1e30); the packed W2 (`ops.planes_cuda.pack_w2`) inverts exactly to
the padded W2 through the swizzle the kernel's descriptors read, and an
in-place update of W2 gives a new packed copy; and a plain emulation of the
kernel's schedule (128-cell tiles, 64-deep k-blocks read from the packed
tiles, 128-column chunks, each thread's running (max, sum of exp) over its
32 columns of a chunk, the quad merge at the end, blank and emit picked by
chunk) reproduces `joint_planes_plain` and the JAX package's Pallas plane
kernel `_compute_planes` (interpret mode) at a ragged size, fp32, rtol/atol
1e-5.  The kernel itself runs only on the card (`chip_smoke.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.ops import joint_loss_fused as JF
from rnnt_tpu_torch.ops import planes_cuda as PC
from rnnt_tpu_torch.ops.rnnt_loss_ref import NEG

torch.set_num_threads(1)

H100_OPTIN = 232448  # bytes of shared memory a block may opt in to
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("J,stages", [(640, 4), (704, 3), (40, 4), (64, 4),
                                      (128, 4), (768, 0), (1024, 0)])
def test_plan_admits_parity_width_and_refuses_wide_joints(J, stages):
    # the parity and bench geometries share J=640 (V and the cell count do
    # not enter the plan); a J of 768 leaves room for 2 stages only
    assert PC.wgmma_stages(torch.bfloat16, J, H100_OPTIN) == stages
    assert PC.wgmma_stages(torch.float32, J, H100_OPTIN) == 0


def test_plan_is_the_kernel_shared_memory_sum():
    # csrc/joint_planes.cu wg::smem_bytes: alignment slack, h tile, ring,
    # barriers; the planned stages fit and one more would not
    for J in (40, 300, 640, 704):
        st = PC.wgmma_stages(torch.bfloat16, J, H100_OPTIN)
        used = (1024 + PC.padded_j(J) // 64 * 128 * 64 * 2
                + st * PC.STAGE_BYTES + 2 * PC.MAX_STAGES * 8)
        assert used <= H100_OPTIN
        assert st == PC.MAX_STAGES or used + PC.STAGE_BYTES > H100_OPTIN


def _inputs(B, T, U1, J, V, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((B, T, J)).astype(np.float32)
    g = rng.standard_normal((B, U1, J)).astype(np.float32)
    y = rng.integers(0, V, (B, U1)).astype(np.int32)
    b1 = (rng.standard_normal(J) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((J, V)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(V) * 0.1).astype(np.float32)
    arrs = (f, g, y, b1, w2, b2)
    return arrs, tuple(torch.from_numpy(a).to(dtype) if a.dtype == np.float32
                       else torch.from_numpy(a) for a in arrs)


@pytest.mark.parametrize("J,V", [(40, 300), (130, 256), (640, 4096)])
def test_operands_padding(J, V):
    _, (f, g, y, b1, w2, b2) = _inputs(2, 3, 4, J, V, J, torch.bfloat16)
    for wgmma, jp in ((True, PC.padded_j(J)), (False, -(-J // 16) * 16)):
        pf, pg, py, pb1, pw2, pb2 = PC.pad_operands(f, g, y, b1, w2, b2,
                                                    wgmma=wgmma)
        vp = PC.padded_v(V)
        assert pf.shape == (2, 3, jp) and pg.shape == (2, 4, jp)
        assert pb2.shape == (vp,)
        assert pb1.shape == (jp,) and py.dtype == torch.int32
        if wgmma:  # the launch packs and pads W2 itself (pack_w2)
            assert torch.equal(pw2, w2)
        else:
            assert pw2.shape == (jp, vp)
            assert torch.equal(pw2[:J, :V], w2) and not pw2[J:].any()
            assert not pw2[:, V:].any()
        assert torch.equal(pf[..., :J], f) and not pf[..., J:].any()
        assert not pg[..., J:].any() and not pb1[J:].any()
        assert pb2.dtype == torch.float32
        assert torch.equal(pb2[:V], b2.float())
        assert torch.all(pb2[V:] == NEG)
    if PC.padded_j(J) == J:  # nothing to pad: f passes through uncopied
        pf = PC.pad_operands(f, g, y, b1, w2, b2, wgmma=True)[0]
        assert pf.data_ptr() == f.data_ptr()


def _tile(packed, Jp, Vp, chunk, kb):
    """W2[k0:k0+64, v0:v0+128] from the packed buffer, element by element
    as the kernel's 128-byte-swizzled K-major descriptor reads a ring stage:
    tile (chunk, kb) is the (chunk * Jp/64 + kb)-th 16 KB run; row n of it
    holds the 64 k of column v0 + n, its 16-byte group c at c ^ (n % 8)."""
    nkb = Jp // 64
    run = packed[(chunk * nkb + kb) * 8192:(chunk * nkb + kb + 1) * 8192]
    run = run.reshape(128, 8, 8)  # [n, physical group, element]
    n = torch.arange(128)[:, None, None]
    k = torch.arange(64)[None, None, :].expand(128, 1, 64)
    phys = (k // 8) ^ (n % 8)
    return run[n, phys, k % 8][:, 0, :].t()  # [64 k, 128 n]


@pytest.mark.parametrize("J,V", [(40, 300), (640, 4096)])
def test_packed_w2_inverts_to_the_padded_w2(J, V):
    _, (_, _, _, _, w2, _) = _inputs(1, 1, 1, J, V, 3, torch.bfloat16)
    Jp, Vp = PC.padded_j(J), PC.padded_v(V)
    packed = PC.pack_w2(w2)
    assert packed.shape == (Jp * Vp,) and packed.is_contiguous()
    back = torch.cat([torch.cat([_tile(packed, Jp, Vp, c, kb)
                                 for kb in range(Jp // 64)], 0)
                      for c in range(Vp // 128)], 1)
    assert torch.equal(back[:J, :V], w2)
    assert not back[J:].any() and not back[:, V:].any()  # zero padding
    # every 16 KB run is one stage: a permutation of its tile's elements
    run = packed[:8192].reshape(128, 64)
    assert torch.equal(run.sort(1).values, back[:64, :128].t().sort(1).values)


def test_in_place_update_of_w2_gives_a_new_packed_copy():
    _, (_, _, _, _, w2, _) = _inputs(1, 1, 1, 128, 256, 5, torch.bfloat16)
    first = PC.pack_w2(w2)
    w2.add_(1.0)
    second = PC.pack_w2(w2)
    assert not torch.equal(first, second)
    assert torch.equal(second, PC.pack_w2(w2.clone()))


def _merge(a, b):
    """The kernel's quad merge of two lanes' running (max, sum of exp)."""
    (ma, sa), (mb, sb) = a, b
    mn = torch.maximum(ma, mb)
    return mn, sa * torch.exp2((ma - mn) * LOG2E) + sb * torch.exp2(
        (mb - mn) * LOG2E)


def emulate_wgmma_schedule(f, g, y, b1, w2, b2):
    """The WGMMA design's arithmetic and order in plain fp32 PyTorch."""
    B, T, J = f.shape
    U1, V = g.shape[1], w2.shape[1]
    f, g, y, b1, w2, b2p = PC.pad_operands(f, g, y, b1, w2, b2, wgmma=True)
    Jp, Vp = f.shape[2], b2p.shape[0]
    packed = PC.pack_w2(w2)
    N = B * T * U1
    n = torch.arange(N)
    bt, u = n // U1, n % U1
    bb = bt // T
    # columns of quad lane q within a chunk: 8 j + 2 q + e
    cols = [torch.tensor([8 * j + 2 * q + e for j in range(16)
                          for e in range(2)]) for q in range(4)]
    out = [torch.empty(N) for _ in range(3)]
    for n0 in range(0, N, PC.CELLS):
        rows = torch.arange(n0, min(n0 + PC.CELLS, N))
        h = torch.zeros(PC.CELLS, Jp)
        h[:len(rows)] = torch.tanh(f.reshape(B * T, Jp)[bt[rows]]
                                   + g.reshape(B * U1, Jp)[bb[rows] * U1
                                                           + u[rows]] + b1)
        ycell = y.reshape(-1)[bb[rows] * U1 + u[rows]].long()
        run = [(torch.full((PC.CELLS,), NEG), torch.zeros(PC.CELLS))
               for _ in range(4)]
        blank = torch.full((PC.CELLS,), NEG)
        emit = torch.full((PC.CELLS,), NEG)
        for c in range(Vp // 128):
            acc = torch.zeros(PC.CELLS, 128)
            for kb in range(Jp // 64):
                acc += h[:, 64 * kb:64 * (kb + 1)] @ _tile(
                    packed, Jp, Vp, c, kb).float()
            x = acc + b2p[128 * c:128 * (c + 1)]
            for q in range(4):
                m, s = run[q]
                xq = x[:, cols[q]]
                m_new = torch.maximum(m, xq.max(1).values)
                s = s * torch.exp2((m - m_new) * LOG2E) + torch.exp2(
                    xq * LOG2E - (m_new * LOG2E)[:, None]).sum(1)
                run[q] = (m_new, s)
            if c == 0:
                blank = x[:, 0]
            here = (ycell >= 128 * c) & (ycell < 128 * (c + 1))
            k = len(rows)
            emit[:k] = torch.where(here, x[:k].gather(
                1, (ycell - 128 * c).clamp(0, 127)[:, None])[:, 0],
                emit[:k])
        m, s = _merge(_merge(run[0], run[1]), _merge(run[2], run[3]))
        k = len(rows)
        out[0][rows] = (m + torch.log(s))[:k]
        out[1][rows] = blank[:k]
        out[2][rows] = emit[:k]
    return tuple(o.reshape(B, T, U1) for o in out)


@pytest.mark.parametrize("B,T,U1,J,V", [(3, 7, 5, 40, 300),
                                        (2, 11, 9, 130, 256)])
def test_emulated_schedule_matches_plain_and_pallas(B, T, U1, J, V):
    # 105 and 198 cells: a partial last tile; J and V padded
    arrs, args = _inputs(B, T, U1, J, V, B * T + J)
    got = emulate_wgmma_schedule(*args)
    plain = PC.joint_planes_plain(*args)
    pallas = JF._compute_planes(*(jnp.asarray(a) for a in arrs))
    for a, b, c in zip(got, plain, pallas):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                   atol=1e-5)
