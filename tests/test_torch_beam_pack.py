"""The beam kernel's streamed advance, as far as it runs without a card: the
packed weight slices (`ops.beam_cuda.pack_layer`) invert exactly to Wx, Wh
and Wp; every gate and projection column belongs to exactly one block; an
in-place weight update gives a new packed copy; the plan admits the parity
width's serving shapes and refuses fp32, too many hypothesis rows and a
ring past the shared memory; and an emulation of the kernel's per-warp
streams (chunk order, slots, fragment reads) reproduces the layer's
products exactly.  The kernel itself runs only on the card
(`chip_smoke.py`)."""

import numpy as np
import pytest
import torch

from rnnt_tpu_torch.config import RNNTConfig
from rnnt_tpu_torch.models.transducer import Transducer
from rnnt_tpu_torch.ops import beam_cuda as BC

torch.set_num_threads(1)

H100_OPTIN = 232448  # bytes of shared memory a block may opt in to
# (H, P, D) and grid sizes: slices of 8 units / columns, uneven shares,
# blocks without Wp columns, x and h padded to 16
WIDTHS = [(48, 24, 20), (64, 40, 36)]
GRIDS = [3, 5]


def _weights(H, P, D, seed):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)
    return rand(D, 4 * H), rand(P, 4 * H), rand(H, P)


def _share(segments, w):
    """Warp w's share of a product's k16 slices, as the kernel deals them
    (`warp_share` in csrc/beam_search.cu): (first slice, stride, count,
    position of its first slice in warp order)."""
    ws = BC.NWARP // len(segments)
    sg, lw = w // ws, w % ws
    n, base = segments[sg], sum(segments[:sg])
    cnt = -(-(n - lw) // ws) if lw < n else 0
    return base + lw, ws, cnt, base + lw * (n // ws) + min(lw, n % ws)


def _decode(packed, rows, kp, bounds, segments):
    """The dense [rows, kp] matrix back from a packed run, element by
    element from the packed layout the kernel reads (csrc/beam_search.cu):
    block b's run starts at (r0 / 8) nsl 128 values; warp w's i-th slice
    sits at its first slice's position plus i; a slice holds the block's
    rows in order, 16 values a row."""
    nsl = kp // 16
    assert sum(segments) == nsl
    where = {}  # slice -> position in warp order
    for w in range(BC.NWARP):
        s0, step, cnt, first = _share(segments, w)
        for i in range(cnt):
            where[s0 + step * i] = first + i
    assert sorted(where) == list(range(nsl))
    assert sorted(where.values()) == list(range(nsl))
    flat = packed.tolist()
    out = [[None] * kp for _ in range(rows)]
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        base = r0 // 8 * nsl * 128
        for s in range(nsl):
            pos = where[s]
            for r in range(r1 - r0):
                for kk in range(16):
                    off = base + (pos * (r1 - r0) + r) * 16 + kk
                    out[r0 + r][16 * s + kk] = flat[off]
    return torch.tensor(out, dtype=torch.float32)


@pytest.mark.parametrize("nblk", GRIDS)
@pytest.mark.parametrize("H,P,D", WIDTHS)
def test_packed_layout_inverts_to_the_weights(H, P, D, nblk):
    wx, wh, wp = _weights(H, P, D, seed=H + nblk)
    for layer, (x_w, din) in enumerate([(wx, D), (wh.clone(), P)]):
        gates, wpk = BC.pack_layer(x_w, wh, wp, nblk)
        kx, kp = -(-din // 16) * 16, BC.gate_k(D, P, layer)
        assert gates.numel() == 4 * H * kp and gates.dtype == torch.bfloat16
        a = _decode(gates, 4 * H, kp,
                    [4 * BC.slice8(b, H, nblk) for b in range(nblk + 1)],
                    (kx // 16, (kp - kx) // 16))
        # row 4u + gate over k: x (din rows of Wx), zeros, h, zeros
        a = a.reshape(H, 4, kp).permute(2, 1, 0).reshape(kp, 4 * H)
        assert torch.equal(a[:din], x_w.float())
        assert torch.equal(a[kx:kx + P], wh.float())
        assert not a[din:kx].any() and not a[kx + P:].any()
        kw = -(-H // 16) * 16
        ap = _decode(wpk, P, kw, [BC.slice8(b, P, nblk)
                                  for b in range(nblk + 1)], (kw // 16,))
        assert torch.equal(ap[:, :H].t(), wp.float())
        assert not ap[:, H:].any()


@pytest.mark.parametrize("nblk", GRIDS + [132])
@pytest.mark.parametrize("H,P", [(48, 24), (64, 40), (2048, 640)])
def test_every_column_owned_by_exactly_one_block(H, P, nblk):
    for n in (H, P):
        begins = [BC.slice8(b, n, nblk) for b in range(nblk + 1)]
        assert begins[0] == 0 and begins[-1] == n
        widths = np.diff(begins)
        assert (widths >= 0).all() and (widths % BC.SLICE == 0).all()
        assert widths.max() == BC.slice_max(n, nblk)
        owner = np.repeat(np.arange(nblk), widths)
        assert len(owner) == n  # each column once, blocks in order
    # every packed run sits where the kernel looks for it, none overlapping
    if H <= 64:
        wx, wh, wp = _weights(H, P, 20, seed=1)
        gates, wpk = BC.pack_layer(wx, wh, wp, nblk)
        nsl = BC.gate_k(20, P, 0) // 16
        ends = [4 * BC.slice8(b, H, nblk) // 8 * nsl * 128
                for b in range(nblk + 1)]
        assert ends[-1] == gates.numel()
        nslp = -(-H // 16)
        assert BC.slice8(nblk, P, nblk) // 8 * nslp * 128 == wpk.numel()


def _tiny_model(dtype=torch.bfloat16):
    cfg = RNNTConfig(vocab_size=24, encoder_layers=2, encoder_size=16,
                     projection_size=24, pred_net_layers=2,
                     pred_net_size=48, joint_size=8, embedding_size=20,
                     mel_bins=4, time_reduction_index=0)
    return Transducer(cfg).init_(0).cast_(dtype).eval()


def test_in_place_weight_update_gives_a_new_packed_copy():
    model = _tiny_model()
    first = BC.packed_slices(model, 3)
    assert BC.packed_slices(model, 3) is first  # kept while unchanged
    lstm = model.prediction.layers[1].lstm
    with torch.no_grad():
        lstm.wh.add_(torch.ones_like(lstm.wh) * 0.5)
    second = BC.packed_slices(model, 3)
    assert second is not first
    fresh = BC.pack_layer(lstm.wx, lstm.wh, lstm.wp, 3)
    for got, want in zip(second[1], fresh):
        assert torch.equal(got, want)
    assert not torch.equal(second[1][0], first[1][0])
    assert torch.equal(second[0][0], first[0][0])  # layer 0 unchanged
    # another grid is another layout
    assert BC.packed_slices(model, 5) is not second
    # a copy_ (a checkpoint restore, an optimizer step) is a change too
    with torch.no_grad():
        lstm.wp.copy_(lstm.wp * 2)
    third = BC.packed_slices(model, 5)
    assert torch.equal(third[1][1], BC.pack_layer(lstm.wx, lstm.wh,
                                                  lstm.wp, 5)[1])


PARITY = dict(V=4096, P=640, J=640, D=500, H=2048, n_layers=2)


def test_plan_admits_the_serving_shapes_and_refuses_the_rest():
    bf16, f32 = torch.bfloat16, torch.float32
    for B in (1, 2, 3, 4):  # N = 4 .. 16 hypothesis rows
        slots = BC.stream_plan(bf16, B, 4, 132, H100_OPTIN, **PARITY)
        assert slots == BC.RING_SLOTS, (B, slots)
        assert BC.smem_bytes(B, 4, 132, slots=slots, **PARITY) <= H100_OPTIN
    # fp32 runs the FMA design at any size
    assert BC.stream_plan(f32, 1, 4, 132, H100_OPTIN, **PARITY) == 0
    # more than two n8 tiles of hypothesis rows
    assert BC.stream_plan(bf16, 5, 4, 132, H100_OPTIN, **PARITY) == 0
    # an oversize ring: a card with less shared memory, or a slice too wide
    small = BC.smem_bytes(1, 4, 132, slots=2, **PARITY) - 1
    assert BC.stream_plan(bf16, 1, 4, 132, small, **PARITY) == 0
    assert BC.stream_plan(bf16, 1, 4, 132, small + 1, **PARITY) == 2
    # a block slice of more than MAXR rows (64 blocks: 32 units, 128 rows)
    assert BC.stream_plan(bf16, 1, 4, 64, H100_OPTIN, **PARITY) == 0
    # a block owning part of a 16-byte vector
    assert BC.stream_plan(bf16, 1, 4, 132, H100_OPTIN,
                          **dict(PARITY, H=2052)) == 0


def _emulate_products(prods, nblk, slots, sbytes, n_exp=3):
    """Every block's warps as the kernel runs them.  prods: the products of
    an expansion in order, (packed run, block row bounds, k, rows x [N,
    k], k16 slices a segment).  Lane 0 issues chunk q of the warp's
    sequence into slot q % slots as soon as chunk q - slots is consumed,
    its cursor skipping products where the warp has no chunk and wrapping
    to the next expansion (the kernel's `issue`); the consumer reads each
    slot's slices (rows of 16 values) against the hypothesis rows and adds
    the 16 warps' partial products.  Returns each product's out [rows, N]
    of the last expansion."""
    outs = [torch.zeros((b[-1], x.shape[0])) for _, b, _, x, _ in prods]
    for blk in range(nblk):
        def shape(pi, w):  # (base, nh, cpc, warp's share)
            _, bounds, kp, _, segs = prods[pi]
            nh = (bounds[blk + 1] - bounds[blk]) // 8
            cpc = sbytes // (nh * BC.HALF) if nh else 1
            s0, step, cnt, first = _share(segs, w)
            return (bounds[blk] // 8 * (kp // 16) * 128, nh, cpc, s0, step,
                    cnt if nh else 0, first)

        def chunks(pi, w):
            return -(-shape(pi, w)[5] // shape(pi, w)[2])

        for w in range(BC.NWARP):
            per_exp = sum(chunks(pi, w) for pi in range(len(prods)))
            total, ring = per_exp * n_exp, {}
            cur = {"q": 0, "pi": 0, "c": 0}

            def issue():
                if cur["q"] >= total:
                    return
                while cur["c"] >= chunks(cur["pi"], w):
                    cur["c"], cur["pi"] = 0, (cur["pi"] + 1) % len(prods)
                base, nh, cpc, _, _, nsw, first = shape(cur["pi"], w)
                i0 = cur["c"] * cpc
                n = min(cpc, nsw - i0) * nh * 128
                off = base + (first + i0) * nh * 128
                ring[cur["q"] % slots] = (cur["q"], prods[cur["pi"]][0]
                                          .float()[off:off + n])
                cur["c"] += 1
                cur["q"] += 1
            for _ in range(slots):
                issue()
            q = 0
            for e in range(n_exp):
                for pi, (_, bounds, _, x, _) in enumerate(prods):
                    _, nh, cpc, s0, step, nsw, _ = shape(pi, w)
                    for i0 in range(0, nsw, cpc):
                        tag, data = ring[q % slots]
                        assert tag == q  # the chunk the consumer expects
                        assert data.numel() == min(cpc, nsw - i0) * nh * 128
                        R = 8 * nh
                        for i in range(min(cpc, nsw - i0)):
                            s = s0 + step * (i0 + i)
                            a = data[i * R * 16:(i + 1) * R * 16]
                            part = a.reshape(R, 16) @ x[:, 16 * s:16 * s
                                                         + 16].t()
                            if e == n_exp - 1:
                                r = bounds[blk]
                                outs[pi][r:r + R] += part
                        q += 1
                        issue()
            assert q == total == cur["q"]  # nothing left in flight
    return outs


# (96, 40, 300): 22 k16 slices of gates, so warps stream several chunks
@pytest.mark.parametrize("slots", [2, 3])
@pytest.mark.parametrize("H,P,D", WIDTHS + [(96, 40, 300)])
def test_emulated_stream_reproduces_the_layer_products(H, P, D, slots):
    nblk = 3
    wx, wh, wp = _weights(H, P, D, seed=7)
    gates, wpk = BC.pack_layer(wx, wh, wp, nblk)
    g = torch.Generator().manual_seed(3)
    N = 5
    kx, kp = -(-D // 16) * 16, BC.gate_k(D, P, 0)
    x = torch.zeros((N, kp))
    x[:, :D] = torch.randn((N, D), generator=g)
    x[:, kx:kx + P] = torch.randn((N, P), generator=g)
    x = x.to(torch.bfloat16).float()
    kw = -(-H // 16) * 16
    hid = torch.zeros((N, kw))
    hid[:, :H] = torch.randn((N, H), generator=g).to(torch.bfloat16).float()
    got_g, got_p = _emulate_products(
        [(gates, [4 * BC.slice8(b, H, nblk) for b in range(nblk + 1)], kp,
          x, (kx // 16, (kp - kx) // 16)),
         (wpk, [BC.slice8(b, P, nblk) for b in range(nblk + 1)], kw, hid,
          (kw // 16,))],
        nblk, slots, BC.slot_bytes(H, P, nblk))
    z = x[:, :D] @ wx.float() + x[:, kx:kx + P] @ wh.float()  # [N, 4H]
    want = z.reshape(N, 4, H).permute(2, 1, 0).reshape(4 * H, N)
    torch.testing.assert_close(got_g, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got_p, (hid[:, :H] @ wp.float()).t(),
                               rtol=1e-5, atol=1e-4)
