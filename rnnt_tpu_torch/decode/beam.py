"""Transducer beam search: the plain version of kernel K3 and the entry
points.

The port of `rnnt_tpu.decode.beam`: the breadth-first "modified" transducer
search with a static number E of label expansions per frame and the
incremental duplicate-prefix merge (Graves 2012: a prefix's probability sums
over its alignments).  Per encoder frame:

  expanding = beam; logp = log_softmax(joint(enc_t, expanding))   [B, K, V]
  settled   = expanding with scores + blank logp
  repeat E times:
      labels   = top-K over each utterance's K x (V-1) label moves; append
                 the token, advance the prediction net
      logp     = joint log-probs of the advanced set
      advanced = advanced scores + blank logp
      merge      advanced rows whose token prefix equals a settled row's into
                 that row (logaddexp), and kill the advanced copy
      settled  = top-K over settled | advanced
  beam = settled (frames at or past an utterance's length keep its beam)

`beam_search_encoded_plain` is that search in plain PyTorch, with the
rounding points of the CUDA kernel (`csrc/beam_search.cu`), which follow the
TPU kernel (`rnnt_tpu/ops/beam_pallas.py`), not greedy decoding's:

- joint: fj = enc_t @ W1 + b1 and g = pred @ W1 as separate fp32 products,
  tanh(fj + g) rounded to the weight type, @ W2 + b2 in fp32, log-softmax in
  fp32 (greedy's `joint_step` adds enc + pred before W1);
- prediction-net layer: z = x @ Wx + h @ Wh + bias in fp32 with x and h in
  the weight type; c in fp32; hid rounded; h_new = hid @ Wp in fp32;
  LayerNorm of the unrounded h_new; the state keeps h_new rounded.

In fp32 all of these agree with the JAX search to ~1e-6; in bf16 the plain
version is the kernel's yardstick on the card.  Selection ties go to the
lowest index: label moves over the flat [K, V] layout (parent row, then
label), the pool over [settled | advanced].  Dead hypotheses score NEG and
never merge.

`beam_search_decode` encodes, then searches with the kernel's wrapper
(`ops.beam_cuda.beam_search`), which runs the kernel on a CUDA tensor and
this plain version on a CPU tensor.  A model with int8 weights (int8
execution) searches instead with `beam_search_encoded_xla`, the counterpart
of the JAX package's XLA beam, which is where the JAX package sends int8
weights: the same selection and merging, through the model's int8-aware
`joint_step` and `predict_step` (`search_by_kind`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from rnnt_tpu_torch.models.encoder import require_lstm_encoder
from rnnt_tpu_torch.models.transducer import Transducer

NEG = -1e30


class Beam(NamedTuple):
    """SoA beam state; tensors lead with [B, K]."""

    scores: torch.Tensor     # [B, K] fp32
    tokens: torch.Tensor     # [B, K, L] int64
    lengths: torch.Tensor    # [B, K] int64
    pred_out: torch.Tensor   # [B, K, P] weight dtype
    state: List[Tuple[torch.Tensor, torch.Tensor]]  # (c fp32, h) [B, K, .]


def initial_beam(model: Transducer, B: int, K: int, device):
    """The prediction net after the start token 0, for B*K rows: (pred_out
    [B*K, P], state [(c, h)] of [B*K, .]) and the scores [B, K] with only
    hypothesis 0 alive, as both searches start."""
    dt = model.dtype
    state0 = model.prediction_zero_state(B * K, dt)
    pred0, state0 = model.predict_step(
        torch.zeros((B * K,), dtype=torch.long, device=device), state0)
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    return pred0.to(dt), [(c.float(), h.to(dt)) for c, h in state0], scores


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather x [B, M, ...] along dim 1 with idx [B, K'] -> [B, K', ...]."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def _gather(beam: Beam, idx: torch.Tensor) -> Beam:
    return Beam(_rows(beam.scores, idx), _rows(beam.tokens, idx),
                _rows(beam.lengths, idx), _rows(beam.pred_out, idx),
                [(_rows(c, idx), _rows(h, idx)) for c, h in beam.state])


def _concat(a: Beam, b: Beam) -> Beam:
    def cat(x, y):
        return torch.cat([x, y], dim=1)
    return Beam(cat(a.scores, b.scores), cat(a.tokens, b.tokens),
                cat(a.lengths, b.lengths), cat(a.pred_out, b.pred_out),
                [(cat(ca, cb), cat(ha, hb))
                 for (ca, ha), (cb, hb) in zip(a.state, b.state)])


def _select(scores: torch.Tensor, k: int):
    """Top-k of scores [B, M] along dim 1, ties to the lowest index (a
    stable descending sort).  Returns (values [B, k+1 or fewer], indices)."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, : k + 1], idx[:, :k]


def _gaps(vals: torch.Tensor) -> torch.Tensor:
    """Each row's smallest gap between consecutive live values of a sorted
    [B, M] (inf where there is none) -> [B]."""
    live = vals[:, 1:] > NEG / 2
    gaps = torch.where(live, vals[:, :-1] - vals[:, 1:],
                       torch.full_like(vals[:, 1:], float("inf")))
    if gaps.shape[1] == 0:
        return torch.full(vals.shape[:1], float("inf"), device=vals.device)
    return gaps.min(dim=1).values


def trace_divergence(got: dict, want: dict, enc_lengths: torch.Tensor,
                     expansions_per_frame: int):
    """Where two traces of one search part, utterance by utterance.

    A trace (the plain search's `stats`, the kernel's `trace`) holds "idx"
    and "val" [S, B, K]: the indices and scores a search chose at each of
    its S = frames * E * 2 selections, in the order it made them (frame,
    expansion, then the label moves before the pool).  Label moves are
    indexed over the flat [K, V] layout (parent * V + label), the pool over
    [settled | advanced].  Selections at or past an utterance's length are
    left out, and so are picks that are dead on both sides.

    Returns, for each utterance, (first selection whose picks differ, or
    None; the drift: the largest |score difference| of a pick the two
    traces share, live in both, up to and including that selection, or over
    all of them).  Picks that differ do not count towards the drift, so a
    wrong pick cannot excuse itself."""
    idx_g, idx_w = got["idx"].cpu(), want["idx"].cpu()
    val_g, val_w = got["val"].cpu(), want["val"].cpu()
    S = min(idx_g.shape[0], idx_w.shape[0])
    frame = torch.arange(S) // (2 * expansions_per_frame)
    out = []
    for b in range(idx_w.shape[1]):
        n = int((frame < int(enc_lengths[b])).sum())
        ig, iw = idx_g[:n, b], idx_w[:n, b]
        vg, vw = val_g[:n, b], val_w[:n, b]
        live_g, live_w = vg > NEG / 2, vw > NEG / 2
        differ = ((ig != iw) & (live_g | live_w)).any(dim=1).nonzero()
        first = int(differ[0]) if len(differ) else None
        upto = n if first is None else first + 1
        both = (live_g & live_w & (ig == iw))[:upto]
        d = (vg[:upto] - vw[:upto]).abs()[both]
        out.append((first, float(d.max()) if d.numel() else 0.0))
    return out


def merge_into_settled(settled: Beam, adv_scores: torch.Tensor,
                       adv_tokens: torch.Tensor, adv_lengths: torch.Tensor):
    """logaddexp-merge advanced (blank-settled) hypotheses into the settled
    pool where both hold the same token prefix (`_merge_adv_into_settled`).

    Only rows of one utterance with equal lengths, equal tokens over
    [0, len) and both alive match.  Both pools are duplicate-free, so each
    advanced row matches at most one settled row; the settled copy keeps the
    mass (its prediction-net state is a function of the prefix alone) and
    the advanced copy is killed to NEG.  Returns (settled scores, advanced
    scores, number of merges)."""
    L = settled.tokens.shape[-1]
    pos = torch.arange(L, device=adv_tokens.device)
    neq = settled.tokens[:, :, None, :] != adv_tokens[:, None, :, :]
    neq &= pos < settled.lengths[:, :, None, None]
    eq = (settled.lengths[:, :, None] == adv_lengths[:, None, :]) \
        & ~neq.any(-1)                                      # [B, Ks, Ka]
    eq &= (settled.scores > NEG / 2)[:, :, None]
    eq &= (adv_scores > NEG / 2)[:, None, :]
    add = torch.where(eq, adv_scores[:, None, :],
                      torch.full_like(eq, NEG, dtype=adv_scores.dtype))
    m = add.max(dim=-1).values
    merged = torch.where(m > NEG / 2, torch.logaddexp(settled.scores, m),
                         settled.scores)
    killed = torch.where(eq.any(dim=1), torch.full_like(adv_scores, NEG),
                         adv_scores)
    return merged, killed, eq.sum()


class _PlainWeights:
    """fp32 copies of the decode-side weights, and the LayerNorm of a
    prediction-net layer, with the kernel's rounding points."""

    def __init__(self, model: Transducer):
        refuse_int8(model, "the plain search (kernel K3's yardstick)")
        j, p = model.joint, model.prediction
        self.dt = model.dtype
        self.w1, self.b1 = j.w1.float(), j.b1.float()
        self.w2, self.b2 = j.w2.float(), j.b2.float()
        self.embed = p.embed
        self.layers = [
            (blk.lstm.wx.float(), blk.lstm.wh.float(), blk.lstm.bias.float(),
             blk.lstm.wp.float(), blk.ln.scale.float(), blk.ln.bias.float())
            for blk in p.layers]

    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        """Round fp32 values to the weight type, kept as fp32."""
        return x.to(self.dt).float()

    def joint_fj(self, enc_t: torch.Tensor) -> torch.Tensor:
        """enc_t [B, P] -> fj = enc_t @ W1 + b1 [B, J] fp32."""
        return self.rnd(enc_t.float()) @ self.w1 + self.b1

    def joint_logp(self, fj: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """fj [B, J], pred [B, K, P] -> log-probs [B, K, V] fp32."""
        g = pred.float() @ self.w1
        h = self.rnd(torch.tanh(fj[:, None, :] + g))
        return torch.log_softmax(h @ self.w2 + self.b2, dim=-1)

    def advance(self, labels: torch.Tensor, state):
        """Embed labels [B, K], then each layer's LSTM step and LayerNorm.
        Returns (pred_out [B, K, P] weight dtype, new state)."""
        x = self.embed[labels].float()
        new_state = []
        for (wx, wh, bias, wp, ln_s, ln_b), (c, h) in zip(self.layers, state):
            z = self.rnd(x) @ wx + h.float() @ wh + bias
            i, g, f, o = torch.chunk(z, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            hid = self.rnd(torch.sigmoid(o) * torch.tanh(c))
            h_new = hid @ wp
            new_state.append((c, h_new.to(self.dt)))
            mean = h_new.mean(dim=-1, keepdim=True)
            var = ((h_new - mean) ** 2).mean(dim=-1, keepdim=True)
            x = (h_new - mean) * torch.rsqrt(var + 1e-3) * ln_s + ln_b
        return x.to(self.dt), new_state


class _ModelSteps:
    """The search's steps through the model's own `joint_step` and
    `predict_step`, as the JAX package's XLA beam takes them
    (`rnnt_tpu.decode.beam.beam_search_encoded`): the joint adds enc_t and
    pred before W1, and int8 weights run through `qdot` / `qtake`."""

    def __init__(self, model: Transducer):
        self.model = model

    def joint_fj(self, enc_t: torch.Tensor) -> torch.Tensor:
        return enc_t

    def joint_logp(self, enc_t: torch.Tensor,
                   pred: torch.Tensor) -> torch.Tensor:
        """enc_t [B, P], pred [B, K, P] -> log-probs [B, K, V] fp32."""
        B, K, P = pred.shape
        logits = self.model.joint_step(enc_t.repeat_interleave(K, dim=0),
                                       pred.reshape(B * K, P))
        return torch.log_softmax(logits, dim=-1).reshape(B, K, -1)

    def advance(self, labels: torch.Tensor, state):
        """labels [B, K] through one prediction-net step of the B*K rows."""
        B, K = labels.shape
        out, new = self.model.predict_step(
            labels.reshape(B * K),
            [(c.reshape(B * K, -1), h.reshape(B * K, -1)) for c, h in state])
        return out.reshape(B, K, -1), [
            (c.reshape(B, K, -1), h.reshape(B, K, -1)) for c, h in new]


def refuse_int8(model: Transducer, what: str) -> None:
    """Raise if the model holds int8 weights: `what` reads fp weights."""
    if model.int8_names():
        raise ValueError(
            f"{what} reads fp weights, and this model holds int8 ones; "
            "int8 weights search with decode.beam.beam_search_encoded_xla")


@torch.no_grad()
def beam_search_encoded_xla(model: Transducer, encoded: torch.Tensor,
                            enc_lengths: torch.Tensor, *, beam_width: int,
                            max_output_length: int,
                            expansions_per_frame: int,
                            merge_duplicates: bool = True,
                            stats: Optional[dict] = None):
    """The counterpart of the JAX package's XLA beam, the search it runs
    for int8 weights (`rnnt_tpu/serve.py`: impl="xla" under int8
    execution): the plain search's selection and merging, with the steps
    of `_ModelSteps`.  It takes int8 weights only and raises on fp ones,
    which search in kernel K3 (`ops.beam_cuda.beam_search`).  Arguments and
    results as `beam_search_encoded_plain`."""
    if not model.int8_names():
        raise ValueError("beam_search_encoded_xla is the int8 search; fp "
                         "weights search with ops.beam_cuda.beam_search")
    return _search(model, _ModelSteps(model), encoded, enc_lengths,
                   beam_width=beam_width, max_output_length=max_output_length,
                   expansions_per_frame=expansions_per_frame,
                   merge_duplicates=merge_duplicates, stats=stats)


@torch.no_grad()
def beam_search_encoded_plain(model: Transducer, encoded: torch.Tensor,
                              enc_lengths: torch.Tensor, *, beam_width: int,
                              max_output_length: int,
                              expansions_per_frame: int,
                              merge_duplicates: bool = True,
                              stats: Optional[dict] = None,
                              follow: Optional[dict] = None):
    """The plain search from encoder output [B, T', P] and lengths [B].

    Returns (best tokens [B, L] int32, best lengths [B] int32, beam scores
    [B, K] fp32, sorted descending).  With a `stats` dict, fills in the
    search's trace, "idx" and "val" [S, B, K] (see `trace_divergence`), and
    "gap" [S, B], each selection's smallest gap between consecutive live
    candidates among its top K+1 (where another implementation first picks
    otherwise, a gap below the two sides' score difference explains it);
    "min_gap", the smallest of them all; and "merges", the number of
    duplicate-prefix merges.

    With `follow`, another search's trace (the kernel's), the search takes
    that trace's picks at every selection, in its order, instead of its own
    top K: it scores the other search's path.  `stats` then also holds
    "own" [S, B, K], the picks it would have made, and "slack" [S, B], how
    far the picks it was made to take fall below its own top K (the
    largest difference between its own sorted top-K values and the sorted
    values of those picks; 0 where they are the same set)."""
    return _search(model, _PlainWeights(model), encoded, enc_lengths,
                   beam_width=beam_width, max_output_length=max_output_length,
                   expansions_per_frame=expansions_per_frame,
                   merge_duplicates=merge_duplicates, stats=stats,
                   follow=follow)


def _search(model, w, encoded, enc_lengths, *, beam_width,
            max_output_length, expansions_per_frame, merge_duplicates,
            stats, follow=None):
    """The search over encoder output with the steps `w` (joint_fj,
    joint_logp, advance); with `follow`, along another trace's picks."""
    require_lstm_encoder(model.cfg, "beam search")
    B, T, P = encoded.shape
    K, L, E = beam_width, max_output_length, expansions_per_frame
    V = model.cfg.vocab_size
    dev = encoded.device
    pred0, state0, scores = initial_beam(model, B, K, dev)
    beam = Beam(scores, torch.zeros((B, K, L), dtype=torch.long, device=dev),
                torch.zeros((B, K), dtype=torch.long, device=dev),
                pred0.reshape(B, K, P),
                [(c.reshape(B, K, -1), h.reshape(B, K, -1))
                 for c, h in state0])
    enc_lengths = enc_lengths.to(dev)
    trace = {"idx": [], "val": [], "gap": []}
    if follow is not None:
        trace.update(own=[], slack=[])
    n_sel = [0]

    def choose(flat, to_trace, from_trace):
        """Own top K of flat [B, M]; with `follow`, that trace's picks at
        this selection instead (indices mapped to and from the trace's
        layout).  Records the selection; returns (values, indices)."""
        vals, top = _select(flat, K)
        own = to_trace(top)
        if follow is None:
            picked, idx = vals[:, :K], top
        else:
            theirs = follow["idx"][n_sel[0]].to(dev).long()
            idx = torch.clamp(from_trace(theirs), 0, flat.shape[1] - 1)
            picked = flat.gather(1, idx)
        n_sel[0] += 1
        if stats is not None:
            trace["idx"].append(to_trace(idx).to(torch.int32))
            trace["val"].append(picked)
            trace["gap"].append(_gaps(vals))
            if follow is not None:
                mine = vals[:, :K]
                short = torch.sort(picked, dim=1, descending=True).values
                slack = torch.where(mine > NEG / 2, mine - short,
                                    torch.zeros_like(mine))
                trace["own"].append(own.to(torch.int32))
                trace["slack"].append(slack.max(dim=1).values.clamp(min=0))
        return picked, idx

    merges = torch.zeros((), dtype=torch.long, device=dev)
    n_frames = min(T, int(enc_lengths.max())) if B else 0
    for t in range(n_frames):
        alive = t < enc_lengths                              # [B]
        fj = w.joint_fj(encoded[:, t, :])
        expanding = beam
        logp = w.joint_logp(fj, expanding.pred_out)
        settled = expanding._replace(scores=expanding.scores + logp[..., 0])
        for _ in range(E):
            # label moves: blank is never a label; the length cap kills them
            cand = expanding.scores[..., None] + logp[..., 1:]  # [B, K, V-1]
            cand = torch.where((expanding.lengths >= L)[..., None],
                               torch.full_like(cand, NEG), cand)
            # the trace indexes label moves over [K, V] (parent, label)
            top_sc, top = choose(
                cand.reshape(B, K * (V - 1)),
                lambda i: i // (V - 1) * V + i % (V - 1) + 1,
                lambda i: i // V * (V - 1) + torch.clamp(i % V - 1, min=0))
            labels = top % (V - 1) + 1
            parent = _gather(expanding, top // (V - 1))
            slot = torch.clamp(parent.lengths, max=L - 1)
            tokens = parent.tokens.scatter(2, slot[..., None],
                                           labels[..., None])
            lengths = parent.lengths + (top_sc > NEG / 2).long()
            pred, state = w.advance(labels, parent.state)
            expanding = Beam(top_sc, tokens, lengths, pred, state)

            # blank-settle the advanced set, merge it into the settled pool
            logp = w.joint_logp(fj, pred)
            blanked = top_sc + logp[..., 0]
            if merge_duplicates:
                s_sc, blanked, n = merge_into_settled(settled, blanked,
                                                      tokens, lengths)
                settled = settled._replace(scores=s_sc)
                merges = merges + n
            pool = _concat(settled, expanding._replace(scores=blanked))
            _, top = choose(pool.scores, lambda i: i, lambda i: i)
            settled = _gather(pool, top)
        # frames at or past an utterance's length keep its beam
        def keep(new, old):
            return torch.where(alive.reshape((B,) + (1,) * (new.dim() - 1)),
                               new, old)
        beam = Beam(keep(settled.scores, beam.scores),
                    keep(settled.tokens, beam.tokens),
                    keep(settled.lengths, beam.lengths),
                    keep(settled.pred_out, beam.pred_out),
                    [(keep(cn, co), keep(hn, ho)) for (cn, hn), (co, ho)
                     in zip(settled.state, beam.state)])
    if stats is not None:
        if trace["idx"]:
            stats.update({k: torch.stack(v) for k, v in trace.items()})
        else:
            stats.update(idx=torch.zeros((0, B, K), dtype=torch.int32),
                         val=torch.zeros((0, B, K)), gap=torch.zeros((0, B)))
            if follow is not None:
                stats.update(own=torch.zeros((0, B, K), dtype=torch.int32),
                             slack=torch.zeros((0, B)))
        stats["min_gap"] = float(stats["gap"].min()) \
            if stats["gap"].numel() else float("inf")
        stats["merges"] = int(merges)
    return (beam.tokens[:, 0, :].to(torch.int32),
            beam.lengths[:, 0].to(torch.int32), beam.scores)


def default_expansions(cfg) -> int:
    """Label expansions per frame by default: min(max_symbols_per_frame, 6),
    which must cover the model's emission burstiness."""
    return min(cfg.max_symbols_per_frame, 6)


def beam_search_decode(model: Transducer, mel: torch.Tensor,
                       spec_lengths: Optional[torch.Tensor] = None, *,
                       beam_width: int = 4, max_output_length: int = 200,
                       expansions_per_frame: Optional[int] = None,
                       merge_duplicates: Optional[bool] = None):
    """Featurized audio [B, T, feat] -> (best tokens [B, L], best lengths
    [B], beam scores [B, K]), by the search the weights' kind selects
    (`search_by_kind`).  expansions_per_frame defaults to
    `default_expansions(cfg)`, merge_duplicates to True, as in the JAX
    package."""
    require_lstm_encoder(model.cfg, "beam search")
    B, T, _ = mel.shape
    if spec_lengths is None:
        spec_lengths = torch.full((B,), T, dtype=torch.int32)
    encoded, _ = model.encode(mel)
    enc_lengths = model.encoded_length(spec_lengths.to(mel.device))
    if expansions_per_frame is None:
        expansions_per_frame = default_expansions(model.cfg)
    if merge_duplicates is None:
        merge_duplicates = True
    return search_by_kind(model)(
        model, encoded, enc_lengths, beam_width=beam_width,
        max_output_length=max_output_length,
        expansions_per_frame=expansions_per_frame,
        merge_duplicates=merge_duplicates)


def search_by_kind(model: Transducer):
    """The beam search for the model's weights, chosen as the JAX service
    chooses its beam: kernel K3's wrapper (`ops.beam_cuda.beam_search`) for
    fp weights, `beam_search_encoded_xla` for int8 ones."""
    if model.int8_names():
        return beam_search_encoded_xla
    from rnnt_tpu_torch.ops.beam_cuda import beam_search

    return beam_search
