"""RNN-T loss dispatcher, the port of `rnnt_tpu.ops.rnnt_loss`: raw logits
in, per-example NLL out, blank 0.  "pallas" runs the lattice in kernel K7
(`ops.lattice_cuda`); "ref" and "auto" run the plain scans, as the JAX
package's "auto" routes to its XLA scans."""

from __future__ import annotations


def rnnt_loss(logits, labels, logit_lengths, label_lengths, *,
              impl: str = "auto"):
    """logits [B, T, U+1, V]; labels [B, U]; logit_lengths [B] (after time
    reduction); label_lengths [B]; impl "auto" | "ref" | "pallas"."""
    if impl == "pallas":
        from rnnt_tpu_torch.ops.lattice_cuda import rnnt_loss_pallas

        return rnnt_loss_pallas(logits, labels, logit_lengths, label_lengths)
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl={impl!r} (want 'auto', 'ref' or 'pallas')")
    from rnnt_tpu_torch.ops.rnnt_loss_ref import rnnt_loss_ref

    return rnnt_loss_ref(logits, labels, logit_lengths, label_lengths)
