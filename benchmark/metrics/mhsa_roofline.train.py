"""The Conformer's attention modules (q, k, v, output and position
projections, q.k^T, the position term, the softmax, A.V): the least time
of a step's calls from their shapes (`benchlib.conformer_flops`) over
the device time a step of the records launched in `rnnt.conformer.mhsa`
and `rnnt.conformer.mhsa.bwd`, in percent."""

from benchlib.conformer_spans import roofline


def read(run):
    return roofline(run, "mhsa")
