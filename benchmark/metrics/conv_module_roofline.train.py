"""The Conformer's convolution modules (pointwise, GLU, depthwise
convolution, BatchNorm, Swish, pointwise): the least time of a step's
calls from their shapes (`benchlib.conformer_flops`) over the device
time a step of the records launched in `rnnt.conformer.conv` and
`rnnt.conformer.conv.bwd`, in percent."""

from benchlib.conformer_spans import roofline


def read(run):
    return roofline(run, "conv")
