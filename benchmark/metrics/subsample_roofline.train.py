"""The Conformer's subsampling (two stride-2 Conv2d with ReLU, the Dense
after them): the least time of a step's calls from their shapes
(`benchlib.conformer_flops`) over the device time a step of the records
launched in `rnnt.conformer.subsample` and
`rnnt.conformer.subsample.bwd`, in percent."""

from benchlib.conformer_spans import roofline


def read(run):
    return roofline(run, "subsample")
