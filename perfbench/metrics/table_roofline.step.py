"""``table_roofline.step`` (device trace, kernels layer): the bytes the
traced steps' table applies need, over the card's memory bandwidth, as a
share of the device's busy time (percent)."""

from perfbench.metrics._roofline import table_roofline


def read(ctx):
    return table_roofline(ctx)
