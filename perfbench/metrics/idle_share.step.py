"""``idle_share.step`` (device trace, device layer): the share of the
traced steps' window in which no operation ran on the device (percent)."""

from perfbench.metrics._idle import idle_share


def read(ctx):
    return idle_share(ctx)
