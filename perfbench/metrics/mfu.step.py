"""``mfu.step`` (host clock, whole unit): the whole f32 step's share of
the card's peak over the untraced window (see ``_mfu.py``)."""

from perfbench.metrics._mfu import mfu


def read(ctx):
    return mfu(ctx)
