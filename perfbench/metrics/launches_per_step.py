"""``launches_per_step`` (device trace, driver / host dispatch layer):
host launch calls per traced step."""

from perfbench.metrics._launches import launches


def read(ctx):
    n = launches(ctx)
    return None if n is None else n / len(ctx["traced_units"])
