"""``launches_per_it`` (device trace, driver / host dispatch layer): host
launch calls per solver iteration of the traced solves."""

from perfbench.metrics._launches import launches


def read(ctx):
    n = launches(ctx)
    its = sum(u.get("its", 0) for u in ctx["traced_units"])
    return None if n is None or its == 0 else n / its
