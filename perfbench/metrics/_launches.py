"""Shared by the launch readers: host calls that put work on the device
(kernel and graph launches, asynchronous copies and sets) in the traced
units, from the profiler's host events."""


def launches(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["traced_units"]:
        return None
    n = tr.launch_count()
    return n if n > 0 else None
