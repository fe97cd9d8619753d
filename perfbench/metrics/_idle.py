"""Shared by the idle share readers: 1 - the union of the device's
operation intervals over the traced window (percent)."""


def idle_share(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or not tr.device_ops:
        return None  # no device operation: nothing to read
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
