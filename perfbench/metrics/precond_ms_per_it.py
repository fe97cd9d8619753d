"""``precond_ms_per_it`` (device trace, preconditioner layer): device
milliseconds of the operations launched inside the harness's span around
the model's A-preconditioner apply (``pb:preA``), per iteration of the
traced solves.  The applies of the solve's Lanczos scaling (40 per solve)
are inside the span too."""


def read(ctx):
    tr = ctx["trace"]
    its = sum(u.get("its", 0) for u in ctx["traced_units"])
    if tr is None or its == 0 or "pb:preA" not in tr.spans:
        return None
    s = tr.device_s_under("pb:preA")
    return s * 1e3 / its if s > 0 else None
