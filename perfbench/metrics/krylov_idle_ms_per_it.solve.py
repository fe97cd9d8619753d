"""``krylov_idle_ms_per_it.solve`` (program span, Krylov layer): device idle
milliseconds whose innermost program span is a solver's own (``bpcg``,
``lanczos`` or their ``.read`` spans: the recurrences and the host reads),
per BPCG iteration of the traced solve (see ``_program.py``)."""

from perfbench.metrics._program import per_iteration


def read(ctx):
    return per_iteration(ctx, _krylov_self_ms, "bpcg")


def _krylov_self_ms(s):
    return s["_ns"]["krylov_self_idle"] * 1e-6 if "idle_ms" in s else None
