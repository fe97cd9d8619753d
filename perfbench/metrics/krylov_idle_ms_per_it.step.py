"""``krylov_idle_ms_per_it.step`` (program span, Krylov layer): device idle
milliseconds whose innermost program span is a CG's own (``cg`` or
``cg.read``: its recurrence and its host read), per CG iteration of the
traced steps, M* and projection together (see ``_program.py``)."""

from perfbench.metrics._program import per_iteration


def read(ctx):
    return per_iteration(ctx, _krylov_self_ms, "cg")


def _krylov_self_ms(s):
    return s["_ns"]["krylov_self_idle"] * 1e-6 if "idle_ms" in s else None
