"""``host_reads_per_it.step`` (program counter, Krylov layer): the
program's host reads (``*.read`` spans) per CG iteration of the traced
steps: one per iteration and one before each CG (see ``_program.py``)."""

from perfbench.metrics._program import per_iteration


def read(ctx):
    return per_iteration(ctx, lambda s: s["reads"], "cg")
