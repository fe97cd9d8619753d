"""``host_reads_per_it.solve`` (program counter, Krylov layer): the
program's host reads (``*.read`` spans, the Lanczos scaling's two per step
included) per BPCG iteration of the traced solve (see ``_program.py``)."""

from perfbench.metrics._program import per_iteration


def read(ctx):
    return per_iteration(ctx, lambda s: s["reads"], "bpcg")
