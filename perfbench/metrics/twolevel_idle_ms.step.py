"""``twolevel_idle_ms.step`` (program span, preconditioner layer): device
idle milliseconds per traced step whose innermost program span is
``twolevel``, the projection CG's preconditioner (element blocks and the P1
coarse solve; see ``_program.py``)."""

from perfbench.metrics._program import program_spans


def read(ctx):
    s = program_spans(ctx)
    if s is None or "idle_ms" not in s or "twolevel" not in s["spans"]:
        return None
    return s["spans"]["twolevel"]["idle_ms"]
