"""``cheb_idle_ms.step`` (program span, preconditioner layer): device idle
milliseconds per traced step whose innermost program span is
``chebyshev``, the projection's 16-term Chebyshev mass inverse (see
``_program.py``)."""

from perfbench.metrics._program import program_spans


def read(ctx):
    s = program_spans(ctx)
    if s is None or "idle_ms" not in s or "chebyshev" not in s["spans"]:
        return None
    return s["spans"]["chebyshev"]["idle_ms"]
