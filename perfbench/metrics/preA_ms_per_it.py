"""``preA_ms_per_it`` (program span, preconditioner layer): device
milliseconds of the operations launched inside the program's ``bpcg.preA``
spans (the scaled A-preconditioner apply of BPCG), per BPCG iteration of
the traced solve; the Lanczos scaling's applies, under ``lanczos.pre``, are
not counted (see ``_program.py``)."""

from perfbench.metrics._program import per_iteration


def read(ctx):
    return per_iteration(ctx, _preA_ms, "bpcg")


def _preA_ms(s):
    if "idle_ms" not in s or "bpcg.preA" not in s["spans"]:
        return None
    return s["_ns"]["device"].get("bpcg.preA", 0) * 1e-6 or None
