"""``solve_its`` (program counter, Krylov layer): iterations per solve over
the window, as the solver counts them (BPCG for the HDG model)."""


def read(ctx):
    units = [u for u in ctx["units"] if "its" in u]
    if not units:
        return None
    return sum(u["its"] for u in units) / len(units)
