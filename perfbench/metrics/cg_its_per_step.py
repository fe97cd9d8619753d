"""``cg_its_per_step`` (program counter, Krylov layer): M* plus projection
CG iterations per step over the window, from the model's
``last_iterations``."""


def read(ctx):
    units = [u for u in ctx["units"] if "mstar" in u and "project" in u]
    if not units:
        return None
    return sum(u["mstar"] + u["project"] for u in units) / len(units)
