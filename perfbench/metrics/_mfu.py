"""Shared by the whole-unit readers of the card's peak: the least time the
card could take for the units of the untraced window (their table bytes
over the memory bandwidth; a table apply reads 4 or 8 bytes per two
operations, so no arithmetic peak is nearer) over the wall time of that
window (percent).  It bounds every kernel's roofline of the unit: a kernel
taken off the path leaves its own roofline silent, not this share."""

from perfbench.peaks import peak


def mfu(ctx):
    mod, spec, op = ctx["config"], ctx["spec"], ctx["traffic"]["op"]
    bw = peak(ctx["device"], "hbm_bytes_per_s")
    units = ctx["window_units"]
    if bw is None or not units:
        return None
    sz = mod.sizes(spec)
    need = [mod.table_bytes(spec, op, u, sz) for u in units]
    if any(b is None for b in need):
        return None
    return 100.0 * sum(need) / bw / ctx["window_s"]
