"""Shared by the table roofline readers: the bytes the traced units' table
applies need (the configuration's ``table_bytes`` from its sizes and the
iteration counts each unit reported) over the card's memory bandwidth, as a
share of the device's busy time in the traced window."""

from perfbench.peaks import peak


def table_roofline(ctx):
    tr, mod = ctx["trace"], ctx["config"]
    bw = peak(ctx["device"], "hbm_bytes_per_s")
    if tr is None or bw is None or not hasattr(mod, "table_bytes"):
        return None
    spec, op = ctx["spec"], ctx["traffic"]["op"]
    sz = mod.sizes(spec)
    need = [mod.table_bytes(spec, op, u, sz) for u in ctx["traced_units"]]
    busy = tr.busy_s()
    if not need or any(b is None for b in need) or busy <= 0:
        return None
    return 100.0 * sum(need) / bw / busy
