"""The plot scripts of the port (``navier_stokes_tpu_torch/scripts/
plot_stokes.py``, ``plot_heat.py``, ``plot_ns_sweep.py``) against the JAX
package's ``scripts/plot_*.py``.

The port reads a CSV with the ``csv`` module (``utils.csvfile.read_csv``)
and reduces it with plain functions; the JAX scripts read it with pandas
and reduce it with groupbys.  pandas' default float parser may round a
decimal one unit in the last place away from the nearest double (the
repo's ``data.csv`` has such cells), so the JAX side here reads with
``float_precision="round_trip"``, which parses as Python does; on those
values the reductions that pick values must be EQUAL (``==``): the maxima,
the first solver times, the error series, the heat slopes; the four
NS-sweep means per ``gauss_seidel_enabled`` agree within a relative 1e-12
(pandas sums a group mean by a compensated sum, the port by a plain
one).  The inputs: the repo's ``data.csv``
(72 rows of the JAX package's sweep), and an ``errors.csv`` and a
``heat_errors.csv`` written by the port's own ``utils.csvfile.write_csv``
from a fixed set of rows in the JAX harness's schema.

The csv-only reductions run unconditionally.  Where pandas and matplotlib
import, the JAX plot functions and the port's draw on Agg axes of their
own and must give bars and lines with equal data, and each port script's
``main`` writes its PNG.  Without matplotlib, ``main`` raises an
ImportError naming it.
"""

import os
import runpy

import numpy as np
import pytest

from navier_stokes_tpu_torch.models.stokes import CSV_COLUMNS
from navier_stokes_tpu_torch.scripts import plot_heat, plot_ns_sweep
from navier_stokes_tpu_torch.scripts import plot_stokes
from navier_stokes_tpu_torch.utils.csvfile import read_csv, write_csv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data.csv")
JAX_SCRIPTS = os.path.join(ROOT, "scripts")


def _errors_rows():
    """Rows in models.stokes.run's schema: three discretizations, two
    solvers, one pair missing, error histories of different lengths."""
    rng = np.random.default_rng(7)
    rows = []
    for disc, solvers in (("TH 2", ("bpcg", "minres")),
                          ("HDG BDM 2", ("bpcg",)),
                          ("MCS 2", ("minres", "bpcg"))):
        for solver in solvers:
            n = int(rng.integers(3, 9))
            errs = np.sort(rng.uniform(1e-9, 1.0, n))[::-1]
            t = float(rng.uniform(0.1, 3.0))
            for it, e in enumerate(errs):
                rows.append(dict(mesh_size=0.1, discretization=disc,
                                 order=2, solver=solver, iteration=it,
                                 error=float(e), solver_time=t,
                                 nvertices=230, nedges=640, nfaces=410,
                                 nfacets=640, nelements=410, ndofs=5112,
                                 method="mixed"))
    return rows


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("plots")
    errors = str(d / "errors.csv")
    write_csv(_errors_rows(), CSV_COLUMNS, errors)
    heat = str(d / "heat_errors.csv")
    ts = np.logspace(-1, -3, 5)
    write_csv([{"time_step": float(t), "error": float(3.1 * t**3.2)}
               for t in ts], ("time_step", "error"), heat)
    return dict(errors=errors, heat=heat)


def _frame(path):
    pd = pytest.importorskip("pandas")
    return pd.read_csv(path, float_precision="round_trip")


def test_read_csv_types_cells_as_pandas(csvs):
    rows = read_csv(DATA)
    assert len(rows) == 72
    assert rows[0] == {"mesh_size": 1.0, "order": 2, "iterations": 208,
                       "time": 15.018691242992645,
                       "gauss_seidel_enabled": True}
    back = read_csv(csvs["errors"])
    assert back == _errors_rows()


def test_stokes_reductions_by_hand(csvs):
    """The tables against a direct loop over the fixed rows."""
    rows = read_csv(csvs["errors"])
    want_max, want_first = {}, {}
    for r in _errors_rows():
        k = (r["discretization"], r["solver"])
        want_max[k] = max(want_max.get(k, -1), r["iteration"])
        want_first.setdefault(k, r["solver_time"])
    assert plot_stokes.iterations_table(rows) == dict(sorted(
        want_max.items()))
    assert plot_stokes.run_time_table(rows) == dict(sorted(
        want_first.items()))
    series = plot_stokes.error_series(rows)
    assert list(series) == sorted(want_max)
    for (disc, solver), (its, errs) in series.items():
        assert its == list(range(want_max[disc, solver] + 1))
        assert errs == [r["error"] for r in rows
                        if (r["discretization"], r["solver"])
                        == (disc, solver)]


def test_heat_and_sweep_reductions_by_hand(csvs):
    ts, err, r3, r4 = plot_heat.heat_slopes(read_csv(csvs["heat"]))
    assert r3[0] == err[0] and r4[0] == err[0]
    assert np.allclose(r3 / err[0], (ts / ts[0]) ** 3, rtol=1e-14)
    rows = read_csv(DATA)
    m = plot_ns_sweep.means(rows, "order", "iterations")
    assert sorted(m) == [False, True]
    for gs, (orders, avg) in m.items():
        assert orders == sorted({r["order"] for r in rows})
        for o, a in zip(orders, avg):
            its = [r["iterations"] for r in rows
                   if r["order"] == o and r["gauss_seidel_enabled"] == gs]
            assert a == sum(its) / len(its)


def test_stokes_reductions_equal_pandas(csvs):
    data = _frame(csvs["errors"])
    rows = read_csv(csvs["errors"])
    g = data.groupby(["discretization", "solver"])
    assert plot_stokes.iterations_table(rows) == g["iteration"].max(
        ).to_dict()
    assert plot_stokes.run_time_table(rows) == g["solver_time"].first(
        ).to_dict()
    mine = plot_stokes.error_series(rows)
    assert list(mine) == [k for k, _ in g]
    for k, grp in g:
        assert mine[k] == (list(grp["iteration"]), list(grp["error"]))


def test_heat_slopes_equal_pandas(csvs):
    errors = _frame(csvs["heat"])
    ts = errors["time_step"]
    e0, t0 = float(errors["error"].iloc[0]), float(ts.iloc[0])
    mine = plot_heat.heat_slopes(read_csv(csvs["heat"]))
    for a, b in zip(mine, (ts, errors["error"], ts**3 * e0 / t0**3,
                           ts**4 * e0 / t0**4)):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("by,value", [("mesh_size", "iterations"),
                                      ("mesh_size", "time"),
                                      ("order", "iterations"),
                                      ("order", "time")])
def test_ns_sweep_means_equal_pandas(by, value):
    data = _frame(DATA)
    mine = plot_ns_sweep.means(read_csv(DATA), by, value)
    want = {gs: grp.groupby(by)[value].mean()
            for gs, grp in data.groupby("gauss_seidel_enabled")}
    assert list(mine) == list(want)
    for gs, g in want.items():
        assert mine[gs][0] == list(g.index)
        np.testing.assert_allclose(mine[gs][1], g.values, rtol=1e-12, atol=0)


def _pyplot():
    pytest.importorskip("pandas")
    pytest.importorskip("matplotlib")
    return plot_stokes.pyplot("test")


def _artists(ax):
    lines = [(list(ln.get_xdata()), list(ln.get_ydata()), ln.get_label())
             for ln in ax.get_lines()]
    bars = [p.get_height() for p in ax.patches]
    return lines, bars, ax.get_xlabel(), ax.get_ylabel(), \
        ax.get_xscale(), ax.get_yscale()


def _same(a, b, rtol=0.0):
    """Equal artists; the lines' y data within ``rtol`` where given."""
    la, ba, *ra = a
    lb, bb, *rb = b
    assert ra == rb
    assert np.array_equal(np.asarray(ba, float), np.asarray(bb, float),
                          equal_nan=True)
    assert len(la) == len(lb)
    for (xa, ya, na), (xb, yb, nb) in zip(la, lb):
        assert na == nb and np.array_equal(xa, xb)
        if rtol:
            np.testing.assert_allclose(ya, yb, rtol=rtol, atol=0)
        else:
            assert np.array_equal(ya, yb)


def test_stokes_plots_equal_jax(csvs):
    plt = _pyplot()
    jax = runpy.run_path(os.path.join(JAX_SCRIPTS, "plot_stokes.py"))
    data, rows = _frame(csvs["errors"]), read_csv(csvs["errors"])
    for name in ("plot_iterations", "plot_run_time",
                 "plot_error_over_iterations"):
        fig, (a, b) = plt.subplots(1, 2)
        jax[name](data, a)
        getattr(plot_stokes, name)(rows, b)
        _same(_artists(a), _artists(b))
        plt.close(fig)


def test_ns_sweep_plots_equal_jax():
    plt = _pyplot()
    jax = runpy.run_path(os.path.join(JAX_SCRIPTS, "plot_ns_sweep.py"))
    data, rows = _frame(DATA), read_csv(DATA)
    for name in ("plot_iterations_vs_h", "plot_time_vs_h",
                 "plot_iterations_vs_order", "plot_time_vs_order"):
        fig, (a, b) = plt.subplots(1, 2)
        jax[name](data, a)
        getattr(plot_ns_sweep, name)(rows, b)
        _same(_artists(a), _artists(b), rtol=1e-12)
        plt.close(fig)


def test_heat_plot_equal_jax(csvs, monkeypatch):
    """The JAX script draws in its ``__main__`` block: run it on a copy of
    the CSV, its ``pd.read_csv`` parsing round-trip, and take its figure
    from pyplot."""
    plt = _pyplot()
    import functools
    import shutil

    import pandas as pd

    jax_csv = csvs["heat"].replace(".csv", "_jax.csv")
    shutil.copy(csvs["heat"], jax_csv)
    monkeypatch.setattr(pd, "read_csv", functools.partial(
        pd.read_csv, float_precision="round_trip"))
    monkeypatch.setattr("sys.argv", ["plot_heat.py", jax_csv])
    plt.close("all")
    runpy.run_path(os.path.join(JAX_SCRIPTS, "plot_heat.py"),
                   run_name="__main__")
    a = plt.gcf().axes[0]
    fig, b = plt.subplots()
    plot_heat.plot_convergence(read_csv(csvs["heat"]), b)
    _same(_artists(a), _artists(b))
    plt.close("all")


@pytest.mark.parametrize("script,csv", [(plot_stokes, "errors"),
                                        (plot_heat, "heat"),
                                        (plot_ns_sweep, "data")])
def test_main_writes_png(csvs, tmp_path, script, csv):
    pytest.importorskip("matplotlib")
    path = DATA if csv == "data" else csvs[csv]
    local = str(tmp_path / os.path.basename(path))
    with open(path) as src, open(local, "w") as dst:
        dst.write(src.read())
    out = script.main(local)
    assert out == local.replace(".csv", ".png")
    with open(out, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_main_without_matplotlib_raises(csvs, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    for script, path in ((plot_stokes, csvs["errors"]),
                         (plot_heat, csvs["heat"]),
                         (plot_ns_sweep, DATA)):
        with pytest.raises(ImportError, match="matplotlib"):
            script.main(path)
