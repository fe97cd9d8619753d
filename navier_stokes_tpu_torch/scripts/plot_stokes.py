"""Plots of the Stokes benchmark CSV, headless.

Counterpart of ``scripts/plot_stokes.py``: reads the ``errors.csv`` that
``scripts/run_stokes.py`` writes (``models.stokes.run``'s schema) and
draws bars of the iterations and of the solver time per (discretization,
solver) and log-y curves of the error over the iterations, into
``errors.png`` beside the CSV.  The JAX script's pandas groupbys are the
plain functions :func:`iterations_table`, :func:`run_time_table` and
:func:`error_series` over the rows of ``utils.csvfile.read_csv`` (no
pandas); matplotlib draws with its Agg backend.

Run: python -m navier_stokes_tpu_torch.scripts.plot_stokes [errors.csv]
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.csvfile import read_csv

KEYS = ("discretization", "solver")


def pyplot(script: str):
    """``matplotlib.pyplot`` on the Agg backend; an ``ImportError`` that
    names ``script`` where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{script} draws with matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def groups(rows: list[dict], keys) -> dict:
    """key tuple -> the rows with that key, in the rows' order, the keys
    sorted (``DataFrame.groupby``)."""
    out: dict = {}
    for r in rows:
        out.setdefault(tuple(r[k] for k in keys), []).append(r)
    return dict(sorted(out.items()))


def iterations_table(rows: list[dict]) -> dict:
    """(discretization, solver) -> the largest ``iteration``."""
    return {k: max(r["iteration"] for r in g)
            for k, g in groups(rows, KEYS).items()}


def run_time_table(rows: list[dict]) -> dict:
    """(discretization, solver) -> the first ``solver_time``."""
    return {k: g[0]["solver_time"] for k, g in groups(rows, KEYS).items()}


def error_series(rows: list[dict]) -> dict:
    """(discretization, solver) -> (iterations, errors) in the rows'
    order."""
    return {k: ([r["iteration"] for r in g], [r["error"] for r in g])
            for k, g in groups(rows, KEYS).items()}


def bars(table: dict, ax, ylabel: str) -> None:
    """A bar per (discretization, solver) of ``table``, grouped by
    discretization, one series per solver (``unstack('solver')`` then
    ``plot.bar``: a missing pair is a bar of height 0, as pandas draws its
    NaN)."""
    discs = sorted({d for d, _ in table})
    solvers = sorted({s for _, s in table})
    width = 0.5 / len(solvers)
    x = np.arange(len(discs))
    for i, s in enumerate(solvers):
        ax.bar(x + (i - (len(solvers) - 1) / 2) * width,
               [table.get((d, s), 0.0) for d in discs], width, label=s)
    ax.set_xticks(x, discs, rotation=90)
    ax.set_xlabel("discretization")
    ax.legend(title="solver")
    ax.set_ylabel(ylabel)


def plot_iterations(rows, ax):
    bars(iterations_table(rows), ax, "iterations")


def plot_run_time(rows, ax):
    bars(run_time_table(rows), ax, "solver time [s]")


def plot_error_over_iterations(rows, ax):
    for (disc, solver), (its, errs) in error_series(rows).items():
        ax.semilogy(its, errs, label=f"{disc} / {solver}")
    ax.set_xlabel("iteration")
    ax.set_ylabel("relative error")
    ax.legend(fontsize=6)


def main(csv: str = "errors.csv") -> str:
    """Draw the three plots of ``csv``; returns the PNG's path."""
    plt = pyplot("plot_stokes")
    rows = read_csv(csv)
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    plot_iterations(rows, axes[0])
    plot_run_time(rows, axes[1])
    plot_error_over_iterations(rows, axes[2])
    fig.tight_layout()
    out = csv.replace(".csv", ".png")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:2])
