"""Plots of the parameter sweep's CSV, headless.

Counterpart of ``scripts/plot_ns_sweep.py``: the mean BPCG iterations and
solve time of ``data.csv`` (``scripts/run_ns_sweep.py``'s schema) against
the mesh size (log x) and against the order, one curve per
``gauss_seidel_enabled``, into ``data.png`` beside the CSV.  The JAX
script's pandas groupby means are :func:`means` over the rows of
``utils.csvfile.read_csv`` (no pandas); matplotlib draws with its Agg
backend.

Run: python -m navier_stokes_tpu_torch.scripts.plot_ns_sweep [data.csv]
"""

from __future__ import annotations

import sys

from ..utils.csvfile import read_csv
from .plot_stokes import groups, pyplot


def means(rows: list[dict], by: str, value: str) -> dict:
    """gauss_seidel_enabled -> (the sorted values of ``by``, the mean of
    ``value`` at each), both lists."""
    out = {}
    for (gs,), grp in groups(rows, ("gauss_seidel_enabled",)).items():
        g = groups(grp, (by,))
        out[gs] = ([k[0] for k in g],
                   [sum(r[value] for r in v) / len(v)
                    for v in g.values()])
    return out


def _curves(rows, ax, by, value, draw, xlabel, ylabel):
    for gs, (x, y) in means(rows, by, value).items():
        getattr(ax, draw)(x, y, "o-", label=f"GS={gs}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend()


def plot_iterations_vs_h(rows, ax):
    _curves(rows, ax, "mesh_size", "iterations", "semilogx", "mesh size",
            "BPCG iterations")


def plot_time_vs_h(rows, ax):
    _curves(rows, ax, "mesh_size", "time", "loglog", "mesh size",
            "solve time [s]")


def plot_iterations_vs_order(rows, ax):
    _curves(rows, ax, "order", "iterations", "plot", "order",
            "BPCG iterations")


def plot_time_vs_order(rows, ax):
    _curves(rows, ax, "order", "time", "semilogy", "order",
            "solve time [s]")


def main(csv: str = "data.csv") -> str:
    """Draw the four plots of ``csv``; returns the PNG's path."""
    plt = pyplot("plot_ns_sweep")
    rows = read_csv(csv)
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    plot_iterations_vs_h(rows, axes[0, 0])
    plot_time_vs_h(rows, axes[0, 1])
    plot_iterations_vs_order(rows, axes[1, 0])
    plot_time_vs_order(rows, axes[1, 1])
    fig.tight_layout()
    out = csv.replace(".csv", ".png")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:2])
