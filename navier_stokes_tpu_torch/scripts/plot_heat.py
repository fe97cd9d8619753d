"""Heat convergence plot, headless.

Counterpart of ``scripts/plot_heat.py``: the L2 error of the heat study
(``heat_errors.csv``, written by ``scripts/run_heat.py``) against the time
step on log-log axes, with dt^3 and dt^4 reference slopes through the
first point, into ``heat_errors.png`` beside the CSV.  The columns come
from ``utils.csvfile.read_csv`` (no pandas); matplotlib draws with its
Agg backend.

Run: python -m navier_stokes_tpu_torch.scripts.plot_heat [heat_errors.csv]
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.csvfile import read_csv
from .plot_stokes import pyplot


def heat_slopes(rows: list[dict]):
    """(time steps, errors, the dt^3 slope, the dt^4 slope), each through
    the first row's error, as numpy arrays."""
    ts = np.asarray([r["time_step"] for r in rows], np.float64)
    err = np.asarray([r["error"] for r in rows], np.float64)
    e0, t0 = float(err[0]), float(ts[0])
    return ts, err, ts**3 * e0 / t0**3, ts**4 * e0 / t0**4


def plot_convergence(rows, ax):
    ts, err, ref3, ref4 = heat_slopes(rows)
    ax.loglog(ts, err, "o-", label="error")
    ax.loglog(ts, ref3, "--", label=r"$\Delta t^3$")
    ax.loglog(ts, ref4, ":", label=r"$\Delta t^4$")
    ax.set_xlabel("time step")
    ax.set_ylabel("L2 error")
    ax.legend()


def main(csv: str = "heat_errors.csv") -> str:
    """Draw the convergence plot of ``csv``; returns the PNG's path."""
    plt = pyplot("plot_heat")
    fig, ax = plt.subplots()
    plot_convergence(read_csv(csv), ax)
    out = csv.replace(".csv", ".png")
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main(*sys.argv[1:2])
