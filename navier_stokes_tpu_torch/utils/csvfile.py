"""CSV output in pandas' ``DataFrame.to_csv`` layout, without pandas.

The JAX package's harnesses (models/stokes.run, models/heat.
heat_convergence_study) write their tables with pandas; the port writes
the same bytes with the standard ``csv`` module: an unnamed index column
0..n-1, then the named columns, floats by their shortest repr, minimal
quoting and ``\\n`` line ends.
"""

from __future__ import annotations

import csv

import numpy as np

__all__ = ["write_csv"]


def _cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def write_csv(rows: list[dict], columns, path: str) -> None:
    """Write ``rows`` (dicts holding every name of ``columns``) to ``path``."""
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow([""] + list(columns))
        for i, row in enumerate(rows):
            w.writerow([str(i)] + [_cell(row[c]) for c in columns])
