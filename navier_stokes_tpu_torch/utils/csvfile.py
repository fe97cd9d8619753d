"""CSV files in pandas' ``DataFrame.to_csv`` layout, without pandas.

The JAX package's harnesses (models/stokes.run, models/heat.
heat_convergence_study) write their tables with pandas; the port writes
the same bytes with the standard ``csv`` module: an unnamed index column
0..n-1, then the named columns, floats by their shortest repr, minimal
quoting and ``\\n`` line ends.  :func:`read_csv` reads such a file back
as ``pandas.read_csv`` types its cells (int, float, bool, else str).
"""

from __future__ import annotations

import csv

import numpy as np

__all__ = ["read_csv", "write_csv"]


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


def _parse(cell: str):
    if cell in ("True", "False"):
        return cell == "True"
    for kind in (int, float):
        try:
            return kind(cell)
        except ValueError:
            pass
    return cell


def read_csv(path: str) -> list[dict]:
    """The rows of ``path`` as dicts of the named columns (the unnamed
    index column left out), each cell an int, float or bool where it
    parses as one, else the string."""
    with open(path, newline="") as fh:
        r = csv.reader(fh)
        names = next(r)
        return [{k: _parse(v) for k, v in zip(names, row) if k}
                for row in r]
