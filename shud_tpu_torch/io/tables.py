# Copied verbatim from shud_tpu/io/tables.py; only the package imports differ.
"""Whitespace table readers for the SHUD input formats.

Format (reference ``src/classes/TabularData.cpp:21-55``): the first line is
``nrow ncol [extra...]``, the second is a column-name header, followed by
``nrow`` whitespace-separated numeric rows.  Several files stack multiple
tables in one file (``.sp.mesh``, ``.sp.riv``, ``.cfg.ic``, ``.lake.bathy``),
so the reader operates on a line cursor.
"""

from __future__ import annotations

import numpy as np


class LineCursor:
    def __init__(self, lines: list[str]):
        self.lines = lines
        self.pos = 0

    def next_line(self) -> str:
        line = self.lines[self.pos]
        self.pos += 1
        return line

    def eof(self) -> bool:
        return self.pos >= len(self.lines)


def _parse_row(line: str, ncol: int) -> list[float]:
    # strtold semantics: parse up to ncol leading numbers; missing -> 0.0
    parts = line.split()
    out = []
    for j in range(ncol):
        if j < len(parts):
            try:
                out.append(float(parts[j]))
            except ValueError:
                out.append(0.0)
        else:
            out.append(0.0)
    return out


def read_table_at(cur: LineCursor) -> tuple[np.ndarray, str, list[str]]:
    """Read one ``nrow ncol`` table at the cursor.

    Returns (data[nrow, ncol] float64, header line, extra header tokens).
    """
    dim_line = cur.next_line()
    parts = dim_line.split()
    nrow, ncol = int(parts[0]), int(parts[1])
    extra = parts[2:]
    header = cur.next_line()
    rows = np.empty((nrow, ncol), dtype=np.float64)
    for i in range(nrow):
        rows[i] = _parse_row(cur.next_line(), ncol)
    return rows, header, extra


def read_tables(path: str, n: int | None = None):
    """Read ``n`` stacked tables (all if None) from *path*."""
    with open(path) as f:
        lines = f.read().splitlines()
    cur = LineCursor(lines)
    out = []
    while not cur.eof() and (n is None or len(out) < n):
        # skip blank trailing lines
        if cur.lines[cur.pos].strip() == "":
            cur.pos += 1
            continue
        out.append(read_table_at(cur))
    return out


def read_table(path: str) -> np.ndarray:
    return read_tables(path, 1)[0][0]
