"""Metadata tables read with the standard library, row for row as the JAX
adapters' `pd.read_csv(path, sep=..., header=None, names=...)` reads them
(the port does not use pandas).

The rules pandas applies and this reader reproduces:
  * `"` quotes a field, which may then hold the separator or line breaks,
    and `""` inside quotes is one `"` (so a caption that opens a quote runs
    on to the closing one, across lines);
  * empty and whitespace-only lines are skipped;
  * a row with fewer fields than the table's width (`len(names)`, else the
    first row's field count) is filled with NaN; a row with more raises;
  * a field in the NA spellings below (exactly, unstripped) is NaN;
  * each column's type is inferred over all its fields: all integers ->
    int (float where the column also has NaN), all numbers -> float, all
    True/False spellings -> bool, otherwise the fields stay strings.
"""
from __future__ import annotations

import csv
import math
import re
from typing import List, Optional, Sequence

import numpy as np

NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
          "false": False}
_INT = re.compile(r"[+-]?[0-9]+")
_FLOAT = re.compile(r"[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?|[+-]?(inf|infinity)",
                    re.IGNORECASE)
_NAN = float("nan")


def _column(fields: List[Optional[str]]) -> list:
    """One column's values, typed as pandas infers them (None = NaN)."""
    present = [f for f in fields if f is not None]
    if not present:
        return [_NAN] * len(fields)
    stripped = [f.strip() for f in present]
    has_na = len(present) < len(fields)
    if all(_INT.fullmatch(f) for f in stripped):
        cast = (lambda f: float(int(f))) if has_na else (lambda f: int(f.strip()))
        return [_NAN if f is None else cast(f.strip()) for f in fields]
    if all(_INT.fullmatch(f) or _FLOAT.fullmatch(f) for f in stripped):
        return [_NAN if f is None else float(f.strip()) for f in fields]
    if all(f in _BOOLS for f in present):
        return [_NAN if f is None else _BOOLS[f] for f in fields]
    return [_NAN if f is None else f for f in fields]


def read_table(path, sep: str = "\t", names: Optional[Sequence[str]] = None) -> List[list]:
    """The rows of a headerless delimited file, each a list of typed
    values (`len(names)` of them where names are given)."""
    with open(path, newline="", encoding="utf-8") as fh:
        raw = [row for row in csv.reader(fh, delimiter=sep)
               if row and not (len(row) == 1 and not row[0].strip())]
    width = len(names) if names is not None else (len(raw[0]) if raw else 0)
    for i, row in enumerate(raw):
        if len(row) > width:
            raise ValueError(f"{path}: expected {width} fields in row {i + 1}, saw {len(row)}")
    cols = [_column([row[c] if c < len(row) and row[c] not in NA_VALUES else None
                     for row in raw]) for c in range(width)]
    return [list(r) for r in zip(*cols)] if cols else [[] for _ in raw]


def sample_rows(rows: list, frac: float) -> list:
    """`DataFrame.sample(frac=frac)`: round(frac * n) rows in a random
    order, the first of a permutation from numpy's global generator (the
    rows pandas picks under the same global seed)."""
    keep = round(frac * len(rows))
    return [rows[i] for i in np.random.permutation(len(rows))[:keep]]


def is_nan(value) -> bool:
    return isinstance(value, float) and math.isnan(value)
