"""Parser for the NoahMP tagged-text parameter table format.

The on-disk format (reference: tbl/*.TBL, parsed by
core/module_noahmp_utils.f90:56-237) is a sequence of sections introduced
by a line ``&NAME#TAG`` (tagged by parameter scheme, e.g. ``USGS``) or
``&NAME`` (untagged).  A *scalar/vector* section holds one record of
comma-separated numbers.  A *table* section's first record is the row
count (trailing header text ignored), followed by that many rows of
``index, v1, v2, ...`` (trailing quoted descriptions ignored).

Unlike the reference — which re-opens and rescans the file once per
variable — this parser reads each file once into a section dict; the
tables are then frozen into tensors at model build time.  Own copy of
``noahmp_tpu/params/reader.py``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

import numpy as np

_NUM_RE = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eEdD][-+]?\d+)?")


def _strip_comment(line: str) -> str:
    # Quoted strings (row descriptions) are dropped entirely.
    return re.sub(r"'[^']*'", " ", line)


def parse_sections(path: str) -> Dict[str, List[str]]:
    """Split a TBL file into {``NAME#TAG`` or ``NAME``: [record lines]}."""
    sections: Dict[str, List[str]] = {}
    current: List[str] | None = None
    with open(path) as f:
        for raw in f:
            line = raw.rstrip("\n").strip()
            if not line:
                continue
            if line.startswith("&"):
                key = line[1:].strip()
                current = sections.setdefault(key, [])
            elif current is not None:
                current.append(line)
    return sections


def _numbers(line: str) -> List[float]:
    return [float(tok.replace("D", "E").replace("d", "e"))
            for tok in _NUM_RE.findall(_strip_comment(line))]


def read_scalar(sections: Dict[str, List[str]], name: str) -> float:
    vals = _numbers(sections[name][0])
    if len(vals) != 1:
        raise ValueError(f"section {name!r} is not a scalar: {vals}")
    return vals[0]


def read_vector(sections: Dict[str, List[str]], name: str) -> np.ndarray:
    return np.asarray(_numbers(sections[name][0]), dtype=np.float32)


def read_table(sections: Dict[str, List[str]], name: str,
               ncols: int) -> np.ndarray:
    """Read a counted table section into a dense (nrows, ncols) array.

    Rows are placed by their leading 1-based index so sparse/reordered
    tables land in the right slots.  Returns rows 1..nrows in order
    (row for class ``i`` is at array index ``i-1``).
    """
    lines = sections[name]
    count = int(_numbers(lines[0])[0])
    rows = lines[1:1 + count]
    if len(rows) < count:
        raise ValueError(f"section {name!r}: expected {count} rows, "
                         f"got {len(rows)}")
    out = np.zeros((count, ncols), dtype=np.float32)
    for line in rows:
        vals = _numbers(line)
        idx = int(vals[0])
        data = vals[1:1 + ncols]
        if len(data) != ncols:
            raise ValueError(f"section {name!r} row {idx}: expected "
                             f"{ncols} values, got {len(data)}")
        out[idx - 1] = data
    return out


def read_columns(sections: Dict[str, List[str]], name: str,
                 ncols: int) -> Sequence[np.ndarray]:
    """Like read_table but returns per-column 1-D arrays."""
    tbl = read_table(sections, name, ncols)
    return [np.ascontiguousarray(tbl[:, j]) for j in range(ncols)]
