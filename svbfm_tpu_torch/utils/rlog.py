"""RLog — column-schema TSV metrics logger (a copy of
``svbfm_tpu/utils/rlog.py``, which is host code).

Parity with the reference ``RLog`` (``src/util/rlog.h:29-91``): fields are
declared up front with per-field defaults (NaN unless specified), a header
row is written on ``init``, and each ``new_line`` flushes the current row in
declaration order, resetting values to their defaults.
"""

from __future__ import annotations

import math
from typing import Optional


class RLog:
    def __init__(self, path: Optional[str]):
        self.path = path
        self._fields: list[str] = []
        self._default: dict[str, float] = {}
        self._value: dict[str, float] = {}
        self._fh = None

    def add_field(self, name: str, default: float = math.nan) -> None:
        if name in self._default:
            raise ValueError(f"duplicate rlog field {name!r}")
        self._fields.append(name)
        self._default[name] = default
        self._value[name] = default

    def has_field(self, name: str) -> bool:
        return name in self._default

    def init(self) -> None:
        if self.path:
            self._fh = open(self.path, "w")
            self._fh.write("\t".join(self._fields) + "\n")
            self._fh.flush()

    def log(self, name: str, value: float) -> None:
        if name not in self._default:
            raise ValueError(f"rlog field {name!r} not registered")
        self._value[name] = value

    def new_line(self) -> None:
        if self._fh is not None:
            self._fh.write(
                "\t".join(str(self._value[f]) for f in self._fields) + "\n")
            self._fh.flush()
        for f in self._fields:
            self._value[f] = self._default[f]

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
