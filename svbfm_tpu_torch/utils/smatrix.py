"""Map-based sparse vector/matrix/tensor containers with text file IO.

Parity target: reference ``src/util/smatrix.h:33-247`` (SparseVector/
SparseMatrix/SparseTensor over ``std::map`` plus the Boolean set variants).
The reference's main training path never uses these (they survive as utility
dead code), but they are part of its public utility surface, so we supply a
host-side equivalent for completeness.  Semantics preserved:

* ``get`` returns 0 (or False) for absent keys without inserting them
  (``smatrix.h:35-42``).
* Iteration / serialization order is ascending by key at every level —
  ``std::map`` ordering (``smatrix.h:120-142``).
* Text format is whitespace-separated ``k... value`` lines: ``"i v"`` per
  vector entry, ``"r c v"`` per matrix entry, ``"t r c v"`` per tensor entry;
  boolean variants store only the index tuple (``smatrix.h:191-199``).
* ``from_file`` tolerates trailing whitespace/newlines the way the
  reference's eof-guarded ``>>`` loop does (``smatrix.h:154-171``).

These are plain host containers (preprocessing / fixture tooling); nothing
here touches the device path.  The port keeps this copy of
``svbfm_tpu/utils/smatrix.py`` so that it imports nothing of the JAX
package.
"""

from __future__ import annotations

import io
from typing import Dict, Iterator, Set, Tuple, TypeVar

T = TypeVar("T")


def _tokens(path: str) -> Iterator[str]:
    with open(path, "r") as f:
        for line in f:
            for tok in line.split():
                yield tok


def _fmt(value) -> str:
    """Format a value the way C++ ``operator<<`` prints it (ints bare,
    floats with up-to-6-significant-digit default formatting)."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    return f"{value:g}"


class SparseVector(Dict[int, T]):
    """``std::map<int,T>`` with a non-inserting 0-default get."""

    def get(self, x: int, default=0):  # type: ignore[override]
        return super().get(x, default)

    def to_stream(self, stream: io.TextIOBase) -> None:
        for k in sorted(self):
            stream.write(f"{k} {_fmt(self[k])}\n")


class SparseMatrix(Dict[int, SparseVector]):
    """Two-level map; ``m[r]`` auto-creates the row (like ``operator[]``)."""

    def __missing__(self, key: int) -> SparseVector:
        row = SparseVector()
        self[key] = row
        return row

    def get(self, x: int, y: int = None, default=0):  # type: ignore[override]
        if y is None:
            return super().get(x, default)
        row = super().get(x)
        return default if row is None else row.get(y, default)

    def to_stream(self, stream: io.TextIOBase) -> None:
        for r in sorted(self):
            row = self[r]
            for c in sorted(row):
                stream.write(f"{r} {c} {_fmt(row[c])}\n")

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            self.to_stream(f)

    def from_file(self, path: str, cast=float) -> "SparseMatrix":
        it = _tokens(path)
        while True:
            try:
                r = int(next(it))
            except StopIteration:
                return self
            c = int(next(it))
            v = cast(next(it))
            self[r][c] = v


class SparseTensor(Dict[int, SparseMatrix]):
    """Three-level map with the reference's ``t r c v`` text format."""

    def __missing__(self, key: int) -> SparseMatrix:
        mat = SparseMatrix()
        self[key] = mat
        return mat

    def get(self, x: int, y: int = None, z: int = None, default=0):  # type: ignore[override]
        if y is None:
            return super().get(x, default)
        mat = super().get(x)
        if mat is None:
            return default
        return mat.get(y, z, default) if z is not None else mat.get(y, default)

    def to_stream(self, stream: io.TextIOBase) -> None:
        for t in sorted(self):
            mat = self[t]
            for r in sorted(mat):
                row = mat[r]
                for c in sorted(row):
                    stream.write(f"{t} {r} {c} {_fmt(row[c])}\n")

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            self.to_stream(f)

    def from_file(self, path: str, cast=float) -> "SparseTensor":
        it = _tokens(path)
        while True:
            try:
                t = int(next(it))
            except StopIteration:
                return self
            r = int(next(it))
            c = int(next(it))
            v = cast(next(it))
            self[t][r][c] = v


class SparseVectorBoolean(Set[int]):
    """``std::set<int>`` membership vector (``smatrix.h:81-91``)."""

    def get(self, x: int) -> bool:
        return x in self


class SparseMatrixBoolean(Dict[int, SparseVectorBoolean]):
    def __missing__(self, key: int) -> SparseVectorBoolean:
        s = SparseVectorBoolean()
        self[key] = s
        return s

    def get(self, x: int, y: int = None):  # type: ignore[override]
        row = super().get(x)
        if y is None:
            return row
        return False if row is None else y in row

    def from_file(self, path: str) -> "SparseMatrixBoolean":
        it = _tokens(path)
        while True:
            try:
                m = int(next(it))
            except StopIteration:
                return self
            v = int(next(it))
            self[m].add(v)


class SparseTensorBoolean(Dict[int, SparseMatrixBoolean]):
    def __missing__(self, key: int) -> SparseMatrixBoolean:
        m = SparseMatrixBoolean()
        self[key] = m
        return m

    def get(self, x: int, y: int = None, z: int = None):  # type: ignore[override]
        mat = super().get(x)
        if mat is None:
            return False if z is not None else None
        if y is None:
            return mat
        return mat.get(y, z) if z is not None else mat.get(y)

    def to_stream(self, stream: io.TextIOBase) -> None:
        for t in sorted(self):
            mat = self[t]
            for r in sorted(mat):
                for c in sorted(mat[r]):
                    stream.write(f"{t} {r} {c}\n")

    def to_file(self, path: str) -> None:
        with open(path, "w") as f:
            self.to_stream(f)

    def from_file(self, path: str) -> "SparseTensorBoolean":
        it = _tokens(path)
        while True:
            try:
                t = int(next(it))
            except StopIteration:
                return self
            r = int(next(it))
            c = int(next(it))
            self[t][r].add(c)


__all__: Tuple[str, ...] = (
    "SparseVector", "SparseMatrix", "SparseTensor",
    "SparseVectorBoolean", "SparseMatrixBoolean", "SparseTensorBoolean",
)
