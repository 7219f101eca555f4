"""libFM text-format reader/writer.

Format (parity with reference ``src/libfm/src/Data.h:106-283``): each line is

    <target> <id>:<value> <id>:<value> ...

Leading/trailing spaces and tabs are skipped; empty lines and lines whose
first non-space character is ``#`` are skipped; a trailing ``#...`` comment
after the features is tolerated.  ``num_features`` is one more than the
largest feature id seen (reference ``Data.h:220-221``).

The reference parses in two passes (count, then fill).  Here a single pass
builds Python-level COO arrays; a compiled C fast path (``tools/libfm_parse.c``
via ctypes) is used when available for large files.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class COOData:
    """Row-major COO triples plus targets, as parsed from a libFM text file."""

    row: np.ndarray  # int32 [nnz]
    col: np.ndarray  # int32 [nnz]
    val: np.ndarray  # float32 [nnz]
    target: np.ndarray  # float32 [N]
    num_rows: int
    num_features: int  # max feature id + 1 (0 if no features at all)

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    def row_nnz(self) -> np.ndarray:
        return np.bincount(self.row, minlength=self.num_rows).astype(np.int32)


_native = None
_native_tried = False


def _load_native():
    """Try to load the C fast-path parser built by tools/Makefile."""
    global _native, _native_tried
    if _native_tried:
        return _native
    _native_tried = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    so = os.path.join(here, "tools", "libfm_parse.so")
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.libfm_count.restype = ctypes.c_int
        lib.libfm_count.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong),  # num_rows
            ctypes.POINTER(ctypes.c_longlong),  # nnz
            ctypes.POINTER(ctypes.c_longlong),  # max_feature
        ]
        lib.libfm_fill.restype = ctypes.c_int
        lib.libfm_fill.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),  # row
            ctypes.POINTER(ctypes.c_int),  # col
            ctypes.POINTER(ctypes.c_float),  # val
            ctypes.POINTER(ctypes.c_float),  # target
        ]
        _native = lib
    except OSError:
        _native = None
    return _native


def _parse_native(lib, path: str) -> COOData:
    n_rows = ctypes.c_longlong(0)
    nnz = ctypes.c_longlong(0)
    max_feat = ctypes.c_longlong(-1)
    rc = lib.libfm_count(path.encode(), ctypes.byref(n_rows), ctypes.byref(nnz), ctypes.byref(max_feat))
    if rc != 0:
        raise ValueError(f"cannot parse libFM file {path} (rc={rc})")
    N, M = n_rows.value, nnz.value
    row = np.empty(M, dtype=np.int32)
    col = np.empty(M, dtype=np.int32)
    val = np.empty(M, dtype=np.float32)
    target = np.empty(N, dtype=np.float32)
    rc = lib.libfm_fill(
        path.encode(),
        row.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        val.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        target.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise ValueError(f"cannot parse libFM file {path} (rc={rc})")
    num_features = int(max_feat.value) + 1
    return COOData(row, col, val, target, N, num_features)


def load_libfm_text(path: str, use_native: bool = True) -> COOData:
    """Parse a libFM text file into COO arrays."""
    if use_native:
        lib = _load_native()
        if lib is not None:
            return _parse_native(lib, path)

    targets: list[float] = []
    rows: list[np.ndarray] = []
    cols: list[np.ndarray] = []
    vals: list[np.ndarray] = []
    max_feature = -1
    n = 0
    with open(path, "r") as f:
        for line in f:
            s = line.strip(" \t\r\n")
            if not s or s[0] == "#":
                continue
            hash_pos = s.find("#")
            if hash_pos >= 0:
                s = s[:hash_pos].rstrip(" \t")
            parts = s.split()
            targets.append(float(parts[0]))
            if len(parts) > 1:
                ids = np.empty(len(parts) - 1, dtype=np.int32)
                xs = np.empty(len(parts) - 1, dtype=np.float32)
                for j, tok in enumerate(parts[1:]):
                    i_str, v_str = tok.split(":", 1)
                    ids[j] = int(i_str)
                    xs[j] = float(v_str)
                rows.append(np.full(len(ids), n, dtype=np.int32))
                cols.append(ids)
                vals.append(xs)
                m = int(ids.max())
                if m > max_feature:
                    max_feature = m
            n += 1
    if rows:
        row = np.concatenate(rows)
        col = np.concatenate(cols)
        val = np.concatenate(vals)
    else:
        row = np.zeros(0, dtype=np.int32)
        col = np.zeros(0, dtype=np.int32)
        val = np.zeros(0, dtype=np.float32)
    return COOData(
        row=row,
        col=col,
        val=val,
        target=np.asarray(targets, dtype=np.float32),
        num_rows=n,
        num_features=max_feature + 1,
    )


def save_libfm_text(path: str, coo: COOData) -> None:
    """Write COO data back out in libFM text format."""
    order = np.argsort(coo.row, kind="stable")
    row, col, val = coo.row[order], coo.col[order], coo.val[order]
    ptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=coo.num_rows))]).astype(np.int64)
    with open(path, "w") as f:
        for r in range(coo.num_rows):
            toks = [repr(float(coo.target[r]))]
            for k in range(ptr[r], ptr[r + 1]):
                v = float(val[k])
                v_str = str(int(v)) if v == int(v) else repr(v)
                toks.append(f"{int(col[k])}:{v_str}")
            f.write(" ".join(toks) + "\n")


def scan_max_feature(paths: list[str]) -> int:
    """Max feature id over files, without retaining data.

    Mirrors ``find_max_feature`` (reference ``libfm.cpp:528-599``) used by the
    online methods, which never load the training file up front.
    """
    mx = -1
    for p in paths:
        coo = load_libfm_text(p)
        mx = max(mx, coo.num_features - 1)
    return mx
