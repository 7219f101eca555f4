"""Out-of-core streaming over binary sparse data.

A copy of ``svbfm_tpu.data.stream``: a :class:`BinaryChunkReader` reads
row-window chunks of a reference-format ``.x``/``.y`` pair directly into
the host (host RAM is bounded by the chunk size), and
:func:`stream_chunks` iterates them in any order for chunked-epoch
training.  ``read_rows``, ``col_count`` and the row index are the JAX
reader's arrays (``tests/test_torch_binary.py``).

The index scan records each row's byte offset.  It runs the C fast path
``sparse_index_scan`` of ``tools/libfm_parse.so`` where that library was
built (``make -C tools``), as ``data/libfm_text.py`` does for text, else
a numpy scan that reads the file in 64 MiB buffers (rows of one common
size are indexed by a strided check, others walked through a memoryview;
no file read per row).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Iterator, Optional

import numpy as np

from svbfm_tpu_torch.data.binary import (DVECTOR_FILE_ID, FMATRIX_FILE_ID,
                                         _HEADER, entries_of)
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.libfm_text import COOData

_SCAN_BYTES = 1 << 26


class BinaryChunkReader:
    """Row-window reader over a reference-format binary sparse matrix.

    An index pass records each row's byte offset, after which any row
    window loads in one contiguous read."""

    def __init__(self, x_path: str, y_path: Optional[str] = None):
        self.x_path = x_path
        self.y_path = y_path
        with open(x_path, "rb") as f:
            hdr = f.read(_HEADER.size)
            fid, fsize, self.num_values, self.num_rows, self.num_cols = \
                _HEADER.unpack(hdr)
            if fid != FMATRIX_FILE_ID or fsize != 4:
                raise ValueError(f"{x_path}: bad header")
        self.row_offsets = np.empty(self.num_rows + 1, dtype=np.int64)
        self.row_sizes = np.empty(self.num_rows, dtype=np.int64)
        if not self._index_scan_c():
            self._index_scan_py()
        self.targets = None
        if y_path is not None and os.path.exists(y_path):
            with open(y_path, "rb") as f:
                fid, dsize, dim = struct.unpack("<III", f.read(12))
                if fid != DVECTOR_FILE_ID or dsize != 4:
                    raise ValueError(f"{y_path}: bad header")
                self.targets = np.frombuffer(f.read(dim * 4), dtype="<f4")
            if len(self.targets) != self.num_rows:
                raise ValueError(f"{y_path}: {len(self.targets)} targets for "
                                 f"{self.num_rows} rows")

    def _index_scan_c(self) -> bool:
        here = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        so = os.path.join(here, "tools", "libfm_parse.so")
        if not os.path.exists(so):
            return False
        try:
            fn = ctypes.CDLL(so).sparse_index_scan
        except (OSError, AttributeError):
            return False
        fn.restype = ctypes.c_int
        rc = fn(self.x_path.encode(), ctypes.c_longlong(_HEADER.size),
                ctypes.c_longlong(self.num_rows),
                self.row_offsets.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_longlong)),
                self.row_sizes.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_longlong)))
        return rc == 0

    def _index_scan_py(self) -> None:
        """The numpy scan: each buffer's rows are indexed at once, and the
        rows a buffer cuts off start the next one."""
        base = _HEADER.size  # file offset of the next unindexed row
        r = 0
        with open(self.x_path, "rb") as f:
            while r < self.num_rows:
                f.seek(base)
                words = np.frombuffer(f.read(_SCAN_BYTES), dtype="<u4")
                # the rows wholly inside this buffer
                offs = _whole_rows(words, self.num_rows - r)
                n = len(offs) - 1
                if n == 0:
                    raise ValueError(f"{self.x_path}: a row longer than "
                                     f"{_SCAN_BYTES} bytes or a cut file")
                self.row_offsets[r:r + n] = base + 4 * offs[:-1]
                self.row_sizes[r:r + n] = (offs[1:] - offs[:-1] - 1) // 2
                base += 4 * int(offs[-1])
                r += n
        self.row_offsets[self.num_rows] = base

    def read_rows(self, lo: int, hi: int) -> COOData:
        """Rows [lo, hi) as a COOData with rows renumbered from 0."""
        lo, hi = int(lo), int(hi)
        with open(self.x_path, "rb") as f:
            f.seek(self.row_offsets[lo])
            buf = f.read(int(self.row_offsets[hi] - self.row_offsets[lo]))
        words = np.frombuffer(buf, dtype="<u4")
        offs = (self.row_offsets[lo:hi + 1] - self.row_offsets[lo]) // 4
        row, col, val = entries_of(words, offs)
        n = hi - lo
        target = (self.targets[lo:hi].astype(np.float32)
                  if self.targets is not None else np.zeros(n, np.float32))
        return COOData(row=row, col=col, val=val, target=target,
                       num_rows=n, num_features=self.num_cols)

    def col_count(self) -> np.ndarray:
        """Full-file per-column occurrence counts (one streaming pass) —
        the OVBFM col_count scan (fm_learn_vb_online.h:704-726)."""
        counts = np.zeros(self.num_cols, dtype=np.int64)
        chunk = max(1, min(self.num_rows, 262144))
        for lo in range(0, self.num_rows, chunk):
            coo = self.read_rows(lo, min(lo + chunk, self.num_rows))
            counts += np.bincount(coo.col, minlength=self.num_cols)
        return counts.astype(np.int32)


def read_window(reader: BinaryChunkReader, lo: int, hi: int,
                D: int) -> SparseDataset:
    """Rows [lo, hi) as a SparseDataset of ``D`` features: array for array
    ``SparseDataset.from_coo(reader.read_rows(lo, hi), D)``.  Where every
    row of the window holds the same number k of entries (one-hot field
    data), the row layout is the file's words reshaped [rows, 1 + 2k],
    with no sort and no per-entry index: the streamed learners' read."""
    lo, hi = int(lo), int(hi)
    n = hi - lo
    sizes = reader.row_sizes[lo:hi]
    k = int(sizes[0]) if n else 0
    if n == 0 or not (sizes == k).all():
        return SparseDataset.from_coo(reader.read_rows(lo, hi), D)
    with open(reader.x_path, "rb") as f:
        f.seek(reader.row_offsets[lo])
        words = np.frombuffer(f.read(4 * n * (1 + 2 * k)), dtype="<u4")
    P = max(k, 1)
    ids = np.zeros((n, P), np.int32)
    vals = np.zeros((n, P), np.float32)
    rec = words.reshape(n, 1 + 2 * k)[:, 1:]
    ids[:, :k] = rec[:, 0::2].astype(np.int64).astype(np.int32)
    vals[:, :k] = rec[:, 1::2].view("<f4")
    target = (reader.targets[lo:hi].astype(np.float32)
              if reader.targets is not None else np.zeros(n, np.float32))
    return SparseDataset(
        ids=ids, vals=vals, target=target, num_rows=n, num_features=D,
        min_target=float(target.min()), max_target=float(target.max()),
        row_nnz=np.full(n, k, np.int32))


def _whole_rows(words: np.ndarray, rows_left: int) -> np.ndarray:
    """Word offsets of the rows that lie wholly in ``words`` (at most
    ``rows_left``), and the offset just past the last of them."""
    n = min(rows_left, len(words))
    if n == 0:
        return np.zeros(1, np.int64)
    k = int(words[0])
    stride = 1 + 2 * k
    m = min(n, len(words) // stride)
    if m and (words[:m * stride:stride] == k).all():
        return np.arange(m + 1, dtype=np.int64) * stride
    mv = memoryview(np.ascontiguousarray(words)).cast("B").cast("I")
    out = [0]
    pos = 0
    size = len(words)
    for _ in range(n):
        if pos >= size:
            break
        nxt = pos + 1 + 2 * mv[pos]
        if nxt > size:
            break
        out.append(nxt)
        pos = nxt
    return np.asarray(out, dtype=np.int64)


def stream_chunks(reader: BinaryChunkReader, num_chunks: int,
                  order: Optional[np.ndarray] = None,
                  min_target: Optional[float] = None,
                  max_target: Optional[float] = None,
                  ) -> Iterator[SparseDataset]:
    """Yield ``num_chunks`` contiguous row-window chunks (optionally in a
    shuffled order) as SparseDatasets."""
    bounds = chunk_bounds(reader.num_rows, num_chunks)
    idx = np.arange(num_chunks) if order is None else np.asarray(order)
    for ci in idx:
        coo = reader.read_rows(bounds[ci], bounds[ci + 1])
        ds = SparseDataset.from_coo(coo, reader.num_cols)
        if min_target is not None:
            ds.min_target = min_target
        if max_target is not None:
            ds.max_target = max_target
        yield ds


def chunk_bounds(num_rows: int, num_chunks: int) -> np.ndarray:
    """The row bounds of ``num_chunks`` windows, as JAX's streaming learners
    cut them (``np.linspace``)."""
    return np.linspace(0, num_rows, num_chunks + 1).astype(np.int64)
