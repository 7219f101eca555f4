"""Reference-compatible binary sparse-matrix / target-vector IO.

A copy of ``svbfm_tpu.data.binary``, array for array and byte for byte
(``tests/test_torch_binary.py`` holds the two to equality): the port must
not import the JAX package.  The writer builds each file in one numpy
buffer, and the reader parses it without a Python step per entry.

Formats (byte-compatible with the reference, so that files made by its
``convert`` / ``transpose`` tools load directly, and the reverse):

* Sparse matrix (``.x`` / ``.xt`` / ``.data`` / ``.datat``), reference
  ``src/util/fmatrix.h:46-108``:
    header: uint32 id(=2), uint32 float_size, uint64 num_values,
            uint32 num_rows, uint32 num_cols   (packed, 24 bytes)
    then per row: uint32 size, size * { uint32 id, float32 value }

* Dense vector (``.y`` / ``.target``), reference ``src/util/matrix.h:280-328``:
    uint32 id(=1), uint32 data_size, uint32 num_rows, then raw values.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from svbfm_tpu_torch.data.libfm_text import COOData

FMATRIX_FILE_ID = 2
DVECTOR_FILE_ID = 1
_HEADER = struct.Struct("<IIQII")


def row_words(row: np.ndarray, col: np.ndarray, val: np.ndarray,
              num_rows: int) -> np.ndarray:
    """The body of a sparse file as uint32 words: per row its size, then
    its (id, value) records; the entries in row order, file order kept
    within a row (a stable sort, as the JAX writer sorts)."""
    order = np.argsort(row, kind="stable")
    row, col, val = row[order], col[order], val[order]
    nnz = len(col)
    sizes = np.bincount(row, minlength=num_rows).astype(np.int64)
    ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(sizes, out=ptr[1:])
    words = np.empty(num_rows + 2 * nnz, dtype="<u4")
    r = np.arange(num_rows, dtype=np.int64)
    words[r + 2 * ptr[:-1]] = sizes.astype(np.uint32)
    at = row.astype(np.int64) + 1 + 2 * np.arange(nnz, dtype=np.int64)
    words[at] = col.astype(np.uint32)
    words[at + 1] = val.astype("<f4").view("<u4")
    return words


def save_sparse_binary(path: str, row: np.ndarray, col: np.ndarray,
                       val: np.ndarray, num_rows: int, num_cols: int) -> None:
    words = row_words(row, col, val, num_rows)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(FMATRIX_FILE_ID, 4, len(col), num_rows,
                             num_cols))
        f.write(words.tobytes())


def size_word_offsets(words: np.ndarray, num_rows: int) -> np.ndarray:
    """The word offset of each row's size word in a sparse file's body
    (``num_rows + 1`` of them, the last one past the body).  Rows of one
    common size are found with one strided check; otherwise the sizes are
    walked in order through a memoryview, no file read per row."""
    out = np.empty(num_rows + 1, dtype=np.int64)
    if num_rows == 0:
        out[0] = 0
        return out
    k = int(words[0])
    stride = 1 + 2 * k
    if len(words) == num_rows * stride and (words[::stride] == k).all():
        out[:] = np.arange(num_rows + 1, dtype=np.int64) * stride
        return out
    mv = memoryview(np.ascontiguousarray(words)).cast("B").cast("I")
    pos = 0
    for r in range(num_rows):
        out[r] = pos
        pos += 1 + 2 * mv[pos]
    out[num_rows] = pos
    return out


def entries_of(words: np.ndarray, offsets: np.ndarray):
    """(row, col, val) of the rows whose size words sit at ``offsets``
    (``num_rows + 1`` word offsets into ``words``), rows numbered from 0."""
    n = len(offsets) - 1
    sizes = ((offsets[1:] - offsets[:-1] - 1) // 2).astype(np.int64)
    nnz = int(sizes.sum())
    row = np.repeat(np.arange(n, dtype=np.int32), sizes)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(sizes, out=ptr[1:])
    pos = np.arange(nnz, dtype=np.int64) - np.repeat(ptr[:-1], sizes)
    at = np.repeat(offsets[:-1], sizes) + 1 + 2 * pos
    col = words[at].astype(np.int64).astype(np.int32)
    val = words[at + 1].view("<f4").astype(np.float32)
    return row, col, val


def load_sparse_binary(path: str):
    """Returns (row, col, val, num_rows, num_cols)."""
    with open(path, "rb") as f:
        buf = f.read()
    fid, float_size, num_values, num_rows, num_cols = _HEADER.unpack_from(
        buf, 0)
    if fid != FMATRIX_FILE_ID:
        raise ValueError(f"{path}: bad sparse file id {fid}")
    if float_size != 4:
        raise ValueError(f"{path}: unsupported float size {float_size}")
    words = np.frombuffer(buf, dtype="<u4", offset=_HEADER.size)
    offsets = size_word_offsets(words, num_rows)
    row, col, val = entries_of(words, offsets)
    if len(col) != num_values:
        raise ValueError(f"{path}: nnz mismatch {len(col)} != {num_values}")
    return row, col, val, num_rows, num_cols


def save_dvector_binary(path: str, values: np.ndarray,
                        dtype=np.float32) -> None:
    v = np.asarray(values, dtype=dtype)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", DVECTOR_FILE_ID, v.dtype.itemsize,
                            v.shape[0]))
        f.write(v.tobytes())


def load_dvector_binary(path: str, dtype=np.float32) -> np.ndarray:
    with open(path, "rb") as f:
        fid, data_size, num_rows = struct.unpack("<III", f.read(12))
        if fid != DVECTOR_FILE_ID:
            raise ValueError(f"{path}: bad dvector file id {fid}")
        dt = np.dtype(dtype)
        if data_size != dt.itemsize:
            raise ValueError(f"{path}: itemsize {data_size} != expected "
                             f"{dt.itemsize}")
        return np.frombuffer(f.read(num_rows * dt.itemsize), dtype=dt).copy()


def save_coo_binary(prefix: str, coo: COOData, transpose: bool = False) -> None:
    """Write ``prefix.x`` + ``prefix.y`` (and ``prefix.xt`` with transpose),
    matching the outputs of the reference ``convert``/``transpose`` tools."""
    save_sparse_binary(prefix + ".x", coo.row, coo.col, coo.val,
                       coo.num_rows, coo.num_features)
    save_dvector_binary(prefix + ".y", coo.target, np.float32)
    if transpose:
        save_sparse_binary(prefix + ".xt", coo.col, coo.row, coo.val,
                           coo.num_features, coo.num_rows)


def load_coo_binary(prefix: str) -> COOData:
    if os.path.exists(prefix + ".x"):
        row, col, val, num_rows, num_cols = load_sparse_binary(prefix + ".x")
        target = load_dvector_binary(prefix + ".y")
    elif os.path.exists(prefix + ".data"):
        row, col, val, num_rows, num_cols = load_sparse_binary(
            prefix + ".data")
        target = load_dvector_binary(prefix + ".target")
    elif os.path.exists(prefix + ".xt"):
        # only the transpose exists: flip it
        col, row, val, num_cols, num_rows = load_sparse_binary(prefix + ".xt")
        order = np.argsort(row, kind="stable")
        row, col, val = row[order], col[order], val[order]
        target = load_dvector_binary(prefix + ".y")
    else:
        raise FileNotFoundError(f"no binary data at {prefix}.x / "
                                f"{prefix}.data")
    return COOData(row=row.astype(np.int32), col=col.astype(np.int32),
                   val=val.astype(np.float32),
                   target=target.astype(np.float32), num_rows=num_rows,
                   num_features=num_cols)


def has_binary(prefix: str) -> bool:
    return ((os.path.exists(prefix + ".x") or os.path.exists(prefix + ".data"))
            and (os.path.exists(prefix + ".y")
                 or os.path.exists(prefix + ".target")))


def binary_paths(prefix: str) -> tuple[str, str]:
    """The (.x or .data, .y or .target) pair ``has_binary`` found, in the
    JAX CLI's order of preference (svbfm_tpu/cli.py:229-232)."""
    xp = prefix + (".x" if os.path.exists(prefix + ".x") else ".data")
    yp = prefix + (".y" if os.path.exists(prefix + ".y") else ".target")
    return xp, yp
