"""The port's binary IO and chunk reader (``svbfm_tpu_torch/data/binary.py``,
``data/stream.py``) against the JAX package's, on the same files.

Tolerance: none.  Files are compared byte for byte, arrays for equality
(values and dtypes), row offsets and sizes exactly.
"""

import filecmp
import struct

import numpy as np
import pytest

from svbfm_tpu.data import binary as jb
from svbfm_tpu.data import relation as jrel
from svbfm_tpu.data import stream as js
from svbfm_tpu.data.libfm_text import COOData as JCOO
from svbfm_tpu_torch.data import binary as tb
from svbfm_tpu_torch.data import relation as trel
from svbfm_tpu_torch.data import stream as ts
from svbfm_tpu_torch.data.libfm_text import COOData


def _ragged(seed=0, num_rows=60, num_cols=23, uniform=False):
    """COO triples with rows of 0-5 entries (some rows empty, the last row
    too), file order inside a row not sorted by column; ``uniform``: two
    entries a row, as a one-hot user/item file."""
    rng = np.random.default_rng(seed)
    sizes = (np.full(num_rows, 2) if uniform
             else rng.integers(0, 6, num_rows))
    if not uniform:
        sizes[[3, 17, num_rows - 1]] = 0
    row = np.repeat(np.arange(num_rows, dtype=np.int32), sizes)
    col = rng.integers(0, num_cols, len(row)).astype(np.int32)
    val = rng.normal(size=len(row)).astype(np.float32)
    target = rng.normal(size=num_rows).astype(np.float32)
    # the rows shuffled: the writers sort them, keeping file order in a row
    perm = rng.permutation(len(row))
    return row[perm], col[perm], val[perm], target, num_rows, num_cols


def _coo(cls, data):
    row, col, val, target, n, d = data
    return cls(row=row, col=col, val=val, target=target, num_rows=n,
               num_features=d)


@pytest.mark.parametrize("uniform", [False, True])
def test_files_are_byte_identical(tmp_path, uniform):
    data = _ragged(uniform=uniform)
    jb.save_coo_binary(str(tmp_path / "j"), _coo(JCOO, data), transpose=True)
    tb.save_coo_binary(str(tmp_path / "t"), _coo(COOData, data),
                       transpose=True)
    for ext in (".x", ".y", ".xt"):
        assert filecmp.cmp(tmp_path / f"j{ext}", tmp_path / f"t{ext}",
                           shallow=False), ext
    jb.save_dvector_binary(str(tmp_path / "j.u"), np.arange(7), np.uint32)
    tb.save_dvector_binary(str(tmp_path / "t.u"), np.arange(7), np.uint32)
    assert filecmp.cmp(tmp_path / "j.u", tmp_path / "t.u", shallow=False)


@pytest.mark.parametrize("branch", ["x", "data", "xt"])
def test_every_load_branch_matches(tmp_path, branch):
    """.x/.y, .data/.target and the .xt-only branch (the transpose flipped
    back) give JAX's arrays."""
    row, col, val, target, n, d = _ragged(seed=1)
    p = str(tmp_path / "f")
    if branch == "x":
        tb.save_coo_binary(p, _coo(COOData, (row, col, val, target, n, d)))
    elif branch == "data":
        tb.save_sparse_binary(p + ".data", row, col, val, n, d)
        tb.save_dvector_binary(p + ".target", target)
    else:
        tb.save_sparse_binary(p + ".xt", col, row, val, d, n)
        tb.save_dvector_binary(p + ".y", target)
    got, want = tb.load_coo_binary(p), jb.load_coo_binary(p)
    for k in ("row", "col", "val", "target"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got.num_rows, got.num_features) == (want.num_rows,
                                                want.num_features)
    assert tb.has_binary(p) == jb.has_binary(p) == (branch != "xt")
    # the sparse reader alone, on the file JAX wrote
    if branch == "x":
        for a, b in zip(tb.load_sparse_binary(p + ".x"),
                        jb.load_sparse_binary(p + ".x")):
            np.testing.assert_array_equal(a, b)


def test_binary_paths_prefer_x(tmp_path):
    p = str(tmp_path / "f")
    for ext in (".data", ".target"):
        (tmp_path / f"f{ext}").write_bytes(b"")
    assert tb.binary_paths(p) == (p + ".data", p + ".target")
    for ext in (".x", ".y"):
        (tmp_path / f"f{ext}").write_bytes(b"")
    assert tb.binary_paths(p) == (p + ".x", p + ".y")


def test_bad_headers_raise(tmp_path):
    p = tmp_path / "bad.x"
    p.write_bytes(struct.pack("<IIQII", 3, 4, 0, 0, 0))
    with pytest.raises(ValueError, match="bad sparse file id"):
        tb.load_sparse_binary(str(p))
    with pytest.raises(ValueError, match="bad header"):
        ts.BinaryChunkReader(str(p))
    q = tmp_path / "bad.y"
    q.write_bytes(struct.pack("<III", 2, 4, 0))
    with pytest.raises(ValueError, match="bad dvector file id"):
        tb.load_dvector_binary(str(q))


def test_binary_relations_and_joins_match(tmp_path):
    """RelationData.load reads prefix.x (with prefix.groups) and the join
    reads as a binary DVector<uint>: JAX's arrays."""
    row, col, val, _t, n, d = _ragged(seed=2, num_rows=40, num_cols=12)
    p = str(tmp_path / "rel")
    tb.save_sparse_binary(p + ".x", row, col, val, n, d)
    (tmp_path / "rel.groups").write_text(
        "\n".join(str(g) for g in np.arange(d) % 3) + "\n")
    got, want = trel.RelationData.load(p), jrel.RelationData.load(p)
    for k in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.num_rows, got.num_features) == (want.num_rows,
                                                want.num_features)
    np.testing.assert_array_equal(got.meta.attr_group, want.meta.attr_group)
    idx = np.random.default_rng(3).integers(0, n, 25)
    tb.save_dvector_binary(p + ".train", idx, np.uint32)
    np.testing.assert_array_equal(trel.load_join(p + ".train", 25),
                                  jrel.load_join(p + ".train", 25))


@pytest.mark.parametrize("scan", ["native", "numpy", "numpy-small-buffers"])
@pytest.mark.parametrize("uniform", [False, True])
def test_reader_matches_jax(tmp_path, monkeypatch, scan, uniform):
    """Row offsets and sizes, read_rows (empty rows, a window of none, the
    last window) and col_count equal the JAX reader's, with the native
    index scan where it was built and the numpy scan (also cut into
    buffers of 64 bytes, so that rows straddle them)."""
    row, col, val, target, n, d = _ragged(seed=4, num_rows=90,
                                          uniform=uniform)
    p = str(tmp_path / "tr")
    jb.save_coo_binary(p, _coo(JCOO, (row, col, val, target, n, d)))
    if scan != "native":
        monkeypatch.setattr(ts.BinaryChunkReader, "_index_scan_c",
                            lambda self: False)
    if scan == "numpy-small-buffers":
        monkeypatch.setattr(ts, "_SCAN_BYTES", 64)
    want = js.BinaryChunkReader(p + ".x", p + ".y")
    got = ts.BinaryChunkReader(p + ".x", p + ".y")
    np.testing.assert_array_equal(got.row_offsets, want.row_offsets)
    np.testing.assert_array_equal(got.row_sizes, want.row_sizes)
    np.testing.assert_array_equal(got.targets, want.targets)
    for lo, hi in ((0, 10), (3, 4), (17, 17), (60, 90), (0, 90)):
        a, b = got.read_rows(lo, hi), want.read_rows(lo, hi)
        for k in ("row", "col", "val", "target"):
            assert getattr(a, k).dtype == getattr(b, k).dtype, k
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert (a.num_rows, a.num_features) == (b.num_rows, b.num_features)
    np.testing.assert_array_equal(got.col_count(), want.col_count())
    assert got.col_count().dtype == want.col_count().dtype


@pytest.mark.parametrize("num_chunks,order", [(4, None), (5, [3, 0, 4, 1, 2]),
                                              (1, None)])
def test_stream_chunks_same_order(tmp_path, num_chunks, order):
    row, col, val, target, n, d = _ragged(seed=5, num_rows=53)
    p = str(tmp_path / "tr")
    tb.save_coo_binary(p, _coo(COOData, (row, col, val, target, n, d)))
    want = list(js.stream_chunks(js.BinaryChunkReader(p + ".x", p + ".y"),
                                 num_chunks, order=order, min_target=-1.0,
                                 max_target=2.0))
    got = list(ts.stream_chunks(ts.BinaryChunkReader(p + ".x", p + ".y"),
                                num_chunks, order=order, min_target=-1.0,
                                max_target=2.0))
    assert len(got) == len(want) == num_chunks
    for a, b in zip(got, want):
        for k in ("ids", "vals", "target", "row_nnz"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert (a.num_rows, a.min_target, a.max_target) == (
            b.num_rows, b.min_target, b.max_target)
    np.testing.assert_array_equal(
        ts.chunk_bounds(n, num_chunks),
        np.linspace(0, n, num_chunks + 1).astype(np.int64))


@pytest.mark.parametrize("uniform", [False, True])
def test_read_window_is_from_coo_of_read_rows(tmp_path, uniform):
    """The streamed learners' read: SparseDataset.from_coo(read_rows) array
    for array, by the reshape of uniform rows or the general path."""
    from svbfm_tpu_torch.data.dataset import SparseDataset

    row, col, val, target, n, d = _ragged(seed=7, num_rows=70,
                                          uniform=uniform)
    p = str(tmp_path / "tr")
    tb.save_coo_binary(p, _coo(COOData, (row, col, val, target, n, d)))
    r = ts.BinaryChunkReader(p + ".x", p + ".y")
    for lo, hi in ((0, 70), (5, 6), (20, 41), (69, 70)):
        got = ts.read_window(r, lo, hi, d + 2)
        want = SparseDataset.from_coo(r.read_rows(lo, hi), d + 2)
        for k in ("ids", "vals", "target", "row_nnz"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        for k in ("num_rows", "num_features", "min_target", "max_target"):
            assert getattr(got, k) == getattr(want, k), k
