"""Relational block structure (libFM BS, VLDB'13): the host-side tables.

A copy of ``svbfm_tpu.data.relation``, kept array-for-array identical
(``tests/test_torch_bs.py`` holds the two to equality): the port must not
import the JAX package.  A relation is a shared feature-block table whose
rows are joined into each data row through a per-row index; relation
attributes live at an offset after the main attributes in a joined global
attribute space, and relation groups are appended after the main groups
(reference ``relation.h:32-148``, ``libfm.cpp:188-256``).

The native BS learner (``learners/mcmc_bs.py``) keeps the relations
factored; ``join_relations`` materialises the join into the flat design
matrix for every other learner.  A relation reads from the reference's
binary ``prefix.x`` where it exists, else from libFM text.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from svbfm_tpu_torch.data.binary import DVECTOR_FILE_ID, load_sparse_binary
from svbfm_tpu_torch.data.libfm_text import COOData, load_libfm_text
from svbfm_tpu_torch.data.meta import DataMetaInfo


@dataclass
class RelationData:
    """A relation table: CSR triples over its own attribute space."""

    row: np.ndarray  # int32 [nnz]
    col: np.ndarray  # int32 [nnz]
    val: np.ndarray  # float32 [nnz]
    num_rows: int
    num_features: int
    meta: DataMetaInfo = field(default=None)
    attr_offset: int = 0  # set during join

    @staticmethod
    def load(prefix: str) -> "RelationData":
        """Load ``prefix.x`` (binary) or ``prefix``/``prefix.libfm`` (text,
        targets ignored); ``prefix.groups`` supplies the relation's groups."""
        if os.path.exists(prefix + ".x"):
            row, col, val, nr, nc = load_sparse_binary(prefix + ".x")
        else:
            tf = prefix if os.path.exists(prefix) else prefix + ".libfm"
            coo = load_libfm_text(tf)
            row, col, val = coo.row, coo.col, coo.val
            nr, nc = coo.num_rows, coo.num_features
        meta = DataMetaInfo(nc)
        if os.path.exists(prefix + ".groups"):
            meta.load_groups_from_file(prefix + ".groups")
        return RelationData(row=row.astype(np.int32), col=col.astype(np.int32),
                            val=val.astype(np.float32), num_rows=nr,
                            num_features=nc, meta=meta)


def load_join(filename: str, expected_rows: int) -> np.ndarray:
    """Per-data-row relation row ids; binary DVector<uint> or one-per-line
    text (relation.h:65-88)."""
    with open(filename, "rb") as f:
        head = f.read(8)
    if len(head) == 8:
        fid, size = struct.unpack("<II", head)
        if fid == DVECTOR_FILE_ID and size == 4:
            with open(filename, "rb") as f:
                _, _, dim = struct.unpack("<III", f.read(12))
                idx = np.frombuffer(f.read(dim * 4), dtype="<u4")
            if dim != expected_rows:
                raise ValueError(f"{filename}: {dim} join entries for "
                                 f"{expected_rows} data rows")
            return idx.astype(np.int64)
    idx = np.loadtxt(filename, dtype=np.int64).reshape(-1)
    if idx.shape[0] != expected_rows:
        raise ValueError(f"{filename}: {idx.shape[0]} join entries for "
                         f"{expected_rows} data rows")
    return idx


def build_joined_meta(meta_main: DataMetaInfo,
                      relations: list[RelationData]) -> DataMetaInfo:
    """Joined attribute->group map with per-relation offsets
    (libfm.cpp:211-256).  Also assigns each relation's attr_offset."""
    num_all = meta_main.num_attributes
    for rel in relations:
        rel.attr_offset = num_all
        num_all += rel.num_features
    groups = np.zeros(num_all, np.int32)
    groups[: meta_main.num_attributes] = meta_main.attr_group
    gc = meta_main.num_attr_groups
    at = meta_main.num_attributes
    for rel in relations:
        groups[at: at + rel.num_features] = rel.meta.attr_group + gc
        gc += rel.meta.num_attr_groups
        at += rel.num_features
    out = DataMetaInfo(num_all)
    out.set_groups(groups)
    return out


def join_relations(main: COOData, relations: list[RelationData],
                   joins: list[np.ndarray],
                   num_main_attributes: Optional[int] = None) -> COOData:
    """Materialise the relational join: each data row's features become its
    own features plus the offset-shifted features of each joined relation
    row.  ``attr_offset`` on each relation must be set (build_joined_meta)."""
    if len(relations) != len(joins):
        raise ValueError(f"{len(relations)} relations, {len(joins)} joins")
    D_main = num_main_attributes or main.num_features
    rows = [main.row]
    cols = [main.col]
    vals = [main.val]
    D_total = D_main
    for rel, join in zip(relations, joins):
        if rel.attr_offset < D_main:
            raise ValueError("call build_joined_meta first")
        # CSR pointers for the relation table
        cnt = np.bincount(rel.row, minlength=rel.num_rows)
        ptr = np.zeros(rel.num_rows + 1, dtype=np.int64)
        np.cumsum(cnt, out=ptr[1:])
        order = np.argsort(rel.row, kind="stable")
        rc = rel.col[order]
        rv = rel.val[order]
        # expand: for data row n joined to relation row j, append j's entries
        j = join.astype(np.int64)
        sizes = cnt[j]
        out_rows = np.repeat(np.arange(main.num_rows, dtype=np.int32), sizes)
        starts = ptr[j]
        flat = (np.repeat(starts, sizes)
                + (np.arange(sizes.sum(), dtype=np.int64)
                   - np.repeat(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                               sizes)))
        rows.append(out_rows)
        cols.append((rc[flat] + rel.attr_offset).astype(np.int32))
        vals.append(rv[flat])
        D_total = max(D_total, rel.attr_offset + rel.num_features)
    return COOData(
        row=np.concatenate(rows), col=np.concatenate(cols),
        val=np.concatenate(vals).astype(np.float32),
        target=main.target, num_rows=main.num_rows, num_features=D_total)
