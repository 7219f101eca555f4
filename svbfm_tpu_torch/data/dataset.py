"""Sparse data layouts for factorization machines (host-side numpy).

A copy of ``svbfm_tpu.data.dataset``, kept array-for-array identical
(``tests/test_torch_data.py`` holds the two to equality): the port must not
import the JAX package.  The layouts were designed for the TPU; the port's
CUDA kernels read them as they are.

Two layouts, both static-shaped (XLA requirement):

1. **Row layout** — ``ids[N, P] int32`` / ``vals[N, P] f32`` padded to the max
   row nnz ``P`` (pad id 0 with value 0; every kernel multiplies by the value,
   so zero-padding is inert).  Used for forward scoring, SGD, and the per-row
   e/q/t cache recomputations.  This is the TPU-native replacement for the
   reference's in-memory CSR (``src/util/fmatrix.h:235-254``).

2. **SweepPlan (column layout)** — the replacement for the reference's CSC
   transpose + serial per-column Gauss-Seidel sweeps
   (``fm_learn_vb.h:383-501``, ``fm_learn_mcmc.h:411-623``).  Columns are
   partitioned into *conflict-free bins*: no two columns in a bin co-occur in
   any row, so all columns of a bin can be updated simultaneously with
   *exactly* the sequential semantics (their residual updates touch disjoint
   rows).  For one-hot field data (all the paper's benchmarks) the bins are
   the fields and the sweep order matches the reference's ascending-id order.
   Per-bin arrays are sorted by column id so per-column sufficient statistics
   are sorted-segment reductions; residual updates are unique-index scatters
   (i.e. permutations), which XLA lowers efficiently on TPU.

Both layouts shard over the ``data`` axis of a mesh: rows (and therefore bin
entries) are partitioned by shard; per-column statistics become local
segment-sums followed by ``psum`` over the data axis.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from svbfm_tpu_torch.data.libfm_text import COOData


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class SparseDataset:
    """Padded row-layout dataset (host-side numpy; moved to device lazily)."""

    ids: np.ndarray  # int32 [N, P]
    vals: np.ndarray  # float32 [N, P]
    target: np.ndarray  # float32 [N]
    num_rows: int  # true number of rows (<= ids.shape[0] after padding)
    num_features: int
    min_target: float
    max_target: float
    row_nnz: np.ndarray  # int32 [N]

    @property
    def max_row_nnz(self) -> int:
        return int(self.ids.shape[1])

    @staticmethod
    def from_coo(coo: COOData, num_features: Optional[int] = None, pad_rows_to: int = 1) -> "SparseDataset":
        D = coo.num_features if num_features is None else num_features
        N = coo.num_rows
        nnz_per_row = coo.row_nnz()
        P = max(int(nnz_per_row.max()) if N else 1, 1)
        N_pad = _ceil_to(max(N, 1), pad_rows_to)
        ids = np.zeros((N_pad, P), dtype=np.int32)
        vals = np.zeros((N_pad, P), dtype=np.float32)
        # stable sort by row keeps within-row (file) order, matching the
        # reference's per-row entry order
        order = np.argsort(coo.row, kind="stable")
        r, c, v = coo.row[order], coo.col[order], coo.val[order]
        # position within row
        ptr = np.zeros(N + 1, dtype=np.int64)
        np.cumsum(nnz_per_row, out=ptr[1:])
        pos = np.arange(r.shape[0], dtype=np.int64) - ptr[r]
        ids[r, pos] = c
        vals[r, pos] = v
        target = np.zeros(N_pad, dtype=np.float32)
        target[:N] = coo.target
        row_nnz = np.zeros(N_pad, dtype=np.int32)
        row_nnz[:N] = nnz_per_row
        if N:
            tmin = float(coo.target.min())
            tmax = float(coo.target.max())
        else:
            tmin, tmax = 0.0, 0.0
        return SparseDataset(
            ids=ids, vals=vals, target=target, num_rows=N, num_features=D,
            min_target=tmin, max_target=tmax, row_nnz=row_nnz,
        )

    def to_coo(self) -> COOData:
        N, P = self.num_rows, self.ids.shape[1]
        mask = np.arange(P)[None, :] < self.row_nnz[:N, None]
        row = np.broadcast_to(np.arange(N, dtype=np.int32)[:, None], (N, P))[mask]
        return COOData(
            row=row.astype(np.int32),
            col=self.ids[:N][mask].astype(np.int32),
            val=self.vals[:N][mask].astype(np.float32),
            target=self.target[:N].copy(),
            num_rows=N,
            num_features=self.num_features,
        )

    def col_count(self) -> np.ndarray:
        """Occurrences of each column in the data (OVBFM col_count,
        reference ``fm_learn_vb_online.h:704-726``)."""
        mask = np.arange(self.ids.shape[1])[None, :] < self.row_nnz[:, None]
        return np.bincount(self.ids[mask].ravel(), minlength=self.num_features).astype(np.int32)

    def padded_to(self, n_shards: int) -> "SparseDataset":
        """Pad row count to a multiple of n_shards (for data-axis sharding).
        Never shrinks: an already over-padded dataset (e.g. streaming chunks
        padded to a common shape) keeps its row count."""
        N_pad = _ceil_to(max(self.num_rows, self.ids.shape[0], 1), n_shards)
        if N_pad == self.ids.shape[0]:
            return self
        def pad(a, n):
            out = np.zeros((n,) + a.shape[1:], dtype=a.dtype)
            out[: a.shape[0]] = a
            return out
        return SparseDataset(
            ids=pad(self.ids, N_pad)[:N_pad], vals=pad(self.vals, N_pad)[:N_pad],
            target=pad(self.target, N_pad)[:N_pad], num_rows=self.num_rows,
            num_features=self.num_features, min_target=self.min_target,
            max_target=self.max_target, row_nnz=pad(self.row_nnz, N_pad)[:N_pad],
        )


# bins="auto" runs greedy coloring up to this many nonzeros; beyond it the
# plan falls back to a single Jacobi bin WITH a loud warning (approximate
# simultaneous updates instead of exact Gauss-Seidel)
GREEDY_NNZ_CAP = 200_000_000


def assign_bins_greedy(coo: COOData, num_features: int) -> np.ndarray:
    """Conflict-free column coloring, processed in ascending column id.

    Two columns conflict iff they co-occur in some row.  Greedy smallest-
    available-color in ascending id order: for one-hot field data this
    recovers the fields exactly, and the (bin, ascending-id) sweep order then
    coincides with the reference's sequential 0..D-1 order restricted to
    conflict-free groups — giving *exact* Gauss-Seidel equivalence.
    """
    D = num_features
    color = np.full(D, -1, dtype=np.int32)
    # rows sorted by row id; iterate row-wise entry lists
    order = np.argsort(coo.row, kind="stable")
    r, c = coo.row[order], coo.col[order]
    nnz_per_row = np.bincount(coo.row, minlength=coo.num_rows)
    ptr = np.zeros(coo.num_rows + 1, dtype=np.int64)
    np.cumsum(nnz_per_row, out=ptr[1:])
    # column -> list of rows is implicit; we color by scanning columns in
    # ascending order and checking colors already used in each row touching
    # the column.  Build col->entries index:
    corder = np.argsort(c, kind="stable")
    cc, cr = c[corder], r[corder]
    cptr = np.zeros(D + 1, dtype=np.int64)
    np.cumsum(np.bincount(cc, minlength=D), out=cptr[1:])
    # per-row set of used colors, maintained as bitmask per row (small
    # #colors).  The outer loop is sequential by construction (greedy
    # coloring is order-dependent); the per-column entry scans are numpy
    # reductions, so the cost is O(D) Python + O(nnz) C.
    row_used = np.zeros(coo.num_rows, dtype=np.uint64)
    one = np.uint64(1)
    for col in range(D):
        lo, hi = cptr[col], cptr[col + 1]
        if lo == hi:
            color[col] = 0  # unobserved column: any bin (it has no entries)
            continue
        rows_c = cr[lo:hi]
        used = np.bitwise_or.reduce(row_used[rows_c])
        b = 0
        while used & (one << np.uint64(b)):
            b += 1
            if b >= 63:
                raise ValueError("greedy coloring needs >63 bins; use jacobi bins")
        color[col] = b
        # np.bitwise_or.at handles a row listed twice under one column
        np.bitwise_or.at(row_used, rows_c, one << np.uint64(b))
    return color


def assign_bins_jacobi(num_features: int) -> np.ndarray:
    """All columns in one bin (parallel Jacobi sweep; approximate)."""
    return np.zeros(num_features, dtype=np.int32)


def detect_field_bins(coo: COOData, num_features: int) -> Optional[np.ndarray]:
    """Fast path: if every row's k-th smallest column falls in the same
    contiguous id range across rows (classic one-hot field layout), the
    ranges are conflict-free bins.  Returns None when the structure doesn't
    hold; callers then fall back to greedy coloring."""
    if coo.nnz == 0 or coo.nnz % coo.num_rows != 0:
        return None
    k = coo.nnz // coo.num_rows
    # fast path: entries already row-major with uniform k and sorted columns
    # within each row (the common case from our loaders) — skip the lexsort
    row_view = coo.row.reshape(coo.num_rows, k)
    # a chunk is row-major only if ALL k entries carry the same row id (the
    # first/last check alone accepts interleaved non-row-major COO layouts)
    if (row_view == row_view[:, :1]).all() and \
            (row_view[:, 0] == np.arange(coo.num_rows, dtype=row_view.dtype)).all():
        cols = coo.col.reshape(coo.num_rows, k)
        if k > 1 and not (np.diff(cols, axis=1) > 0).all():
            cols = np.sort(cols, axis=1)
    else:
        nnz_per_row = np.bincount(coo.row, minlength=coo.num_rows)
        if (nnz_per_row != k).any():
            return None
        order = np.lexsort((coo.col, coo.row))
        cols = coo.col[order].reshape(coo.num_rows, k)
    # field p covers [max of field p-1 + 1 ... ]; check ranges are disjoint
    lo = cols.min(axis=0)
    hi = cols.max(axis=0)
    if not ((hi[:-1] < lo[1:]).all()):
        return None
    color = np.zeros(num_features, dtype=np.int32)
    bounds = np.concatenate([lo[1:], [num_features]])
    start = 0
    for p in range(k):
        color[start : bounds[p]] = p
        start = bounds[p]
    return color


@dataclass
class ColumnBlock:
    """One degree-bucket of one bin: a dense [C, L] view of its columns'
    entries, shard-stacked on axis 0.

    Per-column sufficient statistics become masked row-sums over the L axis
    (pure VPU reductions — no scatter/segment ops, which serialize on TPU).
    Padding entries carry x = 0 and a clipped row index, so every product
    with x vanishes.
    """

    rows: np.ndarray  # int32 [S, C, L] local row ids (pad: rows_per_shard-1)
    x: np.ndarray  # f32 [S, C, L] (pad: 0)
    cols: np.ndarray  # int32 [C] global column ids, ascending
    group: np.ndarray  # int32 [C]
    sx2: np.ndarray  # f32 [C] global sum of x^2
    cnt: np.ndarray  # f32 [C] global entry count in this data
    col_count: np.ndarray  # f32 [C] full-data occurrence count


@dataclass
class SweepPlan:
    """Gather-only data layout for vectorized coordinate sweeps.

    ``blocks[b]`` is the list of degree-bucketed :class:`ColumnBlock`s of
    conflict-free bin ``b``.  A sweep processes bins sequentially (preserving
    the reference's Gauss-Seidel semantics — columns of one bin touch
    disjoint rows) and all columns of a bin's buckets simultaneously:

      1. per-column stats  = masked row-sums over each block's [C, L] entries
                             (+ psum over the data axis),
      2. parameter updates = tiny [C]-sized scatters into the dense tables,
      3. residual-cache patches = ONE row-layout pass per bin, gathering the
         per-column deltas through the padded [N, P] id arrays (deltas are 0
         for out-of-bin columns, so no membership masks are needed).

    Step 3 is exact for conflict-free bins (each row has at most one in-bin
    entry) and degrades to a Jacobi sweep when ``conflict_free`` is False.
    """

    blocks: list  # list[list[ColumnBlock]]
    num_bins: int
    num_features: int
    rows_per_shard: int
    unobserved: np.ndarray  # bool [D] columns with no entries in the data
    color: np.ndarray  # int32 [D] bin of each column
    conflict_free: bool = True

    @property
    def num_shards(self) -> int:
        for bucket in self.blocks:
            for blk in bucket:
                return int(blk.rows.shape[0])
        return 1

    _FIELDS = ("rows", "x", "cols", "group", "sx2", "cnt", "col_count")
    _MAGIC = b"SVBFMPLN"

    def save(self, path: str) -> None:
        """Persist the plan to one file (host preprocessing at 10M+ rows
        costs minutes; reuse across runs/processes): a JSON header of the
        scalars and of each array's dtype, shape and offset, then the
        arrays' bytes, each at a multiple of 64, so that ``load`` reads the
        file in one call and makes no more than a view an array (the JAX
        package's ``np.savez`` parses a zip member an array, 0.7 ms each,
        the most of a streamed chunk's read)."""
        arrays = [("unobserved", self.unobserved), ("color", self.color)]
        for b, bin_blocks in enumerate(self.blocks):
            for j, blk in enumerate(bin_blocks):
                arrays += [(f"blk_{b}_{j}_{f}", getattr(blk, f))
                           for f in self._FIELDS]
        table, off = [], 0
        for name, a in arrays:
            a = np.ascontiguousarray(a)
            table.append((name, a.dtype.str, list(a.shape), off))
            off += -(-a.nbytes // 64) * 64
        head = json.dumps(dict(
            num_bins=int(self.num_bins), num_features=int(self.num_features),
            rows_per_shard=int(self.rows_per_shard),
            conflict_free=bool(self.conflict_free),
            bin_sizes=[len(b) for b in self.blocks],
            arrays=table)).encode()
        start = -(-(len(self._MAGIC) + 8 + len(head)) // 64) * 64
        buf = bytearray(start + off)
        buf[:8] = self._MAGIC
        buf[8:16] = len(head).to_bytes(8, "little")
        buf[16:16 + len(head)] = head
        for (name, a), (_n, _d, _s, at) in zip(arrays, table):
            a = np.ascontiguousarray(a)
            buf[start + at:start + at + a.nbytes] = a.tobytes()
        with open(path, "wb") as f:
            f.write(buf)

    @staticmethod
    def load(path: str) -> "SweepPlan":
        with open(path, "rb") as f:
            buf = bytearray(f.read())
        if bytes(buf[:8]) != SweepPlan._MAGIC:
            raise ValueError(f"{path}: not a saved SweepPlan")
        n = int.from_bytes(buf[8:16], "little")
        head = json.loads(bytes(buf[16:16 + n]))
        start = -(-(16 + n) // 64) * 64
        z = {name: np.frombuffer(buf, dtype=np.dtype(dt),
                                 count=int(np.prod(shape)),
                                 offset=start + at).reshape(shape)
             for name, dt, shape, at in head["arrays"]}
        blocks = [[ColumnBlock(**{f: z[f"blk_{b}_{j}_{f}"]
                                  for f in SweepPlan._FIELDS})
                   for j in range(nb)]
                  for b, nb in enumerate(head["bin_sizes"])]
        return SweepPlan(
            blocks=blocks, num_bins=head["num_bins"],
            num_features=head["num_features"],
            rows_per_shard=head["rows_per_shard"],
            unobserved=z["unobserved"], color=z["color"],
            conflict_free=head["conflict_free"])

    @staticmethod
    def build(
        coo: COOData,
        num_features: int,
        meta_groups: Optional[np.ndarray] = None,
        bins: str = "auto",
        n_shards: int = 1,
        col_count: Optional[np.ndarray] = None,
        lane_pad: int = 8,
        n_rows_total: Optional[int] = None,
        forced_color: Optional[np.ndarray] = None,
        forced_conflict_free: bool = True,
    ) -> "SweepPlan":
        D = num_features
        conflict_free = True
        if forced_color is not None:
            # caller supplies a global coloring (the windowed out-of-core
            # path colors once from the full data so every window's bins
            # partition columns identically); trust its conflict_free claim
            color = np.asarray(forced_color, np.int32)
            conflict_free = forced_conflict_free
        elif bins == "auto":
            color = detect_field_bins(coo, D)
            if color is None:
                # greedy preprocessing is O(D) Python + O(nnz) numpy; cap it
                # to keep plan build bounded on huge general-sparse data
                if coo.nnz <= GREEDY_NNZ_CAP:
                    color = assign_bins_greedy(coo, D)
                else:
                    color = assign_bins_jacobi(D)
                    conflict_free = False
                    print("# WARNING: bins=auto fell back to a single Jacobi "
                          f"bin at nnz={coo.nnz} (> 2e8): sweeps update all "
                          "columns simultaneously (approximate, not exact "
                          "Gauss-Seidel).  Pass -bins greedy to force exact "
                          "conflict-free coloring, at preprocessing cost.",
                          flush=True)
        elif bins == "greedy":
            color = assign_bins_greedy(coo, D)
        elif bins == "jacobi":
            color = assign_bins_jacobi(D)
            conflict_free = False
        elif bins == "fields":
            color = detect_field_bins(coo, D)
            if color is None:
                raise ValueError("data has no one-hot field structure")
        else:
            raise ValueError(f"unknown bins mode {bins!r}")

        num_bins = int(color.max()) + 1 if D else 1
        groups = meta_groups if meta_groups is not None else np.zeros(D, np.int32)

        N_pad = _ceil_to(max(n_rows_total or coo.num_rows, 1), n_shards)
        rows_per_shard = N_pad // n_shards
        shard_of = (coo.row // rows_per_shard).astype(np.int64)
        local_row = (coo.row % rows_per_shard).astype(np.int32)

        observed = np.zeros(D, dtype=bool)
        observed[coo.col] = True

        if col_count is None:
            col_count_full = np.bincount(coo.col, minlength=D).astype(np.float32)
        else:
            col_count_full = col_count.astype(np.float32)

        # per-(shard, column) local entry counts and within-group positions
        key = shard_of * D + coo.col
        order = np.argsort(key, kind="stable")  # stable keeps file order
        key_s = key[order]
        grp_start = np.zeros(len(key_s), dtype=np.int64)
        if len(key_s):
            new_grp = np.concatenate([[True], key_s[1:] != key_s[:-1]])
            grp_idx = np.cumsum(new_grp) - 1
            starts = np.where(new_grp)[0]
            grp_start = starts[grp_idx]
        pos = np.arange(len(key_s), dtype=np.int64) - grp_start  # within (s,c)
        # local count per (shard, col): max over shards drives bucket size
        loc_cnt = np.zeros((n_shards, D), dtype=np.int64)
        np.add.at(loc_cnt, (shard_of, coo.col), 1)
        max_loc = loc_cnt.max(axis=0)  # [D]

        sx2_full = np.zeros(D, dtype=np.float64)
        np.add.at(sx2_full, coo.col, coo.val.astype(np.float64) ** 2)
        cnt_full = np.bincount(coo.col, minlength=D).astype(np.float32)

        col_s = coo.col[order]
        shard_s = shard_of[order]
        lrow_s = local_row[order]
        val_s = coo.val[order]

        blocks: list[list[ColumnBlock]] = []
        for b in range(num_bins):
            bin_blocks: list[ColumnBlock] = []
            cols_b = np.where((color == b) & observed)[0]
            if len(cols_b) == 0:
                blocks.append(bin_blocks)
                continue
            deg = max_loc[cols_b]
            # geometric degree buckets: L in {lane_pad, 2*lane_pad, ...}
            L = lane_pad
            remaining = np.ones(len(cols_b), dtype=bool)
            while remaining.any():
                in_bucket = remaining & (deg <= L)
                if in_bucket.any():
                    cb = cols_b[in_bucket].astype(np.int32)  # ascending
                    C = len(cb)
                    rows_arr = np.full((n_shards, C, L), rows_per_shard - 1,
                                       dtype=np.int32)
                    x_arr = np.zeros((n_shards, C, L), dtype=np.float32)
                    slot = np.full(D, -1, dtype=np.int64)
                    slot[cb] = np.arange(C)
                    sel = slot[col_s] >= 0
                    if sel.any():
                        s_i = shard_s[sel]
                        c_i = slot[col_s[sel]]
                        p_i = pos[sel]
                        rows_arr[s_i, c_i, p_i] = lrow_s[sel]
                        x_arr[s_i, c_i, p_i] = val_s[sel]
                    bin_blocks.append(ColumnBlock(
                        rows=rows_arr, x=x_arr, cols=cb,
                        group=groups[cb].astype(np.int32),
                        sx2=sx2_full[cb].astype(np.float32),
                        cnt=cnt_full[cb],
                        col_count=col_count_full[cb]))
                    remaining = remaining & ~in_bucket
                L *= 2
            blocks.append(bin_blocks)

        return SweepPlan(
            blocks=blocks, num_bins=num_bins, num_features=D,
            rows_per_shard=rows_per_shard, unobserved=~observed, color=color,
            conflict_free=conflict_free,
        )
