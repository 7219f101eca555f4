"""K6: online VB v column statistics + natural-gradient blend
(``csrc/ovb_sweep.cu``).

``ovb_col_stats_update`` takes every degree bucket of one bin of one
factor block in one launch, from the bin's ``BinPlan`` (built once per
chunk membership): the per-column, per-factor statistics v_mean and v_sig
from the row caches (e [N], q/tq [N, F]) and the PRE-BIN mu/sig in
channels 0..2F-1 of the bin's patch table ``ptab`` [D, 5F]; the blend of
the naturals with the per-column rate ``rho_v`` [D]; and its writes, in
place: mu/sig/eta1/eta2 [D, F] at the bin's columns, ptab's delta channels
(dmu, dsig, dmu2), ``tv_add[col] += cnt`` and the int32 [4] counter
``bad`` (nan mu, inf mu, nan sig, inf sig candidates).  A column with
cnt == 0 leaves all four tables untouched and gets zero deltas.  On CUDA
tensors the op launches the hand-written kernel; on CPU tensors it runs
the plain PyTorch twin of each bucket, ``ovb_col_stats_update_plain``, in
the plan's order.

Replaces the bucket body of ``svbfm_tpu/learners/vb_online.py:ovb_v_block``
(:512-559) and of its F = 1 flat form ``ovb_v_factor`` (:598).

``tp_ovb_stats`` and ``tp_ovb_blend`` (T9) split K6 around the
feature-sharded OVB's data all-reduce (``parallel/tp_ovb.py``, F = 1, the
factor-sequential v sweep): the bin's per-column sums (v_mean, v_sig
before the division by cnt) over the data shard's rows into one
[C_bin, 2] buffer, each bucket's columns at its offset, q and tq read from
T2's qt [N, 3]; then, from the all-reduced sums, K6's ending step at the
bin's columns, reading no rows.  Padding columns (local id D_loc) get zero
sums and are not updated.  Replaces ``svbfm_tpu/parallel/tp_ovb.py:
tp_ovb_chunk_update``'s v bucket body (:290-338).

``dp_ovb_stats`` and ``dp_ovb_blend`` (T13) split K6 the same way at any
F, around the data-parallel OVB's data all-reduce (``learners/
vb_online.py`` on a data mesh): the stats read K2's separate q and tq
[N, F] and return the bin's [C_bin, 2F] sums (v_mean's F, then v_sig's
F); the blend writes what K6 writes, at the block's F.  Replaces the
psums of ``svbfm_tpu/learners/vb_online.py`` :531-532 (a v block at
F > 1) and :660-661 (the factor-sequential sweep at F = 1).  T9's twins
are T13's at F = 1.
"""

from __future__ import annotations

import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.kernels.w_sweep import _real, count_candidates
from svbfm_tpu_torch.learners.base import keep_finite

_I32, _F32 = torch.int32, torch.float32


def _v_sums(rows, x, cols, e, q, tq, ptab, F: int):
    """K6's per-column sums of a [C, L] bucket before the division by cnt:
    (sum x h (e + x mu h), sum x^2 h h + x^2 h1), each [C, F], from the
    pre-bin mu/sig in channels 0..2F-1 of ``ptab``."""
    C, L = rows.shape
    prow = ptab.index_select(0, cols)
    mu_c, sig_c = prow[:, :F], prow[:, F:2 * F]
    ridx = rows.reshape(-1)
    e_g = e.index_select(0, ridx).reshape(C, L, 1)
    q_g = q.index_select(0, ridx).reshape(C, L, F)
    tq_g = tq.index_select(0, ridx).reshape(C, L, F)
    xb = x[:, :, None]
    x2 = xb * xb
    mu_b = mu_c[:, None, :]
    h = q_g - xb * mu_b
    h1 = tq_g - x2 * sig_c[:, None, :]
    return ((xb * h * (e_g + xb * mu_b * h)).sum(1),
            (x2 * h * h + x2 * h1).sum(1))


def ovb_col_stats_update_plain(rows, x, cols, group, cnt, col_count, e, q, tq,
                               ptab, mu_t, sig_t, nmu_t, nsig_t, sv, alpha,
                               rho_v, tv_add, bad) -> None:
    F = mu_t.shape[1]
    vm, vs = _v_sums(rows, x, cols, e, q, tq, ptab, F)
    _v_blend(vm, vs, cols, group, cnt, col_count, ptab, mu_t, sig_t, nmu_t,
             nsig_t, sv, alpha, rho_v, tv_add, bad)


def _v_blend(vm, vs, cols, group, cnt, col_count, ptab, mu_t, sig_t, nmu_t,
             nsig_t, sv, alpha, rho_v, tv_add, bad) -> None:
    """K6's ending step at ``cols`` from their sums ``vm``/``vs`` [C, F]:
    the division by max(cnt, 1), the blend, the four tables, ptab's deltas,
    ``tv_add`` (None: not counted) and ``bad``, in place."""
    F = mu_t.shape[1]
    cl = cols.long()
    prow = ptab.index_select(0, cols)
    mu_c, sig_c = prow[:, :F], prow[:, F:2 * F]
    active = (cnt > 0)[:, None]
    cnt1 = torch.clamp(cnt, min=1.0)[:, None]
    v_mean = vm / cnt1
    v_sig = vs / cnt1
    rho = rho_v[cl][:, None]
    cc = col_count[:, None]
    nmu_c, nsig_c = nmu_t[cl], nsig_t[cl]
    nsig_new = (1.0 - rho) * nsig_c + rho * (sv.index_select(0, group)
                                             + alpha * cc * v_sig)
    nmu_new = (1.0 - rho) * nmu_c + rho * cc * alpha * v_mean
    zero = torch.zeros((), dtype=_F32, device=vm.device)
    mu_cand, sig_cand = nmu_new / nsig_new, 1.0 / nsig_new
    count_candidates(bad, torch.where(active, mu_cand, zero),
                     torch.where(active, sig_cand, zero))
    mu_new = torch.where(active, keep_finite(mu_cand, mu_c), mu_c)
    sig_new = torch.where(active, keep_finite(sig_cand, sig_c), sig_c)
    mu_t[cl] = mu_new
    sig_t[cl] = sig_new
    nmu_t[cl] = torch.where(active, nmu_new, nmu_c)
    nsig_t[cl] = torch.where(active, nsig_new, nsig_c)
    ptab[cl, 2 * F:3 * F] = mu_new - mu_c
    ptab[cl, 3 * F:4 * F] = sig_new - sig_c
    ptab[cl, 4 * F:5 * F] = mu_new * mu_new - mu_c * mu_c
    if tv_add is not None:
        tv_add.index_add_(0, cols, torch.where(active[:, 0], cnt, zero))


# the kernel's threads a block and plan columns (csrc/ovb_sweep.cu)
_THREADS = 256


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def col_lanes(F: int, L: int) -> int:
    """U, the lanes K6 gives a column of a bucket of L slots at F factors:
    FL factor lanes (the next power of two >= F, at most 32) times S entry
    slots (the next power of two >= L), at most 32
    (``csrc/ovb_sweep.cu:col_lanes``)."""
    fl = _pow2_at_least(min(F, 32))
    return min(32, fl * _pow2_at_least(min(max(L, 1), 32)))


def bucket_blocks(C: int, F: int, L: int) -> int:
    """The blocks of a [C, L] bucket in K6's launch at F factors."""
    return -(-C * col_lanes(F, L) // _THREADS)


class BinPlan:
    """K6's plan of one bin: its buckets (each with ``rows``, ``x`` [C, L],
    ``cols``, ``group``, ``cnt``, ``col_count`` [C]) and the int64 table
    [nb, 8] the kernel reads, a row a bucket: the six tensors' addresses,
    C and L, on the buckets' device (an empty bin's, never launched, on
    the CPU).  Built once per set of buckets (an OVB chunk's membership),
    which it keeps alive; the buckets' checks run here, once.  ``put``
    copies the table to the buckets' device (a streamed chunk's side-stream
    upload); by default it is copied at once."""

    def __init__(self, buckets, put=None):
        self.buckets = tuple(buckets)
        dev = self.buckets[0].rows.device if self.buckets else "cpu"
        for i, b in enumerate(self.buckets):
            C, L = b.rows.shape
            req = build.require
            req(b.rows, _I32, (C, L), dev, f"bin_plan.rows[{i}]")
            req(b.x, _F32, (C, L), dev, f"bin_plan.x[{i}]")
            for name, dt in (("cols", _I32), ("group", _I32), ("cnt", _F32),
                             ("col_count", _F32)):
                req(getattr(b, name), dt, (C,), dev, f"bin_plan.{name}[{i}]")
        self.rows = tuple(
            (b.rows.data_ptr(), b.x.data_ptr(), b.cols.data_ptr(),
             b.group.data_ptr(), b.cnt.data_ptr(), b.col_count.data_ptr())
            + tuple(b.rows.shape) for b in self.buckets)
        table = torch.tensor(self.rows, dtype=torch.int64).reshape(
            len(self.rows), 8)
        # ``put``: a streamed chunk's upload (learners/streaming.py), which
        # stages the table with the chunk's arrays, without waiting for the
        # card
        on_card = torch.device(dev).type == "cuda"
        self.table = (put(table) if put is not None and on_card
                      else table.to(dev))
        self._blocks = {}

    def blocks(self, F: int) -> int:
        """The launch's blocks at F factors: the buckets' laid end to
        end."""
        n = self._blocks.get(F)
        if n is None:
            n = sum(bucket_blocks(C, F, L) for *_, C, L in self.rows)
            self._blocks[F] = n
        return n

    @property
    def num_cols(self) -> int:
        """C_bin, the bin's columns: the rows of T9's sums."""
        return sum(C for *_, C, _L in self.rows)

    def blend_blocks(self, F: int = 1) -> int:
        """The blend launch's blocks at F factors (T9: F = 1): FL threads
        a column (``col_lanes`` at L = 1), each bucket's ceil(C FL / 256)
        laid end to end."""
        fl = col_lanes(F, 1)
        return sum(-(-C * fl // _THREADS) for *_, C, _L in self.rows)


def ovb_bin_update_plain(plan: BinPlan, e, q, tq, ptab, mu_t, sig_t, nmu_t,
                         nsig_t, sv, alpha, rho_v, tv_add, bad) -> None:
    """The twin of one bin: each bucket's, in the plan's order."""
    for b in plan.buckets:
        ovb_col_stats_update_plain(
            b.rows, b.x, b.cols, b.group, b.cnt, b.col_count, e, q, tq, ptab,
            mu_t, sig_t, nmu_t, nsig_t, sv, alpha, rho_v, tv_add, bad)


def ovb_col_stats_update(plan: BinPlan, e, q, tq, ptab, mu_t, sig_t, nmu_t,
                         nsig_t, sv, alpha, rho_v, tv_add, bad) -> None:
    """Every bucket of the bin ``plan`` in one launch."""
    if build.on_cpu(e):
        return ovb_bin_update_plain(plan, e, q, tq, ptab, mu_t, sig_t, nmu_t,
                                    nsig_t, sv, alpha, rho_v, tv_add, bad)
    D, F = mu_t.shape
    N = e.shape[0]
    dev = e.device
    req = build.require
    blocks = plan.blocks(F) if F > 0 else 0
    if blocks and plan.table.device != dev:
        raise ValueError(f"ovb_col_stats_update.plan: on {plan.table.device}"
                         f", expected {dev}")
    req(e, _F32, (N,), dev, "ovb_col_stats_update.e")
    req(q, _F32, (N, F), dev, "ovb_col_stats_update.q")
    req(tq, _F32, (N, F), dev, "ovb_col_stats_update.tq")
    req(ptab, _F32, (D, 5 * F), dev, "ovb_col_stats_update.ptab")
    for name, a in (("mu_t", mu_t), ("sig_t", sig_t), ("nmu_t", nmu_t),
                    ("nsig_t", nsig_t)):
        req(a, _F32, (D, F), dev, f"ovb_col_stats_update.{name}")
    req(sv, _F32, (sv.shape[0], F), dev, "ovb_col_stats_update.sv")
    req(alpha, _F32, (), dev, "ovb_col_stats_update.alpha")
    req(rho_v, _F32, (D,), dev, "ovb_col_stats_update.rho_v")
    req(tv_add, _F32, (D,), dev, "ovb_col_stats_update.tv_add")
    req(bad, _I32, (4,), dev, "ovb_col_stats_update.bad")
    if blocks == 0:
        return
    lib = build.load_library("ovb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_ovb_col_stats_update(
            build.ptr(plan.table), len(plan.rows), blocks, build.ptr(e),
            build.ptr(q), build.ptr(tq), F, build.ptr(ptab), build.ptr(mu_t),
            build.ptr(sig_t), build.ptr(nmu_t), build.ptr(nsig_t),
            build.ptr(sv), build.ptr(alpha), build.ptr(rho_v),
            build.ptr(tv_add), build.ptr(bad), build.stream_of(e))
    build.check_launch(lib, rc, "ovb_col_stats_update")


# ---- T9: K6 split around the feature-sharded OVB's data all-reduce ----------

def tp_ovb_stats_plain(plan: BinPlan, D_loc: int, e, qt,
                       ptab) -> torch.Tensor:
    """T9's stats twin: T13's at F = 1, q and tq columns 0 and 1 of ``qt``
    [N, 3]."""
    return dp_ovb_stats_plain(plan, D_loc, e, qt[:, :1], qt[:, 1:2], ptab)


def tp_ovb_stats(plan: BinPlan, D_loc: int, e, qt, ptab) -> torch.Tensor:
    """T9, stats launch: every bucket of the bin in one launch; returns the
    sums [C_bin, 2] (kernel on CUDA tensors, twin on CPU tensors)."""
    if build.on_cpu(e):
        return tp_ovb_stats_plain(plan, D_loc, e, qt, ptab)
    N = e.shape[0]
    dev = e.device
    req = build.require
    req(e, _F32, (N,), dev, "tp_ovb_stats.e")
    req(qt, _F32, (N, 3), dev, "tp_ovb_stats.qt")
    req(ptab, _F32, (D_loc, 5), dev, "tp_ovb_stats.ptab")
    blocks = plan.blocks(1)
    if blocks and plan.table.device != dev:
        raise ValueError(f"tp_ovb_stats.plan: on {plan.table.device}, "
                         f"expected {dev}")
    sums = torch.empty(plan.num_cols, 2, dtype=_F32, device=dev)
    if blocks == 0:
        return sums
    lib = build.load_library("ovb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_ovb_stats(
            build.ptr(plan.table), len(plan.rows), blocks, build.ptr(e),
            build.ptr(qt), build.ptr(ptab), build.ptr(sums), D_loc,
            build.stream_of(e))
    build.check_launch(lib, rc, "tp_ovb_stats")
    return sums


def tp_ovb_blend_plain(plan: BinPlan, D_loc: int, sums, ptab, mu_t, sig_t,
                       nmu_t, nsig_t, sv, alpha, rho_v, tv_add, bad) -> None:
    """T9's blend twin: T13's at F = 1."""
    dp_ovb_blend_plain(plan, D_loc, sums, ptab, mu_t, sig_t, nmu_t, nsig_t,
                       sv, alpha, rho_v, tv_add, bad)


def tp_ovb_blend(plan: BinPlan, D_loc: int, sums, ptab, mu_t, sig_t, nmu_t,
                 nsig_t, sv, alpha, rho_v, tv_add, bad) -> None:
    """T9, blend launch (reads ``sums``, no rows), a thread a column; in
    place on the [D_loc, 1] tables, ptab's deltas, ``tv_add`` (None: not
    counted) and ``bad``."""
    if build.on_cpu(sums):
        return tp_ovb_blend_plain(plan, D_loc, sums, ptab, mu_t, sig_t,
                                  nmu_t, nsig_t, sv, alpha, rho_v, tv_add,
                                  bad)
    dev = sums.device
    req = build.require
    req(sums, _F32, (plan.num_cols, 2), dev, "tp_ovb_blend.sums")
    req(ptab, _F32, (D_loc, 5), dev, "tp_ovb_blend.ptab")
    for name, a in (("mu_t", mu_t), ("sig_t", sig_t), ("nmu_t", nmu_t),
                    ("nsig_t", nsig_t)):
        req(a, _F32, (D_loc, 1), dev, f"tp_ovb_blend.{name}")
    req(sv, _F32, (sv.shape[0], 1), dev, "tp_ovb_blend.sv")
    req(alpha, _F32, (), dev, "tp_ovb_blend.alpha")
    req(rho_v, _F32, (D_loc,), dev, "tp_ovb_blend.rho_v")
    if tv_add is not None:
        req(tv_add, _F32, (D_loc,), dev, "tp_ovb_blend.tv_add")
    req(bad, _I32, (4,), dev, "tp_ovb_blend.bad")
    blocks = plan.blend_blocks()
    if blocks and plan.table.device != dev:
        raise ValueError(f"tp_ovb_blend.plan: on {plan.table.device}, "
                         f"expected {dev}")
    if blocks == 0:
        return
    lib = build.load_library("ovb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_ovb_blend(
            build.ptr(plan.table), len(plan.rows), blocks, build.ptr(sums),
            D_loc, build.ptr(ptab), build.ptr(mu_t), build.ptr(sig_t),
            build.ptr(nmu_t), build.ptr(nsig_t), build.ptr(sv),
            build.ptr(alpha), build.ptr(rho_v),
            None if tv_add is None else build.ptr(tv_add), build.ptr(bad),
            build.stream_of(sums))
    build.check_launch(lib, rc, "tp_ovb_blend")


# ---- T13: K6 split at any F around the data-parallel OVB's all-reduce -----

def dp_ovb_stats_plain(plan: BinPlan, D_loc: int, e, q, tq,
                       ptab) -> torch.Tensor:
    """T13's stats twin: the bin's sums [C_bin, 2F] = (v_mean's F, v_sig's
    F, before the division by cnt) of each bucket's columns over this data
    shard's rows, the buckets laid end to end; a padding column's (id
    D_loc) row is zero."""
    F = q.shape[1]
    out = []
    zero = torch.zeros((), dtype=_F32, device=e.device)
    for b in plan.buckets:
        real = _real(b, D_loc)
        cl = torch.where(real, b.cols, torch.zeros_like(b.cols))
        vm, vs = _v_sums(b.rows, b.x, cl, e, q, tq, ptab, F)
        out.append(torch.where(real[:, None], torch.cat([vm, vs], 1), zero))
    if not out:
        return torch.zeros(0, 2 * F, dtype=_F32, device=e.device)
    return torch.cat(out)


def dp_ovb_stats(plan: BinPlan, D_loc: int, e, q, tq, ptab) -> torch.Tensor:
    """T13, stats launch: every bucket of the bin in one launch, at K6's
    lanes; returns the sums [C_bin, 2F] (kernel on CUDA tensors, twin on
    CPU tensors)."""
    if build.on_cpu(e):
        return dp_ovb_stats_plain(plan, D_loc, e, q, tq, ptab)
    N, F = q.shape
    dev = e.device
    req = build.require
    req(e, _F32, (N,), dev, "dp_ovb_stats.e")
    req(q, _F32, (N, F), dev, "dp_ovb_stats.q")
    req(tq, _F32, (N, F), dev, "dp_ovb_stats.tq")
    req(ptab, _F32, (ptab.shape[0], 5 * F), dev, "dp_ovb_stats.ptab")
    blocks = plan.blocks(F) if F > 0 else 0
    if blocks and plan.table.device != dev:
        raise ValueError(f"dp_ovb_stats.plan: on {plan.table.device}, "
                         f"expected {dev}")
    sums = torch.empty(plan.num_cols, 2 * F, dtype=_F32, device=dev)
    if blocks == 0:
        return sums
    lib = build.load_library("ovb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_dp_ovb_stats(
            build.ptr(plan.table), len(plan.rows), blocks, build.ptr(e),
            build.ptr(q), build.ptr(tq), F, build.ptr(ptab), build.ptr(sums),
            D_loc, build.stream_of(e))
    build.check_launch(lib, rc, "dp_ovb_stats")
    return sums


def dp_ovb_blend_plain(plan: BinPlan, D_loc: int, sums, ptab, mu_t, sig_t,
                       nmu_t, nsig_t, sv, alpha, rho_v, tv_add, bad) -> None:
    """T13's blend twin: K6's ending step at each real column of the bin
    from its row of the all-reduced ``sums`` [C_bin, 2F], in place as K6's
    twin (``tv_add`` None: not counted)."""
    F = mu_t.shape[1]
    at = 0
    for b in plan.buckets:
        C = b.cols.shape[0]
        real = _real(b, D_loc)
        part = sums[at:at + C][real]
        at += C
        _v_blend(part[:, :F], part[:, F:], b.cols[real], b.group[real],
                 b.cnt[real], b.col_count[real], ptab, mu_t, sig_t, nmu_t,
                 nsig_t, sv, alpha, rho_v, tv_add, bad)


def dp_ovb_blend(plan: BinPlan, D_loc: int, sums, ptab, mu_t, sig_t, nmu_t,
                 nsig_t, sv, alpha, rho_v, tv_add, bad) -> None:
    """T13, blend launch (reads ``sums``, no rows), FL threads a column; in
    place on the [D, F] tables, ptab's deltas, ``tv_add`` (None: not
    counted) and ``bad``."""
    if build.on_cpu(sums):
        return dp_ovb_blend_plain(plan, D_loc, sums, ptab, mu_t, sig_t,
                                  nmu_t, nsig_t, sv, alpha, rho_v, tv_add,
                                  bad)
    D, F = mu_t.shape
    dev = sums.device
    req = build.require
    req(sums, _F32, (plan.num_cols, 2 * F), dev, "dp_ovb_blend.sums")
    req(ptab, _F32, (D, 5 * F), dev, "dp_ovb_blend.ptab")
    for name, a in (("mu_t", mu_t), ("sig_t", sig_t), ("nmu_t", nmu_t),
                    ("nsig_t", nsig_t)):
        req(a, _F32, (D, F), dev, f"dp_ovb_blend.{name}")
    req(sv, _F32, (sv.shape[0], F), dev, "dp_ovb_blend.sv")
    req(alpha, _F32, (), dev, "dp_ovb_blend.alpha")
    req(rho_v, _F32, (D,), dev, "dp_ovb_blend.rho_v")
    if tv_add is not None:
        req(tv_add, _F32, (D,), dev, "dp_ovb_blend.tv_add")
    req(bad, _I32, (4,), dev, "dp_ovb_blend.bad")
    blocks = plan.blend_blocks(F) if F > 0 else 0
    if blocks and plan.table.device != dev:
        raise ValueError(f"dp_ovb_blend.plan: on {plan.table.device}, "
                         f"expected {dev}")
    if blocks == 0:
        return
    lib = build.load_library("ovb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_dp_ovb_blend(
            build.ptr(plan.table), len(plan.rows), blocks, build.ptr(sums),
            F, D_loc, build.ptr(ptab), build.ptr(mu_t), build.ptr(sig_t),
            build.ptr(nmu_t), build.ptr(nsig_t), build.ptr(sv),
            build.ptr(alpha), build.ptr(rho_v),
            None if tv_add is None else build.ptr(tv_add), build.ptr(bad),
            build.stream_of(sums))
    build.check_launch(lib, rc, "dp_ovb_blend")
