"""K2-K4: the batch VBFM factor-block sweep (``csrc/vb_sweep.cu``).

``vb_build_qt`` (K2) builds the row caches q, tq, tz, and ``build_q`` (X8d,
K2's q-only instantiation) the MCMC/ALS cache q alone, from a starting q
where one is given (``qt_plan``: the form, a thread a row at F = 1, lanes
over a row's chunks at F >= 2);
``vb_col_stats_update`` (K3) computes one degree bucket's per-column
statistics and applies the closed-form update (``col_stats_form``: lanes
over a column's slots, several columns a block, at F <= 4 on buckets of
L <= 128; else a block a column), and
``vb_col_stats_window`` (X13a, K3's window-accumulating mode) the same
over the windows of the out-of-core batch VB (``learners/vb_windowed.py``):
each window's sums added to an accumulator in window order, the update
applied at the last window; ``vb_patch_rows`` (K4)
patches the row caches after a bin; ``w_patch_rows`` is K4 at F = 0, the w
patch of the standalone linear-term sweep (VB) and of the MCMC w sweep.  On CUDA tensors each op launches its hand-written kernel; on CPU
tensors it runs the plain PyTorch twin beside it.  K3 and K4 update their
outputs in place, kernel and twin alike.

Layouts (see ``csrc/vb_sweep.cu``): row caches [N, F]; mu/sigma tables
[D, F]; the per-bin patch table ``ptab`` [D, CH] with channels
(mu_old, sig_old, dmu, dsig, dmu2 [, wdmu, wdsig]), CH = 5F (+2).

Replaces ``svbfm_tpu/learners/vb.py:vb_v_block_update`` → ``build_qt``
(:317), ``tile_stats`` + update (:382, :449-487), ``patch_tile`` (:508);
the w patch of ``vb_w_bin_update`` (:149-157) and of the online w sweep
(``svbfm_tpu/learners/vb_online.py``:270-282); the q builds of
``svbfm_tpu/learners/mcmc.py`` (:337-359, :824-826) and its w patch
(:653-656).
K2 and K4 also serve the online VB factor sweep (``learners/vb_online.py``;
``vb_patch_rows(..., sequential=False)``), and the windowed batch VB on a
window's rows of the resident caches (views: ``vb_build_qt(..., out=)``);
X8d the windowed Gibbs/ALS the same way (``build_q(..., out=)``).
X13a replaces ``svbfm_tpu/learners/vb_windowed.py``'s ``make_stats``
(:447-481) and ``make_draw`` (:483-518).  T2-T4 are the feature-sharded
batch VB's (``svbfm_tpu/parallel/tp_vb.py:tp_vb_update_all``): T2
``tp_build_qt`` the shard's q/tq/tz partials (:337-353), T3
``tp_col_stats`` + ``tp_col_update`` a bucket's column sums, then, after
the caller's data all-reduce, K3's closed form (:355-405), T4
``tp_patch_delta`` a bin's patch deltas against the pre-patch caches
(:407-453, at F = 0 :483-496).  T6 ``tp_build_q`` is T2's q-only mode,
the feature-sharded Gibbs/ALS block's q partials
(``svbfm_tpu/parallel/tp_mcmc.py:230-238``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.kernels.mcmc_sweep import lanes_block_cols
from svbfm_tpu_torch.learners.base import keep_finite, nonfinite

_I32, _F32 = torch.int32, torch.float32


# ---- K2 ---------------------------------------------------------------------

class QtPlan(NamedTuple):
    """K2's (and X8d's) form: "rows" (F = 1: a thread a row) or "chunks"
    (F >= 2: ``lanes`` lanes a row over chunks of ``vec`` factors, ``rows``
    rows a warp); ``build`` "p2" (rows of two positions) or "any"."""

    form: str
    vec: int
    lanes: int
    rows: int
    build: str


def qt_plan(F: int, P: int, ld: int, addrs: dict) -> QtPlan:
    """K2's form at F factors, rows of P positions, ptab's row stride ld and
    the operands' device addresses ``addrs`` (ptab, ids, vals, q0, q, tq,
    tz; 0 or absent for one not given), a function of F, P, ld and of
    alignment (``csrc/vb_sweep.cu:launch_qt``, ``qt_width``): at F = 1 a
    thread a row, the P = 2 build where ids and vals are 8-byte aligned; at
    F >= 2 the widest of 4, 2, 1 factors a chunk that divides F and ld and
    to whose size ptab, q0 and the caches are aligned, min(F / vec, 32)
    lanes a row (5 at F = 20 on a [D, 2F] table, 10 on K2's fast-mode
    [D, 5F + 2])."""
    a = {k: addrs.get(k, 0) for k in ("ptab", "ids", "vals", "q0", "q", "tq",
                                      "tz")}
    if F == 1:
        p2 = P == 2 and a["ids"] % 8 == 0 and a["vals"] % 8 == 0
        return QtPlan("rows", 1, 1, 32, "p2" if p2 else "any")
    vec = next((v for v in (4, 2) if F % v == 0 and ld % v == 0
                and all(a[k] % (4 * v) == 0
                        for k in ("ptab", "q0", "q", "tq", "tz"))), 1)
    lanes = min(F // vec, 32)
    return QtPlan("chunks", vec, lanes, 32 // lanes,
                  "p2" if P == 2 else "any")


def qt_plan_of(ptab, F: int, ids, vals, q0=None, caches=()) -> QtPlan:
    """``qt_plan`` for the tensors of one call; ``caches``: the q (tq, tz)
    it writes, whose addresses the wrapper allocates."""
    ts = dict(ptab=ptab, ids=ids, vals=vals, q0=q0,
              **dict(zip(("q", "tq", "tz"), caches)))
    return qt_plan(F, ids.shape[1], ptab.stride(0),
                   {k: t.data_ptr() for k, t in ts.items() if t is not None})


def vb_build_qt_plain(ptab, F: int, ids, vals):
    """q = sum_p mu x, tq = sum_p sig x^2, tz = sum_p mu^2 x^2, each [N, F],
    from channels 0..F-1 (mu) and F..2F-1 (sig) of ``ptab``."""
    N = ids.shape[0]
    q = torch.zeros(N, F, dtype=_F32, device=ptab.device)
    tq = torch.zeros_like(q)
    tz = torch.zeros_like(q)
    for p in range(ids.shape[1]):
        g = ptab.index_select(0, ids[:, p])
        xp = vals[:, p, None]
        x2p = xp * xp
        mug, sigg = g[:, :F], g[:, F:2 * F]
        q = q + mug * xp
        tq = tq + sigg * x2p
        tz = tz + mug * mug * x2p
    return q, tq, tz


def vb_build_qt(ptab, F: int, ids, vals, out: Optional[tuple] = None):
    """K2; ``out``: the (q, tq, tz) [N, F] tensors to write (the windowed
    learner's views of its resident caches), else new ones."""
    if build.on_cpu(ids):
        caches = vb_build_qt_plain(ptab, F, ids, vals)
        if out is None:
            return caches
        for o, c in zip(out, caches):
            o.copy_(c)
        return out
    N, P = ids.shape
    dev = ids.device
    if ptab.dim() != 2 or ptab.shape[1] < 2 * F:
        raise ValueError(f"vb_build_qt.ptab: shape {tuple(ptab.shape)} has "
                         f"fewer than 2F={2 * F} channels")
    build.require(ptab, _F32, ptab.shape, dev, "vb_build_qt.ptab")
    build.require(ids, _I32, (N, P), dev, "vb_build_qt.ids")
    build.require(vals, _F32, (N, P), dev, "vb_build_qt.vals")
    if out is None:
        q = torch.empty(N, F, dtype=_F32, device=dev)
        tq = torch.empty_like(q)
        tz = torch.empty_like(q)
    else:
        q, tq, tz = out
        for name, a in zip(("q", "tq", "tz"), out):
            build.require(a, _F32, (N, F), dev, f"vb_build_qt.{name}")
    if N * F == 0:
        return q.zero_(), tq.zero_(), tz.zero_()
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_vb_build_qt(
            build.ptr(ptab), ptab.shape[1], F, build.ptr(ids),
            build.ptr(vals), N, P, build.ptr(q), build.ptr(tq), build.ptr(tz),
            build.stream_of(ids))
    build.check_launch(lib, rc, "vb_build_qt")
    return q, tq, tz


# ---- X8d: K2's q channel alone ---------------------------------------------

def build_q_plain(ptab, F: int, ids, vals, q0=None):
    """q [N, F] = q0 + sum_p ptab[id, f] x over channels 0..F-1 of
    ``ptab``, the positions added onto q0 (0 where None) in order, as JAX
    adds them onto its ``q_extra`` (svbfm_tpu/learners/mcmc.py:337-347)."""
    q = (torch.zeros(ids.shape[0], F, dtype=_F32, device=ptab.device)
         if q0 is None else q0.clone())
    for p in range(ids.shape[1]):
        q = q + ptab.index_select(0, ids[:, p])[:, :F] * vals[:, p, None]
    return q


def build_q(ptab, F: int, ids, vals, q0=None, out=None):
    """X8d: q [N, F] from its starting value q0 [N, F] (None: 0);
    ``out``: the [N, F] tensor to write (the windowed learner's view of its
    resident cache), else a new one."""
    if build.on_cpu(ids):
        q = build_q_plain(ptab, F, ids, vals, q0)
        return q if out is None else out.copy_(q)
    N, P = ids.shape
    dev = ids.device
    if ptab.dim() != 2 or ptab.shape[1] < F:
        raise ValueError(f"build_q.ptab: shape {tuple(ptab.shape)} has "
                         f"fewer than F={F} channels")
    build.require(ptab, _F32, ptab.shape, dev, "build_q.ptab")
    build.require(ids, _I32, (N, P), dev, "build_q.ids")
    build.require(vals, _F32, (N, P), dev, "build_q.vals")
    if q0 is not None:
        build.require(q0, _F32, (N, F), dev, "build_q.q0")
    if out is None:
        q = torch.empty(N, F, dtype=_F32, device=dev)
    else:
        build.require(out, _F32, (N, F), dev, "build_q.out")
        q = out
    if N * F == 0:
        return q.zero_()
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_build_q(build.ptr(ptab), ptab.shape[1], F,
                               build.ptr(ids), build.ptr(vals), N, P,
                               None if q0 is None else build.ptr(q0),
                               build.ptr(q), build.stream_of(ids))
    build.check_launch(lib, rc, "build_q")
    return q


# ---- K3 ---------------------------------------------------------------------

#: K3's lanes form (``csrc/vb_sweep.cu:col_stats_lanes_kernel``): the
#: widest block and the longest bucket it takes (4 slots a lane, a warp)
STAT_LANES_MAX_F = 4
STAT_LANES_MAX_L = 128


def col_stats_lanes(C: int, L: int) -> int:
    """K3's lanes a column in its lanes form (``csrc/vb_sweep.cu:
    stat_lanes``): the next power of two >= L / 4 (L / 2 in a bucket of
    fewer than 2,048 columns), 8 to 32."""
    per = 2 if C < 2048 else 4
    U = 8
    while U < 32 and U * per < L:
        U *= 2
    return U


class StatsForm(NamedTuple):
    """K3's (and X13a's) form on a [C, L] bucket: "lanes" (``lanes`` a
    column, ``cols`` columns a block) or "block" (``warps`` a block,
    ``groups`` blocks a column over its factor chunks, ``lanes`` a slot);
    ``vec``: the floats of a q/tq load."""
    form: str
    lanes: int
    warps: int
    groups: int
    vec: int
    cols: int = 1


def col_stats_form(F: int, C: int, L: int, vec: int) -> StatsForm:
    """The form ``csrc/vb_sweep.cu``'s K3 and X13a entries launch for F
    factors on a [C, L] bucket, q and tq read ``vec`` floats a load
    (``col_stats_vec``): the lanes form at F <= 4 on L <= 128
    (``col_stats_lanes`` a column, ``mcmc_sweep.lanes_block_cols``
    columns a block); else ``launch_col_stats``' blocks: the F / vec chunks in groups
    of at most 8 (a block each), a slot a group's lanes, a round of 2
    entries a slot at vec = 4 (4 below) over enough warps to cover L, 1 to
    8, at least one thread for each value a slot sums."""
    if F <= STAT_LANES_MAX_F and L <= STAT_LANES_MAX_L:
        U = col_stats_lanes(C, L)
        cpb = lanes_block_cols(C, U)
        return StatsForm("lanes", U, -(-cpb * U // 32), 1, vec, cpb)
    G = F // vec
    ny = -(-G // 8)
    GT = -(-G // ny)
    SW = 32 // GT
    least = -(-GT * 2 * vec // 32)
    warps = min(8, max(least, -(-L // ((2 if vec == 4 else 4) * SW))))
    return StatsForm("block", GT, warps, ny, vec)


def col_stats_vec(F: int, q, tq) -> int:
    """The floats of K3's q/tq loads: the widest of 4, 2, 1 that divides F
    and to whose size both caches are aligned (``svbfm::chunk_width``)."""
    vec = 4 if F % 4 == 0 else 2 if F % 2 == 0 else 1
    a = q.data_ptr() | tq.data_ptr()
    while vec > 1 and a % (4 * vec):
        vec //= 2
    return vec


def _col_sums(rows, x, cols, e, q, tq, ptab, F: int):
    """One [C, L] bucket's per-column sums (vm, vs [C, F], sum x e [C]) from
    the row caches and the PRE-BIN mu/sig of ``ptab``."""
    C, L = rows.shape
    prow = ptab.index_select(0, cols)
    mu_c, sig_c = prow[:, :F], prow[:, F:2 * F]
    ridx = rows.reshape(-1)
    e_g = e.index_select(0, ridx).reshape(C, L)
    q_g = q.index_select(0, ridx).reshape(C, L, F)
    tq_g = tq.index_select(0, ridx).reshape(C, L, F)
    xb = x[:, :, None]
    mu_b, sig_b = mu_c[:, None, :], sig_c[:, None, :]
    h = q_g - xb * mu_b
    h1 = tq_g - xb * xb * sig_b
    vm = (xb * h * (e_g[:, :, None] + xb * mu_b * h)).sum(1)  # [C, F]
    vs = (xb * xb * (h * h + h1)).sum(1)
    sxe = (x * e_g).sum(1)  # [C]
    return vm, vs, sxe


def _col_update(vm, vs, cols, group, ptab, mu_t, sig_t, sv, alpha,
                nans) -> None:
    """K3's closed form (vb.py:449-469) from the column sums, in place on
    mu_t/sig_t and ptab's delta channels; nans[0] += the candidates that
    were not finite."""
    F = mu_t.shape[1]
    cl = cols.long()
    prow = ptab.index_select(0, cols)
    mu_c, sig_c = prow[:, :F], prow[:, F:2 * F]
    sig_cand = 1.0 / (sv.index_select(0, group) + alpha * vs)
    nan_v = nonfinite(sig_cand)
    sig_new = keep_finite(sig_cand, sig_c)
    mu_cand = sig_new * alpha * vm
    nan_v = nan_v + nonfinite(mu_cand)
    mu_new = keep_finite(mu_cand, mu_c)
    mu_t[cl] = mu_new
    sig_t[cl] = sig_new
    ptab[cl, 2 * F:3 * F] = mu_new - mu_c
    ptab[cl, 3 * F:4 * F] = sig_new - sig_c
    ptab[cl, 4 * F:5 * F] = mu_new * mu_new - mu_c * mu_c
    nans[0] += nan_v


def vb_col_stats_update_plain(rows, x, cols, group, sx2, e, q, tq, ptab,
                              mu_t, sig_t, sv, alpha, w, nans) -> None:
    """One [C, L] bucket: per-column statistics, the closed-form update,
    and its writes (in place).  ``w`` is (mu_w, sig_w_dash, sigma_w) for
    the merged linear-term rider, or None."""
    F = mu_t.shape[1]
    cl = cols.long()
    vm, vs, sxe = _col_sums(rows, x, cols, e, q, tq, ptab, F)
    _col_update(vm, vs, cols, group, ptab, mu_t, sig_t, sv, alpha, nans)

    if w is not None:
        mu_w, sig_w, sigma_w = w
        wmu_c, wsig_c = mu_w[cl], sig_w[cl]
        wsig_cand = 1.0 / (sigma_w.index_select(0, group) + alpha * sx2)
        wsig_new = keep_finite(wsig_cand, wsig_c)
        wmu_cand = wsig_new * alpha * (sxe + wmu_c * sx2)
        nans[1] += nonfinite(wsig_cand) + nonfinite(wmu_cand)
        wmu_new = keep_finite(wmu_cand, wmu_c)
        mu_w[cl] = wmu_new
        sig_w[cl] = wsig_new
        ptab[cl, 5 * F] = wmu_c - wmu_new
        ptab[cl, 5 * F + 1] = wsig_new - wsig_c


def vb_col_stats_update(rows, x, cols, group, sx2, e, q, tq, ptab, mu_t,
                        sig_t, sv, alpha, w: Optional[tuple], nans) -> None:
    if build.on_cpu(rows):
        return vb_col_stats_update_plain(rows, x, cols, group, sx2, e, q, tq,
                                         ptab, mu_t, sig_t, sv, alpha, w,
                                         nans)
    C, L = rows.shape
    D, F = mu_t.shape
    N = e.shape[0]
    CH = 5 * F + (2 if w is not None else 0)
    dev = rows.device
    req = build.require
    req(rows, _I32, (C, L), dev, "vb_col_stats_update.rows")
    req(x, _F32, (C, L), dev, "vb_col_stats_update.x")
    for name, a, dt in (("cols", cols, _I32), ("group", group, _I32),
                        ("sx2", sx2, _F32)):
        req(a, dt, (C,), dev, f"vb_col_stats_update.{name}")
    req(e, _F32, (N,), dev, "vb_col_stats_update.e")
    req(q, _F32, (N, F), dev, "vb_col_stats_update.q")
    req(tq, _F32, (N, F), dev, "vb_col_stats_update.tq")
    req(ptab, _F32, (D, CH), dev, "vb_col_stats_update.ptab")
    req(mu_t, _F32, (D, F), dev, "vb_col_stats_update.mu_t")
    req(sig_t, _F32, (D, F), dev, "vb_col_stats_update.sig_t")
    req(sv, _F32, (sv.shape[0], F), dev, "vb_col_stats_update.sv")
    req(alpha, _F32, (), dev, "vb_col_stats_update.alpha")
    req(nans, _I32, (2,), dev, "vb_col_stats_update.nans")
    if w is not None:
        mu_w, sig_w, sigma_w = w
        req(mu_w, _F32, (D,), dev, "vb_col_stats_update.mu_w")
        req(sig_w, _F32, (D,), dev, "vb_col_stats_update.sig_w")
        req(sigma_w, _F32, (sv.shape[0],), dev, "vb_col_stats_update.sigma_w")
        wp = (build.ptr(mu_w), build.ptr(sig_w), build.ptr(sigma_w))
    else:
        wp = (None, None, None)
    if C == 0 or F == 0:
        return
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_vb_col_stats_update(
            build.ptr(rows), build.ptr(x), C, L, build.ptr(cols),
            build.ptr(group), build.ptr(sx2), build.ptr(e), build.ptr(q),
            build.ptr(tq), F, build.ptr(ptab), CH, build.ptr(mu_t),
            build.ptr(sig_t), build.ptr(sv), build.ptr(alpha), *wp,
            build.ptr(nans), build.stream_of(rows))
    build.check_launch(lib, rc, "vb_col_stats_update")


# ---- X13a: K3 over the windows of the out-of-core batch VB -----------------

def vb_col_stats_window_plain(rows, x, cols, group, e, q, tq, ptab, mu_t,
                              sig_t, sv, alpha, nans, acc, first: bool,
                              last: bool) -> None:
    """One window's [C, L] view of a bucket (rows local to the window's
    caches e, q, tq): its column sums go into ``acc`` [C, 2F] (vm | vs),
    written at the first window and added to (acc + part) at the later
    ones; the last window applies K3's closed form to the accumulated
    sums.  One window (first and last) is K3 without the w rider."""
    F = mu_t.shape[1]
    vm, vs, _ = _col_sums(rows, x, cols, e, q, tq, ptab, F)
    if not first:
        vm, vs = acc[:, :F] + vm, acc[:, F:] + vs
    if not last:
        acc[:, :F] = vm
        acc[:, F:] = vs
        return
    _col_update(vm, vs, cols, group, ptab, mu_t, sig_t, sv, alpha, nans)


def vb_col_stats_window(rows, x, cols, group, e, q, tq, ptab, mu_t, sig_t,
                        sv, alpha, nans, acc, first: bool,
                        last: bool) -> None:
    if build.on_cpu(rows):
        return vb_col_stats_window_plain(rows, x, cols, group, e, q, tq,
                                         ptab, mu_t, sig_t, sv, alpha, nans,
                                         acc, first, last)
    C, L = rows.shape
    D, F = mu_t.shape
    N = e.shape[0]
    dev = rows.device
    req = build.require
    req(rows, _I32, (C, L), dev, "vb_col_stats_window.rows")
    req(x, _F32, (C, L), dev, "vb_col_stats_window.x")
    req(cols, _I32, (C,), dev, "vb_col_stats_window.cols")
    req(group, _I32, (C,), dev, "vb_col_stats_window.group")
    req(e, _F32, (N,), dev, "vb_col_stats_window.e")
    req(q, _F32, (N, F), dev, "vb_col_stats_window.q")
    req(tq, _F32, (N, F), dev, "vb_col_stats_window.tq")
    req(ptab, _F32, (D, 5 * F), dev, "vb_col_stats_window.ptab")
    req(mu_t, _F32, (D, F), dev, "vb_col_stats_window.mu_t")
    req(sig_t, _F32, (D, F), dev, "vb_col_stats_window.sig_t")
    req(sv, _F32, (sv.shape[0], F), dev, "vb_col_stats_window.sv")
    req(alpha, _F32, (), dev, "vb_col_stats_window.alpha")
    req(nans, _I32, (2,), dev, "vb_col_stats_window.nans")
    req(acc, _F32, (C, 2 * F), dev, "vb_col_stats_window.acc")
    if C == 0 or F == 0:
        return
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_vb_col_stats_window(
            build.ptr(rows), build.ptr(x), C, L, build.ptr(cols),
            build.ptr(group), build.ptr(e), build.ptr(q), build.ptr(tq), F,
            build.ptr(ptab), build.ptr(mu_t), build.ptr(sig_t),
            build.ptr(sv), build.ptr(alpha), build.ptr(nans), build.ptr(acc),
            int(first) | 2 * int(last), build.stream_of(rows))
    build.check_launch(lib, rc, "vb_col_stats_window")


# ---- K4 ---------------------------------------------------------------------

def vb_patch_rows_plain(ptab, F: int, merge_w: bool, ids, vals, q, tq, tz, e,
                        t, sequential: bool = True) -> None:
    """Patch q/tq/tz [N, F] and e/t [N] in place from ``ptab``.  With
    ``sequential`` (batch VB) the row positions are walked in order and the
    caches change between positions; without it (online VB) every position
    reads the caches from before the patch."""
    q0, tq0, tz0 = ((q, tq, tz) if sequential
                    else (q.clone(), tq.clone(), tz.clone()))
    for p in range(ids.shape[1]):
        gg = ptab.index_select(0, ids[:, p])  # [N, CH]
        x = vals[:, p]
        xp = x[:, None]
        x2p = xp * xp
        mu_e, sig_e = gg[:, :F], gg[:, F:2 * F]
        dmu_e, dsig_e, dmu2_e = (gg[:, 2 * F:3 * F], gg[:, 3 * F:4 * F],
                                 gg[:, 4 * F:5 * F])
        he = xp * (q0 - xp * mu_e)
        h1e = x2p * (tq0 - x2p * sig_e)
        h2e = x2p * (tz0 - x2p * mu_e * mu_e)
        q += xp * dmu_e
        tq += x2p * dsig_e
        tz += x2p * dmu2_e
        e -= (he * dmu_e).sum(1)
        t += ((h1e + h2e) * dsig_e + h1e * dmu2_e).sum(1)
        if merge_w:
            e += x * gg[:, 5 * F]
            t += x * x * gg[:, 5 * F + 1]


def vb_patch_rows(ptab, F: int, merge_w: bool, ids, vals, q, tq, tz, e,
                  t, sequential: bool = True) -> None:
    if build.on_cpu(ids):
        return vb_patch_rows_plain(ptab, F, merge_w, ids, vals, q, tq, tz, e,
                                   t, sequential)
    N, P = ids.shape
    CH = 5 * F + (2 if merge_w else 0)
    dev = ids.device
    req = build.require
    req(ptab, _F32, (ptab.shape[0], CH), dev, "vb_patch_rows.ptab")
    req(ids, _I32, (N, P), dev, "vb_patch_rows.ids")
    req(vals, _F32, (N, P), dev, "vb_patch_rows.vals")
    for name, a in (("q", q), ("tq", tq), ("tz", tz)):
        req(a, _F32, (N, F), dev, f"vb_patch_rows.{name}")
    req(e, _F32, (N,), dev, "vb_patch_rows.e")
    req(t, _F32, (N,), dev, "vb_patch_rows.t")
    if N == 0:
        return
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_vb_patch_rows(
            build.ptr(ptab), CH, F, int(merge_w), int(sequential),
            build.ptr(ids),
            build.ptr(vals), N, P, build.ptr(q), build.ptr(tq), build.ptr(tz),
            build.ptr(e), build.ptr(t), build.stream_of(ids))
    build.check_launch(lib, rc, "vb_patch_rows")


# ---- K4 at F = 0: the w patch ----------------------------------------------

def w_patch_rows_plain(dtab, ids, vals, e, t=None) -> None:
    """e += sum_p x dtab[id, 0], t += sum_p x^2 dtab[id, 1] (in place):
    K4's twin with no factor channels, ``dtab`` [D, 2] its w channels.
    ``t`` None (MCMC) patches e alone."""
    for p in range(ids.shape[1]):
        gg = dtab.index_select(0, ids[:, p])
        x = vals[:, p]
        e += x * gg[:, 0]
        if t is not None:
            t += x * x * gg[:, 1]


def w_patch_rows(dtab, ids, vals, e, t=None) -> None:
    if build.on_cpu(ids):
        return w_patch_rows_plain(dtab, ids, vals, e, t)
    N, P = ids.shape
    dev = ids.device
    req = build.require
    req(dtab, _F32, (dtab.shape[0], 2), dev, "w_patch_rows.dtab")
    req(ids, _I32, (N, P), dev, "w_patch_rows.ids")
    req(vals, _F32, (N, P), dev, "w_patch_rows.vals")
    req(e, _F32, (N,), dev, "w_patch_rows.e")
    if t is not None:
        req(t, _F32, (N,), dev, "w_patch_rows.t")
    if N == 0:
        return
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_w_patch_rows(
            build.ptr(dtab), build.ptr(ids), build.ptr(vals), N, P,
            build.ptr(e), None if t is None else build.ptr(t),
            build.stream_of(ids))
    build.check_launch(lib, rc, "w_patch_rows")


# ---- T2-T4: the feature-sharded sweep (parallel/tp_vb.py) ------------------
# Each rank holds the table columns [lo, lo + D_loc) (local ids 0 ..
# D_loc - 1; a bucket's padding columns carry D_loc) and the rows of its
# data shard; the row caches are one [N, 3F] buffer qt = (q | tq | tz).

def _in_window(ids, lo: int, D_loc: int):
    """(local ids clamped into the table, whether each id is the shard's)."""
    lid = ids.long() - lo
    return lid.clamp(0, max(D_loc - 1, 0)), (lid >= 0) & (lid < D_loc)


def tp_build_qt_plain(ptab, F: int, ids, vals, lo: int,
                      D_loc: int) -> torch.Tensor:
    """T2's twin: qt [N, 3F] = (q | tq | tz), K2's sums over the ids of
    the shard [lo, lo + D_loc) alone, from channels 0..F-1 (mu) and
    F..2F-1 (sig) of ``ptab`` [D_loc, CH]."""
    lidc, inr = _in_window(ids, lo, D_loc)
    N = ids.shape[0]
    zero = torch.zeros((), dtype=_F32, device=ptab.device)
    q = torch.zeros(N, F, dtype=_F32, device=ptab.device)
    tq = torch.zeros_like(q)
    tz = torch.zeros_like(q)
    for p in range(ids.shape[1]):
        g = ptab.index_select(0, lidc[:, p])
        m = inr[:, p, None]
        xp = vals[:, p, None]
        x2p = xp * xp
        mug, sigg = g[:, :F], g[:, F:2 * F]
        q = q + torch.where(m, mug * xp, zero)
        tq = tq + torch.where(m, sigg * x2p, zero)
        tz = tz + torch.where(m, mug * mug * x2p, zero)
    return torch.cat([q, tq, tz], 1)


def tp_build_qt(ptab, F: int, ids, vals, lo: int, D_loc: int) -> torch.Tensor:
    """T2: kernel on CUDA tensors, plain twin on CPU tensors."""
    if build.on_cpu(ids):
        return tp_build_qt_plain(ptab, F, ids, vals, lo, D_loc)
    N, P = ids.shape
    dev = ids.device
    build.require(ptab, _F32, (D_loc, ptab.shape[1]), dev,
                  "tp_build_qt.ptab")
    if ptab.shape[1] < 2 * F:
        raise ValueError(f"tp_build_qt.ptab: fewer than 2F={2 * F} channels")
    build.require(ids, _I32, (N, P), dev, "tp_build_qt.ids")
    build.require(vals, _F32, (N, P), dev, "tp_build_qt.vals")
    qt = torch.empty(N, 3 * F, dtype=_F32, device=dev)
    if N * F == 0:
        return qt.zero_()
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_build_qt(
            build.ptr(ptab), ptab.shape[1], F, lo, D_loc, build.ptr(ids),
            build.ptr(vals), N, P, build.ptr(qt), build.stream_of(ids))
    build.check_launch(lib, rc, "tp_build_qt")
    return qt


def tp_build_q_plain(ptab, F: int, ids, vals, lo: int,
                     D_loc: int) -> torch.Tensor:
    """T6's twin: q [N, F], X8d's sums over the ids of the shard [lo, lo +
    D_loc) alone, from channels 0..F-1 of ``ptab`` [D_loc, CH]."""
    lidc, inr = _in_window(ids, lo, D_loc)
    zero = torch.zeros((), dtype=_F32, device=ptab.device)
    q = torch.zeros(ids.shape[0], F, dtype=_F32, device=ptab.device)
    for p in range(ids.shape[1]):
        g = ptab.index_select(0, lidc[:, p])[:, :F]
        q = q + torch.where(inr[:, p, None], g * vals[:, p, None], zero)
    return q


def tp_build_q(ptab, F: int, ids, vals, lo: int, D_loc: int) -> torch.Tensor:
    """T6, T2's q-only mode (the feature-sharded Gibbs/ALS block's q):
    kernel on CUDA tensors, plain twin on CPU tensors."""
    if build.on_cpu(ids):
        return tp_build_q_plain(ptab, F, ids, vals, lo, D_loc)
    N, P = ids.shape
    dev = ids.device
    build.require(ptab, _F32, (D_loc, ptab.shape[1]), dev, "tp_build_q.ptab")
    if ptab.shape[1] < F:
        raise ValueError(f"tp_build_q.ptab: fewer than F={F} channels")
    build.require(ids, _I32, (N, P), dev, "tp_build_q.ids")
    build.require(vals, _F32, (N, P), dev, "tp_build_q.vals")
    q = torch.empty(N, F, dtype=_F32, device=dev)
    if N * F == 0:
        return q.zero_()
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_build_q(
            build.ptr(ptab), ptab.shape[1], F, lo, D_loc, build.ptr(ids),
            build.ptr(vals), N, P, build.ptr(q), build.stream_of(ids))
    build.check_launch(lib, rc, "tp_build_q")
    return q


def tp_col_stats_plain(rows, x, cols, D_loc: int, e, qt, ptab,
                       F: int) -> torch.Tensor:
    """T3's stats twin: acc [C, 2F + 1] = (vm | vs | sum x e) of a [C, L]
    bucket's columns over this data shard's rows (``_col_sums`` on the
    caches of ``qt``); a padding column (local id D_loc) gets a zero
    row."""
    C, L = rows.shape
    real = cols != D_loc
    cl = torch.where(real, cols, torch.zeros_like(cols))
    q, tq = qt[:, :F], qt[:, F:2 * F]
    vm, vs, sxe = _col_sums(rows, x, cl, e, q, tq, ptab, F)
    acc = torch.cat([vm, vs, sxe[:, None]], 1)
    return torch.where(real[:, None], acc, torch.zeros((), device=acc.device))


def tp_col_stats(rows, x, cols, D_loc: int, e, qt, ptab,
                 F: int) -> torch.Tensor:
    """T3, stats launch: kernel on CUDA tensors, plain twin on CPU
    tensors."""
    if build.on_cpu(rows):
        return tp_col_stats_plain(rows, x, cols, D_loc, e, qt, ptab, F)
    C, L = rows.shape
    N = e.shape[0]
    dev = rows.device
    req = build.require
    req(rows, _I32, (C, L), dev, "tp_col_stats.rows")
    req(x, _F32, (C, L), dev, "tp_col_stats.x")
    req(cols, _I32, (C,), dev, "tp_col_stats.cols")
    req(e, _F32, (N,), dev, "tp_col_stats.e")
    req(qt, _F32, (N, 3 * F), dev, "tp_col_stats.qt")
    req(ptab, _F32, (D_loc, ptab.shape[1]), dev, "tp_col_stats.ptab")
    acc = torch.empty(C, 2 * F + 1, dtype=_F32, device=dev)
    if C == 0 or F == 0:
        return acc.zero_()
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_col_stats(
            build.ptr(rows), build.ptr(x), C, L, build.ptr(cols), D_loc,
            build.ptr(e), build.ptr(qt), F, build.ptr(ptab), ptab.shape[1],
            build.ptr(acc), build.stream_of(rows))
    build.check_launch(lib, rc, "tp_col_stats")
    return acc


def tp_col_update_plain(acc, cols, D_loc: int, group, sx2, ptab, mu_t, sig_t,
                        sv, alpha, w: Optional[tuple], nans) -> None:
    """T3's update twin: K3's closed form (and the w rider's, ``w`` =
    (mu_w, sig_w_dash, sigma_w)) at the bucket's real columns from the
    column sums ``acc`` [C, 2F + 1], in place as K3's twin."""
    F = mu_t.shape[1]
    real = cols != D_loc
    cols, group, sx2, acc = cols[real], group[real], sx2[real], acc[real]
    _col_update(acc[:, :F], acc[:, F:2 * F], cols, group, ptab, mu_t, sig_t,
                sv, alpha, nans)
    if w is not None:
        mu_w, sig_w, sigma_w = w
        cl = cols.long()
        wmu_c, wsig_c = mu_w[cl], sig_w[cl]
        wsig_cand = 1.0 / (sigma_w.index_select(0, group) + alpha * sx2)
        wsig_new = keep_finite(wsig_cand, wsig_c)
        wmu_cand = wsig_new * alpha * (acc[:, 2 * F] + wmu_c * sx2)
        nans[1] += nonfinite(wsig_cand) + nonfinite(wmu_cand)
        wmu_new = keep_finite(wmu_cand, wmu_c)
        mu_w[cl] = wmu_new
        sig_w[cl] = wsig_new
        ptab[cl, 5 * F] = wmu_c - wmu_new
        ptab[cl, 5 * F + 1] = wsig_new - wsig_c


def tp_col_update(acc, cols, D_loc: int, group, sx2, ptab, mu_t, sig_t, sv,
                  alpha, w: Optional[tuple], nans) -> None:
    """T3, update launch (reads ``acc``, no rows): kernel on CUDA tensors,
    plain twin on CPU tensors; in place."""
    if build.on_cpu(acc):
        return tp_col_update_plain(acc, cols, D_loc, group, sx2, ptab, mu_t,
                                   sig_t, sv, alpha, w, nans)
    C = cols.shape[0]
    F = mu_t.shape[1]
    CH = 5 * F + (2 if w is not None else 0)
    dev = acc.device
    req = build.require
    req(acc, _F32, (C, 2 * F + 1), dev, "tp_col_update.acc")
    req(cols, _I32, (C,), dev, "tp_col_update.cols")
    req(group, _I32, (C,), dev, "tp_col_update.group")
    req(sx2, _F32, (C,), dev, "tp_col_update.sx2")
    req(ptab, _F32, (D_loc, CH), dev, "tp_col_update.ptab")
    req(mu_t, _F32, (D_loc, F), dev, "tp_col_update.mu_t")
    req(sig_t, _F32, (D_loc, F), dev, "tp_col_update.sig_t")
    req(sv, _F32, (sv.shape[0], F), dev, "tp_col_update.sv")
    req(alpha, _F32, (), dev, "tp_col_update.alpha")
    req(nans, _I32, (2,), dev, "tp_col_update.nans")
    if w is not None:
        mu_w, sig_w, sigma_w = w
        req(mu_w, _F32, (D_loc,), dev, "tp_col_update.mu_w")
        req(sig_w, _F32, (D_loc,), dev, "tp_col_update.sig_w")
        req(sigma_w, _F32, (sv.shape[0],), dev, "tp_col_update.sigma_w")
        wp = (build.ptr(mu_w), build.ptr(sig_w), build.ptr(sigma_w))
    else:
        wp = (None, None, None)
    if C == 0 or F == 0:
        return
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_col_update(
            build.ptr(acc), C, build.ptr(cols), D_loc, build.ptr(group),
            build.ptr(sx2), F, build.ptr(ptab), CH, build.ptr(mu_t),
            build.ptr(sig_t), build.ptr(sv), build.ptr(alpha), *wp,
            build.ptr(nans), build.stream_of(acc))
    build.check_launch(lib, rc, "tp_col_update")


def tp_patch_views(patch, N: int, F: int) -> tuple:
    """T4's output, one buffer of N (3F + 2) floats, as its three parts:
    the [N, 3F] (dq | dtq | dtz) of the rows, de [N] and dt [N] (planar, so
    that the adds after the all-reduce read contiguous memory)."""
    return (patch[:N * 3 * F].view(N, 3 * F),
            patch[N * 3 * F:N * (3 * F + 1)], patch[N * (3 * F + 1):])


def tp_patch_delta_plain(ptab, F: int, merge_w: bool, ids, vals, qt,
                         lo: int, D_loc: int) -> torch.Tensor:
    """T4's twin: the bin's patch (dq | dtq | dtz), de, dt of the rows from
    the ids of the shard (``tp_patch_views``' layout), against the
    pre-patch caches ``qt`` (every position reads them: K4's
    non-sequential order, which a conflict-free bin makes equal to the
    sequential one).  At F = 0 ``ptab`` is the w delta table [D_loc, 2]
    and ``qt`` is not read."""
    lidc, inr = _in_window(ids, lo, D_loc)
    N = ids.shape[0]
    dev = ptab.device
    zero = torch.zeros((), dtype=_F32, device=dev)
    dq = torch.zeros(N, F, dtype=_F32, device=dev)
    dtq = torch.zeros_like(dq)
    dtz = torch.zeros_like(dq)
    de = torch.zeros(N, dtype=_F32, device=dev)
    dt = torch.zeros_like(de)
    if F:
        q, tq, tz = qt[:, :F], qt[:, F:2 * F], qt[:, 2 * F:]
    for p in range(ids.shape[1]):
        gg = ptab.index_select(0, lidc[:, p])
        m = inr[:, p]
        x = vals[:, p]
        if F:
            mc = m[:, None]
            xp = x[:, None]
            x2p = xp * xp
            mu_e, sig_e = gg[:, :F], gg[:, F:2 * F]
            dmu_e, dsig_e, dmu2_e = (gg[:, 2 * F:3 * F], gg[:, 3 * F:4 * F],
                                     gg[:, 4 * F:5 * F])
            he = xp * (q - xp * mu_e)
            h1e = x2p * (tq - x2p * sig_e)
            h2e = x2p * (tz - x2p * mu_e * mu_e)
            dq = dq + torch.where(mc, xp * dmu_e, zero)
            dtq = dtq + torch.where(mc, x2p * dsig_e, zero)
            dtz = dtz + torch.where(mc, x2p * dmu2_e, zero)
            de = de - torch.where(m, (he * dmu_e).sum(1), zero)
            dt = dt + torch.where(
                m, ((h1e + h2e) * dsig_e + h1e * dmu2_e).sum(1), zero)
        if merge_w:
            de = de + torch.where(m, x * gg[:, 5 * F], zero)
            dt = dt + torch.where(m, x * x * gg[:, 5 * F + 1], zero)
    return torch.cat([torch.cat([dq, dtq, dtz], 1).reshape(-1), de, dt])


def tp_patch_delta(ptab, F: int, merge_w: bool, ids, vals, qt, lo: int,
                   D_loc: int) -> torch.Tensor:
    """T4: kernel on CUDA tensors, plain twin on CPU tensors."""
    if build.on_cpu(ids):
        return tp_patch_delta_plain(ptab, F, merge_w, ids, vals, qt, lo,
                                    D_loc)
    N, P = ids.shape
    CH = 5 * F + (2 if merge_w else 0)
    dev = ids.device
    req = build.require
    req(ptab, _F32, (D_loc, CH), dev, "tp_patch_delta.ptab")
    req(ids, _I32, (N, P), dev, "tp_patch_delta.ids")
    req(vals, _F32, (N, P), dev, "tp_patch_delta.vals")
    if F:
        req(qt, _F32, (N, 3 * F), dev, "tp_patch_delta.qt")
    out = torch.empty(N * (3 * F + 2), dtype=_F32, device=dev)
    if N == 0:
        return out
    lib = build.load_library("vb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_patch_delta(
            build.ptr(ptab), CH, F, int(merge_w), lo, D_loc, build.ptr(ids),
            build.ptr(vals), N, P, build.ptr(qt) if F else None,
            build.ptr(out), build.stream_of(ids))
    build.check_launch(lib, rc, "tp_patch_delta")
    return out
