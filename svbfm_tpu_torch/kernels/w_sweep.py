"""K5: the standalone linear-term sweep (``csrc/w_sweep.cu``), every degree
bucket of one conflict-free bin in one launch.

``w_bin_update`` (K5) computes the per-column statistic of every bucket of
a bin (each a ``BlockData``: ``rows``/``x`` [C, L], ``cols``, ``group``,
``sx2``, ``cnt``, ``col_count`` [C]) and updates the linear term at its
columns: the closed form of batch VB, or with ``ovb=`` the
natural-gradient blend of online VB.  It writes the bin's rows of the
``[D, 2]`` delta table ``dtab`` (mu_old - mu_new, sig_new - sig_old),
which the caller zeroes before each bin; ``vb_sweep.w_patch_rows`` (K4 at
F = 0) then adds the bin's deltas to the row caches e and t.  On CUDA
tensors the op launches its hand-written kernel once, with the bin's plan
table (``w_plan_rows``, built in host memory the first time the bin's
buckets are seen) as the kernel's parameter (a launch for each
``MAX_BUCKETS`` buckets of a longer bin); on CPU tensors it runs the plain
PyTorch twin of each bucket, ``w_col_update_plain``, in the bin's order.
Both update their outputs in place, kernel and twin alike.

``bad`` is an int32 [4] counter: (nan mu, inf mu, nan sig, inf sig)
candidates.

``mcmc_w_bin_draw`` (X8c) is the same kernel's MCMC mode: the bin's w draw
of Gibbs MCMC (ALS: the conditional mean), with the delta table
(w_new - w_old, 0) that ``vb_sweep.w_patch_rows`` adds to MCMC's e = yhat - y;
``bad[0]``, ``bad[1]`` count the NaN and Inf draws.

``w_bin_update_window`` (X13b) is its window-accumulating mode, the w
sweep of the out-of-core batch VB (``learners/vb_windowed.py``): a bin's
buckets are one window's views, each column's sum x e goes into a [D]
accumulator in window order, and the last window applies the closed form
with the bucket's global sx2 (replaces ``svbfm_tpu/learners/vb_windowed.py``'s
``make_wstats`` :583-599 and ``make_wdraw`` :550-581).

``mcmc_w_bin_draw_window`` (X14b) is X8c's window-accumulating mode, the w
sweep of the out-of-core Gibbs/ALS (``learners/mcmc_windowed.py``): X13b's
accumulator with the MCMC draw, from the bucket's global sx2, at the last
window (replaces ``svbfm_tpu/learners/mcmc_windowed.py``'s ``make_wstats``
:246-262 and ``make_wdraw`` :264-292).

``w_bin_grad_step`` (X9d's w half) is its gradient mode: the bin's step of
the full-batch exp_sgd, w' = keep_finite(w - lr (sum x e + regw w) / N, w),
with the same delta table (w_new - w_old, 0) for the w patch.

``tp_w_stats`` and ``tp_w_update`` (T3 at K = 0) split K5's VB mode
around the feature-sharded learner's data all-reduce: the bin's column
sums into a [D_loc] accumulator, then the closed form from it
(``svbfm_tpu/parallel/tp_vb.py:459-482``); padding columns (local id
D_loc) are skipped.  ``tp_w_draw`` (T5) is the update launch's Gibbs/ALS
mode, the feature-sharded Gibbs w sweep after ``tp_w_stats``: X8c's draw
from the accumulator, the delta table (w_new - w_old, 0)
(``svbfm_tpu/parallel/tp_mcmc.py:158-200``).  ``tp_w_ovb_stats`` and
``tp_w_ovb_blend`` (T10) are the two launches' online-VB mode, the
feature-sharded OVB's w sweep: K5's OVB sums x (e + x mu) into the
accumulator, then K5's OVB blend from it
(``svbfm_tpu/parallel/tp_ovb.py:204-244``).

Replaces ``svbfm_tpu/learners/vb.py:vb_w_bin_update`` (:125-148), the w
column updates of ``svbfm_tpu/learners/vb_online.py:ovb_chunk_update``
(:230-269), the bucket body of ``svbfm_tpu/learners/mcmc.py:w_sweep_main``
(:632-652) and the w buckets of
``svbfm_tpu/learners/exp_sgd.py:exp_sgd_sweep`` (:78-87).
"""

from __future__ import annotations

from typing import Optional

import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.learners.base import keep_finite

_I32, _F32 = torch.int32, torch.float32
# the kernel's threads a block and buckets a launch (csrc/w_sweep.cu)
_THREADS = 256
MAX_BUCKETS = 32


def count_candidates(bad, mu_cand, sig_cand) -> None:
    """bad [4] += (nan, inf) counts of the mu candidates, then of sig."""
    bad[0] += torch.isnan(mu_cand).sum(dtype=_I32)
    bad[1] += torch.isinf(mu_cand).sum(dtype=_I32)
    bad[2] += torch.isnan(sig_cand).sum(dtype=_I32)
    bad[3] += torch.isinf(sig_cand).sum(dtype=_I32)


# ---- K5 ---------------------------------------------------------------------

def w_col_update_plain(rows, x, cols, group, sx2, e, mu_w, sig_w, sigma_w,
                       alpha, dtab, bad, ovb: Optional[tuple] = None) -> None:
    """One [C, L] bucket.  ``ovb`` is (cnt, col_count, n_mu_w, n_sig_w,
    rho_w, t_wj) for online VB, or None for batch VB."""
    e_g = e.index_select(0, rows.reshape(-1)).reshape(rows.shape)
    if ovb is None:
        _vb_w_close((x * e_g).sum(1), cols, group, sx2, mu_w, sig_w,
                    sigma_w, alpha, dtab, bad)
        return
    mu_c = mu_w[cols.long()]
    _ovb_w_close((x * (e_g + x * mu_c[:, None])).sum(1), cols, group, sx2,
                 mu_w, sig_w, sigma_w, alpha, dtab, bad, ovb)


def _ovb_w_close(sxe, cols, group, sx2, mu_w, sig_w, sigma_w, alpha, dtab,
                 bad, ovb: tuple) -> None:
    """Online VB's blend of the linear term (vb_online.py:236-269) at
    ``cols`` from their sums ``sxe`` = sum x (e + x mu), ``ovb`` = (cnt,
    col_count, n_mu_w, n_sig_w, rho_w, t_wj), in place."""
    cl = cols.long()
    mu_c, sig_c = mu_w[cl], sig_w[cl]
    sw = sigma_w.index_select(0, group)
    cnt, col_count, n_mu, n_sig, rho_w, t_wj = ovb
    active = cnt > 0
    cnt1 = torch.clamp(cnt, min=1.0)
    rho = rho_w[cl]
    s1 = sxe / cnt1
    msx2 = sx2 / cnt1
    nmu_c, nsig_c = n_mu[cl], n_sig[cl]
    nsig_new = (1.0 - rho) * nsig_c + rho * (sw + alpha * col_count * msx2)
    nmu_new = (1.0 - rho) * nmu_c + rho * col_count * alpha * s1
    zero = torch.zeros((), dtype=_F32, device=sxe.device)
    mu_cand = torch.where(active, nmu_new / nsig_new, zero)
    sig_cand = torch.where(active, 1.0 / nsig_new, zero)
    mu_new = torch.where(active, keep_finite(nmu_new / nsig_new, mu_c),
                         mu_c)
    sig_new = torch.where(active, keep_finite(1.0 / nsig_new, sig_c),
                          sig_c)
    n_mu[cl] = torch.where(active, nmu_new, nmu_c)
    n_sig[cl] = torch.where(active, nsig_new, nsig_c)
    t_wj.index_add_(0, cols, torch.where(active, cnt, zero))
    count_candidates(bad, mu_cand, sig_cand)
    mu_w[cl] = mu_new
    sig_w[cl] = sig_new
    dtab[cl, 0] = mu_c - mu_new
    dtab[cl, 1] = sig_new - sig_c


def _vb_w_close(sxe, cols, group, sx2, mu_w, sig_w, sigma_w, alpha, dtab,
                bad) -> None:
    """Batch VB's closed form of the linear term (vb.py:140-148) at
    ``cols`` from their sums ``sxe`` = sum x e, in place."""
    cl = cols.long()
    mu_c, sig_c = mu_w[cl], sig_w[cl]
    sig_cand = 1.0 / (sigma_w.index_select(0, group) + alpha * sx2)
    sig_new = keep_finite(sig_cand, sig_c)
    mu_cand = sig_new * alpha * (sxe + mu_c * sx2)
    mu_new = keep_finite(mu_cand, mu_c)
    count_candidates(bad, mu_cand, sig_cand)
    mu_w[cl] = mu_new
    sig_w[cl] = sig_new
    dtab[cl, 0] = mu_c - mu_new
    dtab[cl, 1] = sig_new - sig_c


# ---- X8c: K5's MCMC mode ----------------------------------------------------

def mcmc_w_draw_plain(rows, x, cols, group, sx2, e, w, w_mu, w_lambda, alpha,
                      z, dtab, bad) -> None:
    """One [C, L] bucket of the MCMC/ALS w sweep (mcmc.py:636-652), in
    place on w and dtab; ``z`` is the [D] noise table, or None (ALS)."""
    e_g = e.index_select(0, rows.reshape(-1)).reshape(rows.shape)
    _mcmc_w_close((x * e_g).sum(1), cols, group, sx2, w, w_mu, w_lambda,
                  alpha, z, dtab, bad)


def _mcmc_w_close(sxe, cols, group, sx2, w, w_mu, w_lambda, alpha, z, dtab,
                  bad) -> None:
    """The MCMC/ALS w draw (mcmc.py:641-652) at ``cols`` from their sums
    ``sxe`` = sum x e, in place on w, dtab and bad."""
    cl = cols.long()
    w_c = w[cl]
    mu_g = w_mu.index_select(0, group)
    lam_g = w_lambda.index_select(0, group)
    s2 = 1.0 / (lam_g + alpha * sx2)
    val = -s2 * (alpha * (sxe - w_c * sx2) - mu_g * lam_g)
    if z is not None:
        val = val + torch.sqrt(s2) * z[cl]
    val = torch.where(torch.isfinite(s2), val, torch.zeros_like(val))
    bad[0] += torch.isnan(val).sum(dtype=_I32)
    bad[1] += torch.isinf(val).sum(dtype=_I32)
    w_new = keep_finite(val, w_c)
    w[cl] = w_new
    dtab[cl] = torch.stack([w_new - w_c, torch.zeros_like(w_c)], 1)


# ---- X9d: K5's gradient mode ------------------------------------------------

def w_grad_step_plain(rows, x, cols, e, w, dtab, lr: float, reg: float,
                      n_cases: float) -> None:
    """One [C, L] bucket of the exp_sgd w sweep (exp_sgd.py:81-87), in place
    on w and dtab = (w_new - w_old, 0) at the bucket's columns; e is
    stdev yhat - y.  ``lr``, ``reg`` and ``n_cases`` are float32 numbers, as
    the JAX step takes them."""
    cl = cols.long()
    w_c = w[cl]
    e_g = e.index_select(0, rows.reshape(-1)).reshape(rows.shape)
    w_sum = (x * e_g).sum(1)
    n = torch.full((), n_cases, dtype=_F32, device=w.device)
    w_new = keep_finite(w_c - lr * (w_sum + reg * w_c) / n, w_c)
    w[cl] = w_new
    dtab[cl] = torch.stack([w_new - w_c, torch.zeros_like(w_c)], 1)


# ---- the bin launch ---------------------------------------------------------

def col_lanes(L: int) -> int:
    """U, the lanes K5 gives a column of a bucket of L slots: the next power
    of two >= L, at most 32 (``csrc/w_sweep.cu:col_lanes``)."""
    U = 1
    while U < L and U < 32:
        U *= 2
    return U


def w_plan_rows(buckets) -> tuple[tuple, int]:
    """K5's plan table of one bin (``csrc/w_sweep.cu`` kPlanCols): a row a
    bucket, (rows, x, cols, group, sx2, cnt, col_count pointers, C, L,
    first), the buckets' blocks laid end to end, ceil(C U / 256) a bucket,
    first the bucket's first block; and the blocks in all."""
    out, first = [], 0
    for b in buckets:
        C, L = b.rows.shape
        # a windowed bucket (WindowBlock) has no cnt or col_count, which
        # only the OVB mode reads
        cnt = getattr(b, "cnt", None)
        cc = getattr(b, "col_count", None)
        out.append((b.rows.data_ptr(), b.x.data_ptr(), b.cols.data_ptr(),
                    b.group.data_ptr(), b.sx2.data_ptr(),
                    0 if cnt is None else cnt.data_ptr(),
                    0 if cc is None else cc.data_ptr(), C, L, first))
        first += -(-C * col_lanes(L) // _THREADS)
    return tuple(out), first


def _bin_launches(buckets, e, fields: tuple, name: str) -> list:
    """Check the bin's buckets (rows, x, cols and ``fields``) and return its
    launches, each (host plan table, buckets, blocks): one, or one for each
    ``MAX_BUCKETS`` buckets of a longer bin, its first blocks counted from
    its own first; none where the bin has no blocks."""
    dev = e.device
    for i, b in enumerate(buckets):
        C, L = b.rows.shape
        build.require(b.rows, _I32, (C, L), dev, f"{name}.rows[{i}]")
        build.require(b.x, _F32, (C, L), dev, f"{name}.x[{i}]")
        for f in ("cols",) + fields:
            build.require(getattr(b, f), _I32 if f in ("cols", "group")
                          else _F32, (C,), dev, f"{name}.{f}[{i}]")
    build.require(e, _F32, (e.shape[0],), dev, f"{name}.e")
    out = []
    for i in range(0, len(buckets), MAX_BUCKETS):
        rows, blocks = w_plan_rows(buckets[i:i + MAX_BUCKETS])
        if blocks:
            out.append((build.host_table(rows), len(rows), blocks))
    return out


def w_bin_update_plain(buckets, e, mu_w, sig_w, sigma_w, alpha, dtab, bad,
                       ovb: Optional[tuple] = None) -> None:
    """The twin of one bin: each bucket's, in the bin's order.  ``ovb`` is
    (n_mu_w, n_sig_w, rho_w, t_wj) for online VB, the buckets' cnt and
    col_count beside them, or None for batch VB."""
    for b in buckets:
        w_col_update_plain(b.rows, b.x, b.cols, b.group, b.sx2, e, mu_w,
                           sig_w, sigma_w, alpha, dtab, bad,
                           None if ovb is None else (b.cnt, b.col_count,
                                                     *ovb))


def w_bin_update(buckets, e, mu_w, sig_w, sigma_w, alpha, dtab, bad,
                 ovb: Optional[tuple] = None) -> None:
    """K5 on every bucket of a bin in one launch."""
    if build.on_cpu(e):
        return w_bin_update_plain(buckets, e, mu_w, sig_w, sigma_w, alpha,
                                  dtab, bad, ovb)
    D = mu_w.shape[0]
    dev = e.device
    req = build.require
    launches = _bin_launches(buckets, e, ("group", "sx2") + (
        ("cnt", "col_count") if ovb is not None else ()), "w_bin_update")
    req(mu_w, _F32, (D,), dev, "w_bin_update.mu_w")
    req(sig_w, _F32, (D,), dev, "w_bin_update.sig_w")
    req(sigma_w, _F32, (sigma_w.shape[0],), dev, "w_bin_update.sigma_w")
    req(alpha, _F32, (), dev, "w_bin_update.alpha")
    req(dtab, _F32, (D, 2), dev, "w_bin_update.dtab")
    req(bad, _I32, (4,), dev, "w_bin_update.bad")
    if ovb is not None:
        for a, name in zip(ovb, ("n_mu_w", "n_sig_w", "rho_w", "t_wj")):
            req(a, _F32, (D,), dev, f"w_bin_update.{name}")
        op = tuple(build.ptr(a) for a in ovb)
    else:
        op = (None,) * 4
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(dev):
            rc = lib.svbfm_w_col_update(
                table, nb, blocks, build.ptr(e), build.ptr(mu_w),
                build.ptr(sig_w), build.ptr(sigma_w), build.ptr(alpha),
                build.ptr(dtab), build.ptr(bad), int(ovb is not None), *op,
                build.stream_of(e))
        build.check_launch(lib, rc, "w_col_update")


def w_bin_update_window_plain(buckets, e, mu_w, sig_w, sigma_w, alpha, dtab,
                              bad, acc, first: bool, last: bool) -> None:
    """The twin of X13b on one window of a bin: each bucket's sum x e
    (rows local to the window's residual ``e``) goes into ``acc`` [D] at its
    columns, written at the first window and added to (acc + part) at the
    later ones; the last window applies the closed form with the bucket's
    global sx2.  One window (first and last) is the VB mode's twin."""
    for b in buckets:
        e_g = e.index_select(0, b.rows.reshape(-1)).reshape(b.rows.shape)
        part = (b.x * e_g).sum(1)
        cl = b.cols.long()
        tot = part if first else acc[cl] + part
        if not last:
            acc[cl] = tot
            continue
        _vb_w_close(tot, b.cols, b.group, b.sx2, mu_w, sig_w, sigma_w, alpha,
                    dtab, bad)


def w_bin_update_window(buckets, e, mu_w, sig_w, sigma_w, alpha, dtab, bad,
                        acc, first: bool, last: bool) -> None:
    """X13b on every bucket of one window of a bin in one launch."""
    if build.on_cpu(e):
        return w_bin_update_window_plain(buckets, e, mu_w, sig_w, sigma_w,
                                         alpha, dtab, bad, acc, first, last)
    D = mu_w.shape[0]
    dev = e.device
    req = build.require
    launches = _bin_launches(buckets, e, ("group", "sx2"),
                             "w_bin_update_window")
    req(mu_w, _F32, (D,), dev, "w_bin_update_window.mu_w")
    req(sig_w, _F32, (D,), dev, "w_bin_update_window.sig_w")
    req(sigma_w, _F32, (sigma_w.shape[0],), dev,
        "w_bin_update_window.sigma_w")
    req(alpha, _F32, (), dev, "w_bin_update_window.alpha")
    req(dtab, _F32, (D, 2), dev, "w_bin_update_window.dtab")
    req(bad, _I32, (4,), dev, "w_bin_update_window.bad")
    req(acc, _F32, (D,), dev, "w_bin_update_window.acc")
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(dev):
            rc = lib.svbfm_w_col_window(
                table, nb, blocks, build.ptr(e), build.ptr(mu_w),
                build.ptr(sig_w), build.ptr(sigma_w), build.ptr(alpha),
                build.ptr(dtab), build.ptr(bad), build.ptr(acc),
                int(first) | 2 * int(last), build.stream_of(e))
        build.check_launch(lib, rc, "w_col_window")


def mcmc_w_bin_draw_plain(buckets, e, w, w_mu, w_lambda, alpha, z, dtab,
                          bad) -> None:
    """The twin of one bin of the MCMC/ALS w sweep: each bucket's, in the
    bin's order."""
    for b in buckets:
        mcmc_w_draw_plain(b.rows, b.x, b.cols, b.group, b.sx2, e, w, w_mu,
                          w_lambda, alpha, z, dtab, bad)


def mcmc_w_bin_draw(buckets, e, w, w_mu, w_lambda, alpha, z, dtab,
                    bad) -> None:
    """X8c on every bucket of a bin in one launch; ``z`` is the [D] noise
    table, or None (ALS)."""
    if build.on_cpu(e):
        return mcmc_w_bin_draw_plain(buckets, e, w, w_mu, w_lambda, alpha, z,
                                     dtab, bad)
    D = w.shape[0]
    G = w_mu.shape[0]
    dev = e.device
    req = build.require
    launches = _bin_launches(buckets, e, ("group", "sx2"), "mcmc_w_bin_draw")
    req(w, _F32, (D,), dev, "mcmc_w_bin_draw.w")
    req(w_mu, _F32, (G,), dev, "mcmc_w_bin_draw.w_mu")
    req(w_lambda, _F32, (G,), dev, "mcmc_w_bin_draw.w_lambda")
    req(alpha, _F32, (), dev, "mcmc_w_bin_draw.alpha")
    if z is not None:
        req(z, _F32, (D,), dev, "mcmc_w_bin_draw.z")
    req(dtab, _F32, (D, 2), dev, "mcmc_w_bin_draw.dtab")
    req(bad, _I32, (4,), dev, "mcmc_w_bin_draw.bad")
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(dev):
            rc = lib.svbfm_mcmc_w_draw(
                table, nb, blocks, build.ptr(e), build.ptr(w),
                build.ptr(w_mu), build.ptr(w_lambda), build.ptr(alpha),
                None if z is None else build.ptr(z), build.ptr(dtab),
                build.ptr(bad), build.stream_of(e))
        build.check_launch(lib, rc, "mcmc_w_draw")


def mcmc_w_bin_draw_window_plain(buckets, e, w, w_mu, w_lambda, alpha, z,
                                 dtab, bad, acc, first: bool,
                                 last: bool) -> None:
    """The twin of X14b on one window of a bin: each bucket's sum x e (rows
    local to the window's residual ``e``) goes into ``acc`` [D] at its
    columns, written at the first window and added to (acc + part) at the
    later ones; the last window draws w with the bucket's global sx2.  One
    window (first and last) is ``mcmc_w_bin_draw_plain``."""
    for b in buckets:
        e_g = e.index_select(0, b.rows.reshape(-1)).reshape(b.rows.shape)
        part = (b.x * e_g).sum(1)
        cl = b.cols.long()
        tot = part if first else acc[cl] + part
        if not last:
            acc[cl] = tot
            continue
        _mcmc_w_close(tot, b.cols, b.group, b.sx2, w, w_mu, w_lambda, alpha,
                      z, dtab, bad)


def mcmc_w_bin_draw_window(buckets, e, w, w_mu, w_lambda, alpha, z, dtab,
                           bad, acc, first: bool, last: bool) -> None:
    """X14b on every bucket of one window of a bin in one launch; ``z``
    is the [D] noise table, or None (ALS)."""
    if build.on_cpu(e):
        return mcmc_w_bin_draw_window_plain(buckets, e, w, w_mu, w_lambda,
                                            alpha, z, dtab, bad, acc, first,
                                            last)
    D = w.shape[0]
    G = w_mu.shape[0]
    dev = e.device
    req = build.require
    name = "mcmc_w_bin_draw_window"
    launches = _bin_launches(buckets, e, ("group", "sx2"), name)
    req(w, _F32, (D,), dev, f"{name}.w")
    req(w_mu, _F32, (G,), dev, f"{name}.w_mu")
    req(w_lambda, _F32, (G,), dev, f"{name}.w_lambda")
    req(alpha, _F32, (), dev, f"{name}.alpha")
    if z is not None:
        req(z, _F32, (D,), dev, f"{name}.z")
    req(dtab, _F32, (D, 2), dev, f"{name}.dtab")
    req(bad, _I32, (4,), dev, f"{name}.bad")
    req(acc, _F32, (D,), dev, f"{name}.acc")
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(dev):
            rc = lib.svbfm_mcmc_w_window(
                table, nb, blocks, build.ptr(e), build.ptr(w),
                build.ptr(w_mu), build.ptr(w_lambda), build.ptr(alpha),
                None if z is None else build.ptr(z), build.ptr(dtab),
                build.ptr(bad), build.ptr(acc), int(first) | 2 * int(last),
                build.stream_of(e))
        build.check_launch(lib, rc, "mcmc_w_window")


def w_bin_grad_step_plain(buckets, e, w, dtab, lr: float, reg: float,
                          n_cases: float) -> None:
    """The twin of one bin of the exp_sgd w sweep: each bucket's, in the
    bin's order."""
    for b in buckets:
        w_grad_step_plain(b.rows, b.x, b.cols, e, w, dtab, lr, reg, n_cases)


def w_bin_grad_step(buckets, e, w, dtab, lr: float, reg: float,
                    n_cases: float) -> None:
    """K5's gradient mode on every bucket of a bin in one launch."""
    if build.on_cpu(e):
        return w_bin_grad_step_plain(buckets, e, w, dtab, lr, reg, n_cases)
    D = w.shape[0]
    dev = e.device
    launches = _bin_launches(buckets, e, (), "w_bin_grad_step")
    build.require(w, _F32, (D,), dev, "w_bin_grad_step.w")
    build.require(dtab, _F32, (D, 2), dev, "w_bin_grad_step.dtab")
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(dev):
            rc = lib.svbfm_w_grad_step(
                table, nb, blocks, build.ptr(e), build.ptr(w),
                build.ptr(dtab), lr, reg, n_cases, build.stream_of(e))
        build.check_launch(lib, rc, "w_grad_step")


# ---- T3 at K = 0: the feature-sharded w sweep, stats then update -----------

def _real(b, D_loc: int):
    """The bucket's real columns (padding columns carry local id D_loc)."""
    return b.cols != D_loc


def tp_w_stats_plain(buckets, e, acc, D_loc: int) -> None:
    """The twin of T3's stats launch at K = 0: acc[col] = sum x e of each
    real column of the bin's buckets over this data shard's rows."""
    for b in buckets:
        real = _real(b, D_loc)
        e_g = e.index_select(0, b.rows.reshape(-1)).reshape(b.rows.shape)
        acc[b.cols[real].long()] = (b.x * e_g).sum(1)[real]


def tp_w_stats(buckets, e, acc, D_loc: int) -> None:
    """T3's stats launch at K = 0, every bucket of a bin in one launch."""
    if build.on_cpu(e):
        return tp_w_stats_plain(buckets, e, acc, D_loc)
    launches = _bin_launches(buckets, e, (), "tp_w_stats")
    build.require(acc, _F32, (D_loc,), e.device, "tp_w_stats.acc")
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(e.device):
            rc = lib.svbfm_tp_w_stats(table, nb, blocks, build.ptr(e),
                                      build.ptr(acc), D_loc,
                                      build.stream_of(e))
        build.check_launch(lib, rc, "tp_w_stats")


def tp_w_update_plain(buckets, acc, D_loc: int, mu_w, sig_w, sigma_w, alpha,
                      dtab, bad) -> None:
    """The twin of T3's update launch at K = 0: batch VB's closed form at
    each real column of the bin from its sum ``acc[col]``."""
    for b in buckets:
        real = _real(b, D_loc)
        cols = b.cols[real]
        _vb_w_close(acc[cols.long()], cols, b.group[real], b.sx2[real], mu_w,
                    sig_w, sigma_w, alpha, dtab, bad)


def tp_w_update(buckets, acc, D_loc: int, mu_w, sig_w, sigma_w, alpha, dtab,
                bad) -> None:
    """T3's update launch at K = 0 (reads ``acc``, no rows), every bucket
    of a bin in one launch; in place on mu_w, sig_w, dtab and bad."""
    if build.on_cpu(acc):
        return tp_w_update_plain(buckets, acc, D_loc, mu_w, sig_w, sigma_w,
                                 alpha, dtab, bad)
    dev = acc.device
    req = build.require
    launches = _bin_launches(buckets, acc, ("group", "sx2"), "tp_w_update")
    req(acc, _F32, (D_loc,), dev, "tp_w_update.acc")
    req(mu_w, _F32, (D_loc,), dev, "tp_w_update.mu_w")
    req(sig_w, _F32, (D_loc,), dev, "tp_w_update.sig_w")
    req(sigma_w, _F32, (sigma_w.shape[0],), dev, "tp_w_update.sigma_w")
    req(alpha, _F32, (), dev, "tp_w_update.alpha")
    req(dtab, _F32, (D_loc, 2), dev, "tp_w_update.dtab")
    req(bad, _I32, (4,), dev, "tp_w_update.bad")
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(dev):
            rc = lib.svbfm_tp_w_update(
                table, nb, blocks, build.ptr(acc), D_loc, build.ptr(mu_w),
                build.ptr(sig_w), build.ptr(sigma_w), build.ptr(alpha),
                build.ptr(dtab), build.ptr(bad), build.stream_of(acc))
        build.check_launch(lib, rc, "tp_w_update")


def tp_w_draw_plain(buckets, acc, D_loc: int, w, w_mu, w_lambda, alpha, z,
                    dtab, bad) -> None:
    """The twin of T5: X8c's draw at each real column of the bin from its
    sum ``acc[col]``; ``z`` the [D_loc] noise table, or None (ALS)."""
    for b in buckets:
        real = _real(b, D_loc)
        cols = b.cols[real]
        _mcmc_w_close(acc[cols.long()], cols, b.group[real], b.sx2[real], w,
                      w_mu, w_lambda, alpha, z, dtab, bad)


def tp_w_draw(buckets, acc, D_loc: int, w, w_mu, w_lambda, alpha, z, dtab,
              bad) -> None:
    """T5 (reads ``acc``, no rows), every bucket of a bin in one launch; in
    place on w, dtab and bad."""
    if build.on_cpu(acc):
        return tp_w_draw_plain(buckets, acc, D_loc, w, w_mu, w_lambda, alpha,
                               z, dtab, bad)
    dev = acc.device
    G = w_mu.shape[0]
    req = build.require
    launches = _bin_launches(buckets, acc, ("group", "sx2"), "tp_w_draw")
    req(acc, _F32, (D_loc,), dev, "tp_w_draw.acc")
    req(w, _F32, (D_loc,), dev, "tp_w_draw.w")
    req(w_mu, _F32, (G,), dev, "tp_w_draw.w_mu")
    req(w_lambda, _F32, (G,), dev, "tp_w_draw.w_lambda")
    req(alpha, _F32, (), dev, "tp_w_draw.alpha")
    if z is not None:
        req(z, _F32, (D_loc,), dev, "tp_w_draw.z")
    req(dtab, _F32, (D_loc, 2), dev, "tp_w_draw.dtab")
    req(bad, _I32, (4,), dev, "tp_w_draw.bad")
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(dev):
            rc = lib.svbfm_tp_w_draw(
                table, nb, blocks, build.ptr(acc), D_loc, build.ptr(w),
                build.ptr(w_mu), build.ptr(w_lambda), build.ptr(alpha),
                None if z is None else build.ptr(z), build.ptr(dtab),
                build.ptr(bad), build.stream_of(acc))
        build.check_launch(lib, rc, "tp_w_draw")


# ---- T10: K5's OVB mode split around the feature-sharded OVB's all-reduce ---

def tp_w_ovb_stats_plain(buckets, e, mu_w, acc, D_loc: int) -> None:
    """The twin of T10's stats launch: acc[col] = sum x (e + x mu_w[col])
    of each real column of the bin's buckets over this data shard's
    rows."""
    for b in buckets:
        real = _real(b, D_loc)
        mu_c = mu_w[torch.where(real, b.cols, 0).long()]
        e_g = e.index_select(0, b.rows.reshape(-1)).reshape(b.rows.shape)
        s = (b.x * (e_g + b.x * mu_c[:, None])).sum(1)
        acc[b.cols[real].long()] = s[real]


def tp_w_ovb_stats(buckets, e, mu_w, acc, D_loc: int) -> None:
    """T10's stats launch, every bucket of a bin in one launch."""
    if build.on_cpu(e):
        return tp_w_ovb_stats_plain(buckets, e, mu_w, acc, D_loc)
    launches = _bin_launches(buckets, e, (), "tp_w_ovb_stats")
    build.require(mu_w, _F32, (D_loc,), e.device, "tp_w_ovb_stats.mu_w")
    build.require(acc, _F32, (D_loc,), e.device, "tp_w_ovb_stats.acc")
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(e.device):
            rc = lib.svbfm_tp_w_ovb_stats(table, nb, blocks, build.ptr(e),
                                          build.ptr(mu_w), build.ptr(acc),
                                          D_loc, build.stream_of(e))
        build.check_launch(lib, rc, "tp_w_ovb_stats")


def tp_w_ovb_blend_plain(buckets, acc, D_loc: int, mu_w, sig_w, sigma_w,
                         alpha, dtab, bad, ovb: tuple) -> None:
    """The twin of T10's blend launch: online VB's blend at each real
    column of the bin from its sum ``acc[col]``; ``ovb`` = (n_mu_w,
    n_sig_w, rho_w, t_wj), the buckets' cnt and col_count beside them."""
    for b in buckets:
        real = _real(b, D_loc)
        cols = b.cols[real]
        _ovb_w_close(acc[cols.long()], cols, b.group[real], b.sx2[real],
                     mu_w, sig_w, sigma_w, alpha, dtab, bad,
                     (b.cnt[real], b.col_count[real], *ovb))


def tp_w_ovb_blend(buckets, acc, D_loc: int, mu_w, sig_w, sigma_w, alpha,
                   dtab, bad, ovb: tuple) -> None:
    """T10's blend launch (reads ``acc``, no rows), every bucket of a bin
    in one launch; in place on mu_w, sig_w, the naturals, t_wj, dtab and
    bad."""
    if build.on_cpu(acc):
        return tp_w_ovb_blend_plain(buckets, acc, D_loc, mu_w, sig_w,
                                    sigma_w, alpha, dtab, bad, ovb)
    dev = acc.device
    req = build.require
    launches = _bin_launches(buckets, acc, ("group", "sx2", "cnt",
                                            "col_count"), "tp_w_ovb_blend")
    req(acc, _F32, (D_loc,), dev, "tp_w_ovb_blend.acc")
    req(mu_w, _F32, (D_loc,), dev, "tp_w_ovb_blend.mu_w")
    req(sig_w, _F32, (D_loc,), dev, "tp_w_ovb_blend.sig_w")
    req(sigma_w, _F32, (sigma_w.shape[0],), dev, "tp_w_ovb_blend.sigma_w")
    req(alpha, _F32, (), dev, "tp_w_ovb_blend.alpha")
    req(dtab, _F32, (D_loc, 2), dev, "tp_w_ovb_blend.dtab")
    req(bad, _I32, (4,), dev, "tp_w_ovb_blend.bad")
    for a, name in zip(ovb, ("n_mu_w", "n_sig_w", "rho_w", "t_wj")):
        req(a, _F32, (D_loc,), dev, f"tp_w_ovb_blend.{name}")
    lib = build.load_library("w_sweep")
    for table, nb, blocks in launches:
        with torch.cuda.device(dev):
            rc = lib.svbfm_tp_w_ovb_blend(
                table, nb, blocks, build.ptr(acc), D_loc, build.ptr(mu_w),
                build.ptr(sig_w), build.ptr(sigma_w), build.ptr(alpha),
                build.ptr(dtab), build.ptr(bad),
                *(build.ptr(a) for a in ovb), build.stream_of(acc))
        build.check_launch(lib, rc, "tp_w_ovb_blend")
