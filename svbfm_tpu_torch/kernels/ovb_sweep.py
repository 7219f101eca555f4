"""K6: online VB v column statistics + natural-gradient blend
(``csrc/ovb_sweep.cu``).

``ovb_col_stats_update`` takes one degree bucket of one factor block: the
per-column, per-factor statistics v_mean and v_sig from the row caches
(e [N], q/tq [N, F]) and the PRE-BIN mu/sig in channels 0..2F-1 of the
bin's patch table ``ptab`` [D, 5F]; the blend of the naturals with the
per-column rate ``rho_v`` [D]; and its writes, in place: mu/sig/eta1/eta2
[D, F] at the bucket's columns, ptab's delta channels (dmu, dsig, dmu2),
``tv_add[col] += cnt`` and the int32 [4] counter ``bad`` (nan mu, inf mu,
nan sig, inf sig candidates).  A column with cnt == 0 leaves all four
tables untouched and gets zero deltas.  On CUDA tensors the op launches the
hand-written kernel; on CPU tensors it runs the plain PyTorch twin.

Replaces the bucket body of ``svbfm_tpu/learners/vb_online.py:ovb_v_block``
(:512-559) and of its F = 1 flat form ``ovb_v_factor`` (:598).
"""

from __future__ import annotations

import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.kernels.w_sweep import count_candidates
from svbfm_tpu_torch.learners.base import keep_finite

_I32, _F32 = torch.int32, torch.float32


def ovb_col_stats_update_plain(rows, x, cols, group, cnt, col_count, e, q, tq,
                               ptab, mu_t, sig_t, nmu_t, nsig_t, sv, alpha,
                               rho_v, tv_add, bad) -> None:
    C, L = rows.shape
    F = mu_t.shape[1]
    cl = cols.long()
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
    active = (cnt > 0)[:, None]
    cnt1 = torch.clamp(cnt, min=1.0)[:, None]
    v_mean = (xb * h * (e_g + xb * mu_b * h)).sum(1) / cnt1
    v_sig = (x2 * h * h + x2 * h1).sum(1) / cnt1
    rho = rho_v[cl][:, None]
    cc = col_count[:, None]
    nmu_c, nsig_c = nmu_t[cl], nsig_t[cl]
    nsig_new = (1.0 - rho) * nsig_c + rho * (sv.index_select(0, group)
                                             + alpha * cc * v_sig)
    nmu_new = (1.0 - rho) * nmu_c + rho * cc * alpha * v_mean
    zero = torch.zeros((), dtype=_F32, device=e.device)
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
    tv_add.index_add_(0, cols, torch.where(active[:, 0], cnt, zero))


def ovb_col_stats_update(rows, x, cols, group, cnt, col_count, e, q, tq, ptab,
                         mu_t, sig_t, nmu_t, nsig_t, sv, alpha, rho_v, tv_add,
                         bad) -> None:
    if build.on_cpu(rows):
        return ovb_col_stats_update_plain(
            rows, x, cols, group, cnt, col_count, e, q, tq, ptab, mu_t, sig_t,
            nmu_t, nsig_t, sv, alpha, rho_v, tv_add, bad)
    C, L = rows.shape
    D, F = mu_t.shape
    N = e.shape[0]
    dev = rows.device
    req = build.require
    req(rows, _I32, (C, L), dev, "ovb_col_stats_update.rows")
    req(x, _F32, (C, L), dev, "ovb_col_stats_update.x")
    for name, a, dt in (("cols", cols, _I32), ("group", group, _I32),
                        ("cnt", cnt, _F32), ("col_count", col_count, _F32)):
        req(a, dt, (C,), dev, f"ovb_col_stats_update.{name}")
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
    if C == 0 or F == 0:
        return
    lib = build.load_library("ovb_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_ovb_col_stats_update(
            build.ptr(rows), build.ptr(x), C, L, build.ptr(cols),
            build.ptr(group), build.ptr(cnt), build.ptr(col_count),
            build.ptr(e), build.ptr(q), build.ptr(tq), F, build.ptr(ptab),
            build.ptr(mu_t), build.ptr(sig_t), build.ptr(nmu_t),
            build.ptr(nsig_t), build.ptr(sv), build.ptr(alpha),
            build.ptr(rho_v), build.ptr(tv_add), build.ptr(bad),
            build.stream_of(rows))
    build.check_launch(lib, rc, "ovb_col_stats_update")
