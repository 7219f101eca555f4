"""X10a-X10c: the relation sweeps of the native block-structure sampler
(``csrc/bs_sweep.cu``).

``bs_join_agg`` (X10a) sums, per relation row, the channels built from e and
qO = q - qB0 over the data rows joined to it (all degree buckets of a join
plan in one launch; a block a relation row at F >= 2, a group of up to 32
lanes a relation row at F <= 1); ``bs_rel_draw`` (X10b) computes one relation bucket's she, sh2 and
cross-factor matrix M from the relation-row table and draws the bucket's
factors with exact sequential conditionals (F = 1: the factor-sequential
path's draw); ``bs_rel_patch`` (X10c) patches the relation-row table and dy
after a bin.  ``bs_rel_w_draw`` and ``bs_rel_w_patch`` are X10b's and
X10c's w modes, the relation w sweep; X10a's w mode is ``F = 0`` (e alone).
On CUDA tensors each op launches its hand-written kernel; on CPU tensors it
runs the plain PyTorch twin beside it, the JAX arithmetic vectorised over
the bucket or the relation rows (``einsum`` in float32, the draw by
``mcmc_sweep.exact_block_draws``).  All update their outputs in place.

Layouts (see ``csrc/bs_sweep.cu``): the relation-row table ``rtab``
[R, 3F + 2 + P], P = F(F+1)/2, channels qB | we | weq | wc | wcc | wn
(JAX's per-bin stack ``big``; the w sweep's [R, 2] = we | wn); the patch
table ``ptab`` [Dr, 2Fo] = (v_old, dv), Fo = max(F, 1); v_t [Dr, Fo]; dy
[R, Fo].

Replaces ``svbfm_tpu/learners/mcmc_bs.py``: ``_join_aggregate`` (:554) +
``_scatter_agg`` (:567) with the channel builds (:320-331, :644-646,
:753-757); the relation bucket bodies (:379-438, :650-669, :771-797); the
relation-row patches (:439-453, :670-676, :798-810).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.kernels.mcmc_sweep import (MAX_BLOCK_SMEM,
                                                exact_block_draws)
from svbfm_tpu_torch.learners.base import keep_finite

_I32, _F32 = torch.int32, torch.float32
_TILE = 32  # csrc/bs_sweep.cu kTile
_NARROW_THREADS = 256  # csrc/bs_sweep.cu kNarrowThreads
# the least entries one block of X10b takes when a column is split
_SPLIT_MIN = 256


def rel_layout(F: int) -> dict:
    """Channel offsets of the relation-row table for F factors (F = 0: the
    w sweep's [R, 2] table)."""
    P = F * (F + 1) // 2
    return dict(P=P, we=F, weq=F + 1, wc=2 * F + 1, wcc=3 * F + 1,
                wn=3 * F + 1 + P, ld=3 * F + 2 + P)


def agg_channels(F: int) -> int:
    return 1 + 2 * F + F * (F + 1) // 2


def _sym(F: int):
    """JAX's (mcmc_bs.py:321, :332-336) upper-triangle index pairs and the
    symmetric [F, F] map into the packed upper triangle, its diagonal."""
    iu0, iu1 = np.triu_indices(F)
    sym = np.zeros((F, F), np.int64)
    sym[iu0, iu1] = np.arange(len(iu0))
    sym[iu1, iu0] = sym[iu0, iu1]
    return iu0, iu1, sym.reshape(-1), sym.diagonal().copy()


def join_agg_smem(F: int) -> int:
    """Bytes of shared memory X10a's block takes at F >= 2
    (``csrc/bs_sweep.cu:join_agg_smem``); the F <= 1 form takes none."""
    return 4 * (agg_channels(F) + 2 * _TILE + F * (_TILE + 1) + F)


def draw_outputs(F: int) -> int:
    Fo = max(F, 1)
    return 2 * Fo + (F * (F - 1) // 2 if F > 1 else 0)


def rel_draw_smem(F: int) -> int:
    """Bytes of shared memory X10b's block takes
    (``csrc/bs_sweep.cu:rel_draw_smem``)."""
    Fo = max(F, 1)
    return 4 * (draw_outputs(F) + Fo * (_TILE + 1) + 3 * _TILE
                + 2 * F * (_TILE + 1) + _TILE + 5 * Fo + 2)


def rel_draw_fits(F: int) -> bool:
    """Whether X10a and X10b can run a block of F factors on the card."""
    return max(rel_draw_smem(F), join_agg_smem(F)) <= MAX_BLOCK_SMEM


def draw_splits(C: int, L: int, sms: int) -> tuple[int, int]:
    """(S, Ls): X10b splits each column of a [C, L] bucket into S runs of
    Ls entries, enough for about two blocks per SM when the bucket has few
    columns, never runs shorter than _SPLIT_MIN entries."""
    S = max(1, min(-(-L // _SPLIT_MIN), -(-2 * sms // max(C, 1))))
    Ls = -(-(-(-L // S)) // _TILE) * _TILE
    return -(-L // Ls), Ls


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ---- X10a -------------------------------------------------------------------

def narrow_lanes(L: int) -> int:
    """G, the lanes X10a's F <= 1 form gives each relation row of a bucket
    of L slots: the next power of two >= L, at most 32, so that a row's
    lanes sit in one warp (``csrc/bs_sweep.cu:svbfm_bs_join_agg``)."""
    G = 1
    while G < L and G < 32:
        G *= 2
    return G


def join_plan_rows(buckets, F: int) -> tuple[tuple, int]:
    """X10a's plan table (``csrc/bs_sweep.cu`` kPlanCols): a row a bucket,
    (rows, x, cols pointers, C, L, G, the bucket's first block), the
    buckets' blocks laid end to end (C a bucket at F >= 2, a block a
    relation row; ceil(C G / 256) at F <= 1); and the blocks in all."""
    out, first = [], 0
    for b in buckets:
        C, L = b.rows.shape
        G = narrow_lanes(L)
        out.append((b.rows.data_ptr(), b.x.data_ptr(), b.cols.data_ptr(), C,
                    L, G, first))
        first += C if F >= 2 else -(-C * G // _NARROW_THREADS)
    return tuple(out), first


def bs_join_agg_plain(buckets, e, q, F: int, rtab) -> None:
    """The buckets of a join plan (each with its [C, L] ``rows``, ``x`` and
    [C] ``cols``): rtab[rho, F:F+CH] = the channel sums at each bucket's
    relation rows (``q`` is None at F = 0)."""
    for b in buckets:
        C, L = b.rows.shape
        rho = b.cols.long()
        ridx = b.rows.reshape(-1)
        e_g = e.index_select(0, ridx).reshape(1, C, L)
        if F == 0:
            ch = e_g
        else:
            qO = (q.index_select(0, ridx).reshape(C, L, F)
                  - rtab[rho, :F][:, None, :]).permute(2, 0, 1)  # [F, C, L]
            iu0, iu1, _, _ = _sym(F)
            ch = torch.cat([e_g, e_g * qO, qO, qO[iu0] * qO[iu1]], 0)
        part = (ch * b.x[None]).sum(-1)  # [CH, C]
        rtab[rho, F:F + part.shape[0]] = part.T


def bs_join_agg(buckets, e, q, F: int, rtab) -> None:
    if build.on_cpu(e):
        return bs_join_agg_plain(buckets, e, q, F, rtab)
    N = e.shape[0]
    dev = e.device
    lay = rel_layout(F)
    req = build.require
    req(e, _F32, (N,), dev, "bs_join_agg.e")
    if F > 0:
        req(q, _F32, (N, F), dev, "bs_join_agg.q")
    req(rtab, _F32, (rtab.shape[0], lay["ld"]), dev, "bs_join_agg.rtab")
    for i, b in enumerate(buckets):
        C, L = b.rows.shape
        req(b.rows, _I32, (C, L), dev, f"bs_join_agg.rows[{i}]")
        req(b.x, _F32, (C, L), dev, f"bs_join_agg.x[{i}]")
        req(b.cols, _I32, (C,), dev, f"bs_join_agg.cols[{i}]")
    rows, blocks = join_plan_rows(buckets, F)
    if blocks == 0:
        return
    if join_agg_smem(F) > MAX_BLOCK_SMEM:
        raise ValueError(f"bs_join_agg: F = {F} needs more shared memory "
                         f"than one block may take")
    plan = build.device_table(rows, dev)
    lib = build.load_library("bs_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_bs_join_agg(
            build.ptr(plan), len(rows), blocks, build.ptr(e),
            None if F == 0 else build.ptr(q), F, build.ptr(rtab),
            build.stream_of(e))
    build.check_launch(lib, rc, "bs_join_agg")


# ---- X10b -------------------------------------------------------------------

def _gather_rows(rtab, rows):
    C, L = rows.shape
    return rtab.index_select(0, rows.reshape(-1)).reshape(C, L, -1)


def bs_rel_draw_plain(rows, x, cols, group, rtab, F: int, ptab, v_t, mu, lam,
                      alpha, z: Optional[torch.Tensor], nans) -> None:
    """One [C, L] relation bucket of F >= 1 factors: the blocked draw
    (mcmc_bs.py:379-438) at F >= 2, the factor-sequential one (:771-797) at
    F = 1; in place on v_t, ptab's dv channels and nans."""
    lay = rel_layout(F)
    cl = cols.long()
    g = _gather_rows(rtab, rows)  # [C, L, ld]
    we_g, wn_g = g[..., lay["we"]], g[..., lay["wn"]]

    def chans(off, n):  # [n, C, L]
        return g[..., off:off + n].permute(2, 0, 1)

    qB_g, weq_g = chans(0, F), chans(lay["weq"], F)
    wc_g, wccu_g = chans(lay["wc"], F), chans(lay["wcc"], lay["P"])
    v_c = ptab[cl, :F]  # [C, F] pre-bin
    mu_g = mu.index_select(0, group)
    lam_g = lam.index_select(0, group)
    if F == 1:
        v1 = v_c[:, 0]
        h = x * (qB_g[0] - x * v1[:, None])
        she = (h * we_g + x * weq_g[0]).sum(-1)
        sh2 = (h * h * wn_g + 2.0 * wc_g[0] * x * h
               + x * x * wccu_g[0]).sum(-1)
        s2 = 1.0 / (lam_g[:, 0] + alpha * sh2)
        val = -s2 * (alpha * (she - v1 * sh2) - mu_g[:, 0] * lam_g[:, 0])
        if z is not None:
            val = val + torch.sqrt(s2) * z[0].index_select(0, cols)
        val = torch.where(torch.isfinite(s2), val, torch.zeros_like(val))
        nans[0] += torch.isnan(val).sum(dtype=_I32)
        nans[1] += torch.isinf(val).sum(dtype=_I32)
        new = keep_finite(val, v1)[:, None]
    else:
        _, _, sym_flat, diag = _sym(F)
        xb = x[None]
        x2 = x * x
        h = xb * (qB_g - xb * v_c.T[:, :, None])  # [F, C, L]
        she0 = (h * we_g[None] + xb * weq_g).sum(-1)  # [F, C]
        t4u = (wccu_g * x2[None]).sum(-1)  # [P, C]
        sh2 = (((h * h) * wn_g[None] + 2.0 * wc_g * (xb * h)).sum(-1)
               + t4u[torch.from_numpy(diag).to(t4u.device)])
        t1 = torch.einsum("fcl,gcl->gfc", h, h * wn_g[None])
        t2 = torch.einsum("fcl,gcl->gfc", h, xb * wc_g)
        m_x = (t1 + t2 + t2.permute(1, 0, 2)
               + t4u[torch.from_numpy(sym_flat).to(t4u.device)].reshape(
                   F, F, -1))
        zmat = None if z is None else z.index_select(1, cols)
        new, n1, n2 = exact_block_draws(she0, sh2, m_x, v_c, mu_g, lam_g,
                                        alpha, zmat)
        nans[0] += n1
        nans[1] += n2
    v_t[cl] = new
    ptab[cl, F:] = v_c - new


def bs_rel_w_draw_plain(rows, x, cols, group, rtab, ptab, w, mu, lam, alpha,
                        z: Optional[torch.Tensor], bad) -> None:
    """One [C, L] relation bucket of the w sweep (mcmc_bs.py:655-669), in
    place on w [Dr], ptab [Dr, 2] = (w_old, dw) and bad[0:2]."""
    cl = cols.long()
    g = _gather_rows(rtab, rows)
    we_g, wn_g = g[..., 0], g[..., 1]
    w_c = ptab[cl, 0]
    mu_g = mu.index_select(0, group)
    lam_g = lam.index_select(0, group)
    she = (x * we_g).sum(-1)
    sh2 = (x * x * wn_g).sum(-1)
    s2 = 1.0 / (lam_g + alpha * sh2)
    val = -s2 * (alpha * (she - w_c * sh2) - mu_g * lam_g)
    if z is not None:
        val = val + torch.sqrt(s2) * z.index_select(0, cols)
    val = torch.where(torch.isfinite(s2), val, torch.zeros_like(val))
    bad[0] += torch.isnan(val).sum(dtype=_I32)
    bad[1] += torch.isinf(val).sum(dtype=_I32)
    new = keep_finite(val, w_c)
    w[cl] = new
    ptab[cl, 1] = w_c - new


def _launch_draw(kname, rows, x, cols, group, rtab, F, ptab, v_t, mu, lam,
                 alpha, z, nans):
    C, L = rows.shape
    Dr = v_t.shape[0]
    Fo = max(F, 1)
    G = mu.shape[0]
    dev = rows.device
    lay = rel_layout(F)
    req = build.require
    req(rows, _I32, (C, L), dev, f"{kname}.rows")
    req(x, _F32, (C, L), dev, f"{kname}.x")
    req(cols, _I32, (C,), dev, f"{kname}.cols")
    req(group, _I32, (C,), dev, f"{kname}.group")
    req(rtab, _F32, (rtab.shape[0], lay["ld"]), dev, f"{kname}.rtab")
    req(ptab, _F32, (Dr, 2 * Fo), dev, f"{kname}.ptab")
    req(v_t, _F32, (Dr, Fo) if F else (Dr,), dev, f"{kname}.v")
    req(mu, _F32, (G, Fo) if F else (G,), dev, f"{kname}.mu")
    req(lam, _F32, (G, Fo) if F else (G,), dev, f"{kname}.lam")
    req(alpha, _F32, (), dev, f"{kname}.alpha")
    if z is not None:
        req(z, _F32, (Fo, Dr) if F else (Dr,), dev, f"{kname}.z")
    req(nans, _I32, (nans.shape[0],), dev, f"{kname}.nans")
    if C == 0:
        return
    if rel_draw_smem(F) > MAX_BLOCK_SMEM:
        raise ValueError(f"{kname}: F = {F} needs more shared memory than "
                         "one block may take; use a narrower factor_block")
    S, Ls = draw_splits(C, L, _sms(dev))
    part = done = None
    if S > 1:
        part = torch.empty(C * S * draw_outputs(F), dtype=_F32, device=dev)
        done = torch.zeros(C, dtype=_I32, device=dev)
    lib = build.load_library("bs_sweep")
    args = [build.ptr(rows), build.ptr(x), C, L, Ls, S, build.ptr(cols),
            build.ptr(group), build.ptr(rtab)]
    if F:
        args.append(F)
    args += [build.ptr(ptab), build.ptr(v_t), build.ptr(mu), build.ptr(lam),
             build.ptr(alpha), None if z is None else build.ptr(z), Dr,
             build.ptr(nans), None if part is None else build.ptr(part),
             None if done is None else build.ptr(done), build.stream_of(rows)]
    with torch.cuda.device(dev):
        rc = getattr(lib, f"svbfm_{kname}")(*args)
    build.check_launch(lib, rc, kname)


def bs_rel_draw(rows, x, cols, group, rtab, F: int, ptab, v_t, mu, lam,
                alpha, z: Optional[torch.Tensor], nans) -> None:
    if build.on_cpu(rows):
        return bs_rel_draw_plain(rows, x, cols, group, rtab, F, ptab, v_t, mu,
                                 lam, alpha, z, nans)
    if F < 1:
        raise ValueError("bs_rel_draw: F >= 1 (the w sweep is bs_rel_w_draw)")
    _launch_draw("bs_rel_draw", rows, x, cols, group, rtab, F, ptab, v_t, mu,
                 lam, alpha, z, nans)


def bs_rel_w_draw(rows, x, cols, group, rtab, ptab, w, mu, lam, alpha,
                  z: Optional[torch.Tensor], bad) -> None:
    if build.on_cpu(rows):
        return bs_rel_w_draw_plain(rows, x, cols, group, rtab, ptab, w, mu,
                                   lam, alpha, z, bad)
    _launch_draw("bs_rel_w_draw", rows, x, cols, group, rtab, 0, ptab, w, mu,
                 lam, alpha, z, bad)


# ---- X10c -------------------------------------------------------------------

def bs_rel_patch_plain(rids, rvals, pos, ptab, F: int, rtab, dy) -> None:
    """Patch rtab (qB, we, weq) and dy [R, F] over the positions ``pos`` (an
    int32 tensor) in order: the blocked grouping (mcmc_bs.py:442-453) at
    F >= 2, the factor-sequential one (:802-810) at F = 1."""
    lay = rel_layout(F)
    we, weq, wc, wcc, wn = (lay[k] for k in ("we", "weq", "wc", "wcc", "wn"))
    R = rids.shape[0]
    for p in pos.tolist():
        gp = ptab.index_select(0, rids[:, p])  # [R, 2F]
        xp = rvals[:, p, None]
        v_e, dv_e = gp[:, :F], gp[:, F:]
        qB = rtab[:, :F]
        h_e = xp * (qB - xp * v_e)  # [R, F]
        if F == 1:
            d = dv_e[:, 0]
            h = h_e[:, 0]
            x1 = xp[:, 0]
            new_we = rtab[:, we] - d * (h * rtab[:, wn] + x1 * rtab[:, wc])
            new_weq = rtab[:, weq] - d * (h * rtab[:, wc] + x1 * rtab[:, wcc])
        else:
            _, _, sym_flat, _ = _sym(F)
            wc_r = rtab[:, wc:wc + F]
            wcc_full = rtab[:, wcc:wcc + lay["P"]][
                :, torch.from_numpy(sym_flat).to(rtab.device)].reshape(R, F, F)
            s1 = (dv_e * h_e).sum(1)
            new_we = rtab[:, we] - (s1 * rtab[:, wn]
                                    + xp[:, 0] * (dv_e * wc_r).sum(1))
            new_weq = rtab[:, weq:weq + F] - (
                s1[:, None] * wc_r
                + xp * torch.einsum("rg,rgf->rf", dv_e, wcc_full))
        dy -= dv_e * h_e
        rtab[:, :F] = qB - xp * dv_e
        rtab[:, we] = new_we
        rtab[:, weq:weq + F] = new_weq.reshape(R, F)


def bs_rel_w_patch_plain(rids, rvals, pos, ptab, rtab, dy) -> None:
    """The w sweep's patch (mcmc_bs.py:672-676): we -= x dw wn, dy -= x dw
    over the positions ``pos`` in order; ptab [Dr, 2] = (w_old, dw)."""
    for p in pos.tolist():
        dv_e = ptab[:, 1].index_select(0, rids[:, p])
        xp = rvals[:, p]
        rtab[:, 0] = rtab[:, 0] - xp * dv_e * rtab[:, 1]
        dy[:, 0] = dy[:, 0] - xp * dv_e


def _launch_patch(kname, rids, rvals, pos, ptab, F, rtab, dy):
    R, Pr = rids.shape
    Fo = max(F, 1)
    dev = rids.device
    req = build.require
    req(rids, _I32, (R, Pr), dev, f"{kname}.rids")
    req(rvals, _F32, (R, Pr), dev, f"{kname}.rvals")
    req(pos, _I32, (pos.shape[0],), dev, f"{kname}.pos")
    req(ptab, _F32, (ptab.shape[0], 2 * Fo), dev, f"{kname}.ptab")
    req(rtab, _F32, (R, rel_layout(F)["ld"]), dev, f"{kname}.rtab")
    req(dy, _F32, (R, Fo), dev, f"{kname}.dy")
    if R == 0 or pos.shape[0] == 0:
        return
    lib = build.load_library("bs_sweep")
    args = [build.ptr(rids), build.ptr(rvals), R, Pr, build.ptr(pos),
            pos.shape[0], build.ptr(ptab)]
    if F:
        args.append(F)
    args += [build.ptr(rtab), build.ptr(dy), build.stream_of(rids)]
    with torch.cuda.device(dev):
        rc = getattr(lib, f"svbfm_{kname}")(*args)
    build.check_launch(lib, rc, kname)


def bs_rel_patch(rids, rvals, pos, ptab, F: int, rtab, dy) -> None:
    if build.on_cpu(rids):
        return bs_rel_patch_plain(rids, rvals, pos, ptab, F, rtab, dy)
    if F < 1:
        raise ValueError("bs_rel_patch: F >= 1 (the w sweep is "
                         "bs_rel_w_patch)")
    _launch_patch("bs_rel_patch", rids, rvals, pos, ptab, F, rtab, dy)


def bs_rel_w_patch(rids, rvals, pos, ptab, rtab, dy) -> None:
    if build.on_cpu(rids):
        return bs_rel_w_patch_plain(rids, rvals, pos, ptab, rtab, dy)
    _launch_patch("bs_rel_w_patch", rids, rvals, pos, ptab, 0, rtab, dy)
