"""X8a and X8b: the Gibbs MCMC / ALS factor-block sweep
(``csrc/mcmc_sweep.cu``).

``mcmc_col_draw`` (X8a) computes one degree bucket's per-column statistics
(s0 = sum h e, sh2 = sum h^2 and the cross-factor matrix M = sum h h^T) and
draws the bucket's F factors with exact sequential conditionals (or, with
``exact_seq=False``, factor-Jacobi, ALS only); ``mcmc_patch_rows`` (X8b)
patches the row caches q and e after a bin.  On CUDA tensors each op
launches its hand-written kernel; on CPU tensors it runs the plain PyTorch
twin beside it, the JAX arithmetic vectorised over the bucket or the rows:
h as a [C, L, F] tensor, M by ``einsum`` in float32, and the draw by
``exact_block_draws``, the batched unit-lower-triangular solve with the
sequential loop when any result is not finite.  Both update their outputs
in place, kernel and twin alike.

Layouts (see ``csrc/mcmc_sweep.cu``): row cache q [N, F]; factor table
v_t [D, F]; the per-bin patch table ptab [D, 2F] = (pre-bin v, dv =
v_old - v_new), dv zeroed before each bin; group priors mu/lam [G, F]; the
noise table z [F, D] or None (ALS); ``nans`` an int32 [2] counter of the NaN
and Inf draws.  MCMC's e is yhat - y.

X8a's form is a function of F, the mode and the bucket's shape
(``col_draw_form``): at F = 1 lanes a column and the width of their loads
(also of the alignment, ``col_draw_f1_plan``), in the exact mode at
2 <= F <= 4 lanes a column and several columns a block, else a block a
column; X8b's
(a thread a row at F = 1, else a row's factor chunks over lanes, several
rows a warp) of F and the alignment of q and ptab, ``patch_plan``.

``mcmc_col_draw_window`` (X14a) is X8a's window-accumulating mode, the v
sweep of the out-of-core Gibbs/ALS (``learners/mcmc_windowed.py``): a
bucket is one window's view, each column's sums (s0 | sh2 | M packed, the
strict upper triangle in row order: ``col_outputs`` a column) go into an
accumulator in window order, and the last window draws exactly from the
totals (replaces ``svbfm_tpu/learners/mcmc_windowed.py``'s ``make_stats``
:339-365 and ``make_draw`` :367-398).

``mcmc_col_grad`` (X9d's v half) is X8a's gradient mode, the v columns of
the full-batch exp_sgd: the same s0 = sum h e from the pre-bin e (here
stdev yhat - y) and the step v' = keep_finite(v - lr (s0 + regv v) / N, v)
for all F factors at once; it fills ``ptab``'s dv channels, so X8b patches
q and e as after a draw (``svbfm_tpu/learners/exp_sgd.py:exp_sgd_sweep``,
:120-143).

``tp_col_draw_stats`` + ``tp_col_draw`` (T7) are X14a's window modes on
a feature shard of the feature-sharded Gibbs/ALS (``parallel/tp_mcmc.py``):
the stats launch puts a bucket's packed sums over the data shard's rows
into an accumulator (its first window, not its last), and after the
caller's data all-reduce the draw launch draws from it (its last window on
a bucket of no slots), exactly or, under ``-factor_jacobi`` ALS, from
(s0 | sh2) alone; columns are local ids and the padding column (D_loc) is
skipped (``svbfm_tpu/parallel/tp_mcmc.py:239-283``).
``tp_mcmc_patch_delta`` (T8) is X8b's delta mode over the shard's ids: the
bin's dq and de against the pre-patch q, written to one buffer for the
caller's feature all-reduce (:284-301).

Replaces ``svbfm_tpu/learners/mcmc.py:_v_block_pass`` → ``tile_stats``
(:371-391) + ``exact_block_draws`` (:137-200) or the factor-Jacobi draws
(:449-459), and ``patch_tile`` (:468-478); at F = 1 the bucket body and the
patch of ``v_factor_main_bins`` (:684-718).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.learners.base import keep_finite

_I32, _F32 = torch.int32, torch.float32

#: the dynamic shared memory one block may take on sm_90 (227 KiB)
MAX_BLOCK_SMEM = 227 * 1024
_TILE = 32  # csrc/mcmc_sweep.cu kTile


def col_draw_smem(F: int, exact_seq: bool, grad: bool = False) -> int:
    """Bytes of shared memory X8a's block takes at F >= 2 (the
    accumulators s0, sh2 and, in the exact mode, the packed M; the gradient
    mode s0 alone; the h tile; the column's v and priors), as
    ``csrc/mcmc_sweep.cu:col_draw_smem``."""
    npair = F * (F - 1) // 2 if exact_seq else 0
    nout = F if grad else 2 * F + npair
    return 4 * (nout + F * (_TILE + 1) + _TILE + 4 * F)


# The widest blocks the learners give X8a, by mode (exact sequential
# draw, Jacobi): the widths learners/mcmc.py:factor_width has always picked
MAX_COL_F = {True: 303, False: 1451}


def col_draw_fits(F: int, exact_seq: bool) -> bool:
    """Whether the learners give X8a a block of F factors: F = 1, or F up
    to MAX_COL_F of the mode, where its block fits the card."""
    return F == 1 or (F <= MAX_COL_F[exact_seq]
                      and col_draw_smem(F, exact_seq) <= MAX_BLOCK_SMEM)


class F1Plan(NamedTuple):
    """X8a's form at F = 1 for a [C, L] bucket: ``lanes`` a column (a power
    of two; past 32, 2-4 warps) and ``vec`` the slots a lane loads at once
    (16-, 8- or 4-byte loads of rows and x)."""
    lanes: int
    vec: int


def col_draw_f1_lanes(C: int, L: int) -> int:
    """X8a's lanes a column at F = 1 (``csrc/mcmc_sweep.cu:f1_lanes``): the
    next power of two >= L where L <= 16, else a warp, 8 slots a lane, or
    2-4 warps on long columns (more than 256 slots, or 128 in a bucket of
    fewer than 2,048 columns)."""
    if L <= 16:
        G = 1
        while G < L:
            G *= 2
        return G
    per = 128 if C < 2048 else 256
    return 32 * min(4, -(-L // per))


#: the widest block X8a's exact mode takes in its lanes form
LANES_MAX_F = 4


#: the blocks a lanes form spreads a small bucket over
#: (``csrc/svbfm_common.cuh`` kSpreadBlocks)
SPREAD_BLOCKS = 128


def col_draw_lanes(C: int, L: int) -> int:
    """X8a's lanes a column in its lanes form (``csrc/mcmc_sweep.cu:
    col_lanes``): the next power of two >= L / 8 (L / 4 in a bucket of
    fewer than 2,048 columns), at least the draw's group of 4 lanes, at
    most a warp."""
    per = 4 if C < 2048 else 8
    U = 4
    while U < 32 and U * per < L:
        U *= 2
    return U


def lanes_block_cols(C: int, U: int) -> int:
    """Columns a block of a lanes form (X8a's, K3's), U lanes a column on C
    columns (``csrc/svbfm_common.cuh:lanes_block_cols``): about
    SPREAD_BLOCKS blocks, but 64 to 256 threads a block."""
    return max(64 // U, min(256 // U, -(-C // SPREAD_BLOCKS)))


class DrawForm(NamedTuple):
    """X8a's (and X14a's) form on a [C, L] bucket: "f1" (F = 1, ``lanes``
    a column), "lanes" (the exact mode at 2 <= F <= 4, ``lanes`` a column,
    ``cols`` columns a block) or "block" (a block of ``lanes`` threads a
    column)."""
    form: str
    lanes: int
    cols: int = 1


def col_draw_form(F: int, C: int, L: int, mode: str = "exact") -> DrawForm:
    """The form ``csrc/mcmc_sweep.cu``'s entries launch for an F-factor
    block on a [C, L] bucket in ``mode`` ("exact", "jacobi" or "grad";
    X14a takes the exact mode's): at F = 1 ``col_draw_f1_lanes``; the
    exact mode at 2 <= F <= LANES_MAX_F the lanes form (``col_draw_lanes``
    a column, ``lanes_block_cols`` columns a block); else a block a column, of
    256 threads where it owns more than 128 sums, else 128."""
    if F == 1:
        return DrawForm("f1", col_draw_f1_lanes(C, L))
    if mode == "exact" and F <= LANES_MAX_F:
        U = col_draw_lanes(C, L)
        return DrawForm("lanes", U, lanes_block_cols(C, U))
    nout = F if mode == "grad" else 2 * F + (
        F * (F - 1) // 2 if mode == "exact" else 0)
    return DrawForm("block", 256 if nout > 128 else 128)


def col_draw_f1_plan(rows, x) -> F1Plan:
    """X8a's form at F = 1 for the bucket ``rows``/``x`` [C, L]
    (``csrc/mcmc_sweep.cu:f1_lanes`` and ``f1_vec``)."""
    C, L = rows.shape
    G = col_draw_f1_lanes(C, L)
    a = rows.data_ptr() | x.data_ptr()
    if G < 32:
        vec = 1
    elif L % 4 == 0 and a % 16 == 0:
        vec = 4
    elif L % 2 == 0 and a % 8 == 0:
        vec = 2
    else:
        vec = 1
    return F1Plan(G, vec)


class PatchPlan(NamedTuple):
    """X8b's form: "rows" (F = 1, a thread a row) or "chunks" (F >= 2:
    ``lanes`` lanes a row over chunks of ``vec`` factors, 16-, 8- or
    4-byte loads of q and ptab); ``rows`` rows a warp."""
    form: str
    vec: int
    lanes: int
    rows: int


def patch_plan(ptab, F: int, q) -> PatchPlan:
    """X8b's form for its ptab [D, 2F] and q [N, F]
    (``csrc/mcmc_sweep.cu:svbfm_mcmc_patch_rows``): at F >= 2 the widest
    of 4, 2, 1 factors a chunk that divides F and to whose size both bases
    are aligned, min(F / vec, 32) lanes a row and 32 // lanes rows a warp
    (5 lanes and 6 rows at F = 20)."""
    if F == 1:
        return PatchPlan("rows", 1, 1, 32)
    vec = 4 if F % 4 == 0 else 2 if F % 2 == 0 else 1
    a = q.data_ptr() | ptab.data_ptr()
    while vec > 1 and a % (4 * vec):
        vec //= 2
    lanes = min(F // vec, 32)
    return PatchPlan("chunks", vec, lanes, 32 // lanes)


def _draw_mean(she, sh2, v_c, mu_g, lam_g, alpha, z):
    """The conditional draw with the bad-sigma guard (mcmc.py:177-183)."""
    s2 = 1.0 / (lam_g + alpha * sh2)
    val = -s2 * (alpha * (she - v_c * sh2) - mu_g * lam_g)
    if z is not None:
        val = val + torch.sqrt(s2) * z
    return torch.where(torch.isfinite(s2), val, torch.zeros_like(val))


def exact_block_draws(s0, sh2_all, m_x, v_c, mu_g, lam_g, alpha, zmat):
    """Draw one bucket's F factors with exact sequential conditionals
    (``svbfm_tpu/learners/mcmc.py:exact_block_draws``).

    The recurrence new_v_f = base_f + s2_f alpha corr_f, corr_f =
    sum_{g<f} (v_g - new_v_g) M[g, f], is, in d = v - new_v, one batched
    unit-lower-triangular solve.  A non-finite result falls back to the
    sequential loop, which applies the reference's guards factor by factor.

    s0/sh2_all: [F, C]; m_x: [F, F, C]; v_c/mu_g/lam_g: [C, F]; zmat: [F, C]
    noise or None (ALS).  Returns (new_v [C, F], nan_count, inf_count), the
    counts int32 device scalars."""
    F, C = s0.shape
    s2m = 1.0 / (lam_g + alpha * sh2_all.T)  # [C, F]
    base = -s2m * (alpha * (s0.T - v_c * sh2_all.T) - mu_g * lam_g)
    if zmat is not None:
        base = base + torch.sqrt(s2m) * zmat.T
    tl = torch.tril(torch.ones(F, F, dtype=_F32, device=s0.device), -1)
    tmat = (alpha * s2m)[:, :, None] * m_x.permute(2, 1, 0) * tl[None]
    dsol = torch.linalg.solve_triangular(
        tmat, (v_c - base)[:, :, None], upper=False, unitriangular=True)
    val_solve = v_c - dsol[:, :, 0]
    zero = torch.zeros((), dtype=_I32, device=s0.device)
    if bool(torch.isfinite(val_solve).all() and torch.isfinite(s2m).all()):
        return val_solve, zero, zero
    corr = torch.zeros(F, C, dtype=_F32, device=s0.device)
    nan_c, inf_c = zero, zero
    new_cols = []
    for f in range(F):
        v_cf = v_c[:, f]
        val = _draw_mean(s0[f] - corr[f], sh2_all[f], v_cf, mu_g[:, f],
                         lam_g[:, f], alpha,
                         None if zmat is None else zmat[f])
        nan_c = nan_c + torch.isnan(val).sum(dtype=_I32)
        inf_c = inf_c + torch.isinf(val).sum(dtype=_I32)
        new_v = keep_finite(val, v_cf)
        corr = corr + (v_cf - new_v)[None, :] * m_x[f]
        new_cols.append(new_v)
    return torch.stack(new_cols, dim=1), nan_c, inf_c


# ---- X8a --------------------------------------------------------------------

def _col_sums(rows, x, cols, e, q, ptab, F: int, exact_seq: bool):
    """One [C, L] bucket's column sums from the pre-bin v of ``ptab``:
    s0, sh2 [F, C] and, with ``exact_seq``, M [F, F, C] (else None)."""
    C, L = rows.shape
    v_c = ptab[cols.long(), :F]  # [C, F] pre-bin
    ridx = rows.reshape(-1)
    e_g = e.index_select(0, ridx).reshape(C, L)
    q_g = q.index_select(0, ridx).reshape(C, L, F)
    xb = x[:, :, None]
    h = xb * (q_g - xb * v_c[:, None, :])  # [C, L, F]
    s0 = (h * e_g[:, :, None]).sum(1).T  # [F, C]
    sh2 = (h * h).sum(1).T
    m_x = torch.einsum("clf,clg->fgc", h, h) if exact_seq else None
    return s0, sh2, m_x


def _col_draw(s0, sh2, m_x, cols, group, ptab, v_t, mu, lam, alpha, z,
              nans) -> None:
    """Draw the bucket's columns from their sums (exactly where ``m_x`` is
    given, else factor-Jacobi), in place on v_t, ptab's dv channels and
    nans."""
    F = v_t.shape[1]
    cl = cols.long()
    v_c = ptab[cl, :F]  # [C, F] pre-bin
    mu_g = mu.index_select(0, group)
    lam_g = lam.index_select(0, group)
    zc = None if z is None else z.index_select(1, cols)  # [F, C]
    if m_x is not None:
        new, nan_c, inf_c = exact_block_draws(s0, sh2, m_x, v_c, mu_g, lam_g,
                                              alpha, zc)
    else:
        # factor-Jacobi (mcmc.py:449-459): all F from the pre-bin e
        val = _draw_mean(s0.T, sh2.T, v_c, mu_g, lam_g, alpha,
                         None if zc is None else zc.T)
        nan_c = torch.isnan(val).sum(dtype=_I32)
        inf_c = torch.isinf(val).sum(dtype=_I32)
        new = keep_finite(val, v_c)
    v_t[cl] = new
    ptab[cl, F:] = v_c - new
    nans[0] += nan_c
    nans[1] += inf_c


def mcmc_col_draw_plain(rows, x, cols, group, e, q, ptab, v_t, mu, lam, alpha,
                        z: Optional[torch.Tensor], exact_seq: bool,
                        nans) -> None:
    s0, sh2, m_x = _col_sums(rows, x, cols, e, q, ptab, v_t.shape[1],
                             exact_seq)
    _col_draw(s0, sh2, m_x, cols, group, ptab, v_t, mu, lam, alpha, z, nans)


def mcmc_col_draw(rows, x, cols, group, e, q, ptab, v_t, mu, lam, alpha,
                  z: Optional[torch.Tensor], exact_seq: bool, nans) -> None:
    if build.on_cpu(rows):
        return mcmc_col_draw_plain(rows, x, cols, group, e, q, ptab, v_t, mu,
                                   lam, alpha, z, exact_seq, nans)
    C, L = rows.shape
    D, F = v_t.shape
    G = mu.shape[0]
    dev = rows.device
    req = build.require
    req(rows, _I32, (C, L), dev, "mcmc_col_draw.rows")
    req(x, _F32, (C, L), dev, "mcmc_col_draw.x")
    req(cols, _I32, (C,), dev, "mcmc_col_draw.cols")
    req(group, _I32, (C,), dev, "mcmc_col_draw.group")
    req(e, _F32, (e.shape[0],), dev, "mcmc_col_draw.e")
    req(q, _F32, (e.shape[0], F), dev, "mcmc_col_draw.q")
    req(ptab, _F32, (D, 2 * F), dev, "mcmc_col_draw.ptab")
    req(v_t, _F32, (D, F), dev, "mcmc_col_draw.v_t")
    req(mu, _F32, (G, F), dev, "mcmc_col_draw.mu")
    req(lam, _F32, (G, F), dev, "mcmc_col_draw.lam")
    req(alpha, _F32, (), dev, "mcmc_col_draw.alpha")
    if z is not None:
        req(z, _F32, (F, D), dev, "mcmc_col_draw.z")
    req(nans, _I32, (2,), dev, "mcmc_col_draw.nans")
    if C == 0 or F == 0:
        return
    if not col_draw_fits(F, exact_seq):
        raise ValueError(
            f"mcmc_col_draw: F = {F} is wider than the {MAX_COL_F[exact_seq]} "
            f"factors a block of this mode takes (it needs "
            f"{col_draw_smem(F, exact_seq)} bytes of shared memory of the "
            f"{MAX_BLOCK_SMEM} one block may take); use a narrower "
            f"factor_block")
    lib = build.load_library("mcmc_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_mcmc_col_draw(
            build.ptr(rows), build.ptr(x), C, L, build.ptr(cols),
            build.ptr(group), build.ptr(e), build.ptr(q), F, build.ptr(ptab),
            build.ptr(v_t), build.ptr(mu), build.ptr(lam), build.ptr(alpha),
            None if z is None else build.ptr(z), D, int(exact_seq),
            build.ptr(nans), build.stream_of(rows))
    build.check_launch(lib, rc, "mcmc_col_draw")


# ---- X14a: X8a over the windows of the out-of-core Gibbs/ALS ---------------

def col_outputs(F: int) -> int:
    """The sums X14a keeps a column (``csrc/mcmc_sweep.cu:col_outputs`` of
    the exact mode): s0 [F], sh2 [F], the strict upper triangle of M."""
    return 2 * F + F * (F - 1) // 2


def pack_sums(s0, sh2, m_x) -> torch.Tensor:
    """The [C, col_outputs(F)] rows (s0 | sh2 | M_fg for f < g in row
    order) of a bucket's sums."""
    F = s0.shape[0]
    f, g = torch.triu_indices(F, F, 1, device=s0.device)
    return torch.cat([s0, sh2, m_x[f, g]], 0).T


def unpack_sums(acc):
    """s0, sh2 [F, C] and the symmetric M [F, F, C] (sh2 on its
    diagonal) of ``pack_sums``' rows."""
    C, n = acc.shape
    F = next(F for F in range(n + 1) if col_outputs(F) == n)
    t = acc.T
    s0, sh2 = t[:F], t[F:2 * F]
    m_x = torch.zeros(F, F, C, dtype=acc.dtype, device=acc.device)
    f, g = torch.triu_indices(F, F, 1, device=acc.device)
    m_x[f, g] = t[2 * F:]
    m_x[g, f] = t[2 * F:]
    d = torch.arange(F, device=acc.device)
    m_x[d, d] = sh2
    return s0, sh2, m_x


def mcmc_col_draw_window_plain(rows, x, cols, group, e, q, ptab, v_t, mu, lam,
                               alpha, z: Optional[torch.Tensor], nans, acc,
                               first: bool, last: bool) -> None:
    """One window's [C, L] view of a bucket (rows local to the window's
    caches e, q): its packed sums go into ``acc`` [C, col_outputs(F)],
    written at the first window and added to (acc + part) at the later
    ones; the last window draws exactly from the accumulated sums.  One
    window (first and last) is ``mcmc_col_draw_plain``'s exact mode."""
    part = pack_sums(*_col_sums(rows, x, cols, e, q, ptab, v_t.shape[1],
                                True))
    tot = part if first else acc + part
    if not last:
        acc.copy_(tot)
        return
    _col_draw(*unpack_sums(tot), cols, group, ptab, v_t, mu, lam, alpha, z,
              nans)


def mcmc_col_draw_window(rows, x, cols, group, e, q, ptab, v_t, mu, lam,
                         alpha, z: Optional[torch.Tensor], nans, acc,
                         first: bool, last: bool) -> None:
    if build.on_cpu(rows):
        return mcmc_col_draw_window_plain(rows, x, cols, group, e, q, ptab,
                                          v_t, mu, lam, alpha, z, nans, acc,
                                          first, last)
    C, L = rows.shape
    D, F = v_t.shape
    G = mu.shape[0]
    N = e.shape[0]
    dev = rows.device
    req = build.require
    name = "mcmc_col_draw_window"
    req(rows, _I32, (C, L), dev, f"{name}.rows")
    req(x, _F32, (C, L), dev, f"{name}.x")
    req(cols, _I32, (C,), dev, f"{name}.cols")
    req(group, _I32, (C,), dev, f"{name}.group")
    req(e, _F32, (N,), dev, f"{name}.e")
    req(q, _F32, (N, F), dev, f"{name}.q")
    req(ptab, _F32, (D, 2 * F), dev, f"{name}.ptab")
    req(v_t, _F32, (D, F), dev, f"{name}.v_t")
    req(mu, _F32, (G, F), dev, f"{name}.mu")
    req(lam, _F32, (G, F), dev, f"{name}.lam")
    req(alpha, _F32, (), dev, f"{name}.alpha")
    if z is not None:
        req(z, _F32, (F, D), dev, f"{name}.z")
    req(nans, _I32, (2,), dev, f"{name}.nans")
    req(acc, _F32, (C, col_outputs(F)), dev, f"{name}.acc")
    if C == 0 or F == 0:
        return
    if not col_draw_fits(F, True):
        raise ValueError(
            f"{name}: F = {F} is wider than the {MAX_COL_F[True]} factors "
            f"a block of the exact mode takes (it needs "
            f"{col_draw_smem(F, True)} bytes of shared memory of the "
            f"{MAX_BLOCK_SMEM} one block may take); use a narrower "
            f"factor_block")
    lib = build.load_library("mcmc_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_mcmc_col_draw_window(
            build.ptr(rows), build.ptr(x), C, L, build.ptr(cols),
            build.ptr(group), build.ptr(e), build.ptr(q), F, build.ptr(ptab),
            build.ptr(v_t), build.ptr(mu), build.ptr(lam), build.ptr(alpha),
            None if z is None else build.ptr(z), D, build.ptr(nans),
            build.ptr(acc), int(first) | 2 * int(last),
            build.stream_of(rows))
    build.check_launch(lib, rc, name)


# ---- X9d: X8a's gradient mode ----------------------------------------------

def mcmc_col_grad_plain(rows, x, cols, e, q, ptab, v_t, lr: float, reg: float,
                        n_cases: float) -> None:
    """One [C, L] bucket of the exp_sgd v sweep (exp_sgd.py:125-136), in
    place on v_t and ptab's dv channels at the bucket's columns."""
    C, L = rows.shape
    F = v_t.shape[1]
    cl = cols.long()
    v_c = ptab[cl, :F]  # [C, F] pre-bin
    ridx = rows.reshape(-1)
    e_g = e.index_select(0, ridx).reshape(C, L, 1)
    q_g = q.index_select(0, ridx).reshape(C, L, F)
    xb = x[:, :, None]
    h = xb * (q_g - xb * v_c[:, None, :])
    v_sum = (h * e_g).sum(1)  # [C, F]
    n = torch.full((), n_cases, dtype=_F32, device=v_t.device)
    new = keep_finite(v_c - lr * (v_sum + reg * v_c) / n, v_c)
    v_t[cl] = new
    ptab[cl, F:] = v_c - new


def mcmc_col_grad(rows, x, cols, e, q, ptab, v_t, lr: float, reg: float,
                  n_cases: float) -> None:
    if build.on_cpu(rows):
        return mcmc_col_grad_plain(rows, x, cols, e, q, ptab, v_t, lr, reg,
                                   n_cases)
    C, L = rows.shape
    D, F = v_t.shape
    dev = rows.device
    req = build.require
    req(rows, _I32, (C, L), dev, "mcmc_col_grad.rows")
    req(x, _F32, (C, L), dev, "mcmc_col_grad.x")
    req(cols, _I32, (C,), dev, "mcmc_col_grad.cols")
    req(e, _F32, (e.shape[0],), dev, "mcmc_col_grad.e")
    req(q, _F32, (e.shape[0], F), dev, "mcmc_col_grad.q")
    req(ptab, _F32, (D, 2 * F), dev, "mcmc_col_grad.ptab")
    req(v_t, _F32, (D, F), dev, "mcmc_col_grad.v_t")
    if C == 0 or F == 0:
        return
    if F > 1 and col_draw_smem(F, False, grad=True) > MAX_BLOCK_SMEM:
        raise ValueError(
            f"mcmc_col_grad: a block of F = {F} factors needs "
            f"{col_draw_smem(F, False, grad=True)} bytes of shared memory, "
            f"more than the {MAX_BLOCK_SMEM} one block may take; use a "
            f"narrower factor_block")
    lib = build.load_library("mcmc_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_mcmc_col_grad(
            build.ptr(rows), build.ptr(x), C, L, build.ptr(cols),
            build.ptr(e), build.ptr(q), F, build.ptr(ptab), build.ptr(v_t),
            lr, reg, n_cases, build.stream_of(rows))
    build.check_launch(lib, rc, "mcmc_col_grad")


# ---- X8b --------------------------------------------------------------------

def mcmc_patch_rows_plain(ptab, F: int, ids, vals, q, e) -> None:
    """q [N, F] -= sum_p x dv, e [N] -= sum_p sum_f h dv with h from the
    pre-bin q at every position (in place)."""
    dq = torch.zeros_like(q)
    de = torch.zeros_like(e)
    for p in range(ids.shape[1]):
        gg = ptab.index_select(0, ids[:, p])  # [N, 2F]
        xp = vals[:, p, None]
        v_e, dv_e = gg[:, :F], gg[:, F:]
        h_e = xp * (q - xp * v_e)
        dq += xp * dv_e
        de += (h_e * dv_e).sum(1)
    q -= dq
    e -= de


def mcmc_patch_rows(ptab, F: int, ids, vals, q, e) -> None:
    if build.on_cpu(ids):
        return mcmc_patch_rows_plain(ptab, F, ids, vals, q, e)
    N, P = ids.shape
    dev = ids.device
    req = build.require
    req(ptab, _F32, (ptab.shape[0], 2 * F), dev, "mcmc_patch_rows.ptab")
    req(ids, _I32, (N, P), dev, "mcmc_patch_rows.ids")
    req(vals, _F32, (N, P), dev, "mcmc_patch_rows.vals")
    req(q, _F32, (N, F), dev, "mcmc_patch_rows.q")
    req(e, _F32, (N,), dev, "mcmc_patch_rows.e")
    if N == 0 or F == 0 or P == 0:
        return
    lib = build.load_library("mcmc_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_mcmc_patch_rows(
            build.ptr(ptab), F, build.ptr(ids), build.ptr(vals), N, P,
            build.ptr(q), build.ptr(e), build.stream_of(ids))
    build.check_launch(lib, rc, "mcmc_patch_rows")


# ---- T7: X14a's window modes on a feature shard ----------------------------

def tp_col_outputs(F: int, exact: bool) -> int:
    """The sums T7 keeps a column: X14a's (``col_outputs``), or (s0 | sh2)
    under factor-Jacobi."""
    return col_outputs(F) if exact else 2 * F


def tp_col_draw_stats_plain(rows, x, cols, D_loc: int, e, q, ptab, F: int,
                            exact: bool) -> torch.Tensor:
    """T7's stats twin: acc [C, tp_col_outputs(F, exact)], the packed sums
    of a [C, L] bucket's columns over this data shard's rows; a padding
    column (local id D_loc) gets a zero row."""
    real = cols != D_loc
    cl = torch.where(real, cols, torch.zeros_like(cols))
    s0, sh2, m_x = _col_sums(rows, x, cl, e, q, ptab, F, exact)
    acc = pack_sums(s0, sh2, m_x) if exact else torch.cat([s0, sh2], 0).T
    return torch.where(real[:, None], acc,
                       torch.zeros((), dtype=_F32,
                                   device=acc.device)).contiguous()


def tp_col_draw_stats(rows, x, cols, D_loc: int, e, q, ptab, F: int,
                      exact: bool) -> torch.Tensor:
    """T7, stats launch: kernel on CUDA tensors, plain twin on CPU
    tensors."""
    if build.on_cpu(rows):
        return tp_col_draw_stats_plain(rows, x, cols, D_loc, e, q, ptab, F,
                                       exact)
    C, L = rows.shape
    N = e.shape[0]
    dev = rows.device
    req = build.require
    name = "tp_col_draw_stats"
    req(rows, _I32, (C, L), dev, f"{name}.rows")
    req(x, _F32, (C, L), dev, f"{name}.x")
    req(cols, _I32, (C,), dev, f"{name}.cols")
    req(e, _F32, (N,), dev, f"{name}.e")
    req(q, _F32, (N, F), dev, f"{name}.q")
    req(ptab, _F32, (D_loc, 2 * F), dev, f"{name}.ptab")
    acc = torch.zeros(C, tp_col_outputs(F, exact), dtype=_F32, device=dev)
    if C == 0 or F == 0:
        return acc
    _check_fits(name, F, exact)
    lib = build.load_library("mcmc_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_col_draw_stats(
            build.ptr(rows), build.ptr(x), C, L, build.ptr(cols),
            build.ptr(e), build.ptr(q), F, build.ptr(ptab), D_loc,
            int(exact), build.ptr(acc), build.stream_of(rows))
    build.check_launch(lib, rc, name)
    return acc


def tp_col_draw_plain(acc, cols, group, D_loc: int, ptab, v_t, mu, lam,
                      alpha, z, exact: bool, nans) -> None:
    """T7's draw twin: X8a's draw (exact, or factor-Jacobi) at the
    bucket's real columns from their summed sums ``acc``, in place on v_t,
    ptab's dv channels and nans."""
    F = v_t.shape[1]
    real = cols != D_loc
    acc = acc[real]
    if exact:
        s0, sh2, m_x = unpack_sums(acc)
    else:
        s0, sh2, m_x = acc[:, :F].T, acc[:, F:].T, None
    _col_draw(s0, sh2, m_x, cols[real], group[real], ptab, v_t, mu, lam,
              alpha, z, nans)


def tp_col_draw(acc, cols, group, D_loc: int, ptab, v_t, mu, lam, alpha,
                z: Optional[torch.Tensor], exact: bool, nans) -> None:
    """T7, draw launch (reads ``acc``, no rows): kernel on CUDA tensors,
    plain twin on CPU tensors; in place.  ``z`` the [F, D_loc] noise
    table, or None (ALS)."""
    if build.on_cpu(acc):
        return tp_col_draw_plain(acc, cols, group, D_loc, ptab, v_t, mu, lam,
                                 alpha, z, exact, nans)
    C = cols.shape[0]
    F = v_t.shape[1]
    G = mu.shape[0]
    dev = acc.device
    req = build.require
    name = "tp_col_draw"
    req(acc, _F32, (C, tp_col_outputs(F, exact)), dev, f"{name}.acc")
    req(cols, _I32, (C,), dev, f"{name}.cols")
    req(group, _I32, (C,), dev, f"{name}.group")
    req(ptab, _F32, (D_loc, 2 * F), dev, f"{name}.ptab")
    req(v_t, _F32, (D_loc, F), dev, f"{name}.v_t")
    req(mu, _F32, (G, F), dev, f"{name}.mu")
    req(lam, _F32, (G, F), dev, f"{name}.lam")
    req(alpha, _F32, (), dev, f"{name}.alpha")
    if z is not None:
        req(z, _F32, (F, D_loc), dev, f"{name}.z")
    req(nans, _I32, (2,), dev, f"{name}.nans")
    if C == 0 or F == 0:
        return
    _check_fits(name, F, exact)
    lib = build.load_library("mcmc_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_col_draw(
            None, None, C, build.ptr(cols), build.ptr(group), F,
            build.ptr(ptab), build.ptr(v_t), build.ptr(mu), build.ptr(lam),
            build.ptr(alpha), None if z is None else build.ptr(z), D_loc,
            int(exact), build.ptr(nans), build.ptr(acc),
            build.stream_of(acc))
    build.check_launch(lib, rc, name)


def _check_fits(name: str, F: int, exact: bool) -> None:
    if not col_draw_fits(F, exact):
        raise ValueError(
            f"{name}: F = {F} is wider than the {MAX_COL_F[exact]} factors "
            f"a block of this mode takes (it needs "
            f"{col_draw_smem(F, exact)} bytes of shared memory of the "
            f"{MAX_BLOCK_SMEM} one block may take); use a narrower "
            f"factor_block")


# ---- T8: X8b's delta mode on a feature shard -------------------------------

def tp_mcmc_patch_views(patch, N: int, F: int) -> tuple:
    """T8's output, one buffer of N (F + 1) floats, as dq [N, F] and de
    [N]."""
    return patch[:N * F].view(N, F), patch[N * F:]


def tp_mcmc_patch_delta_plain(ptab, F: int, ids, vals, q, lo: int,
                              D_loc: int) -> torch.Tensor:
    """T8's twin: the bin's dq = sum_p x dv and de = sum_p sum_f x (q - x
    v_old) dv over the ids of the shard [lo, lo + D_loc), against the
    pre-patch q [N, F] (``tp_mcmc_patch_views``' layout)."""
    lid = ids.long() - lo
    inr = (lid >= 0) & (lid < D_loc)
    lidc = lid.clamp(0, max(D_loc - 1, 0))
    zero = torch.zeros((), dtype=_F32, device=ptab.device)
    dq = torch.zeros_like(q)
    de = torch.zeros(q.shape[0], dtype=_F32, device=q.device)
    for p in range(ids.shape[1]):
        gg = ptab.index_select(0, lidc[:, p])  # [N, 2F]
        m = inr[:, p]
        xp = vals[:, p, None]
        v_e, dv_e = gg[:, :F], gg[:, F:]
        h_e = xp * (q - xp * v_e)
        dq = dq + torch.where(m[:, None], xp * dv_e, zero)
        de = de + torch.where(m, (h_e * dv_e).sum(1), zero)
    return torch.cat([dq.reshape(-1), de])


def tp_mcmc_patch_delta(ptab, F: int, ids, vals, q, lo: int,
                        D_loc: int) -> torch.Tensor:
    """T8: kernel on CUDA tensors, plain twin on CPU tensors."""
    if build.on_cpu(ids):
        return tp_mcmc_patch_delta_plain(ptab, F, ids, vals, q, lo, D_loc)
    N, P = ids.shape
    dev = ids.device
    req = build.require
    req(ptab, _F32, (D_loc, 2 * F), dev, "tp_mcmc_patch_delta.ptab")
    req(ids, _I32, (N, P), dev, "tp_mcmc_patch_delta.ids")
    req(vals, _F32, (N, P), dev, "tp_mcmc_patch_delta.vals")
    req(q, _F32, (N, F), dev, "tp_mcmc_patch_delta.q")
    out = torch.zeros(N * (F + 1), dtype=_F32, device=dev)
    if N == 0 or F == 0 or P == 0:
        return out
    lib = build.load_library("mcmc_sweep")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_mcmc_patch_delta(
            build.ptr(ptab), F, lo, D_loc, build.ptr(ids), build.ptr(vals), N,
            P, build.ptr(q), build.ptr(out), build.stream_of(ids))
    build.check_launch(lib, rc, "tp_mcmc_patch_delta")
    return out
