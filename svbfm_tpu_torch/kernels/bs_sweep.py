"""X10a-X10c: the relation sweeps of the native block-structure sampler
(``csrc/bs_sweep.cu``).

``bs_join_agg`` (X10a) sums, per relation row, the channels built from e and
qO = q - qB0 over the data rows joined to it (all degree buckets of a join
plan in one launch; ``join_form``: a group of up to 32 lanes a relation row
at F <= 1, a warp a row to F = 32, a block a row past it, the 4 x 4 tiles
of the row's Gram matrix spread over the block, ``join_block_plan``);
``bs_rel_draw`` (X10b) computes one
relation bucket's she, sh2 and cross-factor matrix M from the relation-row
table and draws the bucket's factors with exact sequential conditionals
(F = 1: the factor-sequential path's draw), in the form ``draw_plan``
picks from F and the bucket's shape, its columns' real entries split over
blocks where they are long (the counts, ``RealCounts``, ride on the
learner's ``RelBlock``); ``bs_rel_patch`` (X10c) patches the relation-row
table and dy after a bin.  ``bs_rel_w_draw`` and ``bs_rel_w_patch`` are
X10b's and X10c's w modes, the relation w sweep; X10a's w mode is
``F = 0`` (e alone).
On CUDA tensors each op launches its hand-written kernel; on CPU tensors it
runs the plain PyTorch twin beside it, the JAX arithmetic vectorised over
the bucket or the relation rows (``einsum`` in float32, the draw by
``mcmc_sweep.exact_block_draws``).  All update their outputs in place.
X10c's form (``patch_plan``) is a function of F: a thread a relation row
at F <= 1, a group of lanes (F <= 32) or a block a row that stages the
row whole in shared memory at F >= 2.

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

from typing import NamedTuple, Optional

import numpy as np
import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.kernels.mcmc_sweep import (MAX_BLOCK_SMEM,
                                                exact_block_draws)
from svbfm_tpu_torch.learners.base import keep_finite

_I32, _F32 = torch.int32, torch.float32
_NARROW_THREADS = 256  # csrc/bs_sweep.cu kNarrowThreads
# the least real entries a block of X10b takes when a column is split
_SPLIT_MIN = 128
# the blocks of X10b's block forms an SM should hold at once: the loads of
# one block's tile, its sums and a column's closing draw overlap the
# others' (the 1M-rating slot bucket at F = 20 on an H100: tiles of 32
# rows at two blocks an SM 0.083 ms, of 25 rows at four 0.070)
_BLOCKS_PER_SM = 4


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


_AGG_WARPS = 4  # csrc/bs_sweep.cu kAggWarps: X10a's warp form, a block
_AGG_ROUND = 32  # kAggRound: the slots a warp reads a round
_AGG_BUFS = 3  # kAggBufs: a warp's buffers, the rounds staged at once
_AGG_MAX_F = 32  # kAggMaxF: the widest F of the warp form
_JOIN_BUFS = 3  # kJoinBufs: the block form's buffers, the rounds staged
# kJoinThreads, kJoinThreadsWide: the widest blocks of the block form at 1
# unit a thread, and at 2 or 3
_JOIN_THREADS = {1: 512, 2: 384, 3: 384}


def join_form(F: int) -> str:
    """X10a's form at F factors (``csrc/bs_sweep.cu:svbfm_bs_join_agg``):
    ``narrow`` (G lanes a relation row) at F <= 1, ``warp`` (a warp a row,
    the warps of a persistent grid walking the rows, the channel sums in
    registers) to F = 32, ``block`` (a block a row, the blocks of a
    persistent grid walking the rows, the sums over its threads) past
    it."""
    if F <= 1:
        return "narrow"
    return "warp" if F <= _AGG_MAX_F else "block"


def agg_stride(F: int) -> int:
    """kS, the floats of an entry the warp form stages at F (q | e | 1 and
    zeros): the next multiple of 8 >= F + 2
    (``csrc/bs_sweep.cu:with_agg_form``)."""
    return -(-(F + 2) // 8) * 8


def join_stride(F: int) -> int:
    """kS of the block form: the floats of an entry (e | 1 | 0 | 0 | q) and
    zeros to a multiple of 8 (``csrc/bs_sweep.cu:join_stride``)."""
    return -(-(F + 4) // 8) * 8


class JoinBlockPlan(NamedTuple):
    """X10a's block form at F: kU, the units (two 4 x 4 Gram tiles over one
    column block) a thread owns, and the threads a block (0 past the
    widest block)."""

    kU: int
    threads: int


def join_block_plan(F: int) -> JoinBlockPlan:
    """The block form's units a thread and threads a block at F
    (``csrc/bs_sweep.cu:join_block_plan``): the kB (kB + 2) / 4 units of
    the Gram upper triangle, kB = join_stride(F) / 4, the fewest of 1, 2, 3
    a thread with which they fit a block (512 threads at 1, 384 at 2 or 3),
    in whole warps."""
    kB = join_stride(F) // 4
    units = kB * (kB + 2) // 4
    kU = next(k for k in (1, 2, 3) if units <= k * _JOIN_THREADS[k] or k == 3)
    threads = -(-(-(-units // kU)) // 32) * 32
    return JoinBlockPlan(kU, threads if threads <= _JOIN_THREADS[kU] else 0)


def join_agg_smem(F: int) -> int:
    """Bytes of shared memory X10a's block takes at F >= 2: kAggBufs
    buffers of a round (``csrc/bs_sweep.cu:agg_buf``) a warp in the warp
    form; in the block form the larger of its two layouts at the least it
    can take, rounds of 16 (``join_block_smem``); the F <= 1 form takes
    none."""
    if join_form(F) == "warp":
        kS = agg_stride(F)
        return 4 * _AGG_WARPS * _AGG_BUFS * (_AGG_ROUND * (kS + 2) + kS + 4)
    return max(join_block_smem(F, raw, 16) for raw in (False, True))


def join_block_smem(F: int, raw: bool, round_: int = 32) -> int:
    """Bytes of shared memory of the block form's block at F in rounds of
    ``round_`` slots (``csrc/bs_sweep.cu:join_block_floats``; the launch
    takes 32 where that fits, unless the SM then holds half as many blocks
    again at 16): kJoinBufs round buffers, each entry's area its t where
    q's rows are 16-byte aligned, else the raw span of its q row with the
    block's one t area after them; at two or three units a thread the
    units' sums between rounds."""
    area = (F + 6) // 4 * 4 if raw else join_stride(F)
    buf = round_ * (area + 3) + -(-F // 4) * 4 + 4
    floats = _JOIN_BUFS * buf + (round_ * join_stride(F) if raw else 0)
    p = join_block_plan(F)
    if p.kU > 1:
        floats += p.kU * 32 * p.threads
    return 4 * floats


def join_fits(F: int) -> bool:
    """Whether X10a takes F factors: every F whose form fits a block (the
    block form's widest, F = 260, past MAX_REL_F)."""
    return join_agg_smem(F) <= MAX_BLOCK_SMEM and (
        join_form(F) != "block" or join_block_plan(F).threads > 0)


def draw_outputs(F: int) -> int:
    Fo = max(F, 1)
    return 2 * Fo + (F * (F - 1) // 2 if F > 1 else 0)


# The widest blocks the learners give X10a and X10b: the widths
# learners/mcmc_bs.py:bs_factor_width has always picked
MAX_REL_F = 251


def rel_draw_fits(F: int) -> bool:
    """Whether the learners give X10a and X10b blocks of F factors: F up to
    MAX_REL_F, where X10a's block and the X10b form draw_form picks (at
    F >= 2 the tiled form without wcc the widest) fit the card."""
    return (F <= MAX_REL_F and join_fits(F)
            and (F <= 1 or tile_rows(F, False) > 0))


# X10b's forms, in the order of their codes (csrc/bs_sweep.cu kForm*): at
# F <= 1 G lanes a column (L <= 32) or a block per (column, split) with the
# threads over the entries; at F >= 2 a warp a column (L <= 32) or a block
# per (column, split) over staged tiles of whole relation rows, or of rows
# without wcc where two tiles of whole rows do not fit
FORMS = ("group", "block", "warp", "tiles", "tiles_l2wcc")
_NARROW_L = 32  # the widest bucket the narrow forms take
_WARP_ROW_FLOATS = 1536  # a warp form's staged rows a round, at most
_MAX_TILE = 32  # rows a tile, at most


class DrawPlan(NamedTuple):
    """How X10b runs one bucket: its form; k, the lanes a column (group,
    warp) or the rows a tile (tiles); S, the splits of a column (the block
    forms; else 1)."""

    form: str
    k: int
    S: int


class RealCounts(NamedTuple):
    """A bucket's real entries a column: its slots up to its last non-zero
    x (the plan lays a column's entries first, its padding after).  ``n``
    int32 [C] on the bucket's device; ``lo`` and ``hi`` the least and the
    most, host integers, so that a launch reads nothing back."""

    n: torch.Tensor
    lo: int
    hi: int


def real_counts(x, device=None) -> RealCounts:
    """The real counts of a [C, L] x: a numpy array (a plan's, as it goes
    to the device) or a tensor (read back to the host: for checks, never
    at a launch)."""
    if torch.is_tensor(x):
        device = x.device if device is None else device
        x = x.detach().cpu().numpy()
    nz = np.asarray(x) != 0
    n = np.where(nz.any(1), nz.shape[1] - np.argmax(nz[:, ::-1], axis=1),
                 0).astype(np.int32)
    lo, hi = (int(n.min()), int(n.max())) if len(n) else (0, 0)
    return RealCounts(torch.from_numpy(n).to(device or "cpu"), lo, hi)


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def warp_slice(F: int, E: int) -> int:
    """Floats of a column's slice in the warp form with E rows a round
    (``csrc/bs_sweep.cu:warp_slice``)."""
    return _r4(_r4(draw_outputs(F)) + E * _r4(rel_layout(F)["ld"]) + 4 * F
               + 2 * E)


def warp_rows(F: int, G: int = 32) -> int:
    """E, the real entries' rows the warp form with G lanes a column stages
    a round: one at G = 8, else as many as _WARP_ROW_FLOATS floats hold,
    one to four (``csrc/bs_sweep.cu:warp_rows``)."""
    n = _WARP_ROW_FLOATS // _r4(rel_layout(F)["ld"])
    return 1 if G < 32 else max(1, min(4, n))


def warp_lanes(F: int, L: int) -> int:
    """G, the lanes a column of the warp form: 8 (four columns a warp, each
    lane drawing up to three factors) where the bucket has at most 8 slots
    and F <= 24, so that a warp's 20-step draw serves four columns; else a
    warp."""
    return 8 if L <= 8 and F <= 24 else 32


def tiles_smem(F: int, T: int, whole: bool) -> int:
    """Bytes of shared memory of the tiled form's block, tiles of T rows,
    whole or without wcc (``csrc/bs_sweep.cu:tiles_smem``)."""
    lay = rel_layout(F)
    lds = lay["ld"] if whole else lay["wcc"] + 1
    return 4 * (2 * T * _r4(lds) + _r4(draw_outputs(F)) + 6 * T + 4 * F + 1)


def tile_rows(F: int, whole: bool) -> int:
    """T, the most rows (at most 32) a tile of the tiled form holds while
    _BLOCKS_PER_SM blocks share an SM's shared memory (F <= 32, where the
    kernel's draw holds one factor a lane and 56 registers a thread let
    four blocks in), else while one block fits (F > 32, where a row is
    2.6 KB or more); 0 if not even one row fits."""
    caps = (MAX_BLOCK_SMEM // _BLOCKS_PER_SM,) if F <= 32 else ()
    for cap in caps + (MAX_BLOCK_SMEM,):
        T = max((T for T in range(1, _MAX_TILE + 1)
                 if tiles_smem(F, T, whole) <= cap), default=0)
        if T:
            return T
    return 0


def draw_form(F: int, L: int) -> str:
    """X10b's form for a bucket of L slots a column at F factors (F = 0:
    the w sweep): narrow buckets (L <= 32, the one-hot ones) a group of
    lanes a column (F <= 1) or the warp form (F >= 2: a warp, or 8 lanes,
    a column, see warp_lanes); wide ones a block per
    (column, split), at F >= 2 over staged tiles of whole rows where two
    tiles of them fit, else of rows without wcc."""
    if F <= 1:
        return "group" if L <= _NARROW_L else "block"
    if L <= _NARROW_L and 4 * warp_slice(F, warp_rows(F)) <= MAX_BLOCK_SMEM:
        return "warp"
    return "tiles" if tile_rows(F, True) else "tiles_l2wcc"


def draw_splits(C: int, lo: int, hi: int, sms: int) -> int:
    """S, the ways the block forms split each column of a bucket of C
    columns whose real entries run from lo to hi a column: about
    _BLOCKS_PER_SM blocks an SM when the bucket has few columns, shares of
    at least _SPLIT_MIN entries in the longest column, and no more than the
    shortest column has entries, so that every block gets one (a column
    with none, lo = 0, takes S = 1)."""
    return max(1, min(hi // _SPLIT_MIN,
                      -(-_BLOCKS_PER_SM * sms // max(C, 1)), lo))


def split_bounds(n: int, S: int) -> list:
    """The S shares [b, e) of a column's n real entries, as each block of
    the column computes its own (``csrc/bs_sweep.cu:split_range``)."""
    return [(s * n // S, (s + 1) * n // S) for s in range(S)]


def draw_plan(F: int, C: int, L: int, lo: int, hi: int,
              sms: int) -> DrawPlan:
    """The form, its k and the splits X10b takes for a [C, L] bucket at F
    factors whose columns hold lo to hi real entries, on a card of sms
    SMs."""
    form = draw_form(F, L)
    if form == "group":
        return DrawPlan(form, narrow_lanes(L), 1)
    if form == "warp":
        return DrawPlan(form, warp_lanes(F, L), 1)
    k = tile_rows(F, form == "tiles") if form != "block" else 0
    return DrawPlan(form, k, draw_splits(C, lo, hi, sms))


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
    (rows, x, cols pointers, C, L, G, first), the buckets laid end to end,
    and their total.  By ``join_form``: narrow, G the lanes a relation row
    (``narrow_lanes``), first the bucket's first block, ceil(C G / 256)
    blocks a bucket, the total the blocks; warp and block, G = 32 (unread),
    first the bucket's first relation row, the total the rows (the kernel
    sizes its persistent grid itself)."""
    form = join_form(F)
    out, first = [], 0
    for b in buckets:
        C, L = b.rows.shape
        if form == "narrow":
            G = narrow_lanes(L)
            size = -(-C * G // _NARROW_THREADS)
        else:
            G, size = 32, C
        out.append((b.rows.data_ptr(), b.x.data_ptr(), b.cols.data_ptr(), C,
                    L, G, first))
        first += size
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
    if not join_fits(F):
        raise ValueError(f"bs_join_agg: F = {F} is wider than a block of "
                         "X10a takes")
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
                 alpha, z, nans, real: Optional[RealCounts]):
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
    if real is None:
        raise ValueError(f"{kname}: the bucket's real counts (RelBlock.real, "
                         "real_counts) are needed on the card")
    req(real.n, _I32, (C,), dev, f"{kname}.real")
    if C == 0:
        return
    if not rel_draw_fits(F):
        raise ValueError(f"{kname}: F = {F} is wider than the {MAX_REL_F} "
                         "factors a block takes (X10a's shared memory); use "
                         "a narrower factor_block")
    plan = draw_plan(F, C, L, real.lo, real.hi, _sms(dev))
    part = done = None
    if plan.S > 1:
        part = torch.empty(C * plan.S * draw_outputs(F), dtype=_F32,
                           device=dev)
        done = torch.zeros(C, dtype=_I32, device=dev)
    lib = build.load_library("bs_sweep")
    args = [build.ptr(rows), build.ptr(x), C, L, FORMS.index(plan.form),
            plan.k, plan.S, build.ptr(real.n), build.ptr(cols),
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
                alpha, z: Optional[torch.Tensor], nans,
                real: Optional[RealCounts] = None) -> None:
    """X10b on CUDA tensors, in draw_plan's form (``real``: the bucket's
    RealCounts, needed there), the twin on CPU tensors."""
    if build.on_cpu(rows):
        return bs_rel_draw_plain(rows, x, cols, group, rtab, F, ptab, v_t, mu,
                                 lam, alpha, z, nans)
    if F < 1:
        raise ValueError("bs_rel_draw: F >= 1 (the w sweep is bs_rel_w_draw)")
    _launch_draw("bs_rel_draw", rows, x, cols, group, rtab, F, ptab, v_t, mu,
                 lam, alpha, z, nans, real)


def bs_rel_w_draw(rows, x, cols, group, rtab, ptab, w, mu, lam, alpha,
                  z: Optional[torch.Tensor], bad,
                  real: Optional[RealCounts] = None) -> None:
    if build.on_cpu(rows):
        return bs_rel_w_draw_plain(rows, x, cols, group, rtab, ptab, w, mu,
                                   lam, alpha, z, bad)
    _launch_draw("bs_rel_w_draw", rows, x, cols, group, rtab, 0, ptab, w, mu,
                 lam, alpha, z, bad, real)


# ---- X10c -------------------------------------------------------------------

# X10c's forms (csrc/bs_sweep.cu): a thread a relation row at F <= 1; G
# lanes a row, G the next power of two >= F, at 2 <= F <= 32; a block of
# round32(F) threads a row past F = 32
_PATCH_THREADS = 256  # csrc/bs_sweep.cu kPatchThreads
_PATCH_POS = 2  # csrc/bs_sweep.cu kPatchPos: positions staged at once


class PatchPlan(NamedTuple):
    """How X10c runs at F factors: its form; lanes, the threads a relation
    row; rows, the rows a block takes at once (the lanes form's blocks walk
    the rows, two slices of shared memory a row's group); smem, a block's
    bytes of shared memory."""

    form: str
    lanes: int
    rows: int
    smem: int


def patch_slice(F: int) -> int:
    """Floats of a row's slice of shared memory in the lanes and block
    forms: the row, then _PATCH_POS ptab rows, v_old and dv each at a
    16-byte boundary (``csrc/bs_sweep.cu:patch_slice``)."""
    return _r4(rel_layout(F)["ld"]) + _PATCH_POS * 2 * _r4(F)


def patch_plan(F: int) -> PatchPlan:
    """X10c's form at F factors (0: the w sweep), a function of F alone
    (``csrc/bs_sweep.cu:svbfm_bs_rel_patch``)."""
    if F <= 1:
        return PatchPlan("thread", 1, _PATCH_THREADS, 0)
    if F <= 32:
        G = narrow_lanes(F)
        rows = _PATCH_THREADS // G
        return PatchPlan("lanes", G, rows, 8 * rows * patch_slice(F))
    threads = -(-F // 32) * 32
    return PatchPlan("block", threads, 1,
                     4 * (patch_slice(F) + 2 * (threads // 32)))


def patch_fits(F: int) -> bool:
    """Whether X10c's block takes a row of F factors: at most
    _PATCH_THREADS factors and a row that fits the block's shared memory
    (every F up to MAX_REL_F does)."""
    p = patch_plan(F)
    return p.lanes <= _PATCH_THREADS and p.smem <= MAX_BLOCK_SMEM


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
    if not patch_fits(F):
        raise ValueError(f"{kname}: F = {F} is wider than the row a block "
                         f"of X10c takes (up to {_PATCH_THREADS} factors "
                         "whose row fits its shared memory)")
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
