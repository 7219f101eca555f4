"""Native relational block structure (BS) for Gibbs MCMC and ALS, on one
device or on a data mesh of ranks.

Counterpart of ``svbfm_tpu/learners/mcmc_bs.py``, regression and probit
classification (the re-predict leaves e = yhat there, and the learner's
eval, inherited from ``MCMCLearner``, runs X12b and X12a): libFM's
VLDB'13 path ("Scaling Factorization Machines to Relational Data",
``fm_learn_mcmc.h:134-220, 459-620, 722-899``).  The relations stay
factored on the device: memory and work per sweep scale with N + the
relation tables' entries + their rows, never with the materialised join.
The algebra and its order are the JAX package's:

  per relation row rho over the join (X10a):
    wnum = #train rows joined to rho (static), qB = sum v x (per factor),
    we = sum e, weq = sum e qO, wc = sum qO, wcc = sum qO qO^T,
    with qO = q - qB[join] (constant during a relation's sweep);
  per relation bucket (X10b): she, sh2 and the cross-factor matrix M from
    those aggregates, then the exact sequential draw of the block's factors;
  after each relation bin (X10c): we, weq, qB and dy patched at the
    relation-row level;
  after each relation (X10d): e += dy[j] + qO dqB[j], q += dqB[j].

The main design block (possibly empty) runs the plain learner's kernels:
the w sweep (X8c + the w patch) and the v block pass (X8d, X8a, X8b) on the
TOTAL q cache (main + sum of the relations' qB[join]).  The v sweep is
factor-blocked with F = K (``bs_factor_width``: narrowed only where X8a's
or X10b's shared memory cannot hold K factors) when F divides K, else the
reference's factor-sequential chain; ``factor_block`` = 1 forces the chain.
The JAX package's TPU workarounds are not carried over: its HBM-budget
choice of F (``_bs_auto_factor_block``), the one-iteration chunk clamp and
unrolled fused steps, and the L = 1 squeeze.

Every random number comes from the state's draw source in JAX's order and
shapes: the relation w sweep draws one [Dr] table per relation when
sampling; the blocked v sweep one [F, Dr] table per relation per block
whether or not it samples (mcmc_bs.py:344-346), the main block's prior one
[D, F] table whenever the main block has attributes (:505-514); the
factor-sequential path one [Dr] table per relation per factor when
sampling (:761-765).

Data-parallel (``mesh=``, a ``parallel/mesh.py:make_mesh`` data mesh of
the ranks; the JAX learner on ``make_mesh(n)``): rank d holds the block d
of the main rows, of ``join_tr`` and ``join_te`` (padded as the rows are)
and its slice [d] of each bucket of the main plan and of each relation's
join plan, both built for as many shards (a pad slot: the shard's last
row, x = 0); the relation row layouts, their plans, ``wnum``, the patch
positions and every table are whole on every rank, and every rank draws
the same numbers, so the tables stay equal bit for bit.  The join
aggregates JAX psums (mcmc_bs.py:326, :645, :755) are X10a's sums of the
rank's slice, their channel columns of the relation-row table (``we`` to
``wcc``; not ``qB`` or ``wn``, which are whole on every rank) copied out,
all-reduced over the data group and written back; X10b and X10c then run
on every rank alike.  The main block runs ``learners/mcmc.py``'s split
forms (T3's w stats + T5, T7), alpha's and w0's sums are all-reduced, and
X10d, X8d, X8b and the re-predict run on the rank's rows.  A mesh of one
rank runs the same forms, with no collective.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
from svbfm_tpu_torch.data.libfm_text import COOData
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.relation import RelationData
from svbfm_tpu_torch.kernels.bs_forward import (bs_rel_moments, bs_resync,
                                                bs_scores, moments_table)
from svbfm_tpu_torch.kernels.bs_sweep import (RealCounts, bs_join_agg,
                                              bs_rel_draw, bs_rel_patch,
                                              bs_rel_w_draw, bs_rel_w_patch,
                                              real_counts, rel_draw_fits,
                                              rel_layout)
from svbfm_tpu_torch.kernels.mcmc_sweep import col_draw_fits
from svbfm_tpu_torch.kernels.vb_sweep import build_q
from svbfm_tpu_torch.learners.base import (FMConfig, PlanData, RowData,
                                           count_bad, keep_finite,
                                           padded_rows, row_block,
                                           zero_counters)
from svbfm_tpu_torch.learners.mcmc import (NAN_FAMILIES, MCMCLearner,
                                           MCMCState, _maybe_sample, _same,
                                           _v_block_pass, check_slice,
                                           draw_alpha, draw_v_hyperpriors,
                                           draw_w0, draw_w_hyperpriors,
                                           repredicted, v_factor_main_bins,
                                           w_sweep_main)

_F32, _I32 = torch.float32, torch.int32


# ---------------------------------------------------------------------------
# Host structures and their device tensors
# ---------------------------------------------------------------------------

@dataclass
class JoinBlock:
    """One degree bucket of the join plan: data rows grouped by relation
    row."""

    rows: torch.Tensor  # int32 [C, L] data-row ids
    x: torch.Tensor  # f32 [C, L] 1.0 real / 0.0 pad
    cols: torch.Tensor  # int32 [C] relation row ids


@dataclass
class RelBlock:
    """One degree bucket of one conflict-free bin of the relation design."""

    rows: torch.Tensor  # int32 [C, L] relation row ids
    x: torch.Tensor  # f32 [C, L]
    cols: torch.Tensor  # int32 [C] relation-local attribute ids
    group: torch.Tensor  # int32 [C] JOINED-global group ids
    real: RealCounts  # each column's real entries, counted on the host


@dataclass
class RelDevice:
    """All device tensors of one relation."""

    rrow_ids: torch.Tensor  # int32 [R, Pr] relation-local attribute ids
    rrow_vals: torch.Tensor  # f32 [R, Pr]
    join_tr: torch.Tensor  # int32 [N] train join
    join_te: torch.Tensor  # int32 [N_te] test join
    wnum: torch.Tensor  # f32 [R] train rows per relation row
    jplan: tuple  # tuple[JoinBlock, ...]
    rplan: tuple  # tuple[tuple[RelBlock, ...], ...] bins -> buckets
    unobserved: torch.Tensor  # bool [Dr] attributes with no entry
    attr_group: torch.Tensor  # int32 [Dr] JOINED-global group of each attr
    # patch_pos[b]: int32 [n_b], the row-layout positions that hold bin b's
    # columns: the per-bin patches gather a dv table through rrow_ids[:, p],
    # and a position holding no in-bin column gathers only zeros, so
    # skipping it is exact (for field-structured relations it turns the
    # bins x positions grid of patch passes into one pass a bin)
    patch_pos: tuple


@dataclass(frozen=True)
class RelStatic:
    """Host facts about one relation."""

    attr_offset: int
    num_attrs: int  # Dr
    num_rows: int  # R


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def build_rel_device(rel: RelationData, join_tr: np.ndarray,
                     join_te: np.ndarray, joined_groups: np.ndarray, device,
                     bins: str = "auto", mesh=None,
                     n_pad: tuple = (0, 0)) -> tuple[RelDevice, RelStatic]:
    """The relation's row layout, its join plan (a Jacobi ``SweepPlan`` over
    the join: columns = relation rows, entries = train rows), its design
    plan (conflict-free bins of its attributes), wnum and the patch
    positions (mcmc_bs.py:130-198); tensors on ``device``, unpadded.  On a
    data ``mesh``: the join plan built for its shards over ``n_pad`` =
    (train, test) padded rows, the rank's slice of each bucket, and the
    rank's blocks of the joins zero-padded to those counts
    (mcmc_bs.py:143-150, :172-179)."""
    R, Dr = rel.num_rows, rel.num_features
    off = rel.attr_offset
    if off < 0:
        raise ValueError("call build_joined_meta before building relations")
    rcoo = COOData(row=rel.row, col=rel.col, val=rel.val,
                   target=np.zeros(R, np.float32), num_rows=R,
                   num_features=Dr)
    rel_ds = SparseDataset.from_coo(rcoo)
    n = len(join_tr)
    jcoo = COOData(row=np.arange(n, dtype=np.int32),
                   col=join_tr.astype(np.int32),
                   val=np.ones(n, np.float32),
                   target=np.zeros(n, np.float32), num_rows=n,
                   num_features=R)
    shards, d = (1, 0) if mesh is None else (mesh.n_data, mesh.d_index)

    def join_rows(join, n_rows):  # the rank's block, padded as its rows
        t = _put(np.asarray(join).astype(np.int32), device)
        return t if mesh is None else row_block(mesh, t, n_rows // shards)

    jplan = SweepPlan.build(jcoo, R, bins="jacobi", n_shards=shards,
                            n_rows_total=n if mesh is None else n_pad[0])
    rplan = SweepPlan.build(rcoo, Dr, meta_groups=joined_groups[off: off + Dr],
                            bins=bins)
    wnum = np.bincount(join_tr, minlength=R).astype(np.float32)
    patch_pos = []
    for b in range(rplan.num_bins):
        ps = []
        for p in range(rel_ds.ids.shape[1]):
            live = rel_ds.vals[:, p] != 0.0
            if live.any() and (rplan.color[rel_ds.ids[live, p]] == b).any():
                ps.append(p)
        patch_pos.append(tuple(ps))
    dev = RelDevice(
        rrow_ids=_put(rel_ds.ids.astype(np.int32), device),
        rrow_vals=_put(rel_ds.vals.astype(np.float32), device),
        join_tr=join_rows(join_tr, n_pad[0]),
        join_te=join_rows(join_te, n_pad[1]),
        wnum=_put(wnum, device),
        jplan=tuple(JoinBlock(rows=_put(blk.rows[d], device),
                              x=_put(blk.x[d], device),
                              cols=_put(blk.cols, device))
                    for blk in jplan.blocks[0]),
        rplan=tuple(tuple(RelBlock(rows=_put(blk.rows[0], device),
                                   x=_put(blk.x[0], device),
                                   cols=_put(blk.cols, device),
                                   group=_put(blk.group, device),
                                   real=real_counts(blk.x[0], device))
                          for blk in bin_blocks)
                    for bin_blocks in rplan.blocks),
        unobserved=_put(rplan.unobserved, device),
        attr_group=_put(joined_groups[off: off + Dr].astype(np.int32), device),
        patch_pos=tuple(_put(np.asarray(ps, np.int32), device)
                        for ps in patch_pos))
    return dev, RelStatic(attr_offset=off, num_attrs=Dr, num_rows=R)


def bs_factor_width(cfg: FMConfig) -> int:
    """The v sweep's block width: an explicit ``factor_block`` as given;
    0 means K, or the widest divisor of K whose block fits X8a's and
    X10a/X10b's shared memory (the port's counterpart of
    ``learners/mcmc.py:factor_width``)."""
    K = cfg.num_factor
    if cfg.factor_block > 0:
        return min(cfg.factor_block, K)
    return max((F for F in range(1, K + 1) if K % F == 0
                and col_draw_fits(F, True) and rel_draw_fits(F)), default=K)


# ---------------------------------------------------------------------------
# Scores (X10d)
# ---------------------------------------------------------------------------

def param_table(w, v, k1: bool) -> torch.Tensor:
    """The parameter table [D_all, 1+K] = (w | v^T); w is 0 without k1."""
    wc = w[:, None] if k1 else torch.zeros_like(w)[:, None]
    return torch.cat([wc, v.T], 1).contiguous()


def bs_score_rows(w0, w, v, ids, vals, rels, rstats, joins,
                  k0: bool = True, k1: bool = True,
                  moms_out=None) -> torch.Tensor:
    """FM scores of data rows from their main row layout and each
    relation's moments at its joined row (mcmc_bs.py:215-268), any number
    of relations.  ``moms_out``: one [R, K+2] table a relation to build
    the moments in (the learner's, at fixed addresses), or None."""
    stab = param_table(w, v, k1)
    outs = moms_out if moms_out is not None else [None] * len(rels)
    moms = [bs_rel_moments(rd.rrow_ids, rd.rrow_vals, stab, rs.attr_offset,
                           k1, out=o) for rd, rs, o in zip(rels, rstats, outs)]
    w0 = w0 if k0 else torch.zeros_like(w0)
    return bs_scores(stab, w0, ids, vals, list(joins), moms)


# ---------------------------------------------------------------------------
# The relation sweeps
# ---------------------------------------------------------------------------

def _unobserved_prior(vr, mu_d, lam_d, z, rd: RelDevice, counters) -> None:
    """Unobserved relation attributes take the prior (mcmc_bs.py:454-459,
    :677-687, :811-818), in place on vr; z is the sweep's noise table (its
    numbers at unobserved attributes are unused so far) or None."""
    s2_d = 1.0 / lam_d
    un = mu_d + torch.sqrt(s2_d) * z if z is not None else mu_d
    un = torch.where(torch.isfinite(s2_d), un, torch.zeros_like(un))
    unobs = rd.unobserved if vr.dim() == 1 else rd.unobserved[:, None]
    count_bad(counters, "v" if vr.dim() == 2 else "w",
              torch.where(unobs, un, 0.0))
    vr.copy_(torch.where(unobs, keep_finite(un, vr), vr))


def join_sums(rd: RelDevice, e, q, F: int, rtab, mesh=None) -> None:
    """X10a's channel sums into ``rtab`` (its layout ``rel_layout(F)``),
    over the join plan; on a data ``mesh`` over the rank's slice of it,
    the channel columns ``we`` to ``wcc`` then all-reduced over the data
    group through a contiguous copy (mcmc_bs.py:326, :645, :755)."""
    bs_join_agg(rd.jplan, e, q, F, rtab)
    if mesh is not None:
        lay = rel_layout(F)
        ch = slice(lay["we"], lay["wn"])
        rtab[:, ch] = mesh.all_reduce_data(rtab[:, ch].contiguous())


def rel_w_sweep(e, w, w_mu, w_lambda, alpha, rd: RelDevice, rs: RelStatic,
                cfg: FMConfig, draws, counters, mesh=None) -> None:
    """One relation's w sweep (draw_w_rel, mcmc_bs.py:641-690), in place on
    e and w: X10a's e channel, X10b/X10c in w mode per bin, the prior of the
    unobserved attributes, the resync e += dy[j] (X10d)."""
    R, Dr, off = rs.num_rows, rs.num_attrs, rs.attr_offset
    dev = e.device
    rtab = torch.zeros(R, 2, dtype=_F32, device=dev)
    rtab[:, 1] = rd.wnum
    join_sums(rd, e, None, 0, rtab, mesh)
    wr = w[off:off + Dr]  # a view: the draws land in w
    dy = torch.zeros(R, 1, dtype=_F32, device=dev)
    zr = draws.normal((Dr,)) if cfg.do_sample else None
    ptab = torch.empty(Dr, 2, dtype=_F32, device=dev)
    bad = torch.zeros(2, dtype=_I32, device=dev)
    for b_i, bin_blocks in enumerate(rd.rplan):
        if not bin_blocks:
            continue
        ptab[:, 0] = wr
        ptab[:, 1].zero_()
        for blk in bin_blocks:
            bs_rel_w_draw(blk.rows, blk.x, blk.cols, blk.group, rtab, ptab,
                          wr, w_mu, w_lambda, alpha, zr, bad, blk.real)
        bs_rel_w_patch(rd.rrow_ids, rd.rrow_vals, rd.patch_pos[b_i], ptab,
                       rtab, dy)
    counters["nan_w"] = counters["nan_w"] + bad[0]
    counters["inf_w"] = counters["inf_w"] + bad[1]
    _unobserved_prior(wr, w_mu.index_select(0, rd.attr_group),
                      w_lambda.index_select(0, rd.attr_group), zr, rd,
                      counters)
    bs_resync(rd.join_tr, 1, dy, None, None, None, e)


def rel_v_sweep(e, q, vr, qB0, rd: RelDevice, rs: RelStatic, mu_gf, lam_gf,
                alpha, z, F: int, counters, mesh=None) -> None:
    """One relation's v sweep of F factors, in place on e, q [N, F] and vr
    [Dr, F] (the relation's rows of the block's factor table): F >= 2 the
    blocked bin-major sweep (_bs_rel_block_sweep, mcmc_bs.py:304-469), F = 1
    the factor-sequential one (:747-824).  qB0 [R, F] is the relation's qB
    at entry; z the [F, Dr] noise table or None."""
    R, Dr = rs.num_rows, rs.num_attrs
    dev = e.device
    lay = rel_layout(F)
    rtab = torch.zeros(R, lay["ld"], dtype=_F32, device=dev)
    rtab[:, :F] = qB0
    rtab[:, lay["wn"]] = rd.wnum
    join_sums(rd, e, q, F, rtab, mesh)
    dy = torch.zeros(R, F, dtype=_F32, device=dev)
    ptab = torch.empty(Dr, 2 * F, dtype=_F32, device=dev)
    nans = torch.zeros(2, dtype=_I32, device=dev)
    for b_i, bin_blocks in enumerate(rd.rplan):
        if not bin_blocks:
            continue
        ptab[:, :F] = vr
        ptab[:, F:].zero_()
        for blk in bin_blocks:
            bs_rel_draw(blk.rows, blk.x, blk.cols, blk.group, rtab, F, ptab,
                        vr, mu_gf, lam_gf, alpha, z, nans, blk.real)
        bs_rel_patch(rd.rrow_ids, rd.rrow_vals, rd.patch_pos[b_i], ptab, F,
                     rtab, dy)
    counters["nan_v"] = counters["nan_v"] + nans[0]
    counters["inf_v"] = counters["inf_v"] + nans[1]
    ag = rd.attr_group
    _unobserved_prior(vr, mu_gf.index_select(0, ag),
                      lam_gf.index_select(0, ag),
                      None if z is None else z.T, rd, counters)
    bs_resync(rd.join_tr, F, dy, rtab[:, :F], qB0, q, e)


def _bs_v_blocked(e, v, v_mu, v_lambda, alpha, plan: PlanData, row: RowData,
                  rels, rstats, cfg: FMConfig, qB_pre, F: int, draws,
                  counters, mesh=None) -> None:
    """The factor-blocked v sweep (mcmc_bs.py:472-521), in place on e and
    v: per block, the q cache from the relations' qB (X10d), the main bins
    (X8d, X8a, X8b on the total q), the main block's unobserved prior, then
    each relation in turn."""
    K, D = v.shape
    N = e.shape[0]
    has_main = any(len(bb) for bb in plan.blocks)
    d_main = min((rs.attr_offset for rs in rstats), default=D)
    ag, unobs = plan.attr_group, plan.unobserved[:, None]
    for f0 in range(0, K, F):
        fs = slice(f0, f0 + F)
        qB_blks = [qB[:, fs].contiguous() for qB in qB_pre]
        q = torch.zeros(N, F, dtype=_F32, device=e.device)
        for rd, qb in zip(rels, qB_blks):
            bs_resync(rd.join_tr, F, None, qb, None, q, None)
        v_t = v[fs].T.contiguous()  # [D, F]
        mu_gf = v_mu[:, fs].contiguous()
        lam_gf = v_lambda[:, fs].contiguous()
        if has_main:
            q = _v_block_pass(e, v_t, mu_gf, lam_gf, draws, plan, row, cfg,
                              alpha, True, counters, q_extra=q, mesh=mesh)
        if d_main > 0:
            # JAX splits a key here whether or not it samples
            new_un = _maybe_sample(cfg.do_sample, draws.normal((D, F)),
                                   mu_gf.index_select(0, ag),
                                   1.0 / lam_gf.index_select(0, ag), v_t,
                                   counters=counters, count_as="v",
                                   count_mask=unobs)
            v_t.copy_(torch.where(unobs, new_un, v_t))
        for rd, rs, qb in zip(rels, rstats, qB_blks):
            # JAX draws this table whether or not it samples
            z = draws.normal((F, rs.num_attrs))
            off = rs.attr_offset
            rel_v_sweep(e, q, v_t[off:off + rs.num_attrs], qb, rd, rs, mu_gf,
                        lam_gf, alpha, z if cfg.do_sample else None, F,
                        counters, mesh)
        v[fs] = v_t.T


def _bs_v_sequential(e, v, v_mu, v_lambda, alpha, plan: PlanData,
                     row: RowData, rels, rstats, cfg: FMConfig, qB_pre,
                     draws, counters, mesh=None) -> None:
    """The reference's factor-sequential chain (mcmc_bs.py:728-833), in
    place on e and v."""
    K = v.shape[0]
    for f in range(K):
        v_f = v[f]
        q = build_q(v_f.view(-1, 1), 1, row.ids, row.vals)
        qB_f = [qB[:, f:f + 1].contiguous() for qB in qB_pre]
        for rd, qb in zip(rels, qB_f):
            bs_resync(rd.join_tr, 1, None, qb, None, q, None)
        mu_f = v_mu[:, f:f + 1].contiguous()
        lam_f = v_lambda[:, f:f + 1].contiguous()
        v_factor_main_bins(e, q, v_f, mu_f, lam_f, alpha, plan, row, cfg,
                           draws, counters, mesh)
        for rd, rs, qb in zip(rels, rstats, qB_f):
            z = draws.normal((1, rs.num_attrs)) if cfg.do_sample else None
            off = rs.attr_offset
            rel_v_sweep(e, q, v_f[off:off + rs.num_attrs].view(-1, 1), qb,
                        rd, rs, mu_f, lam_f, alpha, z, 1, counters, mesh)


def bs_draw_all(state: MCMCState, row: RowData, plan: PlanData, rels, rstats,
                cfg: FMConfig, num_cases: float, F: int, score_moms=None,
                mesh=None):
    """One block-structure Gibbs (or ALS) sweep + the full re-predict of the
    train residual (mcmc_bs.py:576-844).  Returns (new_state, counters);
    ``state``'s tensors are not modified (its draw source advances).
    ``score_moms``: the re-predict's moment tables (``bs_score_rows``).
    ``mesh``: a data mesh of the ranks, ``row``/``plan``/``rels`` the
    rank's (``MCMCBSLearner(mesh=)``)."""
    check_slice(cfg)
    total = _same if mesh is None else mesh.all_reduce_data
    dev = state.e.device
    G, K = cfg.num_groups, cfg.num_factor
    N = torch.full((), num_cases, dtype=_F32, device=dev)
    draws = state.draws
    e = state.e.clone()
    counters = zero_counters(NAN_FAMILIES, dev)
    ag, napg = plan.attr_group, plan.num_attr_per_group

    alpha = draw_alpha(e, row.valid, state.alpha, cfg, N, draws, counters,
                       total)
    w0 = state.w0
    if cfg.k0:
        e, w0 = draw_w0(e, row.valid, w0, cfg, alpha, N, draws, counters,
                        total)
    w, v = state.w.clone(), state.v.clone()
    w_mu, w_lambda = state.w_mu, state.w_lambda
    v_mu, v_lambda = state.v_mu, state.v_lambda
    if cfg.k1:
        # the joined groups cover the relation attributes too
        w_mu, w_lambda = draw_w_hyperpriors(w, w_mu, w_lambda, ag, napg, cfg,
                                            G, draws, counters)
        # the main bins and the unobserved main attributes (the padded
        # unobserved mask never touches a relation attribute)
        w_sweep_main(e, w, w_mu, w_lambda, alpha, plan, row, cfg, draws,
                     counters, mesh)
        for rd, rs in zip(rels, rstats):
            rel_w_sweep(e, w, w_mu, w_lambda, alpha, rd, rs, cfg, draws,
                        counters, mesh)
    if K > 0:
        v_mu, v_lambda = draw_v_hyperpriors(v, v_mu, v_lambda, ag, napg, cfg,
                                            G, K, draws, counters)
        # every factor's qB from the pre-sweep v, in one pass a relation
        stab = param_table(w, v, cfg.k1)
        qB_pre = [bs_rel_moments(rd.rrow_ids, rd.rrow_vals, stab,
                                 rs.attr_offset, cfg.k1)[:, :K]
                  for rd, rs in zip(rels, rstats)]
        if F > 1 and K % F == 0:
            _bs_v_blocked(e, v, v_mu, v_lambda, alpha, plan, row, rels,
                          rstats, cfg, qB_pre, F, draws, counters, mesh)
        else:
            _bs_v_sequential(e, v, v_mu, v_lambda, alpha, plan, row, rels,
                             rstats, cfg, qB_pre, draws, counters, mesh)
    # full re-predict (mcmc_bs.py:837-840): e := yhat - y, or yhat under
    # classification
    e = repredicted(bs_score_rows(w0, w, v, row.ids, row.vals, rels, rstats,
                                  [rd.join_tr for rd in rels], cfg.k0,
                                  cfg.k1, score_moms), row, cfg)
    new_state = MCMCState(w0=w0, w=w, v=v, alpha=alpha, w_mu=w_mu,
                          w_lambda=w_lambda, v_mu=v_mu, v_lambda=v_lambda,
                          e=e, draws=draws)
    return new_state, counters


# ---------------------------------------------------------------------------
# The learners
# ---------------------------------------------------------------------------

class MCMCBSLearner(MCMCLearner):
    """Gibbs MCMC over relational block structure, never materialising the
    join.  ``train``/``test`` are the MAIN design blocks (they may have no
    column: every feature in the relations); ``relations`` with
    ``joins_train``/``joins_test`` carry the factored tables.  ``meta`` is
    the JOINED meta (``build_joined_meta``) and ``cfg.num_attributes`` the
    joined attribute count.  ``mesh``: a data mesh of the ranks (every
    rank constructs the learner with the whole data and keeps its blocks
    of rows; see the module docstring)."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, relations: list[RelationData],
                 joins_train: list[np.ndarray], joins_test: list[np.ndarray],
                 meta: DataMetaInfo, num_main_attributes: int, *, device=None,
                 bins: str = "auto", out_dir: str = ".",
                 write_files: bool = True,
                 w_lambda_init: Optional[np.ndarray] = None,
                 v_lambda_init: Optional[np.ndarray] = None, mesh=None):
        check_slice(cfg)
        # the main plan over the main columns only (on a data mesh built
        # for its shards over the padded rows, as learners/base.py:
        # mesh_plan builds one); unobserved padded to D_all with False so
        # the main sweeps never draw a relation attribute
        n_pad = (0, 0) if mesh is None else (padded_rows(train, mesh.n_data),
                                             padded_rows(test, mesh.n_data))
        plan = SweepPlan.build(
            train.to_coo(), num_main_attributes,
            meta_groups=meta.attr_group[:num_main_attributes], bins=bins,
            **({} if mesh is None else dict(n_shards=mesh.n_data,
                                            n_rows_total=n_pad[0])))
        pad = np.zeros(cfg.num_attributes, dtype=bool)
        pad[:num_main_attributes] = plan.unobserved
        plan.unobserved = pad
        super().__init__(cfg, train, test, meta, device=device, bins=bins,
                         out_dir=out_dir, write_files=write_files,
                         w_lambda_init=w_lambda_init,
                         v_lambda_init=v_lambda_init, plan=plan, mesh=mesh)
        self.num_main_attributes = num_main_attributes
        devs, stats = [], []
        min_off = num_main_attributes
        for rel, jt, je in zip(relations, joins_train, joins_test):
            if rel.attr_offset < min_off:
                raise ValueError(
                    "relation attr_offset overlaps the main block or an "
                    "earlier relation: call build_joined_meta(meta_main, "
                    "relations) before constructing the learner")
            min_off = rel.attr_offset + rel.num_features
            d, s = build_rel_device(rel, np.asarray(jt), np.asarray(je),
                                    meta.attr_group, self.device, bins=bins,
                                    mesh=mesh, n_pad=n_pad)
            devs.append(d)
            stats.append(s)
        self.rels = tuple(devs)
        self.rstats = tuple(stats)
        self.factor_width = bs_factor_width(cfg)
        # the scores' moment tables stay at one address, so bs_scores
        # builds its device arrays of pointers to them once
        self.score_moms = tuple(
            moments_table(s.num_rows, cfg.num_factor, self.device)
            for s in stats)

    def bs_scores(self, w0, w, v, test: bool = False) -> torch.Tensor:
        """Scores of the train (or test) rows (JAX: ``_bs_scores_tr``)."""
        row = self.test_row if test else self.train_row
        joins = [rd.join_te if test else rd.join_tr for rd in self.rels]
        return bs_score_rows(w0, w, v, row.ids, row.vals, self.rels,
                             self.rstats, joins, self.cfg.k0, self.cfg.k1,
                             self.score_moms)

    def state_from_params(self, w0, w, v, draws) -> MCMCState:
        dev = self.device
        w0, w, v = (a.to(dev, _F32) for a in (w0, w, v))
        G, K = self.cfg.num_groups, self.cfg.num_factor
        return MCMCState(
            w0=w0, w=w, v=v, alpha=torch.ones((), dtype=_F32, device=dev),
            w_mu=torch.zeros(G, dtype=_F32, device=dev),
            w_lambda=torch.as_tensor(self.w_lambda_init, dtype=_F32).to(dev),
            v_mu=torch.zeros(G, K, dtype=_F32, device=dev),
            v_lambda=torch.as_tensor(self.v_lambda_init, dtype=_F32).to(dev),
            e=self.bs_scores(w0, w, v) - self.train_row.target, draws=draws)

    def _test_scores(self, state: MCMCState) -> torch.Tensor:
        return self.bs_scores(state.w0, state.w, state.v, test=True)

    def step(self, state: MCMCState):
        return bs_draw_all(state, self.train_row, self.plan_data, self.rels,
                           self.rstats, self.cfg, float(self.train_n),
                           self.factor_width, self.score_moms, self.mesh)


class ALSBSLearner(MCMCBSLearner):
    """ALS over block structure (do_sample=False, do_multilevel=False)."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        cfg = dataclasses.replace(cfg, do_sample=False, do_multilevel=False)
        super().__init__(cfg, *args, **kwargs)
