"""Gibbs MCMC and ALS, on one device or on a data mesh of ranks.

Counterpart of ``svbfm_tpu/learners/mcmc.py``'s resident path, regression
and probit classification: ``MCMCLearner`` (libFM's Bayesian FM,
Freudenthaler et al.) and ``ALSLearner``, which is MCMC with
``do_sample=False, do_multilevel=False`` as the reference CLI rewrites
``-method als`` (``libfm.cpp:131-135``).  The
math and its order are the JAX package's; the execution is eager PyTorch
around hand-written CUDA kernels (``kernels/``), each with a plain twin that
runs on the CPU:

* K1 ``fm_scores``: the init residual, the full re-predict of every sweep
  and the test eval;
* X8c ``mcmc_w_bin_draw`` (K5's MCMC mode, one launch a bin) +
  ``w_patch_rows`` (K4 at F = 0): the w sweep;
* X8d ``build_q`` (K2's q channel): the q cache at block entry;
* X8a ``mcmc_col_draw``: per-bucket column statistics and the exact
  sequential draw of a block's factors;
* X8b ``mcmc_patch_rows``: the per-bin patch of q and e;
* X12b ``probit_eval`` and X12a ``probit_latent`` under classification:
  the test eval into the posterior-mean accumulators, then the latent
  target update of the train rows (mcmc.py:1046-1090).

The hyperparameter segment sums are ``base.group_sum``, as in
``learners/vb.py``.

Semantics kept from the JAX package (and the reference): e = yhat - y
(under classification the re-predict leaves e = yhat and the latent
update then subtracts the drawn target, or under ALS its truncated mean:
e = yhat - z, mcmc.py:843-847); the
conditional draws of fm_learn_mcmc.h:628-1089 with hyperprior constants
alpha_0 = gamma_0 = beta_0 = 1, mu_0 = 0; a full re-predict of the train
residual every sweep; the posterior-mean accumulators pred_sum_all and
all_but5; the guards: a non-finite sigma^2 gives 0 (uncounted), a
non-finite draw is counted and reverted.  The v sweep is factor-blocked
with exact sequential conditionals (bin, factor, column order) when the
block width F divides K, else the reference's factor-sequential chain; F is
``factor_block``, with 0 meaning all K factors (JAX's ``_auto_factor_block``
picks that same width unless a block's temporaries would overflow a TPU's
memory, which the port does not model; the port narrows it only where X8a's
shared memory cannot hold K factors, see ``factor_width``).  Two JAX quirks are kept: the
unobserved columns of the factor-sequential path reuse the factor's noise
table, and each group's v_lambda Gamma draw is one number shared by all K
factors ([G, 1], mcmc.py:603-605).

Every random number comes from the state's draw source
(``learners/draws.py``) in JAX's order and shapes.  Everything a sweep
computes stays on the device: the per-iteration metrics are fetched once
per ``run`` chunk.

Data-parallel (``mesh=``, a ``parallel/mesh.py:make_mesh`` data mesh of
the ranks; the JAX learner on ``make_mesh(n)``): rank d holds the block d
of the rows with e and the q cache, and every table; the sums the JAX
package psums over its data axis (alpha's and w0's residual sums, a bin's
w sums, a bucket's column sums, the test eval's) are all-reduced over the
data group, and every rank draws the same numbers from a draw source
seeded alike, so the tables stay equal bit for bit on every rank.  The
column statistics run as the split forms of the feature-sharded sweep at
``lo = 0``, ``D_loc = D``: T3's w stats + T5 for the w sweep (X8c split),
T7's stats + draw launches for a bucket's factors (X8a split); X8d's q
build, X8b's patch, K4 at F = 0 and K1 run on the rank's rows.  A mesh of
one rank runs the same forms, with no collective.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels.mcmc_sweep import (col_draw_fits, mcmc_col_draw,
                                                mcmc_patch_rows, tp_col_draw,
                                                tp_col_draw_stats)
from svbfm_tpu_torch.kernels.probit import (CDF_EPS, PROBIT_ALS, PROBIT_GIBBS,
                                            probit_eval, probit_latent)
from svbfm_tpu_torch.kernels.vb_sweep import build_q, w_patch_rows
from svbfm_tpu_torch.kernels.w_sweep import (mcmc_w_bin_draw, tp_w_draw,
                                             tp_w_stats)
from svbfm_tpu_torch.learners.base import (TASK_REGRESSION, FMConfig, PlanData,
                                           RowData, TrajectoryFile,
                                           build_plan_data, build_row_data,
                                           check_task_r_or_c, count_bad,
                                           gather_rows, group_sum, held_back,
                                           keep_finite, learner_device,
                                           mesh_plan, print_nonzero_nans,
                                           ref_cdf_gaussian, row_block,
                                           zero_counters)
from svbfm_tpu_torch.learners.draws import Draws, device_draws
from svbfm_tpu_torch.models.fm import init_fm_params
from svbfm_tpu_torch.ops.forward import fm_scores
from svbfm_tpu_torch.utils.checkpoint import resume
from svbfm_tpu_torch.utils.rlog_schema import stream_row

_F32 = torch.float32

#: counter families (fm_learn_mcmc_simultaneous.h:100-128)
NAN_FAMILIES = ("alpha", "w0", "w", "w_mu", "w_lambda",
                "v", "v_mu", "v_lambda")

# Hyperprior constants (fm_learn_mcmc.h:1100-1103)
ALPHA_0 = GAMMA_0 = BETA_0 = 1.0
MU_0 = 0.0
W0_MEAN_0 = 0.0


@dataclass
class MCMCState:
    w0: torch.Tensor  # scalar
    w: torch.Tensor  # [D]
    v: torch.Tensor  # [K, D]
    alpha: torch.Tensor  # scalar
    w_mu: torch.Tensor  # [G]
    w_lambda: torch.Tensor  # [G]
    v_mu: torch.Tensor  # [G, K]
    v_lambda: torch.Tensor  # [G, K]
    e: torch.Tensor  # [N]; e = yhat - y (classification: yhat - z)
    draws: Draws  # the random numbers (JAX: the key)


TENSOR_FIELDS = ("w0", "w", "v", "alpha", "w_mu", "w_lambda", "v_mu",
                 "v_lambda", "e")


def check_slice(cfg: FMConfig) -> None:
    if cfg.factor_block < 0 or cfg.num_factor < 0:
        raise ValueError("factor_block and num_factor must be >= 0")
    check_task_r_or_c(cfg)


def exact_draws(cfg: FMConfig) -> bool:
    """Exact sequential conditionals within a block, unless factor-Jacobi
    ALS (mcmc.py:449-459)."""
    return not (cfg.mcmc_factor_jacobi and not cfg.do_sample)


def factor_width(cfg: FMConfig) -> int:
    """The v sweep's block width (mcmc.py:808-809).  An explicit
    ``factor_block`` is taken as given; 0 means K, or, where a block of K
    factors would not fit X8a's shared memory (past K = 303 in the exact
    mode), the widest divisor of K that fits, on every device alike."""
    K = cfg.num_factor
    if cfg.factor_block > 0:
        return min(cfg.factor_block, K)
    exact = exact_draws(cfg)
    return max((F for F in range(1, K + 1)
                if K % F == 0 and col_draw_fits(F, exact)), default=K)


def _maybe_sample(do_sample: bool, z, mean, sigma_sqr, old,
                  zero_on_bad_sigma=True, counters=None, count_as=None,
                  count_mask=None):
    """Reference guard order (mcmc.py:120-134): a bad sigma^2 gives 0
    (uncounted); a bad draw is counted and reverted.  ``z`` holds the
    standard normals (read only when sampling); ``count_mask`` restricts
    the count to a subset (the unobserved columns)."""
    val = mean
    if do_sample:
        val = mean + torch.sqrt(sigma_sqr) * z
    if zero_on_bad_sigma:
        val = torch.where(torch.isfinite(sigma_sqr), val,
                          torch.zeros_like(val))
    if count_as is not None:
        count_bad(counters, count_as,
                  val if count_mask is None else torch.where(count_mask, val,
                                                             0.0))
    return keep_finite(val, old)


# ---------------------------------------------------------------------------
# Scalar and hyperparameter draws
# ---------------------------------------------------------------------------

def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def draw_alpha(e, valid, alpha_old, cfg: FMConfig, N, draws: Draws,
               counters, total=_same):
    """fm_learn_mcmc.h:901-929.  ``total`` sums a row sum over the data
    shards (the feature-sharded learner's all-reduce; JAX's psum)."""
    if not cfg.do_multilevel:
        return torch.full((), ALPHA_0, dtype=_F32, device=e.device)
    sse = total(torch.sum(e * e * valid))
    draw = draws.gamma((ALPHA_0 + N) / 2.0) / ((GAMMA_0 + sse) / 2.0)
    count_bad(counters, "alpha", draw)
    return keep_finite(draw, alpha_old)


def draw_w0(e, valid, w0, cfg: FMConfig, alpha, N, draws: Draws, counters,
            total=_same):
    """fm_learn_mcmc.h:628-668.  Returns (e, w0); ``total`` as
    draw_alpha's."""
    acc = total(torch.sum((e - w0) * valid))
    s2 = 1.0 / (cfg.reg0 + alpha * N)
    mean = -s2 * (alpha * acc - W0_MEAN_0 * cfg.reg0)
    # JAX splits a key here whether or not it samples
    new_w0 = _maybe_sample(cfg.do_sample, draws.normal(()), mean, s2, w0,
                           zero_on_bad_sigma=False, counters=counters,
                           count_as="w0")
    return e - (w0 - new_w0), new_w0


def draw_w_hyperpriors(w, w_mu, w_lambda, attr_group, napg, cfg: FMConfig,
                       G, draws: Draws, counters, gsum=None):
    """draw_w_lambda then draw_w_mu (fm_learn_mcmc.h:425-426, 931-1007).
    ``gsum`` maps a [D] or [D, K] tensor to its [G, ...] group sums (None:
    ``group_sum`` by ``attr_group``); the feature-sharded learner's sums
    its shard's columns and all-reduces them."""
    if not cfg.do_multilevel:
        return torch.full((G,), MU_0, dtype=_F32, device=w.device), w_lambda
    if gsum is None:
        def gsum(x):
            return group_sum(x, attr_group, G)
    dev = gsum((w - w_mu.index_select(0, attr_group)) ** 2)
    lam_gamma = BETA_0 * (w_mu - MU_0) ** 2 + GAMMA_0 + dev
    lam_alpha = ALPHA_0 + napg + 1.0
    if cfg.do_sample:
        draw = draws.gamma(lam_alpha / 2.0) / (lam_gamma / 2.0)
    else:
        draw = lam_alpha / lam_gamma
    count_bad(counters, "w_lambda", draw)
    w_lambda = keep_finite(draw, w_lambda)
    wsum = gsum(w)
    mu_mean = (wsum + BETA_0 * MU_0) / (napg + BETA_0)
    mu_s2 = 1.0 / ((napg + BETA_0) * w_lambda)
    w_mu = _maybe_sample(cfg.do_sample, draws.normal((G,)), mu_mean, mu_s2,
                         w_mu, zero_on_bad_sigma=False, counters=counters,
                         count_as="w_mu")
    return w_mu, w_lambda


def draw_v_hyperpriors(v, v_mu, v_lambda, attr_group, napg, cfg: FMConfig,
                       G, K, draws: Draws, counters, gsum=None):
    """fm_learn_mcmc.h:1011-1089.  As in JAX, the Gamma draw has shape
    [G, 1]: one standard-Gamma number per group, scaled per factor.
    ``gsum`` as draw_w_hyperpriors'."""
    if not cfg.do_multilevel:
        return (torch.full((G, K), MU_0, dtype=_F32, device=v.device),
                v_lambda)
    if gsum is None:
        def gsum(x):
            return group_sum(x, attr_group, G)
    dev = gsum((v - v_mu.index_select(0, attr_group).T).T ** 2)
    lam_gamma = BETA_0 * (v_mu - MU_0) ** 2 + GAMMA_0 + dev
    lam_alpha = ALPHA_0 + napg[:, None] + 1.0  # [G, 1]
    if cfg.do_sample:
        draw = draws.gamma(lam_alpha / 2.0) / (lam_gamma / 2.0)
    else:
        draw = lam_alpha / lam_gamma
    count_bad(counters, "v_lambda", draw)
    v_lambda = keep_finite(draw, v_lambda)
    vsum = gsum(v.T)
    mu_mean = (vsum + BETA_0 * MU_0) / (napg[:, None] + BETA_0)
    mu_s2 = 1.0 / ((napg[:, None] + BETA_0) * v_lambda)
    v_mu = _maybe_sample(cfg.do_sample, draws.normal((G, K)), mu_mean, mu_s2,
                         v_mu, zero_on_bad_sigma=False, counters=counters,
                         count_as="v_mu")
    return v_mu, v_lambda


# ---------------------------------------------------------------------------
# The sweeps (in place on e and the parameter tables)
# ---------------------------------------------------------------------------

def w_sweep_main(e, w, w_mu, w_lambda, alpha, plan: PlanData, row: RowData,
                 cfg: FMConfig, draws: Draws, counters, mesh=None) -> None:
    """Binned w sweep + unobserved prior draws (fm_learn_mcmc.h:671-718),
    in place on e and w: X8c on every bucket of a bin at once into the
    zeroed [D, 2] delta table, then the w patch of e per bin.  On a data
    ``mesh``: T3's w stats of the rank's rows, the bin's [D] sums
    all-reduced over the data group (mcmc.py:640), then T5's draw."""
    D = w.shape[0]
    dev = w.device
    # one [D] table per sweep: each column is drawn once
    zw = draws.normal((D,)) if cfg.do_sample else None
    dtab = torch.empty(D, 2, dtype=_F32, device=dev)
    bad = torch.zeros(4, dtype=torch.int32, device=dev)
    for bin_blocks in plan.blocks:
        dtab.zero_()
        if mesh is None:
            mcmc_w_bin_draw(bin_blocks, e, w, w_mu, w_lambda, alpha, zw, dtab,
                            bad)
        else:
            acc = torch.zeros(D, dtype=_F32, device=dev)
            tp_w_stats(bin_blocks, e, acc, D)
            tp_w_draw(bin_blocks, mesh.all_reduce_data(acc), D, w, w_mu,
                      w_lambda, alpha, zw, dtab, bad)
        w_patch_rows(dtab, row.ids, row.vals, e)
    counters["nan_w"] = counters["nan_w"] + bad[0]
    counters["inf_w"] = counters["inf_w"] + bad[1]
    w_unobserved(w, w_mu, w_lambda, zw, plan, cfg, counters)


def w_unobserved(w, w_mu, w_lambda, zw, plan: PlanData, cfg: FMConfig,
                 counters) -> None:
    """The unobserved columns' w: posterior = prior N(mu_g, 1/lambda_g),
    from the w sweep's z table (mcmc.py:657-668), in place on w."""
    ag, unobs = plan.attr_group, plan.unobserved
    new_un = _maybe_sample(cfg.do_sample, zw, w_mu.index_select(0, ag),
                           1.0 / w_lambda.index_select(0, ag), w,
                           counters=counters, count_as="w", count_mask=unobs)
    w.copy_(torch.where(unobs, new_un, w))


def col_draw(blk, e, q, ptab, v_t, mu, lam, alpha, z, exact_seq: bool, nans,
             mesh=None) -> None:
    """One bucket's column draw, in place as X8a's: X8a itself, or on a
    data ``mesh`` T7's packed sums of the rank's rows, all-reduced over
    the data group (mcmc.py:437-439, :692), then T7's draw (no rows)."""
    if mesh is None:
        mcmc_col_draw(blk.rows, blk.x, blk.cols, blk.group, e, q, ptab, v_t,
                      mu, lam, alpha, z, exact_seq, nans)
        return
    D, F = v_t.shape
    acc = mesh.all_reduce_data(tp_col_draw_stats(
        blk.rows, blk.x, blk.cols, D, e, q, ptab, F, exact_seq))
    tp_col_draw(acc, blk.cols, blk.group, D, ptab, v_t, mu, lam, alpha, z,
                exact_seq, nans)


def _v_block_pass(e, v_t, mu_gf, lam_gf, draws: Draws, plan: PlanData,
                  row: RowData, cfg: FMConfig, alpha, exact_seq: bool,
                  counters, q_extra: Optional[torch.Tensor] = None,
                  mesh=None):
    """One factor block's bin sweep (mcmc.py:304-497), in place on e and
    v_t [D, F]; ``mu_gf``/``lam_gf`` [G, F] are the block's group priors.
    Per bin: the patch table ``ptab`` [D, 2F] takes the pre-bin v and
    zeroed dv channels; X8a draws each bucket's columns into v_t and fills
    their dv; X8b patches q and e from ``ptab``.  ``q_extra`` [N, F] is the
    non-main part of the q cache (the block-structure learner's relation
    qB gathers, mcmc.py:344-348), X8d's starting q: the positions add onto
    it, in JAX's order.  ``mesh``: a data mesh (``col_draw``).  Returns
    the q cache after the sweep (None when the plan has no bin)."""
    D, F = v_t.shape
    dev = v_t.device
    # one [F, D] table per block step: each column is drawn once
    z = draws.normal((F, D)) if cfg.do_sample else None
    ptab = torch.empty(D, 2 * F, dtype=_F32, device=dev)
    nans = torch.zeros(2, dtype=torch.int32, device=dev)
    q = None
    for bi, bin_blocks in enumerate(plan.blocks):
        ptab[:, :F] = v_t
        ptab[:, F:].zero_()
        if bi == 0:
            q = build_q(ptab, F, row.ids, row.vals, q_extra)
        for blk in bin_blocks:
            col_draw(blk, e, q, ptab, v_t, mu_gf, lam_gf, alpha, z,
                     exact_seq, nans, mesh)
        mcmc_patch_rows(ptab, F, row.ids, row.vals, q, e)
    counters["nan_v"] = counters["nan_v"] + nans[0]
    counters["inf_v"] = counters["inf_v"] + nans[1]
    return q


def _v_blocked_sweep(e, v, v_mu, v_lambda, alpha, plan: PlanData,
                     row: RowData, cfg: FMConfig, F: int, draws: Draws,
                     exact_seq: bool, counters, mesh=None) -> None:
    """Factor-blocked v sweep (mcmc.py:203-263) in K / F blocks of F
    factors, in place on e and v [K, D]; each block's unobserved columns
    then take the prior."""
    K = v.shape[0]
    for f0 in range(0, K, F):
        fs = slice(f0, f0 + F)
        v_t = v[fs].T.contiguous()  # [D, F]
        mu_gf = v_mu[:, fs].contiguous()
        lam_gf = v_lambda[:, fs].contiguous()
        _v_block_pass(e, v_t, mu_gf, lam_gf, draws, plan, row, cfg, alpha,
                      exact_seq, counters, mesh=mesh)
        v[fs] = v_block_unobserved(v_t, mu_gf, lam_gf, draws, plan, cfg,
                                   counters).T


def v_block_unobserved(v_t, mu_gf, lam_gf, draws: Draws, plan: PlanData,
                       cfg: FMConfig, counters) -> torch.Tensor:
    """A factor block's v_t [D, F] with its unobserved columns drawn from
    their prior (mcmc.py:254-261), from a [D, F] table of their own."""
    D, F = v_t.shape
    ag, unobs = plan.attr_group, plan.unobserved[:, None]
    # JAX splits a key here whether or not it samples
    new_un = _maybe_sample(cfg.do_sample, draws.normal((D, F)),
                           mu_gf.index_select(0, ag),
                           1.0 / lam_gf.index_select(0, ag), v_t,
                           counters=counters, count_as="v", count_mask=unobs)
    return torch.where(unobs, new_un, v_t)


def v_factor_main_bins(e, q, v_f, mu_f, lam_f, alpha, plan: PlanData,
                       row: RowData, cfg: FMConfig, draws: Draws,
                       counters, mesh=None) -> None:
    """One factor's bin sweep on its q cache [N, 1] with exact per-bin
    patches (draw_v, fm_learn_mcmc.h:784-840), then the unobserved columns'
    prior draws from the same noise table (mcmc.py:671-730); in place on
    e, q and v_f [D] (contiguous).  ``mu_f``/``lam_f`` are [G, 1]."""
    D = v_f.shape[0]
    dev = v_f.device
    z = draws.normal((D,)) if cfg.do_sample else None
    v_t = v_f.view(D, 1)
    ptab = torch.empty(D, 2, dtype=_F32, device=dev)
    nans = torch.zeros(2, dtype=torch.int32, device=dev)
    for bin_blocks in plan.blocks:
        ptab[:, 0] = v_f
        ptab[:, 1].zero_()
        for blk in bin_blocks:
            col_draw(blk, e, q, ptab, v_t, mu_f, lam_f, alpha,
                     None if z is None else z.view(1, D), True, nans, mesh)
        mcmc_patch_rows(ptab, 1, row.ids, row.vals, q, e)
    counters["nan_v"] = counters["nan_v"] + nans[0]
    counters["inf_v"] = counters["inf_v"] + nans[1]
    ag, unobs = plan.attr_group, plan.unobserved
    new_un = _maybe_sample(cfg.do_sample, z, mu_f[:, 0].index_select(0, ag),
                           1.0 / lam_f[:, 0].index_select(0, ag), v_f,
                           counters=counters, count_as="v", count_mask=unobs)
    v_f.copy_(torch.where(unobs, new_un, v_f))


def mcmc_draw_all(state: MCMCState, row: RowData, plan: PlanData,
                  cfg: FMConfig, num_cases: float, mesh=None):
    """One Gibbs (or ALS) sweep + the full re-predict of the train residual
    (mcmc.py:757-853).  Returns (new_state, counters) with the int32 device
    counters ``nan_<family>``/``inf_<family>``; ``state``'s tensors are not
    modified (its draw source advances).  ``mesh``: a data mesh of the
    ranks, ``row``/``plan`` the rank's (``MCMCLearner(mesh=)``)."""
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
        w_mu, w_lambda = draw_w_hyperpriors(w, w_mu, w_lambda, ag, napg, cfg,
                                            G, draws, counters)
        w_sweep_main(e, w, w_mu, w_lambda, alpha, plan, row, cfg, draws,
                     counters, mesh)
    if K > 0:
        v_mu, v_lambda = draw_v_hyperpriors(v, v_mu, v_lambda, ag, napg, cfg,
                                            G, K, draws, counters)
        F = factor_width(cfg)
        if F > 1 and K % F == 0:
            _v_blocked_sweep(e, v, v_mu, v_lambda, alpha, plan, row, cfg, F,
                             draws, exact_draws(cfg), counters, mesh)
        else:
            # the reference's factor-sequential chain (also where F does
            # not divide K, mcmc.py:808-817)
            for f in range(K):
                v_f = v[f]
                q = build_q(v_f.view(-1, 1), 1, row.ids, row.vals)
                v_factor_main_bins(e, q, v_f, v_mu[:, f:f + 1].contiguous(),
                                   v_lambda[:, f:f + 1].contiguous(), alpha,
                                   plan, row, cfg, draws, counters, mesh)

    # full re-predict (fm_learn_mcmc_simultaneous.h:134-176): e := yhat - y;
    # classification leaves e = yhat for the latent update
    e = repredicted(fm_scores(w0, w, v, row.ids, row.vals, k0=cfg.k0,
                              k1=cfg.k1), row, cfg)
    new_state = MCMCState(w0=w0, w=w, v=v, alpha=alpha, w_mu=w_mu,
                          w_lambda=w_lambda, v_mu=v_mu, v_lambda=v_lambda,
                          e=e, draws=draws)
    return new_state, counters


def repredicted(yhat: torch.Tensor, row: RowData, cfg: FMConfig):
    """The sweep's new residual from the re-predicted train scores
    (mcmc.py:843-847): yhat - y, or yhat itself under classification."""
    return yhat - row.target if cfg.task == TASK_REGRESSION else yhat


def resample_class_targets(state: MCMCState, row: RowData, cfg: FMConfig,
                           shard: int = 0, n_shards: int = 1) -> None:
    """The probit latent update of the train rows (mcmc.py:1072-1090), in
    place on ``state.e`` (= yhat): e <- yhat - z, z drawn from the
    truncated normal by the sign of y through the uniforms of one draw
    (Gibbs; the rows of data shard ``shard`` of ``n_shards``), or its mean
    (ALS, where JAX still splits its key: the port asks its draw source
    for a zero-length draw)."""
    n = state.e.shape[0] if cfg.do_sample else 0
    u = state.draws.uniform((n,), CDF_EPS, 1.0 - CDF_EPS, shard, n_shards)
    if cfg.do_sample:
        probit_latent(state.e, row.target, u, PROBIT_GIBBS)
    else:
        probit_latent(state.e, row.target, None, PROBIT_ALS)


# ---------------------------------------------------------------------------
# The learners
# ---------------------------------------------------------------------------

# per-iteration scalar metrics, in the order they are packed on the device
_SCALARS = ("rmse", "rmse_this", "rmse_all_but5", "mae", "alpha") + tuple(
    f"{k}_{fam}" for fam in NAN_FAMILIES for k in ("nan", "inf"))
# the same under classification (mcmc.py:1046-1068)
_SCALARS_CLASS = ("accuracy", "loglik", "acc_this", "ll_this",
                  "alpha") + _SCALARS[5:]


class MCMCLearner:
    """Gibbs MCMC trainer on one device, or data-parallel over a data mesh
    of ranks (``mesh``: ``parallel/mesh.py:make_mesh``; every rank
    constructs the learner with the whole data and keeps its block of
    rows).  The learner runs where it is told (``device``, or the mesh's)
    and never moves itself."""

    method = "mcmc"
    map_eval = None  # a base.MapEval: per-iteration MAP@k (classification)
    mesh = None  # a data mesh of ranks (parallel/mesh.py:make_mesh)

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None, *,
                 device=None, bins: str = "auto", out_dir: str = ".",
                 write_files: bool = True,
                 w_lambda_init: Optional[np.ndarray] = None,
                 v_lambda_init: Optional[np.ndarray] = None,
                 plan: Optional[SweepPlan] = None,
                 num_eval_cases: Optional[int] = None, mesh=None):
        check_slice(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.device = learner_device(device, mesh)
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        if meta.num_attributes != cfg.num_attributes:
            raise ValueError("meta and cfg disagree on num_attributes")
        self.meta = meta
        self.plan = mesh_plan(train, cfg, meta, bins, mesh, plan)
        self.plan_data = build_plan_data(self.plan, meta, self.device, mesh)
        self.train_row, self.train_n = build_row_data(train, self.device,
                                                      mesh)
        self.test_row, self.test_n = build_row_data(test, self.device, mesh)
        self.rps = self.train_row.ids.shape[0]
        self.test_rps = self.test_row.ids.shape[0]
        # -num_eval_cases: the eval over the first rows (its mask replaces
        # the test valid mask), rmse_test2_this/_all over the rest
        # (mcmc.py:905-923), on the global row index
        first = 0 if mesh is None else mesh.d_index * self.test_rps
        self.test_row, self._rest_valid, self._eval_n = held_back(
            self.test_row, self.test_n, num_eval_cases, first)
        self.out_dir = out_dir
        self.write_files = write_files and self.lead
        G, K = cfg.num_groups, cfg.num_factor
        # -regular: the per-group lambda init (libfm.cpp:367-407)
        self.w_lambda_init = (np.full(G, cfg.regw, np.float32)
                              if w_lambda_init is None else w_lambda_init)
        self.v_lambda_init = (np.full((G, K), cfg.regv, np.float32)
                              if v_lambda_init is None else v_lambda_init)
        self._pred_sum_all = None
        self._pred_iters = 0

    # ---- state ------------------------------------------------------------

    def state_from_params(self, w0, w, v, draws: Draws) -> MCMCState:
        """The sampler's start from w0, w [D] and v [K, D]: e = yhat - y
        (kernel K1), alpha = 1, zero prior means, the -regular lambdas."""
        cfg, row, dev = self.cfg, self.train_row, self.device
        w0, w, v = (a.to(dev, _F32) for a in (w0, w, v))
        e = fm_scores(w0, w, v, row.ids, row.vals, k0=cfg.k0,
                      k1=cfg.k1) - row.target
        G, K = cfg.num_groups, cfg.num_factor
        return MCMCState(
            w0=w0, w=w, v=v, alpha=torch.ones((), dtype=_F32, device=dev),
            w_mu=torch.zeros(G, dtype=_F32, device=dev),
            w_lambda=torch.as_tensor(self.w_lambda_init, dtype=_F32).to(dev),
            v_mu=torch.zeros(G, K, dtype=_F32, device=dev),
            v_lambda=torch.as_tensor(self.v_lambda_init, dtype=_F32).to(dev),
            e=e, draws=draws)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   draws: Optional[Draws] = None) -> MCMCState:
        """w and v ~ init_stdev N(0,1) from ``generator`` (a CPU generator
        seeded with ``cfg.seed`` by default, so every device starts from
        the same numbers); ``draws`` defaults to a generator on the
        learner's device seeded with ``cfg.seed``."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        if draws is None:
            draws = device_draws(cfg.seed, self.device)
        p = init_fm_params(generator, cfg.num_attributes, cfg.num_factor,
                           init_stdev=cfg.init_stdev, init_w_normal=True)
        return self.state_from_params(p.w0, p.w, p.v, draws)

    def _test_scores(self, state: MCMCState) -> torch.Tensor:
        return fm_scores(state.w0, state.w, state.v, self.test_row.ids,
                         self.test_row.vals, k0=self.cfg.k0, k1=self.cfg.k1)

    def predict_test_scores(self, state: MCMCState) -> np.ndarray:
        return self._test_vector(self._test_scores(state))

    # ---- what a data mesh changes (a sharded learner overrides) -----------

    @property
    def lead(self) -> bool:
        """Whether this process prints and writes the files (one device:
        always; a data mesh: rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _test_vector(self, t: torch.Tensor) -> np.ndarray:
        """A per-test-row device vector on the host, its real rows in
        global order (on a data mesh gathered over the shards: every rank
        calls it)."""
        if self.mesh is not None:
            t = gather_rows(self.mesh, t, self.test_rps)
        return t.cpu().numpy()[: self.test_n]

    def _total(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over the rank's rows, total over the rows' shards."""
        return t if self.mesh is None else self.mesh.all_reduce_data(t)

    def _ckpt_blob(self, blob: dict) -> dict:
        """The run's blob as a data mesh's checkpoint holds it, on the
        host: e [N] and the accumulators [N_test] of the real rows in
        global order (a resident learner's layout), so that another
        number of ranks resumes it.  Every rank must call it."""
        st = blob["state"]
        host = {f.name: getattr(st, f.name).cpu() for f in
                dataclasses.fields(MCMCState) if f.name != "draws"}
        host["e"] = gather_rows(self.mesh, st.e, self.rps)[
            : self.train_n].cpu()
        return {"state": MCMCState(**host, draws=st.draws),
                **{k: torch.from_numpy(self._test_vector(blob[k]))
                   for k in ("psum_all", "psum_but5")}}

    def _resume(self, ckpt, blob: dict):
        if self.mesh is None:
            return resume(self, ckpt, blob)
        if ckpt is None:
            return blob, 0
        restored = ckpt.restore_latest(self._ckpt_blob(blob))
        if restored is None:
            return blob, 0
        g, step, _meta = restored
        st = g["state"]
        local = {f.name: getattr(st, f.name) for f in
                 dataclasses.fields(MCMCState) if f.name != "draws"}
        local["e"] = row_block(self.mesh, st.e, self.rps)
        return {"state": MCMCState(**{k: a.to(self.device) for k, a in
                                      local.items()}, draws=st.draws),
                **{k: row_block(self.mesh, g[k], self.test_rps).to(
                    self.device) for k in ("psum_all", "psum_but5")}}, step

    def _save(self, ckpt, blob: dict, done: int) -> None:
        if self.mesh is None:
            ckpt.save(blob, done, {"method": self.method})
            return
        g = self._ckpt_blob(blob)
        if self.lead:
            ckpt.save(g, done, {"method": self.method})
        self.mesh.barrier()

    def final_test_predictions(self, state: MCMCState) -> np.ndarray:
        """The reference's predict() (fm_learn_mcmc.h:355-379): the
        posterior mean pred_sum_all / iterations when sampling, else the
        last state's scores; clamped to the target range, or under
        classification probabilities in [0, 1] (the accumulators hold
        Phi(score) there; ALS takes Phi of its scores, mcmc.py:1542-1556)."""
        if self.cfg.do_sample and self._pred_iters > 0:
            pm = self._pred_sum_all / float(self._pred_iters)
        else:
            pm = self.predict_test_scores(state)
            if self.cfg.task != TASK_REGRESSION:
                pm = ref_cdf_gaussian(torch.from_numpy(pm)).numpy()
        if self.cfg.task != TASK_REGRESSION:
            return np.clip(pm, 0.0, 1.0)
        return np.clip(pm, self.cfg.min_target, self.cfg.max_target)

    # ---- one iteration ----------------------------------------------------

    def step(self, state: MCMCState):
        """One sweep (no eval).  Returns (state, counters)."""
        return mcmc_draw_all(state, self.train_row, self.plan_data, self.cfg,
                             float(self.train_n), self.mesh)

    def _eval(self, state: MCMCState, nans: dict, psum_all, psum_but5,
              it: int) -> torch.Tensor:
        """The JAX learner's _eval_tail (mcmc.py:1005-1068): adds this
        iteration's clipped test scores (classification: Phi(score)) to the
        posterior-mean accumulators (in place) and returns the packed
        metrics, a float32 device vector laid out as ``_SCALARS`` (or
        ``_SCALARS_CLASS``) then w_mu [G], w_lambda [G], v_mu [G*K],
        v_lambda [G*K].  Classification then updates the train rows'
        latent targets, in place on ``state.e``.  Under -num_eval_cases
        the metrics are over the first rows, and rmse_test2_this/_all
        (this iteration's and the posterior mean's RMSE over the held-back
        rows, mcmc.py:1036-1045) follow the counters."""
        cfg, trow = self.cfg, self.test_row
        lo, hi = cfg.min_target, cfg.max_target
        scores = self._test_scores(state)
        nt = float(self._eval_n)
        if cfg.task != TASK_REGRESSION:
            m = self._total(probit_eval(scores, trow.target, trow.valid, nt,
                                        psum_all, psum_but5, it))
            self._resample(state)
            return self._packed([m, state.alpha[None]], nans, state)
        p = torch.clamp(scores, lo, hi)
        psum_all += p
        if it >= 5:
            psum_but5 += p

        def _rmse(pred, norm):
            err = (torch.clamp(pred * norm, lo, hi) - trow.target) * trow.valid
            return torch.sqrt(self._total(torch.sum(err * err)) / nt)

        err_this = (p - trow.target) * trow.valid
        rmse_this = torch.sqrt(self._total(torch.sum(err_this * err_this))
                               / nt)
        rmse_all = _rmse(psum_all, 1.0 / (it + 1.0))
        rmse_but5 = (_rmse(psum_but5, 1.0 / max(it - 4.0, 1.0)) if it >= 5
                     else rmse_all)
        err_all = (torch.clamp(psum_all / (it + 1.0), lo, hi)
                   - trow.target) * trow.valid
        mae = self._total(torch.sum(torch.abs(err_all))) / nt
        tail = []
        if self._rest_valid is not None:
            n2 = float(self.test_n - self._eval_n)
            e2 = (p - trow.target) * self._rest_valid
            pm2 = (torch.clamp(psum_all / (it + 1.0), lo, hi)
                   - trow.target) * self._rest_valid
            tail = [torch.sqrt(self._total(torch.stack(
                [torch.sum(e2 * e2), torch.sum(pm2 * pm2)])) / n2)]
        return self._packed([torch.stack(
            [rmse_all, rmse_this, rmse_but5, mae, state.alpha])], nans, state,
            tail)

    def _resample(self, state: MCMCState) -> None:
        """The latent update of the train rows under classification (on a
        data mesh the uniforms of the rank's shard, mcmc.py:1081's fold-in
        of its index)."""
        d, n = (0, 1) if self.mesh is None else (self.mesh.d_index,
                                                 self.mesh.n_data)
        resample_class_targets(state, self.train_row, self.cfg, d, n)

    def _packed(self, head: list, nans: dict, state: MCMCState,
                tail: list = ()):
        counts = torch.stack([nans[k].to(_F32) for k in _SCALARS[5:]])
        return torch.cat(head + [counts] + list(tail) + [
            state.w_mu, state.w_lambda, state.v_mu.reshape(-1),
            state.v_lambda.reshape(-1)])

    def _scalars(self) -> tuple:
        if self.cfg.task != TASK_REGRESSION:
            return _SCALARS_CLASS
        return _SCALARS + (("rmse_test2_this", "rmse_test2_all")
                           if self._rest_valid is not None else ())

    def _unpack(self, m: np.ndarray) -> dict:
        G, K = self.cfg.num_groups, self.cfg.num_factor
        names = self._scalars()
        n = len(names)
        rec = {k: float(m[i]) for i, k in enumerate(names)}
        rec["w_mu"] = m[n:n + G].copy()
        rec["w_lambda"] = m[n + G:n + 2 * G].copy()
        o = n + 2 * G
        rec["v_mu"] = m[o:o + G * K].reshape(G, K).copy()
        rec["v_lambda"] = m[o + G * K:o + 2 * G * K].reshape(G, K).copy()
        return rec

    # ---- training loop ----------------------------------------------------

    def run(self, state: Optional[MCMCState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            chunk: Optional[int] = None, ckpt=None, ckpt_every: int = 10):
        """Run ``num_iter`` sweeps with the on-device eval and posterior-mean
        accumulators.  The per-iteration metrics are fetched once per chunk
        of ``chunk`` sweeps (default min(10, num_iter); 1 with a
        ``map_eval`` under classification, which ranks the posterior-mean
        probabilities every iteration, mcmc.py:1401-1405);
        ``time_learn`` is the chunk's wall time per sweep, up to that
        fetch.  ``ckpt`` (a ``utils.checkpoint.CheckpointManager``) saves
        and resumes ``{"state", "psum_all", "psum_but5"}``, the draw
        source's generator state in the state (mcmc.py:1414-1426,
        :1523-1528), as ``VBLearner.run`` does.  Returns (state,
        history)."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        verbose = verbose and self.lead
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        chunk = chunk if chunk is not None else max(1, min(10, num_iter))
        map_eval = self.map_eval if cfg.task != TASK_REGRESSION else None
        if map_eval is not None:
            chunk = 1
        n_test = self.test_row.target.shape[0]
        psum_all = torch.zeros(n_test, dtype=_F32, device=self.device)
        blob, done = self._resume(ckpt, {
            "state": state, "psum_all": psum_all,
            "psum_but5": torch.zeros_like(psum_all)})
        state, psum_all, psum_but5 = (blob["state"], blob["psum_all"],
                                      blob["psum_but5"])
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method,
                                   self.out_dir,
                                   self.write_files and done == 0)
        history = []
        last_saved = done
        while done < num_iter:
            n = min(chunk, num_iter - done)
            t0 = time.perf_counter()
            packed = []
            for j in range(n):
                state, nans = self.step(state)
                packed.append(self._eval(state, nans, psum_all, psum_but5,
                                         done + j))
            t_fetch = time.perf_counter()
            metrics = torch.stack(packed).cpu().numpy()  # the one sync
            now = time.perf_counter()
            for j in range(n):
                rec = {"iter": done + j, "time_learn": (now - t0) / n,
                       "time_pred": (now - t_fetch) / n}
                if not self.plan.conflict_free:
                    rec["conflict_free"] = False  # Jacobi-bin approximation
                rec.update(self._unpack(metrics[j]))
                if cfg.task != TASK_REGRESSION:
                    rmse_file.append(rec["accuracy"])
                    if map_eval is not None:
                        # the posterior-mean probabilities at this
                        # iteration (one iteration a chunk)
                        probs = (self._test_vector(psum_all)
                                 / (rec["iter"] + 1.0))
                        rec["map"] = map_eval(probs)
                        if verbose:
                            print(f"#Iter={rec['iter']:3d}\t"
                                  f"Test={rec['accuracy']:.6g}"
                                  f"\tMAP@{map_eval.k}= {rec['map']:.6g}")
                    elif verbose:
                        print(f"#Iter={rec['iter']:3d}\t"
                              f"Test={rec['accuracy']:.6g}")
                else:
                    rmse_file.append(rec["rmse"])
                    if verbose:
                        print(f"#Iter={rec['iter']:3d}\t"
                              f"Test={rec['rmse']:.6g}"
                              f"\tTest(this)={rec['rmse_this']:.6g}")
                print_nonzero_nans(rec, verbose)
                stream_row(self, rec)
                history.append(rec)
            done += n
            if ckpt is not None and (done - last_saved >= ckpt_every
                                     or done >= num_iter):
                self._save(ckpt, {"state": state, "psum_all": psum_all,
                                  "psum_but5": psum_but5}, done)
                last_saved = done
        self._pred_sum_all = self._test_vector(psum_all)
        self._pred_iters = done
        return state, history


class ALSLearner(MCMCLearner):
    """ALS = MCMC with do_sample=False, do_multilevel=False
    (libfm.cpp:131-135).  Trajectory files keep the '_mcmc' suffix because
    the reference rewrites the method string before dispatch."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        cfg = dataclasses.replace(cfg, do_sample=False, do_multilevel=False)
        super().__init__(cfg, *args, **kwargs)
