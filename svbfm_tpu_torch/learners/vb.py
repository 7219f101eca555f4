"""VBFM — batch coordinate-ascent variational Bayes, on one device or on a
data mesh of ranks.

Counterpart of ``svbfm_tpu/learners/vb.py``, regression and probit
classification (``task=1``: each sweep ends with the test accuracy and
log-likelihood, X12b, and the truncated-mean update of the train
residual, X12a), in both of its modes: fast (``factor_block=0``: all K
factors form one block and the linear-term update rides in its bin
passes) and exact (``factor_block=F``
> 0, or K = 0: the linear-term sweep runs standalone first, then blocks of
F factors, the last block narrower when F does not divide K; F = 1 is the
reference's own order).  The math and its order are the JAX package's; the
execution is eager PyTorch around hand-written CUDA kernels (``kernels/``),
each with a plain twin that runs on the CPU:

* K1 ``fm_scores`` / ``fm_t_terms``: init caches and the per-sweep test eval;
* K2 ``vb_build_qt``: the q/tq/tz row caches at block entry;
* K3 ``vb_col_stats_update``: per-bucket column statistics + closed form;
* K4 ``vb_patch_rows``: the per-bin row-cache patch;
* K5 ``w_bin_update`` (one launch a bin) + ``w_patch_rows`` (K4 at
  F = 0): the standalone linear-term sweep;
* X12a ``probit_latent`` and X12b ``probit_eval`` under classification.

Sweep semantics (see the JAX module's docstring): bins in order, exact
Gauss-Seidel over conflict-free columns; factors within the block Jacobi;
the reference's quirks kept (e = y - yhat, 2*3.14 in the free energy,
0.1*N(0,1) init, keep-finite reverts, only the test scores re-predicted).

Everything a sweep computes stays on the device: the per-iteration metrics
are fetched once per ``run`` chunk, never per bin.

Data-parallel (``mesh=``, a ``parallel/mesh.py:make_mesh`` data mesh of
the ranks; the JAX learner on ``make_mesh(n)``): rank d holds the block d
of the rows with their caches and every parameter table; each sum over
rows that the JAX package psums over its data axis is the rank's sum,
all-reduced over the data group, before the closed form that every rank
then computes alike.  The column statistics run as the split forms of the
feature-sharded sweep at ``lo = 0``, ``D_loc = D``:

* T2 ``tp_build_qt``, T3 ``tp_col_stats`` + ``tp_col_update`` and T4
  ``tp_patch_delta`` for a v block (K3's stats and closed form split
  around the all-reduce of the [C, 2F + 1] sums, w rider included; the
  caches one [N, 3F] buffer, which T3 reads);
* T3 at K = 0, ``tp_w_stats`` + ``tp_w_update``, then K4 at F = 0 on the
  rank's rows, for the standalone w sweep (K5 split around the all-reduce
  of the bin's [D] sums);
* w0's and alpha's residual sums and the test eval's sums all-reduced.
A mesh of one rank runs the same forms, with no collective.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels.vb_sweep import (tp_build_qt, tp_col_stats,
                                              tp_col_update, tp_patch_delta,
                                              tp_patch_views, vb_build_qt,
                                              vb_col_stats_update,
                                              vb_patch_rows, w_patch_rows)
from svbfm_tpu_torch.kernels.probit import (PROBIT_VB, probit_eval,
                                            probit_latent)
from svbfm_tpu_torch.kernels.w_sweep import (tp_w_stats, tp_w_update,
                                             w_bin_update)
from svbfm_tpu_torch.learners.base import (TASK_REGRESSION, FMConfig, PlanData,
                                           RowData, TrajectoryFile,
                                           build_plan_data, build_row_data,
                                           check_task_r_or_c, gather_rows,
                                           group_sum, held_back, keep_finite,
                                           learner_device, mesh_plan,
                                           nonfinite, row_block)
from svbfm_tpu_torch.ops.forward import fm_scores, fm_t_terms
from svbfm_tpu_torch.utils.checkpoint import resume
from svbfm_tpu_torch.utils.rlog_schema import stream_row

_F32 = torch.float32


@dataclass
class VBState:
    # variational parameters
    mu_0: torch.Tensor  # scalar
    sigma_0_dash: torch.Tensor  # scalar
    mu_w: torch.Tensor  # [D]
    sigma_w_dash: torch.Tensor  # [D]
    mu_v: torch.Tensor  # [K, D]
    sigma_v_dash: torch.Tensor  # [K, D]
    # posterior precisions / noise
    alpha: torch.Tensor  # scalar
    sigma_0: torch.Tensor  # scalar
    sigma_w: torch.Tensor  # [G]
    sigma_v: torch.Tensor  # [G, K]
    # residual caches
    e: torch.Tensor  # [N] = y - yhat (+ incremental patches)
    t: torch.Tensor  # [N] = T-terms


PARAM_FIELDS = ("mu_0", "sigma_0_dash", "mu_w", "sigma_w_dash", "mu_v",
                "sigma_v_dash", "alpha", "sigma_0", "sigma_w", "sigma_v")


def init_vb_params(generator: torch.Generator, cfg: FMConfig,
                   device) -> dict:
    """The reference's VB init (fm_learn_vb.h:685-712): mu' ~ 0.1 N(0,1),
    sigma' = 0.02, alpha = sigma_0 = sigma_w = sigma_v = 1.  The normal
    draws come from ``generator`` (a CPU generator, so every device gets
    the same numbers) and are then moved to ``device``."""
    D, K, G = cfg.num_attributes, cfg.num_factor, cfg.num_groups
    mu_w = 0.1 * torch.randn(D, generator=generator, dtype=_F32)
    mu_v = 0.1 * torch.randn(K, D, generator=generator, dtype=_F32)
    return dict(
        mu_0=torch.zeros((), dtype=_F32, device=device),
        sigma_0_dash=torch.full((), 0.02, dtype=_F32, device=device),
        mu_w=mu_w.to(device),
        sigma_w_dash=torch.full((D,), 0.02, dtype=_F32, device=device),
        mu_v=mu_v.to(device),
        sigma_v_dash=torch.full((K, D), 0.02, dtype=_F32, device=device),
        alpha=torch.ones((), dtype=_F32, device=device),
        sigma_0=torch.ones((), dtype=_F32, device=device),
        sigma_w=torch.ones(G, dtype=_F32, device=device),
        sigma_v=torch.ones(G, K, dtype=_F32, device=device),
    )


def check_slice(cfg: FMConfig) -> None:
    """Raise for what the port does not run yet; nothing falls back."""
    if cfg.factor_block < 0 or cfg.num_factor < 0:
        raise ValueError("factor_block and num_factor must be >= 0")
    check_task_r_or_c(cfg)


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def vb_v_block_update(e, t, mu_t, sig_t, sv, alpha, plan: PlanData,
                      row: RowData, w_state=None):
    """Coordinate sweep of one block of F factors (fm_learn_vb.h:577-644),
    in place.

    ``mu_t``/``sig_t`` [D, F] are the factor tables, ``sv`` [G, F] the
    per-group prior precisions; e/t [N] are the residual caches.  With
    ``w_state = (mu_w, sigma_w_dash, sigma_w)`` the linear-term update rides
    in the same passes.  All of e, t, mu_t, sig_t and the w_state tables are
    updated in place.  Returns the int32 device counters
    [nan_v, nan_w].

    Per bin: the patch table ``ptab`` [D, CH] takes the PRE-BIN mu/sigma
    (every bucket of the bin, and the patch, read these) and zeroed delta
    channels; K3 fills the deltas of the bin's columns and writes the new
    values into mu_t/sig_t; K4 patches the row caches from ``ptab``.
    """
    D, F = mu_t.shape
    merge_w = w_state is not None
    CH = 5 * F + (2 if merge_w else 0)
    nans = torch.zeros(2, dtype=torch.int32, device=e.device)
    ptab = torch.empty(D, CH, dtype=_F32, device=e.device)
    q = tq = tz = None
    for bi, bin_blocks in enumerate(plan.blocks):
        ptab[:, :F] = mu_t
        ptab[:, F:2 * F] = sig_t
        ptab[:, 2 * F:].zero_()
        if bi == 0:
            q, tq, tz = vb_build_qt(ptab, F, row.ids, row.vals)
        for blk in bin_blocks:
            vb_col_stats_update(blk.rows, blk.x, blk.cols, blk.group, blk.sx2,
                                e, q, tq, ptab, mu_t, sig_t, sv, alpha,
                                w_state, nans)
        vb_patch_rows(ptab, F, merge_w, row.ids, row.vals, q, tq, tz, e, t)
    return nans


def split_v_block_update(e, t, mu_t, sig_t, sv, alpha, plan, row: RowData,
                         mesh, w_state=None, lo: int = 0):
    """``vb_v_block_update`` with the split forms, on a mesh: the rank's
    rows and its columns [lo, lo + D_loc) (``mu_t``/``sig_t`` [D_loc, F];
    the whole table on a data mesh), each bucket's column sums
    all-reduced over the data group between T3's stats and update
    launches (svbfm_tpu/learners/vb.py:446-447, :477).  The row caches are
    T2's one [N, 3F] buffer (q | tq | tz), which T3 reads, and a bin's
    patch T4's deltas against the pre-patch caches, then added; both are
    partials summed over the feature group (nothing on a data mesh:
    ``parallel/tp_vb.py``'s sweep).  In place, as ``vb_v_block_update``;
    returns the int32 device counters [nan_v, nan_w], equal on every
    rank."""
    D_loc, F = mu_t.shape
    N = e.shape[0]
    merge_w = w_state is not None
    ptab = torch.empty(D_loc, 5 * F + (2 if merge_w else 0), dtype=_F32,
                       device=e.device)
    nans = torch.zeros(2, dtype=torch.int32, device=e.device)
    qt = None
    for bin_blocks in plan.blocks:
        # the PRE-BIN mu/sig that every bucket and the patch read, and
        # zeroed deltas
        ptab[:, :F] = mu_t
        ptab[:, F:2 * F] = sig_t
        ptab[:, 2 * F:].zero_()
        if qt is None:  # T2 + ONE feature all-reduce a block
            qt = mesh.all_reduce_feature(
                tp_build_qt(ptab, F, row.ids, row.vals, lo, D_loc))
        for blk in bin_blocks:  # T3: stats, data all-reduce, update
            acc = mesh.all_reduce_data(tp_col_stats(
                blk.rows, blk.x, blk.cols, D_loc, e, qt, ptab, F))
            tp_col_update(acc, blk.cols, D_loc, blk.group, blk.sx2, ptab,
                          mu_t, sig_t, sv, alpha, w_state, nans)
        # T4: the columns' part of the bin's patch against the pre-patch
        # caches, ONE feature all-reduce, then the add
        dqt, de, dt = tp_patch_views(mesh.all_reduce_feature(tp_patch_delta(
            ptab, F, merge_w, row.ids, row.vals, qt, lo, D_loc)), N, F)
        qt += dqt
        e += de
        t += dt
    return nans


def vb_w_bin_update(e, t, mu_w, sigma_w_dash, sigma_w, alpha, bin_blocks,
                    row: RowData, dtab, bad, mesh=None) -> None:
    """One conflict-free bin of the standalone linear-term sweep
    (fm_learn_vb.h:527-574), in place on e, t, mu_w and sigma_w_dash: K5 on
    every degree bucket at once into the zeroed [D, 2] delta table
    ``dtab``, then the w patch of the row caches.  ``bad`` [4] gathers the
    candidate counts.  On a data ``mesh``: T3 at K = 0, the bin's [D]
    column sums all-reduced over the data group between its stats and
    update launches (svbfm_tpu/learners/vb.py:140)."""
    dtab.zero_()
    if mesh is None:
        w_bin_update(bin_blocks, e, mu_w, sigma_w_dash, sigma_w, alpha, dtab,
                     bad)
    else:
        D = mu_w.shape[0]
        acc = torch.zeros(D, dtype=_F32, device=e.device)
        tp_w_stats(bin_blocks, e, acc, D)
        tp_w_update(bin_blocks, mesh.all_reduce_data(acc), D, mu_w,
                    sigma_w_dash, sigma_w, alpha, dtab, bad)
    w_patch_rows(dtab, row.ids, row.vals, e, t)


def factor_blocks(K: int, factor_block: int):
    """(start, stop) of each factor block: ``factor_block`` factors each
    (0 = all K), the last block narrower when the width does not divide K.
    The JAX package pads K to a multiple of the width and masks the pad
    factors instead; their deltas are zero, so the values are the same."""
    F = min(factor_block if factor_block > 0 else K, K)
    return [(f0, min(f0 + F, K)) for f0 in range(0, K, F)] if K else []


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def vb_update_all(state: VBState, row: RowData, plan: PlanData, cfg: FMConfig,
                  num_cases: float, mesh=None):
    """One full VB sweep (fm_learn_vb.h:383-501) + free energy.  Returns
    (new_state, fe, nans) with device scalars; ``state`` is not modified.
    ``nan_w`` counts the linear-term candidates that were not finite in
    fast mode only, as the JAX package records it: the standalone sweep of
    exact mode keeps its reverts but reports none.  ``mesh``: a data mesh
    of the ranks, ``row``/``plan`` the rank's (``VBLearner(mesh=)``)."""
    check_slice(cfg)
    total = _same if mesh is None else mesh.all_reduce_data
    dev = state.e.device
    e, t = state.e.clone(), state.t.clone()
    alpha = state.alpha
    mu_0, sigma_0_dash = state.mu_0, state.sigma_0_dash
    N = torch.full((), num_cases, dtype=_F32, device=dev)

    # --- w0 update (fm_learn_vb.h:504-525) ---
    if cfg.k0:
        sigma_new = 1.0 / (state.sigma_0 + N * alpha)
        w0_temp = total(torch.sum(e * row.valid)) + N * mu_0
        mu_new = sigma_new * alpha * w0_temp
        e += mu_0 - mu_new
        t += sigma_new - sigma_0_dash
        mu_0, sigma_0_dash = mu_new, sigma_new

    # In fast mode the linear-term update rides in the single v block's
    # passes; otherwise (exact mode, K = 0) it runs standalone first.
    K = cfg.num_factor
    merge_w = cfg.k1 and cfg.factor_block == 0 and K > 0
    mu_w, sigma_w_dash = state.mu_w.clone(), state.sigma_w_dash.clone()
    nan_w = torch.zeros((), dtype=torch.int32, device=dev)
    nan_v = torch.zeros((), dtype=torch.int32, device=dev)

    # --- w sweep (fm_learn_vb.h:390-406) ---
    if cfg.k1 and not merge_w:
        dtab = torch.empty(cfg.num_attributes, 2, dtype=_F32, device=dev)
        bad = torch.zeros(4, dtype=torch.int32, device=dev)
        for bin_blocks in plan.blocks:
            vb_w_bin_update(e, t, mu_w, sigma_w_dash, state.sigma_w, alpha,
                            bin_blocks, row, dtab, bad, mesh)

    # --- v sweeps, factor-major (fm_learn_vb.h:409-440) ---
    mu_v = state.mu_v.clone()
    sigma_v_dash = state.sigma_v_dash.clone()
    w_state = (mu_w, sigma_w_dash, state.sigma_w) if merge_w else None
    for f0, f1 in factor_blocks(K, cfg.factor_block):
        # [D, F] from the copies: at F = 1 .contiguous() returns a view,
        # which the kernels then write in place
        mu_t = mu_v[f0:f1].T.contiguous()
        sig_t = sigma_v_dash[f0:f1].T.contiguous()
        sv = state.sigma_v[:, f0:f1].contiguous()
        if mesh is None:
            nans_vw = vb_v_block_update(e, t, mu_t, sig_t, sv, alpha, plan,
                                        row, w_state)
        else:
            nans_vw = split_v_block_update(e, t, mu_t, sig_t, sv, alpha,
                                           plan, row, mesh, w_state)
        mu_v[f0:f1], sigma_v_dash[f0:f1] = mu_t.T, sig_t.T
        nan_v = nan_v + nans_vw[0]
        nan_w = nan_w + nans_vw[1]

    new_state, fe, nan_alpha = vb_finalize(
        e, t, mu_0, sigma_0_dash, mu_w, sigma_w_dash, mu_v, sigma_v_dash,
        state, row, plan, cfg, N, total)
    nans = dict(nan_w=nan_w, nan_v=nan_v, nan_alpha=nan_alpha)
    return new_state, fe, nans


def vb_finalize(e, t, mu_0, sigma_0_dash, mu_w, sigma_w_dash, mu_v,
                sigma_v_dash, state: VBState, row: RowData, plan: PlanData,
                cfg: FMConfig, N, total=_same):
    """Sweep tail: unobserved-column fixups, hyperparameter updates
    (fm_learn_vb.h:446-498) and the free energy (:646-681, constant 2*3.14
    kept).  ``state`` carries the PRE-SWEEP hyperparameters.  The segment
    sums over attribute groups are ``base.group_sum``; ``total`` sums
    alpha's residual sum over the data shards (vb.py:800)."""
    K, G = cfg.num_factor, cfg.num_groups
    dev = e.device
    ag = plan.attr_group
    unobs = plan.unobserved
    zero = torch.zeros((), dtype=_F32, device=dev)

    # columns with no occurrences: sigma' = 1/sigma(g), mu' = 0
    if K > 0:
        sv_d = state.sigma_v.index_select(0, ag).T  # [K, D]
        sigma_v_dash = torch.where(unobs[None, :], 1.0 / sv_d, sigma_v_dash)
        mu_v = torch.where(unobs[None, :], zero, mu_v)
    if cfg.k1:
        sw_d = state.sigma_w.index_select(0, ag)
        sigma_w_dash = torch.where(unobs, 1.0 / sw_d, sigma_w_dash)
        mu_w = torch.where(unobs, zero, mu_w)

    # --- hyperparameter updates (fm_learn_vb.h:446-498) ---
    alpha_temp = total(torch.sum((e * e + t) * row.valid))
    alpha_cand = N / alpha_temp
    nan_alpha = nonfinite(alpha_cand)
    alpha = keep_finite(alpha_cand, state.alpha)
    sigma_0 = 1.0 / (mu_0 * mu_0 + sigma_0_dash)
    w_stat = group_sum(mu_w * mu_w + sigma_w_dash, ag, G)
    sigma_w = plan.num_attr_per_group / w_stat
    v_stat = group_sum((mu_v * mu_v + sigma_v_dash).T, ag, G)  # [G, K]
    sigma_v = plan.num_attr_per_group[:, None] / v_stat

    # --- free energy (fm_learn_vb.h:646-681; constant 2*3.14 kept) ---
    fe = -0.5 * alpha * alpha_temp - 0.5 * N * torch.log(2 * 3.14 / alpha)
    fe = fe + (-0.5 * sigma_0 * (mu_0 * mu_0 + sigma_0_dash)
               + 0.5 * torch.log(sigma_0_dash * sigma_0) + 0.5)
    sw_d = sigma_w.index_select(0, ag)
    fe = fe + torch.sum(-0.5 * sw_d * (mu_w * mu_w + sigma_w_dash)
                        + 0.5 * torch.log(sigma_w_dash * sw_d) + 0.5)
    sv_d = sigma_v.index_select(0, ag).T  # [K, D]
    fe = fe + torch.sum(-0.5 * sv_d * (mu_v * mu_v + sigma_v_dash)
                        + 0.5 * torch.log(sigma_v_dash * sv_d) + 0.5)

    new_state = VBState(
        mu_0=mu_0, sigma_0_dash=sigma_0_dash, mu_w=mu_w,
        sigma_w_dash=sigma_w_dash, mu_v=mu_v, sigma_v_dash=sigma_v_dash,
        alpha=alpha, sigma_0=sigma_0, sigma_w=sigma_w, sigma_v=sigma_v,
        e=e, t=t)
    return new_state, fe, nan_alpha


# ---------------------------------------------------------------------------
# The learner
# ---------------------------------------------------------------------------

# per-iteration scalar metrics, in the order they are packed on the device
_SCALARS = ("free_energy", "rmse", "mae", "train_rmse", "alpha", "nan_w",
            "nan_v", "nan_alpha")
# the same under classification (vb.py:1002-1014)
_SCALARS_CLASS = ("free_energy", "accuracy", "loglik", "alpha", "nan_w",
                  "nan_v", "nan_alpha")


class VBLearner:
    """Batch VBFM trainer on one device, or data-parallel over a data mesh
    of ranks (``mesh``: ``parallel/mesh.py:make_mesh``; every rank
    constructs the learner with the whole data and keeps its block of
    rows).  The learner runs where it is told (``device``, or the mesh's)
    and never moves itself."""

    method = "vb"
    mesh = None  # a data mesh of ranks (parallel/mesh.py:make_mesh)

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None, *,
                 device=None, bins: str = "auto", out_dir: str = ".",
                 write_files: bool = True,
                 num_eval_cases: Optional[int] = None,
                 plan: Optional[SweepPlan] = None, mesh=None):
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
        # -num_eval_cases: the eval over the first rows, rmse_test2_this
        # over the rest (vb.py:896-908), on the global row index
        first = 0 if mesh is None else mesh.d_index * self.test_rps
        self.test_row, self._rest_valid, self._eval_n = held_back(
            self.test_row, self.test_n, num_eval_cases, first)
        self.out_dir = out_dir
        self.write_files = write_files and self.lead

    # ---- what a data mesh changes ------------------------------------------

    @property
    def lead(self) -> bool:
        """Whether this rank prints and writes the files (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _total(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over the rank's rows, summed over the data shards."""
        return t if self.mesh is None else self.mesh.all_reduce_data(t)

    def _test_vector(self, t: torch.Tensor) -> np.ndarray:
        """A per-test-row device vector on the host, its real rows in
        global order (gathered over the data shards: every rank calls
        it)."""
        if self.mesh is not None:
            t = gather_rows(self.mesh, t, self.test_rps)
        return t.cpu().numpy()[: self.test_n]

    # ---- state ------------------------------------------------------------

    def state_from_params(self, params: Mapping[str, torch.Tensor]) -> VBState:
        """Full state from the ten parameter tensors: e = y - yhat and the
        T-terms of the train rows (kernel K1)."""
        cfg, row = self.cfg, self.train_row
        p = {k: params[k].to(self.device) for k in PARAM_FIELDS}
        yhat = fm_scores(p["mu_0"], p["mu_w"], p["mu_v"], row.ids, row.vals,
                         k0=cfg.k0, k1=cfg.k1)
        t = fm_t_terms(p["sigma_0_dash"], p["sigma_w_dash"], p["mu_v"],
                       p["sigma_v_dash"], row.ids, row.vals, k0=cfg.k0,
                       k1=cfg.k1)
        return VBState(e=row.target - yhat, t=t, **p)

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> VBState:
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return self.state_from_params(
            init_vb_params(generator, self.cfg, self.device))

    def predict_test_scores(self, state: VBState) -> np.ndarray:
        s = fm_scores(state.mu_0, state.mu_w, state.mu_v, self.test_row.ids,
                      self.test_row.vals, k0=self.cfg.k0, k1=self.cfg.k1)
        return self._test_vector(s)

    # ---- checkpoints: the global layout on a data mesh ----------------------

    def global_state(self, state: VBState) -> VBState:
        """The state on the host, e and t of the real rows in global order
        (gathered over the data shards: every rank calls it)."""
        rows = {k: gather_rows(self.mesh, getattr(state, k), self.rps)[
            : self.train_n] for k in ("e", "t")}
        return VBState(**{f.name: rows.get(f.name, getattr(state, f.name))
                          .cpu() for f in dataclasses.fields(VBState)})

    def local_state(self, g: VBState) -> VBState:
        """The rank's part of a ``global_state``, on its device."""
        out = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
        for k in ("e", "t"):
            out[k] = row_block(self.mesh, out[k], self.rps)
        return VBState(**{k: a.contiguous().to(self.device)
                          for k, a in out.items()})

    def _resume(self, ckpt, state: VBState):
        if self.mesh is None:
            return resume(self, ckpt, state)
        if ckpt is None:
            return state, 0
        restored = ckpt.restore_latest(self.global_state(state))
        if restored is None:
            return state, 0
        g, step, _meta = restored
        return self.local_state(g), step

    def _save(self, ckpt, state: VBState, done: int) -> None:
        meta = {"method": self.method}
        if self.mesh is None:
            ckpt.save(state, done, meta)
            return
        g = self.global_state(state)
        if self.lead:
            ckpt.save(g, done, meta)
        self.mesh.barrier()

    # ---- one iteration ----------------------------------------------------

    def step(self, state: VBState):
        """One sweep + the in-loop test eval.  Returns (state, packed
        metrics): a float32 device vector laid out as ``_SCALARS`` then
        sigma_w [G] then sigma_v [G*K]."""
        state, fe, nans = vb_update_all(state, self.train_row, self.plan_data,
                                        self.cfg, float(self.train_n),
                                        self.mesh)
        return state, self._eval(state, fe, nans)

    def _eval(self, state: VBState, fe, nans) -> torch.Tensor:
        """The JAX learner's _eval_and_resample (vb.py:976-1019): regression
        takes the test RMSE/MAE and the train RMSE of the clipped e (and,
        under -num_eval_cases, rmse_test2_this over the held-back rows,
        vb.py:990-1001); classification the test accuracy and
        log-likelihood (X12b, the held-back rows masked out), then the
        probit update of the train residual, in place on ``state.e``
        (X12a).  On a data mesh each sum over rows is all-reduced before
        the root and the division by the global count (vb.py:986-1009);
        X12b's outputs, already divided by it, are all-reduced."""
        cfg, trow = self.cfg, self.test_row
        scores = fm_scores(state.mu_0, state.mu_w, state.mu_v, trow.ids,
                           trow.vals, k0=cfg.k0, k1=cfg.k1)
        tail = []
        if cfg.task == TASK_REGRESSION:
            p = torch.clamp(scores, cfg.min_target, cfg.max_target)
            err = (p - trow.target) * trow.valid
            e_c = torch.clamp(state.e, cfg.min_target, cfg.max_target)
            sums = [torch.sum(err * err), torch.sum(torch.abs(err)),
                    torch.sum(e_c * e_c * self.train_row.valid)]
            if self._rest_valid is not None:
                e2 = (p - trow.target) * self._rest_valid
                sums.append(torch.sum(e2 * e2))
            s = self._total(torch.stack(sums))
            n = float(self._eval_n)
            head = [fe, torch.sqrt(s[0] / n), s[1] / n,
                    torch.sqrt(s[2] / float(self.train_n))]
            if self._rest_valid is not None:
                tail = [torch.sqrt(s[3] / float(self.test_n - self._eval_n))]
        else:
            m = self._total(probit_eval(scores, trow.target, trow.valid,
                                        self._eval_n))
            head = [fe, m[0], m[1]]
            probit_latent(state.e, self.train_row.target, None, PROBIT_VB)
        scalars = torch.stack(head + [
            state.alpha, nans["nan_w"].to(_F32), nans["nan_v"].to(_F32),
            nans["nan_alpha"].to(_F32)] + tail)
        return torch.cat([scalars, state.sigma_w.reshape(-1),
                          state.sigma_v.reshape(-1)])

    def _scalars(self) -> tuple:
        if self.cfg.task != TASK_REGRESSION:
            return _SCALARS_CLASS
        return _SCALARS + (("rmse_test2_this",)
                           if self._rest_valid is not None else ())

    def _unpack(self, m: np.ndarray) -> dict:
        G, K = self.cfg.num_groups, self.cfg.num_factor
        names = self._scalars()
        n = len(names)
        rec = {k: float(m[i]) for i, k in enumerate(names)}
        rec["sigma_w"] = m[n:n + G].copy()
        rec["sigma_v"] = m[n + G:n + G + G * K].reshape(G, K).copy()
        return rec

    # ---- training loop ----------------------------------------------------

    def run(self, state: Optional[VBState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            chunk: Optional[int] = None, ckpt=None, ckpt_every: int = 10):
        """Train for ``num_iter`` sweeps.  The per-iteration metrics stay on
        the device and are fetched once per chunk of ``chunk`` sweeps
        (default min(10, num_iter)); ``time_learn`` is the chunk's wall
        time per sweep, up to that fetch.  ``ckpt`` (a
        ``utils.checkpoint.CheckpointManager``) resumes from its latest
        checkpoint and saves one after a chunk once ``ckpt_every`` sweeps
        have passed since the last (counted from the resumed sweep) and
        after the last chunk (vb.py:1402-1408, :1498-1501); a resumed run
        leaves the trajectory files as they are.  Returns (state,
        history)."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        verbose = verbose and self.lead
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        chunk = chunk if chunk is not None else max(1, min(10, num_iter))
        state, done = self._resume(ckpt, state)
        on = self.write_files and done == 0
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method,
                                   self.out_dir, on)
        fe_file = TrajectoryFile("free_energy", cfg, self.method,
                                 self.out_dir, on)
        history = []
        last_saved = done
        while done < num_iter:
            n = min(chunk, num_iter - done)
            t0 = time.perf_counter()
            packed = []
            for _ in range(n):
                state, m = self.step(state)
                packed.append(m)
            t_fetch = time.perf_counter()
            metrics = torch.stack(packed).cpu().numpy()  # the one sync
            now = time.perf_counter()
            for j in range(n):
                rec = {"iter": done + j, "time_learn": (now - t0) / n,
                       "time_pred": (now - t_fetch) / n}
                if not self.plan.conflict_free:
                    rec["conflict_free"] = False  # Jacobi-bin approximation
                rec.update(self._unpack(metrics[j]))
                fe_file.append(-rec["free_energy"])
                if cfg.task != TASK_REGRESSION:
                    rmse_file.append(rec["accuracy"])
                    if verbose:
                        print(f"#Iter={rec['iter']:3d}\t"
                              f"Test={rec['accuracy']:.6g}"
                              f"\tTest(ll)={rec['loglik']:.6g}")
                else:
                    rmse_file.append(rec["rmse"])
                    if verbose:
                        print(f"#Iter={rec['iter']:3d}\t"
                              f"Train={rec['train_rmse']:.6g}"
                              f"\tTest={rec['rmse']:.6g}")
                if verbose:
                    nw, nv = int(rec["nan_w"]), int(rec["nan_v"])
                    if nw or nv or int(rec["nan_alpha"]):
                        print(f"#nans in w: {nw}\t#nans in v: {nv}\t"
                              f"#nans in alpha: {int(rec['nan_alpha'])}")
                stream_row(self, rec)
                history.append(rec)
            done += n
            if ckpt is not None and (done - last_saved >= ckpt_every
                                     or done >= num_iter):
                self._save(ckpt, state, done)
                last_saved = done
        return state, history
