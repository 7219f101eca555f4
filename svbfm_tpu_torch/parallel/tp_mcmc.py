"""Feature-sharded (tensor-parallel) Gibbs MCMC and ALS over a (data, feature)
mesh.

Counterpart of ``svbfm_tpu/parallel/tp_mcmc.py`` on ``torch.distributed``,
built as ``parallel/tp_vb.py`` is: each rank is one coordinate (d, f) of the
mesh (``parallel/mesh.py``), holds the feature shard f of w [D_loc] and v
[K, D_loc] (the columns [f D_loc, (f + 1) D_loc)) and the data shard d of
the rows with their residual e and q cache, and draws ONLY its own columns:

* conflict-free bins partition within each feature shard
  (``tp_vb._build_tp_plan``); a column's statistics are sums over the rows
  of every data shard, all-reduced over the DATA group between a kernel's
  stats launch and its draw launch (T5 after T3's w stats, T7's two
  launches);
* the row caches stay whole on every feature shard of a data shard: a
  bin's patch of e (T4 at F = 0 for w, T8 for v) and the block's q build
  (T6) are additive over columns, so each shard computes its columns'
  part against the pre-patch caches and ONE all-reduce over the FEATURE
  group applies the whole;
* hyperprior statistics are per-group sums of the local columns
  (``learners/base.py:group_sum`` over G + 1 segments, the padding
  columns' group G dropped) all-reduced over FEATURE, and alpha's and
  w0's residual sums are all-reduced over DATA; the gamma and normal
  draws then run replicated from the shared draw chain, so every rank
  holds the same hyperparameters;
* the z tables of the column draws come from ``Draws.column_normal``:
  each [F, D_loc] slice depends on the chain and the GLOBAL column alone,
  so the trajectory does not depend on the mesh and no rank holds an
  [F, D] table.

Semantics: the draw algebra and order of ``learners/mcmc.py`` as the JAX
package's feature-sharded sweep orders it (``tp_mcmc_draw_all``): the w
table of the sweep is drawn only under sampling, and so is each factor
block's, whose unobserved columns take their prior from the block's own
table; factor blocks of ``mcmc.factor_width`` factors (1 where an explicit
``factor_block`` does not divide K), exact sequential conditionals unless
``-factor_jacobi`` ALS; NaN/Inf draw counters are not tracked (zero, as in
JAX).  The learner subclasses ``learners/mcmc.py:MCMCLearner`` and keeps its
run loop (posterior-mean accumulators, RLog, trajectory files); checkpoints
hold the global layout without its padding (tables [D], rows [N]), so a
resume may change the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels.mcmc_sweep import (tp_col_draw,
                                                tp_col_draw_stats,
                                                tp_col_outputs,
                                                tp_mcmc_patch_delta,
                                                tp_mcmc_patch_views)
from svbfm_tpu_torch.kernels.vb_sweep import (tp_build_q, tp_patch_delta,
                                              tp_patch_views)
from svbfm_tpu_torch.kernels.w_sweep import tp_w_draw, tp_w_stats
from svbfm_tpu_torch.learners.base import (FMConfig, RowData, group_sum,
                                           row_block, zero_counters)
from svbfm_tpu_torch.learners.draws import Draws
from svbfm_tpu_torch.learners.mcmc import (NAN_FAMILIES, MCMCLearner,
                                           MCMCState, _maybe_sample,
                                           check_slice, draw_alpha, draw_w0,
                                           draw_v_hyperpriors,
                                           draw_w_hyperpriors, exact_draws,
                                           factor_width, repredicted,
                                           resample_class_targets)
from svbfm_tpu_torch.parallel.mesh import Mesh, make_mesh2d
from svbfm_tpu_torch.parallel.tp import sharded_scores
from svbfm_tpu_torch.parallel.tp_vb import (TPPlanData, _build_tp_plan,
                                            check_tp_memory_budget,
                                            gather_cols, gather_rows,
                                            local_plan, shard_cols,
                                            shard_rows)

_F32 = torch.float32
# the state's tables sharded over the feature group, and its rows over data
_TABLES = ("w", "v")
_ROWS = ("e",)


def block_width(cfg: FMConfig) -> int:
    """The v sweep's factor block (tp_mcmc.py:351-354): the port's
    ``factor_width``, or 1 where it does not divide K."""
    F = factor_width(cfg)
    return 1 if cfg.num_factor % F else F


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def tp_w_sweep(e, w, w_mu, w_lambda, alpha, plan: TPPlanData, row: RowData,
               cfg: FMConfig, draws: Draws, mesh: Mesh, D_loc: int,
               lo: int) -> None:
    """The binned w sweep + the unobserved columns' prior draws
    (tp_mcmc.py:158-210), in place on e and w [D_loc]: per bin T3's w stats,
    a data all-reduce, T5's draw, then the bin's e patch (T4 at F = 0 on
    the delta table (w_new - w_old, 0)) and a feature all-reduce."""
    dev = w.device
    G = w_mu.shape[0]
    N = e.shape[0]
    # one value a column a sweep (its bucket's, or the unobserved prior's)
    zw = draws.column_normal(1, lo, D_loc)[0] if cfg.do_sample else None
    dtab = torch.empty(D_loc, 2, dtype=_F32, device=dev)
    acc = torch.empty(D_loc, dtype=_F32, device=dev)
    bad = torch.zeros(4, dtype=torch.int32, device=dev)
    for bin_blocks in plan.blocks:
        dtab.zero_()
        acc.zero_()
        tp_w_stats(bin_blocks, e, acc, D_loc)
        mesh.all_reduce_data(acc)
        tp_w_draw(bin_blocks, acc, D_loc, w, w_mu, w_lambda, alpha, zw, dtab,
                  bad)
        _, de, _ = tp_patch_views(mesh.all_reduce_feature(tp_patch_delta(
            dtab, 0, True, row.ids, row.vals, None, lo, D_loc)), N, 0)
        e += de
    agc = plan.attr_group.clamp(max=G - 1)  # JAX's take_rows(mode="clip")
    new_un = _maybe_sample(cfg.do_sample, zw, w_mu.index_select(0, agc),
                           1.0 / w_lambda.index_select(0, agc), w)
    w.copy_(torch.where(plan.unobserved, new_un, w))


def tp_v_block_pass(e, v_t, mu_gf, lam_gf, plan: TPPlanData, row: RowData,
                    cfg: FMConfig, alpha, exact: bool, draws: Draws,
                    mesh: Mesh, D_loc: int, lo: int) -> torch.Tensor:
    """One factor block's bin sweep (tp_mcmc.py:213-310), in place on e;
    ``v_t`` [D_loc, F] is drawn in place and returned with its unobserved
    columns drawn from their prior; ``mu_gf``/``lam_gf`` [G, F] are the
    block's group priors.  q [N, F] is T6's partials, all-reduced over
    FEATURE, once a block; per bucket T7's stats, a data all-reduce, T7's
    draw; per bin T8's patch, a feature all-reduce, then q -= dq and
    e -= de."""
    F = v_t.shape[1]
    dev = v_t.device
    N = e.shape[0]
    G = mu_gf.shape[0]
    # one [F, D_loc] table a block, drawn only under sampling
    z = draws.column_normal(F, lo, D_loc) if cfg.do_sample else None
    ptab = torch.empty(D_loc, 2 * F, dtype=_F32, device=dev)
    nans = torch.zeros(2, dtype=torch.int32, device=dev)
    q = None
    for bin_blocks in plan.blocks:
        ptab[:, :F] = v_t
        ptab[:, F:].zero_()
        if q is None:
            q = mesh.all_reduce_feature(
                tp_build_q(ptab, F, row.ids, row.vals, lo, D_loc))
        for blk in bin_blocks:
            acc = mesh.all_reduce_data(tp_col_draw_stats(
                blk.rows, blk.x, blk.cols, D_loc, e, q, ptab, F, exact))
            tp_col_draw(acc, blk.cols, blk.group, D_loc, ptab, v_t, mu_gf,
                        lam_gf, alpha, z, exact, nans)
        dq, de = tp_mcmc_patch_views(mesh.all_reduce_feature(
            tp_mcmc_patch_delta(ptab, F, row.ids, row.vals, q, lo, D_loc)),
            N, F)
        q -= dq
        e -= de
    agc = plan.attr_group.clamp(max=G - 1)
    new_un = _maybe_sample(cfg.do_sample, None if z is None else z.T,
                           mu_gf.index_select(0, agc),
                           1.0 / lam_gf.index_select(0, agc), v_t)
    return torch.where(plan.unobserved[:, None], new_un, v_t)


def tp_mcmc_draw_all(state: MCMCState, row: RowData, plan: TPPlanData,
                     cfg: FMConfig, num_cases: float, mesh: Mesh, D_loc: int,
                     lo: int):
    """One Gibbs (or ALS) sweep + the full re-predict of the train residual
    on one rank (tp_mcmc.py:313-378).  Returns (new_state, counters), the
    counters all zero; ``state``'s tensors are not modified (its draw
    source advances)."""
    check_slice(cfg)
    dev = state.e.device
    G, K = cfg.num_groups, cfg.num_factor
    N = torch.full((), num_cases, dtype=_F32, device=dev)
    draws = state.draws
    e = state.e.clone()
    uncounted = zero_counters(NAN_FAMILIES, dev)
    ag = plan.attr_group
    agc = ag.clamp(max=G - 1)
    napg = plan.num_attr_per_group

    def gsum(x):  # the shard's columns' group sums, padding dropped
        return mesh.all_reduce_feature(group_sum(x, ag, G + 1)[:G])

    alpha = draw_alpha(e, row.valid, state.alpha, cfg, N, draws, uncounted,
                       total=mesh.all_reduce_data)
    w0 = state.w0
    if cfg.k0:
        e, w0 = draw_w0(e, row.valid, w0, cfg, alpha, N, draws, uncounted,
                        total=mesh.all_reduce_data)
    w, v = state.w.clone(), state.v.clone()
    w_mu, w_lambda = state.w_mu, state.w_lambda
    v_mu, v_lambda = state.v_mu, state.v_lambda
    if cfg.k1:
        w_mu, w_lambda = draw_w_hyperpriors(w, w_mu, w_lambda, agc, napg, cfg,
                                            G, draws, uncounted, gsum=gsum)
        tp_w_sweep(e, w, w_mu, w_lambda, alpha, plan, row, cfg, draws, mesh,
                   D_loc, lo)
    if K > 0:
        v_mu, v_lambda = draw_v_hyperpriors(v, v_mu, v_lambda, agc, napg, cfg,
                                            G, K, draws, uncounted, gsum=gsum)
        F = block_width(cfg)
        exact = exact_draws(cfg)
        for f0 in range(0, K, F):
            fs = slice(f0, f0 + F)
            v[fs] = tp_v_block_pass(
                e, v[fs].T.contiguous(), v_mu[:, fs].contiguous(),
                v_lambda[:, fs].contiguous(), plan, row, cfg, alpha, exact,
                draws, mesh, D_loc, lo).T
    # full re-predict (T1's partials, a feature all-reduce)
    e = repredicted(sharded_scores(mesh.all_reduce_feature, w0, w, v,
                                   row.ids, row.vals, lo, D_loc, cfg.k0,
                                   cfg.k1), row, cfg)
    new_state = MCMCState(w0=w0, w=w, v=v, alpha=alpha, w_mu=w_mu,
                          w_lambda=w_lambda, v_mu=v_mu, v_lambda=v_lambda,
                          e=e, draws=draws)
    return new_state, zero_counters(NAN_FAMILIES, dev)


def tp_mcmc_buffer_bytes(plan_data: TPPlanData, n_loc: int, K: int, F: int,
                         D_loc: int, exact: bool) -> dict:
    """The buffers kernels T1 and T5-T8 allocate on a rank, in bytes: the
    block's q cache [N, F] and its patch (N (F + 1) floats), T1's partials
    of the train rows [N, 1 + 2K], the patch table [D_loc, 2F] and the
    largest bucket's column sums."""
    acc = max((b.cols.shape[0] * tp_col_outputs(F, exact)
               for bb in plan_data.blocks for b in bb), default=0)
    return {"q cache": n_loc * F * 4, "bin patch": n_loc * (F + 1) * 4,
            "T1 partials": n_loc * (1 + 2 * K) * 4,
            "patch table": D_loc * 2 * F * 4, "column sums": acc * 4}


# ---------------------------------------------------------------------------
# The learners
# ---------------------------------------------------------------------------

class TPMCMCLearner(MCMCLearner):
    """Gibbs MCMC with feature-sharded tables over a (data, feature) mesh of
    ranks; each rank constructs it with the whole data and keeps its part.
    ``mesh`` None: a data-parallel mesh of every rank on ``device`` (one
    rank: the mesh (1, 1)).  Regression and probit classification."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh: Optional[Mesh] = None, *, device="cuda",
                 bins: str = "auto", out_dir: str = ".",
                 write_files: bool = False,
                 w_lambda_init: Optional[np.ndarray] = None,
                 v_lambda_init: Optional[np.ndarray] = None):
        check_slice(cfg)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh2d(device=device)
        self.device = self.mesh.device
        Sd, Sf = self.mesh.shape
        d, f = self.mesh.d_index, self.mesh.f_index
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        if meta.num_attributes != cfg.num_attributes:
            raise ValueError("meta and cfg disagree on num_attributes")
        self.meta = meta
        D, G, K = cfg.num_attributes, cfg.num_groups, cfg.num_factor
        self.plan = SweepPlan.build(train.to_coo(), D,
                                    meta_groups=meta.attr_group, bins=bins,
                                    n_shards=Sd)
        plan_np, self.D_loc = _build_tp_plan((Sd, Sf), self.plan, meta, D)
        self.D_pad = self.D_loc * Sf
        self.lo = f * self.D_loc
        self.plan_data = local_plan(plan_np, d, f, self.device)
        self.train_row, self.rps = shard_rows(train, Sd, d, self.device)
        self.train_n = train.num_rows
        self.test_row, self.test_rps = shard_rows(test, Sd, d, self.device)
        self.test_n = test.num_rows
        self._rest_valid, self._eval_n = None, test.num_rows
        F = block_width(cfg) if K else 0
        check_tp_memory_budget(
            self.plan_data, self.rps, K, self.D_loc, type(self).__name__,
            self.device, tp_mcmc_buffer_bytes(self.plan_data, self.rps, K, F,
                                              self.D_loc, exact_draws(cfg)))
        self.out_dir = out_dir
        self.write_files = write_files and self.lead
        self.w_lambda_init = (np.full(G, cfg.regw, np.float32)
                              if w_lambda_init is None else w_lambda_init)
        self.v_lambda_init = (np.full((G, K), cfg.regv, np.float32)
                              if v_lambda_init is None else v_lambda_init)
        self._pred_sum_all = None
        self._pred_iters = 0

    @property
    def lead(self) -> bool:
        return self.mesh.rank == 0

    # ---- state ------------------------------------------------------------

    def _shard_of(self, a: torch.Tensor) -> torch.Tensor:
        return shard_cols(a, self.lo, self.D_loc, self.D_pad)

    def state_from_params(self, w0, w, v, draws: Draws) -> MCMCState:
        """The sampler's start from w0 and the whole tables w [D], v [K, D]:
        the rank's feature shard of them, e = yhat - y of its train rows
        (T1, the partials all-reduced over the feature group), alpha = 1,
        zero prior means, the -regular lambdas."""
        cfg, row, dev = self.cfg, self.train_row, self.device
        w0 = w0.to(dev, _F32)
        w, v = (self._shard_of(a.to(dev, _F32)) for a in (w, v))
        e = sharded_scores(self.mesh.all_reduce_feature, w0, w, v, row.ids,
                           row.vals, self.lo, self.D_loc, cfg.k0,
                           cfg.k1) - row.target
        G, K = cfg.num_groups, cfg.num_factor
        return MCMCState(
            w0=w0, w=w, v=v, alpha=torch.ones((), dtype=_F32, device=dev),
            w_mu=torch.zeros(G, dtype=_F32, device=dev),
            w_lambda=torch.as_tensor(self.w_lambda_init, dtype=_F32).to(dev),
            v_mu=torch.zeros(G, K, dtype=_F32, device=dev),
            v_lambda=torch.as_tensor(self.v_lambda_init, dtype=_F32).to(dev),
            e=e, draws=draws)

    def _test_scores(self, state: MCMCState) -> torch.Tensor:
        cfg = self.cfg
        return sharded_scores(self.mesh.all_reduce_feature, state.w0,
                              state.w, state.v, self.test_row.ids,
                              self.test_row.vals, self.lo, self.D_loc,
                              cfg.k0, cfg.k1)

    def _test_vector(self, t: torch.Tensor) -> np.ndarray:
        return gather_rows(self.mesh, t, self.test_rps).cpu().numpy()[
            : self.test_n]

    def _total(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce_data(t)

    def step(self, state: MCMCState):
        return tp_mcmc_draw_all(state, self.train_row, self.plan_data,
                                self.cfg, float(self.train_n), self.mesh,
                                self.D_loc, self.lo)

    def _resample(self, state: MCMCState) -> None:
        """The latent update of the rank's train rows, the uniforms of its
        data shard (mcmc.py:1081's fold-in of the shard's index)."""
        resample_class_targets(state, self.train_row, self.cfg,
                               self.mesh.d_index, self.mesh.n_data)

    # ---- checkpoints: the global layout -----------------------------------

    def global_state(self, state: MCMCState) -> MCMCState:
        """The whole state on the host in the JAX package's global layout
        (w [D_pad], v [K, D_pad], e [N_pad]); every rank must call it."""
        out = {}
        for f in dataclasses.fields(MCMCState):
            a = getattr(state, f.name)
            if f.name in _TABLES:
                a = gather_cols(self.mesh, a, self.lo, self.D_pad).cpu()
            elif f.name in _ROWS:
                a = gather_rows(self.mesh, a, self.rps).cpu()
            elif f.name != "draws":
                a = a.cpu()
            out[f.name] = a
        return MCMCState(**out)

    def _ckpt_blob(self, blob: dict) -> dict:
        """The run's blob as a checkpoint holds it: the global layout cut
        to the real columns and rows (tables [D], e [N], the accumulators
        [N_test]), so that a mesh of another padding resumes it."""
        D = self.cfg.num_attributes
        g = self.global_state(blob["state"])
        cut = {"w": g.w[:D], "v": g.v[:, :D], "e": g.e[: self.train_n]}
        return {"state": dataclasses.replace(g, **cut),
                **{k: gather_rows(self.mesh, blob[k], self.test_rps).cpu()[
                    : self.test_n] for k in ("psum_all", "psum_but5")}}

    def _resume(self, ckpt, blob: dict):
        if ckpt is None:
            return blob, 0
        restored = ckpt.restore_latest(self._ckpt_blob(blob))
        if restored is None:
            return blob, 0
        g, step, _meta = restored

        def rows(a, rps):  # the rank's block of rows, zero-padded
            return row_block(self.mesh, a, rps).to(self.device)

        st = g["state"]
        local = {f.name: torch.as_tensor(getattr(st, f.name), dtype=_F32).to(
            self.device) for f in dataclasses.fields(MCMCState)
            if f.name != "draws"}
        local.update(w=self._shard_of(local["w"]), v=self._shard_of(local["v"]),
                     e=rows(st.e, self.rps))
        return {"state": MCMCState(**local, draws=st.draws),
                **{k: rows(g[k], self.test_rps)
                   for k in ("psum_all", "psum_but5")}}, step

    def _save(self, ckpt, blob: dict, done: int) -> None:
        g = self._ckpt_blob(blob)
        if self.lead:
            ckpt.save(g, done, {"method": self.method})
        self.mesh.barrier()


class TPALSLearner(TPMCMCLearner):
    """Feature-sharded ALS = MCMC with do_sample=False, do_multilevel=False
    (libfm.cpp:131-135); the trajectory files keep the '_mcmc' suffix."""

    method = "mcmc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        cfg = dataclasses.replace(cfg, do_sample=False, do_multilevel=False)
        super().__init__(cfg, *args, **kwargs)
