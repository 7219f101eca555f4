"""Feature-sharded (tensor-parallel) online VBFM over a (data, feature) mesh.

Counterpart of ``svbfm_tpu/parallel/tp_ovb.py`` on ``torch.distributed``,
built as ``parallel/tp_vb.py`` is.  Online VB is the learner whose D is
largest by construction (the paper's KDD run: D = 1.63M): its primal and
natural tables [D] / [K, D] and the Robbins-Monro counters t_wj, t_vj [D]
are what outgrow one device.  Each rank is one coordinate (d, f) of the
mesh (``parallel/mesh.py``): it holds the feature shard f of all ten tables
(the columns [f D_loc, (f + 1) D_loc), zero past D) and the data shard d of
every chunk's rows, and updates ONLY its own columns:

* a chunk's per-column statistics are shard-local row sums, all-reduced
  over the DATA group between a kernel's stats launch and its blend launch
  (T10 for w, T9 for v: ONE all-reduce a bin, its buckets being
  column-disjoint); the blend, the primal recovery and the counters are
  per column;
* the chunk's row caches e, t and the factor's q/tq/tz stay whole on every
  feature shard of a data shard: their bin patches are additive over
  columns, so each shard computes its columns' part against the pre-patch
  caches (T4) and ONE all-reduce over the FEATURE group applies the whole,
  as the chunk's forward (T1) and the factor's q/tq/tz build (T2) do;
* hyperparameter statistics are per-group sums of the local columns
  (``learners/base.py:group_sum`` over G + 1 segments, the padding
  columns' group G dropped) all-reduced over FEATURE; alpha's residual sum
  over DATA.

Semantics: the in-memory ``learners/vb_online.py:OVBLearner`` with fixed
chunk membership, regression, the v sweep factor-sequential (``factor_block``
0 becomes 1), whose ``run`` loop the learner keeps; the trajectory does not
depend on the mesh.  Each chunk is padded to a multiple of the data shards
(valid 0 on the padding rows) and runs its own sweep plan, built once at
construction (the JAX learner's common padded shape over chunks is a TPU
workaround: one compiled program).  Update equations:
``fm_learn_vb_online.h:354-468`` (chunk update), ``:471-627`` (w0/w/v),
``:629-663`` (chunk free energy, 2*3.14 kept).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels.ovb_sweep import (BinPlan, tp_ovb_blend,
                                               tp_ovb_stats)
from svbfm_tpu_torch.kernels.vb_sweep import (tp_build_qt, tp_patch_delta,
                                              tp_patch_views)
from svbfm_tpu_torch.kernels.w_sweep import tp_w_ovb_blend, tp_w_ovb_stats
from svbfm_tpu_torch.learners.base import (TASK_REGRESSION, FMConfig,
                                           RowData, zero_counters)
from svbfm_tpu_torch.learners.vb_online import (LAMBDA, OVB_NAN_FAMILIES,
                                                T0_VJ, T0_W0, T0_WJ,
                                                OVBLearner, OVBState,
                                                _add_family, check_slice,
                                                init_ovb_state,
                                                ovb_chunk_tail, ovb_w0_step)
from svbfm_tpu_torch.parallel.mesh import Mesh, make_mesh2d
from svbfm_tpu_torch.parallel.tp import sharded_scores, sharded_t_terms
from svbfm_tpu_torch.parallel.tp_vb import (TPPlanData, _build_tp_plan,
                                            check_tp_memory_budget,
                                            gather_cols, gather_rows,
                                            local_plan, shard_cols,
                                            shard_rows)

_F32, _I32 = torch.float32, torch.int32
# the state's tables sharded over the feature group
SHARDED_TABLES = ("mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash", "n_mu_w",
           "n_sig_w", "n_mu_v", "n_sig_v", "t_wj", "t_vj")


@dataclass
class TPOVBChunk:
    """One chunk on a rank: its rows of the data shard and its plan's
    buckets of the feature shard (``tp_vb.TPBlock``, local column ids, the
    padding column D_loc), with T9's plan table of each bin."""

    row: RowData  # valid 0 on the padding rows
    blocks: tuple  # tuple[tuple[TPBlock, ...], ...]: bins -> buckets
    bins: tuple  # tuple[BinPlan, ...]: T9's plan a bin


# ---------------------------------------------------------------------------
# One chunk
# ---------------------------------------------------------------------------

def tp_ovb_chunk_update(state: OVBState, row: RowData, chunk: TPOVBChunk,
                        cfg: FMConfig, n_full: float, n_chunk: float,
                        cols: TPPlanData, mesh: Mesh, D_loc: int,
                        lo: int):
    """Process one chunk with feature-sharded tables on one rank, the JAX
    package's ``tp_ovb_chunk_update`` (tp_ovb.py:149-432); ``cols`` gives
    the rank's columns' groups (padding: G), which are real and the
    groups' sizes (a chunk plan's ``local_plan``: every chunk's are the
    same).  Returns ``(new_state, fe, nans)`` with device scalars;
    ``state`` is not modified."""
    dev = row.ids.device
    counters = zero_counters(OVB_NAN_FAMILIES, dev)
    K = cfg.num_factor
    Nf, Nc = float(n_full), float(n_chunk)
    alpha = state.alpha
    rho0 = (T0_W0 + state.t_w0) ** (-LAMBDA)
    # a padding row (valid 0) has ids 0 and x = 0: the chunk's e and t and
    # the w0 patch are masked, and T2's and T4's sums over its positions
    # are zero, so the JAX function's "* valid" after them is not repeated
    ids, vals, valid = row.ids, row.vals, row.valid
    N = ids.shape[0]
    feat, data = mesh.all_reduce_feature, mesh.all_reduce_data

    # chunk e / T caches from the current primal parameters: T1's partials,
    # a feature all-reduce, then the finalize (the square after the sum)
    e = (row.target - sharded_scores(
        feat, state.mu_0, state.mu_w, state.mu_v, ids, vals, lo, D_loc,
        cfg.k0, cfg.k1)) * valid
    t = sharded_t_terms(feat, state.sigma_0_dash, state.sigma_w_dash,
                        state.mu_v, state.sigma_v_dash, ids, vals, lo, D_loc,
                        cfg.k0, cfg.k1) * valid

    # --- w0 (fm_learn_vb_online.h:471-497): Σ e over the data shards ---
    e, t, w0 = ovb_w0_step(state, e, t, valid, cfg, Nf, Nc, rho0, counters,
                           total=data)

    # --- w sweep (fm_learn_vb_online.h:499-557): per bin T10's stats, a
    # data all-reduce, T10's blend, T4 at F = 0, a feature all-reduce ---
    mu_w, sig_w = state.mu_w.clone(), state.sigma_w_dash.clone()
    n_mu_w, n_sig_w = state.n_mu_w.clone(), state.n_sig_w.clone()
    t_wj = state.t_wj.clone()
    bad = torch.zeros(8, dtype=_I32, device=dev)  # w's [4], then v's [4]
    if cfg.k1:
        # a column sits in one bucket of one bin: its rate is the one from
        # before the chunk
        ovb_w = (n_mu_w, n_sig_w, (T0_WJ + state.t_wj) ** (-LAMBDA), t_wj)
        dtab = torch.empty(D_loc, 2, dtype=_F32, device=dev)
        acc = torch.empty(D_loc, dtype=_F32, device=dev)
        for bin_blocks in chunk.blocks:
            dtab.zero_()
            acc.zero_()
            tp_w_ovb_stats(bin_blocks, e, mu_w, acc, D_loc)
            data(acc)
            tp_w_ovb_blend(bin_blocks, acc, D_loc, mu_w, sig_w,
                           state.sigma_w, alpha, dtab, bad[:4], ovb_w)
            _, de, dt = tp_patch_views(feat(tp_patch_delta(
                dtab, 0, True, ids, vals, None, lo, D_loc)), N, 0)
            e += de
            t += dt

    # --- v sweep, factor-sequential (fm_learn_vb_online.h:560-627): per
    # factor T2 + a feature all-reduce; per bin T9's stats, a data
    # all-reduce, T9's blend, T4 at F = 1, a feature all-reduce ---
    mu_v, sig_v = state.mu_v.clone(), state.sigma_v_dash.clone()
    n_mu_v, n_sig_v = state.n_mu_v.clone(), state.n_sig_v.clone()
    t_vj = state.t_vj
    if K > 0:
        rho_v = (T0_VJ + state.t_vj) ** (-LAMBDA)  # once per chunk
        tv_add = torch.zeros(D_loc, dtype=_F32, device=dev)
        ptab = torch.empty(D_loc, 5, dtype=_F32, device=dev)
        for f in range(K):
            tabs = [a[f:f + 1].T.contiguous()
                    for a in (mu_v, sig_v, n_mu_v, n_sig_v)]
            sv = state.sigma_v[:, f:f + 1].contiguous()
            qt = None
            for bin_blocks, plan in zip(chunk.blocks, chunk.bins):
                # the PRE-BIN mu/sig that the stats and the patch read, and
                # zeroed deltas
                ptab[:, :1] = tabs[0]
                ptab[:, 1:2] = tabs[1]
                ptab[:, 2:].zero_()
                if qt is None:
                    qt = feat(tp_build_qt(ptab, 1, ids, vals, lo, D_loc))
                sums = data(tp_ovb_stats(plan, D_loc, e, qt, ptab))
                # t_vj counts a chunk once: its first factor's pass
                tp_ovb_blend(plan, D_loc, sums, ptab, *tabs, sv, alpha, rho_v,
                             tv_add if f == 0 else None, bad[4:])
                dqt, de, dt = tp_patch_views(feat(tp_patch_delta(
                    ptab, 1, False, ids, vals, qt, lo, D_loc)), N, 1)
                qt += dqt
                e += de
                t += dt
            for a, b in zip((mu_v, sig_v, n_mu_v, n_sig_v), tabs):
                a[f] = b[:, 0]
        t_vj = t_vj + tv_add
    bad = feat(bad)  # the w_dash and v_dash families: every shard's columns
    _add_family(counters, "w", bad[:4])
    _add_family(counters, "v", bad[4:])

    # --- hyperparameter smoothing and the chunk free energy: the group
    # sums (the padding's group G dropped) and the column sums of the free
    # energy all-reduced over FEATURE, alpha's residual sum over DATA ---
    return ovb_chunk_tail(
        state, dict(w0, mu_w=mu_w, sigma_w_dash=sig_w, mu_v=mu_v,
                    sigma_v_dash=sig_v, n_mu_w=n_mu_w, n_sig_w=n_sig_w,
                    n_mu_v=n_mu_v, n_sig_v=n_sig_v, t_wj=t_wj, t_vj=t_vj),
        e, t, cfg, Nc, rho0, counters, cols.attr_group,
        cols.num_attr_per_group, total=data, feat=feat,
        col_valid=cols.col_valid)


def tp_ovb_buffer_bytes(chunks, n_loc: int, K: int, D_loc: int) -> dict:
    """The buffers kernels T1, T2, T4, T9 and T10 allocate on a rank, in
    bytes: the factor's row caches qt [N, 3], a bin's patch (N 5 floats),
    T1's partials of a chunk's rows [N, 1 + 3K] (the T-terms'), the patch
    table [D_loc, 5] and the largest bin's sums [C_bin, 2]."""
    sums = max((p.num_cols for c in chunks for p in c.bins), default=0)
    return {"row caches qt": n_loc * 3 * 4, "bin patch": n_loc * 5 * 4,
            "T1 partials": n_loc * (1 + 3 * K) * 4,
            "patch table": D_loc * 5 * 4, "bin sums": sums * 2 * 4}


# ---------------------------------------------------------------------------
# The learner
# ---------------------------------------------------------------------------

class TPOVBLearner(OVBLearner):
    """Online VBFM with feature-sharded tables over a (data, feature) mesh
    of ranks; each rank constructs it with the whole data and keeps its
    part.  Numerics: :class:`svbfm_tpu_torch.learners.vb_online.OVBLearner`
    in memory, fixed membership, regression, factor-sequential; ``run`` is
    its loop (rank 0 writes the files and prints).  ``mesh`` None: a
    data-parallel mesh of every rank on ``device`` (one rank: the mesh
    (1, 1))."""

    method = "vb_online"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh: Optional[Mesh] = None, *, device="cuda",
                 bins: str = "auto", out_dir: str = ".",
                 write_files: bool = False):
        check_slice(cfg)
        if cfg.factor_block == 0:  # factor-sequential, as OVBLearner
            cfg = dataclasses.replace(cfg, factor_block=1)
        if cfg.factor_block != 1:
            raise ValueError("the feature-sharded OVB runs the (stable) "
                             "factor-sequential sweep alone (factor_block "
                             "0 or 1)")
        if cfg.task != TASK_REGRESSION:
            raise ValueError("the feature-sharded OVB runs regression alone "
                             "(task=0); use the resident OVBLearner for "
                             "classification")
        if cfg.reshuffle:
            raise ValueError("the feature-sharded OVB keeps its chunk "
                             "membership fixed (reshuffle is not read)")
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh2d(device=device)
        self.device = self.mesh.device
        Sd, Sf = self.mesh.shape
        d, f = self.mesh.d_index, self.mesh.f_index
        meta = meta if meta is not None else DataMetaInfo(cfg.num_attributes)
        if meta.num_attributes != cfg.num_attributes:
            raise ValueError("meta and cfg disagree on num_attributes")
        self.meta = meta
        D = cfg.num_attributes
        self.D_loc = -(-D // Sf)
        self.D_pad = self.D_loc * Sf
        self.lo = f * self.D_loc
        self.train_n = train.num_rows
        self.col_count = train.col_count()
        self.num_chunks = max(1, min(cfg.num_batches, train.num_rows))
        # the JAX learner's numpy streams: membership from seed, the epoch
        # order from seed + 1 (OVBLearner.run draws it)
        self.member_perm = np.random.default_rng(cfg.seed).permutation(
            train.num_rows)
        self.rng = np.random.default_rng(cfg.seed + 1)
        self.chunks, sizes = [], []
        for rows_idx in np.array_split(self.member_perm, self.num_chunks):
            sub = SparseDataset(
                ids=train.ids[rows_idx], vals=train.vals[rows_idx],
                target=train.target[rows_idx], num_rows=len(rows_idx),
                num_features=D, min_target=train.min_target,
                max_target=train.max_target, row_nnz=train.row_nnz[rows_idx])
            row, rps = shard_rows(sub, Sd, d, self.device)
            plan = SweepPlan.build(sub.to_coo(), D,
                                   meta_groups=meta.attr_group, bins=bins,
                                   n_shards=Sd, col_count=self.col_count,
                                   n_rows_total=rps * Sd)
            # the rank's part; its column arrays are every chunk's
            self.columns = local_plan(_build_tp_plan(
                (Sd, Sf), plan, meta, D)[0], d, f, self.device)
            blocks = self.columns.blocks
            self.chunks.append(TPOVBChunk(
                row=row, blocks=blocks,
                bins=tuple(BinPlan(bb) for bb in blocks)))
            sizes.append(len(rows_idx))
        self.chunk_sizes = np.array(sizes, np.int64)
        self.test_row, self.test_rps = shard_rows(test, Sd, d, self.device)
        self.test_n = test.num_rows
        n_loc = max(c.row.ids.shape[0] for c in self.chunks)
        check_tp_memory_budget(
            None, n_loc, cfg.num_factor, self.D_loc, type(self).__name__,
            self.device, tp_ovb_buffer_bytes(self.chunks, n_loc,
                                             cfg.num_factor, self.D_loc))
        self.out_dir = out_dir
        self.write_files = write_files and self.lead

    @property
    def lead(self) -> bool:
        """Whether this rank writes the files and prints (rank 0)."""
        return self.mesh.rank == 0

    # ---- state ------------------------------------------------------------

    def local_state(self, g: OVBState) -> OVBState:
        """The rank's part of a state whose tables are whole ([D], or the
        JAX package's [D_pad]): their feature shard, zero past D, on the
        rank's device."""
        out = {}
        for fl in dataclasses.fields(OVBState):
            a = torch.as_tensor(getattr(g, fl.name), dtype=_F32)
            if fl.name in SHARDED_TABLES:
                a = shard_cols(a, self.lo, self.D_loc, self.D_pad)
            out[fl.name] = a.contiguous().to(self.device)
        return OVBState(**out)

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> OVBState:
        """The resident learner's init (``init_ovb_state`` from the
        generator of ``cfg.seed``) on every rank, this rank's shard kept:
        the trajectory does not depend on the mesh."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return self.local_state(init_ovb_state(generator, self.cfg, "cpu"))

    def global_state(self, state: OVBState) -> OVBState:
        """The whole state on the host, tables [D_pad] / [K, D_pad]
        gathered by an all-reduce over every rank; every rank must call
        it."""
        return OVBState(**{
            fl.name: (gather_cols(self.mesh, getattr(state, fl.name),
                                  self.lo, self.D_pad)
                      if fl.name in SHARDED_TABLES
                      else getattr(state, fl.name)).cpu()
            for fl in dataclasses.fields(OVBState)})

    def _scores(self, state: OVBState, row: RowData) -> torch.Tensor:
        cfg = self.cfg
        return sharded_scores(self.mesh.all_reduce_feature, state.mu_0,
                              state.mu_w, state.mu_v, row.ids, row.vals,
                              self.lo, self.D_loc, cfg.k0, cfg.k1)

    def predict_test_scores(self, state: OVBState) -> np.ndarray:
        """The scores of every test row (the data shards' gathered by an
        all-reduce); every rank must call it."""
        s = self._scores(state, self.test_row)
        return gather_rows(self.mesh, s, self.test_rps).cpu().numpy()[
            : self.test_n]

    # ---- OVBLearner.epoch's hooks -----------------------------------------

    def _chunks_in(self, order):
        for ci in order:
            c = self.chunks[ci]
            yield c.row, c, ci

    def _chunk_update(self, state: OVBState, row: RowData,
                      chunk: TPOVBChunk, ci: int):
        return tp_ovb_chunk_update(
            state, row, chunk, self.cfg, float(self.train_n),
            float(self.chunk_sizes[ci]), self.columns, self.mesh, self.D_loc,
            self.lo)

    def _test_metrics(self, state: OVBState):
        """Clamped RMSE and MAE of the test rows, the data shards' sums
        all-reduced (tp_ovb.py:612-620)."""
        cfg, trow = self.cfg, self.test_row
        p = torch.clamp(self._scores(state, trow), cfg.min_target,
                        cfg.max_target)
        err = (p - trow.target) * trow.valid
        tot = self.mesh.all_reduce_data(torch.stack(
            [torch.sum(err * err), torch.sum(torch.abs(err))]))
        n = float(self.test_n)
        return torch.sqrt(tot[0] / n), tot[1] / n

    # ---- training loop ----------------------------------------------------

    def run(self, state: Optional[OVBState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            ckpt=None, ckpt_every: int = 10):
        """``OVBLearner.run`` on every rank (two free-energy entries an
        epoch, the RLog row); rank 0 prints and writes the files.  Takes
        no checkpoint: the JAX learner accepts one and never reads it."""
        if ckpt is not None:
            raise ValueError("the feature-sharded OVB does not checkpoint")
        return super().run(state, num_iter, verbose and self.lead)
