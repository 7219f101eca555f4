"""Feature-sharded (tensor-parallel) batch VBFM over a (data, feature) mesh.

Counterpart of ``svbfm_tpu/parallel/tp_vb.py`` on ``torch.distributed``.
Each rank is one coordinate (d, f) of the mesh (``parallel/mesh.py``): it
holds the feature shard f of the variational tables, the columns
[f D_loc, (f + 1) D_loc), and the data shard d of the rows with their
residual caches e, t and q/tq/tz.  It updates ONLY its own columns:

* conflict-free bins partition within each feature shard: a column's
  entries live with its owner shard, stacked [Sf, Sd, C, L] by
  ``_build_tp_plan`` (host numpy, the JAX package's);
* per-column statistics are shard-local row sums, all-reduced over the
  DATA group between kernel T3's stats launch and its update launch (the
  column lives on one feature shard);
* the row caches stay whole on every feature shard of a data shard: their
  bin patches are additive over columns, so each shard computes its
  columns' contribution against the pre-patch caches (T4) and ONE
  all-reduce of N (3K + 2) floats over the FEATURE group a bin applies
  the whole patch everywhere, as the q/tq/tz build does once a sweep (T2)
  and the forward's partials do (T1, ``parallel/tp.py``);
* hyperparameter statistics are per-group sums of the local columns
  (``learners/base.py:group_sum`` over G + 1 segments, the padding
  columns' group G dropped) all-reduced over FEATURE; alpha's residual
  sum over DATA.

Semantics: the single-device fast mode of ``learners/vb.py``
(``factor_block=0``: all K factors Jacobi within a bin, bins sequential,
the linear terms riding the same passes; at K = 0 the standalone w sweep),
regression; the trajectory does not depend on the mesh.  Reference parity
anchors: update equations ``fm_learn_vb.h:383-644``, hyperparameters
``:446-498``, free energy ``:646-681`` (2*3.14 kept).
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
from svbfm_tpu_torch.kernels.vb_sweep import tp_patch_delta, tp_patch_views
from svbfm_tpu_torch.kernels.w_sweep import tp_w_stats, tp_w_update
from svbfm_tpu_torch.learners.base import (TASK_REGRESSION, FMConfig,
                                           RowData, TrajectoryFile,
                                           gather_rows, group_sum,
                                           keep_finite, nonfinite)
from svbfm_tpu_torch.learners.vb import (PARAM_FIELDS, init_vb_params,
                                         split_v_block_update)
from svbfm_tpu_torch.parallel.mesh import Mesh, make_mesh2d
from svbfm_tpu_torch.parallel.tp import sharded_scores, sharded_t_terms
from svbfm_tpu_torch.utils.rlog_schema import stream_row

_F32 = torch.float32


@dataclass
class TPVBState:
    """VB state of one rank: the feature shard of the tables ([D_loc],
    [K, D_loc]), the replicated scalars and group precisions, the data
    shard of the residual caches e, t [N_loc]."""

    mu_0: torch.Tensor
    sigma_0_dash: torch.Tensor
    mu_w: torch.Tensor  # [D_loc]
    sigma_w_dash: torch.Tensor  # [D_loc]
    mu_v: torch.Tensor  # [K, D_loc]
    sigma_v_dash: torch.Tensor  # [K, D_loc]
    alpha: torch.Tensor
    sigma_0: torch.Tensor
    sigma_w: torch.Tensor  # [G]
    sigma_v: torch.Tensor  # [G, K]
    e: torch.Tensor  # [N_loc]
    t: torch.Tensor  # [N_loc]


_TABLES = ("mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash")


@dataclass
class TPBlock:
    """One degree bucket of one bin: the rank's part (the JAX package's
    stacked [Sf, Sd, ...] arrays hold every rank's)."""

    rows: torch.Tensor  # int32 [C, L] rows local to the data shard
    x: torch.Tensor  # f32 [C, L]
    cols: torch.Tensor  # int32 [C] LOCAL column ids (padding: D_loc)
    group: torch.Tensor  # int32 [C]
    sx2: torch.Tensor  # f32 [C]
    cnt: torch.Tensor  # f32 [C] entry count in the plan's data (OVB chunk)
    col_count: torch.Tensor  # f32 [C] occurrences in the full train set


@dataclass
class TPPlanData:
    blocks: tuple  # tuple[tuple[TPBlock, ...], ...]
    attr_group: torch.Tensor  # int32 [D_loc] (padding: G, dropped)
    unobserved: torch.Tensor  # bool [D_loc]
    col_valid: torch.Tensor  # bool [D_loc] (False past D)
    num_attr_per_group: torch.Tensor  # f32 [G]


def _build_tp_plan(shape: tuple, plan: SweepPlan, meta: DataMetaInfo,
                   D: int):
    """Partition a global SweepPlan's bins by feature shard (host side):
    the JAX package's ``_build_tp_plan`` for a mesh of ``shape`` (Sd, Sf),
    every rank's part stacked, as numpy.  Returns (TPPlanData of numpy
    arrays, D_loc)."""
    Sd, Sf = shape
    D_loc = -(-D // Sf)
    rps = plan.rows_per_shard
    blocks = []
    for bin_blocks in plan.blocks:
        bucket_list = []
        for blk in bin_blocks:
            L = blk.rows.shape[2]
            owner = blk.cols // D_loc  # [C]
            counts = np.bincount(owner, minlength=Sf)
            C_max = max(int(counts.max()), 1)
            rows = np.full((Sf, Sd, C_max, L), rps - 1, np.int32)
            x = np.zeros((Sf, Sd, C_max, L), np.float32)
            cols = np.full((Sf, C_max), D_loc, np.int32)  # padding
            group = np.zeros((Sf, C_max), np.int32)
            # sx2, cnt, col_count: zero at the padding columns
            per_col = {k: np.zeros((Sf, C_max), np.float32)
                       for k in ("sx2", "cnt", "col_count")}
            for s in range(Sf):
                sel = np.where(owner == s)[0]
                c = len(sel)
                if c == 0:
                    continue
                rows[s, :, :c] = blk.rows[:, sel]
                x[s, :, :c] = blk.x[:, sel]
                cols[s, :c] = blk.cols[sel] - s * D_loc  # local ids
                group[s, :c] = blk.group[sel]
                for k, a in per_col.items():
                    a[s, :c] = getattr(blk, k)[sel]
            bucket_list.append(TPBlock(rows=rows, x=x, cols=cols,
                                       group=group, **per_col))
        blocks.append(tuple(bucket_list))
    D_pad = D_loc * Sf
    ag = np.full(D_pad, meta.num_attr_groups, np.int32)  # padding: G
    ag[:D] = meta.attr_group
    unob = np.ones(D_pad, bool)
    unob[:D] = plan.unobserved
    valid = np.zeros(D_pad, bool)
    valid[:D] = True
    return TPPlanData(
        blocks=tuple(blocks), attr_group=ag.reshape(Sf, D_loc),
        unobserved=unob.reshape(Sf, D_loc),
        col_valid=valid.reshape(Sf, D_loc),
        num_attr_per_group=meta.num_attr_per_group.astype(np.float32),
    ), D_loc


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def local_plan(plan: TPPlanData, d: int, f: int, device) -> TPPlanData:
    """Rank (d, f)'s part of ``_build_tp_plan``'s stacked plan, on
    ``device``."""
    blocks = tuple(
        tuple(TPBlock(rows=_put(b.rows[f, d], device),
                      x=_put(b.x[f, d], device),
                      **{k: _put(getattr(b, k)[f], device) for k in (
                          "cols", "group", "sx2", "cnt", "col_count")})
              for b in bin_blocks)
        for bin_blocks in plan.blocks)
    return TPPlanData(
        blocks=blocks, attr_group=_put(plan.attr_group[f], device),
        unobserved=_put(plan.unobserved[f], device),
        col_valid=_put(plan.col_valid[f], device),
        num_attr_per_group=_put(plan.num_attr_per_group, device))


# The bytes the rank's TP buffers may take on its device; None: what
# torch.cuda.mem_get_info reports free there (no bound on the CPU).
# Module-level so that a test can shrink it to trip the guard.
TP_BUDGET_BYTES: Optional[int] = None


def tp_buffer_bytes(plan_data: TPPlanData, n_loc: int, K: int,
                    D_loc: int) -> dict:
    """The buffers kernels T1-T4 allocate on a rank, in bytes: the row
    caches qt [N, 3K], a bin's patch (N (3K + 2) floats) and T1's partials
    of the train rows [N, 1 + 3K] (the T-terms'), the patch table
    [D_loc, 5K + 2] and the largest bucket's column sums [C, 2K + 1]."""
    acc = max((b.cols.shape[0] * (2 * K + 1) for bb in plan_data.blocks
               for b in bb), default=0)
    return {"row caches qt": n_loc * 3 * K * 4,
            "bin patch": n_loc * (3 * K + 2) * 4,
            "T1 partials": n_loc * (1 + 3 * K) * 4,
            "patch table": D_loc * (5 * K + 2) * 4,
            "column sums": acc * 4}


def check_tp_memory_budget(plan_data: TPPlanData, n_loc: int, K: int,
                           D_loc: int, learner: str, device,
                           parts: Optional[dict] = None) -> None:
    """Fail LOUDLY, at construction, where the feature-sharded sweep's
    buffers (``parts``, by default the VB sweep's ``tp_buffer_bytes``)
    exceed the rank's device memory (``TP_BUDGET_BYTES``, else the free
    bytes ``torch.cuda.mem_get_info`` reports on the card), instead of
    letting the sweep run out of memory in its middle."""
    budget = TP_BUDGET_BYTES
    if budget is None and torch.device(device).type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0]
    if budget is None:
        return
    if parts is None:
        parts = tp_buffer_bytes(plan_data, n_loc, K, D_loc)
    need = sum(parts.values())
    if need > budget:
        items = "; ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in
                          parts.items())
        raise RuntimeError(
            f"{learner}: problem too large for the feature-sharded (TP) "
            f"sweep's buffers ({items}: {need / 2**30:.2f} GiB of the "
            f"{budget / 2**30:.2f} GiB the rank's device has). Remedies: "
            f"shard the data axis more (n_loc = {n_loc} rows a rank), "
            f"reduce the factor count K={K}, or use the replicated learner, "
            "whose sweep holds no per-shard partials.")


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

def tp_vb_update_all(state: TPVBState, row: RowData, plan: TPPlanData,
                     cfg: FMConfig, num_cases: float, mesh: Mesh, D_loc: int,
                     lo: int):
    """One full VB sweep with feature-sharded tables on one rank, the
    JAX package's ``tp_vb_update_all``; returns (state, fe, nans), device
    tensors.  ``state`` is not modified."""
    dev = state.e.device
    K, G = cfg.num_factor, cfg.num_groups
    e, t = state.e.clone(), state.t.clone()
    alpha = state.alpha
    mu_0, sigma_0_dash = state.mu_0, state.sigma_0_dash
    N = torch.full((), num_cases, dtype=_F32, device=dev)
    ids, vals = row.ids, row.vals
    ag = plan.attr_group  # [D_loc], padding G
    agc = ag.clamp(max=G - 1)  # JAX's take_rows(..., mode="clip")
    zero = torch.zeros((), dtype=_F32, device=dev)

    # --- w0 update (fm_learn_vb.h:504-525) ---
    if cfg.k0:
        sigma_new = 1.0 / (state.sigma_0 + N * alpha)
        w0_temp = mesh.all_reduce_data(torch.sum(e * row.valid)) + N * mu_0
        mu_new = sigma_new * alpha * w0_temp
        e += mu_0 - mu_new
        t += sigma_new - sigma_0_dash
        mu_0, sigma_0_dash = mu_new, sigma_new

    mu_w, sig_w = state.mu_w.clone(), state.sigma_w_dash.clone()
    mu_v, sig_v = state.mu_v.clone(), state.sigma_v_dash.clone()
    nans = torch.zeros(2, dtype=torch.int32, device=dev)
    merge_w = cfg.k1 and K > 0
    if K > 0:
        mu_t, sig_t = mu_v.T.contiguous(), sig_v.T.contiguous()
        w_state = (mu_w, sig_w, state.sigma_w) if merge_w else None
        nans = split_v_block_update(e, t, mu_t, sig_t,
                                    state.sigma_v.contiguous(), alpha, plan,
                                    row, mesh, w_state, lo)
        # unobserved columns: sigma' = 1/sigma_v(g,f), mu' = 0
        unob = plan.unobserved[:, None]
        sig_t = torch.where(unob, 1.0 / state.sigma_v.index_select(0, agc),
                            sig_t)
        mu_t = torch.where(unob, zero, mu_t)
        mu_v, sig_v = mu_t.T.contiguous(), sig_t.T.contiguous()

    if cfg.k1:
        if K == 0:  # no v pass to ride: the standalone w sweep (T3, T4)
            dtab = torch.empty(D_loc, 2, dtype=_F32, device=dev)
            acc = torch.empty(D_loc, dtype=_F32, device=dev)
            bad = torch.zeros(4, dtype=torch.int32, device=dev)
            for bin_blocks in plan.blocks:
                dtab.zero_()
                acc.zero_()
                tp_w_stats(bin_blocks, e, acc, D_loc)
                mesh.all_reduce_data(acc)
                tp_w_update(bin_blocks, acc, D_loc, mu_w, sig_w,
                            state.sigma_w, alpha, dtab, bad)
                _, de, dt = tp_patch_views(mesh.all_reduce_feature(
                    tp_patch_delta(dtab, 0, True, ids, vals, None, lo,
                                   D_loc)), e.shape[0], 0)
                e += de
                t += dt
        # unobserved: sigma' = 1/sigma_w(g), mu' = 0
        unob1 = plan.unobserved
        sig_w = torch.where(unob1, 1.0 / state.sigma_w.index_select(0, agc),
                            sig_w)
        mu_w = torch.where(unob1, zero, mu_w)

    # --- hyperparameters (fm_learn_vb.h:446-498): local per-group sums
    # over G + 1 segments, the padding's (G) dropped, ONE feature
    # all-reduce
    alpha_temp = mesh.all_reduce_data(torch.sum((e * e + t) * row.valid))
    alpha_cand = N / alpha_temp
    nan_alpha = nonfinite(alpha_cand)
    alpha = keep_finite(alpha_cand, state.alpha)
    sigma_0 = 1.0 / (mu_0 * mu_0 + sigma_0_dash)
    valid = plan.col_valid
    terms = torch.cat([(mu_w * mu_w + sig_w)[:, None],
                       (mu_v * mu_v + sig_v).T], 1)  # [D_loc, 1 + K]
    stats = mesh.all_reduce_feature(group_sum(
        torch.where(valid[:, None], terms, zero), ag, G + 1)[:G])
    sigma_w = plan.num_attr_per_group / stats[:, 0]
    sigma_v = plan.num_attr_per_group[:, None] / stats[:, 1:]

    # --- free energy (fm_learn_vb.h:646-681; 2*3.14 kept) ---
    fe = -0.5 * alpha * alpha_temp - 0.5 * N * torch.log(2 * 3.14 / alpha)
    fe = fe + (-0.5 * sigma_0 * (mu_0 * mu_0 + sigma_0_dash)
               + 0.5 * torch.log(sigma_0_dash * sigma_0) + 0.5)
    sw_d = sigma_w.index_select(0, agc)
    fw = torch.sum(torch.where(
        valid, -0.5 * sw_d * (mu_w * mu_w + sig_w)
        + 0.5 * torch.log(sig_w * sw_d) + 0.5, zero))
    sv_d = sigma_v.index_select(0, agc)  # [D_loc, K]
    fv = torch.sum(torch.where(
        valid[:, None], -0.5 * sv_d * (mu_v * mu_v + sig_v).T
        + 0.5 * torch.log(sig_v.T * sv_d) + 0.5, zero))
    parts = mesh.all_reduce_feature(torch.stack([fw, fv]))
    fe = fe + parts[0] + parts[1]

    new_state = TPVBState(
        mu_0=mu_0, sigma_0_dash=sigma_0_dash, mu_w=mu_w, sigma_w_dash=sig_w,
        mu_v=mu_v, sigma_v_dash=sig_v, alpha=alpha, sigma_0=sigma_0,
        sigma_w=sigma_w, sigma_v=sigma_v, e=e, t=t)
    return new_state, fe, dict(nan_w=nans[1], nan_v=nans[0],
                               nan_alpha=nan_alpha)


# ---------------------------------------------------------------------------
# The learner
# ---------------------------------------------------------------------------

_SCALARS = ("free_energy", "rmse", "alpha", "nan_w", "nan_v", "nan_alpha")


def shard_cols(a: torch.Tensor, lo: int, D_loc: int,
               D_pad: int) -> torch.Tensor:
    """The feature shard [lo, lo + D_loc) of a table over its last dim
    [..., D], zero-padded to D_pad first."""
    pad = D_pad - a.shape[-1]
    if pad > 0:
        a = torch.nn.functional.pad(a, (0, pad))
    return a[..., lo:lo + D_loc].contiguous()


def gather_cols(mesh: Mesh, t: torch.Tensor, lo: int,
                D_pad: int) -> torch.Tensor:
    """The feature shards' [..., D_loc] tables as one [..., D_pad] on every
    rank: an all-reduce over every rank of zero-filled tensors, data shard
    0's ranks filling their columns.  Every rank must call it."""
    g = t.new_zeros(tuple(t.shape[:-1]) + (D_pad,))
    if mesh.d_index == 0:
        g[..., lo:lo + t.shape[-1]] = t
    return mesh.all_reduce(g)


def shard_rows(ds: SparseDataset, n_data: int, d: int, device):
    """Data shard ``d`` of ``n_data`` of ``ds``'s rows, padded to a
    multiple of ``n_data`` (the JAX learner's ``padded_to`` and row
    sharding): (RowData, rows a shard)."""
    ds = ds.padded_to(n_data)
    rps = ds.ids.shape[0] // n_data
    sl = slice(d * rps, (d + 1) * rps)
    valid = (np.arange(d * rps, (d + 1) * rps) < ds.num_rows)
    return RowData(
        ids=_put(ds.ids[sl].astype(np.int32), device),
        vals=_put(ds.vals[sl].astype(np.float32), device),
        target=_put(ds.target[sl].astype(np.float32), device),
        valid=_put(valid.astype(np.float32), device)), rps


class TPVBLearner:
    """Batch VBFM with feature-sharded tables over a (data, feature) mesh of
    ranks (``parallel/mesh.py``); each rank constructs it with the whole
    data and keeps its part.  Numerics: the single-device
    :class:`svbfm_tpu_torch.learners.vb.VBLearner` in fast mode
    (factor_block=0), regression.  ``mesh`` None: a data-parallel mesh of
    every rank on ``device`` (one rank: the single-device learner)."""

    method = "vb"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh: Optional[Mesh] = None, *, device="cuda",
                 bins: str = "auto", out_dir: str = ".",
                 write_files: bool = False):
        if cfg.factor_block != 0:
            raise ValueError("the feature-sharded VB runs fast mode alone "
                             "(factor_block=0)")
        if cfg.task != TASK_REGRESSION:
            raise ValueError("the feature-sharded VB runs regression alone "
                             "(task=0)")
        if cfg.num_factor < 0:
            raise ValueError("num_factor must be >= 0")
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
        check_tp_memory_budget(self.plan_data, self.rps, cfg.num_factor,
                               self.D_loc, type(self).__name__, self.device)
        self.out_dir = out_dir
        self.write_files = write_files

    @property
    def lead(self) -> bool:
        """Whether this rank writes the files and prints (rank 0)."""
        return self.mesh.rank == 0

    # ---- forward ----------------------------------------------------------

    def _scores(self, state: TPVBState, row: RowData) -> torch.Tensor:
        cfg = self.cfg
        return sharded_scores(self.mesh.all_reduce_feature, state.mu_0,
                              state.mu_w, state.mu_v, row.ids, row.vals,
                              self.lo, self.D_loc, cfg.k0, cfg.k1)

    # ---- state ------------------------------------------------------------

    def _shard_of(self, a: torch.Tensor) -> torch.Tensor:
        """The rank's feature shard of a table over the last dim [..., D]
        (padded to D_pad)."""
        return shard_cols(a, self.lo, self.D_loc, self.D_pad)

    def state_from_params(self, params: Mapping[str, torch.Tensor]
                          ) -> TPVBState:
        """The rank's state from the ten parameter tensors with whole [D]
        tables (``learners/vb.py:init_vb_params``): its feature shard of
        the tables, and e = y - yhat and the T-terms of its train rows
        (T1, the partials all-reduced over the feature group)."""
        cfg, row = self.cfg, self.train_row
        p = {k: params[k].to(self.device) for k in PARAM_FIELDS}
        for k in _TABLES:
            p[k] = self._shard_of(p[k])
        yhat = sharded_scores(self.mesh.all_reduce_feature, p["mu_0"],
                              p["mu_w"], p["mu_v"], row.ids, row.vals,
                              self.lo, self.D_loc, cfg.k0, cfg.k1)
        t = sharded_t_terms(self.mesh.all_reduce_feature, p["sigma_0_dash"],
                            p["sigma_w_dash"], p["mu_v"], p["sigma_v_dash"],
                            row.ids, row.vals, self.lo, self.D_loc, cfg.k0,
                            cfg.k1)
        return TPVBState(e=row.target - yhat, t=t, **p)

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TPVBState:
        """The whole tables drawn on every rank from the generator of
        ``cfg.seed`` (the single-device learner's draws), then this rank's
        shard kept: the trajectory does not depend on the mesh."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return self.state_from_params(init_vb_params(generator, self.cfg,
                                                     "cpu"))

    def _place(self, state: TPVBState) -> TPVBState:
        """The state's tensors (host or device) on the rank's device."""
        return TPVBState(**{f.name: torch.as_tensor(
            getattr(state, f.name), dtype=_F32).contiguous().to(self.device)
            for f in dataclasses.fields(TPVBState)})

    def predict_test_scores(self, state: TPVBState) -> np.ndarray:
        """The scores of every test row (the data shards' gathered by an
        all-reduce of zero-filled vectors)."""
        s = self._scores(state, self.test_row)
        return gather_rows(self.mesh, s, self.test_rps).cpu().numpy()[
            : self.test_n]

    # ---- checkpoints: the JAX package's padded global layout ----------------

    def global_state(self, state: TPVBState) -> TPVBState:
        """The whole state on the host in the JAX package's global layout
        (tables [D_pad] / [K, D_pad], e/t [N_pad]), gathered by an
        all-reduce over every rank of zero-filled tensors, each rank
        filling its tables (data shard 0's) and its rows (feature shard
        0's).  Every rank must call it."""
        out = {}
        for f in dataclasses.fields(TPVBState):
            a = getattr(state, f.name)
            if f.name in _TABLES:
                a = gather_cols(self.mesh, a, self.lo, self.D_pad)
            elif f.name in ("e", "t"):
                a = gather_rows(self.mesh, a, self.rps)
            out[f.name] = a.cpu()
        return TPVBState(**out)

    def local_state(self, g: TPVBState) -> TPVBState:
        """The rank's part of a global-layout state, on its device."""
        out = {}
        d = self.mesh.d_index
        for f in dataclasses.fields(TPVBState):
            a = getattr(g, f.name)
            if f.name in _TABLES:
                a = a[..., self.lo:self.lo + self.D_loc]
            elif f.name in ("e", "t"):
                a = a[d * self.rps:(d + 1) * self.rps]
            out[f.name] = a
        return self._place(TPVBState(**out))

    def _global_template(self) -> TPVBState:
        K, G = self.cfg.num_factor, self.cfg.num_groups
        z = torch.zeros
        n = self.rps * self.mesh.n_data
        return TPVBState(
            mu_0=z(()), sigma_0_dash=z(()), mu_w=z(self.D_pad),
            sigma_w_dash=z(self.D_pad), mu_v=z(K, self.D_pad),
            sigma_v_dash=z(K, self.D_pad), alpha=z(()), sigma_0=z(()),
            sigma_w=z(G), sigma_v=z(G, K), e=z(n), t=z(n))

    def _resume(self, ckpt, state: TPVBState):
        if ckpt is None:
            return state, 0
        restored = ckpt.restore_latest(self._global_template())
        if restored is None:
            return state, 0
        g, step, _meta = restored
        return self.local_state(g), step

    # ---- one iteration ----------------------------------------------------

    def step(self, state: TPVBState):
        """One sweep + the test RMSE.  Returns (state, packed metrics): a
        float32 device vector laid out as ``_SCALARS`` then sigma_w [G]
        then sigma_v [G*K]."""
        cfg, m = self.cfg, self.mesh
        state, fe, nans = tp_vb_update_all(
            state, self.train_row, self.plan_data, cfg, float(self.train_n),
            m, self.D_loc, self.lo)
        trow = self.test_row
        p = torch.clamp(self._scores(state, trow), cfg.min_target,
                        cfg.max_target)
        err = (p - trow.target) * trow.valid
        rmse = torch.sqrt(m.all_reduce_data(torch.sum(err * err))
                          / float(self.test_n))
        scalars = torch.stack([fe, rmse, state.alpha,
                               nans["nan_w"].to(_F32),
                               nans["nan_v"].to(_F32),
                               nans["nan_alpha"].to(_F32)])
        return state, torch.cat([scalars, state.sigma_w.reshape(-1),
                                 state.sigma_v.reshape(-1)])

    def _unpack(self, m: np.ndarray) -> dict:
        G, K = self.cfg.num_groups, self.cfg.num_factor
        n = len(_SCALARS)
        rec = {k: float(m[i]) for i, k in enumerate(_SCALARS)}
        rec["sigma_w"] = m[n:n + G].copy()
        rec["sigma_v"] = m[n + G:n + G + G * K].reshape(G, K).copy()
        return rec

    # ---- training loop ----------------------------------------------------

    def run(self, state: Optional[TPVBState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            ckpt=None, ckpt_every: int = 10):
        """Train for ``num_iter`` sweeps; every rank calls it.  Rank 0
        writes the trajectory files, prints and streams the RLog.  ``ckpt``
        (a ``utils.checkpoint.CheckpointManager`` every rank can read)
        resumes from its latest checkpoint and rank 0 saves the global
        state after ``ckpt_every`` sweeps and after the last
        (tp_vb.py:665-708).  Returns (state, history)."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        state, it = self._resume(ckpt, state)
        on = self.write_files and self.lead and it == 0
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method,
                                   self.out_dir, on)
        fe_file = TrajectoryFile("free_energy", cfg, self.method,
                                 self.out_dir, on)
        history = []
        last_saved = it
        while it < num_iter:
            t0 = time.perf_counter()
            state, packed = self.step(state)
            t1 = time.perf_counter()
            metrics = packed.cpu().numpy()
            now = time.perf_counter()
            rec = {"iter": it, "time_learn": now - t0, "time_pred": now - t1}
            if not self.plan.conflict_free:
                rec["conflict_free"] = False  # Jacobi-bin approximation
            rec.update(self._unpack(metrics))
            if self.lead:
                fe_file.append(-rec["free_energy"])
                rmse_file.append(rec["rmse"])
                if verbose:
                    print(f"#Iter={it:3d}\tTest={rec['rmse']:.6g}")
                stream_row(self, rec, state=state)
            history.append(rec)
            it += 1
            if ckpt is not None and (it - last_saved >= ckpt_every
                                     or it >= num_iter):
                g = self.global_state(state)
                if self.lead:
                    ckpt.save(g, it, {"method": self.method})
                self.mesh.barrier()
                last_saved = it
        return state, history
