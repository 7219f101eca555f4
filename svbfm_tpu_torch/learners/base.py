"""Shared learner infrastructure: config, device data bundles, eval, logs.

Counterpart of ``svbfm_tpu/learners/base.py``: the data bundles are plain
dataclasses of tensors on the device the learner was given.  On one
device they hold every row; on a data mesh of ranks
(``parallel/mesh.py:make_mesh``) rank d holds the contiguous block d of
the rows, padded as the JAX package pads them, and its slice of each
bucket of a ``SweepPlan`` built for as many shards.  ``FMConfig`` keeps
the JAX config's names and defaults for the fields the port reads.
"""

from __future__ import annotations

import os
import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
from svbfm_tpu_torch.data.meta import DataMetaInfo

TASK_REGRESSION = 0
TASK_CLASSIFICATION = 1  # binary probit / logistic, targets +-1
TASK_POISSON = 2  # the SGD family's exp multiplier (svbfm_tpu sgd.py:98)


@dataclass(frozen=True)
class FMConfig:
    """Static learner configuration: the JAX package's FMConfig fields that
    batch and online VBFM, Gibbs MCMC, ALS and the SGD family read (same
    names and defaults)."""

    num_attributes: int
    num_factor: int
    k0: bool = True
    k1: bool = True
    task: int = TASK_REGRESSION
    min_target: float = -np.inf
    max_target: float = np.inf
    num_groups: int = 1
    num_iter: int = 100
    seed: int = 0
    # MCMC/ALS: the init spread of w and v, the -regular prior precisions
    # (their initial lambdas), and the two switches ALS turns off
    init_stdev: float = 0.1
    # the SGD family: step size (-learn_rate)
    learn_rate: float = 0.1
    reg0: float = 0.0
    regw: float = 0.0
    regv: float = 0.0
    do_sample: bool = True
    do_multilevel: bool = True
    # factors per block in the VB and MCMC v sweeps; 0 = all K in one block
    # (VB "fast mode", the linear-term sweep riding inside it); 1 = the
    # reference's factor-sequential order.  Online VB turns 0 into 1.
    factor_block: int = 0
    # ALS only: all factors of a block from the pre-bin residual
    # (-factor_jacobi), not a valid Gibbs kernel
    mcmc_factor_jacobi: bool = False
    # online VB: chunks per epoch (-batch), and whether chunk membership is
    # re-drawn every epoch (-reshuffle) instead of fixed once
    num_batches: int = 50
    reshuffle: bool = False
    # SGD: the exponential-family multiplier (exp_sgd_stoc), the minibatch
    # size (0: 1024) and the exp-family residual scale (-stdev)
    exp_family: bool = False
    batch_size: int = 0
    stdev: float = 1.0

    @property
    def dim_tag(self) -> str:
        return f"{int(self.k0)}{int(self.k1)}{self.num_factor}"


@dataclass
class RowData:
    """Row-layout tensors on one device."""

    ids: torch.Tensor  # int32 [N, P]
    vals: torch.Tensor  # f32 [N, P]
    target: torch.Tensor  # f32 [N]
    valid: torch.Tensor  # f32 [N] 1.0 for real rows, 0.0 for padding


@dataclass
class BlockData:
    """One ColumnBlock (single shard) on the device."""

    rows: torch.Tensor  # int32 [C, L]
    x: torch.Tensor  # f32 [C, L]
    cols: torch.Tensor  # int32 [C]
    group: torch.Tensor  # int32 [C]
    sx2: torch.Tensor  # f32 [C]
    cnt: torch.Tensor  # f32 [C] entry count in this data (an OVB chunk)
    col_count: torch.Tensor  # f32 [C] occurrences in the full train set


@dataclass
class PlanData:
    """SweepPlan tensors: bins -> degree buckets of BlockData."""

    blocks: tuple  # tuple[tuple[BlockData, ...], ...]
    attr_group: torch.Tensor  # int32 [D]
    num_attr_per_group: torch.Tensor  # f32 [G]
    unobserved: torch.Tensor  # bool [D]


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# Datasets of this many rows or more are padded to a multiple of
# ROW_QUANTUM rows a shard on a data mesh, as the JAX package pads them
# (svbfm_tpu/learners/base.py:115-129)
ROW_QUANTUM = 16384
_ROW_QUANTUM_MIN_ROWS = 2_000_000


def padded_rows(ds: SparseDataset, n_shards: int) -> int:
    """The row count of ``ds`` split over a data mesh of ``n_shards``: a
    multiple of ``n_shards``, and of ``n_shards`` x ``ROW_QUANTUM`` at
    2M rows or more."""
    n = max(ds.num_rows, ds.ids.shape[0], 1)
    q = n_shards * (ROW_QUANTUM if ds.num_rows >= _ROW_QUANTUM_MIN_ROWS
                    else 1)
    return -(-n // q) * q


def build_row_data(ds: SparseDataset, device,
                   mesh=None) -> tuple[RowData, int]:
    """Returns (RowData, num_cases) on ``device``: every row, or on a data
    ``mesh`` the rank's contiguous block of ``padded_rows`` rows (the
    padding rows carry valid = 0); num_cases counts the real rows of all
    ranks."""
    lo, hi = 0, ds.ids.shape[0]
    if mesh is not None:
        ds = ds.padded_to(padded_rows(ds, mesh.n_data))
        rps = ds.ids.shape[0] // mesh.n_data
        lo, hi = mesh.d_index * rps, (mesh.d_index + 1) * rps
    valid = (np.arange(lo, hi) < ds.num_rows).astype(np.float32)
    return RowData(
        ids=_put(ds.ids[lo:hi].astype(np.int32), device),
        vals=_put(ds.vals[lo:hi].astype(np.float32), device),
        target=_put(ds.target[lo:hi].astype(np.float32), device),
        valid=_put(valid, device),
    ), ds.num_rows


def learner_device(device, mesh):
    """The device of a learner given ``device`` and/or a data ``mesh``
    (the mesh's device; one given beside it must be the same)."""
    if mesh is None:
        if device is None:
            raise TypeError("the learner needs a device (or a mesh)")
        return torch.device(device)
    dev = torch.device(device if device is not None else mesh.device)
    if dev.type != mesh.device.type or dev.index not in (None,
                                                         mesh.device.index):
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def mesh_plan(train: SparseDataset, cfg: FMConfig, meta: DataMetaInfo,
              bins: str, mesh, plan: Optional[SweepPlan]) -> SweepPlan:
    """The learner's SweepPlan: ``plan``, else built for the data shards of
    ``mesh`` (one without), its rows per shard those of
    ``build_row_data``'s blocks."""
    if mesh is None:
        return plan if plan is not None else SweepPlan.build(
            train.to_coo(), cfg.num_attributes, meta_groups=meta.attr_group,
            bins=bins)
    n_pad = padded_rows(train, mesh.n_data)
    if plan is None:
        return SweepPlan.build(train.to_coo(), cfg.num_attributes,
                               meta_groups=meta.attr_group, bins=bins,
                               n_shards=mesh.n_data, n_rows_total=n_pad)
    if plan.rows_per_shard * mesh.n_data != n_pad:
        raise ValueError(f"the SweepPlan has {plan.rows_per_shard} rows a "
                         f"shard; the mesh's blocks {n_pad // mesh.n_data}")
    return plan


def build_plan_data(plan: SweepPlan, meta: DataMetaInfo, device,
                    mesh=None) -> PlanData:
    """The plan on ``device``: its one shard, or on a data ``mesh`` the
    rank's slice [d] of each bucket's rows and x (rows local to the rank's
    block; a padding slot is its last row, with x = 0)."""
    n, d = (1, 0) if mesh is None else (mesh.n_data, mesh.d_index)
    # (a plan of no bucket, a block-structure model's empty main block,
    # holds no shard's rows)
    if plan.num_shards != n and any(plan.blocks):
        raise ValueError(f"the SweepPlan was built for {plan.num_shards} "
                         f"shard(s); the learner runs on {n}: build it with "
                         f"n_shards={n}")
    blocks = tuple(
        tuple(
            BlockData(
                rows=_put(blk.rows[d], device), x=_put(blk.x[d], device),
                cols=_put(blk.cols, device), group=_put(blk.group, device),
                sx2=_put(blk.sx2, device), cnt=_put(blk.cnt, device),
                col_count=_put(blk.col_count, device))
            for blk in bin_blocks)
        for bin_blocks in plan.blocks)
    return PlanData(
        blocks=blocks,
        attr_group=_put(meta.attr_group.astype(np.int32), device),
        num_attr_per_group=_put(meta.num_attr_per_group.astype(np.float32),
                                device),
        unobserved=_put(plan.unobserved, device),
    )


def gather_rows(mesh, t: torch.Tensor, rps: int) -> torch.Tensor:
    """The data shards' [rps, ...] row blocks laid end to end on every
    rank (an all-reduce over every rank of zero-filled tensors, feature
    shard 0's ranks filling their block).  Every rank must call it."""
    g = t.new_zeros((rps * mesh.n_data,) + tuple(t.shape[1:]))
    if mesh.f_index == 0:
        g[mesh.d_index * rps:(mesh.d_index + 1) * rps] = t
    return mesh.all_reduce(g)


def row_block(mesh, a: torch.Tensor, rps: int) -> torch.Tensor:
    """The rank's block of ``rps`` rows of a global per-row vector [N]
    (``gather_rows``' inverse), zero-padded to ``rps`` x the data
    shards."""
    a = torch.nn.functional.pad(a, (0, rps * mesh.n_data - a.shape[0]))
    d = mesh.d_index
    return a[d * rps:(d + 1) * rps].contiguous()


def held_back(row: RowData, num_rows: int, num_eval_cases: Optional[int],
              first_row: int = 0):
    """The test eval over the first ``num_eval_cases`` rows (libFM's
    -num_eval_cases, fm_learn_mcmc_simultaneous.h:240-256,
    fm_learn_vb_simultaneous.h:220-232): returns (row, rest, eval_n), the
    row data with its ``valid`` mask REPLACED by the first rows' mask (the
    metric and its normaliser both use it), the held-back rows' mask
    ``rest`` (None when every row is evaluated) and the rows evaluated.
    ``first_row``: the global index of ``row``'s first row (a rank's
    block on a data mesh); the masks are taken on the global index."""
    if num_eval_cases is None or not 0 < num_eval_cases < num_rows:
        return row, None, num_rows
    idx = first_row + torch.arange(row.valid.shape[0],
                                   device=row.valid.device)
    emask = (idx < num_eval_cases).to(torch.float32)
    rest = ((idx >= num_eval_cases) & (idx < num_rows)).to(torch.float32)
    return (RowData(ids=row.ids, vals=row.vals, target=row.target,
                    valid=emask), rest, int(num_eval_cases))


# group_sum's row order and group sizes, by the id of the group tensor they
# are for (an entry leaves with its tensor)
_GROUP_SPLITS: dict = {}


def group_sum(x: torch.Tensor, group: torch.Tensor, G: int) -> torch.Tensor:
    """The sums of ``x``'s rows ([D] or [D, K]) by ``group`` ([D], in
    [0, G)): [G] or [G, K] (JAX's ``segment_sum``).  ``index_add_`` on the
    CPU.  On a card ``index_add_`` adds with float atomics, in an order
    that changes from run to run; there the rows are put in group order
    (found once for each ``group`` tensor) and each group's rows summed by
    ``torch.sum``, which gives the same bits every run, so that a run
    resumed from a checkpoint repeats the uninterrupted one."""
    if x.device.type == "cpu":
        return x.new_zeros((G,) + tuple(x.shape[1:])).index_add_(0, group, x)
    key = id(group)
    split = _GROUP_SPLITS.get(key)
    if split is None or split[0]() is not group:
        g = group.cpu().numpy()
        order = np.argsort(g, kind="stable")
        perm = (None if np.array_equal(order, np.arange(len(g)))
                else torch.from_numpy(order).to(group.device))
        split = _GROUP_SPLITS[key] = (
            weakref.ref(group, lambda _, k=key: _GROUP_SPLITS.pop(k, None)),
            perm, np.bincount(g, minlength=G)[:G].tolist())
    _, perm, sizes = split
    rows = x if perm is None else x.index_select(0, perm)
    return torch.stack([part.sum(0) for part in rows.split(sizes)])


def keep_finite(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """The reference's NaN/Inf revert guard (e.g. fm_learn_vb.h:545-565)."""
    return torch.where(torch.isfinite(new), new, old)


def nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Count of non-finite entries, as an int32 device scalar (batch VB
    counts NaN and Inf together)."""
    return (~torch.isfinite(x)).sum(dtype=torch.int32)


def zero_counters(families, device) -> dict:
    """All-zero int32 device counters ``nan_<family>``/``inf_<family>``."""
    z = torch.zeros((), dtype=torch.int32, device=device)
    return {k: z for fam in families for k in (f"nan_{fam}", f"inf_{fam}")}


def count_bad(counters: dict, name: str, cand: torch.Tensor) -> None:
    """Add the NaN and the Inf candidates of ``cand`` to ``counters`` under
    ``nan_<name>`` and ``inf_<name>`` (svbfm_tpu/learners/mcmc.py:106-117;
    online VB counts the two apart)."""
    counters[f"nan_{name}"] = (counters[f"nan_{name}"]
                               + torch.isnan(cand).sum(dtype=torch.int32))
    counters[f"inf_{name}"] = (counters[f"inf_{name}"]
                               + torch.isinf(cand).sum(dtype=torch.int32))


def print_nonzero_nans(rec: dict, verbose: bool = True) -> None:
    """Print a history record's nonzero ``nan_*``/``inf_*`` counters on one
    line, as the reference prints only nonzero counters
    (fm_learn_vb_online_simultaneous.h:159-186)."""
    if not verbose:
        return
    bad = {k: int(v) for k, v in rec.items()
           if (k.startswith("nan_") or k.startswith("inf_")) and int(v) != 0}
    if bad:
        print("\t".join(f"#{k.split('_', 1)[0]}s in {k.split('_', 1)[1]}: {v}"
                        for k, v in bad.items()))


def check_task_r_or_c(cfg: FMConfig) -> None:
    """For the learners that run regression and classification alone (VB,
    OVB, MCMC and block structure, the full-batch exp_sgd).  The Poisson
    task is the SGD family's: the JAX package sends it down the probit
    learners' classification branch on targets it does not binarise,
    which the reference does not document, and the full-batch exp_sgd
    has no task branch; the port refuses it."""
    if cfg.task == TASK_POISSON:
        raise NotImplementedError(
            "task p (Poisson) is read by the SGD family alone (sgd, "
            "sgd_online, sgda, exp_sgd_stoc); for this method it is not "
            "ported (ROADMAP.md queue 1, item 15)")
    if cfg.task not in (TASK_REGRESSION, TASK_CLASSIFICATION):
        raise ValueError(f"unknown task {cfg.task}")


# ---------------------------------------------------------------------------
# The reference's probit helpers (svbfm_tpu/learners/base.py:201-225), in
# float32 and in its order of operations; csrc/probit.cu computes the same
# ---------------------------------------------------------------------------

# sqrt(3.141 * 2) in float32, the reference's 3.141 kept
SQRT_2PI_REF = float(np.sqrt(np.float32(3.141 * 2)))


def ref_erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 polynomial erf, the reference's ``erf``
    (``src/util/random.h:47-62``)."""
    t = 1.0 / (1.0 + 0.3275911 * torch.abs(x))
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    r = 1.0 - poly * torch.exp(-x * x)
    return torch.where(x >= 0, r, -r)


def ref_cdf_gaussian(x: torch.Tensor) -> torch.Tensor:
    return 0.5 + 0.5 * ref_erf(0.707106781 * x)


def truncnorm_mean_positive(mu: torch.Tensor) -> torch.Tensor:
    """E[z | z > 0], z ~ N(mu, 1), with the reference's constants
    (``fm_learn_vb_simultaneous.h:184-188``)."""
    phi = torch.exp(-mu * mu / 2.0) / SQRT_2PI_REF
    return mu + phi / (1 - ref_cdf_gaussian(-mu))


def truncnorm_mean_negative(mu: torch.Tensor) -> torch.Tensor:
    phi = torch.exp(-mu * mu / 2.0) / SQRT_2PI_REF
    return mu - phi / ref_cdf_gaussian(-mu)


def evaluate_classification(prob, target, normalizer=1.0,
                            num_eval_cases: Optional[int] = None):
    """Accuracy and the negative mean log10 likelihood
    (fm_learn_*_simultaneous), on the host in float64."""
    prob = np.asarray(prob, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if num_eval_cases is not None:
        prob, target = prob[:num_eval_cases], target[:num_eval_cases]
    p = prob * normalizer
    acc = np.mean(((p >= 0.5) & (target > 0)) | ((p < 0.5) & (target < 0)))
    m = (target + 1.0) * 0.5
    pll = np.clip(p, 0.01, 0.99)
    ll = -np.mean(m * np.log10(pll) + (1 - m) * np.log10(1 - pll))
    return float(acc), float(ll)


def regression_metrics(scores: torch.Tensor, row: RowData, num_rows: int,
                       min_target: float, max_target: float, total=None):
    """Test RMSE and MAE of clipped scores, as device scalars; ``total``
    sums the squared and absolute errors' [2] sums over a mesh's data
    shards (a ``parallel/mesh.py`` ``all_reduce_data``) before the root."""
    n = float(num_rows)
    err = (torch.clamp(scores, min_target, max_target) - row.target) * row.valid
    sums = torch.stack([torch.sum(err * err), torch.sum(torch.abs(err))])
    if total is not None:
        sums = total(sums)
    return torch.sqrt(sums[0] / n), sums[1] / n


def evaluate_regression(pred, target, min_target, max_target, normalizer=1.0,
                        num_eval_cases: Optional[int] = None):
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if num_eval_cases is not None:
        pred, target = pred[:num_eval_cases], target[:num_eval_cases]
    p = np.clip(pred * normalizer, min_target, max_target)
    err = p - target
    return float(np.sqrt(np.mean(err**2))), float(np.mean(np.abs(err)))


# ---------------------------------------------------------------------------
# Implicit-feedback MAP@k (host code, as svbfm_tpu/learners/base.py:291-386)
# ---------------------------------------------------------------------------

def map_at_k(pred, user_ids, item_ids, positives: dict, k: int = 5):
    """MAP@k over per-user ranked predictions, using the reference's exact
    (nonstandard) average-precision recurrence (fm_learn.h:203-231): on a
    hit at 0-based rank r the AP state updates as (ap*r + 1)/(r+1) and is
    accumulated — this differs from textbook AP when misses interleave
    hits, and the curves were produced with it.

    positives: {user_id: set(item_id)} of positively-rated items.
    """
    user_ids = np.asarray(user_ids)
    item_ids = np.asarray(item_ids)
    order = np.argsort(user_ids, kind="stable")
    users, items, preds = user_ids[order], item_ids[order], np.asarray(pred)[order]
    ap_sum, n_users = 0.0, 0
    start = 0
    while start < len(users):
        end = start
        while end < len(users) and users[end] == users[start]:
            end += 1
        u = users[start]
        pos = positives.get(int(u), set())
        topk = np.argsort(-preds[start:end], kind="stable")[:k]
        ap, temp = 0.0, 0.0
        for rank, idx in enumerate(topk):
            if int(items[start + idx]) in pos:
                ap = (ap * rank + 1.0) / (rank + 1)
                temp += ap
        if len(pos) > 0:
            ap_sum += temp / len(pos)
        n_users += 1
        start = end
    return ap_sum / max(n_users, 1)


def load_map_fixture(path: str, item_offset: int = 0):
    """Implicit-feedback MAP fixture: libFM-style lines
    ``<rating> <user>:1 <item>:1`` aligned with the test rows
    (the reference hardcodes this file's path and an item offset,
    fm_learn.h:118-153; both are flags here).

    Returns (user_ids [N], item_ids [N], positives {user: set(items)}).
    """
    users, items = [], []
    positives: dict[int, set] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            rating = int(float(parts[0]))
            user = int(parts[1].split(":")[0])
            item = int(parts[2].split(":")[0]) - item_offset
            users.append(user)
            items.append(item)
            if rating == 1:
                positives.setdefault(user, set()).add(item)
    return (np.asarray(users, np.int64), np.asarray(items, np.int64),
            positives)


class MapEval:
    """Per-iteration implicit-feedback MAP@k evaluator for classification.

    The reference evaluates MAP@5 *inside* the MCMC and OVBFM iteration
    loops (fm_learn_mcmc_simultaneous.h:270-275 on the posterior-mean
    probabilities, fm_learn_vb_online_simultaneous.h:258-262 on the current
    epoch's probabilities), using a fixture whose path is hardcoded
    (fm_learn_mcmc.h:1164-1196); here the fixture comes from the
    ``-map_eval``/``-map_item_offset``/``-map_k`` flags and is attached to a
    learner as ``learner.map_eval = MapEval.from_file(...)`` before ``run``.

    Note a deliberate deviation: the reference's ``test_user_prediction_item``
    multimap is never cleared between iterations, so its iteration-i MAP ranks
    a mixture of predictions from ALL iterations <= i; we rank each
    iteration's predictions alone (see PARITY.md).
    """

    def __init__(self, user_ids, item_ids, positives: dict, k: int = 5):
        self.user_ids = np.asarray(user_ids)
        self.item_ids = np.asarray(item_ids)
        self.positives = positives
        self.k = int(k)

    @classmethod
    def from_file(cls, path: str, item_offset: int = 0, k: int = 5) -> "MapEval":
        u, i, pos = load_map_fixture(path, item_offset)
        return cls(u, i, pos, k)

    def __call__(self, probs) -> float:
        return map_at_k(probs, self.user_ids, self.item_ids,
                        self.positives, k=self.k)


class TrajectoryFile:
    """Reference-named per-iteration files (``test_rmse_<dim>_<method>``)."""

    def __init__(self, kind: str, cfg: FMConfig, method: str, out_dir: str = ".",
                 enabled: bool = True):
        self.path = os.path.join(out_dir, f"{kind}_{cfg.dim_tag}_{method}")
        self.enabled = enabled
        if enabled:
            open(self.path, "w").close()  # truncate at run start, like the reference

    def append(self, value: float) -> None:
        if self.enabled:
            with open(self.path, "a") as f:
                f.write(f"{value:g}\n")
