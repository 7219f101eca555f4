"""Shared learner infrastructure: config, device data bundles, eval, logs.

Counterpart of ``svbfm_tpu/learners/base.py`` for one device: the data
bundles are plain dataclasses of tensors on the device the learner was
given, with no sharding.  ``FMConfig`` keeps the JAX config's names and
defaults for the fields the port reads.
"""

from __future__ import annotations

import os
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


def build_row_data(ds: SparseDataset, device) -> tuple[RowData, int]:
    """Returns (RowData, num_cases) on ``device``."""
    valid = (np.arange(ds.ids.shape[0]) < ds.num_rows).astype(np.float32)
    return RowData(
        ids=_put(ds.ids.astype(np.int32), device),
        vals=_put(ds.vals.astype(np.float32), device),
        target=_put(ds.target.astype(np.float32), device),
        valid=_put(valid, device),
    ), ds.num_rows


def build_plan_data(plan: SweepPlan, meta: DataMetaInfo, device) -> PlanData:
    if plan.num_shards != 1:
        raise NotImplementedError(
            "svbfm_tpu_torch runs on one device: build the SweepPlan with "
            "n_shards=1 (multiple GPUs: ROADMAP.md queue 1, item 13)")
    blocks = tuple(
        tuple(
            BlockData(
                rows=_put(blk.rows[0], device), x=_put(blk.x[0], device),
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


def held_back(row: RowData, num_rows: int, num_eval_cases: Optional[int]):
    """The test eval over the first ``num_eval_cases`` rows (libFM's
    -num_eval_cases, fm_learn_mcmc_simultaneous.h:240-256,
    fm_learn_vb_simultaneous.h:220-232): returns (row, rest, eval_n), the
    row data with its ``valid`` mask REPLACED by the first rows' mask (the
    metric and its normaliser both use it), the held-back rows' mask
    ``rest`` (None when every row is evaluated) and the rows evaluated."""
    if num_eval_cases is None or not 0 < num_eval_cases < num_rows:
        return row, None, num_rows
    idx = torch.arange(row.valid.shape[0], device=row.valid.device)
    emask = (idx < num_eval_cases).to(torch.float32)
    rest = ((idx >= num_eval_cases) & (idx < num_rows)).to(torch.float32)
    return (RowData(ids=row.ids, vals=row.vals, target=row.target,
                    valid=emask), rest, int(num_eval_cases))


def rmse_over(p: torch.Tensor, row: RowData, mask: torch.Tensor,
              n: int) -> torch.Tensor:
    """sqrt(sum(((p - target) mask)^2) / n), a device scalar."""
    err = (p - row.target) * mask
    return torch.sqrt(torch.sum(err * err) / float(n))


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
                       min_target: float, max_target: float):
    """Test RMSE and MAE of clipped scores, as device scalars."""
    n = float(num_rows)
    err = (torch.clamp(scores, min_target, max_target) - row.target) * row.valid
    return torch.sqrt(torch.sum(err * err) / n), torch.sum(torch.abs(err)) / n


def evaluate_regression(pred, target, min_target, max_target, normalizer=1.0,
                        num_eval_cases: Optional[int] = None):
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if num_eval_cases is not None:
        pred, target = pred[:num_eval_cases], target[:num_eval_cases]
    p = np.clip(pred * normalizer, min_target, max_target)
    err = p - target
    return float(np.sqrt(np.mean(err**2))), float(np.mean(np.abs(err)))


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
