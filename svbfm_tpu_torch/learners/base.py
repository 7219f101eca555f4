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


@dataclass(frozen=True)
class FMConfig:
    """Static learner configuration: the JAX package's FMConfig fields that
    batch VBFM reads (same names and defaults)."""

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
    # factors per block in the VB v sweep; 0 = all K in one block ("fast
    # mode", the linear-term sweep riding inside it)
    factor_block: int = 0

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
    """One ColumnBlock (single shard) on the device: the fields the VB
    sweep reads."""

    rows: torch.Tensor  # int32 [C, L]
    x: torch.Tensor  # f32 [C, L]
    cols: torch.Tensor  # int32 [C]
    group: torch.Tensor  # int32 [C]
    sx2: torch.Tensor  # f32 [C]


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
                sx2=_put(blk.sx2, device))
            for blk in bin_blocks)
        for bin_blocks in plan.blocks)
    return PlanData(
        blocks=blocks,
        attr_group=_put(meta.attr_group.astype(np.int32), device),
        num_attr_per_group=_put(meta.num_attr_per_group.astype(np.float32),
                                device),
        unobserved=_put(plan.unobserved, device),
    )


def keep_finite(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """The reference's NaN/Inf revert guard (e.g. fm_learn_vb.h:545-565)."""
    return torch.where(torch.isfinite(new), new, old)


def nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Count of non-finite entries, as an int32 device scalar."""
    return (~torch.isfinite(x)).sum(dtype=torch.int32)


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
