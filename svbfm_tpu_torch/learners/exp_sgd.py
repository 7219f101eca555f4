"""Exponential-family SGD: the full-batch coordinate sweep (``-method
exp_sgd``) and the stochastic learner (``-method exp_sgd_stoc``).

``exp_sgd_sweep``/``ExpSGDLearner`` are the counterpart of
``svbfm_tpu/learners/exp_sgd.py`` (:62-261), which takes no task branch
(under ``-task c`` it runs on the +-1 targets, the eval a clamped RMSE;
the Poisson task is refused): full-batch
coordinate gradient steps over conflict-free bins with e/q caches
(exp_fm_learn_sgd.h:267-455),

    e     = stdev yhat - y
    w0   -= lr (sum e + reg0 w0) / N
    w_i  -= lr (sum_i x e + regw w_i) / N
    v_fi -= lr (sum_i h e + regv v_fi) / N,   h = x (q_f - x v_fi)

each reverted where it is not finite, the caches patched after every bin,
and a full re-predict each iteration.  The patches are NOT scaled by stdev
(``exp_sgd.py:74, 91, 143``): the reference's quirk, which the float64
oracle copies, is kept.  Inside a factor block the order is bin-major and
factor-Jacobi (every factor of a bin from the pre-bin e); the last block is
narrower where JAX pads and masks.  The kernels: K1 (scores and the test
eval), K5's gradient mode ``w_bin_grad_step`` (one launch a bin) with the
w patch (K4 at F = 0), X8d ``build_q``, X8a's gradient mode
``mcmc_col_grad`` and X8b ``mcmc_patch_rows``.

``ExpSGDStocLearner`` (``exp_sgd.py:264-273``) is ``SGDLearner`` with the
exponential-family multiplier p / stdev - y, unclamped, under regression,
and SGD's own classification and Poisson multipliers under those tasks
(exp_fm_learn_sgd_stoc_element.h:29-43), on X9a and X9b.
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
from svbfm_tpu_torch.kernels.mcmc_sweep import mcmc_col_grad, mcmc_patch_rows
from svbfm_tpu_torch.kernels.vb_sweep import build_q, w_patch_rows
from svbfm_tpu_torch.kernels.w_sweep import w_bin_grad_step
from svbfm_tpu_torch.learners.base import (FMConfig, PlanData, RowData,
                                           TrajectoryFile, build_plan_data,
                                           build_row_data, check_task_r_or_c,
                                           keep_finite)
from svbfm_tpu_torch.learners.sgd import SGDLearner
from svbfm_tpu_torch.models.fm import init_fm_params
from svbfm_tpu_torch.ops.forward import fm_scores

_F32 = torch.float32


@dataclass
class ExpSGDState:
    """The JAX learner's state, the tuple (w0, w, v)."""

    w0: torch.Tensor  # scalar
    w: torch.Tensor  # [D]
    v: torch.Tensor  # [K, D]


def factor_blocks(cfg: FMConfig) -> list[tuple[int, int]]:
    """(first factor, width) of each factor block: ``factor_block`` wide
    (0 = K), the last one narrower where JAX pads and masks
    (exp_sgd.py:93-107)."""
    K = cfg.num_factor
    F = min(cfg.factor_block, K) if cfg.factor_block > 0 else K
    return [(f0, min(F, K - f0)) for f0 in range(0, K, max(F, 1))]


def exp_sgd_sweep(w0, w, v, e, row: RowData, plan: PlanData, cfg: FMConfig,
                  n_cases: float):
    """One full-batch coordinate gradient sweep (exp_sgd.py:62-153); e =
    stdev yhat - y on entry and is updated in place.  Returns (w0, w, v),
    new tensors; the inputs are left as they were."""
    lr = cfg.learn_rate
    D = w.shape[0]
    dev = e.device
    w, v = w.clone(), v.clone()
    if cfg.k0:
        N = torch.full((), n_cases, dtype=_F32, device=dev)
        w0_new = keep_finite(w0 - lr * (torch.sum(e * row.valid)
                                        + cfg.reg0 * w0) / N, w0)
        e -= (w0 - w0_new) * row.valid
        w0 = w0_new
    if cfg.k1:
        dtab = torch.empty(D, 2, dtype=_F32, device=dev)
        for bin_blocks in plan.blocks:
            dtab.zero_()
            w_bin_grad_step(bin_blocks, e, w, dtab, lr, cfg.regw, n_cases)
            w_patch_rows(dtab, row.ids, row.vals, e)
    for f0, Fb in factor_blocks(cfg):
        v_t = v[f0:f0 + Fb].T.contiguous()  # [D, Fb]
        ptab = torch.empty(D, 2 * Fb, dtype=_F32, device=dev)
        q = None
        for bi, bin_blocks in enumerate(plan.blocks):
            ptab[:, :Fb] = v_t
            ptab[:, Fb:].zero_()
            if bi == 0:
                q = build_q(ptab, Fb, row.ids, row.vals)
            for blk in bin_blocks:
                mcmc_col_grad(blk.rows, blk.x, blk.cols, e, q, ptab, v_t, lr,
                              cfg.regv, n_cases)
            mcmc_patch_rows(ptab, Fb, row.ids, row.vals, q, e)
        v[f0:f0 + Fb] = v_t.T
    return w0, w, v


class ExpSGDLearner:
    """Full-batch exponential-family coordinate SGD (``-method exp_sgd``) on
    one device (``device`` is required)."""

    method = "exp_sgd"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None, *,
                 device, bins: str = "auto", out_dir: str = ".",
                 write_files: bool = True):
        check_task_r_or_c(cfg)
        if cfg.factor_block < 0 or cfg.num_factor < 0:
            raise ValueError("factor_block and num_factor must be >= 0")
        self.cfg = cfg
        self.device = torch.device(device)
        self.meta = meta if meta is not None else DataMetaInfo(
            cfg.num_attributes)
        self.plan = SweepPlan.build(train.to_coo(), cfg.num_attributes,
                                    meta_groups=self.meta.attr_group,
                                    bins=bins)
        self.plan_data = build_plan_data(self.plan, self.meta, self.device)
        self.train_row, self.train_n = build_row_data(train, self.device)
        self.test_row, self.test_n = build_row_data(test, self.device)
        self.out_dir = out_dir
        self.write_files = write_files

    def state_from_params(self, w0, w, v) -> ExpSGDState:
        dev = self.device
        return ExpSGDState(*(torch.as_tensor(a, dtype=_F32).to(dev)
                             for a in (w0, w, v)))

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> ExpSGDState:
        """v ~ init_stdev N(0, 1) from ``generator`` (a CPU generator seeded
        with ``cfg.seed`` by default), w = 0, w0 = 0 (init_fm_params)."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        p = init_fm_params(generator, cfg.num_attributes, cfg.num_factor,
                           init_stdev=cfg.init_stdev)
        return self.state_from_params(p.w0, p.w, p.v)

    def _scores(self, state: ExpSGDState, row: RowData) -> torch.Tensor:
        return fm_scores(state.w0, state.w, state.v, row.ids, row.vals,
                         k0=self.cfg.k0, k1=self.cfg.k1)

    def predict_test_scores(self, state: ExpSGDState) -> np.ndarray:
        return self._scores(state, self.test_row).cpu().numpy()[: self.test_n]

    def step(self, state: ExpSGDState):
        """One sweep and the test eval (exp_sgd.py:184-196): returns (state,
        the clamped test RMSE as a device scalar)."""
        cfg, row = self.cfg, self.train_row
        e = (cfg.stdev * self._scores(state, row) - row.target) * row.valid
        w0, w, v = exp_sgd_sweep(state.w0, state.w, state.v, e, row,
                                 self.plan_data, cfg, float(self.train_n))
        state = ExpSGDState(w0=w0, w=w, v=v)
        trow = self.test_row
        p = torch.clamp(self._scores(state, trow), cfg.min_target,
                        cfg.max_target)
        err = (p - trow.target) * trow.valid
        return state, torch.sqrt(torch.sum(err * err) / float(self.test_n))

    def run(self, state: Optional[ExpSGDState] = None,
            num_iter: Optional[int] = None, verbose: bool = True):
        """``num_iter`` sweeps (exp_sgd.py:224-261): each fetches its test
        RMSE (``time_learn`` up to that fetch).  Returns (state, history)."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method,
                                   self.out_dir, self.write_files)
        history = []
        for it in range(num_iter):
            t0 = time.perf_counter()
            state, rmse = self.step(state)
            t1 = time.perf_counter()
            rmse = float(rmse)  # the one sync of the sweep
            now = time.perf_counter()
            rmse_file.append(rmse)
            history.append({"iter": it, "rmse": rmse, "time_pred": now - t1,
                            "time_learn": now - t0})
            if verbose:
                print(f"#Iter={it:3d}\tTest={rmse:.6g}")
        return state, history


class ExpSGDStocLearner(SGDLearner):
    """Per-example exponential-family SGD, minibatch-damped as
    ``SGDLearner``."""

    method = "exp_sgd_stoc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        super().__init__(dataclasses.replace(cfg, exp_family=True), *args,
                         **kwargs)
