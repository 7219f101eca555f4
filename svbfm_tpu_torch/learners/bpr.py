"""Pairwise (BPR) SGD for implicit-feedback ranking (``-method bpr``).

Counterpart of ``svbfm_tpu/learners/bpr.py``: the reference's ``fm_pairSGD``
(``fm_sgd.h:68-131``) as minibatch pair SGD.  Training rows are the
positive examples of one-hot field data; each epoch pairs every row with a
negative, the same row with its item-field id replaced by a uniform item of
that field, and runs ``cfg.num_batches`` pair batches on X9a's pair mode
and X9b: mult = -sigmoid(-(p_pos - p_neg)); the negative row adds -mult
times its gradients and counts only its sampled item where it differs from
the positive one; w0 is only shrunk, by max(1 - reg0, 0) per pair, with no
learning rate (bpr.py:82, kept).  The eval reports the pairwise ranking
accuracy and the BPR loss on the test rows against fixed negatives drawn
once a run from a source seeded with ``cfg.seed + 17`` (bpr.py:233).

Every random number comes from the state's draw source: an epoch draws the
permutation of the rows, then the negatives of all its batches, [nb, B]
(JAX: one sub-key a batch, bpr.py:164-179).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset, detect_field_bins
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels.sgd_step import (LOSS_PAIR, StepMode,
                                              make_workspace, negative_ids,
                                              run_batches, sgd_apply,
                                              sgd_grad_scatter)
from svbfm_tpu_torch.learners.base import (FMConfig, TrajectoryFile,
                                           build_row_data)
from svbfm_tpu_torch.learners.draws import Draws, device_draws
from svbfm_tpu_torch.learners.sgd import (SGDState, _shuffled_batches, _sync,
                                          table, table_scores)
from svbfm_tpu_torch.models.fm import init_fm_params
from svbfm_tpu_torch.utils.rlog_schema import stream_row

_F32 = torch.float32


class BPRState(SGDState):
    """w0, the table (w | v^T) and the draw source, as ``SGDState``."""


def bpr_step_mode(cfg: FMConfig) -> StepMode:
    """bpr.py:78-112: rate min(lr, 1), the shrink bases max(1 - lr reg, 0)
    and w0's max(1 - reg0, 0), each in float64 as JAX forms these Python
    numbers."""
    lr = cfg.learn_rate
    return StepMode(loss=LOSS_PAIR, K=cfg.num_factor, k0=cfg.k0, k1=cfg.k1,
                    lr=lr, base_w=max(1.0 - lr * cfg.regw, 0.0),
                    base_v=max(1.0 - lr * cfg.regv, 0.0),
                    w0_base=max(1.0 - cfg.reg0, 0.0), w0_grad=False)


def bpr_pair_update(state: BPRState, ids, vals, valid, neg, lo: int, hi: int,
                    m: StepMode, ws) -> None:
    """One minibatch of pairs (bpr.py:68-113), in place: X9a's pair mode,
    then X9b.  ``neg`` [B] are the rows' sampled items in [lo, hi)."""
    sgd_grad_scatter(state.tab, state.w0, ids, vals, torch.zeros_like(valid),
                     valid, ws, m, pair=(neg, lo, hi))
    sgd_apply(state.tab, state.w0, ws, m, ids, neg)


class BPRLearner:
    """Implicit-feedback pairwise ranking trainer on one device.
    ``neg_field`` picks the field the negatives come from (default the
    last); the field layout comes from ``detect_field_bins``."""

    method = "bpr"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None, *,
                 device, neg_field: int = -1, out_dir: str = ".",
                 write_files: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        self.meta = meta if meta is not None else DataMetaInfo(
            cfg.num_attributes)
        color = detect_field_bins(train.to_coo(), cfg.num_attributes)
        if color is None:
            raise ValueError("bpr needs one-hot field data (to sample "
                             "negative items from a field)")
        fields = int(color.max()) + 1
        f = fields + neg_field if neg_field < 0 else neg_field
        in_f = np.where(color == f)[0]
        self.neg_lo, self.neg_hi = int(in_f.min()), int(in_f.max()) + 1
        self.train_row, self.train_n = build_row_data(train, self.device)
        self.test_row, self.test_n = build_row_data(test, self.device)
        self.out_dir = out_dir
        self.write_files = write_files
        self.num_batches = max(1, cfg.num_batches)
        self.mode = bpr_step_mode(cfg)
        self.ws = make_workspace(cfg.num_attributes, cfg.num_factor,
                                 self.device)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   draws: Optional[Draws] = None) -> BPRState:
        """v ~ init_stdev N(0, 1), w = 0, w0 = 0, as ``SGDLearner``."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        if draws is None:
            draws = device_draws(cfg.seed, self.device)
        p = init_fm_params(generator, cfg.num_attributes, cfg.num_factor,
                           init_stdev=cfg.init_stdev)
        return self.state_from_params(p.w0, p.w, p.v, draws)

    def state_from_params(self, w0, w, v, draws: Draws) -> BPRState:
        return BPRState(w0=torch.as_tensor(w0, dtype=_F32).to(self.device),
                        tab=table(w, v).to(self.device), draws=draws)

    def epoch(self, state: BPRState, it: int = 0) -> BPRState:
        """One epoch of pair batches, in place on ``state``."""
        nb = self.num_batches
        n = self.train_row.ids.shape[0]
        batches = _shuffled_batches(self.train_row,
                                    state.draws.permutation(n), nb)
        negs = state.draws.randint((nb, batches[0].shape[1]), self.neg_lo,
                                   self.neg_hi)
        run_batches(state.tab, state.w0, batches, self.ws, self.mode,
                    negs=negs, pair_range=(self.neg_lo, self.neg_hi))
        return state

    def eval_negatives(self, draws: Optional[Draws] = None) -> torch.Tensor:
        """The test rows' fixed negatives [N_test]."""
        if draws is None:
            draws = device_draws(self.cfg.seed + 17, self.device)
        return draws.randint((self.test_row.ids.shape[0],), self.neg_lo,
                             self.neg_hi)

    def eval_pairs(self, state: BPRState, neg: torch.Tensor):
        """(pair accuracy, mean pair loss) on the test rows, as device
        scalars (bpr.py:190-201)."""
        trow, cfg = self.test_row, self.cfg
        ids_n, _ = negative_ids(trow.ids, neg, self.neg_lo, self.neg_hi)
        p_pos = table_scores(state, trow.ids, trow.vals, cfg)
        p_neg = table_scores(state, ids_n, trow.vals, cfg)
        nt = float(self.test_n)
        hits = torch.sum((p_pos > p_neg).to(_F32) * trow.valid)
        loss = torch.sum(-torch.log(torch.sigmoid(p_pos - p_neg) + 1e-12)
                         * trow.valid)
        return hits / nt, loss / nt

    def predict_test_scores(self, state: BPRState) -> np.ndarray:
        s = table_scores(state, self.test_row.ids, self.test_row.vals,
                         self.cfg)
        return s.cpu().numpy()[: self.test_n]

    def run(self, state: Optional[BPRState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            eval_draws: Optional[Draws] = None):
        """``num_iter`` epochs from a copy of ``state``, each followed by the
        pair eval; ``eval_draws`` gives the fixed eval negatives (default:
        a device source seeded with ``cfg.seed + 17``)."""
        cfg = self.cfg
        state = self.init_state() if state is None else state.copy()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        traj = TrajectoryFile("test_rmse", cfg, self.method, self.out_dir,
                              self.write_files)
        neg = self.eval_negatives(eval_draws)
        history = []
        for it in range(num_iter):
            t0 = time.perf_counter()
            state = self.epoch(state, it)
            _sync(self.device)
            acc, loss = (float(a) for a in self.eval_pairs(state, neg))
            rec = {"iter": it, "accuracy": acc, "pair_loss": loss,
                   "time_learn": time.perf_counter() - t0, "time_pred": 0.0}
            traj.append(acc)
            if verbose:
                print(f"#Iter={it:3d}\tPairAcc={acc:.6g}\tLoss={loss:.6g}")
            stream_row(self, rec)
            history.append(rec)
        return state, history
