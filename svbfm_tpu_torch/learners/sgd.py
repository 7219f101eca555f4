"""Minibatch SGD, SGDA and in-memory streaming SGD, on one device.

Counterpart of ``svbfm_tpu/learners/sgd.py``, for regression, classification
(the logistic multiplier y (sigmoid(y p) - 1), an accuracy eval) and the
Poisson task (exp(clamped p) - y, the same eval): ``SGDLearner``
(``-method sgd``), ``SGDALearner`` (adaptive regularisation, ``-method
sgda``) and ``SGDOnlineLearner`` (``-method sgd_online``, chunks of the
in-memory train set, or streamed from a binary file).  The math and its order are the JAX package's: every
row of a minibatch is scored with the parameters from before the batch, and
a parameter touched c times takes the net of c per-example steps, the
regularisation shrink max(1 - lr reg, 0)^c and the summed gradient damped
by (1 - (1 - lr)^c) / c.  The execution is eager PyTorch around the
hand-written kernels of ``kernels/sgd_step.py``: X9a scatters a batch's
gradients, X9b applies them, X9c is SGDA's lambda step; K1 scores the test
set.

The learners keep the parameters as one row-major table ``tab`` [D, 1+K] =
(w | v^T) and a 0-d ``w0``, which K1 and X9a read; the JAX [K, D] layout
shows only at the edges (``state.v``, the converters, ``v_file.txt``).  An
epoch gathers its shuffled rows once; its batches are views of that gather,
and the ``n mod num_batches`` rows left over are dropped, as JAX drops them.
Epochs update the state's tensors in place; ``run`` starts from a copy, so
the state a caller passes in is left as it was.

Every random number comes from the state's draw source
(``learners/draws.py``): one permutation an epoch (SGDA: one of the train
rows, then one of the validation rows; sgd_online: one per chunk), called
as JAX splits its key, so a test source can replay JAX's key chain.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.stream import chunk_bounds, read_window
from svbfm_tpu_torch.kernels.fm_forward import fm_scores_op
from svbfm_tpu_torch.kernels.sgd_step import (LOSS_CLASSIFICATION, LOSS_EXP,
                                              LOSS_POISSON, LOSS_REGRESSION,
                                              StepMode, Workspace,
                                              make_workspace, run_batches,
                                              sgd_apply, sgd_grad_scatter,
                                              sgda_lambda)
from svbfm_tpu_torch.learners.base import (TASK_CLASSIFICATION, TASK_POISSON,
                                           TASK_REGRESSION, FMConfig, RowData,
                                           TrajectoryFile, build_row_data,
                                           evaluate_regression)
from svbfm_tpu_torch.learners.draws import Draws, device_draws
from svbfm_tpu_torch.learners.streaming import DeviceFeed
from svbfm_tpu_torch.models.fm import init_fm_params
from svbfm_tpu_torch.ops.forward import fm_scores
from svbfm_tpu_torch.utils.checkpoint import resume
from svbfm_tpu_torch.utils.rlog_schema import stream_row

_F32 = torch.float32


@dataclass
class SGDState:
    w0: torch.Tensor  # scalar
    tab: torch.Tensor  # [D, 1+K] = (w | v^T)
    draws: Draws  # the random numbers (JAX: the key)

    @property
    def w(self) -> torch.Tensor:
        return self.tab[:, 0]

    @property
    def v(self) -> torch.Tensor:
        """[K, D], a view of the table."""
        return self.tab[:, 1:].T

    def copy(self):
        """The same state in new tensors (the draw source is shared)."""
        return type(self)(**{
            f.name: getattr(self, f.name).clone()
            if isinstance(getattr(self, f.name), torch.Tensor)
            else getattr(self, f.name) for f in dataclasses.fields(self)})


@dataclass
class SGDAState(SGDState):
    reg_w: torch.Tensor  # [G]
    reg_v: torch.Tensor  # [G, K]
    grad_tab: torch.Tensor  # [D, 1+K] last-seen (grad_w | grad_v^T)

    @property
    def grad_w(self) -> torch.Tensor:
        return self.grad_tab[:, 0]

    @property
    def grad_v(self) -> torch.Tensor:
        return self.grad_tab[:, 1:].T


def table(w, v) -> torch.Tensor:
    """(w [D], v [K, D]) -> the row-major table [D, 1+K]."""
    return torch.cat([w.to(_F32)[:, None], v.to(_F32).T], 1).contiguous()


def loss_mode(cfg: FMConfig) -> int:
    """X9a's loss for the task (sgd.py:87-100): the exponential family
    changes regression alone."""
    if cfg.task == TASK_CLASSIFICATION:
        return LOSS_CLASSIFICATION
    if cfg.task == TASK_POISSON:
        return LOSS_POISSON
    if cfg.task != TASK_REGRESSION:
        raise ValueError(f"unknown task {cfg.task}")
    return LOSS_EXP if cfg.exp_family else LOSS_REGRESSION


def shrink_base(lr: float, reg: float) -> float:
    """max(1 - lr reg, 0) in float32, as sgd.py:144 forms it."""
    return float(max(np.float32(1.0) - np.float32(lr) * np.float32(reg), 0.0))


def sgd_step_mode(cfg: FMConfig, mult_scale: float = 1.0,
                  reg0: Optional[float] = None) -> StepMode:
    """The step of ``sgd_epoch`` (scalar regs) or of SGDA's theta step
    (``mult_scale=2``, ``reg0=0``: its regs come per group)."""
    reg0 = cfg.reg0 if reg0 is None else reg0
    lr = cfg.learn_rate
    return StepMode(
        loss=loss_mode(cfg),
        K=cfg.num_factor, k0=cfg.k0, k1=cfg.k1, lr=lr, mult_scale=mult_scale,
        min_target=cfg.min_target, max_target=cfg.max_target,
        stdev=cfg.stdev, base_w=shrink_base(lr, cfg.regw),
        base_v=shrink_base(lr, cfg.regv), w0_base=1.0 - lr * reg0)


def sgd_minibatch_update(state: SGDState, ids, vals, y, valid, m: StepMode,
                         ws: Workspace, sgda=None) -> None:
    """One minibatch step (sgd.py:103-156), in place on the state's w0 and
    table: X9a scatters the batch's gradients, X9b applies them.  ``sgda``
    = (reg_w, reg_v, attr_group, grad_tab): SGDA's per-group regs, and the
    last-seen gradient caches it updates (the batch's last entry of an
    attribute wins, as XLA's scatter keeps it)."""
    sgd_grad_scatter(state.tab, state.w0, ids, vals, y, valid, ws, m,
                     record=sgda is not None)
    sgd_apply(state.tab, state.w0, ws, m, ids, sgda=sgda)


def sgda_lambda_update(state: SGDAState, attr_group, vids, vvals, vy, vvalid,
                       m: StepMode, ws: Workspace) -> None:
    """SGDA's lambda step on one validation batch (sgd.py:195-264), on X9c:
    in place on the state's reg_w and reg_v."""
    sgda_lambda(state.tab, state.grad_tab, state.w0, state.reg_w,
                state.reg_v, attr_group, vids, vvals, vy, vvalid, ws, m)


def _shuffled_batches(row: RowData, order: torch.Tensor, num_batches: int):
    """The rows ``order`` names, cut into [nb, bl, ...] batches
    (sgd.py:159-172): one gather, the batches views of it; the rows past
    bl * nb are dropped."""
    bl = order.shape[0] // num_batches
    idx = order[: bl * num_batches]
    P = row.ids.shape[1]
    return (row.ids.index_select(0, idx).view(num_batches, bl, P),
            row.vals.index_select(0, idx).view(num_batches, bl, P),
            row.target.index_select(0, idx).view(num_batches, bl),
            row.valid.index_select(0, idx).view(num_batches, bl))


def sgd_epoch(state: SGDState, row: RowData, num_batches: int, m: StepMode,
              ws: Workspace, rows: Optional[torch.Tensor] = None) -> SGDState:
    """One epoch (sgd.py:175-192) in place: a permutation from the draw
    source, then ``num_batches`` minibatch steps.  ``rows`` restricts the
    epoch to those rows of ``row`` (an sgd_online chunk)."""
    n = row.ids.shape[0] if rows is None else rows.shape[0]
    order = state.draws.permutation(n)
    if rows is not None:
        order = rows.index_select(0, order)
    run_batches(state.tab, state.w0, _shuffled_batches(row, order,
                                                       num_batches), ws, m)
    return state


def sgda_epoch(state: SGDAState, row: RowData, val_row: RowData,
               num_batches: int, attr_group, do_lambda: bool, m: StepMode,
               ws: Workspace) -> SGDAState:
    """One SGDA epoch (sgd.py:267-311) in place: per batch the theta step
    on train (X9a, X9b; mult_scale 2, reg0 = 0, 2 reg per group) with the
    last-seen gradient caches, then, unless ``do_lambda`` is off (iteration
    0), the lambda step on the validation batch of the same index (X9c)."""
    train_b = _shuffled_batches(row, state.draws.permutation(
        row.ids.shape[0]), num_batches)
    val_b = _shuffled_batches(val_row, state.draws.permutation(
        val_row.ids.shape[0]), num_batches)
    run_batches(state.tab, state.w0, train_b, ws, m,
                sgda=(state.reg_w, state.reg_v, attr_group, state.grad_tab),
                val_batches=val_b if do_lambda else None)
    return state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def table_scores(state: SGDState, ids, vals, cfg: FMConfig) -> torch.Tensor:
    """FM scores of rows from the table (K1); with k0 or k1 off, from the
    parameters with the switched-off terms left out."""
    if cfg.k0 and cfg.k1:
        return fm_scores_op(state.tab, state.w0, ids, vals)
    return fm_scores(state.w0, state.w, state.v, ids, vals, k0=cfg.k0,
                     k1=cfg.k1)


class SGDLearner:
    """Minibatch SGD on one device (``device`` is required: the learner
    runs where it is told and never moves itself)."""

    method = "sgd"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None, *,
                 device, out_dir: str = ".", write_files: bool = True):
        self.cfg = cfg
        self.device = torch.device(device)
        self.meta = meta if meta is not None else DataMetaInfo(
            cfg.num_attributes)
        self.train_row, self.train_n = build_row_data(train, self.device)
        self.test_row, self.test_n = build_row_data(test, self.device)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.out_dir = out_dir
        self.write_files = write_files
        bs = cfg.batch_size if cfg.batch_size > 0 else 1024
        self.num_batches = max(1, self.train_row.ids.shape[0] // max(1, bs))
        self.mode = self._step_mode()
        self.ws = make_workspace(cfg.num_attributes, cfg.num_factor,
                                 self.device)

    def _step_mode(self) -> StepMode:
        return sgd_step_mode(self.cfg)

    # ---- state ------------------------------------------------------------

    def state_from_params(self, w0, w, v, draws: Draws) -> SGDState:
        return SGDState(w0=torch.as_tensor(w0, dtype=_F32).to(self.device),
                        tab=table(w, v).to(self.device), draws=draws)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   draws: Optional[Draws] = None) -> SGDState:
        """v ~ init_stdev N(0, 1) from ``generator`` (a CPU generator seeded
        with ``cfg.seed`` by default), w = 0, w0 = 0 (init_fm_params);
        ``draws`` defaults to a generator on the learner's device seeded
        with ``cfg.seed``."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        if draws is None:
            draws = device_draws(cfg.seed, self.device)
        p = init_fm_params(generator, cfg.num_attributes, cfg.num_factor,
                           init_stdev=cfg.init_stdev)
        return self.state_from_params(p.w0, p.w, p.v, draws)

    def predict_test_scores(self, state: SGDState) -> np.ndarray:
        s = table_scores(state, self.test_row.ids, self.test_row.vals,
                         self.cfg)
        return s.cpu().numpy()[: self.test_n]

    # ---- one epoch --------------------------------------------------------

    def epoch(self, state: SGDState, it: int = 0) -> SGDState:
        """One epoch, in place on ``state``."""
        return sgd_epoch(state, self.train_row, self.num_batches, self.mode,
                         self.ws)

    def _eval_iter(self, state, it, rmse_file, history, verbose,
                   extra=None) -> None:
        cfg = self.cfg
        t0 = time.perf_counter()
        scores = self.predict_test_scores(state)
        rec = {"iter": it, "time_pred": time.perf_counter() - t0}
        rec.update(extra or {})
        if cfg.task != TASK_REGRESSION:
            # sgd.py:398-404: the sign of the score against the target's
            acc = float(np.mean((scores >= 0) == (self.test_target_np > 0)))
            rmse_file.append(acc)
            rec.update(accuracy=acc)
            if verbose:
                print(f"#Iter={it:3d}\tTest={acc:.6g}")
            history.append(rec)
            return
        rmse, mae = evaluate_regression(scores, self.test_target_np,
                                        cfg.min_target, cfg.max_target)
        rmse_file.append(rmse)
        rec.update(rmse=rmse, mae=mae)
        if verbose:
            if "rmse_train" in rec:  # SGDA prints Train= (adapt_reg.h:306)
                print(f"#Iter={it:3d}\tTrain={rec['rmse_train']:.6g}"
                      f"\tTest={rmse:.6g}")
            else:
                print(f"#Iter={it:3d}\tTest={rmse:.6g}")
        history.append(rec)

    def _replay_rng(self, epochs: int) -> None:
        """Advance the host generators past ``epochs`` finished epochs
        (none here; the streaming learner's chunk order)."""

    def run(self, state: Optional[SGDState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            ckpt=None, ckpt_every: int = 10):
        """``num_iter`` epochs from a copy of ``state`` (default: a fresh
        init), each followed by the test eval; ``time_learn`` is an epoch's
        wall time to a device synchronise.  ``ckpt`` (a
        ``utils.checkpoint.CheckpointManager``) resumes from its latest
        checkpoint (the draw source's generator state in it, the host
        generators replayed) and saves after every ``ckpt_every`` epochs
        counted from the resumed one and after the last (sgd.py:415-451).
        Returns (state, history)."""
        cfg = self.cfg
        state = self.init_state() if state is None else state.copy()
        num_iter = num_iter if num_iter is not None else cfg.num_iter
        state, it0 = resume(self, ckpt, state)
        self._replay_rng(it0)
        rmse_file = TrajectoryFile("test_rmse", cfg, self.method,
                                   self.out_dir,
                                   self.write_files and it0 == 0)
        history = []
        for it in range(it0, num_iter):
            t0 = time.perf_counter()
            state = self.epoch(state, it)
            _sync(self.device)
            self._eval_iter(state, it, rmse_file, history, verbose,
                            extra={"time_learn": time.perf_counter() - t0})
            stream_row(self, history[-1], state)
            if ckpt is not None and ((it + 1 - it0) % ckpt_every == 0
                                     or it + 1 >= num_iter):
                ckpt.save(state, it + 1, {"method": self.method})
        return state, history


class SGDALearner(SGDLearner):
    """Adaptive-regularisation SGD (``-method sgda``, WSDM'12): theta steps
    on train, lambda steps on the validation rows; iteration 0 takes no
    lambda steps (sgd.py:516-518).  The state starts from w = 0, zero
    regularisation and zero gradient caches (adapt_reg.h:269-281)."""

    method = "sgda"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, validation: SparseDataset,
                 meta: Optional[DataMetaInfo] = None, *, device,
                 out_dir: str = ".", write_files: bool = True):
        super().__init__(cfg, train, test, meta, device=device,
                         out_dir=out_dir, write_files=write_files)
        self.val_row, self.val_n = build_row_data(validation, self.device)
        self.attr_group = torch.from_numpy(
            self.meta.attr_group.astype(np.int32)).to(self.device)
        B = self.train_row.ids.shape[0] // self.num_batches
        self.ws = make_workspace(cfg.num_attributes, cfg.num_factor,
                                 self.device,
                                 sgda_batch=(B, self.train_row.ids.shape[1]))

    def _step_mode(self) -> StepMode:
        # mult = 2 (p - y), reg factor 2 reg, reg0 = 0 (adapt_reg.h:123-157)
        return sgd_step_mode(self.cfg, mult_scale=2.0, reg0=0.0)

    def state_from_params(self, w0, w, v, draws: Draws) -> SGDAState:
        base = super().state_from_params(w0, w, v, draws)
        G, K = self.cfg.num_groups, self.cfg.num_factor
        return SGDAState(
            w0=base.w0, tab=base.tab, draws=draws,
            reg_w=torch.zeros(G, dtype=_F32, device=self.device),
            reg_v=torch.zeros(G, K, dtype=_F32, device=self.device),
            grad_tab=torch.zeros_like(base.tab))

    def epoch(self, state: SGDAState, it: int = 0) -> SGDAState:
        return sgda_epoch(state, self.train_row, self.val_row,
                          self.num_batches, self.attr_group, it > 0,
                          self.mode, self.ws)

    def _row_rmse(self, state, row: RowData, n: int) -> float:
        s = table_scores(state, row.ids, row.vals, self.cfg)
        return evaluate_regression(s.cpu().numpy()[:n],
                                   row.target.cpu().numpy()[:n],
                                   self.cfg.min_target,
                                   self.cfg.max_target)[0]

    def _eval_iter(self, state, it, rmse_file, history, verbose,
                   extra=None) -> None:
        # the reference evaluates train and validation every iteration
        # (adapt_reg.h:300-341); the JAX learner does under regression
        ex = dict(extra or {})
        if self.cfg.task == TASK_REGRESSION:
            ex["rmse_train"] = self._row_rmse(state, self.train_row,
                                              self.train_n)
            ex["rmse_val"] = self._row_rmse(state, self.val_row, self.val_n)
        super()._eval_iter(state, it, rmse_file, history, verbose, extra=ex)


class SGDOnlineLearner(SGDLearner):
    """Streaming SGD over chunks of the in-memory train set (``-method
    sgd_online``): every epoch a permutation of the rows from
    ``np.random.default_rng(cfg.seed)`` (the JAX learner's numbers) is cut
    into ``cfg.num_batches`` chunks, and each chunk takes one
    ``sgd_epoch`` of rows // (batch_size or 1024) batches
    (sgd.py:576-667).  Out of core (``from_reader``), the chunks are the
    row windows of a binary file in the order of a permutation of
    min(num_batches, rows) from the same generator (sgd.py:576-590), each
    read by a reader thread and copied to the device while the chunk
    before it runs; at most two chunks live on the
    device (sgd.py:610-641)."""

    method = "sgd_online"
    reader = None  # the BinaryChunkReader of an out-of-core learner

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None, *,
                 device, out_dir: str = ".", write_files: bool = True):
        super().__init__(cfg, train, test, meta, device=device,
                         out_dir=out_dir, write_files=write_files)
        self.rng = np.random.default_rng(cfg.seed)

    @classmethod
    def from_reader(cls, cfg: FMConfig, reader, test: SparseDataset,
                    meta: Optional[DataMetaInfo] = None, *, device,
                    out_dir: str = ".", write_files: bool = True
                    ) -> "SGDOnlineLearner":
        """Out-of-core construction from a ``BinaryChunkReader``
        (sgd.py:560-574): no train rows are held, in host memory or on the
        device, beyond the chunks in flight."""
        self = cls.__new__(cls)
        self.cfg = cfg
        self.device = torch.device(device)
        self.meta = meta if meta is not None else DataMetaInfo(
            cfg.num_attributes)
        self.reader = reader
        self.train_n = reader.num_rows
        self.test_row, self.test_n = build_row_data(test, self.device)
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        self.out_dir = out_dir
        self.write_files = write_files
        self.mode = self._step_mode()
        self.ws = make_workspace(cfg.num_attributes, cfg.num_factor,
                                 self.device)
        self.rng = np.random.default_rng(cfg.seed)
        self.feed = DeviceFeed(self.device, 2, workers=1, staged=True)
        return self

    def _read_chunk(self, bounds, ci: int):
        """Row window ``ci``'s host arrays (a reader thread), the targets
        binarised under classification (sgd.py:582-584)."""
        ds = read_window(self.reader, bounds[ci], bounds[ci + 1],
                         self.reader.num_cols)
        if self.cfg.task == TASK_CLASSIFICATION:  # libfm.cpp:337-350
            ds.target = np.where(ds.target > 0, 1.0, -1.0).astype(np.float32)
        return (ds.ids, ds.vals, ds.target, np.ones(ds.num_rows, np.float32))

    def _stream_epoch(self, state: SGDState) -> SGDState:
        cfg = self.cfg
        order = self.rng.permutation(min(max(1, cfg.num_batches),
                                         self.reader.num_rows))
        bounds = chunk_bounds(self.reader.num_rows, len(order))
        bs = max(1, cfg.batch_size or 1024)
        for row in self.feed(
                [int(c) for c in order],
                lambda ci: self._read_chunk(bounds, ci),
                lambda host, put: RowData(*(put(a) for a in host))):
            sgd_epoch(state, row, max(1, row.ids.shape[0] // bs), self.mode,
                      self.ws)
        return state

    def _replay_rng(self, epochs: int) -> None:
        """The chunk orders of ``epochs`` finished epochs (sgd.py:600-608):
        one permutation an epoch, of the chunks out of core, of the rows in
        memory."""
        nb = max(1, self.cfg.num_batches)
        for _ in range(epochs):
            self.rng.permutation(min(nb, self.reader.num_rows)
                                 if self.reader is not None else self.train_n)

    def epoch(self, state: SGDState, it: int = 0) -> SGDState:
        cfg = self.cfg
        if self.reader is not None:
            return self._stream_epoch(state)
        n = self.train_n
        perm = torch.from_numpy(self.rng.permutation(n)).to(self.device)
        bs = max(1, cfg.batch_size or 1024)
        for part in np.array_split(np.arange(n), min(max(1, cfg.num_batches),
                                                     max(1, n))):
            rows = perm[part[0]:part[-1] + 1]
            sgd_epoch(state, self.train_row, max(1, len(part) // bs),
                      self.mode, self.ws, rows=rows)
        return state
