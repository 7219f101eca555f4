"""Feature-sharded (tensor-parallel) minibatch SGD over a (data, feature) mesh.

Counterpart of ``svbfm_tpu/parallel/tp_sgd.py`` on ``torch.distributed``,
built as ``parallel/tp_ovb.py`` is.  Each rank is one coordinate (d, f) of
the mesh (``parallel/mesh.py``): it holds the feature shard f of the table
``tab`` [D_loc, 1+K] = (w | v^T) (the ids [f D_loc, (f + 1) D_loc), zero
rows past D) and the data shard d of the train rows, and steps ONLY its
own rows.  A minibatch is three launches and two collectives:

* T1 (``kernels/fm_forward.py:tp_fm_partials``) writes the batch's
  (lin | s | s2) partials over the rank's window, and ONE all-reduce over
  the FEATURE group sums them: the scores' partials and the s_f of the
  v-gradient, which JAX psums a second time (``tp_sgd.py:125``), are the
  same channels;
* T11 (``kernels/sgd_step.py:tp_sgd_scatter``) scores each row from the
  summed partials (the square after the sum) and adds only the window's
  entries into the accumulator [D_loc, 2+K] and (n_eff, sum mult);
* ONE all-reduce over the DATA group sums accumulator and w0's pair (one
  buffer): a window row may now hold another data shard's entries, so
* X9b runs dense over the D_loc rows (``sgd_apply_dense``; a row with no
  count keeps its bits), w0 stepped on every rank from the same sums.

Semantics: ``learners/sgd.py:SGDLearner``'s step (the damped relaxation of
the reference's per-example steps, ``fm_sgd.h:33-51``) with the rows
sharded as the JAX learner shards them: padded to a multiple of the data
shards, each data shard shuffled by its own permutation (``Draws.
permutation``'s shard arguments: every rank draws all Sd and keeps its
data shard's, so every feature shard of d sees the same batches), batches
of ``batch_size // Sd`` rows a shard; the trajectory depends on Sd alone.
JAX also pads data sets of 2M rows or more to Sd x ``ROW_QUANTUM``; the port
does not (ROADMAP queue 3, "Rows past 2M").  Every loss of X9a (regression,
classification, Poisson, the exponential family).  The learner keeps
``SGDLearner.run`` (rank 0 prints and writes the files); checkpoints hold
the global table without its padding, so a resume may change the mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels.fm_forward import tp_fm_partials
from svbfm_tpu_torch.kernels.sgd_step import (StepMode, sgd_apply_dense,
                                              tp_sgd_scatter)
from svbfm_tpu_torch.learners.base import FMConfig, RowData
from svbfm_tpu_torch.learners.sgd import (SGDLearner, SGDState,
                                          _shuffled_batches, table)
from svbfm_tpu_torch.parallel.mesh import Mesh, make_mesh2d
from svbfm_tpu_torch.parallel.tp import sharded_scores
from svbfm_tpu_torch.parallel.tp_vb import (gather_cols, gather_rows,
                                            shard_cols, shard_rows)

_F32 = torch.float32


def tp_sgd_minibatch_update(state: SGDState, ids, vals, y, valid,
                            m: StepMode, buf: torch.Tensor, mesh: Mesh,
                            lo: int, D_loc: int) -> None:
    """One minibatch step on a rank (``svbfm_tpu/parallel/tp_sgd.py:
    91-131``), in place on ``state.w0`` and ``state.tab`` (the window [lo,
    lo + D_loc)): T1, a feature all-reduce, T11, a data all-reduce of
    ``buf`` [D_loc (2+K) + 2] (acc | acc0, zero between batches: X9b
    zeroes it), X9b dense.  ids are global."""
    acc, acc0 = buf[:-2].view(D_loc, 2 + m.K), buf[-2:]
    part = mesh.all_reduce_feature(tp_fm_partials(
        state.tab, m.K, False, ids, vals, lo, D_loc))
    tp_sgd_scatter(state.tab, state.w0, ids, vals, y, valid, part, lo, acc,
                   acc0, m)
    mesh.all_reduce_data(buf)
    sgd_apply_dense(state.tab, state.w0, acc, acc0, m)


def tp_sgd_epoch(state: SGDState, row: RowData, num_batches: int,
                 m: StepMode, buf: torch.Tensor, mesh: Mesh, lo: int,
                 D_loc: int) -> SGDState:
    """One epoch on a rank (``tp_sgd.py:134-163``) in place: the data
    shard's permutation from the draw source, then ``num_batches``
    minibatch steps."""
    order = state.draws.permutation(row.ids.shape[0], mesh.d_index,
                                    mesh.n_data)
    batches = _shuffled_batches(row, order, num_batches)
    for b in range(num_batches):
        tp_sgd_minibatch_update(state, *(t[b] for t in batches), m, buf,
                                mesh, lo, D_loc)
    return state


class TPSGDLearner(SGDLearner):
    """Minibatch SGD with the table sharded over the feature group of a
    (data, feature) mesh of ranks (``-method sgd -feature_shards S``); each
    rank constructs it with the whole data and keeps its part.  ``mesh``
    None: a data-parallel mesh of every rank on ``device`` (one rank: the
    mesh (1, 1))."""

    method = "sgd"

    def __init__(self, cfg: FMConfig, train: SparseDataset,
                 test: SparseDataset, meta: Optional[DataMetaInfo] = None,
                 mesh: Optional[Mesh] = None, *, device="cuda",
                 out_dir: str = ".", write_files: bool = False):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh2d(device=device)
        self.device = self.mesh.device
        Sd, Sf = self.mesh.shape
        self.meta = meta if meta is not None else DataMetaInfo(
            cfg.num_attributes)
        D = cfg.num_attributes
        self.D_loc = -(-D // Sf)
        self.D_pad = self.D_loc * Sf
        self.lo = self.mesh.f_index * self.D_loc
        d = self.mesh.d_index
        self.train_row, self.rps = shard_rows(train, Sd, d, self.device)
        self.train_n = train.num_rows
        self.test_row, self.test_rps = shard_rows(test, Sd, d, self.device)
        self.test_n = test.num_rows
        self.test_target_np = np.asarray(test.target[: test.num_rows])
        bs = cfg.batch_size if cfg.batch_size > 0 else 1024
        self.num_batches = max(1, self.rps // max(1, bs // Sd))
        self.mode = self._step_mode()
        self.buf = torch.zeros(self.D_loc * (2 + cfg.num_factor) + 2,
                               dtype=_F32, device=self.device)
        self.out_dir = out_dir
        self.write_files = write_files and self.lead

    @property
    def lead(self) -> bool:
        """Whether this rank writes the files and prints (rank 0)."""
        return self.mesh.rank == 0

    # ---- state ------------------------------------------------------------

    def state_from_params(self, w0, w, v, draws) -> SGDState:
        """The rank's state from w0 and the whole w [D], v [K, D]: its
        window of the table (rows past D zero)."""
        tab = shard_cols(table(torch.as_tensor(w), torch.as_tensor(v)).T,
                         self.lo, self.D_loc, self.D_pad).T
        return SGDState(w0=torch.as_tensor(w0, dtype=_F32).to(self.device),
                        tab=tab.contiguous().to(self.device), draws=draws)

    def global_state(self, state: SGDState) -> SGDState:
        """The whole state on the host, the table [D_pad, 1+K] gathered by
        an all-reduce over every rank; every rank must call it."""
        tab = gather_cols(self.mesh, state.tab.T, self.lo, self.D_pad).T
        return SGDState(w0=state.w0.cpu(), tab=tab.contiguous().cpu(),
                        draws=state.draws)

    def predict_test_scores(self, state: SGDState) -> np.ndarray:
        """The scores of every test row (T1, a feature all-reduce, the
        finalize; the data shards' rows gathered); every rank must call
        it."""
        cfg = self.cfg
        s = sharded_scores(self.mesh.all_reduce_feature, state.w0, state.w,
                           state.v, self.test_row.ids, self.test_row.vals,
                           self.lo, self.D_loc, cfg.k0, cfg.k1)
        return gather_rows(self.mesh, s, self.test_rps).cpu().numpy()[
            : self.test_n]

    def epoch(self, state: SGDState, it: int = 0) -> SGDState:
        return tp_sgd_epoch(state, self.train_row, self.num_batches,
                            self.mode, self.buf, self.mesh, self.lo,
                            self.D_loc)

    # ---- checkpoints: the global table without its padding ------------------

    def _ckpt_state(self, state: SGDState) -> SGDState:
        g = self.global_state(state)
        return SGDState(w0=g.w0, tab=g.tab[: self.cfg.num_attributes],
                        draws=state.draws)

    def _resume(self, ckpt, state: SGDState):
        if ckpt is None:
            return state, 0
        restored = ckpt.restore_latest(self._ckpt_state(state))
        if restored is None:
            return state, 0
        g, done, _meta = restored
        return self.state_from_params(g.w0, g.w, g.v, g.draws), done

    def _save(self, ckpt, state: SGDState, done: int) -> None:
        g = self._ckpt_state(state)
        if self.lead:
            ckpt.save(g, done, {"method": self.method})
        self.mesh.barrier()

    # ---- training loop ----------------------------------------------------

    def run(self, state: Optional[SGDState] = None,
            num_iter: Optional[int] = None, verbose: bool = True,
            ckpt=None, ckpt_every: int = 10):
        """``SGDLearner.run`` on every rank; rank 0 prints, writes the files
        and saves the checkpoints."""
        return super().run(state, num_iter, verbose and self.lead, ckpt,
                           ckpt_every)
