"""Batch scoring (serving) of trained FM models, on one device.

Counterpart of ``svbfm_tpu/serve.py:47-207``.  The reference serves one row
at a time through ``fm_model::predict`` (``fm_model.h:103-130``); here a
batch of padded rows is scored by one launch of K1a's kernel with the
output transform fused into it (``kernels/fm_forward.py:fm_serve_op``):
regression scores clamped to ``[min_target, max_target]`` on the finite
sides (``fm_learn_sgd.h:74-77``), classification scores mapped through the
probit link Phi (``fm_learn_mcmc.h:367-375``).

The parameters go to the device once, as K1a's padded table
(``ops/forward.py:score_table``).  On a CUDA device, host arrays flow
through a window of ``inflight`` slots, each a pinned host staging pair
(ids, vals), a pinned output and their device buffers:

* the host writes a batch straight into its slot's pinned staging and
  zeroes only the positions past the input's width (the rows past the
  batch are never read: the kernel launches on the batch's real rows);
* the copy to the device runs on a side stream and records an event; the
  kernel runs on the current stream after that event, and the result is
  copied back, without blocking, into the slot's pinned output, followed
  by the slot's second event;
* at most ``inflight`` batches are dispatched and not yet fetched: the
  oldest is drained (its event waited on, its rows copied out) *before*
  the next dispatch (``svbfm_tpu/serve.py:190-194``), and a slot is
  written again only after its drain.

On the CPU the same window runs the kernel's plain twin.  The fixed batch
shapes of the JAX scorer exist for XLA's compile cache, which the port
does not have; feature sharding over several GPUs is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.data.libfm_text import COOData
from svbfm_tpu_torch.kernels.fm_forward import (SERVE_CLAMP, SERVE_PROBIT,
                                                fm_serve_op)
from svbfm_tpu_torch.learners.base import TASK_CLASSIFICATION, TASK_REGRESSION
from svbfm_tpu_torch.ops.forward import _scalar, score_table

_F32 = torch.float32


class _Slot:
    """One batch's staging on a CUDA device: pinned host ids/vals/output,
    their device buffers, and the events of its two copies."""

    def __init__(self, rows: int, width: int, device: torch.device):
        self.ids = torch.empty((rows, width), dtype=torch.int32,
                               pin_memory=True)
        self.vals = torch.empty((rows, width), dtype=_F32, pin_memory=True)
        self.out = torch.empty(rows, dtype=_F32, pin_memory=True)
        self.d_ids = torch.empty((rows, width), dtype=torch.int32,
                                 device=device)
        self.d_vals = torch.empty((rows, width), dtype=_F32, device=device)
        self.d_out = torch.empty(rows, dtype=_F32, device=device)
        self.copied_in = torch.cuda.Event()
        self.copied_out = torch.cuda.Event()


class BatchScorer:
    """FM batch scorer on one device.

    Args:
      w0, w, v: trained parameters (scalar / [D] / [K, D]; any learner's
        point estimate: ``state.w0/w/v`` or VB's ``mu_0/mu_w/mu_v``),
        numpy arrays or tensors.
      k0, k1: whether w0 and w take part (``-dim``).
      task: TASK_REGRESSION (clamped scores) or TASK_CLASSIFICATION (probit
        probabilities).
      min_target/max_target: the regression clamp; a bound that is not
        finite leaves its side open.
      batch_rows: rows a batch.
      row_pad: the positions a row is padded to; ``None`` sizes it from
        each input.
      device: where the kernel runs (default ``cuda``; ``cpu`` runs its
        plain twin).
      feature_sharded: refused (several GPUs are ROADMAP.md queue 1,
        item 13).
      inflight: the most batches dispatched and not yet fetched.
    """

    def __init__(self, w0, w, v, *, k0: bool = True, k1: bool = True,
                 task: int = TASK_REGRESSION,
                 min_target: float = -np.inf, max_target: float = np.inf,
                 batch_rows: int = 1 << 20, row_pad: Optional[int] = None,
                 device="cuda", feature_sharded: bool = False,
                 inflight: int = 2):
        if feature_sharded:
            raise NotImplementedError(
                "feature_sharded: scoring with the tables sharded over "
                "several GPUs is not ported yet (ROADMAP.md queue 1, "
                "item 13)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchScorer: device cuda, but "
                               "torch.cuda.is_available() is False")
        self.k0, self.k1 = bool(k0), bool(k1)
        self.task = task
        self.min_target, self.max_target = float(min_target), float(max_target)
        self.mode = (SERVE_PROBIT if task == TASK_CLASSIFICATION
                     else SERVE_CLAMP)
        self.batch_rows = max(1, int(batch_rows))
        self.row_pad = row_pad
        self.inflight = max(1, int(inflight))
        w = torch.as_tensor(np.asarray(w, np.float32)).to(self.device)
        v = torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
        self.num_factor = int(v.shape[0])
        self._D = int(w.shape[0])
        self.tab = score_table(w, v, self.k1)
        self.w0 = _scalar(np.float32(w0), self.k0, self.tab)
        self._slots: list = []
        self._copy_stream = None

    @classmethod
    def from_state(cls, state, cfg, **kw):
        """Build from a learner state and its FMConfig, with the state's
        point parameters: ``w0/w/v`` for the SGD, MCMC and exp_sgd states,
        the variational means ``mu_0/mu_w/mu_v`` for VB and OVB's."""
        def get(*names):
            return next(getattr(state, n) for n in names
                        if hasattr(state, n))

        def host(a):
            return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a))
        kw.setdefault("k0", cfg.k0)
        kw.setdefault("k1", cfg.k1)
        kw.setdefault("task", cfg.task)
        kw.setdefault("min_target", cfg.min_target)
        kw.setdefault("max_target", cfg.max_target)
        return cls(host(get("w0", "mu_0")), host(get("w", "mu_w")),
                   host(get("v", "mu_v")), **kw)

    # ------------------------------------------------------------------

    def score_device(self, ids: torch.Tensor, vals: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Predictions [N] of rows already on the scorer's device (int32 /
        float32 [N, P]), on the current stream, not synchronised."""
        return fm_serve_op(self.tab, self.w0, ids, vals, self.mode,
                           self.min_target, self.max_target, out=out)

    def _width(self, P_in: int) -> int:
        P_row = self.row_pad if self.row_pad is not None else max(P_in, 1)
        if P_in > P_row:
            raise ValueError(f"rows have {P_in} nnz > row_pad={P_row}")
        return P_row

    def _slot(self, k: int, width: int) -> _Slot:
        """Slot ``k`` of the window at ``width`` positions (made anew when
        the width changes)."""
        while len(self._slots) <= k:
            self._slots.append(None)
        s = self._slots[k]
        if s is None or s.ids.shape != (self.batch_rows, width):
            s = self._slots[k] = _Slot(self.batch_rows, width, self.device)
        return s

    def _dispatch(self, k: int, ids: np.ndarray, vals: np.ndarray,
                  width: int):
        """Start batch ``ids``/``vals`` [n, P_in] in window slot ``k``;
        returns the handle ``_fetch`` takes."""
        n, P_in = ids.shape
        if self.device.type == "cpu":
            bi = np.zeros((n, width), np.int32)
            bv = np.zeros((n, width), np.float32)
            bi[:, :P_in] = ids
            bv[:, :P_in] = vals
            return self.score_device(torch.from_numpy(bi),
                                     torch.from_numpy(bv)).numpy(), n
        s = self._slot(k, width)
        # the slot's last batch was drained: its copies and kernel are done
        hi = s.ids.numpy()
        hv = s.vals.numpy()
        hi[:n, :P_in] = ids
        hv[:n, :P_in] = vals
        if width > P_in:  # the tail of the row pad; rows past n are unread
            hi[:n, P_in:] = 0
            hv[:n, P_in:] = 0.0
        cur = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        cs = self._copy_stream
        with torch.cuda.stream(cs):
            s.d_ids[:n].copy_(s.ids[:n], non_blocking=True)
            s.d_vals[:n].copy_(s.vals[:n], non_blocking=True)
            s.copied_in.record(cs)
        cur.wait_event(s.copied_in)
        self.score_device(s.d_ids[:n], s.d_vals[:n], out=s.d_out[:n])
        s.out[:n].copy_(s.d_out[:n], non_blocking=True)
        s.copied_out.record(cur)
        return s, n

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        """The predictions of a dispatched batch (waits for it): on a card
        a view of its slot's pinned output, to be copied out before the
        slot's next dispatch."""
        res, n = handle
        if isinstance(res, np.ndarray):
            return res
        res.copied_out.synchronize()
        return res.out.numpy()[:n]

    def score_rows(self, ids: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """Score padded rows ids/vals [N, P] -> predictions [N] (numpy).

        Dispatches up to ``inflight`` batches before fetching, so that the
        copies of one batch overlap the scoring of another."""
        ids = np.ascontiguousarray(ids, np.int32)
        vals = np.ascontiguousarray(vals, np.float32)
        N, P_in = ids.shape
        width = self._width(P_in)
        out = np.empty((N,), np.float32)
        if N == 0:
            return out
        window = []  # (handle, first row)
        B = self.batch_rows
        for b, lo in enumerate(range(0, N, B)):
            # drain BEFORE dispatching: at most `inflight` batches are ever
            # dispatched and not fetched, and the slot is free again
            if len(window) >= self.inflight:
                handle, start = window.pop(0)
                got = self._fetch(handle)
                out[start:start + len(got)] = got
            hi = min(N, lo + B)
            window.append((self._dispatch(b % self.inflight, ids[lo:hi],
                                          vals[lo:hi], width), lo))
        for handle, start in window:
            got = self._fetch(handle)
            out[start:start + len(got)] = got
        return out

    def score_coo(self, coo: COOData) -> np.ndarray:
        """Score a COO dataset (rows padded to its most nnz)."""
        from svbfm_tpu_torch.data.dataset import SparseDataset
        ds = SparseDataset.from_coo(coo, self._D)
        return self.score_rows(ds.ids[: coo.num_rows],
                               ds.vals[: coo.num_rows])
