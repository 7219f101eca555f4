"""Bring a state of the JAX package into the port.

``jax.random`` bits cannot be reproduced in torch, so tests that hold the
two packages to each other start both from the same parameters: the JAX
learner's ``VBState`` (or ``OVBState``, ``MCMCState``, ``SGDState``,
``SGDAState``, ``BPRState``, ``TPVBState``, the feature-sharded learners'
``MCMCState``, ``TPOVBState`` and ``TPSGDState``, or exp_sgd's tuple (w0,
w, v)), fetched
to numpy with
``jax.device_get``, becomes the port's state of the same name (a
feature-sharded state: one rank's part of it).
A block-structure state is an ``MCMCState`` over the joined attributes.
Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from svbfm_tpu_torch.learners.bpr import BPRState
from svbfm_tpu_torch.learners.draws import Draws
from svbfm_tpu_torch.learners.exp_sgd import ExpSGDState
from svbfm_tpu_torch.learners.mcmc import TENSOR_FIELDS, MCMCState
from svbfm_tpu_torch.learners.sgd import SGDAState, SGDState, table
from svbfm_tpu_torch.learners.vb import VBState
from svbfm_tpu_torch.learners.vb_online import OVBState
from svbfm_tpu_torch.parallel.tp_ovb import SHARDED_TABLES
from svbfm_tpu_torch.parallel.tp_vb import TPVBState


def _tensors(np_state: Any, names, device) -> dict:
    if not isinstance(np_state, Mapping):
        np_state = {f.name: getattr(np_state, f.name)
                    for f in dataclasses.fields(np_state)}
    return {n: torch.from_numpy(np.array(np_state[n], dtype=np.float32)).to(
        device) for n in names}


def _from_jax(cls, np_state: Any, device):
    return cls(**_tensors(np_state, [f.name for f in dataclasses.fields(cls)],
                          device))


def state_from_jax(np_state: Any, device) -> VBState:
    """``np_state``: a mapping of VBState field names to numpy arrays, or a
    dataclass holding them (what ``jax.device_get`` returns)."""
    return _from_jax(VBState, np_state, device)


def ovb_state_from_jax(np_state: Any, device) -> OVBState:
    """The same for the online learner's ``OVBState`` (naturals and
    Robbins-Monro counters included)."""
    return _from_jax(OVBState, np_state, device)


def mcmc_state_from_jax(np_state: Any, device, draws: Draws) -> MCMCState:
    """The Gibbs/ALS state; the JAX ``key`` is skipped and ``draws`` takes
    its place.  e keeps its length: the resident learner's padded train
    rows, or the windowed learner's windows of rows (``n_pad``)."""
    return MCMCState(**_tensors(np_state, TENSOR_FIELDS, device), draws=draws)


def _sgd_fields(np_state: Any, device) -> dict:
    t = _tensors(np_state, ("w0", "w", "v"), device)
    return dict(w0=t["w0"], tab=table(t["w"], t["v"]))


def sgd_state_from_jax(np_state: Any, device, draws: Draws) -> SGDState:
    """The SGD state (w0, w, v) as the port's table; the JAX ``key`` is
    skipped and ``draws`` takes its place."""
    return SGDState(**_sgd_fields(np_state, device), draws=draws)


def sgda_state_from_jax(np_state: Any, device, draws: Draws) -> SGDAState:
    """The SGDA state; the JAX package's per-shard gradient caches
    grad_w [S, D] and grad_v [S, K, D] give shard 0's as the table
    (grad_w | grad_v^T)."""
    t = _tensors(np_state, ("reg_w", "reg_v", "grad_w", "grad_v"), device)
    return SGDAState(**_sgd_fields(np_state, device), draws=draws,
                     reg_w=t["reg_w"], reg_v=t["reg_v"],
                     grad_tab=table(t["grad_w"][0], t["grad_v"][0]))


def bpr_state_from_jax(np_state: Any, device, draws: Draws) -> BPRState:
    return BPRState(**_sgd_fields(np_state, device), draws=draws)


def exp_sgd_state_from_jax(np_state: Any, device) -> ExpSGDState:
    """The full-batch exp_sgd state: the JAX learner's tuple (w0, w, v)."""
    w0, w, v = (torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
                for a in np_state)
    return ExpSGDState(w0=w0, w=w, v=v)


def tp_vb_state_from_jax(np_state: Any, device, *, d: int, f: int,
                         n_data: int, D_loc: int) -> TPVBState:
    """The feature-sharded VB state of rank (d, f) of a mesh of ``n_data``
    data shards: JAX keeps the ``TPVBState`` as global arrays, the tables
    padded to D_pad over the feature (last) dim and e/t over the padded
    rows; the rank takes the feature slice [f D_loc, (f + 1) D_loc) of the
    tables and data slice d of e and t."""
    t = _tensors(np_state, [fl.name for fl in dataclasses.fields(TPVBState)],
                 "cpu")
    for k in ("mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash"):
        t[k] = t[k][..., f * D_loc:(f + 1) * D_loc]
    rps = t["e"].shape[0] // n_data
    for k in ("e", "t"):
        t[k] = t[k][d * rps:(d + 1) * rps]
    return TPVBState(**{k: v.contiguous().to(device) for k, v in t.items()})


def tp_mcmc_state_from_jax(np_state: Any, device, draws: Draws, *, d: int,
                           f: int, n_data: int, D_loc: int) -> MCMCState:
    """The feature-sharded Gibbs/ALS state of rank (d, f) of a mesh of
    ``n_data`` data shards: JAX keeps the ``MCMCState`` of its
    ``TPMCMCLearner`` as global arrays, w [D_pad] and v [K, D_pad] padded
    over the feature (last) dim and e over the padded rows; the rank takes
    the feature slice [f D_loc, (f + 1) D_loc) of the tables and data slice
    d of e.  The JAX ``key`` is skipped and ``draws`` takes its place."""
    t = _tensors(np_state, TENSOR_FIELDS, "cpu")
    for k in ("w", "v"):
        t[k] = t[k][..., f * D_loc:(f + 1) * D_loc]
    rps = t["e"].shape[0] // n_data
    t["e"] = t["e"][d * rps:(d + 1) * rps]
    return MCMCState(**{k: v.contiguous().to(device) for k, v in t.items()},
                     draws=draws)


def tp_ovb_state_from_jax(np_state: Any, device, *, d: int, f: int,
                          D_loc: int) -> OVBState:
    """The feature-sharded online VB state of rank (d, f): JAX keeps its
    ``TPOVBState`` as global arrays, the ten tables padded to D_pad over
    the feature (last) dim; the rank takes their feature slice
    [f D_loc, (f + 1) D_loc), the scalars and group hyperparameters whole.
    The state holds no rows, so every data shard ``d`` takes the same."""
    del d  # the state has no data-sharded part
    t = _tensors(np_state, [fl.name for fl in dataclasses.fields(OVBState)],
                 "cpu")
    for k in SHARDED_TABLES:
        t[k] = t[k][..., f * D_loc:(f + 1) * D_loc]
    return OVBState(**{k: v.contiguous().to(device) for k, v in t.items()})


def tp_sgd_state_from_jax(np_state: Any, device, draws: Draws, *, d: int,
                          f: int, D_loc: int) -> SGDState:
    """The feature-sharded SGD state of rank (d, f): JAX keeps its
    ``TPSGDState`` as global arrays, w [D_pad] and v [K, D_pad] padded over
    the feature (last) dim; the rank takes their feature slice
    [f D_loc, (f + 1) D_loc) as its table (w | v^T) and w0 whole.  The JAX
    ``key`` is skipped and ``draws`` takes its place.  The state holds no
    rows, so every data shard ``d`` takes the same."""
    del d  # the state has no data-sharded part
    t = _tensors(np_state, ("w0", "w", "v"), "cpu")
    cols = slice(f * D_loc, (f + 1) * D_loc)
    return SGDState(w0=t["w0"].to(device),
                    tab=table(t["w"][cols], t["v"][:, cols]).to(device),
                    draws=draws)
