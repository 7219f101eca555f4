"""X9a-X9c: the SGD family's minibatch step (``csrc/sgd_step.cu``).

``sgd_grad_scatter`` (X9a) scores a batch from the parameters before it and
adds each entry's count and gradients into the accumulator ``acc`` [D, 2+K]
= (cnt | gw | gv) and ``acc0`` [2] = (n_eff, sum mult); ``sgd_apply`` (X9b)
takes the count-damped step on the table ``tab`` [D, 1+K] = (w | v^T) and
w0 and zeroes ``acc``/``acc0``; ``sgda_lambda`` (X9c) is SGDA's validation
step on the group regularisers.  X9b's kernel visits only the attributes
the batch names (``apply_entries``), since every other row's step is the
identity, each by the one entry that X9a recorded as its owner in the
workspace, unless the batch names at least D entries, where a second
kernel steps every attribute; its twin steps every row, as the JAX code
does.  On CUDA tensors each op launches its hand-written kernel; on CPU
tensors it runs the plain PyTorch twin beside it, the JAX arithmetic in
the same order (``index_add_`` for the scatters).  All three update their
outputs in place, kernel and twin alike.

``tp_sgd_scatter`` (T11) is X9a's kernel in its window mode for the
feature-sharded SGD: over one feature shard's table [D_loc, 1+K] (the ids
[lo, lo + D_loc)), the row scored from T1's partials summed over the
shards, only the window's entries added; ``sgd_apply_dense`` is X9b's
dense kernel over every row of a table, which the feature-sharded SGD runs
after the data all-reduce of the accumulator.

``run_batches`` drives an epoch's batches: it validates the tensors once
and then launches (or runs the twins) batch after batch, so the per-batch
host cost is the launches alone.

Replaces ``svbfm_tpu/learners/sgd.py:sgd_minibatch_update`` (:103-156),
``:sgda_lambda_update`` (:195-264) and the cache scatter of ``sgda_epoch``
(:287-294), ``svbfm_tpu/learners/bpr.py:bpr_pair_update`` (:68-113), and
``svbfm_tpu/parallel/tp_sgd.py:tp_sgd_minibatch_update`` (:91-131).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.kernels.mcmc_sweep import MAX_BLOCK_SMEM

_I32, _F32 = torch.int32, torch.float32

LOSS_REGRESSION, LOSS_EXP, LOSS_PAIR, LOSS_CLASSIFICATION, LOSS_POISSON = (
    0, 1, 2, 3, 4)


@dataclass(frozen=True)
class StepMode:
    """The constants of one learner's step.  ``base_w``/``base_v`` are the
    shrink bases max(1 - lr reg, 0) of the scalar-reg modes, computed by
    the learner as its JAX counterpart does; SGDA's group regs replace
    them with max(1 - lr 2 reg[g], 0) per attribute.  w0 shrinks
    by ``w0_base`` ** n_eff and, with ``w0_grad``, takes the damped sum of
    the multipliers."""

    loss: int
    K: int
    k0: bool = True
    k1: bool = True
    lr: float = 0.1
    mult_scale: float = 1.0
    min_target: float = -math.inf
    max_target: float = math.inf
    stdev: float = 1.0
    base_w: float = 1.0
    base_v: float = 1.0
    w0_base: float = 1.0
    w0_grad: bool = True

    @property
    def decay(self) -> float:
        """1 - rate, rate = min(lr mult_scale, 1), in float32 as JAX
        forms it (sgd.py:124-127)."""
        return f32_sub(1.0, min(self.lr * self.mult_scale, 1.0))


def f32_sub(a: float, b: float) -> float:
    """a - b rounded as float32 arithmetic rounds it."""
    return float(np.float32(a) - np.float32(b))


@dataclass
class Workspace:
    """Scratch that X9a and X9b keep zero (``winner`` at -1) between
    batches: the accumulators, and with SGDA the per-entry gradients of a
    batch of ``B`` rows and the winner per attribute; and ``owner``, which
    X9a writes for X9b at the attributes its batch names (one of the
    batch's entries naming each).  X9c needs no scratch: its sums stay in
    the shared memory of its one cluster."""

    acc: torch.Tensor  # [D, 2+K]
    acc0: torch.Tensor  # [2]
    owner: torch.Tensor  # int32 [D]
    gw_e: Optional[torch.Tensor] = None  # [B, P]
    gv_e: Optional[torch.Tensor] = None  # [B, P, K]
    winner: Optional[torch.Tensor] = None  # int32 [D]


def make_workspace(D: int, K: int, device, sgda_batch=None) -> Workspace:
    """``sgda_batch``: (B, P) of the batches whose entry gradients SGDA
    caches; None for the other learners."""
    ws = Workspace(acc=torch.zeros(D, 2 + K, dtype=_F32, device=device),
                   acc0=torch.zeros(2, dtype=_F32, device=device),
                   owner=torch.zeros(D, dtype=_I32, device=device))
    if sgda_batch is not None:
        B, P = sgda_batch
        ws.gw_e = torch.zeros(B, P, dtype=_F32, device=device)
        ws.gv_e = torch.zeros(B, P, K, dtype=_F32, device=device)
        ws.winner = torch.full((D,), -1, dtype=_I32, device=device)
    return ws


# ---- plain twins ------------------------------------------------------------

def apply_entries(ids, neg=None):
    """The attributes X9b's kernel visits for a batch of fewer entries
    than attributes, in its order (the entries' flat indices, which X9a
    records as owners): the batch's B P entries, then, in pair mode, its
    B sampled items ``neg``.  Every row X9a can write is among them (a
    negative row's ids are the positive row's or its sampled item)."""
    flat = ids.reshape(-1)
    return flat if neg is None else torch.cat([flat, neg.reshape(-1)])


def negative_ids(ids, neg, lo: int, hi: int):
    """BPR's negative rows (bpr.py:156-161): the item-field id of each row
    replaced by its sampled item; returns (ids_n, in_field)."""
    in_field = (ids >= lo) & (ids < hi)
    return torch.where(in_field, neg[:, None], ids), in_field


def _scores_sums(tab, w0, ids, vals, m: StepMode):
    """Scores [B] and the per-factor sums s [B, K] (ops/forward.py:30)."""
    g = tab[ids.long()]  # [B, P, 1+K]
    p = torch.zeros(ids.shape[0], dtype=_F32, device=tab.device)
    if m.k0:
        p = p + w0
    if m.k1:
        for q in range(ids.shape[1]):
            p = p + g[:, q, 0] * vals[:, q]
    d = g[:, :, 1:] * vals[:, :, None]
    s = d.sum(1)
    return p + 0.5 * (s * s - (d * d).sum(1)).sum(1), s, g[:, :, 1:]


def multiplier_plain(p, y, valid, m: StepMode):
    """The loss multiplier times valid (sgd.py:87-100): regression clamps
    the score to the target range, the exponential family scales it by
    1/stdev and does not clamp; classification is y (sigmoid(y p) - 1),
    Poisson exp(clamped p) - y."""
    if m.loss == LOSS_EXP:
        return m.mult_scale * (p / m.stdev - y) * valid
    if m.loss == LOSS_CLASSIFICATION:
        return m.mult_scale * y * (torch.sigmoid(y * p) - 1.0) * valid
    p = torch.clamp(p, m.min_target, m.max_target)
    if m.loss == LOSS_POISSON:
        return m.mult_scale * (torch.exp(p) - y) * valid
    return m.mult_scale * (p - y) * valid


def lambda_class_loss(m: StepMode) -> bool:
    """SGDA's lambda step takes the classification grad_loss
    y (sigmoid(y p) - 1) for every task but regression (sgd.py:226-229:
    the Poisson task falls in that branch too)."""
    return m.loss in (LOSS_CLASSIFICATION, LOSS_POISSON)


def _entry_grads(mult, s, vg, vals, m: StepMode):
    """Per-entry gradients: gw [B, P] and gv [B, P, K]."""
    gw = mult[:, None] * vals
    gv = mult[:, None, None] * (s[:, None, :] * vals[:, :, None]
                                - vg * (vals * vals)[:, :, None])
    return gw, gv


def _add_entries(acc, ids, cnt, gw, gv, m: StepMode):
    B, P = ids.shape
    cols = [cnt.reshape(-1, 1),
            (gw if m.k1 else torch.zeros_like(gw)).reshape(-1, 1),
            gv.reshape(B * P, m.K)]
    acc.index_add_(0, ids.reshape(-1).long(), torch.cat(cols, 1))


def sgd_grad_scatter_plain(tab, w0, ids, vals, y, valid, acc, acc0, owner,
                           m: StepMode, pair=None, sgda=None) -> None:
    """``owner`` [D] takes, at each attribute the batch names, the index of
    one entry naming it (``apply_entries``), as the kernel records it for
    X9b; ``pair`` = (neg [B] int32, lo, hi) for BPR; ``sgda`` = (gw_e
    [B, P], gv_e [B, P, K], winner [D]) to record SGDA's entry
    gradients."""
    p, s, vg = _scores_sums(tab, w0, ids, vals, m)
    if pair is not None:
        neg, lo, hi = pair
        ids_n, in_field = negative_ids(ids, neg, lo, hi)
        p_n, s_n, vg_n = _scores_sums(tab, w0, ids_n, vals, m)
        mult = -torch.sigmoid(-(p - p_n)) * valid
    else:
        mult = multiplier_plain(p, y, valid, m)
    touch = (vals != 0).to(_F32) * valid[:, None]
    gw, gv = _entry_grads(mult, s, vg, vals, m)
    _add_entries(acc, ids, touch, gw, gv, m)
    if pair is not None:
        diff = (ids_n != ids).to(_F32) * in_field.to(_F32) * valid[:, None]
        gw_n, gv_n = _entry_grads(-mult, s_n, vg_n, vals, m)
        _add_entries(acc, ids_n, diff, gw_n, gv_n, m)
    acc0 += torch.stack([valid.sum(), mult.sum()])
    entries = apply_entries(ids, None if pair is None else pair[0])
    owner[entries.long()] = torch.arange(entries.numel(), dtype=_I32,
                                         device=ids.device)
    if sgda is not None:
        gw_e, gv_e, winner = sgda
        gw_e.copy_(gw)
        gv_e.copy_(gv)
        B, P = ids.shape
        flat = torch.arange(B * P, dtype=_I32, device=ids.device)
        keep = ((vals != 0) & (valid[:, None] > 0)).reshape(-1)
        winner.scatter_reduce_(0, ids.reshape(-1).long(),
                               torch.where(keep, flat, -1), "amax")


def sgd_apply_plain(tab, w0, acc, acc0, m: StepMode, sgda=None) -> None:
    """``sgda`` = (reg_w [G], reg_v [G, K], attr_group [D], winner, gw_e,
    gv_e, grad_tab [D, 1+K]): the per-group regs and the last-seen
    caches.  Steps every row: a row whose accumulator is zero keeps its
    value (pow(base, 0) = 1, damp(0) = 0)."""
    cnt = acc[:, 0]
    cnt1 = torch.clamp(cnt, min=1.0)
    damp = (1.0 - torch.pow(m.decay, cnt)) / m.mult_scale
    if sgda is not None:
        reg_w, reg_v, attr_group, winner, gw_e, gv_e, grad_tab = sgda
        ag = attr_group.long()
        base_w = torch.clamp(1.0 - m.lr * (2.0 * reg_w[ag]), min=0.0)
        base_v = torch.clamp(1.0 - m.lr * (2.0 * reg_v[ag]), min=0.0)
        shrink_w = torch.pow(base_w, cnt)
        shrink_v = torch.pow(base_v, cnt[:, None])
    else:
        shrink_w = torch.pow(m.base_w, cnt)
        shrink_v = torch.pow(m.base_v, cnt)[:, None]
    if m.k1:
        tab[:, 0] = tab[:, 0] * shrink_w - damp * acc[:, 1] / cnt1
    tab[:, 1:] = (tab[:, 1:] * shrink_v
                  - damp[:, None] * acc[:, 2:] / cnt1[:, None])
    if m.k0:
        n, g0 = acc0[0], acc0[1]
        new = w0 * torch.pow(m.w0_base, n)
        if m.w0_grad:
            new = new - ((1.0 - torch.pow(m.decay, n)) / m.mult_scale
                         * g0 / torch.clamp(n, min=1.0))
        w0.copy_(new)
    acc.zero_()
    acc0.zero_()
    if sgda is not None:
        won = winner >= 0
        idx = torch.clamp(winner, min=0).long()
        flat_w = gw_e.reshape(-1)
        flat_v = gv_e.reshape(flat_w.shape[0], m.K)  # K = 0: no columns
        if flat_w.numel():
            grad_tab[:, 0] = torch.where(won, flat_w[idx], grad_tab[:, 0])
            grad_tab[:, 1:] = torch.where(won[:, None], flat_v[idx],
                                          grad_tab[:, 1:])
        winner.fill_(-1)


def tp_sgd_scatter_plain(tab, w0, ids, vals, y, valid, part, lo: int, acc,
                         acc0, m: StepMode) -> None:
    """T11's twin (``svbfm_tpu/parallel/tp_sgd.py:91-131``): ``tab``
    [D_loc, 1+K] holds the ids [lo, lo + D_loc), ``part`` [B, 1 + 2K] the
    rows' (lin | s | s2) partials summed over the feature shards.  p from
    the partials (lin left out with k1 off), the loss multiplier, and each
    entry inside the window adds its count, mult x and mult (s_f x - v_f
    x^2) (s_f global, v_f local) into ``acc`` [D_loc, 2+K] at id - lo; an
    entry outside adds nothing.  ``acc0`` [2] takes (n_eff, sum mult)."""
    K, D_loc = m.K, tab.shape[0]
    lid = ids.long() - lo
    inr = (lid >= 0) & (lid < D_loc)
    lidc = lid.clamp(0, max(D_loc - 1, 0))
    zero = torch.zeros((), dtype=_F32, device=tab.device)
    p = part[:, 0] if m.k1 else torch.zeros_like(part[:, 0])
    s = part[:, 1:1 + K]
    if K:
        p = p + 0.5 * (s * s - part[:, 1 + K:1 + 2 * K]).sum(1)
    if m.k0:
        p = p + w0
    mult = multiplier_plain(p, y, valid, m)
    touch = torch.where(inr, (vals != 0).to(_F32) * valid[:, None], zero)
    gw = torch.where(inr, mult[:, None] * vals, zero) if m.k1 \
        else torch.zeros_like(vals)
    vg = tab[lidc, 1:]  # [B, P, K]
    gv = torch.where(inr[:, :, None], mult[:, None, None] * (
        s[:, None, :] * vals[:, :, None] - vg * (vals * vals)[:, :, None]),
        zero)
    B, P = ids.shape
    acc.index_add_(0, lidc.reshape(-1), torch.cat(
        [touch.reshape(-1, 1), gw.reshape(-1, 1), gv.reshape(B * P, K)], 1))
    acc0 += torch.stack([valid.sum(), mult.sum()])


def sgda_lambda_plain(tab, grad_tab, w0, reg_w, reg_v, attr_group, ids,
                      vals, y, valid, m: StepMode) -> None:
    """SGDA's lambda step on one validation batch (sgd.py:195-264), in
    place on reg_w [G] and reg_v [G, K]."""
    G, K = reg_w.shape[0], m.K
    lr = m.lr
    il = ids.long()
    g_of = attr_group.long()[il]  # [B, P]
    tg, gg = tab[il], grad_tab[il]  # [B, P, 1+K]
    w_g, v_g = tg[:, :, 0], tg[:, :, 1:]
    rw_g, rv_g = reg_w[g_of], reg_v[g_of]
    vmask = (vals != 0).to(_F32) * valid[:, None]
    w_dash = w_g - lr * (gg[:, :, 0] + 2.0 * rw_g * w_g)
    v_dash = v_g - lr * (gg[:, :, 1:] + 2.0 * rv_g * v_g)
    p = torch.zeros(ids.shape[0], dtype=_F32, device=tab.device)
    if m.k0:
        p = p + w0
    if m.k1:
        p = p + (w_dash * vals * vmask).sum(-1)
    d = v_dash * vals[:, :, None] * vmask[:, :, None]
    p = p + 0.5 * ((d.sum(1)) ** 2 - (d * d).sum(1)).sum(-1)
    if lambda_class_loss(m):
        grad_loss = y * (torch.sigmoid(y * p) - 1.0)
    else:
        grad_loss = 2.0 * (torch.clamp(p, m.min_target, m.max_target) - y)
    grad_loss = grad_loss * valid
    n_v = valid.sum()
    scale_l = (1.0 - torch.pow(f32_sub(1.0, min(lr, 1.0)), n_v)) / (
        lr * torch.clamp(n_v, min=1.0))
    seg = torch.where(vmask > 0, g_of, G)  # a masked entry -> dropped segment
    B = ids.shape[0]
    xw = vals * w_g * vmask
    lwg = torch.zeros(B, G + 1, dtype=_F32, device=tab.device).scatter_add_(
        1, seg, xw)[:, :G]
    dreg_w = (grad_loss[:, None] * (-2.0 * lr) * lwg).sum(0)
    reg_w.copy_(torch.clamp(reg_w - lr * scale_l * dreg_w, min=0.0))

    x3, m3 = vals[:, :, None], vmask[:, :, None]
    xv = x3 * v_g * m3  # [B, P, K]
    xv_dash = x3 * v_dash * m3
    sum_f_dash = xv_dash.sum(1)  # [B, K]
    seg3 = seg[:, :, None].expand(B, ids.shape[1], K)

    def seg_sum(data):  # [B, P, K] -> [B, G, K]
        return torch.zeros(B, G + 1, K, dtype=_F32,
                           device=tab.device).scatter_add_(1, seg3, data)[:, :G]

    sum_f_g = seg_sum(xv)
    sum_fdf_g = seg_sum(xv_dash * v_g * x3 * m3)
    lvg = -2.0 * lr * (sum_f_dash[:, None, :] * sum_f_g - sum_fdf_g)
    dreg_v = (grad_loss[:, None, None] * lvg).sum(0)  # [G, K]
    reg_v.copy_(torch.clamp(reg_v - lr * scale_l * dreg_v, min=0.0))


# ---- wrappers ---------------------------------------------------------------

def _rows_at(batches, dev, name: str):
    """Validate (ids [nb, B, P], vals, y [nb, B], valid); return B, P and
    each tensor's (address, bytes a batch), so that batch b's pointers are
    a sum."""
    ids, vals, y, valid = batches
    nb, B, P = ids.shape
    req = build.require
    req(ids, _I32, (nb, B, P), dev, f"{name}.ids")
    req(vals, _F32, (nb, B, P), dev, f"{name}.vals")
    req(y, _F32, (nb, B), dev, f"{name}.y")
    req(valid, _F32, (nb, B), dev, f"{name}.valid")
    return B, P, [(t.data_ptr(), math.prod(t.shape[1:]) * 4)
                  for t in batches]


class _Steps:
    """X9a-X9c's launches on one set of tensors, validated once here, so a
    batch costs its launches alone.  ``batches`` and ``val_batches`` are
    (ids [nb, B, P], vals, y [nb, B], valid); ``negs`` [nb, B] are BPR's
    sampled items in ``pair_range``; ``sgda`` = (reg_w, reg_v, attr_group,
    grad_tab) are SGDA's group regs and last-seen caches, and need the
    workspace's SGDA scratch; ``record`` makes X9a write SGDA's entry
    gradients and winners into it.  ``ids`` [nb, B, P]: the batches X9b
    applies, where ``batches`` is not given."""

    def __init__(self, tab, w0, ws: Workspace, m: StepMode, batches=None,
                 negs=None, pair_range=None, sgda=None, record=False,
                 val_batches=None, ids=None):
        dev, D = tab.device, tab.shape[0]
        req = build.require
        req(tab, _F32, (D, 1 + m.K), dev, "sgd_step.tab")
        req(w0, _F32, (), dev, "sgd_step.w0")
        req(ws.acc, _F32, (D, 2 + m.K), dev, "workspace.acc")
        req(ws.acc0, _F32, (2,), dev, "workspace.acc0")
        req(ws.owner, _I32, (D,), dev, "workspace.owner")
        self.rows = self.val = self.negs = self.ids = None
        self.dense = False
        if batches is not None:
            self.rows = _rows_at(batches, dev, "sgd_step")
            ids = batches[0]
        if ids is not None:
            nb, B, P = ids.shape
            req(ids, _I32, (nb, B, P), dev, "sgd_step.ids")
            self.ids = (ids.data_ptr(), B * P)
            # a batch of at least D entries: every attribute, in fewer
            # threads than its entries (X9b's kernel takes no ids)
            self.dense = B * P + (B if negs is not None else 0) >= D
        if val_batches is not None:
            self.val = _rows_at(val_batches, dev, "sgd_step.val")
        if negs is not None:
            req(negs, _I32, (nb, B), dev, "sgd_step.negs")
            self.negs = (negs.data_ptr(), B)
        if record or (sgda is not None and self.ids is not None):
            if ws.gw_e is None:
                raise ValueError("SGDA's steps need the workspace's SGDA "
                                 "scratch: make_workspace(sgda_batch=...)")
            B, P = self.rows[:2] if self.rows is not None else ws.gw_e.shape
            req(ws.gw_e, _F32, (B, P), dev, "workspace.gw_e")
            req(ws.gv_e, _F32, (B, P, m.K), dev, "workspace.gv_e")
            req(ws.winner, _I32, (D,), dev, "workspace.winner")
        if sgda is not None:
            reg_w, reg_v, attr_group, grad_tab = sgda
            G = reg_w.shape[0]
            req(reg_w, _F32, (G,), dev, "sgda.reg_w")
            req(reg_v, _F32, (G, m.K), dev, "sgda.reg_v")
            req(attr_group, _I32, (D,), dev, "sgda.attr_group")
            req(grad_tab, _F32, (D, 1 + m.K), dev, "sgda.grad_tab")
            smem = 4 * (G * (1 + m.K) + 1)
            if smem > MAX_BLOCK_SMEM:
                raise ValueError(
                    f"sgda_lambda: {G} groups of {1 + m.K} sums need {smem} "
                    f"bytes of shared memory, more than the {MAX_BLOCK_SMEM} "
                    "one block may take")
        self.lib = build.load_library("sgd_step")
        self.stream = build.stream_of(tab)
        self.tab, self.w0, self.ws, self.m = tab, w0, ws, m
        self.lo, self.hi = pair_range if pair_range is not None else (0, 0)
        self.sgda, self.record = sgda, record

    def scatter(self, b: int) -> None:
        """X9a on batch b."""
        m, ws, rec = self.m, self.ws, self.record
        B, P, at = self.rows
        neg = self._neg(b)
        rc = self.lib.svbfm_sgd_grad_scatter(
            build.ptr(self.tab), m.K, build.ptr(self.w0),
            *(base + b * step for base, step in at), B, P,
            LOSS_PAIR if neg is not None else m.loss, int(m.k0), int(m.k1),
            m.mult_scale, m.min_target, m.max_target, m.stdev, neg, self.lo,
            self.hi, build.ptr(ws.acc), build.ptr(ws.acc0),
            _p(ws.gw_e) if rec else None, _p(ws.gv_e) if rec else None,
            _p(ws.winner) if rec else None, build.ptr(ws.owner), self.stream)
        build.check_launch(self.lib, rc, "sgd_grad_scatter")

    def _neg(self, b: int):
        """Batch b's sampled items (address), or None."""
        if self.negs is None:
            return None
        return self.negs[0] + 4 * b * self.negs[1]

    def apply(self, b: int) -> None:
        """X9b on the accumulated batch b: its entries' attributes."""
        m, ws, sg = self.m, self.ws, self.sgda
        ids, n_pos = self.ids
        if self.dense:
            entries = (None, self.tab.shape[0], None, 0)
        else:
            entries = (ids + 4 * b * n_pos, n_pos, self._neg(b),
                       0 if self.negs is None else self.negs[1])
        rc = self.lib.svbfm_sgd_apply(
            build.ptr(self.tab), m.K, build.ptr(ws.acc), m.lr, m.decay,
            m.mult_scale, m.base_w, m.base_v,
            *((build.ptr(sg[0]), build.ptr(sg[1]), build.ptr(sg[2]))
              if sg is not None else (None, None, None)),
            int(m.k0), int(m.k1), build.ptr(self.w0), build.ptr(ws.acc0),
            m.w0_base, int(m.w0_grad),
            *((build.ptr(ws.winner), build.ptr(ws.gw_e), build.ptr(ws.gv_e),
               build.ptr(sg[3])) if sg is not None
              else (None, None, None, None)),
            *entries, build.ptr(ws.owner), self.stream)
        build.check_launch(self.lib, rc, "sgd_apply")

    def lambda_step(self, b: int, max_blocks: int = 0) -> None:
        """X9c on validation batch b; ``max_blocks`` > 0 caps its cluster's
        blocks (a test pins the 8-block launch the kernel falls back to
        where the card holds no cluster of 16)."""
        m = self.m
        reg_w, reg_v, attr_group, grad_tab = self.sgda
        Bv, Pv, at = self.val
        rc = self.lib.svbfm_sgda_lambda(
            build.ptr(self.tab), build.ptr(grad_tab), m.K, build.ptr(self.w0),
            build.ptr(reg_w), build.ptr(reg_v), build.ptr(attr_group),
            reg_w.shape[0], *(base + b * step for base, step in at), Bv, Pv,
            m.lr, -2.0 * m.lr, f32_sub(1.0, min(m.lr, 1.0)), m.min_target,
            m.max_target, int(lambda_class_loss(m)), int(m.k0), int(m.k1),
            max_blocks, self.stream)
        build.check_launch(self.lib, rc, "sgda_lambda")


def _p(t):
    return None if t is None else build.ptr(t)


def _one(*ts):
    """One batch as an epoch of one: [1, ...] views."""
    return tuple(t[None] for t in ts)


def sgd_grad_scatter(tab, w0, ids, vals, y, valid, ws: Workspace,
                     m: StepMode, pair=None, record: bool = False) -> None:
    """X9a on one batch: ``pair`` = (neg [B], lo, hi) for BPR; ``record``
    writes SGDA's entry gradients and winners into ``ws``."""
    sgda = (ws.gw_e, ws.gv_e, ws.winner) if record else None
    if build.on_cpu(ids):
        return sgd_grad_scatter_plain(tab, w0, ids, vals, y, valid, ws.acc,
                                      ws.acc0, ws.owner, m, pair, sgda)
    with torch.cuda.device(ids.device):
        _Steps(tab, w0, ws, m, _one(ids, vals, y, valid),
               None if pair is None else pair[0][None],
               None if pair is None else pair[1:], record=record).scatter(0)


def sgd_apply(tab, w0, ws: Workspace, m: StepMode, ids, neg=None,
              sgda=None) -> None:
    """X9b after X9a on the batch ``ids`` [B, P] (and, in pair mode, its
    sampled items ``neg`` [B]): the kernel visits those attributes alone
    (``apply_entries``), each by the owner X9a recorded in ``ws``, or,
    where they are D or more, every attribute.  ``sgda`` = (reg_w, reg_v, attr_group, grad_tab)
    for SGDA's per-group regs and last-seen caches (the entry gradients
    and winners in ``ws``)."""
    if build.on_cpu(tab):
        extra = None
        if sgda is not None:
            reg_w, reg_v, attr_group, grad_tab = sgda
            extra = (reg_w, reg_v, attr_group, ws.winner, ws.gw_e, ws.gv_e,
                     grad_tab)
        return sgd_apply_plain(tab, w0, ws.acc, ws.acc0, m, extra)
    with torch.cuda.device(tab.device):
        _Steps(tab, w0, ws, m, sgda=sgda, ids=ids[None],
               negs=None if neg is None else neg[None]).apply(0)


def sgda_lambda(tab, grad_tab, w0, reg_w, reg_v, attr_group, ids, vals, y,
                valid, ws: Workspace, m: StepMode,
                max_blocks: int = 0) -> None:
    """X9c on one validation batch (``max_blocks``: see
    ``_Steps.lambda_step``)."""
    if build.on_cpu(ids):
        return sgda_lambda_plain(tab, grad_tab, w0, reg_w, reg_v, attr_group,
                                 ids, vals, y, valid, m)
    with torch.cuda.device(ids.device):
        _Steps(tab, w0, ws, m, sgda=(reg_w, reg_v, attr_group, grad_tab),
               val_batches=_one(ids, vals, y, valid)).lambda_step(
                   0, max_blocks)


def tp_sgd_scatter(tab, w0, ids, vals, y, valid, part, lo: int, acc, acc0,
                   m: StepMode) -> None:
    """T11 on one batch of a feature shard (``tp_sgd_scatter_plain``):
    kernel on CUDA tensors, plain twin on CPU tensors; adds into ``acc``
    and ``acc0`` in place.  Every loss but pair."""
    if build.on_cpu(ids):
        return tp_sgd_scatter_plain(tab, w0, ids, vals, y, valid, part, lo,
                                    acc, acc0, m)
    if m.loss == LOSS_PAIR:
        raise ValueError("tp_sgd_scatter: the pair loss has no window mode")
    dev, (B, P), D_loc, K = ids.device, ids.shape, tab.shape[0], m.K
    req = build.require
    req(tab, _F32, (D_loc, 1 + K), dev, "tp_sgd_scatter.tab")
    req(w0, _F32, (), dev, "tp_sgd_scatter.w0")
    req(ids, _I32, (B, P), dev, "tp_sgd_scatter.ids")
    req(vals, _F32, (B, P), dev, "tp_sgd_scatter.vals")
    req(y, _F32, (B,), dev, "tp_sgd_scatter.y")
    req(valid, _F32, (B,), dev, "tp_sgd_scatter.valid")
    req(part, _F32, (B, 1 + 2 * K), dev, "tp_sgd_scatter.part")
    req(acc, _F32, (D_loc, 2 + K), dev, "tp_sgd_scatter.acc")
    req(acc0, _F32, (2,), dev, "tp_sgd_scatter.acc0")
    lib = build.load_library("sgd_step")
    with torch.cuda.device(dev):
        rc = lib.svbfm_tp_sgd_scatter(
            build.ptr(tab), K, build.ptr(w0), build.ptr(ids),
            build.ptr(vals), build.ptr(y), build.ptr(valid), B, P,
            build.ptr(part), lo, D_loc, m.loss, int(m.k0), int(m.k1),
            m.mult_scale, m.min_target, m.max_target, m.stdev,
            build.ptr(acc), build.ptr(acc0), build.stream_of(ids))
    build.check_launch(lib, rc, "tp_sgd_scatter")


def sgd_apply_dense(tab, w0, acc, acc0, m: StepMode) -> None:
    """X9b's dense kernel on every row of ``tab`` [D, 1+K] from ``acc``
    [D, 2+K] and ``acc0`` [2], which it zeroes (a row whose accumulator is
    zero keeps its bits): the feature-sharded SGD's apply, whose window
    rows hold the entries of every data shard's batch.  Scalar regs; plain
    twin on CPU tensors."""
    if build.on_cpu(tab):
        return sgd_apply_plain(tab, w0, acc, acc0, m)
    dev, D = tab.device, tab.shape[0]
    req = build.require
    req(tab, _F32, (D, 1 + m.K), dev, "sgd_apply_dense.tab")
    req(w0, _F32, (), dev, "sgd_apply_dense.w0")
    req(acc, _F32, (D, 2 + m.K), dev, "sgd_apply_dense.acc")
    req(acc0, _F32, (2,), dev, "sgd_apply_dense.acc0")
    lib = build.load_library("sgd_step")
    with torch.cuda.device(dev):
        rc = lib.svbfm_sgd_apply(
            build.ptr(tab), m.K, build.ptr(acc), m.lr, m.decay,
            m.mult_scale, m.base_w, m.base_v, None, None, None, int(m.k0),
            int(m.k1), build.ptr(w0), build.ptr(acc0), m.w0_base,
            int(m.w0_grad), None, None, None, None, None, D, None, 0, None,
            build.stream_of(tab))
    build.check_launch(lib, rc, "sgd_apply")


def run_batches(tab, w0, batches, ws: Workspace, m: StepMode, negs=None,
                pair_range=None, sgda=None, val_batches=None) -> None:
    """One epoch's steps, in place on tab and w0: for each batch b of
    ``batches`` = (ids [nb, B, P], vals, y [nb, B], valid), X9a then X9b,
    and with ``val_batches`` (SGDA's lambda steps) X9c on validation batch
    b.  ``negs`` [nb, B] are BPR's sampled items in ``pair_range``;
    ``sgda`` = (reg_w, reg_v, attr_group, grad_tab) turns on SGDA's theta
    step.  The tensors are validated once; each batch then costs its
    launches."""
    nb = batches[0].shape[0]
    if build.on_cpu(tab):
        for b in range(nb):
            pair = None if negs is None else (negs[b], *pair_range)
            sgd_grad_scatter(tab, w0, *(t[b] for t in batches), ws, m, pair,
                             sgda is not None)
            sgd_apply(tab, w0, ws, m, batches[0][b],
                      None if negs is None else negs[b], sgda)
            if val_batches is not None:
                sgda_lambda(tab, sgda[3], w0, *sgda[:3],
                            *(t[b] for t in val_batches), ws, m)
        return
    with torch.cuda.device(tab.device):
        steps = _Steps(tab, w0, ws, m, batches, negs, pair_range, sgda,
                       sgda is not None, val_batches)
        for b in range(nb):
            steps.scatter(b)
            steps.apply(b)
            if val_batches is not None:
                steps.lambda_step(b)
