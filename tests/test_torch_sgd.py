"""Minibatch SGD, sgd_online, exp_sgd_stoc and SGDA in the port (CPU twins of
X9a-X9c and K1) against the JAX package's ``svbfm_tpu.learners.sgd`` and
``exp_sgd``, and SGDA against the float64 ``SGDAOracle``.  Both packages
start from the JAX learner's init (``utils.convert.sgd_state_from_jax``,
``sgda_state_from_jax``) and use the same permutations: the test draw
sources replay each JAX learner's key chain (sgd.py:163-177, :271-273), and
the tests check that the chains end on the same key.

Tolerances, set from what was measured on this data (float32 sums taken in
another order; the worst is noted beside each):
  * one minibatch step against JAX: rtol 1e-5 / atol 1e-6 (it passes at
    rtol 1e-6 / atol 1e-7);
  * 3 epochs of a learner against JAX: rtol 1e-4 / atol 1e-6 on w0, w, v
    and SGDA's gradient caches, atol 1e-7 on the regs, rtol 1e-5 on the
    per-epoch RMSEs (measured: at most 6e-7 absolute on w0, w, v, 2.4e-6
    on the gradient caches, 1.5e-8 on the regs; 1.5e-7 relative on the
    RMSEs);
  * against SGDAOracle at batch size 1: test_sgd.py:162-166's own.
"""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import exp_sgd as jx
from svbfm_tpu.learners import sgd as js
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels import sgd_step as ks
from svbfm_tpu_torch.learners import exp_sgd as tx
from svbfm_tpu_torch.learners import sgd as ts
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.utils.convert import (sgd_state_from_jax,
                                           sgda_state_from_jax)

from oracle import SGDAOracle


def _perm(key, n):
    return torch.from_numpy(np.asarray(
        jax.random.permutation(jax.random.fold_in(key, 0), n)).astype(
            np.int64))


class JaxSGDKeys:
    """Replays SGD's chain: an epoch (or an sgd_online chunk) splits the
    key and permutes with the sub-key folded with shard 0."""

    def __init__(self, key):
        self.key = key

    def permutation(self, n):
        self.key, sub = jax.random.split(self.key)
        return _perm(sub, n)


class JaxSGDAKeys:
    """Replays SGDA's chain: an epoch splits the key in three, the train
    permutation takes the second, the validation one the third."""

    def __init__(self, key):
        self.key, self._val = key, None

    def permutation(self, n):
        if self._val is None:
            self.key, k1, self._val = jax.random.split(self.key, 3)
            return _perm(k1, n)
        k2, self._val = self._val, None
        return _perm(k2, n)


def _data(num_rows=2000, num_users=30, num_items=25, seed=3):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    return coo, tr, te


def _cfgs(D, tr, K=4, **kw):
    """test_sgd.py:_setup's config in both packages."""
    base = dict(num_attributes=D, num_factor=K,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()), num_groups=2, seed=7,
                learn_rate=0.05, regw=0.01, regv=0.01, batch_size=128, **kw)
    return JConfig(**base), FMConfig(**base)


def _val_split(ds, n, cls):
    return cls(ids=ds.ids[:n], vals=ds.vals[:n], target=ds.target[:n],
               num_rows=n, num_features=ds.num_features,
               min_target=ds.min_target, max_target=ds.max_target,
               row_nnz=ds.row_nnz[:n])


def _pair(which, K=4, **kw):
    coo, tr, te = _data()
    D = coo.num_features
    jcfg, tcfg = _cfgs(D, tr, K, **kw)
    jmeta = JMeta.from_field_offsets(D, [0, 30])
    tmeta = DataMetaInfo.from_field_offsets(D, [0, 30])
    jtr, jte = JDataset.from_coo(tr, D), JDataset.from_coo(te, D)
    ttr, tte = SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D)
    common = dict(write_files=False)
    if which == "sgda":
        jl = js.SGDALearner(jcfg, jtr, jte, _val_split(jtr, 400, JDataset),
                            jmeta, mesh=make_mesh(1), **common)
        tl = ts.SGDALearner(tcfg, ttr, tte, _val_split(ttr, 400,
                                                       SparseDataset),
                            tmeta, device="cpu", **common)
        return jl, tl
    jcls, tcls = {"sgd": (js.SGDLearner, ts.SGDLearner),
                  "sgd_online": (js.SGDOnlineLearner, ts.SGDOnlineLearner),
                  "exp_sgd_stoc": (jx.ExpSGDStocLearner,
                                   tx.ExpSGDStocLearner)}[which]
    jl = jcls(jcfg, jtr, jte, jmeta, mesh=make_mesh(1), **common)
    tl = tcls(tcfg, ttr, tte, tmeta, device="cpu", **common)
    return jl, tl


PARAMS = ("w0", "w", "v")


def _assert_params(tstate, jstate, names, rtol=1e-4, atol=1e-6):
    for k in names:
        ref = np.asarray(getattr(jstate, k))
        if k in ("grad_w", "grad_v"):
            ref = ref[0]
        np.testing.assert_allclose(getattr(tstate, k).numpy(), ref,
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("which,cfg_kw", [
    ("sgd", {}), ("sgd", dict(K=0)), ("sgd", dict(k0=False, k1=False)),
    ("sgd_online", dict(num_batches=4)), ("exp_sgd_stoc", dict(stdev=1.5))])
def test_learner_epochs_match_jax(which, cfg_kw):
    jl, tl = _pair(which, **cfg_kw)
    jstate = jl.init_state()
    tstate = sgd_state_from_jax(jax.device_get(jstate), "cpu",
                                JaxSGDKeys(jstate.key))
    jend, jh = jl.run(jstate, num_iter=3, verbose=False)
    tend, th = tl.run(tstate, num_iter=3, verbose=False)
    assert len(th) == 3
    for a, b in zip(jh, th):
        for k in ("rmse", "mae"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    _assert_params(tend, jend, PARAMS)
    np.testing.assert_array_equal(np.asarray(tend.draws.key),
                                  np.asarray(jend.key))
    # run() started from a copy: the caller's state is unchanged
    np.testing.assert_array_equal(tstate.v.numpy(), np.asarray(jstate.v))
    assert th[-1]["rmse"] < th[0]["rmse"]


def test_sgda_epochs_match_jax_with_duplicate_id_caches():
    """3 SGDA iterations at batch 128 (iteration 0 without lambda steps):
    the parameters, the adapted regs and the last-seen gradient caches,
    where every batch holds many entries of one user (the batch's last
    entry of an attribute is kept, as XLA's CPU scatter keeps it), and the
    per-iteration train, validation and test RMSE."""
    jl, tl = _pair("sgda")
    jstate = jl.init_state()
    tstate = sgda_state_from_jax(jax.device_get(jstate), "cpu",
                                 JaxSGDAKeys(jstate.key))
    jend, jh = jl.run(jstate, num_iter=3, verbose=False)
    tend, th = tl.run(tstate, num_iter=3, verbose=False)
    for a, b in zip(jh, th):
        for k in ("rmse", "rmse_train", "rmse_val"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    _assert_params(tend, jend, PARAMS + ("grad_w", "grad_v"))
    _assert_params(tend, jend, ("reg_w", "reg_v"), rtol=1e-4, atol=1e-7)
    assert float(tend.reg_w.abs().sum() + tend.reg_v.abs().sum()) > 0
    np.testing.assert_array_equal(np.asarray(tend.draws.key),
                                  np.asarray(jend.key))


def _batch(seed=0, B=128, K=4, num_users=30):
    """A train batch of test_sgd.py's data with a padding row (valid 0) and
    an x = 0 entry; random parameters, caches and regs."""
    coo, tr, _ = _data()
    D = coo.num_features
    rng = np.random.default_rng(seed)
    ds = SparseDataset.from_coo(tr, D)
    ids, vals = ds.ids[:B].copy(), ds.vals[:B].copy()
    y = ds.target[:B].copy()
    valid = np.ones(B, np.float32)
    valid[-1] = 0.0
    vals[3, 1] = 0.0
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        D=D, K=K, ids=ids.astype(np.int32), vals=f32(vals), y=f32(y),
        valid=valid, w0=f32(0.3), w=f32(rng.normal(0, 0.1, D)),
        v=f32(rng.normal(0, 0.1, (K, D))),
        reg_w=f32(rng.uniform(0, 0.05, 2)),
        reg_v=f32(rng.uniform(0, 0.05, (2, K))),
        grad_w=f32(rng.normal(0, 0.1, D)),
        grad_v=f32(rng.normal(0, 0.1, (K, D))),
        attr_group=(np.arange(D) >= num_users).astype(np.int32),
        min_t=float(tr.target.min()), max_t=float(tr.target.max()))


CASES = {"regression": {}, "exp_family": dict(exp_family=True, stdev=1.7),
         "k0k1_off": dict(k0=False, k1=False), "K=0": dict(K=0),
         "sgda": dict(sgda=True),
         # X9a's classification and Poisson multipliers (the exponential
         # family changes neither), and X9c's classification grad_loss
         # under both tasks (sgd.py:87-100, :226-229)
         "classification": dict(task=1, exp_family=True),
         "poisson": dict(task=2),
         "sgda_classification": dict(sgda=True, task=1),
         "sgda_poisson": dict(sgda=True, task=2)}


@pytest.mark.parametrize("case", list(CASES))
def test_minibatch_update_matches_jax(case):
    """The port's sgd_minibatch_update (X9a + X9b twins) against JAX's
    inside a 1-device shard_map; in SGDA mode (mult_scale 2, per-group
    regs, reg0 = 0) also the cache scatter of duplicate ids and the lambda
    step (X9c's twin) on a validation batch."""
    kw = dict(CASES[case])
    sgda = kw.pop("sgda", False)
    b = _batch(K=kw.pop("K", 4))
    D, K = b["D"], b["K"]
    vb = _batch(seed=1, B=60)  # the validation batch
    if kw.get("task") == 1:  # +-1 targets, as the CLI binarises them
        for bt in (b, vb):
            bt["y"] = np.where(bt["y"] > 3, 1.0, -1.0).astype(np.float32)
            bt["min_t"], bt["max_t"] = -1.0, 1.0
    cfg_kw = dict(num_attributes=D, num_factor=K, min_target=b["min_t"],
                  max_target=b["max_t"], num_groups=2, learn_rate=0.05,
                  reg0=0.02, regw=0.01, regv=0.03, **kw)
    jcfg, tcfg = JConfig(**cfg_kw), FMConfig(**cfg_kw)
    lr = jcfg.learn_rate
    ag = jnp.asarray(b["attr_group"])
    rep = P()
    mesh = make_mesh(1)
    vb["ids"], vb["vals"], vb["y"] = (vb["ids"][::-1].copy(),
                                      vb["vals"][::-1].copy(),
                                      vb["y"][::-1].copy())

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(rep,) * 15,
             out_specs=(rep,) * 7)
    def jstep(w0, w, v, reg_w, reg_v, grad_w, grad_v, ids, vals, y, valid,
              vids, vvals, vy, vvalid):
        if sgda:
            regw_d = 2.0 * jnp.take(reg_w, ag)
            regv_d = 2.0 * jnp.take(reg_v, ag, axis=0).T
            w0, w, v, gw_e, gv_e = js.sgd_minibatch_update(
                w0, w, v, ids, vals, y, valid, jcfg, lr, 0.0, regw_d, regv_d,
                mult_scale=2.0)
            mask = (vals != 0) & (valid[:, None] > 0)
            ids_sc = jnp.where(mask, ids, D)
            grad_w = grad_w.at[ids_sc].set(gw_e, mode="drop")
            grad_v = grad_v.at[:, ids_sc].set(gv_e, mode="drop")
            reg_w, reg_v = js.sgda_lambda_update(
                w0, w, v, reg_w, reg_v, grad_w, grad_v, vids, vvals, vy,
                vvalid, jcfg, ag)
        else:
            w0, w, v, _, _ = js.sgd_minibatch_update(
                w0, w, v, ids, vals, y, valid, jcfg, lr, jcfg.reg0,
                jnp.full_like(w, jcfg.regw), jnp.full_like(v, jcfg.regv))
        return w0, w, v, reg_w, reg_v, grad_w, grad_v

    names = ("w0", "w", "v", "reg_w", "reg_v", "grad_w", "grad_v")
    want = jstep(*(jnp.asarray(b[k]) for k in names),
                 *(jnp.asarray(b[k]) for k in ("ids", "vals", "y", "valid")),
                 *(jnp.asarray(vb[k]) for k in ("ids", "vals", "y", "valid")))
    want = dict(zip(names, (np.asarray(a) for a in want)))

    t = {k: torch.from_numpy(np.array(b[k])) for k in b
         if isinstance(b[k], np.ndarray)}
    state = ts.SGDAState(w0=t["w0"], tab=ts.table(t["w"], t["v"]),
                         draws=None, reg_w=t["reg_w"], reg_v=t["reg_v"],
                         grad_tab=ts.table(t["grad_w"], t["grad_v"]))
    B, Pn = b["ids"].shape
    if sgda:
        mode = ts.sgd_step_mode(tcfg, mult_scale=2.0, reg0=0.0)
        ws = ks.make_workspace(D, K, "cpu", sgda_batch=(B, Pn))
        ts.sgd_minibatch_update(state, t["ids"], t["vals"], t["y"],
                                t["valid"], mode, ws,
                                (state.reg_w, state.reg_v, t["attr_group"],
                                 state.grad_tab))
        vt = {k: torch.from_numpy(np.array(vb[k]))
              for k in ("ids", "vals", "y", "valid")}
        ts.sgda_lambda_update(state, t["attr_group"], vt["ids"], vt["vals"],
                              vt["y"], vt["valid"], mode, ws)
        assert (ws.winner == -1).all()
    else:
        mode = ts.sgd_step_mode(tcfg)
        ws = ks.make_workspace(D, K, "cpu")
        ts.sgd_minibatch_update(state, t["ids"], t["vals"], t["y"],
                                t["valid"], mode, ws)
    assert not ws.acc.any() and not ws.acc0.any()  # X9b zeroes them
    for k in names:
        np.testing.assert_allclose(getattr(state, k).numpy(), want[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if K:
        assert not np.allclose(want["v"], b["v"])
    if sgda:  # duplicates: 128 rows of 30 users
        assert len(np.unique(b["ids"][:, 0])) < B
        assert not np.allclose(want["reg_v"], b["reg_v"])


@pytest.mark.parametrize("G,Pn,Bv,K", [(1, 1, 1, 1), (3, 4, 37, 8),
                                      (5, 6, 300, 20)])
def test_sgda_lambda_matches_jax(G, Pn, Bv, K):
    """X9c's twin against JAX's sgda_lambda_update inside a one-device
    shard_map, at one to five groups, one to six entries a row (several of
    one group in a row where P > G), one to 300 validation rows (the
    kernel's one-block, several-block and several-rows-a-warp regimes) and
    K = 1, 8, 20; x = 0 entries and a valid-0 row where a batch has more
    than one row.  Held with test_minibatch_update_matches_jax's
    tolerances."""
    rng = np.random.default_rng(10 * G + Pn)
    D, lr = 40, 0.05
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    attr_group = (np.arange(D) % G).astype(np.int32)
    ids = rng.integers(0, D, (Bv, Pn)).astype(np.int32)
    vals = f32(rng.uniform(0.5, 1.5, (Bv, Pn)))
    y = f32(rng.uniform(1, 5, Bv))
    valid = np.ones(Bv, np.float32)
    if Bv > 1:
        vals[::3, -1] = 0.0
        valid[1] = 0.0
    if Pn > G:
        groups = attr_group[ids]
        assert all(len(set(r)) < Pn for r in groups.tolist())
    b = dict(w0=f32(0.3), w=f32(rng.normal(0, 0.1, D)),
             v=f32(rng.normal(0, 0.1, (K, D))),
             reg_w=f32(rng.uniform(0, 0.05, G)),
             reg_v=f32(rng.uniform(0, 0.05, (G, K))),
             grad_w=f32(rng.normal(0, 0.1, D)),
             grad_v=f32(rng.normal(0, 0.1, (K, D))))
    cfg_kw = dict(num_attributes=D, num_factor=K, min_target=1.0,
                  max_target=5.0, num_groups=G, learn_rate=lr)
    jcfg, tcfg = JConfig(**cfg_kw), FMConfig(**cfg_kw)
    ag = jnp.asarray(attr_group)
    rep = P()

    @jax.jit
    @partial(jax.shard_map, mesh=make_mesh(1), in_specs=(rep,) * 11,
             out_specs=(rep, rep))
    def jlambda(w0, w, v, reg_w, reg_v, grad_w, grad_v, vids, vvals, vy,
                vvalid):
        return js.sgda_lambda_update(w0, w, v, reg_w, reg_v, grad_w, grad_v,
                                     vids, vvals, vy, vvalid, jcfg, ag)

    names = ("w0", "w", "v", "reg_w", "reg_v", "grad_w", "grad_v")
    want = [np.asarray(a) for a in jlambda(
        *(jnp.asarray(b[k]) for k in names),
        *(jnp.asarray(a) for a in (ids, vals, y, valid)))]
    t = {k: torch.from_numpy(np.array(a)) for k, a in b.items()}
    reg_w, reg_v = t["reg_w"].clone(), t["reg_v"].clone()
    ks.sgda_lambda_plain(ts.table(t["w"], t["v"]),
                         ts.table(t["grad_w"], t["grad_v"]), t["w0"], reg_w,
                         reg_v, torch.from_numpy(attr_group),
                         torch.from_numpy(ids), torch.from_numpy(vals),
                         torch.from_numpy(y), torch.from_numpy(valid),
                         ts.sgd_step_mode(tcfg, mult_scale=2.0, reg0=0.0))
    for got, ref, k in ((reg_w, want[0], "reg_w"), (reg_v, want[1], "reg_v")):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # (a lone entry has no pair terms: reg_v's gradient is 0 at P = 1)
    assert not np.allclose(want[0], b["reg_w"], rtol=0, atol=1e-9)
    assert (Pn == 1) == np.allclose(want[1], b["reg_v"], rtol=0, atol=1e-9)


def test_sgda_steps_match_oracle_at_batch_one():
    """test_sgd.py:88-168 on the port: per-example theta and lambda steps
    against the float64 SGDAOracle, with its data and tolerances."""
    coo = make_movielens_like(num_users=8, num_items=6, num_ratings=80,
                              rank=2, noise=0.4, seed=5)
    tr, va = train_test_split(coo, 0.4, seed=6)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 8])
    G, K, lr = meta.num_attr_groups, 3, 0.05
    cfg = FMConfig(num_attributes=D, num_factor=K,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), num_groups=G,
                   learn_rate=lr)
    rng = np.random.default_rng(1)
    w0, w = 0.0, np.zeros(D, np.float32)
    v = (0.1 * rng.standard_normal((K, D))).astype(np.float32)
    orc = SGDAOracle(D, K, G, meta.attr_group, lr, cfg.min_target,
                     cfg.max_target)
    orc.init(w0, w, v)
    state = ts.SGDAState(
        w0=torch.tensor(w0), tab=ts.table(torch.from_numpy(w),
                                          torch.from_numpy(v)),
        draws=None, reg_w=torch.zeros(G), reg_v=torch.zeros(G, K),
        grad_tab=torch.zeros(D, 1 + K))
    ag = torch.from_numpy(meta.attr_group.astype(np.int32))
    mode = ts.sgd_step_mode(cfg, mult_scale=2.0, reg0=0.0)
    ws = ks.make_workspace(D, K, "cpu", sgda_batch=(1, 2))

    def row_of(c, i):
        sel = c.row == i
        return c.col[sel].astype(np.int32), c.val[sel].astype(np.float32)

    one = torch.ones(1)
    for i in range(min(12, tr.num_rows, va.num_rows)):
        ti, tx_ = row_of(tr, i)
        vi, vx = row_of(va, i)
        ts.sgd_minibatch_update(
            state, torch.from_numpy(ti)[None], torch.from_numpy(tx_)[None],
            torch.tensor(tr.target[i:i + 1]), one, mode, ws,
            (state.reg_w, state.reg_v, ag, state.grad_tab))
        ts.sgda_lambda_update(state, ag, torch.from_numpy(vi)[None],
                              torch.from_numpy(vx)[None],
                              torch.tensor(va.target[i:i + 1]), one, mode, ws)
        orc.theta_step(ti, tx_, float(tr.target[i]))
        orc.lambda_step(vi, vx, float(va.target[i]))
    np.testing.assert_allclose(float(state.w0), orc.w0, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(state.w.numpy(), orc.w, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(state.v.numpy(), orc.v, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(state.grad_w.numpy(), orc.grad_w, rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(state.reg_w.numpy(), orc.reg_w, rtol=2e-3,
                               atol=1e-7)
    np.testing.assert_allclose(state.reg_v.numpy(), orc.reg_v, rtol=2e-3,
                               atol=1e-7)
    assert float(state.reg_v.abs().sum() + state.reg_w.abs().sum()) > 0


def test_sgda_lambda_nonfinite_loss_poisons_every_group():
    """JAX sums every group of every row (sgd.py:239-263): a row whose
    grad_loss is NaN makes every reg NaN, not only its own groups'."""
    b = _batch(B=4)
    D, K = b["D"], b["K"]
    cfg = FMConfig(num_attributes=D, num_factor=K, num_groups=3,
                   learn_rate=0.05)
    t = {k: torch.from_numpy(np.array(b[k])) for k in b
         if isinstance(b[k], np.ndarray)}
    y = t["y"].clone()
    y[0] = float("nan")
    reg_w, reg_v = torch.full((3,), 0.01), torch.full((3, K), 0.01)
    ks.sgda_lambda_plain(ts.table(t["w"], t["v"]),
                         ts.table(t["grad_w"], t["grad_v"]), t["w0"], reg_w,
                         reg_v, t["attr_group"], t["ids"], t["vals"], y,
                         t["valid"], ts.sgd_step_mode(cfg))
    assert torch.isnan(reg_w).all() and torch.isnan(reg_v).all()


def test_classification_and_poisson_refused():
    """The tasks choose X9a's loss (sgd.py:87-100): the exponential family
    changes regression alone; SGDA's lambda step (X9c) takes the
    classification grad_loss under both other tasks (sgd.py:226-229).  No
    task is refused any more; an unknown one raises."""
    cfg = FMConfig(num_attributes=5, num_factor=2, task=1)
    for task, exp, loss in ((0, False, ks.LOSS_REGRESSION),
                            (0, True, ks.LOSS_EXP),
                            (1, False, ks.LOSS_CLASSIFICATION),
                            (1, True, ks.LOSS_CLASSIFICATION),
                            (2, False, ks.LOSS_POISSON),
                            (2, True, ks.LOSS_POISSON)):
        m = ts.sgd_step_mode(dataclasses.replace(cfg, task=task,
                                                 exp_family=exp))
        assert m.loss == loss
        assert ks.lambda_class_loss(m) == (task != 0)
    with pytest.raises(ValueError, match="unknown task"):
        ts.sgd_step_mode(dataclasses.replace(cfg, task=3))


def test_exp_sgd_and_from_reader_refused():
    """The full-batch exp_sgd runs classification as JAX does, with no task
    branch (tests/test_torch_classification.py holds it to JAX), and
    refuses the Poisson task, naming its ROADMAP item; the out-of-core
    sgd_online streams a binary file's chunks (held to JAX in
    tests/test_torch_sgd_streaming.py)."""
    cfg = FMConfig(num_attributes=4, num_factor=2, task=2)
    with pytest.raises(NotImplementedError, match="item 15"):
        tx.ExpSGDLearner(cfg, None, None, device="cpu")
    coo, tr, te = _data(num_rows=200, num_users=8, num_items=6)
    D = coo.num_features
    tr.target = np.where(tr.target > 3, 1.0, -1.0).astype(np.float32)
    learner = tx.ExpSGDLearner(
        dataclasses.replace(cfg, num_attributes=D, task=1, min_target=-1.0,
                            max_target=1.0, learn_rate=0.5),
        SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
        device="cpu", write_files=False)
    _, h = learner.run(num_iter=1, verbose=False)
    assert np.isfinite(h[0]["rmse"])
    import tempfile

    from svbfm_tpu_torch.data.binary import save_coo_binary
    from svbfm_tpu_torch.data.stream import BinaryChunkReader

    with tempfile.TemporaryDirectory() as tmp:
        save_coo_binary(os.path.join(tmp, "tr"), tr)
        reader = BinaryChunkReader(os.path.join(tmp, "tr.x"),
                                   os.path.join(tmp, "tr.y"))
        online = ts.SGDOnlineLearner.from_reader(
            dataclasses.replace(cfg, num_attributes=D, task=0,
                                num_batches=3, learn_rate=0.05),
            reader, SparseDataset.from_coo(te, D), device="cpu",
            write_files=False)
        _, h = online.run(num_iter=1, verbose=False)
    assert np.isfinite(h[0]["rmse"])


def test_shuffled_batches_drop_the_remainder():
    """n = 13 rows into 4 batches: 3 rows each, the last row of the order
    dropped, as sgd.py:165-167."""
    from svbfm_tpu_torch.learners.base import RowData

    n = 13
    row = RowData(ids=torch.arange(2 * n, dtype=torch.int32).view(n, 2),
                  vals=torch.ones(n, 2), target=torch.arange(n * 1.0),
                  valid=torch.ones(n))
    order = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    ids, vals, y, valid = ts._shuffled_batches(row, order, 4)
    assert ids.shape == (4, 3, 2) and y.shape == (4, 3)
    np.testing.assert_array_equal(y.reshape(-1).numpy(),
                                  order[:12].numpy().astype(np.float32))


@pytest.mark.parametrize("K", [1, 5, 40])
def test_ragged_sgd_kernel_cases_on_cpu(K):
    """chip_smoke.py's ragged SGD cases, which hold X9a-X9c against their
    twins on the card, exercise what they claim: every step mode has a
    case; at K = 5 the NaN target reaches the accumulator, the table and
    every SGDA reg; at K = 1 and 40 all is finite; the X9a record keeps the
    last entry of each attribute."""
    import chip_smoke

    (s,) = [c for c in chip_smoke.ragged_sgd_tensors("cpu")
            if c["sgd"]["tab"].shape[1] == 1 + K]
    cases = chip_smoke.make_cases(s)
    labels = {n: [c[0] for c in cases[n]] for n in
              ("sgd_grad_scatter", "sgd_apply", "sgda_lambda")}
    assert len(labels["sgd_grad_scatter"]) == len(labels["sgd_apply"]) == 4
    assert len(labels["sgda_lambda"]) == 1
    for name in labels:
        for label, prepare, call, _ in cases[name]:
            outs = call("plain", prepare())
            finite = all(torch.isfinite(o.float()).all() for o in outs)
            nan_row = K == 5 and "pair" not in label
            assert finite != nan_row, (name, label)
            if name == "sgda_lambda" and K == 5:
                assert torch.isnan(outs[0]).all() and torch.isnan(
                    outs[1]).all()
            if name == "sgd_grad_scatter" and "sgda" in label:
                ids, vals, _, valid = s["sgd"]["modes"][2][3]
                keep = ((vals != 0) & (valid[:, None] > 0)).reshape(-1)
                want = torch.full((ids.max() + 1,), -1, dtype=torch.int64)
                for i, d in enumerate(ids.reshape(-1).tolist()):
                    if keep[i]:
                        want[d] = i  # the last kept entry of d
                assert (want >= 0).sum() > 0
                assert outs[-1][: len(want)].tolist() == want.tolist()


def _modes_of(K):
    import chip_smoke

    (s,) = [c for c in chip_smoke.ragged_sgd_tensors("cpu")
            if c["sgd"]["tab"].shape[1] == 1 + K]
    return s["sgd"]


def _scattered(g, m, kind, batch):
    """The workspace X9a's twin leaves after ``batch`` in ``kind``'s mode,
    and the batch's sampled items (pair mode) or None."""
    ids, vals, y, valid = batch[:4]
    tab = g["tab"]
    D, K = tab.shape[0], tab.shape[1] - 1
    sgda = kind == "sgda"
    neg = batch[4] if kind == "pair" else None
    ws = ks.make_workspace(D, K, "cpu", sgda_batch=ids.shape if sgda else
                           None)
    ks.sgd_grad_scatter_plain(
        tab, g["w0"], ids, vals, y, valid, ws.acc, ws.acc0, ws.owner, m,
        None if neg is None else (neg, *g["range"]),
        (ws.gw_e, ws.gv_e, ws.winner) if sgda else None)
    return ws, neg


@pytest.mark.parametrize("K", [1, 5, 40])
def test_apply_entries_name_every_row_x9a_writes(K):
    """X9b's kernel visits the attributes ``apply_entries`` lists: the
    batch's B P entries, then in pair mode its B sampled items.  Every row
    X9a's twin writes (a nonzero or NaN count or gradient, a winner) is
    among them, in each step mode of chip_smoke.py's ragged cases: x = 0
    entries, a valid = 0 row, a NaN target at K = 5, duplicate ids, and a
    pair whose negative is its own item.  The owner X9a records for each
    named attribute is an entry naming it."""
    g = _modes_of(K)
    for label, m, kind, batch in g["modes"]:
        ws, neg = _scattered(g, m, kind, batch)
        ids = batch[0]
        entries = ks.apply_entries(ids, neg)
        B, P = ids.shape
        assert entries.tolist() == ids.reshape(-1).tolist() + (
            [] if neg is None else neg.tolist())
        written = ((ws.acc != 0) | torch.isnan(ws.acc)).any(1)
        if kind == "sgda":
            written |= ws.winner >= 0
        named = torch.zeros_like(written)
        named[entries.long()] = True
        assert written.any() and not (written & ~named).any(), label
        assert torch.equal(entries[ws.owner[entries.long()].long()], entries)
        if neg is not None:
            # the negatives write rows the positive entries do not name
            pos = torch.zeros_like(written)
            pos[ids.reshape(-1).long()] = True
            assert (written & ~pos).any()
            assert set(neg.tolist()) <= set(entries[B * P:].tolist())


@pytest.mark.parametrize("K", [1, 5, 40])
def test_dense_twin_keeps_unnamed_rows_bit_identical(K):
    """The invariant X9b's kernel relies on to skip the rows no entry
    names: the dense twin, stepping every row, leaves such a row's table
    bits as they were, NaN, +inf, -inf and -0 included, and its
    accumulator at +0, in every step mode (SGDA's per-group regs too)."""
    g = dict(_modes_of(K))
    D = g["tab"].shape[0]
    # four more attributes, which no batch names
    special = torch.tensor([float("nan"), float("inf"), -float("inf"),
                            -0.0])[:, None].expand(4, 1 + K)
    g["tab"] = torch.cat([g["tab"], special])
    g["grad_tab"] = torch.cat([g["grad_tab"], torch.zeros(4, 1 + K)])
    g["attr_group"] = torch.cat([g["attr_group"],
                                 torch.zeros(4, dtype=torch.int32)])
    for label, m, kind, batch in g["modes"]:
        ws, neg = _scattered(g, m, kind, batch)
        tab = g["tab"].clone()
        named = torch.zeros(tab.shape[0], dtype=torch.bool)
        named[ks.apply_entries(batch[0], neg).long()] = True
        free = torch.nonzero(~named)[:, 0]
        assert free[-4:].tolist() == list(range(D, D + 4))
        before = tab.clone()
        assert not ws.acc[free].any() and not torch.signbit(
            ws.acc[free]).any()
        extra = None
        if kind == "sgda":
            extra = (g["reg_w"], g["reg_v"], g["attr_group"], ws.winner,
                     ws.gw_e, ws.gv_e, g["grad_tab"].clone())
        ks.sgd_apply_plain(tab, g["w0"].clone(), ws.acc, ws.acc0, m, extra)
        assert torch.equal(tab[free].view(torch.int32),
                           before[free].view(torch.int32)), label
        assert not torch.equal(tab[named], before[named]), label
