"""The full-batch exponential-family coordinate SGD (``-method exp_sgd``,
kernel X9d: K5's and X8a's gradient modes with X8b, X8d, K1) in the port,
on the CPU twins, against the JAX package's ``ExpSGDLearner`` and the
float64 ``ExpSGDOracle``; both packages start from the JAX learner's init
(``exp_sgd_state_from_jax``).

Tolerances, with their reasons:
  * steps against JAX: rtol 1e-5 / atol 1e-6 on w0, w, v and the test RMSE
    (float32 sums of the same terms in another order; the port's last
    factor block is narrower where JAX pads and masks, which changes no
    arithmetic);
  * against the float64 oracle: test_exp_sgd.py:73-75's own.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import exp_sgd as je
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels import mcmc_sweep as km
from svbfm_tpu_torch.kernels import w_sweep as kw
from svbfm_tpu_torch.learners import exp_sgd as te
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.utils.convert import exp_sgd_state_from_jax

from oracle import ExpSGDOracle


def _pair(num_rows=96, num_users=9, num_items=7, K=3, seed=2, **cfg_kw):
    """The JAX learner and the port's on test_exp_sgd.py's oracle data."""
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=seed)
    tr, te_ = train_test_split(coo, 0.25, seed=seed + 1)
    D = coo.num_features
    kw_ = dict(num_attributes=D, num_factor=K, num_groups=2, seed=7,
               min_target=float(tr.target.min()),
               max_target=float(tr.target.max()), learn_rate=0.4, stdev=1.0,
               regw=0.05, regv=0.05)
    kw_.update(cfg_kw)
    jl = je.ExpSGDLearner(JConfig(**kw_), JDataset.from_coo(tr, D),
                          JDataset.from_coo(te_, D),
                          JMeta.from_field_offsets(D, [0, num_users]),
                          mesh=make_mesh(1), write_files=False)
    tl = te.ExpSGDLearner(FMConfig(**kw_), SparseDataset.from_coo(tr, D),
                          SparseDataset.from_coo(te_, D),
                          DataMetaInfo.from_field_offsets(D, [0, num_users]),
                          device="cpu", write_files=False)
    return jl, tl, tr


CASES = {
    "factor_block=0": dict(factor_block=0),
    "factor_block=1": dict(factor_block=1),
    "factor_block=2 (last block narrower)": dict(factor_block=2),
    "K=0": dict(K=0),
    "stdev=2, reg0": dict(stdev=2.0, reg0=0.1, factor_block=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_exp_sgd_steps_match_jax(case):
    jl, tl, _ = _pair(**CASES[case])
    js = jl.init_state()
    ts = exp_sgd_state_from_jax(jax.device_get(js), "cpu")
    for _ in range(3):
        js, jr = jl._step(js, jl.train_row, jl.plan_data, jl.test_row)
        ts, tr_ = tl.step(ts)
        for name, got, ref in zip(("w0", "w", "v"), (ts.w0, ts.w, ts.v), js):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(float(tr_), float(jr), rtol=1e-5)
    assert tuple(ts.v.shape) == (tl.cfg.num_factor, tl.cfg.num_attributes)


def test_exp_sgd_matches_float64_oracle():
    """test_exp_sgd.py:43-75: factor_block=1 on one-hot field data, where
    the bin order is the natural column order."""
    _, tl, tr = _pair(factor_block=1)
    cfg = tl.cfg
    ts = tl.init_state()
    orc = ExpSGDOracle(tr.row, tr.col, tr.val, tr.target,
                       cfg.num_attributes, 3, lr=cfg.learn_rate,
                       stdev=cfg.stdev, reg0=cfg.reg0, regw=cfg.regw,
                       regv=cfg.regv)
    orc.init(float(ts.w0), ts.w.numpy(), ts.v.numpy())
    for _ in range(3):
        ts, _rmse = tl.step(ts)
        orc.iterate()
        np.testing.assert_allclose(float(ts.w0), orc.w0, rtol=3e-4, atol=1e-6)
        np.testing.assert_allclose(ts.w.numpy(), orc.w, rtol=3e-3, atol=3e-5)
        np.testing.assert_allclose(ts.v.numpy(), orc.v, rtol=3e-3, atol=3e-5)


def test_exp_sgd_run_matches_jax_and_converges():
    """test_exp_sgd.py:25-31's recipe, 8 sweeps: the run records equal
    JAX's, and the test RMSE falls."""
    jl, tl, _ = _pair(num_rows=2000, num_users=30, num_items=25, K=4, seed=3,
                      learn_rate=0.5, regw=0.0, regv=0.0)
    js = jl.init_state()
    _, jh = jl.run(js, num_iter=8, verbose=False)
    _, th = tl.run(exp_sgd_state_from_jax(jax.device_get(js), "cpu"),
                   num_iter=8, verbose=False)
    np.testing.assert_allclose([r["rmse"] for r in th],
                               [r["rmse"] for r in jh], rtol=1e-5)
    assert th[-1]["rmse"] < th[0]["rmse"] and np.isfinite(th[-1]["rmse"])


def test_gradient_twins_step_one_bucket():
    """K5's and X8a's gradient-mode twins on one bucket: the step of
    exp_sgd.py:84-87 / :129-136 written out, the delta tables, and the
    revert of a non-finite step."""
    _, tl, _ = _pair(K=2)
    s = tl.init_state()
    row = tl.train_row
    blk = tl.plan_data.blocks[0][0]
    D, N = tl.cfg.num_attributes, float(tl.train_n)
    e = torch.randn(row.ids.shape[0], generator=torch.Generator().manual_seed(1))
    w, dtab = s.w.clone() + 0.1, torch.zeros(D, 2)
    w_old = w.clone()
    kw.w_grad_step_plain(blk.rows, blk.x, blk.cols, e, w, dtab, 0.4, 0.05, N)
    cl = blk.cols.long()
    sxe = (blk.x * e[blk.rows.long()]).sum(1)
    want = w_old[cl] - 0.4 * (sxe + 0.05 * w_old[cl]) / N
    np.testing.assert_allclose(w[cl].numpy(), want.numpy(), rtol=1e-6)
    np.testing.assert_allclose(dtab[cl, 0].numpy(), (w - w_old)[cl].numpy())
    assert (dtab[:, 1] == 0).all()
    # X8a's gradient mode: F = 2, one column's q made Inf -> that step reverts
    F = 2
    v_t = s.v.T.contiguous()
    ptab = torch.cat([v_t, torch.zeros(D, F)], 1)
    q = torch.randn(row.ids.shape[0], F)
    q[blk.rows[0, 0].long()] = np.inf
    v_new = v_t.clone()
    km.mcmc_col_grad_plain(blk.rows, blk.x, blk.cols, e, q, ptab, v_new, 0.4,
                           0.05, N)
    assert torch.isfinite(v_new).all()
    assert torch.equal(v_new[cl[0]], v_t[cl[0]])
    changed = (v_new != v_t).any(1)
    assert changed[cl[1:]].all() and not changed[~torch.isin(
        torch.arange(D), cl)].any()
    np.testing.assert_allclose(ptab[:, F:].numpy(), (v_t - v_new).numpy())


def test_factor_blocks_cover_k():
    cfg = FMConfig(num_attributes=4, num_factor=5)
    assert te.factor_blocks(dataclasses.replace(cfg, factor_block=2)) == [
        (0, 2), (2, 2), (4, 1)]
    assert te.factor_blocks(cfg) == [(0, 5)]
    assert te.factor_blocks(dataclasses.replace(cfg, num_factor=0)) == []
