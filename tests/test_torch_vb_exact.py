"""Batch VBFM in exact mode (``factor_block`` > 0, and K = 0) in the port,
CPU twins of kernels K1-K5 and the w patch, against the JAX package's
``VBLearner`` and the float64 ``VBOracle``, both packages started from the
JAX learner's init (``utils.convert.state_from_jax``).

Tolerances, never looser than the JAX tests' own (test_vb.py:58-64: rtol
3e-3 on parameters, 2e-3 on the free energy) and set from what was measured
on this data (worst relative difference ~2e-4 on parameters near zero,
~2e-7 on the free energy; float32 sums taken in another order):
  * one sweep: rtol 1e-4 / atol 1e-5 on e, t and the parameters, rtol 1e-5
    on alpha, the precisions and the free energy;
  * five-sweep trajectories: rtol 1e-5 on rmse, train_rmse, free energy;
  * against VBOracle (float64, factor_block=1): the JAX test's own.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import vb as jvb
from svbfm_tpu.learners.base import plan_specs_for
from svbfm_tpu.parallel.mesh import DATA_AXIS
from svbfm_tpu_torch.learners import vb as tvb
from svbfm_tpu_torch.utils.convert import state_from_jax

from oracle import VBOracle
from test_torch_vb import _np, _pair


def _one_sweep(jl, tl):
    js = jl.init_state()
    ts = state_from_jax(jax.device_get(js), "cpu")
    j1, jfe = jl._step(js, jl.train_row, jl.plan_data)
    t1, tfe, nans = tvb.vb_update_all(ts, tl.train_row, tl.plan_data, tl.cfg,
                                      float(tl.train_n))
    return _np(j1), float(jfe), _np(t1), float(tfe), nans


def _assert_sweep_close(jn, jfe, tn, tfe, nans):
    for k in ("e", "t", "mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash",
              "mu_0", "sigma_0_dash"):
        np.testing.assert_allclose(tn[k], jn[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k in ("alpha", "sigma_0", "sigma_w", "sigma_v"):
        np.testing.assert_allclose(tn[k], jn[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tfe, jfe, rtol=1e-5)
    assert {k: int(v) for k, v in nans.items()} == dict(nan_w=0, nan_v=0,
                                                        nan_alpha=0)


@pytest.mark.parametrize("K,factor_block", [(4, 1), (4, 2), (3, 2)])
def test_one_exact_sweep_matches_jax(K, factor_block):
    """(3, 2): the port's narrower last block against JAX's padded, masked
    one."""
    jl, tl = _pair(num_rows=200, num_users=12, num_items=9, K=K,
                   factor_block=factor_block)
    _assert_sweep_close(*_one_sweep(jl, tl))


@pytest.mark.parametrize("factor_block", [0, 1])
def test_num_factor_zero_matches_jax(factor_block):
    jl, tl = _pair(num_rows=200, num_users=12, num_items=9, K=0,
                   factor_block=factor_block)
    jn, jfe, tn, tfe, nans = _one_sweep(jl, tl)
    assert tn["mu_v"].shape == (0, tl.cfg.num_attributes)
    _assert_sweep_close(jn, jfe, tn, tfe, nans)


@pytest.mark.parametrize("K,factor_block", [(4, 1), (4, 2), (0, 1)])
def test_exact_five_sweep_trajectories_match_jax(K, factor_block):
    jl, tl = _pair(num_rows=400, num_users=15, num_items=12, K=K,
                   factor_block=factor_block)
    js = jl.init_state()
    ts = state_from_jax(jax.device_get(js), "cpu")
    _, jh = jl.run(js, num_iter=5, verbose=False, donate=False)
    _, th = tl.run(ts, num_iter=5, verbose=False, chunk=2)
    for a, b in zip(jh, th):
        for k in ("rmse", "mae", "train_rmse", "free_energy", "alpha"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
        assert b["nan_w"] == b["nan_v"] == 0


def test_factor_block_1_matches_vb_oracle():
    """factor_block=1 is the reference's factor-sequential Gauss-Seidel: the
    port holds to the float64 oracle as test_vb.py:43 holds the JAX
    package (its tolerances)."""
    jl, tl = _pair(factor_block=1)
    # _pair's train split, as COO
    coo = make_movielens_like(num_users=9, num_items=7, num_ratings=96,
                              rank=2, noise=0.4, seed=2)
    tr, _ = train_test_split(coo, 0.25, seed=3)
    ts = state_from_jax(jax.device_get(jl.init_state()), "cpu")
    orc = VBOracle(tr.row, tr.col, tr.val, tr.target, tl.cfg.num_attributes,
                   tl.cfg.num_factor, groups=tl.meta.attr_group)
    orc.init(float(ts.mu_0), float(ts.sigma_0_dash), ts.mu_w.numpy(),
             ts.sigma_w_dash.numpy(), ts.mu_v.numpy(),
             ts.sigma_v_dash.numpy())
    np.testing.assert_allclose(ts.e.numpy(), orc.e, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ts.t.numpy(), orc.t, rtol=2e-4, atol=2e-4)
    for _ in range(3):
        ts, fe, _nans = tvb.vb_update_all(ts, tl.train_row, tl.plan_data,
                                          tl.cfg, float(tl.train_n))
        fe_o = orc.iterate()
        np.testing.assert_allclose(ts.mu_w.numpy(), orc.mu_w, rtol=3e-3,
                                   atol=3e-4)
        np.testing.assert_allclose(ts.mu_v.numpy(), orc.mu_v, rtol=3e-3,
                                   atol=3e-4)
        np.testing.assert_allclose(ts.sigma_w_dash.numpy(), orc.sigma_w_dash,
                                   rtol=3e-3, atol=1e-6)
        np.testing.assert_allclose(float(ts.alpha), orc.alpha, rtol=3e-3)
        np.testing.assert_allclose(float(ts.mu_0), orc.mu_0, rtol=3e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(float(fe), fe_o, rtol=2e-3)


def test_w_bin_update_matches_jax():
    """The standalone linear-term sweep alone (K5 twin + the w patch twin)
    against the JAX ``vb_w_bin_update``, bin by bin, under shard_map on a
    one-device mesh."""
    jl, tl = _pair(num_rows=300, num_users=14, num_items=11, K=2, seed=4,
                   factor_block=1)
    js = jax.device_get(jl.init_state())
    ts = state_from_jax(js, "cpu")
    rep, shd = P(), P(DATA_AXIS)
    specs = plan_specs_for(jl.plan_data)
    e, t = ts.e.clone(), ts.t.clone()
    mw, sw = ts.mu_w.clone(), ts.sigma_w_dash.clone()
    je, jt, jmw, jsw = js.e, js.t, js.mu_w, js.sigma_w_dash
    dtab = torch.empty(tl.cfg.num_attributes, 2)
    bad = torch.zeros(4, dtype=torch.int32)
    for b, bin_blocks in enumerate(jl.plan_data.blocks):
        fn = jax.jit(jax.shard_map(
            lambda e, t, mw, sw, blocks, row: jvb.vb_w_bin_update(
                e, t, mw, sw, js.sigma_w, js.alpha, blocks, row),
            mesh=jl.mesh,
            in_specs=(shd, shd, rep, rep, specs.blocks[b], jvb._row_specs()),
            out_specs=(shd, shd, rep, rep)))
        je, jt, jmw, jsw = fn(je, jt, jmw, jsw, bin_blocks, jl.train_row)
        tvb.vb_w_bin_update(e, t, mw, sw, ts.sigma_w, ts.alpha,
                            tl.plan_data.blocks[b], tl.train_row, dtab, bad)
        for name, got, ref in (("e", e, je), ("t", t, jt), ("mu_w", mw, jmw),
                               ("sigma_w_dash", sw, jsw)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    assert bad.tolist() == [0, 0, 0, 0]


def test_factor_blocks_spans():
    assert tvb.factor_blocks(4, 0) == [(0, 4)]
    assert tvb.factor_blocks(4, 1) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert tvb.factor_blocks(3, 2) == [(0, 2), (2, 3)]
    assert tvb.factor_blocks(3, 8) == [(0, 3)]
    assert tvb.factor_blocks(0, 1) == []


def test_exact_mode_free_energy_increases():
    _, tl = _pair(num_rows=400, num_users=15, num_items=12, K=4,
                  factor_block=1)
    _, history = tl.run(num_iter=6, verbose=False)
    fes = [h["free_energy"] for h in history]
    for a, b in zip(fes, fes[1:]):
        assert b >= a - abs(a) * 1e-4


@pytest.mark.parametrize("factor_block", [0, 1])
def test_nan_w_record_matches_jax(factor_block):
    """A NaN prior precision for the item group makes every linear-term
    candidate of its columns non-finite.  Both packages revert them, and
    record ``nan_w`` alike: the count in fast mode, 0 in exact mode, where
    the standalone sweep reports none."""
    jl, tl = _pair(num_rows=200, num_users=12, num_items=9, K=2,
                   factor_block=factor_block)
    js = jl.init_state()
    js = js.replace(sigma_w=js.sigma_w.at[1].set(np.nan))
    ts = state_from_jax(jax.device_get(js), "cpu")
    _, jh = jl.run(js, num_iter=1, verbose=False, donate=False)
    _, th = tl.run(ts, num_iter=1, verbose=False)
    assert th[0]["nan_w"] == jh[0]["nan_w"]
    assert (th[0]["nan_w"] > 0) == (factor_block == 0)
    for k in ("rmse", "train_rmse", "free_energy"):
        np.testing.assert_allclose(th[0][k], jh[0][k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("K,factor_block", [(4, 1), (3, 2)])
def test_exact_sweep_leaves_input_state_unchanged(K, factor_block):
    """A block of one factor is a view of its [K, D] table; the sweep must
    write the new state's copy, never the state it was given."""
    _, tl = _pair(num_rows=200, num_users=12, num_items=9, K=K,
                  factor_block=factor_block)
    s0 = tl.init_state()
    before = {k: getattr(s0, k).clone() for k in ("mu_v", "sigma_v_dash")}
    s1, _, _ = tvb.vb_update_all(s0, tl.train_row, tl.plan_data, tl.cfg,
                                 float(tl.train_n))
    for k, v in before.items():
        assert torch.equal(getattr(s0, k), v), k
        assert not torch.equal(getattr(s1, k), v), k
