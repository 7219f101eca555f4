"""Batch VBFM in the port (fast mode, CPU twins of kernels K1-K4) against
the JAX package's VBLearner, both started from the JAX learner's init
state (``utils.convert.state_from_jax``).

Tolerances, held below the JAX tests' own (test_vb.py: rtol 3e-3 on
parameters, 2e-3 on the free energy) and set from what was measured on
this data (worst relative difference ~2e-5 on parameters near zero, ~2e-7
on the free energy; float32 sums taken in another order):
  * one sweep: rtol 1e-4 / atol 1e-5 on e, t and the parameters, rtol 1e-5
    on alpha, the precisions and the free energy;
  * five-sweep trajectories: rtol 1e-5 on rmse, train_rmse, free energy.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like
from svbfm_tpu.data.synth import train_test_split
from svbfm_tpu.learners import vb as jvb
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.learners.base import plan_specs_for
from svbfm_tpu.parallel.mesh import DATA_AXIS, make_mesh
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.learners import vb as tvb
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.utils.convert import state_from_jax

STATE_FIELDS = [f.name for f in dataclasses.fields(tvb.VBState)]


def _pair(num_rows=96, num_users=9, num_items=7, K=3, seed=2, bins="auto",
          **cfg_kw):
    """The JAX learner and the port's learner on the same data and config
    (test_vb.py's _setup shapes)."""
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    D = coo.num_features
    kw = dict(num_attributes=D, num_factor=K,
              min_target=float(tr.target.min()),
              max_target=float(tr.target.max()), seed=7, **cfg_kw)
    jmeta = JMeta.from_field_offsets(D, [0, num_users])
    tmeta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    jl = jvb.VBLearner(JConfig(num_groups=jmeta.num_attr_groups, **kw),
                       JDataset.from_coo(tr, D), JDataset.from_coo(te, D),
                       jmeta, mesh=make_mesh(1), bins=bins, write_files=False)
    tl = tvb.VBLearner(FMConfig(num_groups=tmeta.num_attr_groups, **kw),
                       SparseDataset.from_coo(tr, D),
                       SparseDataset.from_coo(te, D), tmeta, device="cpu",
                       bins=bins, write_files=False)
    return jl, tl


def _np(state):
    if isinstance(state, tvb.VBState):
        return {k: getattr(state, k).numpy() for k in STATE_FIELDS}
    return {k: np.asarray(getattr(state, k)) for k in STATE_FIELDS}


def test_state_from_jax_and_init_caches():
    jl, tl = _pair()
    js = jl.init_state()
    ts = state_from_jax(jax.device_get(js), "cpu")
    assert all(getattr(ts, k).dtype == torch.float32 for k in STATE_FIELDS)
    jnp_ = _np(js)
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(), jnp_[k])
    # the port's K1 on the same parameters rebuilds JAX's init e/t
    rebuilt = tl.state_from_params(
        {k: getattr(ts, k) for k in tvb.PARAM_FIELDS})
    np.testing.assert_allclose(rebuilt.e.numpy(), jnp_["e"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rebuilt.t.numpy(), jnp_["t"], rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("variant", ["default", "no_k0", "no_k1",
                                     "jacobi_bins"])
def test_one_sweep_matches_jax(variant):
    cfg_kw, bins = {}, "auto"
    if variant == "no_k0":
        cfg_kw = dict(k0=False)
    elif variant == "no_k1":
        cfg_kw = dict(k1=False)
    elif variant == "jacobi_bins":
        bins = "jacobi"  # one non-conflict-free bin: sequential-p patch
    jl, tl = _pair(num_rows=200, num_users=12, num_items=9, K=4, bins=bins,
                   **cfg_kw)
    js = jl.init_state()
    ts = state_from_jax(jax.device_get(js), "cpu")
    j1, jfe = jl._step(js, jl.train_row, jl.plan_data)
    t1, tfe, nans = tvb.vb_update_all(ts, tl.train_row, tl.plan_data, tl.cfg,
                                      float(tl.train_n))
    jn, tn = _np(j1), _np(t1)
    for k in ("e", "t", "mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash",
              "mu_0", "sigma_0_dash"):
        np.testing.assert_allclose(tn[k], jn[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k in ("alpha", "sigma_0", "sigma_w", "sigma_v"):
        np.testing.assert_allclose(tn[k], jn[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(tfe), float(jfe), rtol=1e-5)
    assert {k: int(v) for k, v in nans.items()} == dict(nan_w=0, nan_v=0,
                                                        nan_alpha=0)
    # the input state is not modified
    np.testing.assert_array_equal(ts.e.numpy(), np.asarray(js.e))


@pytest.mark.parametrize("K", [1, 4, 20, 33])
def test_block_update_matches_jax_kernel_chain(K):
    """vb_v_block_update alone (K2-K4 twins) against the JAX function of
    the same name, run under shard_map on a one-device mesh, at the widths
    K3's and K4's lane layouts care about: one factor, chunks of 4 (4, 20)
    and an odd width past 32 (33)."""
    jl, tl = _pair(num_rows=300, num_users=14, num_items=11, K=K, seed=4)
    js = jax.device_get(jl.init_state())
    ts = state_from_jax(js, "cpu")
    sv_t = np.asarray(js.sigma_v)[np.asarray(jl.meta.attr_group)]  # [D, K]

    def f(e, t, mu_t, sig_t, sv, alpha, plan, row, w):
        e, t, mu, sig, nans, (mw, sw, _) = jvb.vb_v_block_update(
            e, t, mu_t, sig_t, sv, alpha, plan, row, w_state=w)
        return e, t, mu, sig, mw, sw

    rep, shd = P(), P(DATA_AXIS)
    fn = jax.jit(jax.shard_map(
        f, mesh=jl.mesh,
        in_specs=(shd, shd, rep, rep, rep, rep, plan_specs_for(jl.plan_data),
                  jvb._row_specs(), (rep, rep, rep)),
        out_specs=(shd, shd, rep, rep, rep, rep)))
    je, jt, jmu, jsig, jmw, jsw = map(np.asarray, fn(
        js.e, js.t, js.mu_v.T, js.sigma_v_dash.T, sv_t, js.alpha,
        jl.plan_data, jl.train_row, (js.mu_w, js.sigma_w_dash, js.sigma_w)))

    e, t = ts.e.clone(), ts.t.clone()
    mu_t, sig_t = ts.mu_v.T.contiguous(), ts.sigma_v_dash.T.contiguous()
    mw, sw = ts.mu_w.clone(), ts.sigma_w_dash.clone()
    nans = tvb.vb_v_block_update(e, t, mu_t, sig_t, ts.sigma_v, ts.alpha,
                                 tl.plan_data, tl.train_row,
                                 (mw, sw, ts.sigma_w))
    for name, got, ref in (("e", e, je), ("t", t, jt), ("mu", mu_t, jmu),
                           ("sig", sig_t, jsig), ("mu_w", mw, jmw),
                           ("sig_w", sw, jsw)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert nans.tolist() == [0, 0]


def test_run_trajectory_matches_jax(tmp_path):
    jl, tl = _pair(num_rows=400, num_users=15, num_items=12, K=4)
    js = jl.init_state()
    ts = state_from_jax(jax.device_get(js), "cpu")
    _, jh = jl.run(js, num_iter=5, verbose=False, donate=False)
    tl.out_dir, tl.write_files = str(tmp_path), True
    _, th = tl.run(ts, num_iter=5, verbose=False, chunk=2)
    assert [h["iter"] for h in th] == list(range(5))
    assert set(jh[0]) == set(th[0])
    for a, b in zip(jh, th):
        for k in ("rmse", "mae", "train_rmse", "free_energy", "alpha"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(b["sigma_v"], a["sigma_v"], rtol=1e-5)
        assert b["nan_v"] == a["nan_v"] == 0
    # the reference-named trajectory files
    tag = tl.cfg.dim_tag
    rm = np.loadtxt(os.path.join(tmp_path, f"test_rmse_{tag}_vb"))
    fe = np.loadtxt(os.path.join(tmp_path, f"free_energy_{tag}_vb"))
    np.testing.assert_allclose(rm, [h["rmse"] for h in th], rtol=1e-5)
    np.testing.assert_allclose(fe, [-h["free_energy"] for h in th], rtol=1e-5)


def test_vb_free_energy_increases():
    _, tl = _pair(num_rows=400, num_users=15, num_items=12, K=4)
    _, history = tl.run(num_iter=8, verbose=False)
    fes = [h["free_energy"] for h in history]
    # coordinate ascent on the ELBO: free energy must be non-decreasing
    # (allow tiny f32 jitter)
    for a, b in zip(fes, fes[1:]):
        assert b >= a - abs(a) * 1e-4


def test_vb_rmse_improves():
    _, tl = _pair(num_rows=2000, num_users=30, num_items=25, K=4)
    _, history = tl.run(num_iter=10, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    assert history[-1]["rmse"] < 1.0


def test_evaluate_regression_matches_jax():
    from svbfm_tpu.learners.base import evaluate_regression as jeval
    from svbfm_tpu_torch.learners.base import evaluate_regression as teval

    rng = np.random.default_rng(0)
    pred, y = rng.normal(3, 2, 50), rng.integers(1, 6, 50).astype(float)
    for n in (None, 20):
        assert teval(pred, y, 1.0, 5.0, num_eval_cases=n) == \
            jeval(pred, y, 1.0, 5.0, num_eval_cases=n)


def test_predict_test_scores_matches_jax():
    jl, tl = _pair()
    js = jl.init_state()
    ts = state_from_jax(jax.device_get(js), "cpu")
    np.testing.assert_allclose(tl.predict_test_scores(ts),
                               jl.predict_test_scores(js), rtol=1e-5,
                               atol=1e-6)


def _tiny_port_data():
    from svbfm_tpu_torch.data.synth import make_movielens_like as tmake

    coo = tmake(num_users=5, num_items=4, num_ratings=40, rank=2, seed=0)
    D = coo.num_features
    return SparseDataset.from_coo(coo, D), FMConfig(num_attributes=D,
                                                    num_factor=2)


@pytest.mark.parametrize("change", [dict(task=1),
                                    dict(task=1, factor_block=1),
                                    dict(task=1, num_factor=0)])
def test_out_of_slice_raises(change):
    """Classification runs in every mode, batch and online alike, and the
    Poisson task, which these learners do not read, raises (its ROADMAP
    item named).  A sweep (an epoch) on +-1 targets gives the JAX
    learner's accuracy (tests/test_torch_classification.py holds the
    states)."""
    from svbfm_tpu.learners import vb_online as jov
    from svbfm_tpu_torch.learners.vb_online import OVBLearner
    from svbfm_tpu_torch.utils.convert import ovb_state_from_jax

    ds, cfg = _tiny_port_data()
    ds.target = np.where(ds.target > 3, 1.0, -1.0).astype(np.float32)
    cfg = dataclasses.replace(cfg, min_target=-1.0, max_target=1.0, seed=7,
                              num_batches=2, **change)
    jds = JDataset(ids=ds.ids, vals=ds.vals, target=ds.target,
                   num_rows=ds.num_rows, num_features=ds.num_features,
                   min_target=-1.0, max_target=1.0, row_nnz=ds.row_nnz)
    jcfg = JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})
    for jcls, tcls, conv in ((jvb.VBLearner, tvb.VBLearner, state_from_jax),
                             (jov.OVBLearner, OVBLearner,
                              ovb_state_from_jax)):
        jl = jcls(jcfg, jds, jds, mesh=make_mesh(1), write_files=False)
        tl = tcls(cfg, ds, ds, device="cpu", write_files=False)
        js = jl.init_state()
        ts = conv(jax.device_get(js), "cpu")
        _, jh = jl.run(js, num_iter=1, verbose=False)
        _, th = tl.run(ts, num_iter=1, verbose=False)
        assert abs(th[0]["accuracy"] - jh[0]["accuracy"]) * tl.test_n < 1.5
        np.testing.assert_allclose(th[0]["loglik"], jh[0]["loglik"],
                                   rtol=2e-3)
        with pytest.raises(NotImplementedError, match="item 15"):
            tcls(dataclasses.replace(cfg, task=2), ds, ds, device="cpu")


def test_num_eval_cases_raises():
    """-num_eval_cases runs (held to JAX in tests/test_torch_num_eval.py):
    the eval over the first 5 rows, rmse_test2_this over the rest."""
    ds, cfg = _tiny_port_data()
    learner = tvb.VBLearner(cfg, ds, ds, device="cpu", num_eval_cases=5,
                            write_files=False)
    assert learner._eval_n == 5 and learner._rest_valid is not None
    _, h = learner.run(num_iter=1, verbose=False)
    assert np.isfinite(h[0]["rmse"]) and np.isfinite(h[0]["rmse_test2_this"])


@pytest.mark.parametrize("F,P,ld,shift,plan", [
    (20, 2, 40, 0, ("chunks", 4, 5, 6, "p2")),     # X8d's [D, 2F]
    (20, 2, 102, 0, ("chunks", 2, 10, 3, "p2")),   # K2's fast mode
    (20, 3, 100, 0, ("chunks", 4, 5, 6, "any")),   # K2 without the rider
    (20, 2, 40, 1, ("chunks", 1, 20, 1, "p2")),    # ptab one float on
    (20, 2, 40, 2, ("chunks", 2, 10, 3, "p2")),
    (2, 1, 4, 0, ("chunks", 2, 1, 32, "any")),
    (3, 2, 6, 0, ("chunks", 1, 3, 10, "p2")),
    (33, 2, 66, 0, ("chunks", 1, 32, 1, "p2")),
    (136, 1, 272, 0, ("chunks", 4, 32, 1, "any")),
    (1, 2, 5, 0, ("rows", 1, 1, 32, "p2")),        # K2 exact, OVB chunk
    (1, 2, 1, 0, ("rows", 1, 1, 32, "p2")),        # X8d at factor_block 1
    (1, 2, 5, 1, ("rows", 1, 1, 32, "any")),       # ids one int on
    (1, 3, 5, 0, ("rows", 1, 1, 32, "any"))])
def test_qt_plan_is_the_cu_rule(F, P, ld, shift, plan):
    """K2's and X8d's form (csrc/vb_sweep.cu:launch_qt, qt_width): a thread
    a row at F = 1, the P = 2 build where ids and vals are 8-byte aligned;
    at F >= 2 chunks of the widest of 4, 2, 1 factors that divides F and
    ptab's row stride and to whose size ptab and the caches are aligned,
    min(F / vec, 32) lanes a row, 32 // lanes rows a warp.  Walking the
    launch over a ragged N reaches every (row, chunk) once."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    N, D = 53, 7

    def view(shape, sh, dtype=torch.float32):
        buf = torch.zeros(shape[0] * shape[1] + sh, dtype=dtype)
        assert buf.data_ptr() % 16 == 0
        return buf[sh:].view(shape)

    ids = view((N, P), shift if F == 1 else 0, torch.int32)
    ptab = view((D, ld), shift if F > 1 else 0)
    q = torch.zeros(N, F)
    p = kv.qt_plan_of(ptab, F, ids, view((N, P), 0), caches=(q, q, q))
    assert tuple(p) == plan
    if p.form == "rows":
        return
    G = F // p.vec
    seen = []
    for w in range(-(-N // p.rows)):
        for lane in range(32):
            slot, j = divmod(lane, p.lanes)
            n = w * p.rows + slot
            if slot < p.rows and n < N:
                seen += [(n, ch) for c0 in range(0, G, 32)
                         if (ch := c0 + j) < G]
    assert sorted(seen) == [(n, ch) for n in range(N) for ch in range(G)]
