"""Gibbs MCMC and ALS in the port (CPU twins of K1, K4 at F = 0, X8a-X8d)
against the JAX package's ``MCMCLearner``/``ALSLearner`` and the float64
``ALSOracle``/``BinOrderALSOracle``, both packages started from the JAX
learner's init (``utils.convert.mcmc_state_from_jax``).  Gibbs replays the
JAX key chain: ``JaxKeyDraws`` splits the state's key once per draw, as the
JAX sweep does, so both packages use the same numbers; a sweep that drew
in another order or shape would leave the two key chains apart, which the
tests check.

Tolerances, never looser than the JAX tests' own (test_mcmc.py:49-53: rtol
2e-3 on w0, 5e-3 on w/v/e) and set from what was measured on this data
(after 3 sweeps at rtol 1e-4 the worst absolute excess was 1.3e-5, on e
under -factor_jacobi; 2.6e-7 relative on alpha and the hyperparameters;
float32 sums taken in another order):
  * sweeps against JAX: rtol 1e-4 / atol 5e-5 on w0, w, v and e; rtol 1e-5 /
    atol 1e-6 on alpha and the four hyperparameter arrays; counters equal;
  * run() records against JAX: rtol 1e-5;
  * against the float64 oracles: the JAX test's own;
  * exact_block_draws and the twins against JAX's functions: rtol 1e-5 /
    atol 1e-6 (the JAX test holds its solve to its loop at 2e-4 / 2e-5).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from svbfm_tpu.cli import main as jax_main
from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import mcmc as jm
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.learners.base import plan_specs_for
from svbfm_tpu.parallel.mesh import DATA_AXIS, make_mesh
from svbfm_tpu_torch import cli
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.libfm_text import save_libfm_text
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels import mcmc_sweep as km
from svbfm_tpu_torch.kernels import vb_sweep as kv
from svbfm_tpu_torch.kernels import w_sweep as kw
from svbfm_tpu_torch.learners import mcmc as tm
from svbfm_tpu_torch.learners.base import FMConfig, zero_counters
from svbfm_tpu_torch.learners.draws import device_draws, host_draws
from svbfm_tpu_torch.ops.forward import fm_scores
from svbfm_tpu_torch.utils.convert import mcmc_state_from_jax

from oracle import ALSOracle, BinOrderALSOracle

PARAMS = ("w0", "w", "v", "e")
HYPER = ("alpha", "w_mu", "w_lambda", "v_mu", "v_lambda")


class JaxKeyDraws:
    """A draw source that replays a JAX key chain: each draw splits the key
    and uses the sub-key, as ``svbfm_tpu.learners.mcmc`` does."""

    def __init__(self, key):
        self.key = key

    def _sub(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def normal(self, shape):
        return torch.tensor(np.asarray(
            jax.random.normal(self._sub(), tuple(shape), jnp.float32)))

    def gamma(self, a):
        a = jnp.asarray(np.asarray(a, dtype=np.float32))
        return torch.tensor(np.asarray(
            jax.random.gamma(self._sub(), a, dtype=jnp.float32)))

    def uniform(self, shape, lo, hi, shard=0, n_shards=1):
        """The probit draw's chain (mcmc.py:1079-1082): split, fold in the
        data shard's index, uniform in [lo, hi).  A zero-length draw (ALS)
        still splits, as JAX does."""
        sub = jax.random.fold_in(self._sub(), shard)
        return torch.tensor(np.asarray(jax.random.uniform(
            sub, tuple(shape), jnp.float32, lo, hi)))

    def column_normal(self, F, lo, D_loc):
        """The feature-sharded sweep's z table (tp_mcmc.py:170, :228-229):
        one sub-key, the shard's [F, D_loc] slice of its W-aligned
        chunks."""
        from svbfm_tpu.parallel.tp_mcmc import _z_table_local
        return torch.tensor(np.asarray(_z_table_local(
            self._sub(), F, D_loc, lo, jnp.float32)))


def _data(num_rows=96, num_users=9, num_items=7, seed=2):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    return coo, tr, te


def _pair(als, num_rows=96, num_users=9, num_items=7, K=3, seed=2,
          **cfg_kw):
    """The JAX learner and the port's on the same data and config
    (test_mcmc.py's _setup shapes)."""
    coo, tr, te = _data(num_rows, num_users, num_items, seed)
    D = coo.num_features
    kw_ = dict(num_attributes=D, num_factor=K,
               min_target=float(tr.target.min()),
               max_target=float(tr.target.max()), seed=7, **cfg_kw)
    jmeta = JMeta.from_field_offsets(D, [0, num_users])
    tmeta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    jcls = jm.ALSLearner if als else jm.MCMCLearner
    tcls = tm.ALSLearner if als else tm.MCMCLearner
    jl = jcls(JConfig(num_groups=jmeta.num_attr_groups, **kw_),
              JDataset.from_coo(tr, D), JDataset.from_coo(te, D), jmeta,
              mesh=make_mesh(1), write_files=False)
    tl = tcls(FMConfig(num_groups=tmeta.num_attr_groups, **kw_),
              SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
              tmeta, device="cpu", write_files=False)
    return jl, tl, tr


def _start(jl):
    js = jl.init_state()
    return js, mcmc_state_from_jax(jax.device_get(js), "cpu",
                                   JaxKeyDraws(js.key))


def _assert_state_close(js, jnans, ts, tnans, n):
    for k in PARAMS + HYPER:
        got, ref = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        if k == "e":
            ref = ref[:n]
        tol = dict(rtol=1e-4, atol=5e-5) if k in PARAMS else dict(
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, ref, err_msg=k, **tol)
    assert {k: int(v) for k, v in tnans.items()} == {
        k: int(v) for k, v in jnans.items()}
    np.testing.assert_array_equal(np.asarray(ts.draws.key),
                                  np.asarray(js.key))


def _sweeps_match(jl, tl, n_sweeps):
    js, ts = _start(jl)
    for _ in range(n_sweeps):
        js, jnans = jl._step(js, jl.train_row, jl.plan_data)
        ts, tnans = tl.step(ts)
        _assert_state_close(js, jnans, ts, tnans, tl.train_n)


ALS_CASES = {
    "factor_block=1": dict(K=3, factor_block=1, regw=0.05, regv=0.05),
    "factor_block=0": dict(K=3, factor_block=0, regw=0.05, regv=0.05),
    "K=4,factor_block=2": dict(K=4, factor_block=2),
    "K=3,factor_block=2 (sequential)": dict(K=3, factor_block=2),
    "factor_jacobi": dict(K=4, mcmc_factor_jacobi=True, regv=0.05),
}


@pytest.mark.parametrize("n_sweeps", [1, 3])
@pytest.mark.parametrize("case", list(ALS_CASES))
def test_als_sweeps_match_jax(case, n_sweeps):
    jl, tl, _ = _pair(True, **ALS_CASES[case])
    _sweeps_match(jl, tl, n_sweeps)


@pytest.mark.parametrize("n_sweeps", [1, 3])
@pytest.mark.parametrize("factor_block", [0, 1])
def test_gibbs_sweeps_match_jax_with_replayed_draws(factor_block, n_sweeps):
    jl, tl, _ = _pair(False, K=4, factor_block=factor_block, regw=0.1,
                      regv=0.1)
    _sweeps_match(jl, tl, n_sweeps)


def test_run_records_match_jax():
    """7 iterations (all_but5 needs 6) of the posterior-mean records."""
    jl, tl, _ = _pair(False, num_rows=300, num_users=14, num_items=11, K=4)
    js, ts = _start(jl)
    _, jh = jl.run(js, num_iter=7, verbose=False)
    _, th = tl.run(ts, num_iter=7, verbose=False, chunk=3)
    assert len(th) == 7
    for a, b in zip(jh, th):
        for k in ("rmse", "rmse_this", "rmse_all_but5", "mae", "alpha"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
        for k in ("w_lambda", "v_lambda"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        for fam in tm.NAN_FAMILIES:
            assert b[f"nan_{fam}"] == a[f"nan_{fam}"] == 0
    assert th[6]["rmse_all_but5"] != th[6]["rmse"]
    np.testing.assert_allclose(tl.final_test_predictions(None),
                               jl.final_test_predictions(None), rtol=1e-5)


def _oracle_for(tl, tr, cls, **kw):
    ts = tl.init_state()
    orc = cls(tr.row, tr.col, tr.val, tr.target, tl.cfg.num_attributes,
              tl.cfg.num_factor, groups=tl.meta.attr_group, regw=0.05,
              regv=0.05, **kw)
    orc.init(float(ts.w0), ts.w.numpy(), ts.v.numpy())
    return ts, orc


@pytest.mark.parametrize("oracle", ["ALSOracle", "BinOrderALSOracle"])
def test_als_matches_float64_oracle(oracle):
    """factor_block=1 is the reference's factor-sequential chain
    (ALSOracle); factor_block=0 the blocked sweep's (bin, factor, column)
    order (BinOrderALSOracle), as test_mcmc.py:32-53,92-115."""
    fb = 1 if oracle == "ALSOracle" else 0
    K = 3 if fb == 1 else 4
    jl, tl, tr = _pair(True, K=K, factor_block=fb, regw=0.05, regv=0.05)
    if oracle == "ALSOracle":
        ts, orc = _oracle_for(tl, tr, ALSOracle)
    else:
        ts, orc = _oracle_for(tl, tr, BinOrderALSOracle, color=tl.plan.color)
    np.testing.assert_allclose(ts.e.numpy(), orc.e, rtol=2e-4, atol=2e-4)
    for _ in range(3):
        ts, _nans = tl.step(ts)
        orc.iterate()
        np.testing.assert_allclose(float(ts.w0), orc.w0, rtol=2e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(ts.w.numpy(), orc.w, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(ts.v.numpy(), orc.v, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(ts.e.numpy(), orc.e, rtol=5e-3, atol=5e-3)


def _random_block(seed=0, F=6, C=17):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return dict(
        s0=f32(rng.standard_normal((F, C))),
        sh2=f32(np.abs(rng.standard_normal((F, C)))),
        m_x=f32(rng.standard_normal((F, F, C))),
        v_c=f32(rng.standard_normal((C, F))),
        mu=f32(rng.standard_normal((C, F))),
        lam=f32(np.abs(rng.standard_normal((C, F))) + 0.3),
        zmat=f32(rng.standard_normal((F, C))))


@pytest.mark.parametrize("nan_lambda", [False, True])
def test_exact_block_draws_matches_jax(nan_lambda):
    """test_mcmc.py:247-292's inputs: with a NaN lambda for column 3 the
    solve is not finite, the loop runs, and the column comes out 0,
    uncounted."""
    b = _random_block()
    if nan_lambda:
        b["lam"][3, :] = np.nan
    args = [b[k] for k in ("s0", "sh2", "m_x", "v_c", "mu", "lam")]
    want, wnan, winf = jax.jit(jm.exact_block_draws)(
        *map(jnp.asarray, args), 1.7, jnp.asarray(b["zmat"]))
    got, gnan, ginf = km.exact_block_draws(
        *map(torch.from_numpy, args), torch.tensor(1.7),
        torch.from_numpy(b["zmat"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert (int(gnan), int(ginf)) == (int(wnan), int(winf)) == (0, 0)
    if nan_lambda:
        assert (got.numpy()[3] == 0.0).all()
    # ALS: no noise table
    want_a, _, _ = jax.jit(jm.exact_block_draws)(
        *map(jnp.asarray, args), 1.7, None)
    got_a, _, _ = km.exact_block_draws(*map(torch.from_numpy, args),
                                       torch.tensor(1.7), None)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("als", [False, True])
def test_col_draw_and_patch_twins_match_block_pass_on_one_bin(als):
    """X8d, X8a and X8b twins on bin 0 of a factor block against the JAX
    ``_v_block_pass`` run on a one-bin plan: the drawn factors, the patched
    residual and the patched q cache.  Gibbs draws with the z table of the
    same key; ALS runs factor-Jacobi."""
    cfg_kw = (dict(mcmc_factor_jacobi=True, regv=0.05) if als
              else dict(regv=0.1))
    jl, tl, _ = _pair(als, num_rows=300, num_users=14, num_items=11, K=4,
                      **cfg_kw)
    js, ts = _start(jl)
    jcfg, exact = jl.cfg, not als
    F, D = 4, tl.cfg.num_attributes
    jplan = jl.plan_data.replace(blocks=jl.plan_data.blocks[:1])
    pspec = plan_specs_for(jplan)
    rep, shd = P(), P(DATA_AXIS)
    mu_t = jnp.asarray(np.full((D, F), 0.05, np.float32))
    lam_t = jnp.asarray(np.full((D, F), 2.0, np.float32))
    alpha = jnp.float32(1.3)

    def fn(e, v_t, key, plan, row):
        e, v_t, q, _key = jm._v_block_pass(e, v_t, mu_t, lam_t, key, plan,
                                           row, jcfg, alpha,
                                           exact_seq=exact)
        return e, v_t, q

    je, jv, jq = jax.jit(jax.shard_map(
        fn, mesh=jl.mesh, in_specs=(shd, rep, rep, pspec, jm._row_specs()),
        out_specs=(shd, rep, P(None, DATA_AXIS))))(
            js.e, js.v.T, js.key, jplan, jl.train_row)

    row = tl.train_row
    e, v_t = ts.e.clone(), ts.v.T.contiguous()
    z = ts.draws.normal((F, D)) if not als else None
    ptab = torch.cat([v_t, torch.zeros(D, F)], 1)
    q = kv.build_q_plain(ptab, F, row.ids, row.vals)
    nans = torch.zeros(2, dtype=torch.int32)
    mu_g, lam_g = torch.full((2, F), 0.05), torch.full((2, F), 2.0)
    for blk in tl.plan_data.blocks[0]:
        km.mcmc_col_draw_plain(blk.rows, blk.x, blk.cols, blk.group, e, q,
                               ptab, v_t, mu_g, lam_g, torch.tensor(1.3), z,
                               exact, nans)
    km.mcmc_patch_rows_plain(ptab, F, row.ids, row.vals, q, e)
    n = tl.train_n
    np.testing.assert_allclose(v_t.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(e.numpy(), np.asarray(je)[:n], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq).T[:n], rtol=1e-5,
                               atol=1e-6)
    assert nans.tolist() == [0, 0]
    changed = (v_t != ts.v.T).any(1)
    assert changed.any() and not changed.all()  # bin 0's columns only


def test_maybe_sample_guard_order():
    """test_mcmc.py:202-223: a non-finite sigma^2 zeroes the draw before
    the count (uncounted); a finite negative one gives a NaN draw, counted
    and reverted; a bad mean without the guard is counted; count_mask
    restricts the count."""
    z = torch.tensor(np.random.default_rng(0).standard_normal(4),
                     dtype=torch.float32)
    counters = zero_counters(tm.NAN_FAMILIES, "cpu")
    out = tm._maybe_sample(True, z, torch.zeros(4),
                           torch.tensor([1.0, -1.0, np.nan, 1.0]),
                           torch.zeros(4), counters=counters, count_as="w")
    assert int(counters["nan_w"]) == 1
    assert torch.isfinite(out).all() and out[2] == 0.0
    out2 = tm._maybe_sample(True, z, torch.full((4,), np.nan), torch.ones(4),
                            torch.zeros(4), zero_on_bad_sigma=False,
                            counters=counters, count_as="w0")
    assert int(counters["nan_w0"]) == 4
    assert (out2 == 0.0).all()  # reverted to old
    counters2 = zero_counters(tm.NAN_FAMILIES, "cpu")
    tm._maybe_sample(True, z, torch.full((4,), np.nan), torch.ones(4),
                     torch.zeros(4), zero_on_bad_sigma=False,
                     counters=counters2, count_as="v",
                     count_mask=torch.tensor([True, False, True, False]))
    assert int(counters2["nan_v"]) == 2


def test_w_sweep_keeps_e_equal_to_yhat_minus_y():
    """MCMC's e is yhat - y, the opposite of VB's: after the w sweep (X8c +
    the w patch with dtab = w_new - w_old) e is the residual of the new w."""
    _, tl, _ = _pair(False, num_rows=300, num_users=14, num_items=11, K=2)
    s = tl.init_state()
    cfg, row, plan = tl.cfg, tl.train_row, tl.plan_data
    e, w = s.e.clone(), s.w.clone()
    counters = zero_counters(tm.NAN_FAMILIES, "cpu")
    tm.w_sweep_main(e, w, s.w_mu, torch.full((2,), 3.0), s.alpha, plan, row,
                    cfg, s.draws, counters)
    assert not torch.allclose(w, s.w)
    want = fm_scores(s.w0, w, s.v, row.ids, row.vals) - row.target
    np.testing.assert_allclose(e.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the w patch alone: e += x (w_new - w_old) over each row
    dtab = torch.zeros(cfg.num_attributes, 2)
    dtab[:, 0] = w - s.w
    e2 = s.e.clone()
    kv.w_patch_rows_plain(dtab, row.ids, row.vals, e2)
    np.testing.assert_allclose(e2.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_mcmc_w_draw_twin_counts_and_zeroes():
    """X8c's twin on a bucket whose group lambda is NaN: the bad-sigma
    columns come out 0 and uncounted; an Inf noise number is counted and
    reverted."""
    _, tl, _ = _pair(False, num_rows=300, num_users=14, num_items=11, K=2)
    s = tl.init_state()
    blk = tl.plan_data.blocks[0][0]
    D = tl.cfg.num_attributes
    w = s.w.clone()
    z = torch.zeros(D)
    z[blk.cols[0].long()] = np.inf
    lam = torch.tensor([2.0, np.nan])
    dtab, bad = torch.zeros(D, 2), torch.zeros(4, dtype=torch.int32)
    kw.mcmc_w_draw_plain(blk.rows, blk.x, blk.cols, blk.group, blk.sx2, s.e,
                         w, s.w_mu, lam, s.alpha, z, dtab, bad)
    cl = blk.cols.long()
    bad_sigma = blk.group == 1
    assert (w[cl][bad_sigma] == 0).all()
    inf_cols = (~bad_sigma) & (z[cl] == np.inf)
    assert int(bad[1]) == int(inf_cols.sum()) and int(bad[0]) == 0
    assert torch.equal(w[cl][inf_cols], s.w[cl][inf_cols])
    assert torch.equal(dtab[cl, 0], w[cl] - s.w[cl])


def test_draw_sources():
    """The host-table source gives the CPU generator's numbers; the default
    source is a generator on the device; Gamma draws are positive."""
    a, b = host_draws(5, "cpu"), device_draws(5, "cpu")
    np.testing.assert_array_equal(a.normal((3, 2)).numpy(),
                                  b.normal((3, 2)).numpy())
    g = a.gamma(torch.tensor([[0.5], [3.0]]))
    assert g.shape == (2, 1) and (g > 0).all()
    assert a.gamma(torch.tensor(2.0)).shape == ()


def test_factor_width():
    cfg = FMConfig(num_attributes=5, num_factor=4)
    widths = [tm.factor_width(dataclasses.replace(cfg, factor_block=fb))
              for fb in (0, 1, 2, 3, 8)]
    assert widths == [4, 1, 2, 3, 4]


@pytest.mark.parametrize("K,jacobi,want", [
    (20, False, 20), (256, False, 256), (303, False, 303), (512, False, 256),
    (600, False, 300), (307, False, 1), (512, True, 512)])
def test_factor_width_fits_col_draw_shared_memory(K, jacobi, want):
    """factor_block=0 takes K, or the widest divisor of K whose X8a block
    fits the card's shared memory (the exact mode's M grows as F^2/2; the
    factor-Jacobi mode drops it); an explicit width is kept."""
    cfg = FMConfig(num_attributes=5, num_factor=K, factor_block=0,
                   do_sample=not jacobi, mcmc_factor_jacobi=jacobi)
    F = tm.factor_width(cfg)
    assert F == want
    assert km.col_draw_smem(F, not jacobi) <= km.MAX_BLOCK_SMEM
    assert not km.col_draw_fits(304, True) and km.col_draw_fits(303, True)
    assert tm.factor_width(dataclasses.replace(cfg, factor_block=512)) == min(
        K, 512)


def _converge_setup(als):
    coo, tr, te = _data(num_rows=3000, num_users=30, num_items=25)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 30])
    reg = dict(regw=0.1, regv=0.1) if als else {}
    cfg = FMConfig(num_attributes=D, num_factor=4, num_groups=2, seed=7,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), **reg)
    cls = tm.ALSLearner if als else tm.MCMCLearner
    return cls(cfg, SparseDataset.from_coo(tr, D),
               SparseDataset.from_coo(te, D), meta, device="cpu",
               write_files=False)


def test_gibbs_converges_with_own_generator():
    _, history = _converge_setup(False).run(num_iter=15, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    assert history[-1]["rmse"] < 1.0
    assert np.isfinite(history[-1]["alpha"])
    for fam in tm.NAN_FAMILIES:
        assert history[-1][f"nan_{fam}"] == history[-1][f"inf_{fam}"] == 0


def test_als_converges():
    learner = _converge_setup(True)
    state, history = learner.run(num_iter=10, verbose=False)
    assert history[-1]["rmse_this"] < history[0]["rmse_this"]
    assert history[-1]["rmse_this"] < 1.0
    # ALS predicts from the last state, not the posterior mean
    np.testing.assert_allclose(
        learner.final_test_predictions(state),
        np.clip(learner.predict_test_scores(state), learner.cfg.min_target,
                learner.cfg.max_target))


@pytest.fixture
def cli_data(tmp_path):
    coo = make_movielens_like(num_users=30, num_items=20, num_ratings=600,
                              seed=1)
    tr, te = train_test_split(coo, 0.2, seed=2)
    save_libfm_text(str(tmp_path / "tr.libfm"), tr)
    save_libfm_text(str(tmp_path / "te.libfm"), te)
    return tmp_path, te


@pytest.mark.parametrize("method", ["mcmc", "als"])
def test_cli_mcmc_and_als(cli_data, method, monkeypatch, capsys):
    """Both methods write what the JAX CLI writes (test_rmse_114_mcmc: the
    reference rewrites als to mcmc), the -out predictions and the Final
    line; -regular and -init_stdev are read."""
    d, te = cli_data
    args = ["-task", "r", "-train", str(d / "tr.libfm"), "-test",
            str(d / "te.libfm"), "-dim", "1,1,4", "-iter", "3", "-method",
            method, "-out", "pred.txt", "-regular", "0.1", "-init_stdev",
            "0.05"]
    names = {}
    for who, fn, extra in (("torch", cli.main, ["-device", "cpu"]),
                           ("jax", jax_main, [])):
        (d / who).mkdir()
        monkeypatch.chdir(d / who)
        assert fn(args + extra) == 0
        names[who] = sorted(os.listdir(d / who))
    out = capsys.readouterr().out
    assert names["torch"] == names["jax"] == sorted(
        ["v_file.txt", "pred.txt", "test_rmse_114_mcmc"])
    monkeypatch.chdir(d / "torch")
    pred = np.loadtxt("pred.txt")
    assert pred.shape == (te.num_rows,)
    assert ((pred >= 1.0) & (pred <= 5.0)).all()
    assert np.loadtxt("test_rmse_114_mcmc").shape == (3,)
    assert "Test(this)=" in out


def test_cli_refuses_factor_jacobi_with_sampling(cli_data):
    d, _ = cli_data
    args = ["-task", "r", "-train", str(d / "tr.libfm"), "-test",
            str(d / "te.libfm"), "-method", "mcmc", "-factor_jacobi", "1",
            "-device", "cpu"]
    with pytest.raises(SystemExit) as ei:
        cli.main(args)
    assert "factor_jacobi" in str(ei.value.code)


def test_ragged_kernel_case_twins_on_cpu():
    """chip_smoke.py's ragged MCMC case, which holds X8a and X8c against
    their twins on the card, exercises what it claims: column 3's NaN
    lambda gives 0s, uncounted; the Inf noise number one counted,
    reverted draw, in the exact mode only."""
    import chip_smoke

    s = chip_smoke.ragged_mcmc_tensors("cpu")
    cases = chip_smoke.make_cases(s)
    col3 = s["m_buckets"][0]["cols"][3].long()
    for label, prepare, call, _ in cases["mcmc_col_draw"]:
        ptab, vt, nans = call("plain", prepare())
        assert nans.tolist() == ([0, 0] if "jacobi" in label else [0, 1])
        assert (vt[col3] == 0).all() and torch.isfinite(vt).all()
    for label, prepare, call, _ in cases["mcmc_w_draw"]:
        w, _dtab, bad = call("plain", prepare())
        assert bad.tolist() == ([0, 0, 0, 0] if "als" in label
                                else [0, 1, 0, 0])
        assert w[col3] == 0 and torch.isfinite(w).all()
    for _, prepare, call, _ in cases["gather_probe"]:
        (o,) = call("plain", prepare())
        assert torch.isfinite(o).all()


@pytest.mark.parametrize("C,L,G", [
    (1, 1, 1), (9, 2, 2), (9, 7, 8), (9, 16, 16), (9, 17, 32), (14, 128, 32),
    (6026, 256, 32), (2339, 256, 32), (2047, 256, 64), (2048, 257, 64),
    (1613, 512, 128), (2048, 512, 64), (5000, 1024, 128), (3, 5000, 128)])
def test_col_draw_f1_form_is_a_function_of_c_and_l(C, L, G):
    """X8a's lanes a column at F = 1 (csrc/mcmc_sweep.cu:f1_lanes): the
    next power of two >= L up to L = 16, else a warp, 8 slots a lane, or
    2-4 warps on long columns (past 256 slots, or 128 where the bucket has
    fewer than 2,048 columns).  With each load width L allows, the
    launch's threads (256 a block, G a column) reach every column once
    and read each of its slots once."""
    G_got = km.col_draw_f1_lanes(C, L)
    assert G_got == G
    blocks = -(-C * G // 256)
    owners = {}
    for blk in range(blocks):
        for tid in range(256):
            c = blk * (256 // G) + tid // G
            if c < C:
                owners.setdefault(c, []).append(tid % G)
    assert sorted(owners) == list(range(C))
    assert all(sorted(v) == list(range(G)) for v in owners.values())
    for V in (1, 2, 4):
        if (G < 32 and V > 1) or L % V:
            continue
        kR, nch, slots = 4 // V, L // V, []  # kF1Slots = 4
        for li in range(G):
            for j0 in range(li, nch, G * kR):
                for i in range(kR):
                    j = j0 + i * G
                    if j < nch:
                        slots.extend(range(j * V, j * V + V))
        assert sorted(slots) == list(range(L)), V


@pytest.mark.parametrize("shift,L,vec", [
    (0, 256, 4), (1, 256, 1), (2, 256, 2), (0, 258, 2), (0, 33, 1),
    (2, 33, 1), (0, 16, 1), (0, 1000, 4)])
def test_col_draw_f1_plan_reads_the_alignment(shift, L, vec):
    """X8a's load width at F = 1 (csrc/mcmc_sweep.cu:f1_vec): 16-byte loads
    of rows and x where L is a multiple of 4 and both bases are 16-byte
    aligned, 8-byte ones where L is even and they are 8-byte aligned, else
    4-byte; always 4-byte where a column has fewer than 32 lanes."""
    C = 5
    buf = torch.zeros(C * L + shift, dtype=torch.int32)
    rows = buf[shift:].view(C, L)
    x = torch.zeros(C, L)
    assert x.data_ptr() % 16 == 0 and buf.data_ptr() % 16 == 0
    assert km.col_draw_f1_plan(rows, x) == (km.col_draw_f1_lanes(C, L), vec)


@pytest.mark.parametrize("F,q_shift,p_shift,plan", [
    (1, 0, 0, ("rows", 1, 1, 32)),
    (20, 0, 0, ("chunks", 4, 5, 6)),
    (20, 1, 0, ("chunks", 1, 20, 1)),
    (20, 2, 0, ("chunks", 2, 10, 3)),
    (20, 0, 2, ("chunks", 2, 10, 3)),
    (20, 0, 1, ("chunks", 1, 20, 1)),
    (2, 0, 0, ("chunks", 2, 1, 32)),
    (3, 0, 0, ("chunks", 1, 3, 10)),
    (5, 0, 0, ("chunks", 1, 5, 6)),
    (33, 0, 0, ("chunks", 1, 32, 1)),
    (64, 0, 0, ("chunks", 4, 16, 2)),
    (64, 1, 0, ("chunks", 1, 32, 1)),
    (136, 0, 0, ("chunks", 4, 32, 1))])
def test_patch_plan_is_the_cu_rule(F, q_shift, p_shift, plan):
    """X8b's form (csrc/mcmc_sweep.cu:svbfm_mcmc_patch_rows): a thread a
    row at F = 1; at F >= 2 chunks of the widest of 4, 2, 1 factors that
    divides F and to whose size the bases of q and ptab are aligned (q or
    ptab one or two floats past a 16-byte boundary narrows them),
    min(F / vec, 32) lanes a row, 32 // lanes rows a warp.  Walking the
    launch over a ragged N reaches every (row, chunk) once."""
    N, D = 53, 7

    def view(shape, shift):
        buf = torch.zeros(shape[0] * shape[1] + shift)
        assert buf.data_ptr() % 16 == 0
        return buf[shift:].view(shape)

    p = km.patch_plan(view((D, 2 * F), p_shift), F, view((N, F), q_shift))
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
                seen += [(n, ch) for ch in range(j, G, p.lanes)]
    assert sorted(seen) == [(n, ch) for n in range(N) for ch in range(G)]


def test_build_q_starts_from_q_extra_in_jax_order():
    """X8d's starting q (the block-structure learner's relation part of the
    cache): build_q_plain adds the positions onto q0 in order, as JAX's
    build_q adds them onto q_extra (svbfm_tpu/learners/mcmc.py:337-347,
    replayed here in jnp on the [F, N] layout), bit for bit; a q0 of 1e8
    against a first position of -1e8 and a second of 1 shows the order:
    (1e8 - 1e8) + 1 = 1 there, where adding q0 last gives 0."""
    rng = np.random.default_rng(8)
    N, P, D, F = 37, 3, 11, 5
    ids = rng.integers(0, D, (N, P)).astype(np.int32)
    vals = rng.uniform(-1, 2, (N, P)).astype(np.float32)
    v_t = rng.normal(0, 1, (D, F)).astype(np.float32)
    q0 = rng.normal(0, 3, (N, F)).astype(np.float32)
    ids[0], vals[0] = (1, 2, 0), (1.0, 1.0, 0.0)
    v_t[1, 0], v_t[2, 0], q0[0, 0] = -1e8, 1.0, 1e8
    ptab = np.concatenate([v_t, np.zeros_like(v_t)], 1)  # [D, 2F]
    qj = jnp.asarray(q0.T)
    for p in range(P):
        qj = qj + (jnp.take(jnp.asarray(v_t.T), jnp.asarray(ids[:, p]),
                            axis=-1) * jnp.asarray(vals[:, p])[None])
    got = kv.build_q_plain(torch.from_numpy(ptab), F, torch.from_numpy(ids),
                           torch.from_numpy(vals), torch.from_numpy(q0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(qj).T)
    assert got[0, 0].item() == 1.0
    late = kv.build_q_plain(torch.from_numpy(ptab), F, torch.from_numpy(ids),
                            torch.from_numpy(vals)) + torch.from_numpy(q0)
    assert late[0, 0].item() == 0.0
