"""Classification (``task=1``) and the Poisson task (``task=2``) in the port
against the JAX package: the probit helpers, the plain twins of X12a and
X12b, and every learner, each started from the JAX learner's init
(``utils.convert``), Gibbs and the SGD family with the JAX key chains
replayed (``JaxKeyDraws``, ``JaxSGDKeys``, ``JaxSGDAKeys``), at the JAX
tests' own classification shapes (test_vb.py's 96-row ``_setup``,
test_mcmc.py:80's 3,000 rows, test_vb_online.py:88, test_sgd.py:41).

Tolerances (float32 sums taken in another order; XLA's exp and log10 and
torch's differ by an ulp):
  * helpers and the erfinv twin: rtol 1e-6 / atol 2.4e-7 (two ulps at 1)
    where they are well conditioned; the truncated means through the
    reference's A&S erf lose digits in the tail, where 1 - Phi(-mu)
    cancels: there one ulp of exp moves them by up to 2e-3 relative
    (|mu| <= 4), which is the bound;
  * the twins of X12a/X12b against JAX's expressions: the same, and the
    accuracy equal, the log-likelihood at rtol 1e-5;
  * VB, 3 sweeps: parameters rtol 3e-3, free energy 2e-3 (test_vb.py:58-64),
    accuracy within one test row, loglik rtol 2e-3;
  * Gibbs and ALS, 3 sweeps: test_torch_mcmc.py's tolerances (w0, w, v
    rtol 1e-4 / atol 5e-5, hyperparameters 1e-5 / 1e-6), e at atol 2e-3:
    the Gibbs latent draw passes e through erfinv, whose slope near the
    clip amplifies an ulp of Phi(-e); the key chains equal;
  * OVB, SGD, SGDA, exp_sgd_stoc: their learner tests' tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import base as jb
from svbfm_tpu.learners import exp_sgd as jx
from svbfm_tpu.learners import mcmc as jm
from svbfm_tpu.learners import sgd as js
from svbfm_tpu.learners import vb as jvb
from svbfm_tpu.learners import vb_online as jov
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels import probit as kp
from svbfm_tpu_torch.learners import base as tb
from svbfm_tpu_torch.learners import exp_sgd as tx
from svbfm_tpu_torch.learners import mcmc as tm
from svbfm_tpu_torch.learners import sgd as ts
from svbfm_tpu_torch.learners import vb as tvb
from svbfm_tpu_torch.learners import vb_online as tov
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.utils.convert import (exp_sgd_state_from_jax,
                                           mcmc_state_from_jax,
                                           ovb_state_from_jax,
                                           sgd_state_from_jax,
                                           sgda_state_from_jax,
                                           state_from_jax)

from test_torch_mcmc import JaxKeyDraws
from test_torch_sgd import JaxSGDAKeys, JaxSGDKeys

HELPERS = ("ref_erf", "ref_cdf_gaussian", "truncnorm_mean_positive",
           "truncnorm_mean_negative")


def _x(n=100_000, seed=0, scale=3.0):
    x = np.random.default_rng(seed).normal(0, scale, n).astype(np.float32)
    x[:4] = [0.0, -0.0, 1e-30, -1e-30]
    return x


@pytest.mark.parametrize("name", HELPERS)
def test_helpers_match_jax(name):
    x = _x()
    ref = np.asarray(getattr(jb, name)(jnp.asarray(x)))
    got = getattr(tb, name)(torch.from_numpy(x)).numpy()
    if name.startswith("truncnorm"):
        calm = np.abs(x) <= 1.0
        np.testing.assert_allclose(got[calm], ref[calm], rtol=1e-6,
                                   atol=2.4e-7)
        tail = (np.abs(x) > 1.0) & (np.abs(x) <= 4.0)
        np.testing.assert_allclose(got[tail], ref[tail], rtol=2e-3)
        return
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2.4e-7)


def test_truncated_means_overflow_where_jax_does():
    """Past |mu| of about 5.7 the reference's A&S Phi(-mu) is exactly 0 or
    1 in float32 and the far tail's truncated mean is infinite, in both
    packages alike: why batch VB's fast mode turns NaN on the ML-1M
    classification recipe (chip_smoke.py's vb-class-fast)."""
    mu = np.float32([6.0, 8.0, -6.0, -8.0, 5.0, -5.0])
    for name in ("truncnorm_mean_negative", "truncnorm_mean_positive"):
        ref = np.asarray(getattr(jb, name)(jnp.asarray(mu)))
        got = getattr(tb, name)(torch.from_numpy(mu)).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
        assert np.isinf(got).sum() == 2 and np.isfinite(got[4:]).all()


def test_erfinv_twin_matches_jax():
    """Giles' polynomial, written out in the twin (and the kernel), against
    jax.scipy.special.erfinv on 10^5 points of [-1 + 2e-7, 1 - 2e-7] and
    the last steps below 1, where the draw's clip lands."""
    x = np.concatenate([
        np.linspace(-1 + 2e-7, 1 - 2e-7, 100_000, dtype=np.float32),
        np.float32(1) - np.float32(6e-8) * np.arange(2, 40, dtype=np.float32),
        np.float32([0.0, 0.5, -0.5])])
    ref = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    got = kp.erfinv_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2.4e-7)
    ends = kp.erfinv_plain(torch.tensor([1.0, -1.0, float("nan")]))
    assert ends[0] == float("inf") and ends[1] == -float("inf")
    assert torch.isnan(ends[2])


def _latent_inputs(n=20_000, seed=1):
    rng = np.random.default_rng(seed)
    e = rng.normal(0, 2.5, n).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    y[:50] = 0.0  # y >= 0 takes the positive branch
    u = rng.uniform(1e-7, 1 - 1e-7, n).astype(np.float32)
    u[50:60] = np.float32(1e-7)
    u[60:70] = np.float32(1 - 1e-7)
    return e, y, u


def _jax_latent(e, y, u, mode):
    """The JAX expressions: vb.py:1015-1019, mcmc.py:1083-1090."""
    e, y, u = map(jnp.asarray, (e, y, u))
    if mode == kp.PROBIT_GIBBS:
        lo = jb.ref_cdf_gaussian(-e)
        cdf = jnp.where(y >= 0, lo + u * (1 - lo), u * lo)
        cdf = jnp.clip(cdf, 1e-7, 1 - 1e-7)
        sampled = e + jnp.sqrt(2.0) * jax.scipy.special.erfinv(2 * cdf - 1)
        return np.asarray(e - sampled)
    sampled = jnp.where(y >= 0, jb.truncnorm_mean_positive(e),
                        jb.truncnorm_mean_negative(e))
    return np.asarray(sampled - e if mode == kp.PROBIT_VB else e - sampled)


@pytest.mark.parametrize("mode", [kp.PROBIT_VB, kp.PROBIT_ALS,
                                  kp.PROBIT_GIBBS])
def test_probit_latent_twin_matches_jax(mode):
    e, y, u = _latent_inputs()
    ref = _jax_latent(e, y, u, mode)
    t = torch.from_numpy(e.copy())
    kp.probit_latent(t, torch.from_numpy(y),
                     torch.from_numpy(u) if mode == kp.PROBIT_GIBBS else None,
                     mode)
    got = t.numpy()
    # well conditioned rows at rtol 1e-6; every row within the A&S erf's
    # tail conditioning (see the module docstring)
    calm = np.abs(e) <= 1.0
    np.testing.assert_allclose(got[calm], ref[calm], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("it", [None, 2, 6])
def test_probit_eval_twin_matches_jax(it):
    """VB's eval (it None) and Gibbs's, before and after all_but5 starts
    (mcmc.py:1046-1068), with padding rows (valid 0) and a NaN-free
    accumulator carried in."""
    rng = np.random.default_rng(3)
    n = 5_000
    s = rng.normal(0, 1.5, n).astype(np.float32)
    yt = np.where(rng.random(n) < 0.4, 1.0, -1.0).astype(np.float32)
    valid = (np.arange(n) < n - 30).astype(np.float32)
    nt = float(n - 30)
    prob = np.asarray(jb.ref_cdf_gaussian(jnp.asarray(s)))

    def jscore(p):
        hit = ((p >= 0.5) & (yt > 0)) | ((p < 0.5) & (yt < 0))
        m = (yt + 1.0) * 0.5
        pll = jnp.clip(p, 0.01, 0.99)
        ll = -jnp.sum((m * jnp.log10(pll) + (1 - m) * jnp.log10(1 - pll))
                      * valid) / nt
        return float(jnp.sum(hit * valid) / nt), float(ll)

    if it is None:
        got = kp.probit_eval(torch.from_numpy(s), torch.from_numpy(yt),
                             torch.from_numpy(valid), nt).numpy()
        ref = jscore(prob) * 2
    else:
        pa0 = rng.uniform(0, it, n).astype(np.float32)
        pb0 = rng.uniform(0, 1, n).astype(np.float32)
        pa, pb = torch.from_numpy(pa0.copy()), torch.from_numpy(pb0.copy())
        got = kp.probit_eval(torch.from_numpy(s), torch.from_numpy(yt),
                             torch.from_numpy(valid), nt, pa, pb, it).numpy()
        jpa = pa0 + prob
        jpb = pb0 + np.where(it >= 5, prob, 0.0)
        np.testing.assert_allclose(pa.numpy(), jpa, rtol=1e-6)
        np.testing.assert_allclose(pb.numpy(), jpb, rtol=1e-6)
        ref = jscore(jpa / (it + 1.0)) + jscore(prob)
    for k in (0, 2):
        assert abs(got[k] - ref[k]) * nt < 0.5  # within one test row
    for k in (1, 3):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)


# ---------------------------------------------------------------------------
# The learners
# ---------------------------------------------------------------------------

def _binary(num_rows, num_users, num_items, seed, holdout=0.25):
    """make_movielens_like data split as the JAX tests do, the targets
    binarised at the train median (test_vb_online.py:88)."""
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=seed)
    tr, te = train_test_split(coo, holdout, seed=seed + 1)
    thr = np.median(tr.target)
    for c in (tr, te):
        c.target = np.where(c.target > thr, 1.0, -1.0).astype(np.float32)
    return coo.num_features, tr, te


def _pair(jcls, tcls, num_rows, num_users, num_items, seed=2, K=3,
          holdout=0.25, jkw=None, tkw=None, **cfg_kw):
    D, tr, te = _binary(num_rows, num_users, num_items, seed, holdout)
    kw = dict(num_attributes=D, num_factor=K, task=1, min_target=-1.0,
              max_target=1.0, seed=7, **cfg_kw)
    jmeta = JMeta.from_field_offsets(D, [0, num_users])
    tmeta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    jl = jcls(JConfig(num_groups=jmeta.num_attr_groups, **kw),
              JDataset.from_coo(tr, D), JDataset.from_coo(te, D), jmeta,
              mesh=make_mesh(1), write_files=False, **(jkw or {}))
    tl = tcls(FMConfig(num_groups=tmeta.num_attr_groups, **kw),
              SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
              tmeta, device="cpu", write_files=False, **(tkw or {}))
    return jl, tl


def _close(t, j, names, n=None, **tol):
    for k in names:
        ref = np.asarray(getattr(j, k))
        if k == "e" and n is not None:
            ref = ref[:n]
        np.testing.assert_allclose(getattr(t, k).numpy(), ref, err_msg=k,
                                   **tol)


def _records_close(th, jh, nt, keys=("accuracy", "loglik")):
    assert len(th) == len(jh)
    for a, b in zip(jh, th):
        for k in keys:
            if k.startswith("acc"):
                assert abs(b[k] - a[k]) * nt < 1.5, (k, a[k], b[k])
            else:
                np.testing.assert_allclose(b[k], a[k], rtol=2e-3, err_msg=k)


VB_CASES = {"fast": dict(factor_block=0), "exact": dict(factor_block=1),
            "K=0": dict(K=0)}


@pytest.mark.parametrize("case", list(VB_CASES))
def test_vb_classification_matches_jax(case):
    """3 sweeps: the probit eval, then the truncated-mean update of e
    (vb.py:1002-1019), in fast mode, exact mode and at K = 0."""
    jl, tl = _pair(jvb.VBLearner, tvb.VBLearner, 96, 9, 7, **VB_CASES[case])
    js = jl.init_state()
    ts = state_from_jax(jax.device_get(js), "cpu")
    jend, jh = jl.run(js, num_iter=3, verbose=False)
    tend, th = tl.run(ts, num_iter=3, verbose=False, chunk=2)
    _close(tend, jend, ("e", "t", "mu_0", "mu_w", "mu_v", "sigma_w_dash",
                        "sigma_v_dash", "alpha", "sigma_w", "sigma_v"),
           tl.train_n, rtol=3e-3, atol=1e-5)
    _records_close(th, jh, tl.test_n)
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["free_energy"], a["free_energy"],
                                   rtol=2e-3)
    assert "rmse" not in th[0]


MCMC_CASES = {"gibbs fb0": (False, 0), "gibbs fb1": (False, 1),
              "als fb0": (True, 0), "als fb1": (True, 1)}


@pytest.mark.parametrize("case", list(MCMC_CASES))
def test_mcmc_classification_matches_jax(case):
    """3 iterations at test_mcmc.py:80's shape: the posterior-mean probit
    records, the latent update (Gibbs: the erfinv draw through the
    replayed key chain; ALS: the truncated mean, with the key split JAX
    makes and does not use), the end state and final_test_predictions."""
    als, fb = MCMC_CASES[case]
    jl, tl = _pair(jm.ALSLearner if als else jm.MCMCLearner,
                   tm.ALSLearner if als else tm.MCMCLearner, 3000, 30, 25,
                   K=4, factor_block=fb, regw=0.1, regv=0.1)
    js = jl.init_state()
    ts = mcmc_state_from_jax(jax.device_get(js), "cpu", JaxKeyDraws(js.key))
    jend, jh = jl.run(js, num_iter=3, verbose=False)
    tend, th = tl.run(ts, num_iter=3, verbose=False, chunk=2)
    np.testing.assert_array_equal(np.asarray(tend.draws.key),
                                  np.asarray(jend.key))
    _close(tend, jend, ("w0", "w", "v"), rtol=1e-4, atol=5e-5)
    _close(tend, jend, ("alpha", "w_mu", "w_lambda", "v_mu", "v_lambda"),
           rtol=1e-5, atol=1e-6)
    _close(tend, jend, ("e",), tl.train_n, rtol=1e-4, atol=2e-3)
    _records_close(th, jh, tl.test_n,
                   ("accuracy", "loglik", "acc_this", "ll_this"))
    p = tl.final_test_predictions(tend)
    assert ((p >= 0) & (p <= 1)).all()
    np.testing.assert_allclose(p, jl.final_test_predictions(jend),
                               rtol=1e-4, atol=1e-5)


def test_ovb_classification_matches_jax():
    """2 epochs at test_vb_online.py:88's shape (5 chunks): the chunk
    updates on the +-1 targets and the probit eval of each epoch."""
    jl, tl = _pair(jov.OVBLearner, tov.OVBLearner, 2500, 25, 20, seed=9,
                   K=4, holdout=0.2, num_batches=5)
    js = jl.init_state()
    ts = ovb_state_from_jax(jax.device_get(js), "cpu")
    jend, jh = jl.run(js, num_iter=2, verbose=False)
    tend, th = tl.run(ts, num_iter=2, verbose=False)
    _close(tend, jend, ("mu_0", "mu_w", "mu_v", "alpha"), rtol=1e-4,
           atol=1e-5)
    _records_close(th, jh, tl.test_n)
    assert th[-1]["accuracy"] > 0.6


def _sgd_pair(which, task, **kw):
    """test_sgd.py:_setup's learners on binarised (task 1) or count
    (task 2: the stars above 3 as a count, 0-2) targets."""
    coo = make_movielens_like(num_users=30, num_items=25, num_ratings=2000,
                              rank=2, noise=0.4, seed=3)
    tr, te = train_test_split(coo, 0.2, seed=4)
    for c in (tr, te):
        c.target = (np.where(c.target > np.median(tr.target), 1.0, -1.0)
                    if task == 1 else np.maximum(c.target - 3.0, 0.0)
                    ).astype(np.float32)
    D = coo.num_features
    base = dict(num_attributes=D, num_factor=4, task=task,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()), num_groups=2, seed=7,
                learn_rate=0.05, regw=0.01, regv=0.01, batch_size=128, **kw)
    jmeta = JMeta.from_field_offsets(D, [0, 30])
    tmeta = DataMetaInfo.from_field_offsets(D, [0, 30])
    jtr, jte = JDataset.from_coo(tr, D), JDataset.from_coo(te, D)
    ttr, tte = SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D)
    if which == "sgda":
        def val(ds, cls):
            return cls(ids=ds.ids[:400], vals=ds.vals[:400],
                       target=ds.target[:400], num_rows=400,
                       num_features=ds.num_features,
                       min_target=ds.min_target, max_target=ds.max_target,
                       row_nnz=ds.row_nnz[:400])
        return (js.SGDALearner(JConfig(**base), jtr, jte, val(jtr, JDataset),
                               jmeta, mesh=make_mesh(1), write_files=False),
                ts.SGDALearner(FMConfig(**base), ttr, tte,
                               val(ttr, SparseDataset), tmeta, device="cpu",
                               write_files=False))
    jcls, tcls = {"sgd": (js.SGDLearner, ts.SGDLearner),
                  "sgd_online": (js.SGDOnlineLearner, ts.SGDOnlineLearner),
                  "exp_sgd_stoc": (jx.ExpSGDStocLearner,
                                   tx.ExpSGDStocLearner)}[which]
    return (jcls(JConfig(**base), jtr, jte, jmeta, mesh=make_mesh(1),
                 write_files=False),
            tcls(FMConfig(**base), ttr, tte, tmeta, device="cpu",
                 write_files=False))


@pytest.mark.parametrize("task", [1, 2], ids=["c", "p"])
@pytest.mark.parametrize("which", ["sgd", "sgda", "exp_sgd_stoc",
                                   "sgd_online"])
def test_sgd_family_tasks_match_jax(which, task):
    """An epoch (SGDA: 2 iterations, the second with lambda steps) in the
    classification and Poisson modes of X9a (and X9c's classification
    grad_loss, which the Poisson task takes too): parameters, regs and the
    accuracy records."""
    kw = dict(num_batches=4) if which == "sgd_online" else {}
    jl, tl = _sgd_pair(which, task, **kw)
    jstate = jl.init_state()
    n = 2 if which == "sgda" else 1
    if which == "sgda":
        tstate = sgda_state_from_jax(jax.device_get(jstate), "cpu",
                                     JaxSGDAKeys(jstate.key))
    else:
        tstate = sgd_state_from_jax(jax.device_get(jstate), "cpu",
                                    JaxSGDKeys(jstate.key))
    jend, jh = jl.run(jstate, num_iter=n, verbose=False)
    tend, th = tl.run(tstate, num_iter=n, verbose=False)
    for a, b in zip(jh, th):
        assert b["accuracy"] == a["accuracy"] and "rmse" not in b
    _close(tend, jend, ("w0", "w", "v"), rtol=1e-4, atol=1e-6)
    if which == "sgda":
        _close(tend, jend, ("reg_w", "reg_v"), rtol=1e-4, atol=1e-7)
        assert float(tend.reg_w.abs().sum() + tend.reg_v.abs().sum()) > 0
    np.testing.assert_array_equal(np.asarray(tend.draws.key),
                                  np.asarray(jend.key))


def test_exp_sgd_full_batch_classification_matches_jax():
    """The full-batch exp_sgd takes no task branch (exp_sgd.py:186-199): on
    the +-1 targets, 3 sweeps, its clamped-RMSE records and parameters."""
    jl, tl = _pair(jx.ExpSGDLearner, tx.ExpSGDLearner, 200, 12, 9, K=4,
                   learn_rate=0.5)
    js0 = jl.init_state()
    ts0 = exp_sgd_state_from_jax(jax.device_get(js0), "cpu")
    jend, jh = jl.run(js0, num_iter=3, verbose=False)
    tend, th = tl.run(ts0, num_iter=3, verbose=False)
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["rmse"], a["rmse"], rtol=1e-5)
    for t, j in zip((tend.w0, tend.w, tend.v), jend):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-6)
    with pytest.raises(NotImplementedError, match="item 15"):
        tx.ExpSGDLearner(dataclasses.replace(tl.cfg, task=2), None, None,
                         device="cpu")


@pytest.mark.parametrize("cls", [tvb.VBLearner, tov.OVBLearner,
                                 tm.MCMCLearner, tm.ALSLearner])
def test_poisson_task_refused_where_jax_has_no_branch(cls):
    """-task p is the SGD family's (sgd.py:87-100); the probit learners
    refuse it, naming the ROADMAP item."""
    D, tr, te = _binary(96, 9, 7, 2)
    cfg = FMConfig(num_attributes=D, num_factor=2, task=2)
    ds = SparseDataset.from_coo(tr, D)
    with pytest.raises(NotImplementedError, match="item 15"):
        cls(cfg, ds, ds, device="cpu", write_files=False)
