"""Edge dimension configs in the port: k0/k1 off and K = 0 (dim '1,1,0',
'0,0,3', '1,0,2', '0,1,0'), as ``tests/test_edge_configs.py`` runs them
through ``svbfm_tpu``, here through ``svbfm_tpu_torch`` on the CPU (the
kernels' twins): every learner of that test and SGDA, sgd_online and BPR
besides, 3 iterations, finite results and, where k0 is on (not the
full-batch exp_sgd, whose exponential-family multipliers converge
otherwise), test RMSE < 2.0, the JAX test's own bounds; the block-structure
Gibbs and ALS learners likewise.

At each setting the learners whose steps both packages take from the same
numbers are held to ``svbfm_tpu`` from the JAX learner's init, 3 sweeps or
epochs: batch VB, ALS and Gibbs (its key chain replayed, ``JaxKeyDraws``)
state for state, SGD epoch for epoch (its permutations replayed,
``JaxSGDKeys``), and the block-structure ALS learner sweep for sweep.
Tolerances, those of ``test_torch_vb.py``, ``test_torch_mcmc.py``,
``test_torch_sgd.py`` and ``test_torch_bs.py``: rtol 1e-4 / atol 1e-5 on
the parameters (SGD: atol 1e-6), rtol 1e-5 / atol 1e-6 on the
hyperparameters and precisions, counters and key chains equal.  The
residual e is held at rtol 1e-4 and, row by row, atol 1e-5 + 2 eps S, S
the sum of the magnitudes of the row's terms (|y|, |w0|, |x w| and the
factor part's squares, in float64 from the JAX state) and eps float32's:
without k0 the factors carry the targets' mean (|v| up to 21, S up to
~1,000 at '0,0,3'), and e, a difference of such terms, keeps only float32's
resolution of them.  The second witness: each package's e against y and
its own parameters in float64, held at 4 eps S (measured at the four
settings after each of 3 sweeps: at most 0.63 eps S in either package,
but VB's e, a cache patched in place, drifts to 2.16 eps S in the port and
1.89 in JAX at '0,0,3'; between the packages at most 2.92 eps S, and
3.9e-5 absolute at S = 420, ALS at '0,0,3').  At K = 0 the
relation sweeps run X10c's w mode alone.
"""

import jax
import numpy as np
import pytest

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like as jax_movielens_like
from svbfm_tpu.data.synth import train_test_split as jax_split
from svbfm_tpu.learners import mcmc as jm
from svbfm_tpu.learners import mcmc_bs as jbs
from svbfm_tpu.learners import sgd as jsgd
from svbfm_tpu.learners import vb as jvb
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.learners import mcmc_bs as tbs
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.bpr import BPRLearner
from svbfm_tpu_torch.learners.exp_sgd import ExpSGDLearner, ExpSGDStocLearner
from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
from svbfm_tpu_torch.learners.sgd import (SGDALearner, SGDLearner,
                                          SGDOnlineLearner)
from svbfm_tpu_torch.learners import vb as tvb
from svbfm_tpu_torch.learners.vb import VBLearner
from svbfm_tpu_torch.learners.vb_online import OVBLearner
from svbfm_tpu_torch.utils.convert import (mcmc_state_from_jax,
                                           sgd_state_from_jax,
                                           state_from_jax)

from test_torch_bs import JPKG, TPKG, _build, _joined, _problem, _start
from test_torch_mcmc import HYPER, JaxKeyDraws
from test_torch_sgd import JaxSGDKeys

EDGE_DIMS = [(True, True, 0), (False, False, 3), (True, False, 2),
             (False, True, 0)]


def _data(seed=2):
    coo = make_movielens_like(num_users=12, num_items=9, num_ratings=600,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 12])
    return tr, te, D, meta


@pytest.mark.parametrize("k0,k1,K", EDGE_DIMS)
@pytest.mark.parametrize("cls", [VBLearner, ALSLearner, SGDLearner,
                                 OVBLearner, MCMCLearner, ExpSGDLearner,
                                 ExpSGDStocLearner, SGDALearner,
                                 SGDOnlineLearner, BPRLearner])
def test_edge_dims_run_and_stay_finite(k0, k1, K, cls):
    tr, te, D, meta = _data()
    cfg = FMConfig(num_attributes=D, num_factor=K, k0=k0, k1=k1,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7,
                   learn_rate=0.05, regw=0.05, regv=0.05, batch_size=64,
                   num_batches=3)
    train, test = SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D)
    # SGDA validates on the test rows; BPR takes every row as a positive
    args = (cfg, train, test, test, meta) if cls is SGDALearner else (
        cfg, train, test, meta)
    learner = cls(*args, device="cpu", write_files=False)
    _, history = learner.run(num_iter=3, verbose=False)
    last = history[-1]
    if cls is BPRLearner:
        assert np.isfinite(last["accuracy"]) and np.isfinite(last["pair_loss"])
        return
    key = "rmse" if "rmse" in last else "rmse_this"
    assert np.isfinite(last[key])
    if k0 and cls is not ExpSGDLearner:
        assert last[key] < 2.0


def _edge_bs_problem():
    """tests/test_edge_configs.py's relational case: the users one-hot in
    the main block, the items one-hot in a relation, 200 rows."""
    return _problem(n=200, n_users=11, n_items=6, seed=4, wide=1)


@pytest.mark.parametrize("k0,k1,K", EDGE_DIMS)
def test_edge_dims_relational_bs(k0, k1, K):
    main, rels, joins, _ = _edge_bs_problem()
    cfg, ds, robjs, meta, d_main = _build(TPKG, main, rels, joins, K, k0=k0,
                                          k1=k1)
    for cls in (tbs.MCMCBSLearner, tbs.ALSBSLearner):
        bs = cls(cfg, ds, ds, robjs, joins, joins, meta, d_main,
                 device="cpu", write_files=False)
        _, history = bs.run(num_iter=3, verbose=False)
        key = "rmse" if "rmse" in history[-1] else "rmse_this"
        assert np.isfinite(history[-1][key])


EPS32 = float(np.finfo(np.float32).eps)


def _scores64(params, design, y, k0, k1):
    """(y_hat, S) in float64 from float32 parameters (w0, w, v [K, D]) on
    the design (rows, cols, vals): the model as k0 and k1 set it, and S,
    the sum of the magnitudes of each row's terms and of its y."""
    w0, w, v = (np.asarray(a, np.float64) for a in params)
    rows, cols, vals = design
    n = len(y)
    lin = vals * w[cols] * k1
    yh = np.full(n, float(w0) * k0)
    S = np.abs(y) + abs(float(w0)) * k0
    np.add.at(yh, rows, lin)
    np.add.at(S, rows, np.abs(lin))
    if v.size:
        s = np.zeros((n, v.shape[0]))
        s2 = np.zeros_like(s)
        np.add.at(s, rows, vals[:, None] * v.T[cols])
        np.add.at(s2, rows, (vals ** 2)[:, None] * v.T[cols] ** 2)
        yh += 0.5 * (s ** 2 - s2).sum(1)
        S += 0.5 * (s ** 2 + s2).sum(1)
    return yh, S


def _assert_e_close(et, ej, pt, pj, design, y, k0, k1, sign):
    """The port's e (et, from parameters pt) and JAX's (ej, pj), e =
    sign (y_hat - y): each within 4 eps S of y and its own parameters in
    float64, and the two at rtol 1e-4, atol 1e-5 + 2 eps S (S from JAX's
    parameters)."""
    et, ej = (np.asarray(e, np.float64) for e in (et, ej))
    S = None
    for e, p, who in ((et, pt, "port"), (ej, pj, "jax")):
        yh, S = _scores64(p, design, y, k0, k1)
        ratio = np.abs(e - sign * (yh - y)) / (EPS32 * S)
        assert ratio.max() <= 4.0, (who, float(ratio.max()))
    excess = np.abs(et - ej) - (1e-5 + 2 * EPS32 * S + 1e-4 * np.abs(ej))
    assert excess.max() <= 0, float(np.abs(et - ej).max())


def _jax_pair(kind, k0, k1, K):
    """The JAX learner and the port's on the same data (``_data``'s shapes,
    drawn by svbfm_tpu's generator) and config; and the train rows."""
    coo = jax_movielens_like(num_users=12, num_items=9, num_ratings=600,
                             rank=2, noise=0.4, seed=2)
    tr, te = jax_split(coo, 0.2, seed=3)
    D = coo.num_features
    kw = dict(num_attributes=D, num_factor=K, k0=k0, k1=k1,
              min_target=float(tr.target.min()),
              max_target=float(tr.target.max()), seed=7, learn_rate=0.05,
              regw=0.05, regv=0.05, batch_size=64)
    jmeta = JMeta.from_field_offsets(D, [0, 12])
    tmeta = DataMetaInfo.from_field_offsets(D, [0, 12])
    jcls, tcls = {"vb": (jvb.VBLearner, VBLearner),
                  "als": (jm.ALSLearner, ALSLearner),
                  "mcmc": (jm.MCMCLearner, MCMCLearner),
                  "sgd": (jsgd.SGDLearner, SGDLearner)}[kind]
    jl = jcls(JConfig(num_groups=jmeta.num_attr_groups, **kw),
              JDataset.from_coo(tr, D), JDataset.from_coo(te, D), jmeta,
              mesh=make_mesh(1), write_files=False)
    tl = tcls(FMConfig(num_groups=tmeta.num_attr_groups, **kw),
              SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
              tmeta, device="cpu", write_files=False)
    return jl, tl, tr


def _assert_fields(ts, js, names, n, **tol):
    for k in names:
        ref = np.asarray(getattr(js, k))
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   ref[:n] if k == "t" else ref, err_msg=k,
                                   **tol)


VB_PARAMS = ("mu_0", "sigma_0_dash", "mu_w", "sigma_w_dash", "mu_v",
             "sigma_v_dash", "t")
VB_HYPER = ("alpha", "sigma_0", "sigma_w", "sigma_v")


@pytest.mark.parametrize("k0,k1,K", EDGE_DIMS)
@pytest.mark.parametrize("kind", ["vb", "als", "mcmc", "sgd"])
def test_edge_dims_learners_match_jax(kind, k0, k1, K):
    jl, tl, tr = _jax_pair(kind, k0, k1, K)
    js = jl.init_state()
    if kind == "sgd":
        ts = sgd_state_from_jax(jax.device_get(js), "cpu",
                                JaxSGDKeys(js.key))
        jend, jh = jl.run(js, num_iter=3, verbose=False)
        tend, th = tl.run(ts, num_iter=3, verbose=False)
        for a, b in zip(jh, th):
            for k in ("rmse", "mae"):
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
        _assert_fields(tend, jend, ("w0", "w", "v"), None, rtol=1e-4,
                       atol=1e-6)
        np.testing.assert_array_equal(np.asarray(tend.draws.key),
                                      np.asarray(jend.key))
        return
    n = tl.train_n
    design = (tr.row, tr.col, tr.val.astype(np.float64))
    y = tr.target.astype(np.float64)
    if kind == "vb":
        ts = state_from_jax(jax.device_get(js), "cpu")
    else:
        ts = mcmc_state_from_jax(jax.device_get(js), "cpu",
                                 JaxKeyDraws(js.key))
    for _ in range(3):
        if kind == "vb":
            js, jfe = jl._step(js, jl.train_row, jl.plan_data)
            ts, tfe, nans = tvb.vb_update_all(ts, tl.train_row, tl.plan_data,
                                              tl.cfg, float(n))
            np.testing.assert_allclose(float(tfe), float(jfe), rtol=1e-5)
            assert {k: int(v) for k, v in nans.items()} == dict(
                nan_w=0, nan_v=0, nan_alpha=0)
            params, hyper, mean, sign = VB_PARAMS, VB_HYPER, (
                "mu_0", "mu_w", "mu_v"), -1
        else:
            js, jnans = jl._step(js, jl.train_row, jl.plan_data)
            ts, tnans = tl.step(ts)
            assert {k: int(v) for k, v in tnans.items()} == {
                k: int(v) for k, v in jnans.items()}
            np.testing.assert_array_equal(np.asarray(ts.draws.key),
                                          np.asarray(js.key))
            params, hyper, mean, sign = ("w0", "w", "v"), HYPER, (
                "w0", "w", "v"), 1
        _assert_fields(ts, js, params, n, rtol=1e-4, atol=1e-5)
        _assert_fields(ts, js, hyper, n, rtol=1e-5, atol=1e-6)
        _assert_e_close(ts.e.numpy(), np.asarray(js.e)[:n],
                        [getattr(ts, k).numpy() for k in mean],
                        [np.asarray(getattr(js, k)) for k in mean], design,
                        y, k0, k1, sign)


@pytest.mark.parametrize("k0,k1,K", EDGE_DIMS)
def test_edge_dims_bs_als_sweeps_match_jax(k0, k1, K):
    main, rels, joins, _ = _edge_bs_problem()
    pair = []
    for pkg, jax_side in ((JPKG, True), (TPKG, False)):
        cfg, ds, robjs, meta, d_main = _build(pkg, main, rels, joins, K,
                                              k0=k0, k1=k1)
        if jax_side:
            pair.append(jbs.ALSBSLearner(cfg, ds, ds, robjs, joins, joins,
                                         meta, d_main, mesh=make_mesh(1),
                                         write_files=False))
        else:
            pair.append(tbs.ALSBSLearner(cfg, ds, ds, robjs, joins, joins,
                                         meta, d_main, device="cpu",
                                         write_files=False))
    jl, tl = pair
    joined, _ = _joined(tl, main, rels, joins)
    design = (joined.row, joined.col, joined.val.astype(np.float64))
    y = np.asarray(main["target"], np.float64)
    js, ts = _start(jl)
    n = tl.train_n
    for _ in range(3):
        js, jnans = jl._step(js, jl.train_row, jl.plan_data, jl.rels)
        ts, tnans = tl.step(ts)
        _assert_fields(ts, js, ("w0", "w", "v"), n, rtol=1e-4, atol=1e-5)
        _assert_fields(ts, js, HYPER, n, rtol=1e-5, atol=1e-6)
        _assert_e_close(ts.e.numpy(), np.asarray(js.e)[:n],
                        [getattr(ts, k).numpy() for k in ("w0", "w", "v")],
                        [np.asarray(getattr(js, k)) for k in ("w0", "w", "v")],
                        design, y, k0, k1, 1)
        assert {k: int(v) for k, v in tnans.items()} == {
            k: int(v) for k, v in jnans.items()}
        np.testing.assert_array_equal(np.asarray(ts.draws.key),
                                      np.asarray(js.key))
