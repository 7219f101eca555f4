"""The port's Gibbs MCMC and ALS data-parallel (``MCMCLearner(mesh=)``,
``ALSLearner(mesh=)``) on spawned gloo ranks, against the JAX package's
learners on ``make_mesh(4)`` of conftest's 8-device CPU mesh, against the
port's one-device learners and against the float64 ``ALSOracle``, every
run from the JAX learner's init; Gibbs replays the JAX key chain
(``test_torch_mcmc.py:JaxKeyDraws``: every rank the same chain, the probit
uniforms folded with the rank's data shard as JAX folds its device's).

Each case runs once on four ranks (one spawn for the module, beside a
two-rank spawn that writes a checkpoint): ALS and Gibbs at factor_block 1
and the default (Gibbs's under ``-num_eval_cases``), both under ``-task
c``, and a recipe whose last rank holds only padding rows.
Tolerances:
  * against JAX on four devices: ALS ``test_vb.py:95-96``'s rtol 2e-3 /
    atol 2e-5 on the tables; Gibbs ``test_mcmc.py:353-354``'s rtol 2e-3 /
    atol 2e-4 on the RMSE, and the same on the tables; the metrics rtol
    2e-3;
  * against the float64 oracle: ``test_mcmc.py:31-53``'s;
  * against the port on one device, the same init and draws: rtol 1e-4 /
    atol 1e-6 on the tables after every sweep, rtol 1e-5 on the metrics
    (measured: 1.4e-6 absolute, 1.4e-4 relative, on an ALS v entry near
    1e-2; 5.5e-7 relative on the metrics.  Gibbs under ``-task c`` draws
    its probit uniforms a shard at a time,
    so its chain depends on the number of ranks: it is held to JAX
    alone);
  * the four ranks' tables after every sweep: equal bit for bit.
"""

import shutil

import numpy as np
import pytest

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import mcmc as jm
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.parallel.mesh import make_mesh as port_mesh
from torch_tp_ranks import dp_ranks, dp_run, dp_setup, run_ranks

from oracle import ALSOracle

NUM_ITER = 3
REG = dict(regw=0.1, regv=0.1)
# name: (dp_setup kwargs, "gibbs" or "als", -num_eval_cases)
CASES = {
    "als_factor_block=1": (dict(factor_block=1, regw=0.05, regv=0.05), "als",
                           None),
    "als_default": (dict(factor_block=0, regw=0.05, regv=0.05), "als", None),
    "gibbs_factor_block=1": (dict(K=4, factor_block=1, **REG), "gibbs",
                             None),
    "gibbs_default_num_eval_cases": (dict(K=4, factor_block=0, **REG),
                                     "gibbs", 10),
    "als_task_c": (dict(task=1, factor_block=1, **REG), "als", None),
    "gibbs_task_c": (dict(task=1, K=4, **REG), "gibbs", None),
    # 6 train rows and 5 test rows, two rows a rank on four ranks: rank 3
    # holds padding alone
    "padding_rank": (dict(num_rows=11, num_users=4, num_items=3, K=2,
                          factor_block=1, **REG), "gibbs", None),
}
# the chain depends on the number of ranks (the probit uniforms)
ONE_DEVICE = [c for c in CASES if c != "gibbs_task_c"]
CKPT = dict(num_rows=128, seed=5, K=4, **REG)
TABLES = ("w0", "w", "v", "alpha", "w_mu", "w_lambda", "v_mu", "v_lambda")


def _jax_learner(kind, num_rows=96, num_users=9, num_items=7, K=3, seed=2,
                 task=0, nec=None, **cfg_kw):
    """``dp_setup``'s recipe through the JAX package on ``make_mesh(4)``."""
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    D = coo.num_features
    if task == 1:
        thr = np.median(tr.target)
        for c in (tr, te):
            c.target = np.where(c.target > thr, 1.0, -1.0).astype(
                np.float32)
    meta = JMeta.from_field_offsets(D, [0, num_users])
    cfg = JConfig(num_attributes=D, num_factor=K, task=task,
                  min_target=float(tr.target.min()),
                  max_target=float(tr.target.max()),
                  num_groups=meta.num_attr_groups, seed=7, **cfg_kw)
    cls = jm.ALSLearner if kind == "als" else jm.MCMCLearner
    return cls(cfg, JDataset.from_coo(tr, D), JDataset.from_coo(te, D), meta,
               mesh=make_mesh(4), write_files=False, num_eval_cases=nec)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs (init and key saved as npz, history, final state), the
    port's on one device from the same init and draws, and the port's on
    four ranks (one spawn), the last resuming the checkpoint two ranks
    wrote (a second spawn)."""
    d = tmp_path_factory.mktemp("dp_mcmc")
    jax_out, one = {}, {}
    for name, (setup, kind, nec) in CASES.items():
        jl = _jax_learner(kind, nec=nec, **setup)
        s0 = jl.init_state()
        init = {k: np.asarray(getattr(s0, k)) for k in ("w0", "w", "v",
                                                        "key")}
        path = str(d / f"{name}.npz")
        np.savez(path, **init)
        s, h = jl.run(s0, num_iter=NUM_ITER, verbose=False)
        jax_out[name] = dict(path=path, init=init, hist=h, final={
            k: np.asarray(getattr(s, k)) for k in TABLES},
            preds=jl.final_test_predictions(s))
        if name in ONE_DEVICE:
            one[name] = dp_run(None, setup, NUM_ITER, path, kind,
                               num_eval_cases=nec)
    ck = d / "ck"
    two = run_ranks(dp_ranks, 2, d / "two", timeout=120, runs=[
        ("first", CKPT, 3, "", "gibbs", None, str(ck), 3)])
    # each resume from a copy of its own (a resumed run saves its last
    # iteration there too)
    for n in ("1", "4"):
        shutil.copytree(ck, d / f"ck{n}")
    four = run_ranks(dp_ranks, 4, d / "four", timeout=150, runs=[
        (name, setup, NUM_ITER, jax_out[name]["path"], kind, nec, "", 100)
        for name, (setup, kind, nec) in CASES.items()] + [
        ("full", CKPT, 5, "", "gibbs", None, "", 100),
        ("resumed", CKPT, 5, "", "gibbs", None, str(d / "ck4"), 100)])
    resumed_one = dp_run(port_mesh(device="cpu"), CKPT, 5, mcmc="gibbs",
                         ckpt=str(d / "ck1"))
    return dict(jax=jax_out, one=one, two=two, four=four,
                resumed_one=resumed_one)


def _scalars(rec):
    return {k: v for k, v in rec.items() if not k.startswith("time")
            and np.ndim(v) == 0}


@pytest.mark.parametrize("case", list(CASES))
def test_dp_mcmc_matches_jax_on_four_devices(runs, case):
    ref, got = runs["jax"][case], runs["four"][0][case]
    gibbs = CASES[case][1] == "gibbs"
    tol = dict(rtol=2e-3, atol=2e-4 if gibbs else 2e-5)
    assert len(got["hist"]) == len(ref["hist"]) == NUM_ITER
    for a, b in zip(got["hist"], ref["hist"]):
        keys = [k for k in ("rmse", "rmse_this", "accuracy", "loglik",
                            "rmse_test2_this", "rmse_test2_all") if k in b]
        assert keys
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-3, atol=2e-4,
                                       err_msg=k)
    for k in TABLES:
        np.testing.assert_allclose(got["final"][k], ref["final"][k],
                                   err_msg=k, **tol)
    np.testing.assert_allclose(got["preds"], ref["preds"], **tol)


@pytest.mark.parametrize("case", ONE_DEVICE)
def test_dp_mcmc_matches_one_device(runs, case):
    one, got = runs["one"][case], runs["four"][0][case]
    assert len(got["sweeps"]) == len(one["sweeps"]) == NUM_ITER
    for a, b in zip(got["sweeps"], one["sweeps"]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for a, b in zip(got["hist"], one["hist"]):
        sa, sb = _scalars(a), _scalars(b)
        assert sa.keys() == sb.keys()
        for k in sb:
            np.testing.assert_allclose(sa[k], sb[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    np.testing.assert_allclose(got["final"]["e"], one["final"]["e"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["preds"], one["preds"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", list(CASES) + ["full", "resumed"])
def test_dp_mcmc_ranks_hold_the_same_bits(runs, case):
    """Every rank's replicated tables equal rank 0's bit for bit after
    every sweep (no rank skipped a draw), and every rank saw the same
    metrics."""
    four = runs["four"]
    assert len(four) == 4
    for r in four[1:]:
        assert len(r[case]["sweeps"]) == len(four[0][case]["sweeps"]) > 0
        for a, b in zip(r[case]["sweeps"], four[0][case]["sweeps"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for a, b in zip(r[case]["hist"], four[0][case]["hist"]):
            assert _scalars(a) == _scalars(b)


def test_dp_als_factor_block_1_matches_the_oracle(runs):
    """ALS at factor_block=1 on four ranks against the float64 serial
    oracle from the same init, every sweep (test_mcmc.py:31-53's
    tolerances)."""
    setup = CASES["als_factor_block=1"][0]
    cfg, tr, _, meta, D = dp_setup(**setup)
    init = runs["jax"]["als_factor_block=1"]["init"]
    coo = tr.to_coo()
    orc = ALSOracle(coo.row, coo.col, coo.val, coo.target, D, cfg.num_factor,
                    groups=meta.attr_group, regw=0.05, regv=0.05)
    orc.init(float(init["w0"]), init["w"], init["v"])
    got = runs["four"][0]["als_factor_block=1"]
    for sw in got["sweeps"]:
        orc.iterate()
        np.testing.assert_allclose(float(sw["w0"]), orc.w0, rtol=2e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(sw["w"], orc.w, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(sw["v"], orc.v, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(got["final"]["e"], orc.e, rtol=5e-3,
                               atol=5e-3)


@pytest.mark.parametrize("where", ["one_rank", "four_ranks"])
def test_dp_mcmc_checkpoint_resumes_on_another_number_of_ranks(runs, where):
    """Three Gibbs iterations on two ranks save a checkpoint (the state,
    its draw source and the posterior-mean accumulators, rows without
    padding); a world of one and four ranks resume it to five, the last
    two as the uninterrupted four-rank run's."""
    first = runs["two"][0]["first"]
    full = runs["four"][0]["full"]
    res = runs["resumed_one"] if where == "one_rank" \
        else runs["four"][0]["resumed"]
    assert [h["iter"] for h in first["hist"]] == [0, 1, 2]
    assert [h["iter"] for h in res["hist"]] == [3, 4]
    for a, b in zip(res["hist"], full["hist"][3:]):
        for k in ("rmse", "rmse_this", "rmse_all_but5", "alpha"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    for k in TABLES:
        np.testing.assert_allclose(res["final"][k], full["final"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(res["preds"], full["preds"], rtol=1e-5)
