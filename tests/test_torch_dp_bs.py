"""The port's block-structure Gibbs and ALS data-parallel
(``MCMCBSLearner(mesh=)``, ``ALSBSLearner(mesh=)``) on spawned gloo ranks,
against the JAX package's BS learners on ``make_mesh(4)`` of conftest's
8-device CPU mesh, against the port's one-device learners, and against
the port's ALS on the materialised join on the same four ranks
(``tests/test_bs.py:59-85`` on the mesh); every run from the JAX learner's
init, Gibbs replaying the JAX key chain (``test_torch_mcmc.py:
JaxKeyDraws``: every rank the same chain, the probit uniforms folded with
the rank's data shard as JAX folds its device's).

Each case runs once on four ranks (one spawn for the module, beside a
two-rank spawn that writes a checkpoint): ALS and Gibbs at factor_block 1
and the blocked width (two relations and an empty main block among
them), both under ``-task c``, and a recipe whose last rank holds only
padding rows; X10a's twin on two join slices summed against the whole
plan.  Tolerances:
  * against JAX on four devices: ``test_torch_bs.py``'s sweeps' bounds,
    rtol 1e-4 / atol 5e-5 on w0, w, v and the predictions, rtol 1e-5 /
    atol 1e-6 on alpha and the hyperparameters, the metrics rtol 1e-5
    (under ``-task c`` its classification test's: accuracy within one
    test row, loglik rtol 2e-3);
  * against the materialised join: ``test_bs.py:80-85``'s, RMSE within
    1e-5, w rtol 2e-4 / atol 2e-5, v rtol 2e-3 / atol 2e-4;
  * against the port on one device, the same init and draws: rtol 1e-4 /
    atol 1e-6 on the tables after every sweep, rtol 1e-5 on the metrics
    (Gibbs under ``-task c`` draws its probit uniforms a shard at a time,
    so its chain depends on the number of ranks: it is held to JAX
    alone);
  * the four ranks' tables after every sweep: equal bit for bit.
"""

import shutil

import numpy as np
import pytest
import torch

from svbfm_tpu.learners import mcmc_bs as jbs
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SweepPlan
from svbfm_tpu_torch.data.libfm_text import COOData
from svbfm_tpu_torch.kernels.bs_sweep import (agg_channels,
                                              bs_join_agg_plain, rel_layout)
from svbfm_tpu_torch.learners.mcmc_bs import JoinBlock
from svbfm_tpu_torch.parallel.mesh import make_mesh as port_mesh
from test_torch_bs import JPKG, _build, _problem
from torch_tp_ranks import dp_ranks, dp_run, run_ranks

NUM_ITER = 3
# name: (bs_setup kwargs, "bs_als" or "bs_gibbs")
CASES = {
    "als_factor_block=1": (dict(problem=dict(n=240), factor_block=1),
                           "bs_als"),
    "als_blocked": (dict(problem=dict(n=240), factor_block=0), "bs_als"),
    "gibbs_factor_block=1": (dict(problem=dict(n=400), factor_block=1),
                             "bs_gibbs"),
    "gibbs_blocked_two_relations": (dict(problem=dict(n=400, users_rel=True),
                                         factor_block=0), "bs_gibbs"),
    "als_task_c": (dict(problem=dict(n=400), factor_block=1, task=1),
                   "bs_als"),
    "gibbs_task_c": (dict(problem=dict(n=400), factor_block=0, task=1),
                     "bs_gibbs"),
    # 6 rows (train = test), two a rank on four ranks: rank 3 holds padding
    # alone, in the main plan and in every join bucket
    "padding_rank": (dict(problem=dict(n=6, n_users=4, n_items=3),
                          factor_block=1), "bs_gibbs"),
}
# the chain depends on the number of ranks (the probit uniforms)
ONE_DEVICE = [c for c in CASES if c != "gibbs_task_c"]
CKPT = dict(problem=dict(n=128, seed=5), factor_block=0)
TABLES = ("w0", "w", "v", "alpha", "w_mu", "w_lambda", "v_mu", "v_lambda")
PARAMS = ("w0", "w", "v")


def _jax_learner(setup, kind):
    """``bs_setup``'s problem through the JAX package on ``make_mesh(4)``."""
    main, rels, joins, y = _problem(**setup["problem"])
    task = setup.get("task", 0)
    if task == 1:
        main["target"] = np.where(y > np.median(y), 1.0, -1.0).astype(
            np.float32)
    cfg, ds, robjs, meta, d_main = _build(
        JPKG, main, rels, joins, setup.get("K", 3),
        factor_block=setup.get("factor_block", 0), task=task)
    cls = jbs.ALSBSLearner if kind == "bs_als" else jbs.MCMCBSLearner
    return cls(cfg, ds, ds, robjs, joins, joins, meta, d_main,
               mesh=make_mesh(4), write_files=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs (init and key saved as npz, history, final state), the
    port's on one device from the same init and draws, and the port's on
    four ranks (one spawn: every case, ALS on the materialised join, and
    the last run resuming the checkpoint two ranks wrote, a second
    spawn)."""
    d = tmp_path_factory.mktemp("dp_bs")
    jax_out, one = {}, {}
    for name, (setup, kind) in CASES.items():
        jl = _jax_learner(setup, kind)
        s0 = jl.init_state()
        init = {k: np.asarray(getattr(s0, k)) for k in ("w0", "w", "v",
                                                        "key")}
        path = str(d / f"{name}.npz")
        np.savez(path, **init)
        s, h = jl.run(s0, num_iter=NUM_ITER, verbose=False)
        jax_out[name] = dict(path=path, hist=h, final={
            k: np.asarray(getattr(s, k)) for k in TABLES},
            preds=jl.final_test_predictions(s))
        if name in ONE_DEVICE:
            one[name] = dp_run(None, setup, NUM_ITER, path, kind)
    ck = d / "ck"
    two = run_ranks(dp_ranks, 2, d / "two", timeout=150, runs=[
        ("first", CKPT, 3, "", "bs_gibbs", None, str(ck), 3)])
    for n in ("1", "4"):
        shutil.copytree(ck, d / f"ck{n}")
    join_setup = CASES["als_factor_block=1"][0]
    four = run_ranks(dp_ranks, 4, d / "four", timeout=150, runs=[
        (name, setup, NUM_ITER, jax_out[name]["path"], kind, None, "", 100)
        for name, (setup, kind) in CASES.items()] + [
        ("join", join_setup, NUM_ITER, jax_out["als_factor_block=1"]["path"],
         "join_als", None, "", 100),
        ("full", CKPT, 5, "", "bs_gibbs", None, "", 100),
        ("resumed", CKPT, 5, "", "bs_gibbs", None, str(d / "ck4"), 100)])
    resumed_one = dp_run(port_mesh(device="cpu"), CKPT, 5, mcmc="bs_gibbs",
                         ckpt=str(d / "ck1"))
    return dict(jax=jax_out, one=one, two=two, four=four,
                resumed_one=resumed_one)


def _scalars(rec):
    return {k: v for k, v in rec.items() if not k.startswith("time")
            and np.ndim(v) == 0}


@pytest.mark.parametrize("case", list(CASES))
def test_dp_bs_matches_jax_on_four_devices(runs, case):
    ref, got = runs["jax"][case], runs["four"][0][case]
    assert len(got["hist"]) == len(ref["hist"]) == NUM_ITER
    for a, b in zip(got["hist"], ref["hist"]):
        if "accuracy" in b:
            # one test row's flip at most (test_torch_bs.py's bound)
            assert abs(a["accuracy"] - b["accuracy"]) * len(got["preds"]) \
                < 1.5
            np.testing.assert_allclose(a["loglik"], b["loglik"], rtol=2e-3)
            continue
        for k in ("rmse", "rmse_this", "alpha"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    for k in TABLES:
        tol = dict(rtol=1e-4, atol=5e-5) if k in PARAMS else dict(
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["final"][k], ref["final"][k],
                                   err_msg=k, **tol)
    np.testing.assert_allclose(got["preds"], ref["preds"], rtol=1e-4,
                               atol=5e-5)


@pytest.mark.parametrize("case", ONE_DEVICE)
def test_dp_bs_matches_one_device(runs, case):
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


@pytest.mark.parametrize("case", list(CASES) + ["join", "full", "resumed"])
def test_dp_bs_ranks_hold_the_same_bits(runs, case):
    """Every rank's replicated tables equal rank 0's bit for bit after
    every sweep (no rank summed qB or wnum, drew other noise or skipped a
    draw), and every rank saw the same metrics."""
    four = runs["four"]
    assert len(four) == 4
    for r in four[1:]:
        assert len(r[case]["sweeps"]) == len(four[0][case]["sweeps"]) > 0
        for a, b in zip(r[case]["sweeps"], four[0][case]["sweeps"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for a, b in zip(r[case]["hist"], four[0][case]["hist"]):
            assert _scalars(a) == _scalars(b)


def test_dp_bs_als_matches_the_materialised_join(runs):
    """ALS over block structure on four ranks against ALS on the
    materialised join on the same four ranks, from one init, at
    factor_block 1 (test_bs.py:59-85 on the mesh)."""
    bs, mat = runs["four"][0]["als_factor_block=1"], runs["four"][0]["join"]
    for hb, hm in zip(bs["hist"], mat["hist"]):
        assert abs(hb["rmse"] - hm["rmse"]) < 1e-5
    np.testing.assert_allclose(bs["final"]["w"], mat["final"]["w"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(bs["final"]["v"], mat["final"]["v"],
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("where", ["one_rank", "four_ranks"])
def test_dp_bs_checkpoint_resumes_on_another_number_of_ranks(runs, where):
    """Three BS Gibbs iterations on two ranks save a checkpoint (the state,
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


@pytest.mark.parametrize("F", [0, 1, 20, 33])
def test_join_agg_twin_on_two_slices_sums_to_the_whole_plan(F):
    """X10a's twin on each rank's slice of a join plan built for two
    shards (shard-local rows, x = 0 pad slots at the shard's last row; a
    relation row joined to no row of a shard gets zero sums there),
    summed over the channel columns, against the twin on the whole plan;
    the qB and wn columns are the same on both and not summed."""
    gen = torch.Generator().manual_seed(F)
    rng = np.random.default_rng(F)
    R, N = 40, 301
    join = rng.integers(0, R - 3, N).astype(np.int32)  # 3 rows unjoined
    n_pad = N + 1
    half = n_pad // 2
    join[:half] = np.minimum(join[:half], 5)  # rows 6.. on shard 1 alone
    coo = COOData(row=np.arange(N, dtype=np.int32), col=join,
                  val=np.ones(N, np.float32),
                  target=np.zeros(N, np.float32), num_rows=N,
                  num_features=R)
    e = torch.randn(n_pad, generator=gen)
    q = torch.randn(n_pad, F, generator=gen) if F else None
    lay = rel_layout(F)
    base = torch.zeros(R, lay["ld"])
    base[:, :F] = torch.randn(R, F, generator=gen)
    base[:, lay["wn"]] = torch.from_numpy(np.bincount(join, minlength=R)
                                          .astype(np.float32))

    def blocks(plan, s):
        return [JoinBlock(rows=torch.from_numpy(b.rows[s].copy()),
                          x=torch.from_numpy(b.x[s].copy()),
                          cols=torch.from_numpy(b.cols.copy()))
                for b in plan.blocks[0]]

    whole = base.clone()
    bs_join_agg_plain(blocks(SweepPlan.build(coo, R, bins="jacobi"), 0), e,
                      q, F, whole)
    split = SweepPlan.build(coo, R, bins="jacobi", n_shards=2,
                            n_rows_total=n_pad)
    parts = []
    for s in range(2):
        t = base.clone()
        rows = slice(s * half, (s + 1) * half)
        bs_join_agg_plain(blocks(split, s), e[rows],
                          None if q is None else q[rows], F, t)
        parts.append(t)
    ch = slice(lay["we"], lay["wn"])
    assert ch.stop - ch.start == agg_channels(F)
    got = parts[0].clone()
    got[:, ch] = parts[0][:, ch] + parts[1][:, ch]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)
    # shard 0 holds no row joined past relation row 5
    assert torch.all(parts[0][6:, ch] == 0)
