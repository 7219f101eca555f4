"""The port's batch VB data-parallel (``VBLearner(mesh=)``) on spawned gloo
ranks, against the JAX package's ``VBLearner`` on ``make_mesh(4)`` of
conftest's 8-device CPU mesh, against the port's one-device learner and
against the float64 ``VBOracle``, every run from the JAX learner's init.

Each case runs once on four ranks (one spawn for the module, beside a
two-rank spawn that writes a checkpoint): fast mode, factor_block 1 and 4
(exact mode), K = 0, ``-task c`` and ``-num_eval_cases``, and a recipe
whose last rank holds only padding rows.  Tolerances:
  * against JAX on four devices: ``test_vb.py:95-96``'s, rtol 2e-3 /
    atol 2e-5 on the tables, rtol 1e-3 on the free energy; the test
    metrics rtol 2e-3;
  * against the float64 oracle: ``test_vb.py:58-64``'s;
  * against the port on one device, the same init: rtol 1e-4 / atol 1e-6
    on the tables after every sweep and rtol 1e-5 on the metrics (float32
    sums over four blocks of rows instead of one; measured: up to 9.5e-6
    relative on the table entries above 1e-3, 3e-7 on the metrics);
  * the four ranks' tables after every sweep: equal bit for bit.
"""

import shutil

import numpy as np
import pytest

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.learners.vb import VBLearner as JVBLearner
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.learners.base import padded_rows
from svbfm_tpu_torch.learners.vb import PARAM_FIELDS
from svbfm_tpu_torch.parallel.mesh import make_mesh as port_mesh
from torch_tp_ranks import dp_ranks, dp_run, dp_setup, run_ranks

from oracle import VBOracle

NUM_ITER = 3
# name: (dp_setup kwargs, -num_eval_cases)
CASES = {
    "fast": (dict(factor_block=0), None),
    "factor_block=1": (dict(factor_block=1), None),
    "factor_block=4": (dict(K=8, factor_block=4), None),
    "K=0": (dict(K=0), None),
    "task_c": (dict(task=1, factor_block=1), None),
    "num_eval_cases": (dict(factor_block=0), 10),
    # 6 train rows and 5 test rows, two rows a rank on four ranks: rank 3
    # holds padding alone
    "padding_rank": (dict(num_rows=11, num_users=4, num_items=3, K=2,
                          factor_block=1), None),
}
CKPT = dict(num_rows=128, seed=5, factor_block=1)
TABLES = ("mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash")


def _jax_learner(num_rows=96, num_users=9, num_items=7, K=3, seed=2, task=0,
                 nec=None, **cfg_kw):
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
    return JVBLearner(cfg, JDataset.from_coo(tr, D), JDataset.from_coo(te, D),
                      meta, mesh=make_mesh(4), write_files=False,
                      num_eval_cases=nec)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs (init saved as npz, history, final state), the port's
    on one device from the same init, and the port's on four ranks (one
    spawn), the last resuming the checkpoint two ranks wrote (a second
    spawn)."""
    d = tmp_path_factory.mktemp("dp_vb")
    jax_out, one = {}, {}
    for name, (setup, nec) in CASES.items():
        jl = _jax_learner(nec=nec, **setup)
        s0 = jl.init_state()
        init = {k: np.asarray(getattr(s0, k)) for k in PARAM_FIELDS}
        path = str(d / f"{name}.npz")
        np.savez(path, **init)
        s, h = jl.run(s0, num_iter=NUM_ITER, verbose=False)
        jax_out[name] = dict(path=path, init=init, hist=h, final={
            k: np.asarray(getattr(s, k)) for k in TABLES + ("alpha",)},
            preds=jl.predict_test_scores(s))
        one[name] = dp_run(None, setup, NUM_ITER, path, num_eval_cases=nec)
    ck = d / "ck"
    two = run_ranks(dp_ranks, 2, d / "two", timeout=120, runs=[
        ("first", CKPT, 3, "", "", None, str(ck), 3)])
    # each resume from a copy of its own (a resumed run saves its last
    # sweep there too)
    for n in ("1", "4"):
        shutil.copytree(ck, d / f"ck{n}")
    four = run_ranks(dp_ranks, 4, d / "four", timeout=150, runs=[
        (name, setup, NUM_ITER, jax_out[name]["path"], "", nec, "", 100)
        for name, (setup, nec) in CASES.items()] + [
        ("full", CKPT, 5, "", "", None, "", 100),
        ("resumed", CKPT, 5, "", "", None, str(d / "ck4"), 100)])
    resumed_one = dp_run(port_mesh(device="cpu"), CKPT, 5,
                         ckpt=str(d / "ck1"))
    return dict(jax=jax_out, one=one, two=two, four=four,
                resumed_one=resumed_one)


def _metric(rec):
    return "rmse" if "rmse" in rec else "accuracy"


@pytest.mark.parametrize("case", list(CASES))
def test_dp_vb_matches_jax_on_four_devices(runs, case):
    ref, got = runs["jax"][case], runs["four"][0][case]
    assert len(got["hist"]) == len(ref["hist"]) == NUM_ITER
    for a, b in zip(got["hist"], ref["hist"]):
        np.testing.assert_allclose(a["free_energy"], b["free_energy"],
                                   rtol=1e-3)
        m = _metric(b)
        np.testing.assert_allclose(a[m], b[m], rtol=2e-3, err_msg=m)
        if "rmse_test2_this" in b:
            np.testing.assert_allclose(a["rmse_test2_this"],
                                       b["rmse_test2_this"], rtol=2e-3)
    for k in TABLES + ("alpha",):
        np.testing.assert_allclose(got["final"][k], ref["final"][k],
                                   rtol=2e-3, atol=2e-5, err_msg=k)
    np.testing.assert_allclose(got["preds"], ref["preds"], rtol=2e-3,
                               atol=2e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_vb_matches_one_device(runs, case):
    one, got = runs["one"][case], runs["four"][0][case]
    for a, b in zip(got["sweeps"], one["sweeps"]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    keys = [k for k in one["hist"][0] if not k.startswith("time")
            and np.ndim(one["hist"][0][k]) == 0]
    assert "free_energy" in keys
    for a, b in zip(got["hist"], one["hist"]):
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    np.testing.assert_allclose(got["final"]["e"], one["final"]["e"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["preds"], one["preds"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", list(CASES) + ["full", "resumed"])
def test_dp_vb_ranks_hold_the_same_bits(runs, case):
    """Every rank's replicated tables equal rank 0's bit for bit after
    every sweep, and every rank saw the same metrics."""
    four = runs["four"]
    assert len(four) == 4
    for r in four[1:]:
        assert len(r[case]["sweeps"]) == len(four[0][case]["sweeps"]) > 0
        for a, b in zip(r[case]["sweeps"], four[0][case]["sweeps"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for a, b in zip(r[case]["hist"], four[0][case]["hist"]):
            assert {k: v for k, v in a.items() if not k.startswith("time")
                    and np.ndim(v) == 0} == {
                k: v for k, v in b.items() if not k.startswith("time")
                and np.ndim(v) == 0}


def test_dp_vb_factor_block_1_matches_the_oracle(runs):
    """factor_block=1 on four ranks against the float64 serial oracle from
    the same init, every sweep (test_vb.py:42-64's tolerances)."""
    cfg, tr, _, meta, D = dp_setup(factor_block=1)
    init = runs["jax"]["factor_block=1"]["init"]
    coo = tr.to_coo()
    orc = VBOracle(coo.row, coo.col, coo.val, coo.target, D, cfg.num_factor,
                   groups=meta.attr_group)
    orc.init(float(init["mu_0"]), float(init["sigma_0_dash"]), init["mu_w"],
             init["sigma_w_dash"], init["mu_v"], init["sigma_v_dash"])
    got = runs["four"][0]["factor_block=1"]
    for sw, rec in zip(got["sweeps"], got["hist"]):
        fe_o = orc.iterate()
        np.testing.assert_allclose(sw["mu_w"], orc.mu_w, rtol=3e-3,
                                   atol=3e-4)
        np.testing.assert_allclose(sw["mu_v"], orc.mu_v, rtol=3e-3,
                                   atol=3e-4)
        np.testing.assert_allclose(sw["sigma_w_dash"], orc.sigma_w_dash,
                                   rtol=3e-3, atol=1e-6)
        np.testing.assert_allclose(float(sw["alpha"]), orc.alpha, rtol=3e-3)
        np.testing.assert_allclose(float(sw["mu_0"]), orc.mu_0, rtol=3e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(rec["free_energy"], fe_o, rtol=2e-3)


def test_dp_vb_last_rank_holds_padding_alone():
    """The padding recipe's blocks: on four ranks the last rank's train
    and test rows are all padding (valid = 0), so its stats launches sum
    nothing; the runs above hold it to JAX and to one device."""
    _, tr, te, _, _ = dp_setup(**CASES["padding_rank"][0])
    for ds in (tr, te):
        assert padded_rows(ds, 4) == 8 and ds.num_rows <= 6, ds.num_rows


@pytest.mark.parametrize("where", ["one_rank", "four_ranks"])
def test_dp_vb_checkpoint_resumes_on_another_number_of_ranks(runs, where):
    """Three sweeps on two ranks save a checkpoint (the global layout
    without padding); a world of one and four ranks resume it to five
    sweeps, the last two as the uninterrupted four-rank run's."""
    first = runs["two"][0]["first"]
    full = runs["four"][0]["full"]
    res = runs["resumed_one"] if where == "one_rank" \
        else runs["four"][0]["resumed"]
    assert [h["iter"] for h in first["hist"]] == [0, 1, 2]
    assert [h["iter"] for h in res["hist"]] == [3, 4]
    for a, b in zip(res["hist"], full["hist"][3:]):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=1e-5)
        np.testing.assert_allclose(a["free_energy"], b["free_energy"],
                                   rtol=1e-5)
    for k in TABLES:
        np.testing.assert_allclose(res["final"][k], full["final"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
