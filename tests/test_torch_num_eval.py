"""``-num_eval_cases`` in the port: the per-iteration eval over the first
test rows, the held-back rows' ``rmse_test2_this`` (and for Gibbs/ALS
``rmse_test2_all``), against the JAX package's VBLearner, MCMCLearner and
ALSLearner at the same ``num_eval_cases``, both started from the JAX
learner's init (Gibbs with the JAX key chain replayed, ``JaxKeyDraws`` of
``tests/test_torch_mcmc.py``); and the CLI's final ``Test=`` over the
first rows, the rule of the JAX CLI.

Tolerances: rmse, mae, train rmse, free energy and every ``rmse_test2_*``
rtol 1e-5 (``tests/test_torch_vb.py``'s and ``test_torch_mcmc.py``'s for
trajectories); accuracy equal (it counts rows), loglik rtol 1e-5; the CLI
line to the 6 digits it prints.
"""

import jax
import numpy as np
import pytest

from svbfm_tpu.cli import main as jax_main
from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import mcmc as jm
from svbfm_tpu.learners import vb as jvb
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch import cli
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.libfm_text import save_libfm_text
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.learners import mcmc as tm
from svbfm_tpu_torch.learners import vb as tvb
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.utils.convert import mcmc_state_from_jax, state_from_jax

from test_torch_mcmc import JaxKeyDraws

NEC = 40


def _data(task=0):
    coo = make_movielens_like(num_users=14, num_items=11, num_ratings=400,
                              rank=2, noise=0.4, seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    if task == 1:
        for c in (tr, te):
            c.target = np.where(c.target > 3, 1.0, -1.0).astype(np.float32)
    return coo.num_features, tr, te


def _pair(kind, task=0, **cfg_kw):
    D, tr, te = _data(task)
    kw = dict(num_attributes=D, num_factor=3, task=task, num_groups=2,
              min_target=float(tr.target.min()),
              max_target=float(tr.target.max()), seed=7, **cfg_kw)
    jmeta = JMeta.from_field_offsets(D, [0, 14])
    tmeta = DataMetaInfo.from_field_offsets(D, [0, 14])
    jcls, tcls = {"vb": (jvb.VBLearner, tvb.VBLearner),
                  "mcmc": (jm.MCMCLearner, tm.MCMCLearner),
                  "als": (jm.ALSLearner, tm.ALSLearner)}[kind]
    jl = jcls(JConfig(**kw), JDataset.from_coo(tr, D),
              JDataset.from_coo(te, D), jmeta, mesh=make_mesh(1),
              write_files=False, num_eval_cases=NEC)
    tl = tcls(FMConfig(**kw), SparseDataset.from_coo(tr, D),
              SparseDataset.from_coo(te, D), tmeta, device="cpu",
              write_files=False, num_eval_cases=NEC)
    assert tl.test_n > NEC and tl._eval_n == NEC
    return jl, tl


def _start(kind, jl):
    js = jl.init_state()
    if kind == "vb":
        return js, state_from_jax(jax.device_get(js), "cpu")
    return js, mcmc_state_from_jax(jax.device_get(js), "cpu",
                                   JaxKeyDraws(js.key))


@pytest.mark.parametrize("kind,cfg_kw,keys", [
    ("vb", {}, ("rmse", "mae", "train_rmse", "free_energy",
                "rmse_test2_this")),
    ("vb", dict(factor_block=1), ("rmse", "mae", "free_energy",
                                  "rmse_test2_this")),
    ("mcmc", {}, ("rmse", "rmse_this", "mae", "rmse_test2_this",
                  "rmse_test2_all")),
    ("als", dict(factor_block=1, regw=0.05, regv=0.05),
     ("rmse_this", "mae", "rmse_test2_this", "rmse_test2_all")),
])
def test_held_back_histories_match_jax(kind, cfg_kw, keys):
    jl, tl = _pair(kind, **cfg_kw)
    js, ts = _start(kind, jl)
    _, jh = jl.run(js, num_iter=4, verbose=False)
    _, th = tl.run(ts, num_iter=4, verbose=False, chunk=3)
    assert len(th) == 4
    for a, b in zip(jh, th):
        for k in keys:
            np.testing.assert_allclose(b[k], float(a[k]), rtol=1e-5,
                                       err_msg=k)
    assert th[-1]["rmse_test2_this"] != th[-1][keys[0]]


@pytest.mark.parametrize("kind", ["vb", "mcmc"])
def test_held_back_classification_matches_jax(kind):
    """Under -task c the eval is over the first rows (X12b's valid mask),
    and no rmse_test2 is reported, as in JAX."""
    jl, tl = _pair(kind, task=1)
    js, ts = _start(kind, jl)
    _, jh = jl.run(js, num_iter=3, verbose=False)
    _, th = tl.run(ts, num_iter=3, verbose=False)
    for a, b in zip(jh, th):
        assert b["accuracy"] == pytest.approx(float(a["accuracy"]), abs=1e-7)
        np.testing.assert_allclose(b["loglik"], float(a["loglik"]),
                                   rtol=1e-5)
        assert "rmse_test2_this" not in b
        # the accuracy is a count of the first rows over NEC
        assert round(b["accuracy"] * NEC, 3) == int(round(b["accuracy"]
                                                          * NEC))


def test_split_identity_on_the_held_back_rows():
    """nec rmse^2 + (N - nec) rmse_test2_this^2 = N rmse_full^2 for one
    sweep of the same state: the two masks split the rows."""
    D, tr, te = _data()
    kw = dict(num_attributes=D, num_factor=3, num_groups=2, seed=7,
              min_target=float(tr.target.min()),
              max_target=float(tr.target.max()))
    meta = DataMetaInfo.from_field_offsets(D, [0, 14])
    args = (FMConfig(**kw), SparseDataset.from_coo(tr, D),
            SparseDataset.from_coo(te, D), meta)
    split = tvb.VBLearner(*args, device="cpu", write_files=False,
                          num_eval_cases=NEC)
    full = tvb.VBLearner(*args, device="cpu", write_files=False)
    init = full.init_state()
    (hs,), (hf,) = (lr.run(init, num_iter=1, verbose=False)[1]
                    for lr in (split, full))
    N = te.num_rows
    np.testing.assert_allclose(
        NEC * hs["rmse"] ** 2 + (N - NEC) * hs["rmse_test2_this"] ** 2,
        N * hf["rmse"] ** 2, rtol=1e-5)
    # num_eval_cases at or past the test rows evaluates every row
    every = tvb.VBLearner(*args, device="cpu", write_files=False,
                          num_eval_cases=N)
    assert every._rest_valid is None and every._eval_n == N


@pytest.mark.parametrize("method", ["vb", "mcmc", "als", "sgd"])
def test_cli_final_test_over_first_rows(tmp_path, monkeypatch, capsys,
                                        method):
    """Both CLIs print Final Test= over the first -num_eval_cases rows of
    their -out predictions (svbfm_tpu/cli.py:565-583), and the port prints
    the same num_eval_cases= line."""
    D, tr, te = _data()
    save_libfm_text(str(tmp_path / "tr.libfm"), tr)
    save_libfm_text(str(tmp_path / "te.libfm"), te)
    monkeypatch.chdir(tmp_path)
    extra = (["-regular", "1"] if method == "als"
             else ["-learn_rate", "0.05"] if method == "sgd" else [])
    argv = ["-task", "r", "-train", "tr.libfm", "-test", "te.libfm",
            "-dim", "1,1,3", "-method", method, "-iter", "2",
            "-num_eval_cases", str(NEC), "-out", "pred.txt",
            "-verbosity", "1"] + extra
    for main, more in ((cli.main, ["-device", "cpu"]), (jax_main, [])):
        assert main(argv + more) == 0
        out = capsys.readouterr().out
        pred = np.loadtxt("pred.txt")
        assert pred.shape == (te.num_rows,)
        final = float(out.split("Final\tTest=")[1].split()[0])
        want = np.sqrt(np.mean((pred[:NEC] - te.target[:NEC]) ** 2))
        np.testing.assert_allclose(final, want, rtol=1e-5)
        if method in ("mcmc", "als"):
            assert f"num_eval_cases={NEC}" in out
