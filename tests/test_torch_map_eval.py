"""Per-iteration MAP@k in the port's Gibbs/ALS and OVB classification loops
and the CLI's ``-map_eval`` (``svbfm_tpu_torch/learners/base.py``:
``map_at_k``, ``load_map_fixture``, ``MapEval``), against
``tests/test_map_eval.py``'s three cases and the JAX package:

* ``map_at_k`` and ``load_map_fixture`` equal the JAX functions on the
  same inputs;
* the probabilities each iteration ranks (Gibbs: the posterior mean
  psum_all / (it + 1), the JAX key chain replayed; OVB: Phi of the
  epoch's test scores) are JAX's within test_torch_classification.py's
  tolerance for final_test_predictions, rtol 1e-4 / atol 1e-5.
"""

import os

import jax
import numpy as np
import pytest

from svbfm_tpu.learners import base as jbase
from svbfm_tpu.learners import mcmc as jm
from svbfm_tpu.learners import vb_online as jov
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.libfm_text import save_libfm_text
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.learners import mcmc as tm
from svbfm_tpu_torch.learners import vb_online as tov
from svbfm_tpu_torch.learners.base import (TASK_CLASSIFICATION, FMConfig,
                                           MapEval, load_map_fixture,
                                           map_at_k)
from svbfm_tpu_torch.utils.convert import (mcmc_state_from_jax,
                                           ovb_state_from_jax)

from test_torch_classification import _binary, _pair
from test_torch_mcmc import JaxKeyDraws


def _user_item_of(coo_sub, num_users):
    """Per-row (user, item) ids of a 2-hot movielens-like COO subset."""
    order = np.lexsort((coo_sub.col, coo_sub.row))
    row = coo_sub.row[order].reshape(-1, 2)
    col = coo_sub.col[order].reshape(-1, 2)
    assert (row[:, 0] == row[:, 1]).all()
    return col.min(axis=1), col.max(axis=1) - num_users


def _fixture_of(te, num_users):
    users, items = _user_item_of(te, num_users)
    positives = {}
    for u, i, y in zip(users, items, te.target):
        if y > 0:
            positives.setdefault(int(u), set()).add(int(i))
    return users, items, positives


class _Recorder:
    """A MapEval of either package that keeps the probabilities it ranks."""

    def __init__(self, cls, fixture):
        self.inner = cls(*fixture, k=5)
        self.k = 5
        self.probs = []

    def __call__(self, probs):
        self.probs.append(np.asarray(probs, np.float64).copy())
        return self.inner(probs)


def test_map_at_k_and_fixture_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    n = 400
    users = rng.integers(0, 30, n)
    items = rng.integers(0, 20, n)
    probs = rng.uniform(size=n).astype(np.float32)
    probs[::9] = probs[1::9][: len(probs[::9])]  # ties
    rating = rng.integers(0, 2, n)
    path = tmp_path / "fix.txt"
    path.write_text("".join(f"{r} {u}:1 {i + 100}:1\n"
                            for r, u, i in zip(rating, users, items)))
    ours = load_map_fixture(str(path), item_offset=100)
    theirs = jbase.load_map_fixture(str(path), item_offset=100)
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_array_equal(a, b)
    assert ours[2] == theirs[2]
    for k in (1, 5, 10):
        assert map_at_k(probs, *ours, k=k) == \
            jbase.map_at_k(probs, *theirs, k=k)
    assert MapEval.from_file(str(path), 100, 5)(probs) == \
        jbase.MapEval.from_file(str(path), 100, 5)(probs)


@pytest.mark.parametrize("which", ["gibbs", "ovb"])
def test_per_iteration_map_matches_jax(which):
    """test_map_eval.py's learners (25 users, 2,500 ratings, K = 4) from
    one injected state: each iteration's MAP@5 (not all equal) ranks
    JAX's probabilities."""
    D, tr, te = _binary(2500, 25, 20, 9, holdout=0.2)
    fixture = _fixture_of(te, 25)
    if which == "gibbs":
        jl, tl = _pair(jm.MCMCLearner, tm.MCMCLearner, 2500, 25, 20, seed=9,
                       K=4, holdout=0.2)
        js = jl.init_state()
        ts = mcmc_state_from_jax(jax.device_get(js), "cpu",
                                 JaxKeyDraws(js.key))
    else:
        jl, tl = _pair(jov.OVBLearner, tov.OVBLearner, 2500, 25, 20, seed=9,
                       K=4, holdout=0.2, num_batches=5)
        js = jl.init_state()
        ts = ovb_state_from_jax(jax.device_get(js), "cpu")
    jl.map_eval = jrec = _Recorder(jbase.MapEval, fixture)
    tl.map_eval = trec = _Recorder(MapEval, fixture)
    _, jh = jl.run(js, num_iter=3, verbose=False)
    _, th = tl.run(ts, num_iter=3, verbose=False)
    maps = [rec["map"] for rec in th]
    assert len(maps) == 3 and maps[-1] > 0.0
    assert len(set(round(m, 12) for m in maps)) > 1
    if which == "gibbs":  # test_map_eval.py:74 (the reference's AP
        # recurrence can pass 1 where a user rates an item twice)
        assert all(0.0 <= m <= 1.0 for m in maps)
    assert len(trec.probs) == len(jrec.probs) == 3
    for a, b in zip(trec.probs, jrec.probs):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    for rec, p in zip(th, trec.probs):
        assert rec["map"] == map_at_k(p, *fixture, k=5)


def test_ovb_map_written_to_trajectory_file(tmp_path):
    """The reference writes MAP@k, not the accuracy, into test_rmse_* for
    task c (fm_learn_vb_online_simultaneous.h:258-262)."""
    D, tr, te = _binary(2500, 25, 20, 13, holdout=0.2)
    meta = DataMetaInfo.from_field_offsets(D, [0, 25])
    cfg = FMConfig(num_attributes=D, num_factor=4, task=TASK_CLASSIFICATION,
                   min_target=-1.0, max_target=1.0,
                   num_groups=meta.num_attr_groups, seed=7, num_batches=5)
    lr = tov.OVBLearner(cfg, SparseDataset.from_coo(tr, D),
                        SparseDataset.from_coo(te, D), meta, device="cpu",
                        out_dir=str(tmp_path))
    lr.map_eval = MapEval(*_fixture_of(te, 25), k=5)
    _, history = lr.run(num_iter=3, verbose=False)
    assert all("map" in rec for rec in history)
    vals = [float(x) for x in
            (tmp_path / "test_rmse_114_vb_online").read_text().split()]
    assert vals == pytest.approx([rec["map"] for rec in history], abs=1e-6)


def test_cli_map_eval_per_iteration(tmp_path, capsys):
    """-map_eval through both CLIs: MAP@5 on every #Iter line and the final
    MAP@5 line, from the same fixture."""
    from svbfm_tpu.cli import main as jax_main
    from svbfm_tpu_torch.cli import main
    D, tr, te = _binary(2500, 25, 20, 21, holdout=0.2)
    trf, tef = str(tmp_path / "c.train"), str(tmp_path / "c.test")
    save_libfm_text(trf, tr)
    save_libfm_text(tef, te)
    users, items = _user_item_of(te, 25)
    fixf = str(tmp_path / "c.fixture")
    with open(fixf, "w") as f:
        for u, i, y in zip(users, items, te.target):
            f.write(f"{1 if y > 0 else 0} {u}:1 {i}:1\n")
    argv = ["-task", "c", "-train", trf, "-test", tef, "-dim", "1,1,4",
            "-method", "mcmc", "-iter", "3", "-seed", "3", "-map_eval", fixf,
            "-map_k", "5"]
    outs = []
    old = os.getcwd()
    os.chdir(tmp_path)
    try:
        for fn, extra in ((main, ["-device", "cpu"]), (jax_main, [])):
            assert fn(argv + extra) == 0
            outs.append(capsys.readouterr().out)
    finally:
        os.chdir(old)
    for out in outs:
        iters = [ln for ln in out.splitlines() if ln.startswith("#Iter=")]
        assert len(iters) == 3 and all("MAP@5= " in ln for ln in iters)
        final = [ln for ln in out.splitlines() if ln.startswith("MAP@5\t")]
        assert len(final) == 1 and 0.0 <= float(final[0].split()[1]) <= 1.0
