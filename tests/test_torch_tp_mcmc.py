"""The port's feature-sharded Gibbs MCMC and ALS (``parallel/tp_mcmc.py``) on
spawned gloo ranks, against the JAX package's ``TPALSLearner`` and
``TPMCMCLearner`` on the same meshes (conftest's 8-device CPU mesh).

Both packages start from the JAX learner's initial state
(``utils.convert.tp_mcmc_state_from_jax``, each rank its part); Gibbs
replays the JAX key chain (``test_torch_mcmc.py:JaxKeyDraws``, whose
``column_normal`` calls ``_z_table_local`` with the replayed sub-key).  The
recipe is ``tests/test_tp_mcmc.py:_setup``'s (900 ratings, K = 4).
Tolerances are ``test_tp_mcmc.py``'s: rtol 5e-4 / atol 1e-4 on the tables
and rtol 2e-4 on the RMSE (:44-52), rtol 1e-5 on the hyperparameters of a
deterministic multilevel step (:171), rtol 5e-4 between two meshes (:66),
accuracy above 0.6 after 10 classification sweeps (:90); a resume, also
onto another mesh, within rtol 1e-5 of the uninterrupted run.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest

from svbfm_tpu.parallel.mesh import make_mesh2d as jmesh2d
from svbfm_tpu.parallel.tp_mcmc import TPALSLearner as JTPALS
from svbfm_tpu.parallel.tp_mcmc import TPMCMCLearner as JTPMCMC
from svbfm_tpu_torch.learners.mcmc import ALSLearner
from svbfm_tpu_torch.parallel import tp_vb
from svbfm_tpu_torch.parallel.mesh import make_mesh2d
from svbfm_tpu_torch.parallel.tp_mcmc import (TPALSLearner,
                                              tp_mcmc_buffer_bytes)
from test_tp_mcmc import _setup
from torch_tp_ranks import (mcmc_four_ranks, mcmc_setup, mcmc_two_ranks,
                            run_ranks)

MESHES = [(1, 2), (2, 1), (2, 2)]
NUM_ITER = 4
RANKS_TIMEOUT = 300


def _host(state) -> dict:
    s = jax.device_get(state)
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


def _jax_run(cls, cfg, tr, te, meta, shape, num_iter, path=None):
    lr = cls(cfg, tr, te, meta,
             mesh=jmesh2d(n_data=shape[0], n_feature=shape[1]))
    s0 = lr.init_state()
    if path is not None:
        np.savez(path, **_host(s0))
    s, h = lr.run(s0, num_iter=num_iter, verbose=False)
    return dict(hist=h, state=_host(s))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """For each mesh: the JAX initial global state (saved as npz, its key
    beside it), the 4-sweep ALS and Gibbs runs from it; one deterministic
    multilevel step on (2, 2)."""
    d = tmp_path_factory.mktemp("jax_tp_mcmc")
    cfg, tr, te, meta, D = _setup()
    out = {"D": D}
    for shape in MESHES:
        path = str(d / f"init_{shape[0]}x{shape[1]}.npz")
        out[shape, "gibbs"] = _jax_run(JTPMCMC, cfg, tr, te, meta, shape,
                                       NUM_ITER, path)
        out[shape, "als"] = _jax_run(JTPALS, cfg, tr, te, meta, shape,
                                     NUM_ITER)
        out[shape, "init"] = path
    cfg, tr, te, meta, _ = _setup(seed=41)
    cfg = dataclasses.replace(cfg, do_sample=False, do_multilevel=True)
    out["ml_init"] = str(d / "init_ml.npz")
    out["multilevel"] = _jax_run(JTPMCMC, cfg, tr, te, meta, (2, 2), 1,
                                 out["ml_init"])
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """The port's runs: two ranks (the meshes (1, 2) and (2, 1), the
    checkpoint and the edge configs) and four ((2, 2)); each rank's
    results."""
    d = tmp_path_factory.mktemp("tp_mcmc_ranks")
    inits = {s: jax_runs[s, "init"] for s in MESHES}
    two = run_ranks(mcmc_two_ranks, 2, d / "two", timeout=RANKS_TIMEOUT,
                    inits=inits, ck=str(d / "ck"))
    four = run_ranks(mcmc_four_ranks, 4, d / "four", timeout=RANKS_TIMEOUT,
                     init=inits[(2, 2)], ml_init=jax_runs["ml_init"])
    out = {}
    for shape in ((1, 2), (2, 1)):
        for kind in ("als", "gibbs"):
            out[shape, kind] = [r[shape, kind] for r in two]
    for kind in ("als", "gibbs"):
        out[(2, 2), kind] = [r[kind] for r in four]
    for k in ("own", "full", "first", "resumed", "k0", "bias_off"):
        out[k, 2] = [r[k] for r in two]
    for k in ("multilevel", "own", "class"):
        out[k, 4] = [r[k] for r in four]
    return out


def _same_on_every_rank(res):
    for r in res[1:]:
        for a, b in zip(r["hist"], res[0]["hist"]):
            for k in ("rmse", "rmse_this", "alpha"):
                assert a[k] == b[k], k


def _close_to_jax(res, ref, D):
    for k in ("w", "v"):
        np.testing.assert_allclose(res["state"][k][..., :D],
                                   ref["state"][k][..., :D], rtol=5e-4,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(res["state"]["w0"]),
                               float(ref["state"]["w0"]), rtol=1e-4)
    assert len(res["hist"]) == len(ref["hist"]) == NUM_ITER
    for a, b in zip(res["hist"], ref["hist"]):
        for k in ("rmse", "rmse_this"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_als_matches_jax(jax_runs, port_runs, shape):
    res = port_runs[shape, "als"]
    assert len(res) == 2 if shape != (2, 2) else len(res) == 4
    _same_on_every_rank(res)
    assert res[0]["D_loc"] * shape[1] >= jax_runs["D"]
    _close_to_jax(res[0], jax_runs[shape, "als"], jax_runs["D"])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_gibbs_matches_jax(jax_runs, port_runs, shape):
    """The replayed key chain: the same numbers, drawn in JAX's order and
    shapes (the final keys equal), so the sampled tables agree."""
    res = port_runs[shape, "gibbs"]
    _same_on_every_rank(res)
    ref = jax_runs[shape, "gibbs"]
    _close_to_jax(res[0], ref, jax_runs["D"])
    for r in res:
        np.testing.assert_array_equal(r["key"], ref["state"]["key"])
    for k in ("alpha", "w_mu", "w_lambda", "v_mu", "v_lambda"):
        np.testing.assert_allclose(res[0]["state"][k], ref["state"][k],
                                   rtol=2e-4, atol=1e-6, err_msg=k)


def test_tp_multilevel_deterministic_matches_jax(jax_runs, port_runs):
    """``test_tp_mcmc.py:test_tp_multilevel_deterministic_matches_replicated``
    against the JAX TP learner: one step of do_sample=False,
    do_multilevel=True pins the group statistics (local segment sums
    all-reduced over the feature group)."""
    res = port_runs["multilevel", 4][0]["state"]
    ref = jax_runs["multilevel"]["state"]
    D = jax_runs["D"]
    for k in ("w_mu", "v_mu"):
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in ("w_lambda", "v_lambda", "alpha"):
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-5, err_msg=k)
    for k in ("w", "v"):
        np.testing.assert_allclose(res[k][..., :D], ref[k][..., :D],
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_tp_gibbs_mesh_invariance(port_runs):
    """The port's own Gibbs (a host generator of the seed, the column
    tables keyed by the global column): (1, 2) against (2, 2)."""
    a, b = port_runs["own", 2][0], port_runs["own", 4][0]
    assert len(a["hist"]) == len(b["hist"]) == NUM_ITER
    for x, y in zip(a["hist"], b["hist"]):
        np.testing.assert_allclose(x["rmse"], y["rmse"], rtol=5e-4)


def test_tp_mcmc_classification(port_runs):
    res = port_runs["class", 4]
    _h = res[0]["hist"]
    assert len(_h) == 10
    assert _h[-1]["accuracy"] > 0.6
    for r in res[1:]:
        assert r["hist"][-1]["accuracy"] == _h[-1]["accuracy"]


def test_tp_mcmc_checkpoint_resume(port_runs):
    """6 sweeps against 3, a checkpoint, and 3 more resumed on another
    mesh: the checkpoint holds the global layout and the draw source's
    generator state."""
    full = port_runs["full", 2][0]
    first = port_runs["first", 2][0]
    res = port_runs["resumed", 2][0]
    assert len(first["hist"]) == 3
    h = res["hist"]
    assert len(h) == 3 and h[0]["iter"] == 3
    np.testing.assert_allclose(h[-1]["rmse"], full["hist"][-1]["rmse"],
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["k0", "bias_off"])
def test_tp_edge_configs(port_runs, kind):
    """dim 1,1,0 (K = 0, Gibbs) and 0,0,4 (ALS) run finite."""
    h = port_runs[kind, 2][0]["hist"]
    assert len(h) == 3 and np.isfinite(h[-1]["rmse"])


def test_tp_als_one_rank_is_the_resident_als():
    """A one-rank mesh (no collective) runs the resident ALSLearner's
    sweep: the same trajectory and tables."""
    cfg, tr, te, meta, D = mcmc_setup()
    _, h1 = ALSLearner(cfg, tr, te, meta, device="cpu",
                       write_files=False).run(num_iter=3, verbose=False)
    lr = TPALSLearner(cfg, tr, te, meta, mesh=make_mesh2d(device="cpu"))
    _, h2 = lr.run(num_iter=3, verbose=False)
    for a, b in zip(h1, h2):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=1e-5)


def test_tp_mcmc_budget_check_fails_loudly(monkeypatch):
    """Where T1 and T5-T8's buffers exceed the rank's device memory (a
    budget shrunk to 64 bytes), the learner fails at construction."""
    cfg, tr, te, meta, _ = mcmc_setup()
    lr = TPALSLearner(cfg, tr, te, meta, mesh=make_mesh2d(device="cpu"))
    parts = tp_mcmc_buffer_bytes(lr.plan_data, lr.rps, 4, 4, lr.D_loc, True)
    assert parts["q cache"] == lr.rps * 4 * 4
    monkeypatch.setattr(tp_vb, "TP_BUDGET_BYTES", 64)
    with pytest.raises(RuntimeError, match="replicated learner"):
        TPALSLearner(cfg, tr, te, meta, mesh=make_mesh2d(device="cpu"))
