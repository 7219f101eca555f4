"""The port's feature-sharded batch VB (``parallel/tp_vb.py``) on spawned
gloo ranks, against the JAX package's ``TPVBLearner`` on the same mesh
(conftest's 8-device CPU mesh) and against the port's own fast-mode
``VBLearner``.

Both TP learners start from the JAX learner's initial state
(``utils.convert.tp_vb_state_from_jax``, each rank its part); the recipe
is ``tests/test_tp.py:_tp_train_setup``'s (700 ratings, K = 4).
Tolerances are ``test_tp.py:69-80``'s: rtol 5e-4, atol 1e-5 on the
tables; rtol 1e-4 on alpha, RMSE and the free energy.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh2d as jmesh2d
from svbfm_tpu.parallel.tp_vb import TPVBLearner as JTPVBLearner
from svbfm_tpu_torch.learners.vb import VBLearner
from torch_tp_ranks import (full_and_first, run_ranks, tp_setup, train,
                            train_ckpt)

MESHES = [(1, 2), (2, 1), (2, 2)]
NUM_ITER = 5
TABLES = ("mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash")


def _jax_setup(seed=2, K=4):
    coo = make_movielens_like(num_users=20, num_items=14, num_ratings=700,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = JMeta.from_field_offsets(D, [0, 20])
    cfg = JConfig(num_attributes=D, num_factor=K,
                  min_target=float(tr.target.min()),
                  max_target=float(tr.target.max()),
                  num_groups=meta.num_attr_groups, seed=7)
    return cfg, JDataset.from_coo(tr, D), JDataset.from_coo(te, D), meta, D


def _host(state) -> dict:
    s = jax.device_get(state)
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """For each mesh: the JAX learner's initial global state (saved as
    npz), its 5-sweep history and final state."""
    out = {}
    d = tmp_path_factory.mktemp("jax_tp")
    cfg, tr, te, meta, D = _jax_setup()
    for shape in MESHES:
        lr = JTPVBLearner(cfg, tr, te, meta,
                          mesh=jmesh2d(n_data=shape[0], n_feature=shape[1]))
        s0 = lr.init_state()
        init = _host(s0)
        path = str(d / f"init_{shape[0]}x{shape[1]}.npz")
        np.savez(path, **init)
        s, h = lr.run(s0, num_iter=NUM_ITER, verbose=False)
        out[shape] = dict(init=init, path=path, hist=h, state=_host(s),
                          scores=lr.predict_test_scores(s))
    return out, D


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    runs, _ = jax_runs
    out = {}
    for shape in MESHES:
        d = tmp_path_factory.mktemp(f"ranks_{shape[0]}x{shape[1]}")
        res = run_ranks(train, shape[0] * shape[1], d, timeout=120,
                        shape=shape, setup={}, num_iter=NUM_ITER,
                        init=runs[shape]["path"])
        out[shape] = res
    return out


def _close_hist(ha, hb, rtol=1e-4):
    assert len(ha) == len(hb) == NUM_ITER
    for a, b in zip(ha, hb):
        for k in ("rmse", "free_energy"):
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)


def _close_tables(sa, sb, D):
    for k in TABLES:
        np.testing.assert_allclose(np.asarray(sa[k])[..., :D],
                                   np.asarray(sb[k])[..., :D],
                                   rtol=5e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(sa["alpha"]), float(sb["alpha"]),
                               rtol=1e-4)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_vb_matches_jax_on_the_same_mesh(jax_runs, port_runs, shape):
    runs, D = jax_runs
    ref = runs[shape]
    res = port_runs[shape]
    assert len(res) == shape[0] * shape[1]
    for r in res:  # every rank saw the same metrics
        _close_hist(r["hist"], res[0]["hist"], rtol=0)
    _close_hist(res[0]["hist"], ref["hist"])
    assert res[0]["D_loc"] * shape[1] >= D
    _close_tables(res[0]["state"], ref["state"], D)
    np.testing.assert_allclose(res[0]["state"]["e"], ref["state"]["e"],
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(res[0]["scores"], ref["scores"], rtol=1e-4,
                               atol=1e-5)


def test_tp_vb_matches_the_ports_fast_vb(jax_runs, port_runs):
    """Each mesh's trajectory against the single-device fast-mode
    VBLearner from the same parameters (its e and t from its own K1)."""
    runs, D = jax_runs
    cfg, tr, te, meta, _ = tp_setup()
    init = runs[MESHES[0]]["init"]
    params = {k: torch.from_numpy(np.array(v)) for k, v in init.items()}
    for k in TABLES:
        params[k] = params[k][..., :D].contiguous()
    vb = VBLearner(cfg, tr, te, meta, device="cpu", write_files=False)
    s, h = vb.run(vb.state_from_params(params), num_iter=NUM_ITER,
                  verbose=False)
    for shape in MESHES:
        res = port_runs[shape][0]
        _close_hist(res["hist"], h)
        for a, b in zip(res["hist"], h):
            np.testing.assert_allclose(a["alpha"], b["alpha"], rtol=1e-4)
        _close_tables(res["state"], {f: getattr(s, f).numpy() for f in
                                     TABLES + ("alpha",)}, D)


def test_tp_vb_mesh_invariance(jax_runs, port_runs):
    """(2, 1) against (1, 2): row sharding against table sharding."""
    _, D = jax_runs
    a, b = port_runs[(2, 1)][0], port_runs[(1, 2)][0]
    _close_hist(a["hist"], b["hist"])
    _close_tables(a["state"], b["state"], D)


def test_tp_vb_checkpoint_resume(tmp_path):
    """``tests/test_tp_mcmc.py:test_tp_vb_checkpoint_resume`` on spawned
    ranks: 6 sweeps against 3, a checkpoint, and 3 more resumed on another
    mesh (the checkpoint holds the global layout, so it does not depend
    on the mesh)."""
    setup = dict(seed=21)
    ck = str(tmp_path / "ck")
    full, first = run_ranks(full_and_first, 2, tmp_path / "a", timeout=120,
                            setup=setup, ck=ck)[0]
    assert len(first["hist"]) == 3
    assert any(f.endswith(".npz") for f in os.listdir(ck))
    res = run_ranks(train_ckpt, 2, tmp_path / "b", timeout=120,
                    shape=(2, 1), setup=setup, num_iter=6, ckpt_dir=ck,
                    ckpt_every=100)[0]
    h = res["hist"]
    assert len(h) == 3 and h[0]["iter"] == 3
    np.testing.assert_allclose(h[-1]["rmse"], full["hist"][-1]["rmse"],
                               rtol=1e-5)
    np.testing.assert_allclose(res["state"]["mu_v"], full["state"]["mu_v"],
                               rtol=1e-5, atol=1e-6)



def test_tp_budget_check_fails_loudly(monkeypatch):
    """``tests/test_tp.py:118`` in the port: where T1-T4's buffers exceed
    the rank's device memory (here a budget shrunk to 64 bytes) the learner
    fails at construction with the remedies, not mid-sweep; on the CPU,
    with no budget set, it constructs."""
    from svbfm_tpu_torch.parallel import tp_vb as tpmod
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d

    cfg, tr, te, meta, _ = tp_setup()
    mesh = make_mesh2d(device="cpu")
    lr = tpmod.TPVBLearner(cfg, tr, te, meta, mesh=mesh)
    parts = tpmod.tp_buffer_bytes(lr.plan_data, lr.rps, 4, lr.D_loc)
    assert parts["row caches qt"] == lr.rps * 12 * 4
    monkeypatch.setattr(tpmod, "TP_BUDGET_BYTES", 64)
    with pytest.raises(RuntimeError, match="replicated learner"):
        tpmod.TPVBLearner(cfg, tr, te, meta, mesh=mesh)
