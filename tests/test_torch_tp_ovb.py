"""The port's feature-sharded online VB (``parallel/tp_ovb.py``) on spawned
gloo ranks, against the JAX package's ``TPOVBLearner`` on the same meshes
(conftest's 8-device CPU mesh) and against the port's resident
``OVBLearner``.

Both packages start from the JAX learner's initial state
(``utils.convert.tp_ovb_state_from_jax``, each rank its part); the recipe
is ``tests/test_tp_ovb.py:_setup``'s (900 ratings, 18 users, 14 items,
K = 3, 4 chunks).  Tolerances: ``test_tp_ovb.py:48-51``'s on the
trajectory (RMSE rtol 2e-3 / atol 2e-4, free energy rtol 2e-3) and
``test_torch_tp_vb.py``'s on the tables (rtol 5e-4, atol 1e-5): the JAX
learner pads every chunk to one common shape and sums in another order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.parallel.mesh import make_mesh2d as jmesh2d
from svbfm_tpu.parallel.tp_ovb import TPOVBLearner as JTPOVB
from svbfm_tpu_torch.learners.vb_online import OVBLearner
from svbfm_tpu_torch.parallel import tp_vb
from svbfm_tpu_torch.parallel.mesh import make_mesh2d
from svbfm_tpu_torch.parallel.tp_ovb import (TPOVBLearner,
                                             tp_ovb_buffer_bytes)
from svbfm_tpu_torch.utils.convert import (ovb_state_from_jax,
                                           tp_ovb_state_from_jax)
from test_tp_ovb import _setup
from torch_tp_ranks import ovb_ranks, ovb_setup, run_ranks

MESHES = [(1, 2), (2, 2), (1, 4)]
NUM_ITER = 4
RANKS_TIMEOUT = 240
TABLES = ("mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash", "n_mu_w",
          "n_sig_w", "n_mu_v", "n_sig_v", "t_wj", "t_vj")


def _host(state) -> dict:
    s = jax.device_get(state)
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """For each mesh: the JAX learner's initial global state (saved as
    npz) and its 4-epoch history and final state."""
    d = tmp_path_factory.mktemp("jax_tp_ovb")
    tr, te, D, meta, cfg = _setup()
    out = {"D": D}
    for shape in MESHES:
        lr = JTPOVB(cfg, JDataset.from_coo(tr, D), JDataset.from_coo(te, D),
                    meta,
                    mesh=jmesh2d(n_data=shape[0], n_feature=shape[1]),
                    write_files=False)
        s0 = lr.init_state()
        path = str(d / f"init_{shape[0]}x{shape[1]}.npz")
        np.savez(path, **_host(s0))
        s, h = lr.run(s0, num_iter=NUM_ITER, verbose=False)
        out[shape] = dict(path=path, hist=h, state=_host(s),
                          scores=lr.predict_test_scores(s))
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """Two ranks: the meshes (1, 2) and (2, 1) from the (1, 2) init, and
    (1, 2) from the port's own init; four ranks: (2, 2) and (1, 4) from
    their inits.  Each rank's results by shape."""
    d = tmp_path_factory.mktemp("tp_ovb_ranks")
    init = jax_runs[(1, 2)]["path"]
    two = run_ranks(ovb_ranks, 2, d / "two", timeout=RANKS_TIMEOUT,
                    runs=[((1, 2), init), ((2, 1), init), ((1, 2), "")],
                    num_iter=NUM_ITER)
    four = run_ranks(ovb_ranks, 4, d / "four", timeout=RANKS_TIMEOUT,
                     runs=[((2, 2), jax_runs[(2, 2)]["path"]),
                           ((1, 4), jax_runs[(1, 4)]["path"])],
                     num_iter=NUM_ITER)
    return {k: [r[k] for r in res] for res in (two, four) for k in res[0]}


def _same_on_every_rank(res):
    for r in res[1:]:
        for a, b in zip(r["hist"], res[0]["hist"]):
            for k in ("rmse", "mae", "free_energy"):
                assert a[k] == b[k], k


def _close_hist(ha, hb):
    assert len(ha) == len(hb) == NUM_ITER
    for a, b in zip(ha, hb):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=2e-3,
                                   atol=2e-4)
        np.testing.assert_allclose(a["free_energy"], b["free_energy"],
                                   rtol=2e-3)


def _close_tables(sa, sb, D):
    for k in TABLES:
        np.testing.assert_allclose(np.asarray(sa[k])[..., :D],
                                   np.asarray(sb[k])[..., :D],
                                   rtol=5e-4, atol=1e-5, err_msg=k)
    for k in ("mu_0", "alpha", "sigma_w", "sigma_v", "t_w0"):
        np.testing.assert_allclose(np.asarray(sa[k]), np.asarray(sb[k]),
                                   rtol=5e-4, err_msg=k)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_ovb_matches_jax_on_the_same_mesh(jax_runs, port_runs, shape):
    res = port_runs[shape]
    assert len(res) == shape[0] * shape[1]
    _same_on_every_rank(res)
    D = jax_runs["D"]
    ref = jax_runs[shape]
    assert res[0]["D_loc"] * shape[1] >= D
    _close_hist(res[0]["hist"], ref["hist"])
    _close_tables(res[0]["state"], ref["state"], D)
    np.testing.assert_allclose(res[0]["scores"], ref["scores"], rtol=5e-4,
                               atol=1e-5)


def test_tp_ovb_mesh_invariance(port_runs):
    """(2, 1) against (1, 2) from one state: row sharding against table
    sharding, the chunk rows split otherwise, the same trajectory."""
    a, b = port_runs[(2, 1)][0], port_runs[(1, 2)][0]
    for x, y in zip(a["hist"], b["hist"]):
        for k in ("rmse", "mae", "free_energy"):
            np.testing.assert_allclose(x[k], y[k], rtol=1e-5, err_msg=k)
    _close_tables(a["state"], b["state"], a["D_loc"])


def test_tp_ovb_own_init_on_ranks(port_runs):
    """The port's own init (``init_ovb_state`` from the seed, cut to the
    rank's shard) on (1, 2) against the same on one rank: equal within
    float reassociation, and the free energy rises epoch by epoch."""
    res = port_runs[((1, 2), "own")]
    _same_on_every_rank(res)
    cfg, tr, te, meta, D = ovb_setup()
    one = TPOVBLearner(cfg, tr, te, meta, mesh=make_mesh2d(device="cpu"))
    _, h = one.run(num_iter=NUM_ITER, verbose=False)
    for a, b in zip(res[0]["hist"], h):
        for k in ("rmse", "free_energy"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    assert np.all(np.isfinite([r["rmse"] for r in h]))


def test_tp_ovb_world_of_one_matches_resident(jax_runs):
    """A (1, 1) mesh (no process group) against the port's resident
    OVBLearner from the same JAX init: the same chunks in the same order;
    T1/T4 in place of K1/K4 and T9/T10's launches, the same math."""
    cfg, tr, te, meta, D = ovb_setup()
    with np.load(jax_runs[(1, 2)]["path"]) as z:
        init = dict(z)
    tp = TPOVBLearner(cfg, tr, te, meta, mesh=make_mesh2d(device="cpu"))
    st, h = tp.run(tp_ovb_state_from_jax(init, "cpu", d=0, f=0,
                                         D_loc=tp.D_loc),
                   num_iter=NUM_ITER, verbose=False)
    whole = {k: (v[..., :D] if k in TABLES else v) for k, v in init.items()}
    res = OVBLearner(cfg, tr, te, meta, device="cpu", write_files=False)
    rs, hr = res.run(ovb_state_from_jax(whole, "cpu"), num_iter=NUM_ITER,
                     verbose=False)
    for a, b in zip(h, hr):
        for k in ("rmse", "mae", "free_energy"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    _close_tables(dataclasses.asdict(tp.global_state(st)),
                  dataclasses.asdict(rs), D)
    np.testing.assert_allclose(tp.predict_test_scores(st),
                               res.predict_test_scores(rs), rtol=1e-5,
                               atol=1e-6)


def test_tp_ovb_factor_block_and_task():
    """factor_block 0 becomes 1 (the factor-sequential sweep); another
    width, classification and -reshuffle are refused."""
    cfg, tr, te, meta, _ = ovb_setup(factor_block=0)
    mesh = make_mesh2d(device="cpu")
    assert TPOVBLearner(cfg, tr, te, meta, mesh=mesh).cfg.factor_block == 1
    for kw, msg in ((dict(factor_block=2), "factor-sequential"),
                    (dict(task=1), "regression alone"),
                    (dict(reshuffle=True), "membership fixed")):
        with pytest.raises(ValueError, match=msg):
            TPOVBLearner(dataclasses.replace(cfg, **kw), tr, te, meta,
                         mesh=mesh)


def test_tp_ovb_refuses_a_checkpoint():
    cfg, tr, te, meta, _ = ovb_setup()
    lr = TPOVBLearner(cfg, tr, te, meta, mesh=make_mesh2d(device="cpu"))
    with pytest.raises(ValueError, match="does not checkpoint"):
        lr.run(num_iter=1, verbose=False, ckpt=object())


def test_tp_ovb_budget_check_fails_loudly(monkeypatch):
    """``test_torch_tp_vb.py:test_tp_budget_check_fails_loudly`` for the
    online learner: OVB's own buffers (qt [N, 3], the N 5 patch, T1's
    partials, the [D_loc, 5] patch table, a bin's sums) counted, and a
    budget shrunk to 64 bytes fails at construction with the remedies."""
    cfg, tr, te, meta, _ = ovb_setup()
    mesh = make_mesh2d(device="cpu")
    lr = TPOVBLearner(cfg, tr, te, meta, mesh=mesh)
    n = max(c.row.ids.shape[0] for c in lr.chunks)
    parts = tp_ovb_buffer_bytes(lr.chunks, n, cfg.num_factor, lr.D_loc)
    assert parts["row caches qt"] == n * 3 * 4
    assert parts["T1 partials"] == n * (1 + 3 * cfg.num_factor) * 4
    assert parts["bin sums"] == 8 * max(p.num_cols for c in lr.chunks
                                        for p in c.bins)
    monkeypatch.setattr(tp_vb, "TP_BUDGET_BYTES", 64)
    with pytest.raises(RuntimeError, match="replicated learner"):
        TPOVBLearner(cfg, tr, te, meta, mesh=mesh)


def test_tp_ovb_state_from_jax_cuts_the_shard():
    """``tp_ovb_state_from_jax`` takes the rank's feature slice of the ten
    padded tables and the scalars whole, the same on every data shard."""
    rng = np.random.default_rng(0)
    K, D_pad, G = 3, 8, 2
    g = {}
    for k in ("mu_0", "sigma_0_dash", "n_mu_0", "n_sig_0", "alpha",
              "sigma_0", "t_w0"):
        g[k] = np.float32(rng.standard_normal())
    for k in ("mu_w", "sigma_w_dash", "n_mu_w", "n_sig_w", "t_wj", "t_vj"):
        g[k] = rng.standard_normal(D_pad).astype(np.float32)
    for k in ("mu_v", "sigma_v_dash", "n_mu_v", "n_sig_v"):
        g[k] = rng.standard_normal((K, D_pad)).astype(np.float32)
    g["sigma_w"] = rng.standard_normal(G).astype(np.float32)
    g["sigma_v"] = rng.standard_normal((G, K)).astype(np.float32)
    for d in (0, 1):
        s = tp_ovb_state_from_jax(g, "cpu", d=d, f=1, D_loc=4)
        for k in TABLES:
            assert torch.equal(getattr(s, k), torch.from_numpy(
                g[k][..., 4:8]))
        assert torch.equal(s.sigma_v, torch.from_numpy(g["sigma_v"]))
        assert float(s.alpha) == float(g["alpha"])
