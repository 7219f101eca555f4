"""The port's feature-sharded SGD (``parallel/tp_sgd.py``, T11 and X9b's
dense form) on spawned gloo ranks, against the JAX package's
``TPSGDLearner`` on the same meshes (conftest's 8-device CPU mesh) and
against the port's resident ``SGDLearner``.

Both packages start from the JAX learner's initial state
(``utils.convert.tp_sgd_state_from_jax``, each rank its part) and shuffle
by the JAX learner's permutations: its key chain is replayed here (an
epoch splits the key, data shard d permutes with the sub-key folded with
d, ``svbfm_tpu/learners/sgd.py:159-172``) and the ranks take the recorded
permutations (``torch_tp_ranks.RecordedPerms``).  The recipe is
``tests/test_tp_sgd.py:_setup``'s (900 ratings, K = 3, batch 128, 5
epochs).  Tolerances: ``test_tp_sgd.py:52-54``'s on the RMSE history (rtol
2e-4 / atol 2e-5) and ``test_torch_tp_vb.py``'s on the tables (rtol 5e-4
/ atol 1e-5); one minibatch on two shards against JAX's
``sgd_minibatch_update`` on the whole table, ``test_torch_sgd.py``'s (rtol
1e-5 / atol 1e-6).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.learners import sgd as js
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu.parallel.mesh import make_mesh2d as jmesh2d
from svbfm_tpu.parallel.tp_sgd import TPSGDLearner as JTPSGD
from svbfm_tpu_torch.kernels import fm_forward as k1
from svbfm_tpu_torch.kernels import sgd_step as ks
from svbfm_tpu_torch.learners import sgd as ts
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.draws import Draws, host_draws
from svbfm_tpu_torch.parallel.mesh import make_mesh2d
from svbfm_tpu_torch.parallel.tp_sgd import TPSGDLearner
from svbfm_tpu_torch.utils.convert import (sgd_state_from_jax,
                                           tp_sgd_state_from_jax)
from test_torch_sgd import CASES, _batch
from test_tp_sgd import _setup
from torch_tp_ranks import run_ranks, sgd_setup, sgd_ranks

MESHES = [(1, 2), (2, 2), (1, 4)]
NUM_ITER = 5
CLASS_ITER = 4  # test_tp_sgd_classification's epochs
RANKS_TIMEOUT = 240
EDGES = {"K=0": dict(num_factor=0), "k0k1_off": dict(k0=False, k1=False)}


def _jax_cfg(task: int = 0, **kw):
    """``test_tp_sgd.py:_setup``'s data and config, ``task`` 1 binarised
    as ``test_tp_sgd_classification`` does."""
    tr, te, D, meta, cfg = _setup(task=task)
    if task == 1:
        mid = 0.5 * (cfg.min_target + cfg.max_target)
        tr.target[:] = np.where(tr.target > mid, 1.0, -1.0)
        te.target[:] = np.where(te.target > mid, 1.0, -1.0)
        cfg = dataclasses.replace(cfg, min_target=-1.0, max_target=1.0)
    return tr, te, D, meta, dataclasses.replace(cfg, **kw)


def _jax_run(path: str, shape, num_iter: int, task: int = 0, **kw) -> dict:
    """The JAX learner on ``shape``: its initial w0, w, v and the
    permutations of ``num_iter`` epochs (its key chain replayed) saved as
    npz at ``path``; its history, final state and test scores."""
    tr, te, D, meta, cfg = _jax_cfg(task, **kw)
    lr = JTPSGD(cfg, JDataset.from_coo(tr, D), JDataset.from_coo(te, D),
                meta, mesh=jmesh2d(n_data=shape[0], n_feature=shape[1]),
                write_files=False)
    s0 = lr.init_state()
    n_loc = lr.train_row.ids.shape[0] // shape[0]
    key, perms = s0.key, []
    for _ in range(num_iter):
        key, sub = jax.random.split(key)
        perms.append([np.asarray(jax.random.permutation(
            jax.random.fold_in(sub, d), n_loc)) for d in range(shape[0])])
    np.savez(path, w0=np.asarray(s0.w0), w=np.asarray(s0.w),
             v=np.asarray(s0.v), perms=np.asarray(perms, np.int64))
    s, h = lr.run(s0, num_iter=num_iter, verbose=False)
    return dict(path=path, hist=h, w0=float(s.w0), w=np.asarray(s.w),
                v=np.asarray(s.v), scores=lr.predict_test_scores(s), D=D,
                num_batches=lr.num_batches)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX learner on each mesh; on (1, 2) also classification and the
    edge dims."""
    d = tmp_path_factory.mktemp("jax_tp_sgd")
    out = {s: _jax_run(str(d / f"init_{s[0]}x{s[1]}.npz"), s, NUM_ITER)
           for s in MESHES}
    out["class"] = _jax_run(str(d / "init_class.npz"), (1, 2), CLASS_ITER,
                            task=1)
    for name, kw in EDGES.items():
        out[name] = _jax_run(str(d / f"init_{name}.npz"), (1, 2), NUM_ITER,
                             **kw)
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs, tmp_path_factory):
    """Two ranks: (1, 2) from its JAX init, (2, 1) from (2, 2)'s (the
    permutations depend on Sd alone), classification and the edge dims on
    (1, 2); 4 uninterrupted epochs of the port's own init on (1, 2) and 2
    that save a checkpoint.  Four ranks: (2, 2) and (1, 4) from their
    inits, and the checkpoint resumed to 4 epochs on (1, 4)."""
    d = tmp_path_factory.mktemp("tp_sgd_ranks")
    ck = str(d / "ck")
    two = run_ranks(sgd_ranks, 2, d / "two", timeout=RANKS_TIMEOUT, runs=[
        ("1x2", (1, 2), {}, NUM_ITER, jax_runs[(1, 2)]["path"], "", 100),
        ("2x1", (2, 1), {}, NUM_ITER, jax_runs[(2, 2)]["path"], "", 100),
        ("class", (1, 2), dict(task=1), CLASS_ITER,
         jax_runs["class"]["path"], "", 100),
        *((name, (1, 2), kw, NUM_ITER, jax_runs[name]["path"], "", 100)
          for name, kw in EDGES.items()),
        ("full", (1, 2), {}, 4, "", "", 100),
        ("first", (1, 2), {}, 2, "", ck, 2)])
    four = run_ranks(sgd_ranks, 4, d / "four", timeout=RANKS_TIMEOUT, runs=[
        ("2x2", (2, 2), {}, NUM_ITER, jax_runs[(2, 2)]["path"], "", 100),
        ("1x4", (1, 4), {}, NUM_ITER, jax_runs[(1, 4)]["path"], "", 100),
        ("resumed", (1, 4), {}, 4, "", ck, 100)])
    return {k: [r[k] for r in res] for res in (two, four) for k in res[0]}


def _same_on_every_rank(res, key="rmse"):
    for r in res[1:]:
        assert [h[key] for h in r["hist"]] == [h[key] for h in res[0]["hist"]]
        np.testing.assert_array_equal(r["tab"], res[0]["tab"])


def _close_hist(ha, hb, key="rmse", rtol=2e-4, atol=2e-5):
    assert len(ha) == len(hb)
    for a, b in zip(ha, hb):
        np.testing.assert_allclose(a[key], b[key], rtol=rtol, atol=atol)


def _close_to_jax(res, ref, key="rmse"):
    D = ref["D"]
    _close_hist(res["hist"], ref["hist"], key)
    np.testing.assert_allclose(res["tab"][:D, 0], ref["w"][:D], rtol=5e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res["tab"][:D, 1:].T, ref["v"][:, :D],
                               rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(res["w0"], ref["w0"], rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(res["scores"], ref["scores"], rtol=5e-4,
                               atol=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_sgd_matches_jax_on_the_same_mesh(jax_runs, port_runs, shape):
    res = port_runs[f"{shape[0]}x{shape[1]}"]
    assert len(res) == shape[0] * shape[1]
    _same_on_every_rank(res)
    ref = jax_runs[shape]
    assert res[0]["num_batches"] == ref["num_batches"]
    assert res[0]["D_loc"] * shape[1] >= ref["D"]
    _close_to_jax(res[0], ref)


def test_tp_sgd_feature_count_leaves_the_trajectory(port_runs):
    """(2, 1) against (2, 2) from one state and the same permutations: the
    batches depend on the data shards alone."""
    a, b = port_runs["2x1"][0], port_runs["2x2"][0]
    _close_hist(a["hist"], b["hist"], rtol=1e-5, atol=1e-6)
    D = a["tab"].shape[0]
    np.testing.assert_allclose(a["tab"], b["tab"][:D], rtol=1e-5, atol=1e-6)


def test_tp_sgd_classification_matches_jax(jax_runs, port_runs):
    """``test_tp_sgd_classification``'s recipe on (1, 2): the logistic
    multiplier in T11, the accuracy eval; the tables and scores within the
    tolerances above, the accuracies equal."""
    res = port_runs["class"]
    _same_on_every_rank(res, "accuracy")
    _close_to_jax(res[0], jax_runs["class"], "accuracy")
    assert [h["accuracy"] for h in res[0]["hist"]] == [
        h["accuracy"] for h in jax_runs["class"]["hist"]]


@pytest.mark.parametrize("name", list(EDGES))
def test_tp_sgd_edge_dims_match_jax(jax_runs, port_runs, name):
    """K = 0 (T1's and T11's factor-free rows) and k0 / k1 off (T11 leaves
    lin and w0 out, X9b steps neither) on (1, 2)."""
    res = port_runs[name]
    _same_on_every_rank(res)
    _close_to_jax(res[0], jax_runs[name])


def test_tp_sgd_checkpoint_resumes_onto_another_feature_count(port_runs):
    """2 epochs on (1, 2) saved (the global table without padding and the
    draw source's generator), resumed to 4 on (1, 4): the uninterrupted 4
    epochs on (1, 2)."""
    full, first = port_runs["full"][0], port_runs["first"][0]
    resumed = port_runs["resumed"]
    _same_on_every_rank(resumed)
    assert len(first["hist"]) == 2 and len(resumed[0]["hist"]) == 2
    _close_hist(first["hist"] + resumed[0]["hist"], full["hist"])
    D = full["tab"].shape[0]
    np.testing.assert_allclose(resumed[0]["tab"][:D], full["tab"],
                               rtol=5e-4, atol=1e-5)


def test_tp_sgd_world_of_one_matches_resident(jax_runs):
    """A (1, 1) mesh (no process group) against the port's resident
    SGDLearner from the JAX init and one host generator's permutations:
    T1 + T11 + X9b dense in place of X9a + X9b, the same math."""
    cfg, tr, te, meta, D = sgd_setup()
    with np.load(jax_runs[(1, 2)]["path"]) as z:
        init = dict(z)
    tp = TPSGDLearner(cfg, tr, te, meta, mesh=make_mesh2d(device="cpu"))
    st, h = tp.run(tp_sgd_state_from_jax(init, "cpu", host_draws(3, "cpu"),
                                         d=0, f=0, D_loc=tp.D_loc),
                   num_iter=NUM_ITER, verbose=False)
    whole = dict(w0=init["w0"], w=init["w"][:D], v=init["v"][:, :D])
    res = ts.SGDLearner(cfg, tr, te, meta, device="cpu", write_files=False)
    rs, hr = res.run(sgd_state_from_jax(whole, "cpu", host_draws(3, "cpu")),
                     num_iter=NUM_ITER, verbose=False)
    _close_hist(h, hr, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.global_state(st).tab[:D].numpy(),
                               rs.tab.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.predict_test_scores(st),
                               res.predict_test_scores(rs), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", [c for c in CASES if "sgda" not in c])
def test_tp_sgd_one_minibatch_on_two_shards_matches_jax(case):
    """One minibatch on two feature shards: the twins of T1 (summed over
    the shards), T11 and X9b dense on each window, the windows
    concatenated, against JAX's ``sgd_minibatch_update`` on the whole
    table."""
    kw = dict(CASES[case])
    b = _batch(K=kw.pop("K", 4))
    D, K = b["D"], b["K"]
    if kw.get("task") == 1:
        b["y"] = np.where(b["y"] > 3, 1.0, -1.0).astype(np.float32)
        b["min_t"], b["max_t"] = -1.0, 1.0
    cfg_kw = dict(num_attributes=D, num_factor=K, min_target=b["min_t"],
                  max_target=b["max_t"], num_groups=2, learn_rate=0.05,
                  reg0=0.02, regw=0.01, regv=0.03, **kw)
    jcfg, tcfg = JConfig(**cfg_kw), FMConfig(**cfg_kw)
    rep = P()

    @jax.jit
    @partial(jax.shard_map, mesh=make_mesh(1), in_specs=(rep,) * 7,
             out_specs=(rep,) * 3)
    def jstep(w0, w, v, ids, vals, y, valid):
        w0, w, v, _, _ = js.sgd_minibatch_update(
            w0, w, v, ids, vals, y, valid, jcfg, jcfg.learn_rate, jcfg.reg0,
            jnp.full_like(w, jcfg.regw), jnp.full_like(v, jcfg.regv))
        return w0, w, v

    names = ("w0", "w", "v", "ids", "vals", "y", "valid")
    want = [np.asarray(a) for a in jstep(*(jnp.asarray(b[k])
                                           for k in names))]
    t = {k: torch.from_numpy(np.array(b[k])) for k in names}
    m = ts.sgd_step_mode(tcfg)
    D_loc = -(-D // 2)
    tab = torch.nn.functional.pad(ts.table(t["w"], t["v"]),
                                  (0, 0, 0, 2 * D_loc - D))
    shards = [tab[f * D_loc:(f + 1) * D_loc].clone() for f in (0, 1)]
    part = sum(k1.tp_fm_partials_plain(sh, K, False, t["ids"], t["vals"],
                                       f * D_loc, D_loc)
               for f, sh in enumerate(shards))
    w0s = []
    for f, sh in enumerate(shards):
        w0 = t["w0"].clone()
        acc = torch.zeros(D_loc, 2 + K)
        acc0 = torch.zeros(2)
        ks.tp_sgd_scatter(sh, w0, t["ids"], t["vals"], t["y"], t["valid"],
                          part, f * D_loc, acc, acc0, m)
        ks.sgd_apply_dense(sh, w0, acc, acc0, m)
        assert not acc.any() and not acc0.any()
        w0s.append(float(w0))
    got = torch.cat(shards)[:D]
    assert w0s[0] == w0s[1]
    np.testing.assert_allclose(w0s[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, 0].numpy(), want[1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[:, 1:].T.numpy(), want[2], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("loss", ["regression", "exp", "classification",
                                  "poisson"])
def test_tp_sgd_scatter_at_one_shard_is_x9a(loss):
    """At one feature shard (the window the whole table) T11's twin adds
    what X9a's twin adds, from T1's partials of the whole table; an id
    outside a window adds nothing (Sf = 2: the two windows' accumulators
    are the whole one's halves)."""
    b = _batch(K=5)
    D, K = b["D"], b["K"]
    task = {"classification": 1, "poisson": 2}.get(loss, 0)
    y = np.where(b["y"] > 3, 1.0, -1.0) if task == 1 else b["y"]
    cfg = FMConfig(num_attributes=D, num_factor=K, min_target=b["min_t"],
                   max_target=b["max_t"], task=task, learn_rate=0.05,
                   exp_family=loss == "exp", stdev=1.3)
    m = ts.sgd_step_mode(cfg)
    t = {k: torch.from_numpy(np.array(b[k])) for k in
         ("w0", "w", "v", "ids", "vals", "valid")}
    y = torch.from_numpy(np.asarray(y, np.float32))
    tab = ts.table(t["w"], t["v"])
    ws = ks.make_workspace(D, K, "cpu")
    ks.sgd_grad_scatter_plain(tab, t["w0"], t["ids"], t["vals"], y,
                              t["valid"], ws.acc, ws.acc0, ws.owner, m)
    part = k1.tp_fm_partials_plain(tab, K, False, t["ids"], t["vals"], 0, D)
    acc, acc0 = torch.zeros(D, 2 + K), torch.zeros(2)
    ks.tp_sgd_scatter(tab, t["w0"], t["ids"], t["vals"], y, t["valid"], part,
                      0, acc, acc0, m)
    torch.testing.assert_close(acc, ws.acc, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(acc0, ws.acc0, rtol=1e-5, atol=1e-6)
    half = -(-D // 2)
    for f in (0, 1):
        a = torch.zeros(half, 2 + K)
        sh = torch.nn.functional.pad(tab, (0, 0, 0, 2 * half - D))[
            f * half:(f + 1) * half]
        ks.tp_sgd_scatter(sh, t["w0"], t["ids"], t["vals"], y, t["valid"],
                          part, f * half, a, torch.zeros(2), m)
        torch.testing.assert_close(a[:D - f * half], acc[f * half:][:half],
                                   rtol=1e-6, atol=1e-7)


def test_tp_sgd_state_from_jax_cuts_the_shard():
    """``tp_sgd_state_from_jax`` takes the rank's feature slice of w and v
    as its table and w0 whole, the same on every data shard."""
    rng = np.random.default_rng(0)
    K, D_pad = 3, 8
    g = dict(w0=np.float32(0.7),
             w=rng.standard_normal(D_pad).astype(np.float32),
             v=rng.standard_normal((K, D_pad)).astype(np.float32))
    for d in (0, 1):
        s = tp_sgd_state_from_jax(g, "cpu", None, d=d, f=1, D_loc=4)
        assert torch.equal(s.w, torch.from_numpy(g["w"][4:8]))
        assert torch.equal(s.v, torch.from_numpy(g["v"][:, 4:8]))
        assert float(s.w0) == float(g["w0"]) and s.tab.is_contiguous()


def test_permutation_of_a_data_shard_keeps_the_chain_in_step():
    """``Draws.permutation(n, shard, n_shards)`` draws every shard's
    permutation and keeps its own: the ranks' generators stay in step, and
    one shard of one is the plain permutation."""
    a, b = (Draws(torch.Generator().manual_seed(5), "cpu") for _ in (0, 1))
    p0, p1 = a.permutation(10, 0, 2), b.permutation(10, 1, 2)
    assert sorted(p0.tolist()) == sorted(p1.tolist()) == list(range(10))
    assert not torch.equal(p0, p1)
    assert torch.equal(a.permutation(7), b.permutation(7))
    c, e = (Draws(torch.Generator().manual_seed(5), "cpu") for _ in (0, 1))
    assert torch.equal(c.permutation(10, 0, 1), e.permutation(10))

