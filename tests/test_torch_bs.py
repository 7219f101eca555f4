"""Native relational block structure (BS) in the port: ``data/relation.py``
array for array against ``svbfm_tpu.data.relation``; the CPU twins of
X10a-X10d inside ``learners/mcmc_bs.py`` against the JAX package's
``MCMCBSLearner``/``ALSBSLearner`` (test_bs.py:_setup sizes), both packages
started from the JAX learner's init (``mcmc_state_from_jax``: a BS state is
an ``MCMCState`` over the joined attributes); against the float64
``BinOrderALSOracle``/``BSBlockedALSOracle``; and against the port's own
``ALSLearner`` on the materialised join.  Gibbs replays the JAX key chain
(``JaxKeyDraws``), so a sweep that drew in another order or shape would
leave the two chains apart, which the tests check.

Tolerances, with their reasons:
  * sweeps against JAX: rtol 1e-4 / atol 1e-5 on w0, w, v and e (the
    issue's bound; float32 sums of the relation aggregates taken in another
    order), rtol 1e-5 / atol 1e-6 on alpha and the hyperparameters;
    counters equal;
  * scores against JAX: rtol 1e-5 / atol 1e-6 (one float32 sum per row in
    another order);
  * against the float64 oracles and the materialised join: test_bs.py's own.
"""

import dataclasses
import struct

import jax
import numpy as np
import pytest
import torch

from svbfm_tpu.data import relation as jrel
from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.dataset import SweepPlan as JSweepPlan
from svbfm_tpu.data.libfm_text import COOData as JCOO
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.learners import mcmc_bs as jbs
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data import relation as trel
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.libfm_text import COOData
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.synth import make_bs_problem
from svbfm_tpu_torch.learners import mcmc as tm
from svbfm_tpu_torch.learners import mcmc_bs as tbs
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.utils.convert import mcmc_state_from_jax

from oracle import BinOrderALSOracle, BSBlockedALSOracle
from test_torch_mcmc import HYPER, PARAMS, JaxKeyDraws

# ---------------------------------------------------------------------------
# The problem: test_bs.py:_setup, optionally with the users in a relation too
# ---------------------------------------------------------------------------


def _rel_arrays(n_rows, wide):
    """One-hot id + ``wide - 1`` two-column attribute slots per row."""
    per = [np.arange(n_rows, dtype=np.int32)]
    cols = [np.arange(n_rows, dtype=np.int32)]
    vals = [np.ones(n_rows, np.float32)]
    for wi in range(wide - 1):
        per.append(np.arange(n_rows, dtype=np.int32))
        cols.append(n_rows + wi * 2 + (np.arange(n_rows, dtype=np.int32) % 2))
        vals.append(np.full(n_rows, 0.5 + 0.5 * wi, np.float32))
    order = np.argsort(np.concatenate(per), kind="stable")
    return dict(row=np.concatenate(per)[order],
                col=np.concatenate(cols)[order],
                val=np.concatenate(vals)[order], num_rows=n_rows,
                num_features=n_rows + 2 * (wide - 1))


def _problem(n=240, n_users=9, n_items=5, seed=0, wide=2, users_rel=False,
             n_extra=0):
    """Numpy pieces: the main block (user one-hots, or empty when the users
    are a relation of their own), the relations and their joins.
    ``n_extra`` more categorical relations (one-hot ids of 2-5 rows), each
    with its own join, follow the items."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    y = (2.0 + 0.3 * users - 0.2 * items
         + 0.4 * rng.standard_normal(n)).astype(np.float32)
    rels = [_rel_arrays(n_items, wide)]
    joins = [items]
    if users_rel:
        main = dict(row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
                    val=np.zeros(0, np.float32), target=y, num_rows=n,
                    num_features=0)
        rels = [_rel_arrays(n_users, 2)] + rels
        joins = [users] + joins
    else:
        main = dict(row=np.arange(n, dtype=np.int32),
                    col=users.astype(np.int32), val=np.ones(n, np.float32),
                    target=y, num_rows=n, num_features=n_users)
    for r in range(n_extra):
        size = 2 + r % 4
        j = rng.integers(0, size, n)
        rels.append(_rel_arrays(size, 1))
        joins.append(j)
        y += (0.1 * (r % 3 - 1) * j).astype(np.float32)
    return main, rels, joins, y


def _build(pkg, main, rels, joins, K, **cfg_kw):
    """(cfg, train dataset, relations, joined meta, d_main) in one package."""
    coo_cls, meta_cls, rel_mod, ds_cls, cfg_cls = pkg
    coo = coo_cls(**main)
    rel_objs = [rel_mod.RelationData(meta=meta_cls(r["num_features"]), **r)
                for r in rels]
    d_main = main["num_features"]
    meta = rel_mod.build_joined_meta(meta_cls(d_main), rel_objs)
    y = main["target"]
    cfg = cfg_cls(num_attributes=meta.num_attributes, num_factor=K,
                  num_groups=meta.num_attr_groups, min_target=float(y.min()),
                  max_target=float(y.max()), regw=0.05, regv=0.05, seed=3,
                  **cfg_kw)
    return cfg, ds_cls.from_coo(coo, meta.num_attributes), rel_objs, meta, \
        d_main


JPKG = (JCOO, JMeta, jrel, JDataset, JConfig)
TPKG = (COOData, DataMetaInfo, trel, SparseDataset, FMConfig)


def _pair(als, K=3, factor_block=0, n=240, **prob_kw):
    """The JAX learner and the port's on the same problem; train = test."""
    main, rels, joins, _ = _problem(n=n, **prob_kw)
    out = []
    for pkg, jax_side in ((JPKG, True), (TPKG, False)):
        cfg, ds, robjs, meta, d_main = _build(pkg, main, rels, joins, K,
                                              factor_block=factor_block)
        if jax_side:
            cls = jbs.ALSBSLearner if als else jbs.MCMCBSLearner
            out.append(cls(cfg, ds, ds, robjs, joins, joins, meta, d_main,
                           mesh=make_mesh(1), write_files=False))
        else:
            cls = tbs.ALSBSLearner if als else tbs.MCMCBSLearner
            out.append(cls(cfg, ds, ds, robjs, joins, joins, meta, d_main,
                           device="cpu", write_files=False))
    return out


def _start(jl):
    js = jl.init_state()
    return js, mcmc_state_from_jax(jax.device_get(js), "cpu",
                                   JaxKeyDraws(js.key))


# ---------------------------------------------------------------------------
# data/relation.py
# ---------------------------------------------------------------------------


def _write_relation(d, name, arrs, groups):
    rows = [[] for _ in range(arrs["num_rows"])]
    for r, c, v in zip(arrs["row"], arrs["col"], arrs["val"]):
        rows[r].append(f"{c}:{v:g}")
    (d / name).write_text("".join("0 " + " ".join(e) + "\n" for e in rows))
    (d / (name + ".groups")).write_text("".join(f"{g}\n" for g in groups))
    return str(d / name)


def _assert_same(a, b):
    for k in ("row", "col", "val", "target"):
        if hasattr(a, k):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)
    for k in ("num_rows", "num_features", "attr_offset"):
        if hasattr(a, k):
            assert getattr(a, k) == getattr(b, k), k


def test_relation_load_and_join_match_jax(tmp_path):
    """RelationData.load (text + .groups), build_joined_meta and
    join_relations give the JAX package's arrays."""
    main, rels, joins, _ = _problem(users_rel=False, wide=3)
    groups = np.r_[np.zeros(5, int), np.ones(4, int)]
    path = _write_relation(tmp_path, "items.libfm", rels[0], groups)
    tr, jr = trel.RelationData.load(path), jrel.RelationData.load(path)
    _assert_same(tr, jr)
    np.testing.assert_array_equal(tr.meta.attr_group, jr.meta.attr_group)
    tmeta = trel.build_joined_meta(DataMetaInfo(9), [tr])
    jmeta = jrel.build_joined_meta(JMeta(9), [jr])
    np.testing.assert_array_equal(tmeta.attr_group, jmeta.attr_group)
    assert tmeta.num_attr_groups == jmeta.num_attr_groups == 3
    _assert_same(tr, jr)  # attr_offset
    tj = trel.join_relations(COOData(**main), [tr], joins, 9)
    jj = jrel.join_relations(JCOO(**main), [jr], joins, 9)
    _assert_same(tj, jj)
    assert tj.row.dtype == jj.row.dtype and tj.val.dtype == jj.val.dtype


@pytest.mark.parametrize("form", ["text", "dvector"])
def test_load_join_matches_jax(tmp_path, form):
    idx = np.random.default_rng(0).integers(0, 50, 37)
    f = tmp_path / "rel.train"
    if form == "text":
        f.write_text("".join(f"{i}\n" for i in idx))
    else:  # the reference's DVector<uint>: file id, value size, count, data
        f.write_bytes(struct.pack("<III", trel.DVECTOR_FILE_ID, 4, len(idx))
                      + idx.astype("<u4").tobytes())
    got = trel.load_join(str(f), len(idx))
    want = jrel.load_join(str(f), len(idx))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int64
    with pytest.raises(ValueError, match="join entries"):
        trel.load_join(str(f), len(idx) + 1)


def test_binary_relation_is_refused(tmp_path):
    """A relation's binary prefix.x is read as the JAX package reads it
    (tests/test_torch_binary.py holds the arrays to JAX's), in place of
    the text beside it."""
    from svbfm_tpu_torch.data.binary import save_sparse_binary

    row = np.array([0, 0, 2], np.int32)
    col = np.array([3, 1, 0], np.int32)
    val = np.array([1.0, 0.5, 2.0], np.float32)
    save_sparse_binary(str(tmp_path / "rel.x"), row, col, val, 3, 5)
    (tmp_path / "rel").write_text("not libFM text\n")
    got = trel.RelationData.load(str(tmp_path / "rel"))
    want = jrel.RelationData.load(str(tmp_path / "rel"))
    assert (got.num_rows, got.num_features) == (3, 5)
    for k in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_make_bs_problem_shape():
    """The card's recipe (scripts/bench_bs.py:make_bs_problem), at 2000
    rows: an empty main block, two relations of 1 + ua / 1 + ia entries a
    row, and 42 joined entries a data row at ua = ia = 20."""
    main, ru, ri, users, items, y = make_bs_problem(2000, 20, 20)
    assert main.num_features == 0 and main.num_rows == 2000 == len(y)
    assert (ru.num_rows, ri.num_rows) == (71567, 10681)
    assert len(ru.row) == 21 * ru.num_rows and len(ri.row) == 21 * ri.num_rows
    assert users.max() < ru.num_rows and items.max() < ri.num_rows
    meta = trel.build_joined_meta(DataMetaInfo(0), [ru, ri])
    joined = trel.join_relations(main, [ru, ri], [users, items], 0)
    assert len(joined.row) == 42 * 2000
    assert meta.num_attributes == ru.num_features + ri.num_features


# ---------------------------------------------------------------------------
# X10d: the scores
# ---------------------------------------------------------------------------

# nine relations: the scores kernel takes any number
NINE = dict(n_extra=8)
SCORE_CASES = {
    "wide=2": dict(wide=2),
    "wide=6": dict(wide=6),
    "empty main, two relations": dict(wide=3, users_rel=True),
    "empty main, nine relations": dict(wide=3, users_rel=True, n_extra=7),
}


@pytest.mark.parametrize("case", list(SCORE_CASES))
def test_bs_scores_match_jax(case):
    jl, tl = _pair(True, K=3, **SCORE_CASES[case])
    rng = np.random.default_rng(4)
    D = tl.cfg.num_attributes
    w0 = np.float32(0.3)
    w = rng.standard_normal(D).astype(np.float32)
    v = rng.standard_normal((3, D)).astype(np.float32)
    joins = tuple(rd.join_tr for rd in jl.rels)
    want = np.asarray(jl._bs_scores_tr(w0, w, v, jl.train_row.ids,
                                       jl.train_row.vals, jl.rels, joins))
    got = tl.bs_scores(torch.tensor(w0), torch.from_numpy(w),
                       torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want[: tl.train_n], rtol=1e-5,
                               atol=1e-6)
    # and against the materialised join's plain FM scores
    from svbfm_tpu_torch.ops.forward import fm_scores
    main, rels, joins_np, _ = _problem(**SCORE_CASES[case])
    _, _, robjs, meta, d_main = _build(TPKG, main, rels, joins_np, 3)
    jn = trel.join_relations(COOData(**main), robjs, joins_np, d_main)
    ds = SparseDataset.from_coo(jn, meta.num_attributes)
    flat = fm_scores(torch.tensor(w0), torch.from_numpy(w),
                     torch.from_numpy(v), torch.from_numpy(ds.ids),
                     torch.from_numpy(ds.vals))
    np.testing.assert_allclose(got.numpy(), flat.numpy()[: tl.train_n],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Sweeps against JAX
# ---------------------------------------------------------------------------


def _assert_state_close(js, jnans, ts, tnans, n):
    for k in PARAMS + HYPER:
        got, ref = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
        if k == "e":
            ref = ref[:n]
        tol = dict(rtol=1e-4, atol=1e-5) if k in PARAMS else dict(
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, ref, err_msg=k, **tol)
    assert {k: int(v) for k, v in tnans.items()} == {
        k: int(v) for k, v in jnans.items()}
    np.testing.assert_array_equal(np.asarray(ts.draws.key),
                                  np.asarray(js.key))


def _sweeps_match(jl, tl, n_sweeps):
    js, ts = _start(jl)
    np.testing.assert_allclose(
        tl.bs_scores(ts.w0, ts.w, ts.v).numpy() - tl.train_row.target.numpy(),
        np.asarray(js.e)[: tl.train_n], rtol=1e-5, atol=1e-5)
    for _ in range(n_sweeps):
        js, jnans = jl._step(js, jl.train_row, jl.plan_data, jl.rels)
        ts, tnans = tl.step(ts)
        _assert_state_close(js, jnans, ts, tnans, tl.train_n)


BS_CASES = {
    "factor_block=1": dict(factor_block=1),
    "factor_block=K": dict(factor_block=0),
    # F = 34: past the warp form's F <= 32, X10a's block form on the card
    "factor_block=K, K=34": dict(factor_block=0, K=34),
    "two relations, empty main, factor_block=K": dict(factor_block=0,
                                                      users_rel=True),
    "nine relations, factor_block=K": dict(factor_block=0, **NINE),
}


@pytest.mark.parametrize("case", list(BS_CASES))
def test_bs_als_sweeps_match_jax(case):
    jl, tl = _pair(True, **BS_CASES[case])
    fb, K = BS_CASES[case]["factor_block"], BS_CASES[case].get("K", 3)
    assert tl.factor_width == (1 if fb == 1 else K) == (
        jl.cfg.factor_block if fb else K)
    _sweeps_match(jl, tl, 3)


@pytest.mark.parametrize("case", list(BS_CASES))
def test_bs_gibbs_sweeps_match_jax_with_replayed_draws(case):
    jl, tl = _pair(False, n=400, **BS_CASES[case])
    _sweeps_match(jl, tl, 2)


# ---------------------------------------------------------------------------
# Against the float64 oracles and the materialised join
# ---------------------------------------------------------------------------


def _joined(tl, main, rels, joins):
    _, _, robjs, meta, d_main = _build(TPKG, main, rels, joins, 3)
    return trel.join_relations(COOData(**main), robjs, joins, d_main), d_main


def _rel_color(rel):
    coo = JCOO(target=np.zeros(rel["num_rows"], np.float32), **rel)
    return JSweepPlan.build(coo, rel["num_features"], bins="auto",
                            n_shards=1).color


@pytest.mark.parametrize("factor_block", [1, 0])
def test_bs_als_matches_float64_oracle(factor_block):
    """factor_block=1: BinOrderALSOracle over the combined colouring (main
    bins, then the relation's); factor_block=K: BSBlockedALSOracle
    (test_bs.py:85-127, 189-234)."""
    main, rels, joins, _ = _problem()
    _, tl = _pair(True, factor_block=factor_block)
    joined, d_main = _joined(tl, main, rels, joins)
    D, K = tl.cfg.num_attributes, tl.cfg.num_factor
    rcolor = _rel_color(rels[0])
    common = (joined.row, joined.col, joined.val, joined.target, D, K)
    kw = dict(groups=tl.meta.attr_group, regw=0.05, regv=0.05)
    if factor_block == 1:
        color = np.zeros(D, np.int32)
        color[:d_main] = tl.plan.color[:d_main]
        color[d_main:] = rcolor + tl.plan.num_bins
        orc = BinOrderALSOracle(*common, color=color, factor_block=1, **kw)
    else:
        main_bins = [np.flatnonzero(tl.plan.color[:d_main] == b)
                     for b in range(tl.plan.num_bins)]
        rel_bins = [[d_main + np.flatnonzero(rcolor == b)
                     for b in range(int(rcolor.max()) + 1)]]
        orc = BSBlockedALSOracle(*common, main_bins=main_bins,
                                 rel_bins=rel_bins, factor_block=K, **kw)
    ts = tl.init_state()
    orc.init(float(ts.w0), ts.w.numpy(), ts.v.numpy())
    for _ in range(3):
        ts, _nans = tl.step(ts)
        orc.iterate()
        np.testing.assert_allclose(float(ts.w0), orc.w0, rtol=2e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(ts.w.numpy(), orc.w, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(ts.v.numpy(), orc.v, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(ts.e.numpy(), orc.e, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("prob", [{}, NINE], ids=["one relation",
                                                 "nine relations"])
def test_bs_als_matches_materialised_join(prob):
    """The port's BS ALS reproduces the port's ALSLearner on the
    materialised join (test_bs.py:60-82): same coordinate order at
    factor_block = 1, same conditionals."""
    main, rels, joins, _ = _problem(**prob)
    _, tl = _pair(True, factor_block=1, **prob)
    s_bs, h_bs = tl.run(num_iter=4, verbose=False)
    joined, _ = _joined(tl, main, rels, joins)
    D = tl.cfg.num_attributes
    trj = SparseDataset.from_coo(joined, D)
    mat = tm.ALSLearner(tl.cfg, trj, trj, tl.meta, device="cpu",
                        write_files=False)
    s_m, h_m = mat.run(num_iter=4, verbose=False)
    for hb, hm in zip(h_bs, h_m):
        assert abs(hb["rmse"] - hm["rmse"]) < 1e-5
    np.testing.assert_allclose(s_bs.w.numpy(), s_m.w.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(s_bs.v.numpy(), s_m.v.numpy(), rtol=2e-3,
                               atol=2e-4)


@pytest.mark.parametrize("factor_block", [1, 3])
def test_bs_nan_counters_zero(factor_block):
    """Both factor paths surface the counters, all zero on a healthy run
    (test_bs.py:255-271), and the posterior-mean RMSE falls."""
    _, tl = _pair(False, factor_block=factor_block)
    _, hist = tl.run(num_iter=3, verbose=False)
    for rec in hist:
        for fam in tm.NAN_FAMILIES:
            assert rec[f"nan_{fam}"] == rec[f"inf_{fam}"] == 0
    assert np.isfinite(hist[-1]["rmse"])


def test_bs_never_materialises_the_join():
    """The main row layout stays one entry a row though the joined design
    has seven (test_bs.py:154-171)."""
    _, tl = _pair(True, wide=6)
    assert tl.train_row.ids.shape[1] == 1
    assert tuple(tl.rels[0].rrow_ids.shape) == (5, 6)
    _, h = tl.run(num_iter=2, verbose=False)
    assert np.isfinite(h[-1]["rmse_this"])


def test_bs_factor_width():
    cfg = FMConfig(num_attributes=5, num_factor=20)
    widths = [tbs.bs_factor_width(dataclasses.replace(cfg, factor_block=fb))
              for fb in (0, 1, 4, 30)]
    assert widths == [20, 1, 4, 20]
    # past what X10b's shared memory holds, the widest divisor that fits
    big = tbs.bs_factor_width(dataclasses.replace(cfg, num_factor=300))
    assert big == 150 and tbs.rel_draw_fits(150)
    assert not tbs.rel_draw_fits(300)


def test_classification_is_refused():
    """Classification through block structure is no longer refused: 2 BS
    Gibbs iterations on the +-1 targets (test_bs.py:174's binarisation at
    the median) held to svbfm_tpu with the replayed key chain, the
    re-predict leaving e = yhat for the latent draw (mcmc_bs.py:722, :839);
    the Poisson task, which the probit learners do not read, is refused."""
    main, rels, joins, y = _problem(n=400)
    main["target"] = np.where(y > np.median(y), 1.0, -1.0).astype(np.float32)
    out = []
    for pkg, jax_side in ((JPKG, True), (TPKG, False)):
        cfg, ds, robjs, meta, d_main = _build(pkg, main, rels, joins, 3,
                                              task=1)
        if jax_side:
            out.append(jbs.MCMCBSLearner(cfg, ds, ds, robjs, joins, joins,
                                         meta, d_main, mesh=make_mesh(1),
                                         write_files=False))
        else:
            out.append(tbs.MCMCBSLearner(cfg, ds, ds, robjs, joins, joins,
                                         meta, d_main, device="cpu",
                                         write_files=False))
    jl, tl = out
    assert tl.cfg.min_target == -1.0 and tl.cfg.max_target == 1.0
    js, ts = _start(jl)
    jend, jh = jl.run(js, num_iter=2, verbose=False)
    tend, th = tl.run(ts, num_iter=2, verbose=False)
    np.testing.assert_array_equal(np.asarray(tend.draws.key),
                                  np.asarray(jend.key))
    for k in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(tend, k).numpy(),
                                   np.asarray(getattr(jend, k)), rtol=1e-4,
                                   atol=5e-5, err_msg=k)
    np.testing.assert_allclose(tend.e.numpy(),
                               np.asarray(jend.e)[: tl.train_n], rtol=1e-4,
                               atol=2e-3)
    for a, b in zip(jh, th):
        assert abs(b["accuracy"] - a["accuracy"]) * tl.test_n < 1.5
        np.testing.assert_allclose(b["loglik"], a["loglik"], rtol=2e-3)
    np.testing.assert_allclose(tl.final_test_predictions(tend),
                               jl.final_test_predictions(jend), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(NotImplementedError, match="item 15"):
        tbs.MCMCBSLearner(dataclasses.replace(tl.cfg, task=2), ds, ds, robjs,
                          joins, joins, meta, d_main, device="cpu",
                          write_files=False)


def test_ragged_bs_case_twins_on_cpu():
    """chip_smoke.py's ragged relational case, which holds X10a-X10d against
    their twins on the card, exercises what it claims: the Inf noise number
    is counted once a factor (then reverted), the NaN-lambda column comes
    out 0 uncounted, the one-hot bucket is also drawn at L = 1, and every
    kernel has cases at F = 20, 5, 1 and the w sweep."""
    import chip_smoke

    s = chip_smoke.ragged_bs_tensors("cpu")
    cases = chip_smoke.make_cases(s)
    for name in chip_smoke.BS_KERNELS:
        assert cases[name], name
    widths = {label.split()[2] for label, *_ in cases["bs_rel_draw"]}
    assert widths == {"F=20", "F=5", "F=1"}
    assert any(",1]" in label for label, *_ in cases["bs_rel_draw"])
    r = s["bs"][0]
    for label, prepare, call, _ in cases["bs_rel_draw"] + cases[
            "bs_rel_w_draw"]:
        ptab, vt, nans = call("plain", prepare())
        F = 1 if "F=0" in label else int(label.split()[2][2:])
        first = label.split()[3:5] == ["bin", "0"] and "+z" in label
        assert nans.tolist() == ([0, F] if first else [0, 0]), label
        assert torch.isfinite(vt).all()
    # the bucket with the NaN-lambda group: its first column comes out 0
    from svbfm_tpu_torch.kernels import bs_sweep as ks
    F, w = r["widths"][0]
    _, b = w["picks"][-2]
    ptab, vt = w["ptab"].clone(), w["vt"].clone()
    nans = torch.zeros(2, dtype=torch.int32)
    ks.bs_rel_draw_plain(b.rows, b.x, b.cols, b.group, w["rtab"], F, ptab,
                         vt, w["mu"], w["lam"], r["alpha"], w["z"], nans)
    assert (vt[b.cols[0].long()] == 0).all() and nans.tolist() == [0, 0]
    assert (vt[b.cols[1].long()] != 0).all()


def test_pointer_table_holds_the_pointers_once():
    """bs_scores' device arrays of pointers (build.device_table): the
    tensors' data_ptr()s in order, built once per set of pointers and found
    again, the oldest table dropped past the cache's size."""
    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.kernels import bs_forward as kf

    cpu = torch.device("cpu")
    ts = [torch.zeros(3 + k) for k in range(9)]
    a = kf.pointer_table(ts, cpu)
    assert a.dtype == torch.int64
    assert a.tolist() == [t.data_ptr() for t in ts]
    assert kf.pointer_table(ts, cpu) is a
    assert kf.pointer_table([], cpu).tolist() == [0]
    for k in range(build._TABLES_KEPT + 1):
        build.device_table((-1, k), cpu)
    assert len(build._tables) == build._TABLES_KEPT
    assert kf.pointer_table(ts, cpu) is not a


@pytest.mark.parametrize("L,G", [(1, 1), (2, 2), (7, 8), (8, 8), (9, 16),
                                 (32, 32), (33, 32), (300, 32)])
def test_narrow_lanes_is_the_cu_formula(L, G):
    """X10a's lanes a relation row at F <= 1, as csrc/bs_sweep.cu documents
    them: the next power of two >= L, at most 32."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    assert ks.narrow_lanes(L) == G == min(32, 1 << max(L - 1, 0).bit_length())


def test_join_plan_rows_lay_the_buckets_end_to_end():
    """X10a's plan table: a row a bucket (pointers, C, L, G, first), the
    buckets end to end: ceil(C G / 256) blocks a bucket at F <= 1, C
    relation rows at F >= 2 (G = 32, unread; a persistent grid of warps
    at F <= 32, of blocks past it, walks them), an empty bucket taking
    none; and the blocks or rows in all."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    bs = [tbs.JoinBlock(rows=torch.zeros(C, L, dtype=torch.int32),
                        x=torch.zeros(C, L), cols=torch.zeros(C,
                                                              dtype=torch.int32))
          for C, L in ((100, 8), (0, 16), (50, 33), (3, 300))]
    rows, blocks = ks.join_plan_rows(bs, 1)
    assert [r[3:] for r in rows] == [(100, 8, 8, 0), (0, 16, 16, 4),
                                     (50, 33, 32, 4), (3, 300, 32, 11)]
    assert blocks == 12 and rows[0][:3] == (
        bs[0].rows.data_ptr(), bs[0].x.data_ptr(), bs[0].cols.data_ptr())
    rows, blocks = ks.join_plan_rows(bs, 20)
    assert [r[5:] for r in rows] == [(32, 0), (32, 100), (32, 100),
                                     (32, 150)]
    assert blocks == 153
    rows, blocks = ks.join_plan_rows(bs, 33)
    assert [r[5:] for r in rows] == [(32, 0), (32, 100), (32, 100),
                                     (32, 150)]
    assert blocks == 153


def _join_plan_walk(rows, total, F, ngrid=None):
    """Emulate X10a's launch over a plan table (csrc/bs_sweep.cu), each
    form with its own mapping: narrow, each block finds its bucket
    (find_bucket) and its threads their relation rows; warp and block,
    ``ngrid`` warps or blocks of a persistent grid walk the rows laid end
    to end (AggBuckets), unit w rows w, w + ngrid, ..., each in rounds of
    32 slots.  Returns {(bucket, row): [slots read]}."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    form = ks.join_form(F)
    seen = {}
    if form in ("warp", "block"):
        for w in range(ngrid):
            for g in range(w, total, ngrid):
                b = max(i for i, r in enumerate(rows)
                        if r[6] <= g and r[3] > 0)
                _, _, _, C, L, G, first = rows[b]
                assert G == 32 and first <= g < first + C
                for l0 in range(0, max(L, 1), 32):
                    seen.setdefault((b, g - first), []).extend(
                        range(l0, min(l0 + 32, L)))
        return seen
    for blk in range(total):
        b = 0
        while b + 1 < len(rows) and rows[b + 1][6] <= blk:
            b += 1
        _, _, _, C, L, G, first = rows[b]
        for tid in range(256):  # G lanes a row, 256 threads a block
            c = ((blk - first) * 256 + tid) // G
            if c < C:
                seen.setdefault((b, c), []).extend(range(tid % G, L, G))
    return seen


@pytest.mark.parametrize("F", [0, 1, 2, 5, 20, 32, 33, 64, 251])
def test_join_plan_covers_every_relation_row_once(F):
    """X10a's plan in each form reaches every relation row of every
    bucket (empty buckets among them, L = 1-4,096) once and reads each of
    its slots exactly once; in the warp and block forms whatever the
    persistent grid's size (1, 3 and 1,000 warps or blocks: one walking
    many rows across buckets, or fewer rows than the grid)."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    shapes = ((0, 8), (37, 1), (100, 8), (0, 16), (50, 33), (9, 128),
              (7, 129), (3, 300), (5, 1000), (2, 4096), (0, 64))
    bs = [tbs.JoinBlock(rows=torch.zeros(C, L, dtype=torch.int32),
                        x=torch.zeros(C, L),
                        cols=torch.zeros(C, dtype=torch.int32))
          for C, L in shapes]
    rows, total = ks.join_plan_rows(bs, F)
    grids = (None,) if ks.join_form(F) == "narrow" else (1, 3, 1000)
    for ngrid in grids:
        seen = _join_plan_walk(rows, total, F, ngrid)
        assert sorted(seen) == [(b, c) for b, (C, _) in enumerate(shapes)
                                for c in range(C)]
        for (b, c), slots in seen.items():
            assert sorted(slots) == list(range(shapes[b][1])), (b, c)


@pytest.mark.parametrize("F,kU,threads", [
    (33, 1, 32), (36, 1, 32), (37, 1, 64), (64, 1, 96), (128, 1, 320),
    (172, 1, 512), (173, 2, 288), (212, 2, 384), (213, 3, 288),
    (251, 3, 352), (260, 3, 384), (261, 3, 0)])
def test_join_block_plan_owns_every_gram_tile(F, kU, threads):
    """X10a's block form past F = 32 (csrc/bs_sweep.cu:join_block_plan):
    the kB (kB + 2) / 4 units (row blocks 2p, 2p + 1 over a column block
    bj >= 2p) of the Gram upper triangle of t = (e | 1 | 0 | 0 | qO),
    kB = join_stride(F) / 4, the fewest of 1, 2, 3 a thread with which they
    fit a block (512 threads at 1, 384 at 2 or 3), in whole warps; the
    units hold
    every tile of the triangle once; the block's rounds fit its shared
    memory in both layouts at every width the learners admit, so they keep
    F up to 251 (0 threads past F = 260)."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks
    from svbfm_tpu_torch.kernels.mcmc_sweep import MAX_BLOCK_SMEM

    p = ks.join_block_plan(F)
    assert (p.kU, p.threads) == (kU, threads)
    kS = ks.join_stride(F)
    kB = kS // 4
    assert kS % 8 == 0 and F + 4 <= kS < F + 12
    units = _block_units(kB)
    assert len(units) == kB * (kB + 2) // 4
    tiles = [t for bp, bj in units for t in ((bp, bj), (bp + 1, bj))
             if t[0] <= t[1]]
    assert sorted(tiles) == [(i, j) for i in range(kB) for j in range(i, kB)]
    if threads:
        assert threads % 32 == 0 and kU * threads >= len(units)
        assert kU * (threads - 32) < len(units)
        assert ks.join_fits(F) and ks.join_agg_smem(F) <= MAX_BLOCK_SMEM
        assert ks.join_agg_smem(F) == max(ks.join_block_smem(F, raw, 16)
                                          for raw in (False, True))
    else:
        assert not ks.join_fits(F)
    assert all(ks.join_fits(F2) for F2 in range(2, ks.MAX_REL_F + 1))


def _block_units(kB):
    """The block form's units as its threads decode them
    (csrc/bs_sweep.cu:join_agg_block_kernel): unit u -> (2p, bj),
    row-pair-major, bj from 2p to kB - 1."""
    out = []
    for u in range(kB * (kB + 2) // 4):
        p = 0
        while u >= kB - 2 * p:
            u -= kB - 2 * p
            p += 1
        out.append((2 * p, 2 * p + u))
    return out


def _block_cells(F):
    """csrc/bs_sweep.cu:stage_cells over every unit's tiles: {(i, j):
    channel} of t = (e | 1 | 0 | 0 | qO)."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    out = {}
    for bp, bj in _block_units(ks.join_stride(F) // 4):
        for bi in (bp, bp + 1):
            if bi > bj:
                continue
            if bi == bj == 0:
                out[(0, 1)] = 0
                continue
            for ii in range(4 if bi else 2):
                m = 4 * bi + ii - 4
                base = (2 * F - 3 + m * F - m * (m + 1) // 2 if bi
                        else (-3 if ii == 0 else F - 3))
                for jj in range(4):
                    j = 4 * bj + jj
                    if (jj >= ii or bi != bj) and j < F + 4:
                        assert (4 * bi + ii, j) not in out
                        out[(4 * bi + ii, j)] = base + j
    return out


@pytest.mark.parametrize("F", [2, 5, 20, 33, 37, 48, 64, 65, 66, 128, 251,
                               260])
def test_join_block_cells_land_on_their_channels(F):
    """The block form's epilogue puts each Gram cell of t = (e | 1 | 0 | 0 |
    qO) at the channel of its product (e x, e qO_m x, qO_m x, then
    qO_m qO_n x in numpy's triu order, as bs_join_agg_plain stacks them):
    every channel once, and no cell of e e, 1 1, the zeros or below the
    diagonal."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    iu0, iu1, _, _ = ks._sym(F)
    want = {(0, 1): 0}
    want.update({(0, 4 + m): 1 + m for m in range(F)})
    want.update({(1, 4 + m): 1 + F + m for m in range(F)})
    want.update({(4 + m, 4 + n): 1 + 2 * F + p
                 for p, (m, n) in enumerate(zip(iu0, iu1))})
    got = _block_cells(F)
    assert got == want
    assert sorted(got.values()) == list(range(ks.agg_channels(F)))


@pytest.mark.parametrize("F,L,form", [
    (0, 1, "group"), (0, 32, "group"), (0, 33, "block"), (1, 8, "group"),
    (1, 65536, "block"), (2, 8, "warp"), (20, 8, "warp"), (20, 32, "warp"),
    (20, 33, "tiles"), (20, 65536, "tiles"), (192, 64, "tiles"),
    (193, 64, "tiles_l2wcc"), (236, 8, "warp"), (237, 8, "tiles_l2wcc"),
    (251, 65536, "tiles_l2wcc")])
def test_rel_draw_form_is_a_function_of_f_and_l(F, L, form):
    """X10b's form: narrow buckets (L <= 32) a group of lanes (F <= 1) or a
    warp (F >= 2) a column while a warp's slice fits; wide ones a block per
    (column, split), at F >= 2 over tiles of whole rows while two of them
    fit, past that of rows without wcc; the plan's k fits the block."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks
    from svbfm_tpu_torch.kernels.mcmc_sweep import MAX_BLOCK_SMEM

    assert ks.draw_form(F, L) == form
    p = ks.draw_plan(F, 3, L, 1, L, 132)
    assert p.form == form and p.k >= (0 if form == "block" else 1)
    if form == "group":
        assert p.k == ks.narrow_lanes(L) and p.S == 1
    if form == "warp":
        assert p.S == 1 and p.k == ks.warp_lanes(F, L) in (8, 32)
        E = ks.warp_rows(F, p.k)
        assert 4 * ks.warp_slice(F, E) * (32 // p.k) <= MAX_BLOCK_SMEM
    if form.startswith("tiles"):
        # the most rows (<= 32) that let four blocks share an SM where the
        # draw holds one factor a lane (F <= 32), else that fit one block
        cap = MAX_BLOCK_SMEM // 4 if F <= 32 else MAX_BLOCK_SMEM
        assert ks.tiles_smem(F, p.k, form == "tiles") <= cap
        assert p.k == 32 or ks.tiles_smem(F, p.k + 1, form == "tiles") > cap


@pytest.mark.parametrize("C,lo,hi", [(2, 35500, 36100), (2, 589, 611),
                                     (2, 1024, 1024), (1, 3, 300),
                                     (7, 257, 512), (500, 33, 64),
                                     (3, 0, 299), (1, 1, 1)])
def test_rel_draw_splits_cover_the_real_entries(C, lo, hi):
    """The block forms' split of a column's real entries: every share of
    every column from lo to hi entries holds at least one real entry (a
    column with none takes one share), the shares tile [0, n) in order,
    the longest column's shares hold at least 128 where it is split, and
    a bucket of few columns gets about four blocks an SM."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    S = ks.draw_splits(C, lo, hi, 132)
    assert 1 <= S <= max(lo, 1)
    assert S == 1 or hi // S >= 128
    assert C * S <= 4 * 132 + C
    for n in sorted({lo, (lo + hi) // 2, hi}):
        shares = ks.split_bounds(n, S)
        assert shares[0][0] == 0 and shares[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        assert n == 0 or all(e > b for b, e in shares)
    if (C, lo, hi) == (2, 35500, 36100):
        assert S == 264  # the card's 132 SMs, four blocks each


def test_rel_block_real_counts_are_the_plans():
    """RelBlock.real on chip_smoke.py's small relational problem: each
    column's real entries are numpy's count of its non-zero x (the plan
    puts them first), with their least and most on the host."""
    import chip_smoke

    learner = chip_smoke.small_bs_learner("cpu")
    for rd in learner.rels:
        for bb in rd.rplan:
            for b in bb:
                x = b.x.numpy()
                n = np.count_nonzero(x, axis=1)
                assert b.real.n.dtype == torch.int32
                np.testing.assert_array_equal(b.real.n.numpy(), n)
                assert (b.real.lo, b.real.hi) == (n.min(), n.max())
                assert all((x[c, :k] != 0).all() for c, k in enumerate(n))


def test_draw_widths_the_learners_admit_are_unchanged():
    """The widths the learners give X8a and X10b, F = 1 ... 320, are the
    ones the block-wide draws admitted (their shared-memory footprints,
    written out here), so factor_width and bs_factor_width pick the same
    F: X8a's exact mode up to 303, its Jacobi mode beyond 320, X10a and
    X10b up to 251."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks
    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    cap = 227 * 1024
    for F in range(1, 321):
        nout = 2 * F + F * (F - 1) // 2
        col = {True: 4 * (nout + 33 * F + 32 + 5 * F + 1),
               False: 4 * (2 * F + 33 * F + 32 + 5 * F + 1)}
        for exact in (True, False):
            assert km.col_draw_fits(F, exact) == (F == 1 or col[exact] <= cap)
        Fo = max(F, 1)
        draw = 4 * (ks.draw_outputs(F) + Fo * 33 + 96 + 2 * F * 33 + 32
                    + 5 * Fo + 2)
        agg = 4 * (1 + 2 * F + F * (F + 1) // 2 + 64 + 33 * F + F)
        assert ks.rel_draw_fits(F) == (max(draw, agg) <= cap)
    assert [F for F in range(1, 321) if km.col_draw_fits(F, True)][-1] == 303
    assert [F for F in range(1, 321) if ks.rel_draw_fits(F)][-1] == 251


@pytest.mark.parametrize("F,form,lanes", [
    (0, "thread", 1), (1, "thread", 1), (2, "lanes", 2), (3, "lanes", 4),
    (4, "lanes", 4), (5, "lanes", 8), (8, "lanes", 8), (9, "lanes", 16),
    (16, "lanes", 16), (17, "lanes", 32), (20, "lanes", 32),
    (32, "lanes", 32), (33, "block", 64), (64, "block", 64),
    (65, "block", 96), (251, "block", 256), (256, "block", 256)])
def test_rel_patch_form_is_a_function_of_f(F, form, lanes):
    """X10c's form: a thread a relation row at F <= 1; at 2 <= F <= 32 the
    next power of two >= F lanes a row, the rows of a 256-thread block in
    two slices of shared memory each (the row and two positions' ptab rows,
    v_old and dv at 16-byte boundaries); past F = 32 a block of round32(F)
    threads a row, one slice and the block's sum partials; every plan fits
    a block (csrc/bs_sweep.cu:svbfm_bs_rel_patch)."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks
    from svbfm_tpu_torch.kernels.mcmc_sweep import MAX_BLOCK_SMEM

    p = ks.patch_plan(F)
    assert (p.form, p.lanes) == (form, lanes)
    ld = ks.rel_layout(F)["ld"]
    r4 = lambda n: -(-n // 4) * 4  # noqa: E731
    assert ks.patch_slice(F) == r4(ld) + 2 * 2 * r4(F)
    if form == "thread":
        assert (p.rows, p.smem) == (256, 0)
    elif form == "lanes":
        assert lanes >= F > lanes // 2 and p.rows == 256 // lanes
        assert p.smem == 4 * 2 * p.rows * ks.patch_slice(F)
    else:
        assert p.rows == 1 and lanes == -(-F // 32) * 32
        assert p.smem == 4 * (ks.patch_slice(F) + 2 * lanes // 32)
    assert p.smem <= MAX_BLOCK_SMEM and ks.patch_fits(F)


def test_rel_patch_fits_every_width_the_learners_give():
    """Every width the BS learners give X10c (to MAX_REL_F) fits its form;
    past 256 factors a block's threads no longer cover the factors."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    assert all(ks.patch_fits(F) for F in range(ks.MAX_REL_F + 1))
    assert ks.patch_fits(256) and not ks.patch_fits(257)


_A = dict(join=0x1000, dy=0x2000, qB1=0x3000, qB0=0x4000, q=0x5000,
          e=0x6000)


@pytest.mark.parametrize("F,ld1,addrs,plan", [
    (1, 6, _A, ("rows", 4, 1, 4)),
    (1, 6, dict(_A, e=0x6004), ("rows", 1, 1, 4)),
    (1, 6, dict(_A, join=0x1008), ("rows", 1, 1, 4)),
    (1, 1, dict(join=0x1000, qB1=0x3004, q=0x5000), ("rows", 4, 1, 4)),
    (1, 0, dict(join=0x1000, dy=0x2004, e=0x6000), ("rows", 4, 1, 4)),
    (20, 272, _A, ("chunks", 4, 5, 6)),
    (20, 20, dict(join=0x1000, qB1=0x3000, q=0x5000), ("chunks", 4, 5, 6)),
    (20, 272, dict(_A, q=0x5008), ("chunks", 2, 10, 3)),
    (20, 272, dict(_A, qB0=0x4004), ("chunks", 1, 20, 1)),
    (20, 21, _A, ("chunks", 1, 20, 1)),
    (2, 11, _A, ("chunks", 1, 2, 16)),
    (3, 17, _A, ("chunks", 1, 3, 10)),
    (8, 62, _A, ("chunks", 2, 4, 8)),
    (64, 64, dict(join=0x1000, qB1=0x3000, q=0x5000), ("chunks", 4, 16, 2)),
    (64, 2274, _A, ("chunks", 2, 32, 1)),
    (33, 33, _A, ("chunks", 1, 32, 1)),
    (251, 251, _A, ("chunks", 1, 32, 1))])
def test_resync_plan_is_a_function_of_f_and_alignment(F, ld1, addrs, plan):
    """X10d's resync form: at F = 1 four data rows a thread, 16-byte loads
    of join, q and e where all three allow them; at F >= 2 lanes over
    chunks of a row of the widest of 4, 2, 1 floats that divides F (and
    ld1, where qB1 is given) and to whose size dy, qB1, qB0 and q are
    aligned, min(F / vec, 32) lanes a row, 32 // lanes rows a warp
    (csrc/bs_forward.cu:svbfm_bs_resync, resync_vec)."""
    from svbfm_tpu_torch.kernels import bs_forward as kf

    assert tuple(kf.resync_plan(F, ld1, addrs)) == plan


def test_resync_plan_of_reads_the_tensors():
    """resync_plan_of takes qB1's row stride and the operands' addresses
    from the tensors of a call: a column slice of the relation table at
    F = 20 (ld1 = 272) and at F = 3 (ld1 = 17)."""
    from svbfm_tpu_torch.kernels import bs_forward as kf
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    N, R = 10, 4
    join = torch.zeros(N, dtype=torch.int32)
    for F, vec in ((20, 4), (3, 1)):
        rtab = torch.zeros(R, ks.rel_layout(F)["ld"])
        t = [torch.zeros(R, F), rtab[:, :F], torch.zeros(R, F),
             torch.zeros(N, F), torch.zeros(N)]
        assert all(a.data_ptr() % 16 == 0 for a in t)  # the CPU allocator
        p = kf.resync_plan_of(join, F, *t)
        assert p.form == "chunks" and p.vec == vec
        assert p == kf.resync_plan(F, rtab.stride(0), dict(
            join=join.data_ptr(), dy=t[0].data_ptr(), qB1=t[1].data_ptr(),
            qB0=t[2].data_ptr(), q=t[3].data_ptr(), e=t[4].data_ptr()))


# ---------------------------------------------------------------------------
# The relation-row moments (X10d)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,G,ch", [
    (0, 1, 3), (2, 1, 3), (3, 2, 3), (5, 2, 3), (7, 4, 3), (15, 8, 3),
    (16, 8, 3), (20, 8, 3), (33, 16, 3), (64, 32, 3), (127, 32, 3),
    (200, 32, 3)])
def test_moments_plan_covers_every_channel_once(K, G, ch):
    """The moments kernel's form (csrc/bs_forward.cu:moments_lanes,
    svbfm_bs_rel_moments): 3 channels a lane a pass, the next power of two
    >= (K + 1) / 3 lanes a row, at most 32.  Walking its launch (32 / G
    rows a warp, lane l of a row on channels l, l + G, ..., ch a pass) over
    a ragged R reaches every (row, channel) once."""
    from svbfm_tpu_torch.kernels import bs_forward as kf

    assert tuple(kf.moments_plan(K)) == (G, ch, 32 // G)
    R, C = 37, K + 1
    rpw = 32 // G
    seen = []
    for w in range(-(-R // rpw)):
        for lane in range(32):
            slot, gl = divmod(lane, G)
            rho = w * rpw + slot
            if rho < R:
                for c0 in range(0, C, ch * G):
                    seen += [(rho, c) for i in range(ch)
                             if (c := c0 + gl + G * i) < C]
    assert sorted(seen) == [(r, c) for r in range(R) for c in range(C)]


@pytest.mark.parametrize("k1", [True, False])
@pytest.mark.parametrize("K,Pr", [(0, 3), (1, 1), (5, 21), (20, 21),
                                  (33, 40)])
def test_moments_twin_is_the_float64_sum(K, Pr, k1):
    """bs_rel_moments_plain, the moments kernel's twin: (qB | lin | sumsB)
    of each relation row over its positions, padding entries (x = 0) among
    them, sumsB = sum_f sB_f, equal to a float64 numpy sum, at the
    moments table's stride (a multiple of 8 floats); lin is 0 without
    k1."""
    from svbfm_tpu_torch.kernels import bs_forward as kf

    rng = np.random.default_rng(10 * K + Pr)
    R, Dr, off = 13, 17, 4
    stab = rng.normal(0, 1, (off + Dr + 2, K + 1)).astype(np.float32)
    rids = rng.integers(0, Dr, (R, Pr)).astype(np.int32)
    rvals = rng.uniform(-1, 2, (R, Pr)).astype(np.float32)
    rvals[::3, -1] = 0.0
    got = kf.bs_rel_moments_plain(torch.from_numpy(rids),
                                  torch.from_numpy(rvals),
                                  torch.from_numpy(stab), off, k1).numpy()
    d = stab.astype(np.float64)[off + rids] * rvals[..., None]  # [R, Pr, C]
    lin = d[..., 0].sum(1) if k1 else np.zeros(R)
    want = np.concatenate([d[..., 1:].sum(1), lin[:, None],
                           (d[..., 1:] ** 2).sum((1, 2))[:, None]], 1)
    m = kf.bs_rel_moments_plain(torch.from_numpy(rids),
                                torch.from_numpy(rvals),
                                torch.from_numpy(stab), off, k1)
    assert got.shape == (R, K + 2)
    assert m.stride(0) == kf.moments_stride(K) and m.stride(0) % 8 == 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if not k1:
        assert (got[:, K] == 0).all()


@pytest.mark.parametrize("case", ["wide=6", "empty main, two relations"])
def test_moments_qb_matches_jax_qb_pre(case):
    """The moments' qB channels, which the port's v sweep takes as qB_pre
    (learners/mcmc_bs.py), against the JAX sweep's qB_pre loop
    (svbfm_tpu/learners/mcmc_bs.py:700-708) from the JAX learner's
    initial state, relation by relation."""
    import jax.numpy as jnp

    from svbfm_tpu_torch.kernels import bs_forward as kf

    K = 3
    jl, tl = _pair(False, K=K, **SCORE_CASES[case])
    js, ts = _start(jl)
    stab = tbs.param_table(ts.w, ts.v, True)
    for jrd, jrs, rd, rs in zip(jl.rels, jl.rstats, tl.rels, tl.rstats):
        v_r = jax.lax.dynamic_slice_in_dim(js.v, jrs.attr_offset,
                                           jrs.num_attrs, axis=1)
        qB = jnp.zeros((K, jrs.num_rows), js.v.dtype)
        for p in range(jrd.rrow_ids.shape[1]):
            qB = qB + (jnp.take(v_r, jrd.rrow_ids[:, p], axis=-1)
                       * jrd.rrow_vals[:, p][None])
        got = kf.bs_rel_moments_plain(rd.rrow_ids, rd.rrow_vals, stab,
                                      rs.attr_offset)[:, :K]
        np.testing.assert_allclose(got.numpy().T, np.asarray(qB), rtol=1e-6,
                                   atol=1e-7)


def test_lane_tree_sum_is_the_kernel_order():
    """lane_tree_sum, the twin's sumsB, walks the moments kernel's order
    (csrc/bs_forward.cu:rel_moments_kernel): each lane's channels in
    ascending c from 0, then the segmented shuffle, lane l adding lane
    l + d for d = 1, 2, 4, ...; replayed here in float32, bit for bit, at
    every lane count the kernel takes."""
    from svbfm_tpu_torch.kernels import bs_forward as kf

    rng = np.random.default_rng(5)
    for K in (0, 1, 3, 8, 20, 33, 130):
        G = kf.moments_plan(K).lanes
        c = rng.normal(0, 1, (6, K + 1)).astype(np.float32)
        want = np.zeros(6, np.float32)
        for r in range(6):
            lane = [np.float32(0)] * G
            for ch in range(1, K + 1):
                lane[ch % G] = np.float32(lane[ch % G] + c[r, ch])
            d = 1
            while d < G:
                lane = [np.float32(lane[i] + lane[i + d]) if i + d < G
                        else lane[i] for i in range(G)]
                d *= 2
            want[r] = lane[0]
        got = kf.lane_tree_sum(torch.from_numpy(c), G).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"K={K}")


@pytest.mark.parametrize("K,P,ldm,aligned,plan", [
    (20, 1, 24, True, (4, 5, 6, "p1", 24)),
    (20, 2, 24, True, (4, 5, 6, "any", 24)),
    (20, 1, 24, False, (1, 5, 6, "p1", 24)),
    (20, 3, 22, True, (1, 5, 6, "any", 22)),  # a contiguous [R, K+2]
    (0, 1, 8, True, (1, 1, 32, "p1", 8)),
    (1, 3, 8, True, (1, 1, 32, "any", 8)),
    (3, 2, 8, True, (1, 1, 32, "any", 8)),
    (8, 1, 16, True, (4, 2, 16, "p1", 16)),
    (33, 1, 40, True, (1, 9, 3, "p1", 40)),
    (128, 4, 136, True, (4, 32, 1, "any", 136)),
    (130, 2, 136, True, (1, 32, 1, "any", 136))])
def test_scores_plan_is_the_cu_rule(K, P, ldm, aligned, plan):
    """bs_scores' form (csrc/fm_forward.cu:svbfm_bs_scores,
    moments_width, row_lanes): K1a's lanes and rows, its P = 1 build
    (rows of two positions take the any-P build), 16-byte moments loads where K and the rows' stride are multiples of 4
    and the tables' bases 16-byte aligned, else 4-byte loads; the
    stride moments_table gives is K + 2 rounded up to 8.  Walking the
    launch over a ragged N reaches every (row, chunk) once, and each
    row's relation rider (lin, sumsB) on one lane, its last chunk's."""
    from svbfm_tpu_torch.kernels import bs_forward as kf

    p = kf.scores_plan(K, P, ldm, aligned)
    assert tuple(p) == plan
    if ldm % 8 == 0:
        assert kf.moments_stride(K) == ldm
    N, G = 53, -(-K // 4)
    warps = -(-N // p.rows)
    seen, rider = [], []
    for w in range(warps):
        for lane in range(32):
            slot, j = divmod(lane, p.lanes)
            n = w * p.rows + slot
            if slot >= p.rows or n >= N:
                continue
            for c0 in range(0, max(G, 1), 32):  # the warp's passes
                ch = c0 + j
                if ch < G:
                    seen.append((n, ch))
                if ch == max(G - 1, 0):
                    rider.append(n)
    assert sorted(seen) == [(n, c) for n in range(N) for c in range(G)]
    assert sorted(rider) == list(range(N))


def _rel_case(rng, K, nrel, N=41, Dm=7, P=2):
    """A main block of Dm attributes over P positions (padding entries at
    attribute 0, x = 0), ``nrel`` relations of 3 + 2r rows over 5
    attributes in 3 positions each (padding among them), their joins, and
    parameters: numpy arrays."""
    ids = rng.integers(0, Dm, (N, P)).astype(np.int32)
    vals = rng.uniform(-1, 2, (N, P)).astype(np.float32)
    ids[::4, -1], vals[::4, -1] = 0, 0.0
    rels, off = [], Dm
    for r in range(nrel):
        R, Dr = 3 + 2 * r, 5
        rid = rng.integers(0, Dr, (R, 3)).astype(np.int32)
        rx = rng.uniform(-1, 2, (R, 3)).astype(np.float32)
        rx[::2, -1] = 0.0
        rels.append(dict(ids=rid, vals=rx, off=off, R=R, Dr=Dr,
                         join=rng.integers(0, R, N).astype(np.int32)))
        off += Dr
    w = rng.normal(0, 0.5, off).astype(np.float32)
    v = rng.normal(0, 0.3, (K, off)).astype(np.float32)
    return ids, vals, rels, np.float32(0.3), w, v


def _joined_positions(ids, vals, rels):
    """Each data row's positions in the materialised join: (attribute, x)
    pairs of its main row and of each relation's joined row, padding
    entries among them (a repeated attribute stays two positions, as in
    the row layout)."""
    out = []
    for n in range(ids.shape[0]):
        pos = list(zip(ids[n], vals[n]))
        for r in rels:
            j = r["join"][n]
            pos += [(r["off"] + i, x) for i, x in zip(r["ids"][j],
                                                     r["vals"][j])]
        out.append(pos)
    return out


@pytest.mark.parametrize("k0k1", [(True, True), (False, False)])
@pytest.mark.parametrize("nrel", [0, 1, 2, 9])
@pytest.mark.parametrize("K", [0, 1, 3, 8, 20, 33])
def test_bs_scores_match_jax_and_float64(K, nrel, k0k1):
    """The moments twin's row (qB | lin | sumsB), bs_scores_plain and
    bs_score_rows (the learners' scores) against svbfm_tpu's bs_scores
    (the function the JAX learner's _bs_scores_tr runs) and against a
    float64 sum over the materialised join, at K = 0-33, with 0, 1, 2 and
    9 relations and k0/k1 on and off.  Scores: rtol 1e-5 / atol 1e-5 (one
    float32 sum a row in another order, sumsB among it); the moments: the
    same against float64."""
    import types

    import jax.numpy as jnp

    from svbfm_tpu_torch.kernels import bs_forward as kf

    k0, k1 = k0k1
    rng = np.random.default_rng(100 * K + 10 * nrel + k0)
    ids, vals, rels, w0, w, v = _rel_case(rng, K, nrel)
    stab = tbs.param_table(torch.from_numpy(w), torch.from_numpy(v), k1)
    for r in rels:
        m = kf.bs_rel_moments_plain(torch.from_numpy(r["ids"]),
                                    torch.from_numpy(r["vals"]), stab,
                                    r["off"], k1).numpy()
        d = (np.concatenate([w[:, None], v.T], 1).astype(np.float64)
             [r["off"] + r["ids"]] * r["vals"][..., None])
        want = np.concatenate([d[..., 1:].sum(1), (d[..., 0].sum(1) if k1
                                                   else np.zeros(r["R"]))[:, None],
                               (d[..., 1:] ** 2).sum((1, 2))[:, None]], 1)
        np.testing.assert_allclose(m, want, rtol=1e-5, atol=1e-5)

    want64 = np.zeros(ids.shape[0])
    for n, pos in enumerate(_joined_positions(ids, vals, rels)):
        a = np.array([i for i, _ in pos])
        x = np.array([x for _, x in pos], np.float64)
        d = v.astype(np.float64)[:, a] * x  # [K, positions]
        want64[n] = ((w0 if k0 else 0.0)
                     + (w.astype(np.float64)[a] @ x if k1 else 0.0)
                     + 0.5 * ((d.sum(1) ** 2).sum() - (d ** 2).sum()))

    jrels = [types.SimpleNamespace(rrow_ids=jnp.asarray(r["ids"]),
                                   rrow_vals=jnp.asarray(r["vals"]))
             for r in rels]
    jstats = [jbs.RelStatic(attr_offset=r["off"], num_attrs=r["Dr"],
                            num_rows=r["R"]) for r in rels]
    want = np.asarray(jbs.bs_scores(
        jnp.float32(w0), jnp.asarray(w), jnp.asarray(v), jnp.asarray(ids),
        jnp.asarray(vals), jrels, jstats,
        [jnp.asarray(r["join"]) for r in rels], k0, k1))

    trels = [types.SimpleNamespace(rrow_ids=torch.from_numpy(r["ids"]),
                                   rrow_vals=torch.from_numpy(r["vals"]))
             for r in rels]
    tstats = [types.SimpleNamespace(attr_offset=r["off"]) for r in rels]
    joins = [torch.from_numpy(r["join"]) for r in rels]
    got = tbs.bs_score_rows(torch.tensor(w0), torch.from_numpy(w),
                            torch.from_numpy(v), torch.from_numpy(ids),
                            torch.from_numpy(vals), trels, tstats, joins, k0,
                            k1).numpy()
    moms = [kf.bs_rel_moments_plain(rd.rrow_ids, rd.rrow_vals, stab,
                                    rs.attr_offset, k1)
            for rd, rs in zip(trels, tstats)]
    plain = kf.bs_scores_plain(
        stab, torch.tensor(w0 if k0 else 0.0), torch.from_numpy(ids),
        torch.from_numpy(vals), joins, moms).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want64, rtol=1e-5, atol=1e-5)
