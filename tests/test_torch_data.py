"""The port's host data layer is an array-for-array copy of the JAX
package's: same COO in, same arrays out, field by field."""

import numpy as np
import pytest

from svbfm_tpu.data import dataset as jds
from svbfm_tpu.data import libfm_text as jtxt
from svbfm_tpu.data import meta as jmeta
from svbfm_tpu.data import synth as jsynth
from svbfm_tpu_torch.data import dataset as tds
from svbfm_tpu_torch.data import libfm_text as ttxt
from svbfm_tpu_torch.data import meta as tmeta
from svbfm_tpu_torch.data import synth as tsynth

BLOCK_FIELDS = ("rows", "x", "cols", "group", "sx2", "cnt", "col_count")


def _general_coo(mod, seed=0, num_rows=300, D=40):
    """Non-field sparse data (variable nnz, overlapping id ranges): bins
    come from greedy coloring."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for r in range(num_rows):
        k = int(rng.integers(1, 5))
        c = np.sort(rng.choice(D, size=k, replace=False))
        rows += [r] * k
        cols += c.tolist()
        vals += rng.uniform(0.5, 2.0, size=k).tolist()
    return mod.COOData(
        row=np.asarray(rows, np.int32), col=np.asarray(cols, np.int32),
        val=np.asarray(vals, np.float32),
        target=rng.normal(3.0, 1.0, size=num_rows).astype(np.float32),
        num_rows=num_rows, num_features=D)


def _assert_coo_equal(a, b):
    for f in ("row", "col", "val", "target"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.num_rows, a.num_features) == (b.num_rows, b.num_features)


def _assert_plans_equal(pj, pt):
    assert (pj.num_bins, pj.num_features, pj.rows_per_shard,
            pj.conflict_free) == (pt.num_bins, pt.num_features,
                                  pt.rows_per_shard, pt.conflict_free)
    np.testing.assert_array_equal(pj.unobserved, pt.unobserved)
    np.testing.assert_array_equal(pj.color, pt.color)
    assert [len(b) for b in pj.blocks] == [len(b) for b in pt.blocks]
    for bj, bt in zip(pj.blocks, pt.blocks):
        for kj, kt in zip(bj, bt):
            for f in BLOCK_FIELDS:
                a, b = getattr(kj, f), getattr(kt, f)
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_synth_and_split_identical():
    cj = jsynth.make_movielens_like(num_users=20, num_items=15,
                                    num_ratings=500, rank=2, seed=4)
    ct = tsynth.make_movielens_like(num_users=20, num_items=15,
                                    num_ratings=500, rank=2, seed=4)
    _assert_coo_equal(cj, ct)
    for a, b in zip(jsynth.train_test_split(cj, 0.2, seed=5),
                    tsynth.train_test_split(ct, 0.2, seed=5)):
        _assert_coo_equal(a, b)


@pytest.mark.parametrize("kind", ["field", "general"])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_sweep_plan_identical(kind, n_shards):
    if kind == "field":
        cj = jsynth.make_movielens_like(num_users=25, num_items=18,
                                        num_ratings=600, rank=2, seed=1)
        ct = tsynth.make_movielens_like(num_users=25, num_items=18,
                                        num_ratings=600, rank=2, seed=1)
        groups = np.repeat([0, 1], [25, 18]).astype(np.int32)
    else:
        cj, ct = _general_coo(jtxt), _general_coo(ttxt)
        groups = (np.arange(cj.num_features) % 3).astype(np.int32)
    D = cj.num_features
    pj = jds.SweepPlan.build(cj, D, meta_groups=groups, n_shards=n_shards)
    pt = tds.SweepPlan.build(ct, D, meta_groups=groups, n_shards=n_shards)
    if kind == "field":
        assert pt.num_bins == 2
    else:
        assert tds.detect_field_bins(ct, D) is None  # greedy path taken
        np.testing.assert_array_equal(tds.assign_bins_greedy(ct, D),
                                      jds.assign_bins_greedy(cj, D))
    _assert_plans_equal(pj, pt)


def test_sparse_dataset_identical():
    cj, ct = _general_coo(jtxt, seed=3), _general_coo(ttxt, seed=3)
    for pad in (1, 7):
        dj = jds.SparseDataset.from_coo(cj, pad_rows_to=pad)
        dt = tds.SparseDataset.from_coo(ct, pad_rows_to=pad)
        for f in ("ids", "vals", "target", "row_nnz"):
            np.testing.assert_array_equal(getattr(dj, f), getattr(dt, f))
        assert (dj.num_rows, dj.num_features, dj.min_target,
                dj.max_target) == (dt.num_rows, dt.num_features,
                                   dt.min_target, dt.max_target)
        _assert_coo_equal(dj.to_coo(), dt.to_coo())
        np.testing.assert_array_equal(dj.col_count(), dt.col_count())


def test_libfm_text_round_trip(tmp_path):
    ct = _general_coo(ttxt, seed=6, num_rows=50)
    path = str(tmp_path / "d.libfm")
    ttxt.save_libfm_text(path, ct)
    for native in (False, True):
        _assert_coo_equal(ttxt.load_libfm_text(path, use_native=native),
                          jtxt.load_libfm_text(path, use_native=native))
    _assert_coo_equal(ttxt.load_libfm_text(path, use_native=False), ct)


def test_meta_identical():
    mj = jmeta.DataMetaInfo.from_field_offsets(30, [0, 12, 20])
    mt = tmeta.DataMetaInfo.from_field_offsets(30, [0, 12, 20])
    np.testing.assert_array_equal(mj.attr_group, mt.attr_group)
    np.testing.assert_array_equal(mj.num_attr_per_group,
                                  mt.num_attr_per_group)
    assert mj.num_attr_groups == mt.num_attr_groups == 3
