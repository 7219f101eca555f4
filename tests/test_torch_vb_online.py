"""Online VBFM in the port (CPU twins of K1, K2, K4, K5, K6 and the w
patch) against the JAX package's ``OVBLearner`` and the float64
``OVBOracle``, both packages started from the JAX learner's init
(``utils.convert.ovb_state_from_jax``).

Tolerances, never looser than the JAX tests' own (test_vb_online.py:60-67:
rtol 5e-3 on mu, 3e-3 on mu_0, 5e-3 on sigma'_w and alpha; the
Robbins-Monro counters exactly) and set from what was measured on this
data over 2 epochs (worst relative difference ~3e-4 on the naturals, whose
col_count-scaled sums cancel; ~1e-6 on primal parameters, rmse and the
free energy; float32 sums taken in another order):
  * parameters, precisions and caches: rtol 1e-4 / atol 1e-5;
  * naturals eta1, eta2: rtol 1e-3 / atol 1e-4;
  * rmse, mae, free energy: rtol 1e-5;
  * t_w0, t_wj, t_vj and the nan/inf counters: equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import vb_online as jov
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels import ovb_sweep as ko
from svbfm_tpu_torch.learners import vb_online as tov
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.utils.convert import ovb_state_from_jax

from oracle import OVBOracle

FIELDS = [f.name for f in dataclasses.fields(tov.OVBState)]
NATURALS = ("n_mu_0", "n_sig_0", "n_mu_w", "n_sig_w", "n_mu_v", "n_sig_v")
COUNTERS = ("t_w0", "t_wj", "t_vj")


def _data(num_rows, num_users, num_items, seed):
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=seed)
    return coo, *train_test_split(coo, 0.25, seed=seed + 1)


def _pair(num_rows=120, num_users=9, num_items=7, K=3, seed=2,
          num_batches=3, **cfg_kw):
    """The JAX learner and the port's on the same data and config
    (test_vb_online.py's _setup shapes)."""
    coo, tr, te = _data(num_rows, num_users, num_items, seed)
    D = coo.num_features
    kw = dict(num_attributes=D, num_factor=K, min_target=float(tr.target.min()),
              max_target=float(tr.target.max()), seed=7,
              num_batches=num_batches, **cfg_kw)
    jmeta = JMeta.from_field_offsets(D, [0, num_users])
    tmeta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    jl = jov.OVBLearner(JConfig(num_groups=jmeta.num_attr_groups, **kw),
                        JDataset.from_coo(tr, D), JDataset.from_coo(te, D),
                        jmeta, mesh=make_mesh(1), write_files=False)
    tl = tov.OVBLearner(FMConfig(num_groups=tmeta.num_attr_groups, **kw),
                        SparseDataset.from_coo(tr, D),
                        SparseDataset.from_coo(te, D), tmeta, device="cpu",
                        write_files=False)
    return jl, tl, tr


def _np(state):
    if isinstance(state, tov.OVBState):
        return {k: getattr(state, k).numpy() for k in FIELDS}
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _assert_states_close(tn, jn):
    for k in FIELDS:
        if k in COUNTERS:
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
        elif k in NATURALS:
            np.testing.assert_allclose(tn[k], jn[k], rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(tn[k], jn[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def _run_both(jl, tl, epochs):
    js = jl.init_state()
    ts = ovb_state_from_jax(jax.device_get(js), "cpu")
    js, jh = jl.run(js, num_iter=epochs, verbose=False)
    ts, th = tl.run(ts, num_iter=epochs, verbose=False)
    return _np(ts), th, _np(jax.device_get(js)), jh


def _assert_histories_close(th, jh):
    assert len(th) == len(jh)
    for a, b in zip(jh, th):
        assert set(a) == set(b)
        for k in ("rmse", "mae", "free_energy"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
        counters = [k for k in a if k.startswith(("nan_", "inf_"))]
        assert len(counters) == 20
        assert {k: b[k] for k in counters} == {k: int(a[k]) for k in counters}


def test_ovb_state_from_jax_round_trip():
    jl, tl, _ = _pair()
    js = jax.device_get(jl.init_state())
    ts = ovb_state_from_jax(js, "cpu")
    assert all(getattr(ts, k).dtype == torch.float32 for k in FIELDS)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    # the port's own init keeps the reference's naturals quirk
    own = tl.init_state()
    np.testing.assert_array_equal(own.n_mu_w.numpy(),
                                  (own.mu_w / 0.02).numpy())
    np.testing.assert_array_equal(own.n_sig_v.numpy(),
                                  (1.0 / own.sigma_v_dash).numpy())
    assert float(own.t_w0) == 0.0 and not own.t_vj.any()


def test_one_chunk_one_epoch_matches_jax():
    jl, tl, _ = _pair(num_batches=1)
    tn, th, jn, jh = _run_both(jl, tl, 1)
    _assert_states_close(tn, jn)
    _assert_histories_close(th, jh)


@pytest.mark.parametrize("reshuffle", [False, True])
def test_three_chunks_two_epochs_match_jax(reshuffle):
    jl, tl, _ = _pair(num_batches=3, reshuffle=reshuffle)
    tn, th, jn, jh = _run_both(jl, tl, 2)
    _assert_states_close(tn, jn)
    _assert_histories_close(th, jh)


def test_chunk_membership_and_order_match_jax():
    jl, tl, _ = _pair(num_rows=200, num_batches=4, reshuffle=True)
    np.testing.assert_array_equal(tl.chunk_sizes, jl.chunk_sizes)

    def same_chunks():
        for ci, (row, _plan) in enumerate(tl.chunks):
            n = int(tl.chunk_sizes[ci])
            for field in ("ids", "vals", "target"):
                np.testing.assert_array_equal(
                    getattr(row, field).numpy(),
                    np.asarray(getattr(jl.chunk_row, field))[ci][:n])

    same_chunks()
    for _ in range(3):  # epoch orders
        np.testing.assert_array_equal(tl.rng.permutation(tl.num_chunks),
                                      jl.rng.permutation(jl.num_chunks))
    jl._reshuffle_membership()
    tl._reshuffle_membership()
    np.testing.assert_array_equal(tl.member_perm, jl._last_member_perm)
    same_chunks()


def _bin(widths, seed=0):
    """A bin of buckets [C, L] for (C, L) in ``widths``, its columns
    numbered in order."""
    from svbfm_tpu_torch.learners.base import BlockData

    rng = np.random.default_rng(seed)
    out, col = [], 0
    for C, L in widths:
        out.append(BlockData(
            rows=torch.from_numpy(rng.integers(0, 50, (C, L)).astype(
                np.int32)),
            x=torch.ones(C, L), cols=torch.arange(col, col + C,
                                                  dtype=torch.int32),
            group=torch.zeros(C, dtype=torch.int32), sx2=torch.ones(C) * L,
            cnt=torch.ones(C) * L, col_count=torch.ones(C) * L))
        col += C
    return out


def _kernel_cover(plan, F):
    """The (bucket, column, factor) each thread of K6's launch takes its
    ending step on, as csrc/ovb_sweep.cu maps blocks and lanes: a block's
    bucket from the plan's C and L, U lanes a column, FL factor lanes
    times S entry slots, slot 0 ending each factor of a chunk of FL."""
    from svbfm_tpu_torch.kernels.ovb_sweep import _THREADS, col_lanes

    CL = [(r[6], r[7]) for r in plan.table.tolist()]
    FL = col_lanes(F, 1)
    seen = []
    for blk in range(plan.blocks(F)):
        first, b = 0, 0
        while b + 1 < len(CL):
            n = ko.bucket_blocks(CL[b][0], F, CL[b][1])
            if blk < first + n:
                break
            first, b = first + n, b + 1
        C, L = CL[b]
        U = col_lanes(F, L)
        for th in range(_THREADS):
            c = ((blk - first) * _THREADS + th) // U
            lane = th % U
            if c >= C or lane // FL:
                continue
            for f0 in range(0, F, FL):
                if f0 + lane % FL < F:
                    seen.append((b, c, f0 + lane % FL))
    return seen


@pytest.mark.parametrize("F", [1, 2, 5, 20, 33])
def test_bin_plan_covers_every_column_once(F):
    """K6's plan of a bin whose buckets have L = 1, 7, 16, 33 and 300 and
    one is empty: the table holds each bucket's tensors, C and L in the
    bin's order, and the launch the kernel makes from it takes the ending
    step of every (column, factor) of every bucket exactly once."""
    widths = [(5, 1), (9, 7), (0, 16), (40, 16), (3, 33), (2, 300)]
    buckets = _bin(widths)
    plan = ko.BinPlan(buckets)
    assert plan.buckets == tuple(buckets)
    assert plan.table.dtype == torch.int64 and plan.table.shape == (6, 8)
    for row, b in zip(plan.table.tolist(), buckets):
        assert row == [b.rows.data_ptr(), b.x.data_ptr(), b.cols.data_ptr(),
                       b.group.data_ptr(), b.cnt.data_ptr(),
                       b.col_count.data_ptr(), *b.rows.shape]
    assert torch.equal(ko.BinPlan(buckets).table, plan.table)
    seen = _kernel_cover(plan, F)
    want = [(b, c, f) for b, (C, _) in enumerate(widths) for c in range(C)
            for f in range(F)]
    assert sorted(seen) == want  # each once
    assert plan.blocks(F) == sum(ko.bucket_blocks(C, F, L)
                                 for C, L in widths)
    assert ko.BinPlan([]).blocks(F) == 0


def test_bin_plans_rebuilt_with_membership():
    """The learner keeps a BinPlan for each bin of each chunk, built from
    that chunk's own buckets (their counts are the chunk's), and builds
    them anew when reshuffle re-draws the membership."""
    _, tl, _ = _pair(num_rows=400, num_users=17, num_items=13,
                     num_batches=3, reshuffle=True)
    D = tl.cfg.num_attributes

    def check():
        assert len(tl.chunks) == tl.num_chunks
        for row, bins in tl.chunks:
            cnt = np.zeros(D)
            for plan in bins:
                assert isinstance(plan, ko.BinPlan)
                assert plan.table.tolist() == [
                    [b.rows.data_ptr(), b.x.data_ptr(), b.cols.data_ptr(),
                     b.group.data_ptr(), b.cnt.data_ptr(),
                     b.col_count.data_ptr(), *b.rows.shape]
                    for b in plan.buckets]
                for b in plan.buckets:
                    cnt[b.cols.numpy()] += b.cnt.numpy()
            ids, vals = row.ids.numpy(), row.vals.numpy()
            np.testing.assert_array_equal(
                cnt, np.bincount(ids[vals != 0], minlength=D))
        return [plan for _, bins in tl.chunks for plan in bins]

    before, perm = check(), tl.member_perm.copy()
    tl._reshuffle_membership()
    after = check()
    assert not np.array_equal(perm, tl.member_perm)
    assert not any(a is b for a in after for b in before)


def test_ovb_matches_serial_oracle():
    """As test_vb_online.py:33-67 holds the JAX learner (its tolerances)."""
    jl, tl, tr = _pair(factor_block=1)
    ts = tl.init_state()
    orc = OVBOracle(tr.row, tr.col, tr.val, tr.target, tl.cfg.num_attributes,
                    tl.cfg.num_factor, tl.col_count, tr.num_rows,
                    groups=tl.meta.attr_group)
    orc.init(float(ts.mu_0), float(ts.sigma_0_dash), ts.mu_w.numpy(),
             ts.sigma_w_dash.numpy(), ts.mu_v.numpy(),
             ts.sigma_v_dash.numpy())
    perm = np.random.default_rng(tl.cfg.seed).permutation(tr.num_rows)
    chunk_rows = np.array_split(perm, tl.num_chunks)
    order_rng = np.random.default_rng(tl.cfg.seed + 1)
    for _epoch in range(2):
        order = order_rng.permutation(tl.num_chunks)
        ts, packed = tl.epoch(ts, order)
        assert not packed[4:].any()  # healthy run: no nan/inf candidates
        for ci in order:
            orc.chunk_update(chunk_rows[ci])
        np.testing.assert_allclose(float(ts.mu_0), orc.mu_0, rtol=3e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(ts.mu_w.numpy(), orc.mu_w, rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(ts.mu_v.numpy(), orc.mu_v, rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(ts.sigma_w_dash.numpy(), orc.sigma_w_dash,
                                   rtol=5e-3, atol=1e-5)
        np.testing.assert_allclose(float(ts.alpha), orc.alpha, rtol=5e-3)
        np.testing.assert_allclose(ts.t_wj.numpy(), orc.t_wj)
        np.testing.assert_allclose(ts.t_vj.numpy(), orc.t_vj)


def test_k1_matches_jax_flat_factor_path(monkeypatch):
    """K = 1: the JAX learner forced onto its F = 1 flat specialisation
    (ovb_v_factor), which the port serves with the generic block at F = 1."""
    monkeypatch.setenv("SVBFM_OVB_FLAT", "1")
    assert jov._use_flat_dispatch(100, 10, 1)
    jl, tl, _ = _pair(K=1, num_batches=3, factor_block=1)
    tn, th, jn, jh = _run_both(jl, tl, 2)
    _assert_states_close(tn, jn)
    _assert_histories_close(th, jh)


# test_vb_online.py:175's shape: 400 rows, 17 users, 13 items
JAX_TEST_SHAPE = dict(num_rows=400, num_users=17, num_items=13)


@pytest.mark.parametrize("K,factor_block,shape", [
    (3, 2, {}), (0, 1, {}), (1, 1, JAX_TEST_SHAPE), (3, 3, JAX_TEST_SHAPE)])
def test_factor_blocks_and_k0_match_jax(K, factor_block, shape):
    """(3, 2): the narrower last block against JAX's padded, masked one;
    (0, 1): no factors, the w sweep alone; K = 1 and 3 on the JAX tests'
    shape, whose bins hold several buckets each: K6 runs a bin at a time
    from its BinPlan (on the CPU its twin, bucket by bucket)."""
    jl, tl, _ = _pair(K=K, num_batches=3, factor_block=factor_block,
                      **shape)
    if shape:
        bins = [plan for _, bb in tl.chunks for plan in bb]
        assert sum(len(plan.buckets) for plan in bins) > len(bins)
    tn, th, jn, jh = _run_both(jl, tl, 2)
    _assert_states_close(tn, jn)
    _assert_histories_close(th, jh)


def test_nan_candidates_counted_as_jax_counts():
    """A NaN natural (eta2 of one w column and of one v column) makes NaN
    candidates: the port counts nan and inf apart, family by family, as
    the JAX learner does, and keeps the primal finite."""
    jl, tl, _ = _pair(num_batches=3)
    js = jax.device_get(jl.init_state())
    col = int(np.argmax(tl.col_count))  # a column present in every chunk
    js = js.replace(n_sig_w=np.asarray(js.n_sig_w).copy(),
                    n_sig_v=np.asarray(js.n_sig_v).copy())
    js.n_sig_w[col] = np.nan
    js.n_sig_v[1, col] = np.nan
    ts = ovb_state_from_jax(js, "cpu")
    js2, jh = jl.run(jax.device_put(js), num_iter=1, verbose=False)
    ts2, th = tl.run(ts, num_iter=1, verbose=False)
    _assert_histories_close(th, jh)
    assert th[0]["nan_mu_w_dash"] > 0 and th[0]["nan_sigma_v_dash"] > 0
    assert np.isfinite(ts2.mu_w.numpy()).all()
    np.testing.assert_allclose(ts2.mu_w.numpy(), np.asarray(js2.mu_w),
                               rtol=1e-4, atol=1e-5)


def test_ovb_converges():
    coo, tr, te = _data(3000, 30, 25, 2)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 30])
    cfg = FMConfig(num_attributes=D, num_factor=4, num_groups=2, seed=7,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), num_batches=5)
    learner = tov.OVBLearner(cfg, SparseDataset.from_coo(tr, D),
                             SparseDataset.from_coo(te, D), meta,
                             device="cpu", write_files=False)
    assert learner.cfg.factor_block == 1  # factor-sequential by default
    _, history = learner.run(num_iter=12, verbose=False)
    assert history[-1]["rmse"] < history[0]["rmse"]
    assert history[-1]["rmse"] < 1.0


def test_trajectory_files_first_and_last_chunk(tmp_path):
    jl, tl, _ = _pair(num_batches=3)
    tl.out_dir, tl.write_files = str(tmp_path), True
    _, th = tl.run(num_iter=2, verbose=False)
    tag = tl.cfg.dim_tag
    fe = np.loadtxt(tmp_path / f"free_energy_{tag}_vb_online")
    rm = np.loadtxt(tmp_path / f"test_rmse_{tag}_vb_online")
    assert fe.shape == (4,)  # first and last chunk of each epoch
    np.testing.assert_allclose(fe[1::2], [-h["free_energy"] for h in th],
                               rtol=1e-6)
    np.testing.assert_allclose(rm, [h["rmse"] for h in th], rtol=1e-6)


def test_predict_test_scores_matches_jax():
    jl, tl, _ = _pair()
    js = jl.init_state()
    ts = ovb_state_from_jax(jax.device_get(js), "cpu")
    np.testing.assert_allclose(tl.predict_test_scores(ts),
                               jl.predict_test_scores(js), rtol=1e-5,
                               atol=1e-6)
