"""Out-of-core batch VBFM in the port (``learners/vb_windowed.py``: the CPU
twins of K1, K2, X13a, K4, X13b and the w patch, the rows and buckets
streamed window by window) against the JAX package's
``WindowedVBLearner`` and against the port's resident exact-mode
``VBLearner``.

Tolerances:
  * the windowed plan against JAX's ``build_windowed_plan``: equal, array
    for array;
  * the windowed learner against JAX's, both from the JAX learner's init
    state: rmse, mae, train rmse and free energy rtol 1e-5; parameters and
    hyperparameters rtol 1e-4 / atol 1e-5; the nan counters equal
    (measured on this data: at most 2e-7 relative on the trajectories);
  * against the port's resident exact mode at the same factor_block: the
    JAX test's own bound (test_vb_windowed.py:53-58), rmse rtol 2e-4 /
    atol 2e-5 and free energy rtol 2e-4 (the window axis splits each
    column's sum);
  * the twins of X13a and X13b: one window equals K3's and K5's twin bit
    for bit; several windows equal the window sums added in window order
    bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from svbfm_tpu.data.binary import save_coo_binary
from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.stream import BinaryChunkReader as JReader
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import vb_windowed as jvw
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.stream import BinaryChunkReader
from svbfm_tpu_torch.kernels import vb_sweep as kv
from svbfm_tpu_torch.kernels import w_sweep as kw
from svbfm_tpu_torch.learners import vb_windowed as tvw
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.vb import VBLearner
from svbfm_tpu_torch.utils.convert import state_from_jax

PARAMS = ("mu_0", "sigma_0_dash", "mu_w", "sigma_w_dash", "mu_v",
          "sigma_v_dash", "alpha", "sigma_0", "sigma_w", "sigma_v")


def _setup(num_rows=3000, num_users=40, num_items=30, K=4, task=0, **kw):
    """test_vb_windowed.py's data and config, in both packages."""
    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=3)
    tr, te = train_test_split(coo, 0.2, seed=4)
    D = coo.num_features
    if task == 1:
        thr = np.median(tr.target)
        tr.target = np.where(tr.target > thr, 1.0, -1.0).astype(np.float32)
        te.target = np.where(te.target > thr, 1.0, -1.0).astype(np.float32)
    base = dict(num_attributes=D, num_factor=K, task=task,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()), num_groups=2, seed=7,
                **kw)
    return dict(tr=tr, te=te, D=D, jcfg=JConfig(**base),
                tcfg=FMConfig(**base),
                jmeta=JMeta.from_field_offsets(D, [0, num_users]),
                tmeta=DataMetaInfo.from_field_offsets(D, [0, num_users]))


def _pair(s, num_windows=3, src=None):
    D = s["D"]
    jsrc, tsrc = src if src is not None else (
        JDataset.from_coo(s["tr"], D), SparseDataset.from_coo(s["tr"], D))
    jl = jvw.WindowedVBLearner(s["jcfg"], jsrc, JDataset.from_coo(s["te"], D),
                               s["jmeta"], num_windows=num_windows,
                               write_files=False)
    tl = tvw.WindowedVBLearner(s["tcfg"], tsrc,
                               SparseDataset.from_coo(s["te"], D), s["tmeta"],
                               device="cpu", num_windows=num_windows,
                               write_files=False)
    return jl, tl


def _run_both(jl, tl, sweeps):
    js = jax.device_get(jl.init_state())  # the JAX run donates its state
    ts = state_from_jax(js, "cpu")
    jend, jh = jl.run(jl.init_state(), num_iter=sweeps, verbose=False)
    tend, th = tl.run(ts, num_iter=sweeps, verbose=False)
    return jax.device_get(jend), jh, tend, th, ts


def _assert_match(jend, jh, tend, th, metrics):
    assert len(th) == len(jh)
    for a, b in zip(jh, th):
        for k in metrics + ("free_energy", "alpha"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
        for k in ("nan_w", "nan_v", "nan_alpha"):
            assert b[k] == float(a[k]), k
    for k in PARAMS:
        np.testing.assert_allclose(getattr(tend, k).numpy(),
                                   np.asarray(getattr(jend, k)), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_windowed_plan_matches_jax():
    s = _setup()
    jl, tl = _pair(s)
    jp, tp = jl.plan, tl.plan
    assert (tp.num_windows, tp.wlen, tp.n_rows, tp.conflict_free) == (
        jp.num_windows, jp.wlen, jp.n_rows, jp.conflict_free)
    assert tp.num_windows == 3 and tp.conflict_free
    np.testing.assert_array_equal(tp.color, jp.color)
    np.testing.assert_array_equal(tp.unobserved, jp.unobserved)
    for a, b in zip(tp.ids + tp.vals, jp.ids + jp.vals):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(tp.bins) == len(jp.bins)
    for tb_, jb_ in zip(tp.bins, jp.bins):
        assert len(tb_) == len(jb_)
        for a, b in zip(tb_, jb_):
            assert a.L == b.L
            for k in ("cols", "group", "sx2"):
                assert getattr(a, k).dtype == getattr(b, k).dtype, k
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            for w in range(tp.num_windows):
                np.testing.assert_array_equal(a.rows[w], b.rows[w])
                np.testing.assert_array_equal(a.x[w], b.x[w])
    assert tl.cfg.factor_block == jl.cfg.factor_block == 4  # K = 4: auto


def test_window_count_and_factor_block_rules():
    assert tvw.num_windows_for(2_000_044, 8_388_608) == 4
    assert tvw.num_windows_for(100, None) == 1
    for K, fb, want in ((20, 0, 4), (20, 3, 4), (9, 0, 3), (10, 4, 2),
                        (7, 0, 1), (20, 5, 5), (0, 0, 0)):
        cfg = FMConfig(num_attributes=3, num_factor=K, factor_block=fb)
        assert tvw.auto_factor_block(cfg).factor_block == want, (K, fb)


@pytest.mark.parametrize("factor_block", [1, 2])
def test_windowed_matches_jax_and_resident(factor_block):
    s = _setup(factor_block=factor_block)
    jl, tl = _pair(s)
    jend, jh, tend, th, init = _run_both(jl, tl, 4)
    _assert_match(jend, jh, tend, th, ("rmse", "mae", "train_rmse"))
    D = s["D"]
    res = VBLearner(s["tcfg"], SparseDataset.from_coo(s["tr"], D),
                    SparseDataset.from_coo(s["te"], D), s["tmeta"],
                    device="cpu", write_files=False)
    params = {k: getattr(init, k) for k in PARAMS}
    _, rh = res.run(res.state_from_params(params), num_iter=4, verbose=False)
    for a, b in zip(rh, th):
        np.testing.assert_allclose(b["rmse"], a["rmse"], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(b["free_energy"], a["free_energy"],
                                   rtol=2e-4)


def test_windowed_classification_matches_jax():
    s = _setup(K=3, task=1, factor_block=1)
    jl, tl = _pair(s, num_windows=2)
    jend, jh, tend, th, _ = _run_both(jl, tl, 3)
    _assert_match(jend, jh, tend, th, ("accuracy", "loglik"))
    assert th[-1]["accuracy"] > 0.6


def test_windowed_from_binary_reader_matches_jax(tmp_path):
    """Through the reference binary format: both packages' readers stream
    the windows of tr.x/tr.y."""
    s = _setup(factor_block=2)
    prefix = str(tmp_path / "tr")
    save_coo_binary(prefix, s["tr"])
    jl, tl = _pair(s, src=(JReader(prefix + ".x", prefix + ".y"),
                           BinaryChunkReader(prefix + ".x", prefix + ".y")))
    assert tl.train_n == s["tr"].num_rows
    _assert_match(*_run_both(jl, tl, 3)[:4], ("rmse", "mae", "train_rmse"))


# ---- the twins of the window-accumulating modes ---------------------------

def _bucket_case(seed=0, N=64, F=3, D=12, C=5, L=6):
    g = torch.Generator().manual_seed(seed)
    return dict(
        rows=torch.randint(0, N, (C, L), generator=g, dtype=torch.int32),
        x=torch.randn(C, L, generator=g),
        cols=torch.arange(1, 1 + 2 * C, 2, dtype=torch.int32),
        group=torch.randint(0, 2, (C,), generator=g, dtype=torch.int32),
        e=torch.randn(N, generator=g), q=torch.randn(N, F, generator=g),
        tq=torch.rand(N, F, generator=g), mu=torch.randn(D, F, generator=g),
        sig=torch.rand(D, F, generator=g) + 0.1,
        sv=torch.rand(2, F, generator=g) + 0.5, alpha=torch.tensor(1.3),
        F=F, D=D)


def _ptab(c):
    F = c["F"]
    p = torch.zeros(c["D"], 5 * F)
    p[:, :F], p[:, F:2 * F] = c["mu"], c["sig"]
    return p


def test_x13a_twin_one_window_is_k3():
    c = _bucket_case()
    out = []
    for windowed in (False, True):
        mu, sig, p = c["mu"].clone(), c["sig"].clone(), _ptab(c)
        nans = torch.zeros(2, dtype=torch.int32)
        if windowed:
            acc = torch.full((5, 2 * c["F"]), float("nan"))
            kv.vb_col_stats_window(c["rows"], c["x"], c["cols"], c["group"],
                                   c["e"], c["q"], c["tq"], p, mu, sig,
                                   c["sv"], c["alpha"], nans, acc, True, True)
        else:
            kv.vb_col_stats_update(c["rows"], c["x"], c["cols"], c["group"],
                                   torch.zeros(5), c["e"], c["q"], c["tq"], p,
                                   mu, sig, c["sv"], c["alpha"], None, nans)
        out.append((mu, sig, p, nans))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_x13a_twin_accumulates_in_window_order():
    """Three windows: acc holds part0, then part0 + part1; the last window's
    update is K3's closed form on (part0 + part1) + part2."""
    cases = [_bucket_case(seed=s) for s in (1, 2, 3)]
    c0 = cases[0]
    F = c0["F"]
    mu, sig, p = c0["mu"].clone(), c0["sig"].clone(), _ptab(c0)
    nans = torch.zeros(2, dtype=torch.int32)
    acc = torch.empty(5, 2 * F)
    parts = []
    for w, c in enumerate(cases):
        vm, vs, _ = kv._col_sums(c["rows"], c["x"], c0["cols"], c["e"],
                                 c["q"], c["tq"], p, F)
        parts.append(torch.cat([vm, vs], 1))
        kv.vb_col_stats_window(c["rows"], c["x"], c0["cols"], c0["group"],
                               c["e"], c["q"], c["tq"], p, mu, sig, c0["sv"],
                               c0["alpha"], nans, acc, w == 0, w == 2)
        if w == 0:
            assert torch.equal(acc, parts[0])
        if w == 1:
            assert torch.equal(acc, parts[0] + parts[1])
            assert torch.equal(mu, c0["mu"])  # no update before the last
    tot = (parts[0] + parts[1]) + parts[2]
    mu2, sig2, p2 = c0["mu"].clone(), c0["sig"].clone(), _ptab(c0)
    nans2 = torch.zeros(2, dtype=torch.int32)
    kv._col_update(tot[:, :F], tot[:, F:], c0["cols"], c0["group"], p2, mu2,
                   sig2, c0["sv"], c0["alpha"], nans2)
    for a, b in ((mu, mu2), (sig, sig2), (p, p2), (nans, nans2)):
        assert torch.equal(a, b)
    assert not torch.equal(mu, c0["mu"])


def _w_bin(c, n_buckets=2):
    """A bin of two windowed buckets over c's rows (the global sx2 larger
    than one window's, as it is)."""
    out = []
    for j in range(n_buckets):
        C = 3
        out.append(tvw.WindowBlock(
            rows=c["rows"][:C] if j == 0 else c["rows"][C:C + 2],
            x=c["x"][:C] if j == 0 else c["x"][C:C + 2],
            cols=torch.tensor([0, 4, 8] if j == 0 else [2, 9],
                              dtype=torch.int32),
            group=torch.tensor([0, 1, 1] if j == 0 else [1, 0],
                               dtype=torch.int32),
            sx2=torch.tensor([3.5, 1.0, 2.0] if j == 0 else [0.5, 4.0])))
    return out


def test_x13b_twin_one_window_is_k5():
    c = _bucket_case()
    D = c["D"]
    sigma_w = torch.tensor([0.7, 1.4])
    out = []
    for windowed in (False, True):
        mu_w, sig_w = torch.linspace(-1, 1, D), torch.full((D,), 0.02)
        dtab, bad = torch.zeros(D, 2), torch.zeros(4, dtype=torch.int32)
        bins = _w_bin(c)
        if windowed:
            kw.w_bin_update_window(bins, c["e"], mu_w, sig_w, sigma_w,
                                   c["alpha"], dtab, bad,
                                   torch.full((D,), float("nan")), True, True)
        else:
            kw.w_bin_update_plain(bins, c["e"], mu_w, sig_w, sigma_w,
                                  c["alpha"], dtab, bad)
        out.append((mu_w, sig_w, dtab, bad))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_x13b_twin_accumulates_in_window_order():
    cases = [_bucket_case(seed=s) for s in (4, 5, 6)]
    D = cases[0]["D"]
    sigma_w = torch.tensor([0.7, 1.4])
    mu_w, sig_w = torch.linspace(-1, 1, D), torch.full((D,), 0.02)
    dtab, bad = torch.zeros(D, 2), torch.zeros(4, dtype=torch.int32)
    acc = torch.zeros(D)
    tot = torch.zeros(D)
    for w, c in enumerate(cases):
        bins = _w_bin(c)
        for b in bins:
            part = (b.x * c["e"][b.rows.long()]).sum(1)
            cl = b.cols.long()
            tot[cl] = part if w == 0 else tot[cl] + part
        kw.w_bin_update_window(bins, c["e"], mu_w, sig_w, sigma_w,
                               cases[0]["alpha"], dtab, bad, acc, w == 0,
                               w == 2)
        if w < 2:
            assert torch.equal(acc, tot)
            assert not dtab.any()
    mu2, sig2 = torch.linspace(-1, 1, D), torch.full((D,), 0.02)
    dtab2, bad2 = torch.zeros(D, 2), torch.zeros(4, dtype=torch.int32)
    for b in _w_bin(cases[0]):
        kw._vb_w_close(tot[b.cols.long()], b.cols, b.group, b.sx2, mu2, sig2,
                       sigma_w, cases[0]["alpha"], dtab2, bad2)
    for a, b in ((mu_w, mu2), (sig_w, sig2), (dtab, dtab2), (bad, bad2)):
        assert torch.equal(a, b)


def test_build_qt_writes_into_views():
    """K2 with ``out``: a window's rows of the resident caches, the rest
    untouched."""
    g = torch.Generator().manual_seed(0)
    ptab = torch.randn(7, 10, generator=g)
    ids = torch.randint(0, 7, (5, 2), generator=g, dtype=torch.int32)
    vals = torch.randn(5, 2, generator=g)
    caches = [torch.full((12, 2), 9.0) for _ in range(3)]
    kv.vb_build_qt(ptab, 2, ids, vals, out=tuple(c[4:9] for c in caches))
    for c, want in zip(caches, kv.vb_build_qt_plain(ptab, 2, ids, vals)):
        assert torch.equal(c[4:9], want)
        assert (c[:4] == 9).all() and (c[9:] == 9).all()


def test_windowed_k0_and_no_linear_term():
    """K = 0 (w alone) and k1 off run, finite, one bin's X13b skipped."""
    for kw_ in (dict(K=0), dict(K=2, k1=False)):
        s = _setup(num_rows=2500, num_users=10, num_items=8, **kw_)
        D = s["D"]
        tl = tvw.WindowedVBLearner(
            s["tcfg"], SparseDataset.from_coo(s["tr"], D),
            SparseDataset.from_coo(s["te"], D), s["tmeta"], device="cpu",
            num_windows=2, write_files=False)
        assert tl.num_windows == 2
        _, h = tl.run(num_iter=2, verbose=False)
        assert np.isfinite([x["free_energy"] for x in h]).all()
