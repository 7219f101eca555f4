"""Out-of-core Gibbs MCMC and ALS in the port (``learners/mcmc_windowed.py``:
the CPU twins of K1a, X14b and the w patch, X8d, X14a and X8b, the rows and
buckets streamed window by window) against the JAX package's
``WindowedMCMCLearner``/``WindowedALSLearner``, both started from the JAX
learner's init (``utils.convert.mcmc_state_from_jax``, whose e is padded to
the windows' rows), and against the port's resident learners.  Gibbs
replays the JAX key chain (``JaxWindowKeyDraws``: test_torch_mcmc.py's
``JaxKeyDraws``, and the windowed probit draw's one split with a fold-in a
window).

Data: test_mcmc_windowed.py's (3,000 ratings of 40 x 30, K = 4, factor
block 2, 3 windows).  Tolerances, test_torch_mcmc.py's:
  * sweeps against JAX: rtol 1e-4 / atol 5e-5 on w0, w, v and e; rtol
    1e-5 / atol 1e-6 on alpha and the four hyperparameter arrays; the
    records rtol 1e-5; counters equal; the key chains equal;
  * against the port's resident learner at the same blocked factor_block
    and draws: the JAX test's own (test_mcmc_windowed.py:51-56), rmse
    rtol 5e-4 / atol 5e-5, alpha rtol 5e-3 (the window axis splits each
    column's sums);
  * the twins of X14a and X14b: one window equals X8a's exact mode and
    X8c bit for bit; several windows equal the window sums added in window
    order bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbfm_tpu.cli import main as jax_main
from svbfm_tpu.data.binary import save_coo_binary
from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.stream import BinaryChunkReader as JReader
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import mcmc_windowed as jmw
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu_torch import cli
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.libfm_text import save_libfm_text
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.stream import BinaryChunkReader
from svbfm_tpu_torch.kernels import mcmc_sweep as km
from svbfm_tpu_torch.kernels import vb_sweep as kv
from svbfm_tpu_torch.kernels import w_sweep as kw
from svbfm_tpu_torch.learners import mcmc as tm
from svbfm_tpu_torch.learners import mcmc_windowed as tmw
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.draws import host_draws
from svbfm_tpu_torch.learners.vb_windowed import WindowBlock
from svbfm_tpu_torch.models.fm import init_fm_params
from svbfm_tpu_torch.utils.convert import mcmc_state_from_jax

from test_torch_mcmc import HYPER, PARAMS, JaxKeyDraws

CLS = {"als": "WindowedALSLearner", "gibbs": "WindowedMCMCLearner"}


class JaxWindowKeyDraws(JaxKeyDraws):
    """JaxKeyDraws with the windowed probit draw (mcmc_windowed.py:
    499-516): one split, then each window's uniforms from the sub-key
    folded with the window's index; a split with no numbers under ALS."""

    def window_uniform(self, windows, length, lo, hi):
        sub = self._sub()
        return torch.cat([torch.tensor(np.asarray(jax.random.uniform(
            jax.random.fold_in(sub, w), (length,), jnp.float32, lo, hi)))
            for w in range(windows)])


def _setup(num_rows=3000, num_users=40, num_items=30, K=4, task=0, **kw):
    """test_mcmc_windowed.py's data and config, in both packages."""
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


def _pair(s, kind, num_windows=3, src=None):
    D = s["D"]
    jsrc, tsrc = src if src is not None else (
        JDataset.from_coo(s["tr"], D), SparseDataset.from_coo(s["tr"], D))
    jl = getattr(jmw, CLS[kind])(s["jcfg"], jsrc,
                                 JDataset.from_coo(s["te"], D), s["jmeta"],
                                 num_windows=num_windows, write_files=False)
    tl = getattr(tmw, CLS[kind])(s["tcfg"], tsrc,
                                 SparseDataset.from_coo(s["te"], D),
                                 s["tmeta"], device="cpu",
                                 num_windows=num_windows, write_files=False)
    return jl, tl


def _sweeps_match(jl, tl, n_sweeps, metrics):
    """n sweeps of both learners from the JAX init, each with its eval
    (and, under classification, its latent update): states, records,
    counters and key chains after every sweep."""
    js = jl.init_state()
    js_np = jax.device_get(js)  # the JAX sweep donates its state
    ts = mcmc_state_from_jax(js_np, "cpu",
                             JaxWindowKeyDraws(jnp.asarray(js_np.key)))
    assert ts.e.shape[0] == tl.n_pad == jl.n_pad
    n_test = jl.test_row.target.shape[0]
    jpa, jpb = jnp.zeros(n_test), jnp.zeros(n_test)
    tpa, tpb = torch.zeros(n_test), torch.zeros(n_test)
    for it in range(n_sweeps):
        js, jpa, jpb, jrec = jl._iteration(js, jpa, jpb, it)
        js, jrec = jax.device_get((js, jrec))
        ts, tnans = tl.step(ts)
        trec = tl._unpack(tl._eval(ts, tnans, tpa, tpb, it).numpy())
        for k in PARAMS + HYPER:
            tol = dict(rtol=1e-4, atol=5e-5) if k in PARAMS else dict(
                rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(getattr(ts, k).numpy(),
                                       np.asarray(getattr(js, k)),
                                       err_msg=f"{k} sweep {it}", **tol)
        for k in metrics:
            np.testing.assert_allclose(trec[k], float(jrec[k]), rtol=1e-5,
                                       err_msg=f"{k} sweep {it}")
        for fam in tm.NAN_FAMILIES:
            for c in ("nan", "inf"):
                assert trec[f"{c}_{fam}"] == int(jrec[f"{c}_{fam}"]), fam
        np.testing.assert_array_equal(np.asarray(ts.draws.key),
                                      np.asarray(js.key))
    return trec


REGRESSION = ("rmse", "rmse_this", "rmse_all_but5", "mae")


def test_windowed_plan_matches_jax():
    s = _setup(factor_block=2)
    jl, tl = _pair(s, "als")
    jp, tp = jl.plan, tl.plan
    assert (tp.num_windows, tp.wlen, tp.n_rows) == (jp.num_windows, jp.wlen,
                                                    jp.n_rows)
    assert (tp.num_windows, tp.wlen) == (3, 1024)
    for a, b in zip(tp.ids + tp.vals, jp.ids + jp.vals):
        np.testing.assert_array_equal(a, b)
    for tb_, jb_ in zip(tp.bins, jp.bins):
        for a, b in zip(tb_, jb_):
            np.testing.assert_array_equal(a.cols, b.cols)
            for w in range(3):
                np.testing.assert_array_equal(a.rows[w], b.rows[w])
    assert tl.F == jl.F == 2 and tl.n_pad == jl.n_pad


@pytest.mark.parametrize("factor_block", [1, 2])
@pytest.mark.parametrize("kind", ["als", "gibbs"])
def test_windowed_matches_jax(kind, factor_block):
    """ALS, and Gibbs with the JAX key chain replayed, 4 sweeps."""
    s = _setup(factor_block=factor_block, regw=0.05, regv=0.05)
    jl, tl = _pair(s, kind)
    assert tl.num_windows == 3 and tl.plan.conflict_free
    _sweeps_match(jl, tl, 4, REGRESSION)


@pytest.mark.parametrize("kind", ["als", "gibbs"])
def test_windowed_matches_resident(kind):
    """The windowed learner against the port's resident one at the same
    factor_block (2, blocked), from one init and one host-table draw
    source: the windows only split each column's sums."""
    s = _setup(factor_block=2)
    D = s["D"]
    args = (SparseDataset.from_coo(s["tr"], D),
            SparseDataset.from_coo(s["te"], D), s["tmeta"])
    res = (tm.ALSLearner if kind == "als" else tm.MCMCLearner)(
        s["tcfg"], *args, device="cpu", write_files=False)
    win = getattr(tmw, CLS[kind])(s["tcfg"], *args, device="cpu",
                                  num_windows=3, write_files=False)
    p = init_fm_params(torch.Generator().manual_seed(3), D, 4,
                       init_stdev=0.1, init_w_normal=True)
    hists = [lr.run(lr.state_from_params(p.w0, p.w, p.v,
                                         host_draws(5, "cpu")),
                    num_iter=4, verbose=False)[1] for lr in (res, win)]
    for r_ref, r_w in zip(*hists):
        for k in ("rmse", "rmse_this"):
            np.testing.assert_allclose(r_w[k], r_ref[k], rtol=5e-4,
                                       atol=5e-5, err_msg=k)
        np.testing.assert_allclose(r_w["alpha"], r_ref["alpha"], rtol=5e-3)


@pytest.mark.parametrize("kind", ["als", "gibbs"])
def test_windowed_from_binary_reader_matches_jax(kind, tmp_path):
    """Through the reference binary format: both packages' readers stream
    the windows of tr.x/tr.y."""
    s = _setup(factor_block=2)
    prefix = str(tmp_path / "tr")
    save_coo_binary(prefix, s["tr"])
    jl, tl = _pair(s, kind, src=(JReader(prefix + ".x", prefix + ".y"),
                                 BinaryChunkReader(prefix + ".x",
                                                   prefix + ".y")))
    assert tl.train_n == s["tr"].num_rows
    _sweeps_match(jl, tl, 3, REGRESSION)


@pytest.mark.parametrize("kind", ["als", "gibbs"])
def test_windowed_classification_matches_jax(kind):
    """-task c (test_mcmc_windowed.py's: K = 3, factor_block 1, 2 windows):
    ALS, and Gibbs with the windows' probit uniforms replayed."""
    s = _setup(K=3, task=1, factor_block=1)
    jl, tl = _pair(s, kind, num_windows=2)
    assert tl.num_windows == 2
    _sweeps_match(jl, tl, 3, ("accuracy", "loglik"))


def test_windowed_classification_learns():
    """test_mcmc_windowed.py:64-72 on the port: 6 Gibbs iterations from the
    default draw source reach accuracy > 0.6 with a finite loglik."""
    s = _setup(K=3, task=1, factor_block=1)
    D = s["D"]
    tl = tmw.WindowedMCMCLearner(s["tcfg"], SparseDataset.from_coo(s["tr"], D),
                                 SparseDataset.from_coo(s["te"], D),
                                 s["tmeta"], device="cpu", num_windows=2,
                                 write_files=False)
    _, hist = tl.run(num_iter=6, verbose=False)
    assert hist[-1]["accuracy"] > 0.6
    assert np.isfinite([h["loglik"] for h in hist]).all()


def test_windowed_k0_and_no_linear_term():
    """K = 0 (w alone) and k1 off run, finite, against JAX."""
    for kw_ in (dict(K=0, factor_block=1), dict(K=2, k1=False,
                                                factor_block=2)):
        s = _setup(num_rows=2500, num_users=10, num_items=8, **kw_)
        jl, tl = _pair(s, "als", num_windows=2)
        assert tl.num_windows == 2
        _sweeps_match(jl, tl, 2, REGRESSION)


def test_windowed_refuses_factor_jacobi_and_wide_blocks():
    s = _setup()
    D = s["D"]
    args = (SparseDataset.from_coo(s["tr"], D),
            SparseDataset.from_coo(s["te"], D), s["tmeta"])
    with pytest.raises(ValueError, match="draws exactly"):
        tmw.WindowedALSLearner(dataclasses.replace(
            s["tcfg"], mcmc_factor_jacobi=True), *args, device="cpu")
    with pytest.raises(ValueError, match="wider than"):
        tmw.WindowedALSLearner(dataclasses.replace(
            s["tcfg"], num_factor=320, factor_block=320), *args,
            device="cpu")


# ---- the twins of the window-accumulating modes ---------------------------

def _bucket_case(seed=0, N=64, F=3, D=12, C=5, L=6):
    g = torch.Generator().manual_seed(seed)
    return dict(
        rows=torch.randint(0, N, (C, L), generator=g, dtype=torch.int32),
        x=torch.randn(C, L, generator=g),
        cols=torch.arange(1, 1 + 2 * C, 2, dtype=torch.int32),
        group=torch.randint(0, 2, (C,), generator=g, dtype=torch.int32),
        e=torch.randn(N, generator=g), q=torch.randn(N, F, generator=g),
        v=torch.randn(D, F, generator=g), mu=torch.randn(2, F, generator=g),
        lam=torch.rand(2, F, generator=g) + 0.5,
        z=torch.randn(F, D, generator=g), alpha=torch.tensor(1.3), F=F, D=D)


def _ptab(c):
    F = c["F"]
    p = torch.zeros(c["D"], 2 * F)
    p[:, :F] = c["v"]
    return p


def _x14a(c, fn, *extra):
    """(v_t, ptab, nans) after ``fn`` on case ``c``'s bucket."""
    v_t, ptab = c["v"].clone(), _ptab(c)
    nans = torch.zeros(2, dtype=torch.int32)
    fn(c["rows"], c["x"], c["cols"], c["group"], c["e"], c["q"], ptab, v_t,
       c["mu"], c["lam"], c["alpha"], c["z"], *extra)
    return v_t, ptab, nans


@pytest.mark.parametrize("F", [1, 3, 4])
def test_x14a_twin_one_window_is_x8a(F):
    c = _bucket_case(F=F)
    v1, p1 = c["v"].clone(), _ptab(c)
    n1 = torch.zeros(2, dtype=torch.int32)
    km.mcmc_col_draw(c["rows"], c["x"], c["cols"], c["group"], c["e"],
                     c["q"], p1, v1, c["mu"], c["lam"], c["alpha"], c["z"],
                     True, n1)
    v2, p2 = c["v"].clone(), _ptab(c)
    n2 = torch.zeros(2, dtype=torch.int32)
    acc = torch.full((5, km.col_outputs(F)), float("nan"))
    km.mcmc_col_draw_window(c["rows"], c["x"], c["cols"], c["group"], c["e"],
                            c["q"], p2, v2, c["mu"], c["lam"], c["alpha"],
                            c["z"], n2, acc, True, True)
    for a, b in ((v1, v2), (p1, p2), (n1, n2)):
        assert torch.equal(a, b)
    assert not torch.equal(v1, c["v"])
    assert torch.isnan(acc).all()  # the last window leaves acc alone


@pytest.mark.parametrize("F", [1, 3])
def test_x14a_twin_accumulates_in_window_order(F):
    """Three windows: acc holds part0, then part0 + part1; the last window
    draws from (part0 + part1) + part2, the packed sums' layout (s0 | sh2 |
    M_fg, f < g in row order)."""
    cases = [_bucket_case(seed=s, F=F) for s in (1, 2, 3)]
    c0 = cases[0]
    v_t, ptab = c0["v"].clone(), _ptab(c0)
    nans = torch.zeros(2, dtype=torch.int32)
    acc = torch.empty(5, km.col_outputs(F))
    parts = []
    for w, c in enumerate(cases):
        s0, sh2, m_x = km._col_sums(c["rows"], c["x"], c0["cols"], c["e"],
                                    c["q"], ptab, F, True)
        parts.append(km.pack_sums(s0, sh2, m_x))
        if F == 3:
            assert torch.equal(parts[-1][:, 2 * F:],
                               torch.stack([m_x[0, 1], m_x[0, 2],
                                            m_x[1, 2]], 1))
        km.mcmc_col_draw_window(c["rows"], c["x"], c0["cols"], c0["group"],
                                c["e"], c["q"], ptab, v_t, c0["mu"],
                                c0["lam"], c0["alpha"], c0["z"], nans, acc,
                                w == 0, w == 2)
        if w == 0:
            assert torch.equal(acc, parts[0])
        if w == 1:
            assert torch.equal(acc, parts[0] + parts[1])
            assert torch.equal(v_t, c0["v"])  # no draw before the last
    tot = (parts[0] + parts[1]) + parts[2]
    v2, p2 = c0["v"].clone(), _ptab(c0)
    n2 = torch.zeros(2, dtype=torch.int32)
    km._col_draw(*km.unpack_sums(tot), c0["cols"], c0["group"], p2, v2,
                 c0["mu"], c0["lam"], c0["alpha"], c0["z"], n2)
    for a, b in ((v_t, v2), (ptab, p2), (nans, n2)):
        assert torch.equal(a, b)
    assert not torch.equal(v_t, c0["v"])


def _w_bin(c):
    """A bin of two windowed buckets over c's rows."""
    return [WindowBlock(rows=c["rows"][:3], x=c["x"][:3],
                        cols=torch.tensor([0, 4, 8], dtype=torch.int32),
                        group=torch.tensor([0, 1, 1], dtype=torch.int32),
                        sx2=torch.tensor([3.5, 1.0, 2.0])),
            WindowBlock(rows=c["rows"][3:5], x=c["x"][3:5],
                        cols=torch.tensor([2, 9], dtype=torch.int32),
                        group=torch.tensor([1, 0], dtype=torch.int32),
                        sx2=torch.tensor([0.5, 4.0]))]


W_MU, W_LAMBDA = torch.tensor([0.1, -0.2]), torch.tensor([0.7, 1.4])


@pytest.mark.parametrize("noise", [True, False])
def test_x14b_twin_one_window_is_x8c(noise):
    c = _bucket_case()
    D = c["D"]
    z = torch.randn(D, generator=torch.Generator().manual_seed(9)) \
        if noise else None
    out = []
    for windowed in (False, True):
        w, dtab = torch.linspace(-1, 1, D), torch.zeros(D, 2)
        bad = torch.zeros(4, dtype=torch.int32)
        if windowed:
            kw.mcmc_w_bin_draw_window(_w_bin(c), c["e"], w, W_MU, W_LAMBDA,
                                      c["alpha"], z, dtab, bad,
                                      torch.full((D,), float("nan")), True,
                                      True)
        else:
            kw.mcmc_w_bin_draw(_w_bin(c), c["e"], w, W_MU, W_LAMBDA,
                               c["alpha"], z, dtab, bad)
        out.append((w, dtab, bad))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert out[0][1].any()


def test_x14b_twin_accumulates_in_window_order():
    cases = [_bucket_case(seed=s) for s in (4, 5, 6)]
    D = cases[0]["D"]
    z = torch.randn(D, generator=torch.Generator().manual_seed(9))
    w, dtab = torch.linspace(-1, 1, D), torch.zeros(D, 2)
    bad = torch.zeros(4, dtype=torch.int32)
    acc, tot = torch.zeros(D), torch.zeros(D)
    for wi, c in enumerate(cases):
        for b in _w_bin(c):
            part = (b.x * c["e"][b.rows.long()]).sum(1)
            cl = b.cols.long()
            tot[cl] = part if wi == 0 else tot[cl] + part
        kw.mcmc_w_bin_draw_window(_w_bin(c), c["e"], w, W_MU, W_LAMBDA,
                                  cases[0]["alpha"], z, dtab, bad, acc,
                                  wi == 0, wi == 2)
        if wi < 2:
            assert torch.equal(acc, tot)
            assert not dtab.any()
    w2, dtab2 = torch.linspace(-1, 1, D), torch.zeros(D, 2)
    bad2 = torch.zeros(4, dtype=torch.int32)
    for b in _w_bin(cases[0]):
        kw._mcmc_w_close(tot[b.cols.long()], b.cols, b.group, b.sx2, w2,
                         W_MU, W_LAMBDA, cases[0]["alpha"], z, dtab2, bad2)
    for a, b in ((w, w2), (dtab, dtab2), (bad, bad2)):
        assert torch.equal(a, b)


def test_build_q_writes_into_views():
    """X8d with ``out``: a window's rows of the resident cache, the rest
    untouched; the same values from a starting q."""
    g = torch.Generator().manual_seed(0)
    ptab = torch.randn(7, 4, generator=g)
    ids = torch.randint(0, 7, (5, 2), generator=g, dtype=torch.int32)
    vals = torch.randn(5, 2, generator=g)
    q0 = torch.randn(5, 2, generator=g)
    for start in (None, q0):
        cache = torch.full((12, 2), 9.0)
        got = kv.build_q(ptab, 2, ids, vals, start, out=cache[4:9])
        assert got.data_ptr() == cache[4:9].data_ptr()
        assert torch.equal(cache[4:9], kv.build_q_plain(ptab, 2, ids, vals,
                                                        start))
        assert (cache[:4] == 9).all() and (cache[9:] == 9).all()


# ---- the CLI ----------------------------------------------------------------

@pytest.fixture
def files(tmp_path):
    coo = make_movielens_like(num_users=30, num_items=20, num_ratings=600,
                              seed=1)
    tr, te = train_test_split(coo, 0.2, seed=2)
    save_libfm_text(str(tmp_path / "tr.libfm"), tr)
    save_libfm_text(str(tmp_path / "te.libfm"), te)
    return tmp_path, te


def _args(d, method, *extra):
    return ["-task", "r", "-train", str(d / "tr.libfm"), "-test",
            str(d / "te.libfm"), "-dim", "1,1,4", "-iter", "2", "-method",
            method, *extra]


@pytest.mark.parametrize("method", ["mcmc", "als"])
def test_cli_cache_size_runs_windowed_like_the_jax_cli(files, method,
                                                       monkeypatch, capsys):
    """-method mcmc|als -cache_size with a binary train file: the windowed
    learner streams it (the port never loads it whole), from the JAX init
    (Gibbs with the JAX key chain), and its -out predictions equal the JAX
    CLI's windowed learner's on the same files."""
    import os

    from svbfm_tpu_torch.data import binary as tbin
    from test_torch_cli import _binary_files, _run_in, _start_from_jax_inits

    d, te = files
    _binary_files(d)
    _start_from_jax_inits(monkeypatch)
    made = []
    real_init = tmw.WindowedMCMCLearner.__init__

    def spy(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)
    monkeypatch.setattr(tmw.WindowedMCMCLearner, "__init__", spy)
    loaded = []
    real = tbin.load_coo_binary
    monkeypatch.setattr(tbin, "load_coo_binary",
                        lambda p: loaded.append(p) or real(p))
    argv = _args(d, method, "-cache_size", "4000", "-regular", "0.1",
                 "-out", "pred.txt")
    ours = _run_in(d / "torch", cli.main, argv + ["-device", "cpu"],
                   monkeypatch)
    out = capsys.readouterr().out
    assert loaded == [str(d / "te.libfm")]  # the train file streamed
    assert len(made) == 1 and made[0].cfg.do_sample == (method == "mcmc")
    theirs = _run_in(d / "jax", jax_main, argv, monkeypatch)
    assert ours == theirs
    pred = np.loadtxt(d / "torch" / "pred.txt")
    assert pred.shape == (te.num_rows,)
    np.testing.assert_allclose(pred, np.loadtxt(d / "jax" / "pred.txt"),
                               rtol=1e-4, atol=1e-6)
    assert "Final\tTest=" in out and os.path.exists(d / "torch" /
                                                    "v_file.txt")


@pytest.mark.parametrize("method,extra,message", [
    ("mcmc", ["-num_eval_cases", "5"],
     "-num_eval_cases is not supported with -cache_size"),
    ("als", ["-checkpoint", "ck"], "item 12"),
    ("mcmc", ["-bins", "greedy"], "-bins is not read"),
    ("als", ["-factor_jacobi", "1"], "windowed Gibbs/ALS draws exactly"),
    ("mcmc", ["-relation", "rel"], "not read by the block-structure"),
])
def test_cli_cache_size_refusals(files, method, extra, message):
    """The JAX CLI's refusals with -cache_size (-num_eval_cases,
    -checkpoint), the port's of -bins, and -factor_jacobi (the windowed
    draws are exact) and -relation (the block-structure rows stay
    resident)."""
    d, _ = files
    with pytest.raises(SystemExit) as ei:
        cli.main(_args(d, method, "-cache_size", "1000", *extra, "-device",
                       "cpu"))
    assert message in str(ei.value.code)
