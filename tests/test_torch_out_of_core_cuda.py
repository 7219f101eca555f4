"""The out-of-core paths on the card: X13a and X13b (K3's and K5's
window-accumulating modes) and X14a and X14b (X8a's and X8c's) against
their plain twins, and the streamed OVB and sgd_online and the windowed
batch VB, Gibbs and ALS against the CPU.

These need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode); without
a GPU they skip.  On the card:
    python -m pytest --noconftest -m cuda tests/test_torch_out_of_core_cuda.py

Tolerances: a kernel against its twin, ``chip_smoke.compare`` (max |kernel
- twin| <= 1e-4 max(1, max |twin|) where the twin is finite, the same
NaN/Inf pattern where it is not); two launches on the same inputs, the
same bits; a learner on the card against the CPU, rtol 1e-5 on the
trajectories.
"""

import dataclasses

import numpy as np
import pytest
import torch

from svbfm_tpu_torch.data.binary import save_coo_binary
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.stream import BinaryChunkReader
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.learners.base import FMConfig

pytestmark = pytest.mark.cuda

RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _cases(cuda):
    import chip_smoke

    for s in chip_smoke.ragged_win_tensors(cuda):
        cases = chip_smoke.make_cases(s)
        for name in ("vb_col_stats_window", "w_col_window"):
            assert cases[name]
            for case in cases[name]:
                yield name, case


def _mcmc_cases(cuda):
    import chip_smoke

    for s in chip_smoke.ragged_mwin_tensors(cuda):
        cases = chip_smoke.make_cases(s)
        for name in ("mcmc_col_draw_window", "mcmc_w_window"):
            assert cases[name]
            for case in cases[name]:
                yield name, case


def test_mcmc_window_modes_match_twins(cuda):
    """X14a at F = 3, 1, 2 and 4 (the lanes form at F >= 2) and X14b with
    and without noise, every window
    in order and single launches, with a NaN e row, NaN group lambdas, an
    Inf noise number, L = 1 buckets, an empty bucket, columns whose window
    holds no entry and pad rows: the kernel gives the twin's outputs, the
    accumulator and the counters included."""
    import chip_smoke

    before = {k: build.launch_counts[k]
              for k in ("mcmc_col_draw_window", "mcmc_w_window")}
    for name, (label, prepare, call, _) in _mcmc_cases(cuda):
        ok, op = call("kernel", prepare()), call("plain", prepare())
        torch.cuda.synchronize()
        chip_smoke.compare(ok, op, f"{name} ({label})")
    assert all(build.launch_counts[k] > v for k, v in before.items())


def test_mcmc_window_modes_repeat_bit_for_bit(cuda):
    for name, (label, prepare, call, _) in _mcmc_cases(cuda):
        a, b = call("kernel", prepare()), call("kernel", prepare())
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x.nan_to_num(), y.nan_to_num()), (name, label)


@pytest.mark.parametrize("F", [1, 2, 3, 4, 20])
def test_one_window_equals_the_resident_mcmc_kernels(cuda, F):
    """At one window (first and last) X14a gives X8a's exact bits (at F = 1
    its F = 1 lanes form, at F = 2-4 the lanes form, at F = 20 the block
    form) and X14b X8c's, with and without noise."""
    from svbfm_tpu_torch.kernels import mcmc_sweep as km
    from svbfm_tpu_torch.kernels import w_sweep as kw
    from svbfm_tpu_torch.learners.base import BlockData

    g = torch.Generator().manual_seed(F)
    N, D, C, L = 300, 50, 20, 40

    def r(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    rows = torch.randint(0, N, (C, L), generator=g,
                         dtype=torch.int32).to(cuda)
    x, e, q = r(C, L), r(N), r(N, F)
    cols = torch.arange(0, 2 * C, 2, dtype=torch.int32, device=cuda)
    group = (cols % 3 == 0).to(torch.int32)
    vt, mu, lam, z = r(D, F), r(2, F), r(2, F).abs() + 0.5, r(F, D)
    alpha = torch.tensor(1.2, device=cuda)
    for noise in (z, None):
        outs = []
        for windowed in (False, True):
            v, ptab = vt.clone(), torch.cat([vt, torch.zeros_like(vt)], 1)
            nans = torch.zeros(2, dtype=torch.int32, device=cuda)
            if windowed:
                km.mcmc_col_draw_window(
                    rows, x, cols, group, e, q, ptab, v, mu, lam, alpha,
                    noise, nans, torch.empty(C, km.col_outputs(F),
                                             device=cuda), True, True)
            else:
                km.mcmc_col_draw(rows, x, cols, group, e, q, ptab, v, mu,
                                 lam, alpha, noise, True, nans)
            outs.append((v, ptab, nans))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    blk = BlockData(rows=rows, x=x, cols=cols, group=group,
                    sx2=(x * x).sum(1), cnt=torch.zeros(C, device=cuda),
                    col_count=torch.zeros(C, device=cuda))
    w_mu, w_lambda = r(2), r(2).abs() + 0.5
    for noise in (r(D), None):
        outs = []
        for windowed in (False, True):
            w, dtab = vt[:, 0].clone(), torch.zeros(D, 2, device=cuda)
            bad = torch.zeros(4, dtype=torch.int32, device=cuda)
            if windowed:
                kw.mcmc_w_bin_draw_window([blk], e, w, w_mu, w_lambda, alpha,
                                          noise, dtab, bad,
                                          torch.empty(D, device=cuda), True,
                                          True)
            else:
                kw.mcmc_w_bin_draw([blk], e, w, w_mu, w_lambda, alpha, noise,
                                   dtab, bad)
            outs.append((w, dtab, bad))
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def test_window_modes_match_twins(cuda):
    """Every window in order and single launches, at F = 3, 2 and 4 (X13a
    in its lanes form), with a NaN e row, NaN group precisions, columns
    whose window holds no entry, an L = 1 bucket and pad rows: the kernel
    gives the twin's outputs, counters included."""
    import chip_smoke

    before = {k: build.launch_counts[k]
              for k in ("vb_col_stats_window", "w_col_window")}
    for name, (label, prepare, call, _) in _cases(cuda):
        ok, op = call("kernel", prepare()), call("plain", prepare())
        torch.cuda.synchronize()
        chip_smoke.compare(ok, op, f"{name} ({label})")
    assert all(build.launch_counts[k] > v for k, v in before.items())


def test_window_modes_repeat_bit_for_bit(cuda):
    for name, (label, prepare, call, _) in _cases(cuda):
        a, b = call("kernel", prepare()), call("kernel", prepare())
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x.nan_to_num(), y.nan_to_num()), (name, label)


def _x13a_one_window(cuda, g, F, L):
    """X13a at one window (first and last) against K3 on a random [20, L]
    bucket at F factors: the same bits (returns the generator and the
    bucket's tensors for X13b)."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    N, D, C = 300, 50, 20

    def r(*shape):
        return torch.randn(*shape, generator=g).to(cuda)

    rows = torch.randint(0, N, (C, L), generator=g,
                         dtype=torch.int32).to(cuda)
    x, e, q, tq = r(C, L), r(N), r(N, F), r(N, F).abs()
    cols = torch.arange(0, 2 * C, 2, dtype=torch.int32, device=cuda)
    group = (cols % 3 == 0).to(torch.int32)
    ptab = torch.zeros(D, 5 * F, device=cuda)
    ptab[:, :F], ptab[:, F:2 * F] = r(D, F), r(D, F).abs() + 0.1
    sv, alpha = r(2, F).abs() + 0.5, torch.tensor(1.2, device=cuda)
    outs = []
    for windowed in (False, True):
        mu, sig = ptab[:, :F].clone(), ptab[:, F:2 * F].clone()
        p, nans = ptab.clone(), torch.zeros(2, dtype=torch.int32,
                                            device=cuda)
        if windowed:
            kv.vb_col_stats_window(rows, x, cols, group, e, q, tq, p, mu, sig,
                                   sv, alpha, nans, torch.empty(C, 2 * F,
                                                                device=cuda),
                                   True, True)
        else:
            kv.vb_col_stats_update(rows, x, cols, group,
                                   torch.zeros(C, device=cuda), e, q, tq, p,
                                   mu, sig, sv, alpha, None, nans)
        outs.append((mu, sig, p, nans))
    for a, b in zip(*outs):
        assert torch.equal(a, b), (F, L)
    return r, rows, x, e, cols, group, alpha, D, C


def test_one_window_equals_the_resident_kernels(cuda):
    """At one window (first and last) X13a gives K3's bits and X13b K5's,
    on the card (F = 4 on a [20, 16] bucket: both in the lanes form)."""
    from svbfm_tpu_torch.kernels import w_sweep as kw
    from svbfm_tpu_torch.learners.base import BlockData

    g = torch.Generator().manual_seed(0)
    r, rows, x, e, cols, group, alpha, D, C = _x13a_one_window(cuda, g, 4,
                                                               16)
    blk = BlockData(rows=rows, x=x, cols=cols, group=group,
                    sx2=(x * x).sum(1), cnt=torch.zeros(C, device=cuda),
                    col_count=torch.zeros(C, device=cuda))
    outs = []
    for windowed in (False, True):
        g.manual_seed(1)
        mu_w, sig_w = r(D), torch.full((D,), 0.02, device=cuda)
        dtab = torch.zeros(D, 2, device=cuda)
        bad = torch.zeros(4, dtype=torch.int32, device=cuda)
        sigma_w = torch.tensor([0.5, 2.0], device=cuda)
        if windowed:
            kw.w_bin_update_window([blk], e, mu_w, sig_w, sigma_w, alpha,
                                   dtab, bad, torch.empty(D, device=cuda),
                                   True, True)
        else:
            kw.w_bin_update([blk], e, mu_w, sig_w, sigma_w, alpha, dtab, bad)
        outs.append((mu_w, sig_w, dtab, bad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("F,L", [(2, 64), (3, 40), (4, 64), (1, 128),
                                 (4, 200)])
def test_one_window_equals_the_resident_k3_forms(cuda, F, L):
    """X13a at one window gives K3's bits in the lanes form (F = 2 on the
    windowed paths' L = 64, F = 3 and 4, F = 1 at L = 128, exact mode's
    [14,128] shape) and in the block form past L = 128."""
    _x13a_one_window(cuda, torch.Generator().manual_seed(10 * F + L), F, L)


def _data(tmp_path, num_rows=6000, users=60, items=40, seed=4):
    coo = make_movielens_like(num_users=users, num_items=items,
                              num_ratings=num_rows, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    save_coo_binary(str(tmp_path / "tr"), tr)
    meta = DataMetaInfo.from_field_offsets(D, [0, users])
    cfg = FMConfig(num_attributes=D, num_factor=4, num_groups=2, seed=7,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()))
    return tr, te, D, meta, cfg, str(tmp_path / "tr")


def _reader(prefix):
    return BinaryChunkReader(prefix + ".x", prefix + ".y")


def _close(hg, hc, keys):
    for a, b in zip(hg, hc):
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)


def test_windowed_vb_gpu_matches_cpu(cuda, tmp_path):
    from svbfm_tpu_torch.learners.vb import init_vb_params
    from svbfm_tpu_torch.learners.vb_windowed import WindowedVBLearner

    tr, te, D, meta, cfg, prefix = _data(tmp_path)
    cfg = dataclasses.replace(cfg, factor_block=2)
    params = init_vb_params(torch.Generator().manual_seed(3), cfg, "cpu")
    hists = []
    for dev in (cuda, "cpu"):
        lr = WindowedVBLearner(cfg, _reader(prefix),
                               SparseDataset.from_coo(te, D), meta,
                               device=dev, num_windows=3, write_files=False)
        assert lr.num_windows == 3
        build.reset_launch_counts()
        hists.append(lr.run(lr.state_from_params(params), num_iter=2,
                            verbose=False)[1])
        if dev == cuda:
            torch.cuda.synchronize()
            for k in ("vb_col_stats_window", "w_col_window", "vb_build_qt",
                      "vb_patch_rows", "w_patch_rows"):
                assert build.launch_counts[k] > 0, k
    _close(*hists, ("rmse", "train_rmse", "free_energy"))


@pytest.mark.parametrize("kind,task", [("gibbs", 0), ("als", 0),
                                       ("gibbs", 1)])
def test_windowed_mcmc_gpu_matches_cpu(cuda, tmp_path, kind, task):
    """Windowed Gibbs (a host-table draw source) and ALS, 3 windows, factor
    block 2, 2 sweeps on the card and on the CPU, Gibbs also under -task c
    (the ratings above 3.5 the positive class; X12a over the windows'
    uniforms); X14a, X14b, X8d, X8b and the w patch launched."""
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners import mcmc_windowed as tmw
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr, te, D, meta, cfg, prefix = _data(tmp_path)
    cfg = dataclasses.replace(cfg, factor_block=2, regw=0.1, regv=0.1)
    keys = ("rmse", "rmse_this", "mae", "alpha")
    if task:
        for coo in (tr, te):
            coo.target = np.where(coo.target > 3.5, 1.0, -1.0).astype(
                np.float32)
        save_coo_binary(prefix, tr)
        cfg = dataclasses.replace(cfg, task=1, min_target=-1.0,
                                  max_target=1.0)
        keys = ("accuracy", "loglik", "alpha")
    cls = tmw.WindowedALSLearner if kind == "als" else tmw.WindowedMCMCLearner
    p0 = init_fm_params(torch.Generator().manual_seed(3), D, 4,
                        init_stdev=0.1, init_w_normal=True)
    hists = []
    for dev in (cuda, "cpu"):
        lr = cls(cfg, _reader(prefix), SparseDataset.from_coo(te, D), meta,
                 device=dev, num_windows=3, write_files=False)
        assert lr.num_windows == 3
        build.reset_launch_counts()
        hists.append(lr.run(lr.state_from_params(p0.w0, p0.w, p0.v,
                                                 host_draws(3, dev)),
                            num_iter=2, verbose=False)[1])
        if dev == cuda:
            torch.cuda.synchronize()
            for k in ("mcmc_col_draw_window", "mcmc_w_window", "build_q",
                      "mcmc_patch_rows", "w_patch_rows", "fm_scores") + (
                          ("probit_latent",) if task else ()):
                assert build.launch_counts[k] > 0, k
    _close(*hists, keys)


def test_streamed_ovb_gpu_matches_cpu(cuda, tmp_path):
    from svbfm_tpu_torch.learners.vb_online import OVBLearner, init_ovb_state

    tr, te, D, meta, cfg, prefix = _data(tmp_path)
    cfg = dataclasses.replace(cfg, num_batches=5)
    init = init_ovb_state(torch.Generator().manual_seed(3), cfg, "cpu")
    hists = []
    for dev in (cuda, "cpu"):
        lr = OVBLearner.from_reader(cfg, _reader(prefix),
                                    SparseDataset.from_coo(te, D), meta,
                                    device=dev, write_files=False)
        st = type(init)(**{f.name: getattr(init, f.name).to(dev)
                           for f in dataclasses.fields(init)})
        hists.append(lr.run(st, num_iter=2, verbose=False)[1])
    _close(*hists, ("rmse", "mae", "free_energy"))


def test_streamed_sgd_online_gpu_matches_cpu(cuda, tmp_path):
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.sgd import SGDOnlineLearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr, te, D, meta, cfg, prefix = _data(tmp_path)
    cfg = dataclasses.replace(cfg, num_batches=4, learn_rate=0.05,
                              batch_size=128)
    p0 = init_fm_params(torch.Generator().manual_seed(3), D, 4,
                        init_stdev=0.1)
    ends, hists = [], []
    for dev in (cuda, "cpu"):
        lr = SGDOnlineLearner.from_reader(cfg, _reader(prefix),
                                          SparseDataset.from_coo(te, D),
                                          meta, device=dev,
                                          write_files=False)
        st, h = lr.run(lr.state_from_params(p0.w0, p0.w, p0.v,
                                            host_draws(3, dev)),
                       num_iter=2, verbose=False)
        ends.append(st.tab.cpu())
        hists.append(h)
    _close(*hists, ("rmse", "mae"))
    assert (ends[0] - ends[1]).abs().max().item() <= 1e-5


def test_staged_feed_carries_every_array(cuda):
    """The staged feed: nested arrays of four dtypes (one empty) and a
    tensor made in upload, more keys than the ring's buffers, in key
    order, the device values the host's, each view aligned."""
    from svbfm_tpu_torch.learners.streaming import DeviceFeed

    rng = np.random.default_rng(0)

    def load(k):
        return (rng.integers(0, 9, (k + 3, 2)).astype(np.int32),
                [rng.standard_normal(k * 7 + 1).astype(np.float32),
                 np.arange(k, dtype=np.int64), np.zeros((0, 4), np.float32)])

    hosts = {}

    def remember(k):
        hosts[k] = load(k)
        return hosts[k]

    def upload(h, put):
        ids, (x, n, empty) = h
        return (put(ids), put(x), put(n), put(empty),
                put(torch.tensor([5, 6, 7], dtype=torch.int64)))

    feed = DeviceFeed(cuda, depth=2, workers=2, staged=True)
    keys = [4, 0, 7, 2, 9, 1]
    for k, out in zip(keys, feed(keys, remember, upload)):
        ids, (x, n, empty) = hosts[k]
        for t, a in zip(out[:4], (ids, x, n, empty)):
            assert t.device.type == "cuda" and t.data_ptr() % 256 == 0
            np.testing.assert_array_equal(t.cpu().numpy(), a)
        assert out[4].tolist() == [5, 6, 7]
