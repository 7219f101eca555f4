"""The hand-written CUDA kernels against their plain twins, on the card, and
the learners on the card against the CPU.

These need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode); without
a GPU they skip.  On the card:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
from svbfm_tpu_torch.learners.vb_online import OVBLearner, init_ovb_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def test_kernels_match_twins_on_ragged_case(cuda):
    import chip_smoke

    before = dict(build.launch_counts)
    out = chip_smoke.merge_reports(*(
        chip_smoke.check_cases(s, timed=False)
        for s in chip_smoke.ragged_tensors(cuda)))
    assert set(out) == set(build.launch_counts)
    assert all(build.launch_counts[k] > before[k] for k in before)


@pytest.mark.parametrize("kernel,which", [
    ("w_col_update", 1), ("w_col_update", 2), ("ovb_col_stats_update", 2),
    ("w_patch_rows", 1), ("vb_patch_rows", 2)])
def test_new_kernels_match_twins_with_nan_column(cuda, kernel, which):
    """K5 in batch-VB (1) and online (2) mode, K6, the w patch and K4's
    online position order on the ragged case, whose column 9 produces NaN
    candidates and column 17 has cnt = 0: the kernel gives the twin's
    outputs, counters included."""
    import chip_smoke

    s = chip_smoke.ragged_tensors(cuda)[which]
    cases = chip_smoke.make_cases(s)[kernel]
    assert cases
    for label, prepare, call, _ in cases:
        ok, op = call("kernel", prepare()), call("plain", prepare())
        torch.cuda.synchronize()
        chip_smoke.compare(ok, op, f"{kernel} ({label})")
        if kernel in ("w_col_update", "ovb_col_stats_update"):
            bad = ok[-1] if kernel == "ovb_col_stats_update" else ok[3]
            assert bad.sum() > 0 and torch.equal(
                bad, op[-1] if kernel == "ovb_col_stats_update" else op[3])


def _small(**cfg_kw):
    coo = make_movielens_like(num_users=60, num_items=40, num_ratings=5000,
                              rank=2, seed=1)
    tr, te = train_test_split(coo, 0.2, seed=2)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 60])
    cfg = FMConfig(num_attributes=D, num_factor=5, num_groups=2, seed=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), **cfg_kw)
    return tr, te, D, meta, cfg


@pytest.mark.parametrize("factor_block", [0, 1, 2])
def test_learner_on_gpu_matches_cpu(cuda, factor_block):
    tr, te, D, meta, cfg = _small(factor_block=factor_block)
    params = init_vb_params(torch.Generator().manual_seed(3), cfg, "cpu")
    hists, ends = [], []
    for dev in (cuda, "cpu"):
        learner = VBLearner(cfg, SparseDataset.from_coo(tr, D),
                            SparseDataset.from_coo(te, D), meta, device=dev,
                            write_files=False)
        _, h = learner.run(learner.state_from_params(params), num_iter=3,
                           verbose=False)
        hists.append(h)
    for g, c in zip(*hists):
        for k in ("rmse", "train_rmse", "free_energy"):
            np.testing.assert_allclose(g[k], c[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("reshuffle", [False, True])
def test_ovb_learner_on_gpu_matches_cpu(cuda, reshuffle):
    tr, te, D, meta, cfg = _small(num_batches=4, reshuffle=reshuffle)
    init = init_ovb_state(torch.Generator().manual_seed(3), cfg, "cpu")
    hists, ends = [], []
    for dev in (cuda, "cpu"):
        learner = OVBLearner(cfg, SparseDataset.from_coo(tr, D),
                             SparseDataset.from_coo(te, D), meta, device=dev,
                             write_files=False)
        state = type(init)(**{k: v.to(dev) for k, v in vars(init).items()})
        hists.append(learner.run(state, num_iter=3, verbose=False)[1])
    for g, c in zip(*hists):
        for k in ("rmse", "mae", "free_energy"):
            np.testing.assert_allclose(g[k], c[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("kernel", ["build_q", "mcmc_col_draw",
                                    "mcmc_patch_rows", "mcmc_w_draw",
                                    "w_patch_rows", "gather_probe"])
def test_mcmc_kernels_match_twins_on_ragged_case(cuda, kernel):
    """X8d, X8a (F = 6 and F = 1, both draw modes), X8b, X8c, the w patch
    without t, and P1 on the ragged MCMC case: column 3's lambda is NaN
    (0, uncounted) and one noise number is Inf (counted, reverted); the
    kernel gives the twin's outputs, counters included."""
    import chip_smoke

    s = chip_smoke.ragged_mcmc_tensors(cuda)
    cases = chip_smoke.make_cases(s)[kernel]
    assert cases
    for label, prepare, call, _ in cases:
        ok, op = call("kernel", prepare()), call("plain", prepare())
        torch.cuda.synchronize()
        chip_smoke.compare(ok, op, f"{kernel} ({label})")
        if kernel in ("mcmc_col_draw", "mcmc_w_draw"):
            assert torch.equal(ok[-1], op[-1])
            assert int(ok[-1][1]) == (0 if ("jacobi" in label
                                            or "als" in label) else 1)


@pytest.mark.parametrize("als,factor_block", [(False, 0), (False, 1),
                                              (True, 1), (True, 2)])
def test_mcmc_learner_on_gpu_matches_cpu(cuda, als, factor_block):
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr, te, D, meta, cfg = _small(factor_block=factor_block, regw=0.5,
                                  regv=0.5)
    p = init_fm_params(torch.Generator().manual_seed(3), D, 5,
                       init_w_normal=True)
    hists, ends = [], []
    for dev in (cuda, "cpu"):
        cls = ALSLearner if als else MCMCLearner
        learner = cls(cfg, SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta, device=dev,
                      write_files=False)
        state = learner.state_from_params(p.w0, p.w, p.v, host_draws(4, dev))
        hists.append(learner.run(state, num_iter=3, verbose=False)[1])
    for g, c in zip(*hists):
        for k in ("rmse", "rmse_this", "mae", "alpha"):
            np.testing.assert_allclose(g[k], c[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("F", [256, 303])
def test_col_draw_wide_block_matches_twin(cuda, F):
    """X8a in the exact mode at wide blocks: F = K = 256 (a default
    -dim 1,1,256 run) and 303, the widest that fits 227 KiB of shared
    memory; a wider block raises before the launch."""
    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    g = torch.Generator().manual_seed(F)
    N, D, C, L, G = 300, 40, 12, 20, 2
    rows = torch.randint(0, N, (C, L), generator=g, dtype=torch.int32)
    x = torch.rand(C, L, generator=g) + 0.5
    x[-1, L // 2:] = 0.0  # padding entries
    cols = torch.randperm(D, generator=g)[:C].to(torch.int32)
    group = (cols % G).to(torch.int32)
    e = torch.randn(N, generator=g)
    q = 0.1 * torch.randn(N, F, generator=g)
    v_t = 0.1 * torch.randn(D, F, generator=g)
    ptab = torch.cat([v_t, torch.zeros(D, F)], 1)
    mu = 0.1 * torch.randn(G, F, generator=g)
    lam = torch.rand(G, F, generator=g) + 1.0
    z = torch.randn(F, D, generator=g)
    alpha = torch.tensor(1.3)
    outs = []
    for dev in (cuda, "cpu"):
        a = [t.to(dev) for t in (rows, x, cols, group, e, q, ptab.clone(),
                                 v_t.clone(), mu, lam, alpha, z)]
        nans = torch.zeros(2, dtype=torch.int32, device=dev)
        km.mcmc_col_draw(*a[:11], a[11], True, nans)
        outs.append([a[6].cpu(), a[7].cpu(), nans.cpu()])
    import chip_smoke

    chip_smoke.compare(outs[0], outs[1], f"mcmc_col_draw F={F}")
    assert outs[0][2].tolist() == outs[1][2].tolist() == [0, 0]
    W = 304  # past the widest block that fits
    assert not km.col_draw_fits(W, True)
    with pytest.raises(ValueError, match="shared memory"):
        km.mcmc_col_draw(
            rows.to(cuda), x.to(cuda), cols.to(cuda), group.to(cuda),
            e.to(cuda), torch.zeros(N, W, device=cuda),
            torch.zeros(D, 2 * W, device=cuda), torch.zeros(D, W, device=cuda),
            torch.zeros(G, W, device=cuda), torch.ones(G, W, device=cuda),
            alpha.to(cuda), None, True,
            torch.zeros(2, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("kernel", ["sgd_grad_scatter", "sgd_apply",
                                    "sgda_lambda"])
def test_sgd_kernels_match_twins_on_ragged_case(cuda, kernel):
    """X9a-X9c in every step mode at K = 1, 5 and 40 on chip_smoke.py's
    ragged SGD cases (padding entries and rows, duplicate ids, a pair whose
    negative is its own item; at K = 5 a NaN target): the kernel gives the
    twin's outputs, NaN where the twin has NaN."""
    import chip_smoke

    for s in chip_smoke.ragged_sgd_tensors(cuda):
        cases = chip_smoke.make_cases(s)[kernel]
        assert cases
        for label, prepare, call, _ in cases:
            ok, op = call("kernel", prepare()), call("plain", prepare())
            torch.cuda.synchronize()
            chip_smoke.compare(ok, op, f"{kernel} ({label})")


@pytest.mark.parametrize("method", ["sgd", "sgd_online", "sgda", "bpr"])
def test_sgd_learners_on_gpu_match_cpu(cuda, method):
    """3 epochs from one host-made init and host-drawn permutations and
    negatives, on the card (kernels) and on the CPU (twins): the metrics
    agree to chip_smoke.SGD_TRAJ_RTOL and the parameter tables (and SGDA's
    regs) to chip_smoke.SGD_PARAM_ATOL; only X9a's atomics add in another
    order."""
    import chip_smoke

    from svbfm_tpu_torch.learners.bpr import BPRLearner
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.sgd import (SGDALearner, SGDLearner,
                                              SGDOnlineLearner)
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr, te, D, meta, cfg = _small(learn_rate=0.05, regw=0.01, regv=0.01,
                                  batch_size=128, num_batches=4)
    train, test = SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D)
    p = init_fm_params(torch.Generator().manual_seed(3), D, 5)
    hists, ends = [], []
    for dev in (cuda, "cpu"):
        if method == "sgda":
            learner = SGDALearner(cfg, train, test, test, meta, device=dev,
                                  write_files=False)
        elif method == "bpr":
            learner = BPRLearner(cfg, train, test, meta, device=dev,
                                 write_files=False)
        else:
            cls = SGDLearner if method == "sgd" else SGDOnlineLearner
            learner = cls(cfg, train, test, meta, device=dev,
                          write_files=False)
        state = learner.state_from_params(p.w0, p.w, p.v, host_draws(4, dev))
        kw = dict(eval_draws=host_draws(5, dev)) if method == "bpr" else {}
        state, hist = learner.run(state, num_iter=3, verbose=False, **kw)
        hists.append(hist)
        ends.append([state.tab.cpu()] + ([state.reg_w.cpu(), state.reg_v.cpu()]
                                         if method == "sgda" else []))
    keys = {"sgda": ("rmse", "rmse_train", "rmse_val"),
            "bpr": ("pair_loss",)}.get(method, ("rmse", "mae"))
    for g, c in zip(*hists):
        for k in keys:
            np.testing.assert_allclose(g[k], c[k],
                                       rtol=chip_smoke.SGD_TRAJ_RTOL,
                                       err_msg=k)
    for g, c in zip(*ends):
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=0,
                                   atol=chip_smoke.SGD_PARAM_ATOL)


@pytest.mark.parametrize("kernel", ["w_grad_step", "mcmc_col_grad"])
def test_exp_sgd_kernels_match_twins_on_ragged_case(cuda, kernel):
    """X9d, K5's and X8a's gradient modes, on the ragged MCMC bucket at
    F = 1, 5 and 20, with a NaN residual (column 6's w step reverts) and an
    Inf q entry (column 4's v steps revert)."""
    import chip_smoke

    s = chip_smoke.ragged_mcmc_tensors(cuda)
    cases = chip_smoke.make_cases(s)[kernel]
    assert len(cases) == (1 if kernel == "w_grad_step" else 3)
    for label, prepare, call, _ in cases:
        ok, op = call("kernel", prepare()), call("plain", prepare())
        torch.cuda.synchronize()
        chip_smoke.compare(ok, op, f"{kernel} ({label})")
        assert all(torch.isfinite(t).all() for t in ok)


@pytest.mark.parametrize("kernel", ["bs_join_agg", "bs_rel_draw",
                                    "bs_rel_w_draw", "bs_rel_patch",
                                    "bs_rel_w_patch", "bs_rel_moments",
                                    "bs_scores", "bs_resync"])
def test_bs_kernels_match_twins_on_ragged_case(cuda, kernel):
    """X10a-X10d on chip_smoke.py's small relational problem at F = 20, 5,
    1 and the w sweep: every bucket, the one-hot bucket also at L = 1, the
    attribute-slot columns split over blocks, a NaN group lambda (0,
    uncounted) and an Inf noise number (counted, reverted); the kernel
    gives the twin's outputs, counters included."""
    import chip_smoke

    s = chip_smoke.ragged_bs_tensors(cuda)
    cases = chip_smoke.make_cases(s)[kernel]
    assert cases
    for label, prepare, call, _ in cases:
        ok, op = call("kernel", prepare()), call("plain", prepare())
        torch.cuda.synchronize()
        chip_smoke.compare(ok, op, f"{kernel} ({label})")
        if kernel in ("bs_rel_draw", "bs_rel_w_draw"):
            assert torch.equal(ok[-1], op[-1])


def test_bs_draw_splits_long_columns(cuda):
    """The attribute-slot buckets of the ragged problem are split over
    several blocks per column (the last block adds the partials)."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    learner = chip_smoke.small_bs_learner(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = [ks.draw_splits(*b.rows.shape, sms)[0]
              for bb in learner.rels[0].rplan for b in bb]
    assert max(splits) > 1 and min(splits) == 1


@pytest.mark.parametrize("factor_block", [0, 1, 2])
def test_exp_sgd_learner_on_gpu_matches_cpu(cuda, factor_block):
    from svbfm_tpu_torch.learners.exp_sgd import ExpSGDLearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr, te, D, meta, cfg = _small(factor_block=factor_block, learn_rate=0.5,
                                  regw=0.01, regv=0.01)
    p = init_fm_params(torch.Generator().manual_seed(3), D, 5)
    hists = []
    for dev in (cuda, "cpu"):
        learner = ExpSGDLearner(cfg, SparseDataset.from_coo(tr, D),
                                SparseDataset.from_coo(te, D), meta,
                                device=dev, write_files=False)
        hists.append(learner.run(learner.state_from_params(p.w0, p.w, p.v),
                                 num_iter=3, verbose=False)[1])
    for g, c in zip(*hists):
        np.testing.assert_allclose(g["rmse"], c["rmse"], rtol=1e-5)


@pytest.mark.parametrize("als,factor_block", [(False, 0), (False, 1),
                                              (True, 0), (True, 1)])
def test_bs_learner_on_gpu_matches_cpu(cuda, als, factor_block):
    """The block-structure sampler on chip_smoke.py's small relational
    problem (K = 5), card against CPU from one init and one host-table draw
    source, 3 sweeps."""
    import chip_smoke
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.models.fm import init_fm_params

    hists = []
    for dev in (cuda, "cpu"):
        learner = chip_smoke.small_bs_learner(dev, K=5, als=als,
                                              factor_block=factor_block)
        D = learner.cfg.num_attributes
        p = init_fm_params(torch.Generator().manual_seed(3), D, 5,
                           init_w_normal=True)
        state = learner.state_from_params(p.w0, p.w, p.v, host_draws(4, dev))
        hists.append(learner.run(state, num_iter=3, verbose=False)[1])
    for g, c in zip(*hists):
        for k in ("rmse", "rmse_this", "mae", "alpha"):
            np.testing.assert_allclose(g[k], c[k], rtol=1e-5, err_msg=k)
