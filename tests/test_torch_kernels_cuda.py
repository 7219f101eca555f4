"""The hand-written CUDA kernels against their plain twins, on the card, and
the learners on the card against the CPU.

These need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode); without
a GPU they skip.  On the card:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses

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


def _small(K=5, **cfg_kw):
    coo = make_movielens_like(num_users=60, num_items=40, num_ratings=5000,
                              rank=2, seed=1)
    tr, te = train_test_split(coo, 0.2, seed=2)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 60])
    cfg = FMConfig(num_attributes=D, num_factor=K, num_groups=2, seed=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), **cfg_kw)
    return tr, te, D, meta, cfg


@pytest.mark.parametrize("factor_block,K", [(0, 5), (1, 5), (2, 5), (0, 20),
                                            (1, 20)])
def test_learner_on_gpu_matches_cpu(cuda, factor_block, K):
    """Batch VB, 3 sweeps from one init on the card and on the CPU: fast
    mode (factor_block 0: K3 and K4 at F = K) and exact mode (F = 1, 2)."""
    tr, te, D, meta, cfg = _small(K=K, factor_block=factor_block)
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


@pytest.mark.parametrize("K", [5, 20], ids=lambda K: f"K{K}")
@pytest.mark.parametrize("als,factor_block", [(False, 0), (False, 1),
                                              (True, 1), (True, 2)])
def test_mcmc_learner_on_gpu_matches_cpu(cuda, als, factor_block, K):
    """Gibbs and ALS, 3 sweeps from one host-made init and host-drawn
    numbers on the card and on the CPU, at K = 5 and at K = 20 (where K1a
    reads the padded table in 16-byte loads): the metrics agree to 1e-5."""
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr, te, D, meta, cfg = _small(K=K, factor_block=factor_block, regw=0.5,
                                  regv=0.5)
    p = init_fm_params(torch.Generator().manual_seed(3), D, K,
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


@pytest.mark.parametrize("K", [5, 20], ids=lambda K: f"K{K}")
@pytest.mark.parametrize("method", ["sgd", "sgd_online", "sgda", "bpr"])
def test_sgd_learners_on_gpu_match_cpu(cuda, method, K):
    """3 epochs from one host-made init and host-drawn permutations and
    negatives, on the card (kernels) and on the CPU (twins), at K = 5 and
    at K = 20 (where K1a reads the family's stride-21 table): the metrics
    agree to chip_smoke.SGD_TRAJ_RTOL and the parameter tables (and SGDA's
    regs) to chip_smoke.SGD_PARAM_ATOL; only X9a's atomics add in another
    order."""
    import chip_smoke

    from svbfm_tpu_torch.learners.bpr import BPRLearner
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.sgd import (SGDALearner, SGDLearner,
                                              SGDOnlineLearner)
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr, te, D, meta, cfg = _small(K=K, learn_rate=0.05, regw=0.01,
                                  regv=0.01, batch_size=128, num_batches=4)
    train, test = SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D)
    p = init_fm_params(torch.Generator().manual_seed(3), D, K)
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


def test_sgda_k0_on_gpu_matches_cpu(cuda):
    """SGDA at K = 0 (dim '1,1,0', the linear model alone), 3 epochs from
    one host-made init and host-drawn permutations on the card and on the
    CPU: the metrics agree to chip_smoke.SGD_TRAJ_RTOL, the tables and
    regs to chip_smoke.SGD_PARAM_ATOL."""
    import chip_smoke

    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.sgd import SGDALearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr, te, D, meta, cfg = _small(K=0, learn_rate=0.05, regw=0.01,
                                  regv=0.01, batch_size=128, num_batches=4)
    train, test = SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D)
    p = init_fm_params(torch.Generator().manual_seed(3), D, 0)
    hists, ends = [], []
    for dev in (cuda, "cpu"):
        learner = SGDALearner(cfg, train, test, test, meta, device=dev,
                              write_files=False)
        state = learner.state_from_params(p.w0, p.w, p.v, host_draws(4, dev))
        state, hist = learner.run(state, num_iter=3, verbose=False)
        hists.append(hist)
        ends.append([state.tab.cpu(), state.reg_w.cpu(), state.reg_v.cpu()])
    for g, c in zip(*hists):
        for k in ("rmse", "rmse_train", "rmse_val"):
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


def _same_bits(a, b) -> bool:
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("which", [0, 1, 2], ids=["vb", "ovb", "mcmc-grad"])
def test_w_bin_matches_twin_in_every_mode(cuda, which):
    """K5's bin launch in its four modes on chip_smoke's ragged bins (L = 1,
    8 with an empty bucket, 16, 33, 512 and a padded [3, 8]; a bin of 40
    small buckets), e NaN at one row, NaN priors, a cnt = 0 column, a NaN
    eta2 and an Inf noise number: the kernel gives the twin's outputs,
    NaN/Inf pattern and bad counts included, and two launches give the
    same bits."""
    import chip_smoke

    s = chip_smoke.ragged_w_tensors(cuda)[which]
    cases = chip_smoke.make_cases(s)
    names = ("w_col_update",) if which < 2 else ("mcmc_w_draw",
                                                 "w_grad_step")
    for name in names:
        assert len(cases[name]) == (4 if name == "mcmc_w_draw" else 2)
        for label, prepare, call, _ in cases[name]:
            ok, ok2 = call("kernel", prepare()), call("kernel", prepare())
            op = call("plain", prepare())
            torch.cuda.synchronize()
            chip_smoke.compare(ok, op, f"{name} ({label})")
            assert all(_same_bits(a, b) for a, b in zip(ok, ok2))
            if name == "w_grad_step":
                assert all(torch.isfinite(t).all() for t in ok)
                continue
            i = 3 if name == "w_col_update" else 2
            assert torch.equal(ok[i], op[i])
            if "of 40" not in label:
                assert int(ok[i].sum()) > 0


@pytest.mark.parametrize("n,offset,W", [
    (2_000_003, 0, 1), (37, 0, 1), (37, 1, 1), (1, 3, 1),
    (15_625 * 128, 0, 128), (640, 1, 128), (12, 1, 6), (12, 0, 3)])
def test_gather_probe_forms_match_twin(cuda, n, offset, W):
    """P1 at W = 1 and 128, and at 6 and 3 (rows narrower than a 16-byte
    vector): n not a multiple of 4, the index base ``offset`` elements
    past a 16-byte boundary, 2M indices over many blocks; a gather is
    exact, so the bits equal the twin's."""
    from svbfm_tpu_torch.kernels import gather_probe as kg

    gen = torch.Generator(device=cuda).manual_seed(n + offset)
    S = 1_000_000 // W if n > 1000 else 9
    t = torch.randn(S, W, generator=gen, device=cuda)
    buf = torch.randint(0, S, (n + offset,), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx = buf[offset:].view(n // W, W)
    before = build.launch_counts["gather_probe"]
    o = kg.gather_rows(t, idx)
    torch.cuda.synchronize()
    assert build.launch_counts["gather_probe"] == before + 1
    assert torch.equal(o, kg.gather_rows_plain(t, idx))


def test_learners_launch_k5_once_a_bin(cuda):
    """Exact VB, Gibbs, ALS, exp_sgd and OVB on the card launch K5 once a
    bin: a sweep's launches are the plan's bins (an OVB epoch's, each
    chunk's bins)."""
    from svbfm_tpu_torch.learners.exp_sgd import ExpSGDLearner
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner

    tr, te, D, meta, cfg = _small()
    data = (SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta)
    rep = dataclasses.replace
    for cls, c, name in (
            (VBLearner, rep(cfg, factor_block=1), "w_col_update"),
            (MCMCLearner, cfg, "mcmc_w_draw"),
            (ALSLearner, rep(cfg, regv=1.0, regw=1.0), "mcmc_w_draw"),
            (ExpSGDLearner, rep(cfg, learn_rate=0.5), "w_grad_step"),
            (OVBLearner, rep(cfg, num_batches=3), "w_col_update")):
        learner = cls(c, *data, device=cuda, write_files=False)
        state, _ = learner.run(num_iter=1, verbose=False)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        learner.run(state, num_iter=1, verbose=False)
        torch.cuda.synchronize()
        bins = (sum(len(b) for _, b in learner.chunks)
                if cls is OVBLearner else len(learner.plan_data.blocks))
        assert bins >= 2 and build.launch_counts[name] == bins, cls


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
    several blocks per column by their real entries (the last block adds
    the partials); the one-hot bucket is not split."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    learner = chip_smoke.small_bs_learner(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = [ks.draw_plan(20, *b.rows.shape, b.real.lo, b.real.hi, sms).S
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


@pytest.mark.parametrize("nrel", [9, 12])
def test_bs_scores_many_relations_match_twin(cuda, nrel):
    """X10d's scores over 9 and 12 relations (five and six batches of two),
    read through device arrays of pointers: every relation's qB adds into
    one s_f before it is squared."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import bs_forward as kf

    rng = np.random.default_rng(nrel)
    N, P, D, K = 333, 3, 20, 5
    ids = rng.integers(0, D, (N, P))
    vals = rng.uniform(0.5, 1.5, (N, P))
    ids[::3, 2], vals[::3, 2] = 0, 0.0  # padding entries
    sizes = [3 + r for r in range(nrel)]

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(cuda)

    stab = t(rng.normal(0, 0.3, (D, 1 + K)))
    w0 = torch.tensor(0.2, device=cuda)
    joins = [t(rng.integers(0, R, N), np.int32) for R in sizes]
    moms = [kf.moments_table(R, K, cuda).copy_(t(rng.normal(0, 0.3,
                                                          (R, K + 2))))
            for R in sizes]
    before = build.launch_counts["bs_scores"]
    got = kf.bs_scores(stab, w0, t(ids, np.int32), t(vals), joins, moms)
    want = kf.bs_scores_plain(stab, w0, t(ids, np.int32), t(vals), joins,
                              moms)
    torch.cuda.synchronize()
    assert build.launch_counts["bs_scores"] == before + 1
    chip_smoke.compare([got], [want], f"bs_scores relations={nrel}")


def _join_bucket(rng, C, L, N, cols, dev):
    """A [C, L] join bucket at relation rows ``cols`` with ragged padding
    (pad row N - 1, x = 0) and, past 5 columns, column 3 padding only."""
    from svbfm_tpu_torch.learners.mcmc_bs import JoinBlock

    rows = rng.integers(0, N - 1, (C, L))
    x = rng.uniform(0.5, 1.5, (C, L))
    cnt = rng.integers(1, L + 1, C)
    if C > 5:
        cnt[3] = 0
    pad = np.arange(L)[None, :] >= cnt[:, None]
    rows[pad], x[pad] = N - 1, 0.0
    return JoinBlock(rows=torch.from_numpy(rows.astype(np.int32)).to(dev),
                     x=torch.from_numpy(x.astype(np.float32)).to(dev),
                     cols=torch.from_numpy(cols.astype(np.int32)).to(dev))


def _join_agg_case(cuda, F, shapes, seed, poison=None, twice=False,
                   q_shift=0):
    """X10a against its twin on a plan of ``shapes``; ``poison`` "e" (a NaN
    residual) or "q" (an Inf cache) at the pad row N - 1; ``twice``: a
    second launch must give the same bits; ``q_shift``: q a view that many
    floats into its buffer (its rows off their 16-byte boundaries)."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    rng = np.random.default_rng(seed)
    N, R = 2000, 400
    # the buckets of one plan hold disjoint relation rows, as a join plan's
    order = rng.permutation(R)
    buckets, start = [], 0
    for C, L in shapes:
        buckets.append(_join_bucket(rng, C, L, N, order[start:start + C],
                                    cuda))
        start += C
    # a NaN residual at a real entry of each bucket's column 5
    e = rng.standard_normal(N)
    for b in buckets:
        if b.rows.shape[0] > 5:
            e[int(b.rows[5, 0])] = np.nan
    lay = ks.rel_layout(F)
    rtab = torch.from_numpy(rng.normal(0, 1, (R, lay["ld"])).astype(
        np.float32)).to(cuda)
    qn = rng.standard_normal((N, F))
    if poison == "e":
        e[N - 1] = np.nan
    elif poison == "q":
        qn[N - 1, F - 1] = np.inf
    e_t = torch.from_numpy(e.astype(np.float32)).to(cuda)
    q = None
    if F:
        flat = torch.zeros(N * F + q_shift, device=cuda)
        q = flat[q_shift:].view(N, F)
        q.copy_(torch.from_numpy(qn.astype(np.float32)))
    got, want = rtab.clone(), rtab.clone()
    before = build.launch_counts["bs_join_agg"]
    ks.bs_join_agg(buckets, e_t, q, F, got)
    ks.bs_join_agg_plain(buckets, e_t, q, F, want)
    if twice:
        again = rtab.clone()
        ks.bs_join_agg(buckets, e_t, q, F, again)
    torch.cuda.synchronize()
    live = any(b.rows.shape[0] for b in buckets)
    assert build.launch_counts["bs_join_agg"] == before + int(live) * (
        1 + twice)
    what = f"bs_join_agg F={F} {shapes} poison={poison}"
    chip_smoke.compare([got], [want], what)
    if twice:
        assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
            what
    CH = ks.agg_channels(F)
    for b in buckets:
        if b.rows.shape[0] > 5:
            assert torch.isnan(got[int(b.cols[5]), F]).item()
            pad_only = got[int(b.cols[3]), F:F + CH]
            if poison is None:
                assert (pad_only == 0).all()
            else:  # the twin's x = 0 products of the poisoned pad row
                assert torch.isnan(pad_only).any()


@pytest.mark.parametrize("F", [0, 1])
@pytest.mark.parametrize("C,L", [(23, 1), (23, 7), (23, 33), (23, 300),
                                 (0, 8)])
def test_join_agg_narrow_matches_twin(cuda, F, C, L):
    """X10a's F <= 1 form (G lanes a relation row) on one ragged bucket:
    L = 1, 7, 33, 300 (one to ten entries a lane), an empty bucket, a column
    of padding only, a NaN residual at a real entry; rtab written only at
    the bucket's relation rows."""
    _join_agg_case(cuda, F, [(C, L)], 10 * L + F)


@pytest.mark.parametrize("F", [0, 1, 2, 20])
def test_join_agg_plan_in_one_launch_matches_twin(cuda, F):
    """X10a over a whole join plan in one launch, both forms: buckets of
    L = 1, 7, 33 and 300 with an empty one between them, each block
    finding its bucket in the plan table."""
    _join_agg_case(cuda, F, [(23, 1), (40, 7), (0, 8), (31, 33), (9, 300)],
                   F)


@pytest.mark.parametrize("F,poison", [
    (0, None), (0, "e"), (1, None), (1, "e"), (1, "q"),
    *((F, p) for F in (2, 5, 20, 32, 33, 48, 64, 128, 200, 251)
      for p in (None, "e", "q"))])
def test_join_agg_forms_match_twin(cuda, F, poison):
    """X10a in each form (``join_form``): G lanes a relation row at F <= 1,
    a warp a row at F = 2, 5, 20, 32 (rows of 1 to 32 rounds of 32 slots,
    L = 300 and 1,000 among them), a block a row at F = 33, 48, 64, 128,
    200 and 251 (one, two and three units a thread, q's rows staged in
    place and as raw 16-byte words, rows written in one window and in
    several); buckets of L = 1-1,000
    with an empty one, ragged padding and a column of padding only; with
    ``poison`` a NaN e or an Inf q at the pad row, which the twin's x = 0
    products carry into every padded relation row's sums; two launches
    give the same bits."""
    _join_agg_case(cuda, F, [(23, 1), (40, 7), (0, 8), (31, 33), (9, 300),
                             (3, 1000)], 100 + F, poison, twice=True)


@pytest.mark.parametrize("F", [48, 64, 200])
@pytest.mark.parametrize("poison", [None, "e", "q"])
def test_join_agg_block_form_on_unaligned_q_matches_twin(cuda, F, poison):
    """X10a's block form at F % 4 == 0 with q's rows off their 16-byte
    boundaries (q a view one float into its buffer): the layout that
    stages each row's raw 16-byte words and builds t from them, which odd
    F always takes, against the twin with the same poisons; two launches
    give the same bits."""
    _join_agg_case(cuda, F, [(23, 1), (40, 7), (0, 8), (31, 33), (9, 300),
                             (3, 1000)], 200 + F, poison, twice=True,
                   q_shift=1)


def _col_f1_case(cuda, C, L, mode, shift, poison):
    """X8a at F = 1 (``mode`` "draw": Gibbs, or "grad": exp_sgd's step) on
    one [C, L] bucket with ragged padding (pad row N - 1, x = 0), past 5
    columns column 3 padding only, a group whose lambda is NaN (its draws
    give 0, uncounted), an Inf noise number at column 0 (counted,
    reverted); rows and x ``shift`` elements past a 16-byte boundary;
    ``poison``: a NaN q or an Inf e at the pad row.  Two launches, then the
    twin; returns the kernel's outputs."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    rng = np.random.default_rng(1000 * C + 10 * L + shift)
    N, G = 2000, 3
    D = C + 7
    rows = rng.integers(0, N - 1, (C, L))
    x = rng.uniform(0.5, 1.5, (C, L))
    cnt = rng.integers(1, L + 1, C)
    if C > 5:
        cnt[3] = 0
    pad = np.arange(L)[None, :] >= cnt[:, None]
    rows[pad], x[pad] = N - 1, 0.0
    cols = rng.permutation(D)[:C]
    group = rng.integers(0, 2, C)
    if C > 2:
        group[1] = 2  # the NaN-lambda group, alone
    e, q = rng.normal(0, 1, N), rng.normal(0, 1, (N, 1))
    if poison == "q":
        q[N - 1, 0] = np.nan
    elif poison == "e":
        e[N - 1] = np.inf
    v = rng.normal(0, 0.3, (D, 1))
    mu = rng.normal(0, 0.1, (G, 1))
    lam = rng.uniform(0.5, 2.0, (G, 1))
    lam[2] = np.nan
    z = rng.normal(0, 1, (1, D))
    if C:
        z[0, cols[0]] = np.inf

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(cuda)

    r_t = _offset_view(torch.from_numpy(rows.astype(np.int32)), shift == 0,
                       cuda, shift)
    x_t = _offset_view(torch.from_numpy(x.astype(np.float32)), shift == 0,
                       cuda, shift)
    plan = km.col_draw_f1_plan(r_t, x_t)
    assert plan.lanes == km.col_draw_f1_lanes(C, L)
    if C:  # (an empty view's address is not the buffer's)
        assert plan.vec == (1 if plan.lanes < 32 or L % 2 or shift == 1
                            else 2 if L % 4 or shift == 2 else 4)
    name = "mcmc_col_draw" if mode == "draw" else "mcmc_col_grad"
    before = build.launch_counts[name]
    outs = []
    for fn in ((km.mcmc_col_draw, km.mcmc_col_draw, km.mcmc_col_draw_plain)
               if mode == "draw" else
               (km.mcmc_col_grad, km.mcmc_col_grad, km.mcmc_col_grad_plain)):
        ptab = t(np.concatenate([v, np.zeros_like(v)], 1))
        vt, nans = t(v), torch.zeros(2, dtype=torch.int32, device=cuda)
        if mode == "draw":
            fn(r_t, x_t, t(cols, np.int32), t(group, np.int32), t(e), t(q),
               ptab, vt, t(mu), t(lam),
               torch.tensor(1.3, device=cuda), t(z), True, nans)
        else:
            fn(r_t, x_t, t(cols, np.int32), t(e), t(q), ptab, vt, 0.3, 0.05,
               float(N))
        outs.append([ptab, vt, nans])
    torch.cuda.synchronize()
    assert build.launch_counts[name] == before + 2 * (C > 0)
    what = f"{name} F=1 [{C},{L}] shift={shift} poison={poison} {plan}"
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    chip_smoke.compare(outs[0], outs[2], what)
    assert torch.equal(outs[0][2], outs[2][2]), what
    return outs[0]


@pytest.mark.parametrize("poison", [None, "q", "e"])
@pytest.mark.parametrize("shift", [0, 1, 2])
@pytest.mark.parametrize("L", [1, 7, 16, 33, 256, 512, 1000])
@pytest.mark.parametrize("C", [0, 1, 300])
@pytest.mark.parametrize("mode", ["draw", "grad"])
def test_col_draw_f1_matches_twin(cuda, mode, C, L, shift, poison):
    """X8a at F = 1 in the Gibbs draw and exp_sgd gradient modes against
    the twin: L = 1, 7, 16 (a few lanes a column, several columns a warp),
    33 and 256 (a warp), 512 and 1,000 (2-4 warps a column); C = 0, 1 and
    300; rows and x at 16-, 4- and 8-byte alignment (16-, 4- and 8-byte
    loads); a padding-only column, a NaN-lambda group, an Inf noise
    number; a NaN q or an Inf e at the pad row turns the padded columns'
    sums NaN, as in the twin (a NaN sh2 gives a draw of 0, uncounted; a
    NaN s0 a NaN draw, counted and reverted; a step kept from moving); two
    launches give the same bits."""
    out = _col_f1_case(cuda, C, L, mode, shift, poison)
    if mode == "draw" and C > 1 and poison is None:
        assert out[2][1] >= 1  # the Inf noise number
    if mode == "draw" and C > 5 and poison == "e":
        assert out[2][0] >= 1  # column 3, padding only


@pytest.mark.parametrize("L", [256, 512])
@pytest.mark.parametrize("mode", ["draw", "grad"])
def test_col_draw_f1_many_columns_match_twin(cuda, mode, L):
    """X8a at F = 1 on buckets of 2,500 columns, where a long column keeps
    one warp (L = 256) or takes two (L = 512), as ML-1M's `[6026,256]`
    and `[1613,512]` buckets do at their own widths."""
    _col_f1_case(cuda, 2500, L, mode, 0, None)


@pytest.mark.parametrize("merge_w", [False, True])
@pytest.mark.parametrize("N,P", [(1, 1), (1, 3), (257, 1), (257, 3)])
@pytest.mark.parametrize("sequential", [True, False])
def test_patch_rows_f1_matches_twin(cuda, sequential, N, P, merge_w):
    """K4 at F = 1 (a thread a row) in both position orders: one row and a
    ragged block (N not a multiple of 256), one and three positions with
    padding entries, the w channels merged or not, a NaN delta at one
    attribute."""
    _patch_case(cuda, 1, N, P, sequential, merge_w)


@pytest.mark.parametrize("merge_w", [False, True])
@pytest.mark.parametrize("sequential", [True, False])
@pytest.mark.parametrize("N,P", [(1, 1), (1, 3), (257, 1), (257, 3),
                                 (1000, 2)])
@pytest.mark.parametrize("F", [2, 3, 5, 20, 33, 64])
def test_patch_rows_wide_matches_twin(cuda, F, N, P, sequential, merge_w):
    """K4 at F >= 2 (a row's factor chunks over threads): chunks of 4
    floats (F = 20, 64; ptab read 2 floats wide with the w channels, whose
    CH = 5F + 2), of 2 (F = 2) and of 1 (F = 3, 5, 33: 33 over two rounds
    of 17 threads); rows that straddle warps and blocks; the same padding
    entries and NaN delta as the F = 1 test."""
    _patch_case(cuda, F, N, P, sequential, merge_w)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("N", [1, 257, 1000])
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("F", [2, 3, 5, 20, 33, 64])
def test_mcmc_patch_rows_wide_matches_twin(cuda, F, P, N, aligned):
    """X8b at F >= 2 (a row's factor chunks over lanes, several rows a
    warp), in both its builds (P = 2 unrolled, P = 1 and 3 at any P):
    chunks of 4 factors (F = 20, 64), 2 (F = 2) and 1 (F = 3, 5,
    33: 32 lanes, the first taking chunks 0 and 32), and with q one float
    past a 16-byte boundary, where the 4- and 2-wide forms must give way;
    one row and a ragged last warp and block; padding entries (id 0, x 0)
    and a NaN dv at attribute 7, which row 0 holds.  Against the twin, the
    launch counted, two launches the same bits."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    rng = np.random.default_rng(1000 * F + 10 * N + P)
    D = 30
    ids = rng.integers(1, D, (N, P))
    vals = rng.uniform(0.5, 1.5, (N, P))
    if P > 1:
        ids[1::2, -1], vals[1::2, -1] = 0, 0.0
    ids[0, 0] = 7
    ptab = rng.normal(0, 0.3, (D, 2 * F))
    ptab[7, F] = np.nan

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(cuda)

    ids_t, vals_t, ptab_t = t(ids, torch.int32), t(vals), t(ptab)
    q = torch.from_numpy(rng.normal(0, 1, (N, F)).astype(np.float32))
    e = torch.from_numpy(rng.normal(0, 1, N).astype(np.float32))
    before = build.launch_counts["mcmc_patch_rows"]
    outs = []
    for fn in (km.mcmc_patch_rows, km.mcmc_patch_rows,
               km.mcmc_patch_rows_plain):
        qr, er = _offset_view(q, aligned, cuda), e.to(cuda)
        fn(ptab_t, F, ids_t, vals_t, qr, er)
        outs.append([qr, er])
    torch.cuda.synchronize()
    assert build.launch_counts["mcmc_patch_rows"] == before + 2
    p = km.patch_plan(ptab_t, F, outs[0][0])
    assert p.form == "chunks" and (aligned or p.vec == 1)
    what = f"mcmc_patch_rows F={F} N={N} P={P} aligned={aligned} {p}"
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    chip_smoke.compare(outs[0], outs[2], what)
    assert torch.isnan(outs[0][1][0]).item()


@pytest.mark.parametrize("k1", [True, False])
@pytest.mark.parametrize("R", [1, 301])
@pytest.mark.parametrize("Pr", [1, 21, 40])
@pytest.mark.parametrize("K", [0, 1, 5, 15, 20, 33, 130])
def test_rel_moments_match_twin(cuda, K, Pr, R, k1):
    """X10d's moments (lanes over the channels of (w | v), lin in the same
    pass, three channels a lane: 1 lane a row at K <= 2, 2 at K = 5, 8 at
    K = 15 and 20, 16 at K = 33, 32 in two passes at K = 130; rows
    (qB | lin | sumsB), sumsB by a segmented shuffle) against their twin:
    R = 1 and a ragged R, one position, 21 and 40 (several rounds of
    positions), padding entries (x = 0), k1 on and off (lin 0), a NaN stab
    row that row 0 holds; the launch counted, a second launch into a
    NaN-filled contiguous ``out`` gives the same bits."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import bs_forward as kf

    g = torch.Generator().manual_seed(100 * K + 10 * Pr + R)
    Dr, off = 45, 6
    stab = torch.randn(off + Dr + 3, K + 1, generator=g)
    stab[off + 5] = float("nan")
    rids = torch.randint(0, Dr, (R, Pr), generator=g, dtype=torch.int32)
    rvals = torch.rand(R, Pr, generator=g) + 0.5
    if Pr > 1:
        rvals[::4, -1] = 0.0
    rids[0, 0] = 5
    args = (rids.to(cuda), rvals.to(cuda), stab.to(cuda), off, k1)
    before = build.launch_counts["bs_rel_moments"]
    first = kf.bs_rel_moments(*args)
    out = torch.full((R, K + 2), float("nan"), device=cuda)
    again = kf.bs_rel_moments(*args, out=out)
    plain = kf.bs_rel_moments_plain(*args)
    torch.cuda.synchronize()
    assert again is out
    assert build.launch_counts["bs_rel_moments"] == before + 2
    what = f"bs_rel_moments K={K} Pr={Pr} R={R} k1={k1}"
    assert first.stride(0) == kf.moments_stride(K)
    assert torch.equal(first.view(torch.int32), out.view(torch.int32)), what
    chip_smoke.compare([first], [plain], what)
    assert torch.isnan(first[0, :K]).all()
    assert K == 0 or torch.isnan(first[0, K + 1]).item()
    if not k1:
        assert (first[:, K] == 0).all()


def _patch_case(cuda, F, N, P, sequential, merge_w):
    import chip_smoke
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    rng = np.random.default_rng(N + 10 * P + 100 * merge_w + 1000 * sequential
                                + 10000 * (F - 1))
    D = 30
    ids = rng.integers(1, D, (N, P))
    vals = rng.uniform(0.5, 1.5, (N, P))
    if P > 1:
        ids[1::2, -1], vals[1::2, -1] = 0, 0.0  # padding entries
    ids[0, 0] = 7
    CH = 5 * F + (2 if merge_w else 0)
    ptab = rng.normal(0, 0.3, (D, CH))
    ptab[:, F:2 * F] = rng.uniform(0.01, 0.1, (D, F))
    ptab[7, 2 * F] = np.nan  # dmu of attribute 7

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
            cuda)

    caches = [rng.normal(0, 1, (N, F)), rng.uniform(0, 1, (N, F)),
              rng.uniform(0, 1, (N, F)), rng.normal(0, 1, N),
              rng.uniform(0, 1, N)]
    ids_t = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    before = build.launch_counts["vb_patch_rows"]
    outs = []
    for fn in (kv.vb_patch_rows, kv.vb_patch_rows_plain):
        c = [t(a) for a in caches]
        fn(t(ptab), F, merge_w, ids_t, t(vals), *c, sequential=sequential)
        outs.append(c)
    torch.cuda.synchronize()
    assert build.launch_counts["vb_patch_rows"] == before + 1
    chip_smoke.compare(outs[0], outs[1], f"vb_patch_rows F={F} N={N} P={P}")
    assert torch.isnan(outs[0][3][0]).item()


@pytest.mark.parametrize("C,L", [(1, 1), (23, 7), (23, 33), (23, 300),
                                 (3, 8)])
@pytest.mark.parametrize("w_rider", [False, True])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 5, 20, 33, 64])
def test_col_stats_matches_twin(cuda, F, w_rider, C, L):
    """K3 with lanes over (entry, factor chunk): chunks of 4, 2 and 1
    floats, blocks over more than one group of chunks (F = 33, 64), one
    entry to 300, padding entries (x = 0 at the pad row) in every column;
    past 2 columns, column 1's group has a NaN prior (sigma_v, and with the
    rider sigma_w), so its candidates are counted and reverted.  Both NaN
    counters match the twin's, and two launches give the same bits."""
    nans = _col_stats_case(cuda, F, w_rider, C, L)
    assert (nans[0] > 0) == (C > 2)
    assert (nans[1] > 0) == (C > 2 and w_rider)


@pytest.mark.parametrize("poison", ["pad_row", "zero_x", "pad_row_real"])
@pytest.mark.parametrize("C,L", [(23, 7), (23, 300), (5, 1100)])
@pytest.mark.parametrize("F", [1, 5, 20])
def test_col_stats_padding_matches_twin(cuda, F, C, L, poison):
    """K3 where an x = 0 entry is not plain zero: a NaN cache at the pad
    row (pad_row) reaches every padded column's candidates, as in the
    twin; a real x = 0 entry at a row whose e is NaN (zero_x); real x != 0
    entries at the pad row (pad_row_real); L = 1100 stages two tiles."""
    nans = _col_stats_case(cuda, F, True, C, L, poison)
    assert nans[0] > 0


def _col_stats_case(cuda, F, w_rider, C, L, poison=None):
    import chip_smoke
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    rng = np.random.default_rng(1000 * F + 10 * C + L + 7 * w_rider)
    N, D, G = 400, 60, 2
    rows = rng.integers(0, N - 1, (C, L))
    x = rng.uniform(0.5, 1.5, (C, L))
    cnt = rng.integers(1, L + 1, C)
    pad = np.arange(L)[None, :] >= cnt[:, None]
    rows[pad], x[pad] = N - 1, 0.0  # padding entries
    cols = rng.permutation(D)[:C]
    group = rng.integers(0, G, C)
    CH = 5 * F + (2 if w_rider else 0)
    ptab = np.zeros((D, CH))
    ptab[:, :F] = rng.normal(0, 0.3, (D, F))
    ptab[:, F:2 * F] = rng.uniform(0.01, 0.1, (D, F))
    sv = rng.uniform(0.5, 2.0, (G, F))
    sigma_w = np.array([1.0, 2.0])
    if C > 2:
        sv[group[1]] = sigma_w[group[1]] = np.nan
    e, q = rng.normal(0, 1, N), rng.normal(0, 1, (N, F))
    if poison == "pad_row":
        q[N - 1, 0] = np.nan
    elif poison == "zero_x":
        x[0, 0] = 0.0
        e[rows[0, 0]] = np.nan
    elif poison == "pad_row_real":
        rows[:, 0] = N - 1

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(cuda)

    ins = (t(rows, np.int32), t(x), t(cols, np.int32), t(group, np.int32),
           t((x * x).sum(1)), t(e), t(q), t(rng.uniform(0, 1, (N, F))))
    before = build.launch_counts["vb_col_stats_update"]
    outs = []
    for fn in (kv.vb_col_stats_update, kv.vb_col_stats_update,
               kv.vb_col_stats_update_plain):
        tab = t(ptab)
        out = [tab, tab[:, :F].contiguous(), tab[:, F:2 * F].contiguous(),
               t(np.linspace(-0.1, 0.1, D)), t(np.full(D, 0.02)),
               torch.zeros(2, dtype=torch.int32, device=cuda)]
        w = (out[3], out[4], t(sigma_w)) if w_rider else None
        fn(*ins, out[0], out[1], out[2], t(sv),
           torch.tensor(1.3, device=cuda), w, out[5])
        outs.append(out)
    torch.cuda.synchronize()
    assert build.launch_counts["vb_col_stats_update"] == before + 2
    what = f"vb_col_stats_update F={F} [{C},{L}] w={w_rider} {poison}"
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    chip_smoke.compare(outs[0], outs[2], what)
    assert torch.equal(outs[0][5], outs[2][5]), what
    return outs[0][5].tolist()


@pytest.mark.parametrize("factor_block", [0, 1])
def test_bs_nine_relations_on_gpu_matches_cpu(cuda, factor_block):
    """chip_smoke.py's small relational problem with nine relations (K = 5),
    card against CPU from one init and one host-table draw source, 3
    sweeps."""
    import chip_smoke
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.models.fm import init_fm_params

    hists = []
    for dev in (cuda, "cpu"):
        learner = chip_smoke.small_bs_learner(
            dev, K=5, factor_block=factor_block,
            n_rel=chip_smoke.NINE_RELATIONS)
        assert len(learner.rels) == 9
        p = init_fm_params(torch.Generator().manual_seed(3),
                           learner.cfg.num_attributes, 5, init_w_normal=True)
        state = learner.state_from_params(p.w0, p.w, p.v, host_draws(4, dev))
        hists.append(learner.run(state, num_iter=3, verbose=False)[1])
    for g, c in zip(*hists):
        for k in ("rmse", "rmse_this", "mae", "alpha"):
            np.testing.assert_allclose(g[k], c[k], rtol=1e-5, err_msg=k)


def _rel_table(g, F, R):
    """A relation-row table [R, 3F + 2 + P] whose aggregates come from 1-4
    joined rows each (wn, we, weq, wc, wcc summed over them, qB drawn), so
    that every sh2 and M is a sum of squares, as in a sweep; F = 0 the w
    sweep's [R, 2] = we | wn."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    lay = ks.rel_layout(F)
    k = torch.randint(1, 5, (R,), generator=g)
    live = torch.arange(4)[None, :] < k[:, None]  # [R, 4] joined rows
    e = torch.randn(R, 4, generator=g) * live
    rtab = torch.zeros(R, lay["ld"])
    rtab[:, lay["we"]] = e.sum(1)
    rtab[:, lay["wn"]] = k.float()
    if F:
        qo = 0.5 * torch.randn(R, 4, F, generator=g) * live[:, :, None]
        iu0, iu1 = np.triu_indices(F)
        rtab[:, :F] = 0.5 * torch.randn(R, F, generator=g)
        rtab[:, lay["weq"]:lay["weq"] + F] = (e[:, :, None] * qo).sum(1)
        rtab[:, lay["wc"]:lay["wc"] + F] = qo.sum(1)
        rtab[:, lay["wcc"]:lay["wcc"] + lay["P"]] = (
            qo[:, :, iu0] * qo[:, :, iu1]).sum(1)
    return rtab


def _rel_bucket(F, C, L, nreal, seed, z, poison, cuda):
    """One relation bucket of C columns of L slots, nreal[c] real entries
    first in each (random rows of a 300-row relation, x in [0.5, 1.5]), and
    its draw's inputs; ``poison``: the columns of group 2 have a NaN
    lambda (drawn 0, uncounted) and column 0 an Inf noise number (counted,
    reverted)."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    g = torch.Generator().manual_seed(seed)
    R, Dr, G, Fo = 300, C + 7, 3, max(F, 1)
    rows = torch.randint(0, R - 1, (C, L), generator=g, dtype=torch.int32)
    x = torch.rand(C, L, generator=g) + 0.5
    for c, n in enumerate(nreal):
        x[c, n:] = 0.0
        rows[c, n:] = R - 1
    cols = torch.randperm(Dr, generator=g)[:C].to(torch.int32)
    group = (torch.arange(C) % G).to(torch.int32)
    v = 0.1 * torch.randn(Dr, Fo, generator=g)
    mu = 0.1 * torch.randn(G, Fo, generator=g)
    lam = torch.rand(G, Fo, generator=g) + 1.0
    zt = torch.randn(Fo, Dr, generator=g) if z else None
    if poison:
        lam[2] = float("nan")
        if z:
            zt[:, cols[0].long()] = float("inf")
    t = dict(rows=rows, x=x, cols=cols, group=group, rtab=_rel_table(g, F, R),
             ptab=torch.cat([v, torch.zeros(Dr, Fo)], 1),
             v=v if F else v[:, 0].contiguous(),
             mu=mu if F else mu[:, 0].contiguous(),
             lam=lam if F else lam[:, 0].contiguous(),
             z=None if zt is None else (zt if F else zt[0].contiguous()),
             alpha=torch.tensor(1.7))
    t = {k: None if a is None else a.to(cuda) for k, a in t.items()}
    t["real"] = ks.real_counts(t["x"])
    return t


def _rel_draw_runs(F, t):
    """X10b twice on the card and its twin on the CPU, from the same
    inputs: [(ptab, v, nans)] each."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    outs = []
    for dev in ("kernel", "kernel", "cpu"):
        a = {k: (v.cpu() if dev == "cpu" else v) if torch.is_tensor(v) else v
             for k, v in t.items()}
        ptab, v = a["ptab"].clone(), a["v"].clone()
        nans = torch.zeros(2, dtype=torch.int32, device=ptab.device)
        args = (a["rows"], a["x"], a["cols"], a["group"], a["rtab"])
        args += (F,) if F else ()
        args += (ptab, v, a["mu"], a["lam"], a["alpha"], a["z"], nans)
        if F:
            ks.bs_rel_draw(*args, a["real"])
        else:
            ks.bs_rel_w_draw(*args, a["real"])
        outs.append([ptab.cpu(), v.cpu(), nans.cpu()])
    torch.cuda.synchronize()
    return outs


def _check_rel_draw(F, t, what):
    import chip_smoke

    k1, k2, twin = _rel_draw_runs(F, t)
    for a, b in zip(k1, k2):  # two launches, the same bits
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    chip_smoke.compare(k1, twin, what)
    assert torch.equal(k1[2], twin[2]), what
    assert all(torch.isfinite(a).all() for a in k1[:2]), what
    return k1[2].tolist()


# (C, L, real entries a column, the form at F >= 2 and at F <= 1)
_REL_SHAPES = {
    "L=1": (600, 1, [1] * 600, "warp", "group"),
    "L=8 one real": (600, 8, [1] * 600, "warp", "group"),
    "L=32": (300, 32, [1 + (7 * c) % 32 for c in range(300)], "warp",
             "group"),
    "mid-tile": (2, 1024, [589, 611], "tiles", "block"),
    "all padding": (3, 300, [0, 150, 299], "tiles", "block"),
    "splits on the real count": (2, 2048, [1024, 1024], "tiles", "block"),
}


@pytest.mark.parametrize("z,poison", [(True, False), (False, False),
                                      (True, True), (False, True)])
@pytest.mark.parametrize("F", [20, 5, 1, 0])
@pytest.mark.parametrize("shape", list(_REL_SHAPES))
def test_rel_draw_forms_match_twin(cuda, shape, F, z, poison):
    """X10b in each form against its twin: the narrow forms at L = 1, at
    L = 8 with one real entry, at L = 32 with 1-32 real; the block forms
    with real entries ending mid-tile, with an all-padding column (the
    bucket is not split), and with splits that fall on tile boundaries;
    with and without noise, with a NaN group lambda and an Inf noise
    number.  Two launches give the same bits and counters, the twin's."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    C, L, nreal, wide_f, narrow_f = _REL_SHAPES[shape]
    t = _rel_bucket(F, C, L, nreal, 100 * F + L, z, poison, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ks.draw_plan(F, C, L, t["real"].lo, t["real"].hi, sms)
    assert plan.form == (wide_f if F >= 2 else narrow_f)
    if shape == "all padding":
        assert plan.S == 1
    if shape == "splits on the real count":
        assert plan.S == 8 and ks.split_bounds(1024, 8)[-1] == (896, 1024)
    if shape == "mid-tile":
        assert plan.S == 4
    nans = _check_rel_draw(F, t, f"X10b {shape} F={F} z={z} {poison}")
    assert nans == [0, max(F, 1) if z and poison else 0]


@pytest.mark.parametrize("F,L,nreal", [(150, 64, [40, 64]),
                                       (200, 64, [40, 64]),
                                       (200, 8, [1, 3, 8]),
                                       (251, 40, [33, 40])])
def test_rel_draw_wide_blocks_match_twin(cuda, F, L, nreal):
    """X10b at the widest blocks the learners give it: F = 150 (tiles of one
    whole row), F = 200 and 251 (rows staged without wcc, read from L2),
    and a narrow bucket at F = 200 (a warp a column, one row a round)."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    t = _rel_bucket(F, len(nreal), L, nreal, F, True, True, cuda)
    form = ks.draw_form(F, L)
    assert form == ("tiles" if F == 150 else
                    "warp" if L <= 32 else "tiles_l2wcc")
    _check_rel_draw(F, t, f"X10b F={F} [{len(nreal)},{L}] {form}")


@pytest.mark.parametrize("F", [5, 20, 33, 64, 100, 150])
def test_rel_draw_tiles_match_twin_at_their_rows(cuda, F):
    """X10b's tiled form of whole rows at the rows a tile draw_plan gives
    it, from 32 (F = 5) down to one (F = 150), and with one, two, four and
    ten factors a lane in its draw; real entries ending mid-tile and the
    column split."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    t = _rel_bucket(F, 2, 1024, [589, 611], F, True, True, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ks.draw_plan(F, 2, 1024, 589, 611, sms)
    assert plan.form == "tiles" and plan.k == ks.tile_rows(F, True)
    assert plan.S > 1 and (F != 5 or plan.k == 32)
    _check_rel_draw(F, t, f"X10b tiles T={plan.k} F={F}")


@pytest.mark.parametrize("F,L,G", [(5, 1, 8), (20, 8, 8), (24, 8, 8),
                                   (25, 8, 32), (33, 8, 32), (20, 16, 32),
                                   (100, 8, 32)])
def test_rel_draw_warp_lanes_match_twin(cuda, F, L, G):
    """X10b's warp form at F >= 2: 8 lanes a column (four columns a warp,
    up to three factors a lane) on buckets of at most 8 slots at F <= 24,
    else a warp a column; 301 columns (a warp's last groups past the
    bucket's end) of 1 to L real entries."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    t = _rel_bucket(F, 301, L, [1 + c % L for c in range(301)], F + L, True,
                    True, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ks.draw_plan(F, 301, L, 1, L, sms) == ("warp", G, 1)
    _check_rel_draw(F, t, f"X10b warp G={G} L={L} F={F}")


@pytest.mark.parametrize("F", [1, 0])
@pytest.mark.parametrize("L", [1, 2, 8, 16, 32])
def test_rel_draw_narrow_lanes_match_twin(cuda, F, L):
    """X10b's F <= 1 narrow form, G lanes a column, G the next power of two
    >= L (one to 32)."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    t = _rel_bucket(F, 300, L, [1 + c % L for c in range(300)], L, True,
                    True, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    G = ks.narrow_lanes(L)
    assert ks.draw_plan(F, 300, L, 1, L, sms) == ("group", G, 1)
    _check_rel_draw(F, t, f"X10b group G={G} L={L} F={F}")


@pytest.mark.parametrize("poison", [None, "pad_row", "nan_e"])
@pytest.mark.parametrize("C,L", [(1, 1), (150, 7), (70, 40), (23, 300),
                                 (9, 700)])
@pytest.mark.parametrize("F", [2, 3, 4])
def test_col_draw_lanes_matches_twin(cuda, F, C, L, poison):
    """X8a's exact mode at 2 <= F <= 4, its lanes form: 4-32 lanes a
    column, several columns a block (150 columns of 4 lanes: 10 blocks),
    up to 22 slots a lane in rounds of 4 (L = 700); padding entries at the
    pad row in columns past the first, a NaN q there (pad_row: its
    factor's sh2 turns NaN in every padded column, which draws it 0,
    uncounted) or a NaN e at a real row of column 0 (nan_e: its draws NaN,
    counted and reverted); a NaN group lambda (drawn 0, uncounted) and an
    Inf noise number (counted, reverted); q one float off its alignment
    where C is odd (4-byte loads of its rows).  Two launches give the same
    bits and counters, the twin's."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    assert km.col_draw_form(F, C, L).form == "lanes"
    g = torch.Generator().manual_seed(100 * F + L)
    N, D, G = 400, 200, 3
    rows = torch.randint(0, N - 1, (C, L), generator=g, dtype=torch.int32)
    x = torch.rand(C, L, generator=g) + 0.5
    cnt = torch.randint(1, L + 1, (C,), generator=g)
    cnt[0] = L
    pad = torch.arange(L)[None, :] >= cnt[:, None]
    rows[pad], x[pad] = N - 1, 0.0
    cols = torch.randperm(D, generator=g)[:C].to(torch.int32)
    group = (torch.arange(C) % G).to(torch.int32)
    e = torch.randn(N, generator=g)
    qa = 0.1 * torch.randn(N * F + 1, generator=g)
    q = (qa[1:] if C % 2 else qa[:-1]).view(N, F)
    if poison == "pad_row":
        q[N - 1, F - 1] = float("nan")
    elif poison == "nan_e":
        e[rows[0, 0].long()] = float("nan")
    v_t = 0.1 * torch.randn(D, F, generator=g)
    ptab = torch.cat([v_t, torch.zeros(D, F)], 1)
    mu = 0.1 * torch.randn(G, F, generator=g)
    lam = torch.rand(G, F, generator=g) + 1.0
    lam[2] = float("nan")
    z = torch.randn(F, D, generator=g)
    z[F // 2, cols[0].long()] = float("inf")
    alpha = torch.tensor(1.3)
    outs = []
    for dev in (cuda, cuda, "cpu"):
        a = [t.to(dev) for t in (rows, x, cols, group, e)]
        qd = qa.to(dev)
        qd = (qd[1:] if C % 2 else qd[:-1]).view(N, F)
        a += [qd] + [t.to(dev) for t in (ptab.clone(), v_t.clone(), mu, lam,
                                         alpha, z)]
        nans = torch.zeros(2, dtype=torch.int32, device=dev)
        km.mcmc_col_draw(*a[:11], a[11], True, nans)
        outs.append([a[6].cpu(), a[7].cpu(), nans.cpu()])
    what = f"mcmc_col_draw lanes F={F} [{C},{L}] {poison}"
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    chip_smoke.compare(outs[0], outs[2], what)
    assert outs[0][2].tolist() == outs[2][2].tolist(), what
    if poison is None:
        assert outs[0][2].tolist() == [0, 1], what  # the Inf noise number
    elif poison == "nan_e":
        assert outs[0][2][0] > 0, what
    else:
        padded = cols[pad.any(1)].long()
        assert (outs[0][1][padded, F - 1] == 0).all(), what


@pytest.mark.parametrize("F", [20, 33, 64, 100, 256, 303])
def test_col_draw_exact_warp_draw_matches_twin(cuda, F):
    """X8a's exact mode, its draw by one warp: F = 20, 33 and 64 (a lane
    owns two factors), 100 (four slots a lane), 256 and 303 (ten slots a
    lane); a NaN group lambda (drawn 0,
    uncounted) and an Inf noise number (counted, reverted); two launches
    give the same bits and counters, the twin's."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    g = torch.Generator().manual_seed(F)
    N, D, C, L, G = 300, 40, 12, 20, 3
    rows = torch.randint(0, N, (C, L), generator=g, dtype=torch.int32)
    x = torch.rand(C, L, generator=g) + 0.5
    x[-1, L // 2:] = 0.0  # padding entries
    cols = torch.randperm(D, generator=g)[:C].to(torch.int32)
    group = (torch.arange(C) % G).to(torch.int32)
    e = torch.randn(N, generator=g)
    q = 0.1 * torch.randn(N, F, generator=g)
    v_t = 0.1 * torch.randn(D, F, generator=g)
    ptab = torch.cat([v_t, torch.zeros(D, F)], 1)
    mu = 0.1 * torch.randn(G, F, generator=g)
    lam = torch.rand(G, F, generator=g) + 1.0
    lam[2] = float("nan")
    z = torch.randn(F, D, generator=g)
    z[F // 2, cols[0].long()] = float("inf")
    alpha = torch.tensor(1.3)
    outs = []
    for dev in (cuda, cuda, "cpu"):
        a = [t.to(dev) for t in (rows, x, cols, group, e, q, ptab.clone(),
                                 v_t.clone(), mu, lam, alpha, z)]
        nans = torch.zeros(2, dtype=torch.int32, device=dev)
        km.mcmc_col_draw(*a[:11], a[11], True, nans)
        outs.append([a[6].cpu(), a[7].cpu(), nans.cpu()])
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), F
    chip_smoke.compare(outs[0], outs[2], f"mcmc_col_draw exact F={F}")
    assert outs[0][2].tolist() == outs[2][2].tolist() == [0, 1]


# K6's bin: L = 1, 7, 16 (two columns a warp at F = 1), 33, 300 and an
# empty bucket, laid end to end in one launch
_K6_BIN = ((5, 1), (9, 7), (0, 16), (40, 16), (3, 33), (2, 300))


@pytest.mark.parametrize("F", [1, 2, 5, 20, 33])
def test_ovb_bin_launch_matches_twin(cuda, F):
    """K6 on every bucket of a bin in one launch against the twin bucket by
    bucket: padding entries (x = 0) in every column, a tenth of the columns
    with cnt = 0 (zero deltas, tables kept), a NaN residual at one row (its
    columns' candidates NaN, counted and reverted); the counters, tv_add
    and every table match, and two launches give the same bits."""
    _ovb_bin_case(cuda, F, _K6_BIN)


@pytest.mark.parametrize("F", [1, 3])
def test_ovb_bin_of_forty_buckets_matches_twin(cuda, F):
    """A bin of more buckets than a warp has lanes: the kernel finds a
    block's bucket 32 buckets a pass, and the second pass holds the
    last eight (L = 1 to 40)."""
    _ovb_bin_case(cuda, F, tuple((3 + b % 4, 1 + b) for b in range(40)))


def _ovb_bin_case(cuda, F, widths):
    import chip_smoke
    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.learners.base import BlockData

    rng = np.random.default_rng(F)
    N, G = 700, 2
    D = sum(C for C, _ in widths) + 7

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(cuda)

    cols = rng.permutation(D)
    buckets, at = [], 0
    for C, L in widths:
        rows = rng.integers(0, N - 1, (C, L))
        x = rng.uniform(0.5, 1.5, (C, L))
        n = rng.integers(1, L + 1, C)
        pad = np.arange(L)[None, :] >= n[:, None]
        rows[pad], x[pad] = N - 1, 0.0
        cnt = n * (rng.random(C) > 0.1)
        buckets.append(BlockData(
            rows=t(rows, np.int32), x=t(x), cols=t(cols[at:at + C], np.int32),
            group=t(rng.integers(0, G, C), np.int32), sx2=t((x * x).sum(1)),
            cnt=t(cnt), col_count=t(cnt * rng.uniform(5, 20, C))))
        at += C
    plan = ko.BinPlan(buckets)
    e = rng.normal(0, 1, N)
    e[int(buckets[3].rows[0, 0])] = np.nan
    ptab = np.zeros((D, 5 * F))
    ptab[:, :F] = rng.normal(0, 0.3, (D, F))
    ptab[:, F:2 * F] = rng.uniform(0.01, 0.1, (D, F))
    fixed = (t(e), t(rng.normal(0, 1, (N, F))), t(rng.uniform(0, 1, (N, F))))
    tail = (t(rng.uniform(0.5, 2.0, (G, F))),
            torch.tensor(1.3, device=cuda), t(rng.uniform(0.1, 1.0, D)))

    def state():
        return [t(ptab), t(ptab[:, :F]), t(ptab[:, F:2 * F]),
                t(rng.normal(0, 5, (D, F))), t(rng.uniform(20, 60, (D, F))),
                torch.zeros(D, device=cuda),
                torch.zeros(4, dtype=torch.int32, device=cuda)]

    base = state()
    outs = []
    for fn in (ko.ovb_col_stats_update, ko.ovb_bin_update_plain,
               ko.ovb_col_stats_update):
        s = [a.clone() for a in base]
        fn(plan, *fixed, *s[:5], *tail, *s[5:])
        outs.append(s)
    torch.cuda.synchronize()
    chip_smoke.compare(outs[0], outs[1], f"ovb bin F={F}")
    for a, b in zip(outs[0], outs[2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    bad = outs[0][-1]
    assert bad[0] > 0 and torch.equal(bad, outs[1][-1])
    zero = torch.cat([b.cols[b.cnt == 0] for b in buckets]).long()
    assert zero.numel() > 0
    assert not outs[0][0][zero, 2 * F:].any()
    assert torch.equal(outs[0][1][zero], base[1][zero])


@pytest.mark.parametrize("mode", ["regression", "sgda", "pair"])
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 1024, 4096])
@pytest.mark.parametrize("D", [9992, 82248])
@pytest.mark.parametrize("K", [1, 5, 20, 40])
def test_sgd_apply_matches_twin(cuda, K, D, B, P, mode):
    """X9b over the batch's own attributes against the dense twin, after
    X9a's kernel, whose owner record X9b reads: each attribute the batch
    names (BPR's sampled items too) is owned by an entry naming it.  K = 1
    and 5 give an entry a group of 2 or 8 lanes, K = 40 loops over its
    channels.  Duplicate ids, x = 0 entries, valid = 0 rows, an inf target
    in a valid row and an inf in one accumulator row (inf and NaN
    gradients), SGDA's winners, BPR's negatives (one equal to its row's
    item); NaN, +inf, -inf and -0 in table rows no entry names, which keep
    their bits (their values, NaN for NaN, where the batch names D entries
    or more and the kernel steps every attribute: B = 4096 at D = 9,992
    with P = 3, or P = 2 and pairs; pairs of B = 1024 at D = 9,992 name
    fewer); two launches the same bits; the owners read, not changed."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import sgd_step as ks

    rng = np.random.default_rng(D + 10 * B + P + 100_000 * K)
    G, lo = 2, D // 2

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(cuda)

    ids = np.concatenate([rng.integers(0, 2000, (B, 1)),
                          rng.integers(lo, lo + 2000, (B, P - 1))], 1)
    vals = rng.uniform(0.5, 1.5, (B, P)) * (rng.random((B, P)) > 0.1)
    valid = (rng.random(B) > 0.1).astype(np.float32)
    y = rng.uniform(1, 5, B)
    if B > 1:
        valid[1] = 1.0
        y[1] = np.inf
    neg = rng.integers(lo, D - 4, B)
    neg[0] = ids[0, -1]
    tab = rng.normal(0, 0.1, (D, 1 + K))
    tab[[D - 1, D - 2, D - 3, D - 4]] = np.array(
        [np.nan, np.inf, -np.inf, -0.0])[:, None]
    bt = (t(ids, np.int32), t(vals), t(y), t(valid))
    m = ks.StepMode(ks.LOSS_PAIR if mode == "pair" else ks.LOSS_REGRESSION,
                    K=K, lr=0.05, mult_scale=2.0 if mode == "sgda" else 1.0,
                    min_target=1.0, max_target=5.0, base_w=0.999,
                    base_v=0.998, w0_base=0.9999, w0_grad=mode != "pair")
    sgda = mode == "sgda"
    ws = ks.make_workspace(D, K, cuda, sgda_batch=(B, P) if sgda else None)
    pair = (t(neg, np.int32), lo, D) if mode == "pair" else None
    ks.sgd_grad_scatter(t(tab), torch.tensor(3.5, device=cuda), *bt, ws, m,
                        pair, record=sgda)
    entries = ks.apply_entries(bt[0], pair and pair[0]).long()
    assert torch.equal(entries[ws.owner[entries].long()], entries)
    ws.acc[int(ids[0, 0]), 2] = np.inf  # an inf gradient, in every mode
    regs = (t(rng.uniform(0, 0.5, G)), t(rng.uniform(0, 0.5, (G, K))),
            t(np.arange(D) >= lo, np.int32))
    grad_tab = rng.normal(0, 0.1, (D, 1 + K))

    def run(kernel):
        w = ks.Workspace(**{k: None if v is None else v.clone()
                            for k, v in vars(ws).items()})
        tb, w0, gt = t(tab), torch.tensor(3.5, device=cuda), t(grad_tab)
        if kernel:
            ks.sgd_apply(tb, w0, w, m, bt[0], pair and pair[0],
                         regs + (gt,) if sgda else None)
        else:
            ks.sgd_apply_plain(tb, w0, w.acc, w.acc0, m, regs + (
                w.winner, w.gw_e, w.gv_e, gt) if sgda else None)
        return [tb, w0, w.acc, w.acc0, gt] + (
            [w.winner] if sgda else []), w.owner

    (ok, owner), (op, _), (ok2, _) = run(True), run(False), run(True)
    torch.cuda.synchronize()
    chip_smoke.compare(ok, op, f"sgd_apply {mode} K={K} D={D} B={B} P={P}")
    for a, b in zip(ok, ok2):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(owner, ws.owner)
    assert not ok[2].any() and not ok[3].any()
    named = torch.zeros(D, dtype=torch.bool, device=cuda)
    named[entries] = True
    free = ~named
    assert free[-4:].all()
    if ids.size + (B if mode == "pair" else 0) < D:
        assert torch.equal(ok[0][free].view(torch.int32),
                           t(tab)[free].view(torch.int32))
    else:
        assert torch.equal(ok[0][free].nan_to_num(), t(tab)[free].nan_to_num())
        assert torch.equal(ok[0][free].isnan(), t(tab)[free].isnan())
    assert not torch.isfinite(ok[0][named]).all()


def _lambda_case(cuda, Bv, G, K, P, nan_target=False, seed=0,
                 loss=None):
    """X9c's inputs: Bv validation rows of P entries over D = 60
    attributes in G groups (attribute d in group d % G, so a row's entries
    share groups), duplicate ids, an x = 0 entry in every third row, a
    valid-0 row; a NaN target in row Bv // 2 on request; ``loss``
    LOSS_CLASSIFICATION: +-1 targets and the classification grad_loss."""
    from svbfm_tpu_torch.kernels import sgd_step as ks

    rng = np.random.default_rng(seed + 1000 * Bv + 100 * K + 10 * G + P)
    D = 60

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(cuda)

    ids = rng.integers(0, D, (Bv, P))
    vals = rng.uniform(0.5, 1.5, (Bv, P))
    vals[::3, P - 1] = 0.0
    y = (np.where(rng.random(Bv) < 0.5, 1.0, -1.0)
         if loss == ks.LOSS_CLASSIFICATION else rng.uniform(1, 5, Bv))
    valid = np.ones(Bv)
    if Bv > 1:
        valid[1] = 0.0
    if nan_target:
        y[Bv // 2] = np.nan
    m = ks.StepMode(loss if loss is not None else ks.LOSS_REGRESSION, K=K,
                    lr=0.05, mult_scale=2.0, min_target=1.0, max_target=5.0)
    fixed = (t(rng.normal(0, 0.3, (D, 1 + K))),
             t(rng.normal(0, 0.1, (D, 1 + K))), torch.tensor(3.0, device=cuda))
    regs = (t(rng.uniform(0, 0.05, G)), t(rng.uniform(0, 0.05, (G, K))))
    rest = (t(np.arange(D) % G, np.int32), t(ids, np.int32), t(vals), t(y),
            t(valid))
    return fixed, regs, rest, ks.make_workspace(D, K, cuda), m


@pytest.mark.parametrize("G,P", [(1, 1), (3, 3), (7, 6)])
@pytest.mark.parametrize("K", [1, 5, 20, 40])
@pytest.mark.parametrize("Bv", [0, 1, 10, 113, 256, 257, 1000, 3000])
def test_sgda_lambda_cluster_matches_twin(cuda, Bv, G, K, P):
    """X9c's one cluster against the twin: 1 to 8 blocks of 32 warps (a
    row a warp up to Bv = 256, several rows a warp past it), one to seven
    groups, one factor to more than a warp's lanes of channels (K = 40),
    one to six entries a row (past the four a lane holds at P = 6), two
    entries of one group in a row, x = 0 entries, a valid-0 row and the
    empty batch (the regs still step); two launches give the same bits
    (the warps' and blocks' sums fold in a fixed order)."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import sgd_step as ks

    fixed, regs, rest, ws, m = _lambda_case(cuda, Bv, G, K, P)
    outs = []
    for kernel in (True, False, True):
        rw, rv = (r.clone() for r in regs)
        if kernel:
            ks.sgda_lambda(*fixed[:3], rw, rv, *rest, ws, m)
        else:
            ks.sgda_lambda_plain(*fixed[:3], rw, rv, *rest, m)
        outs.append([rw, rv])
    torch.cuda.synchronize()
    chip_smoke.compare(outs[0], outs[1], f"sgda_lambda Bv={Bv} G={G} K={K} "
                       f"P={P}")
    for a, b in zip(outs[0], outs[2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if Bv > 1:  # (a lone entry has no pair terms: reg_v's gradient is
        # 0 at P = 1, up to rounding)
        assert not torch.equal(outs[0][0], regs[0])
        assert P == 1 or not torch.equal(outs[0][1], regs[1])


@pytest.mark.parametrize("K", [5, 20])
@pytest.mark.parametrize("Bv", [1000, 3000])
def test_sgda_lambda_eight_block_fallback_matches_twin(cuda, Bv, K):
    """X9c's cluster cut to 8 blocks, the launch the kernel falls back to
    where the card holds no cluster of 16 (forced here by its block cap):
    against the twin at Bv = 1,000 and 3,000, several rows a warp; two
    launches give the same bits."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import sgd_step as ks

    fixed, regs, rest, ws, m = _lambda_case(cuda, Bv, 3, K, 3)
    outs = []
    for kernel in (True, False, True):
        rw, rv = (r.clone() for r in regs)
        if kernel:
            ks.sgda_lambda(*fixed[:3], rw, rv, *rest, ws, m, max_blocks=8)
        else:
            ks.sgda_lambda_plain(*fixed[:3], rw, rv, *rest, m)
        outs.append([rw, rv])
    torch.cuda.synchronize()
    chip_smoke.compare(outs[0], outs[1], f"sgda_lambda 8 blocks Bv={Bv} "
                       f"K={K}")
    for a, b in zip(outs[0], outs[2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("Bv", [10, 300])
def test_sgda_lambda_nan_target_poisons_every_reg(cuda, Bv):
    """A NaN target makes grad_loss NaN, which JAX's dense segment sums
    carry into every group: every reg of the kernel is NaN, as the
    twin's."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import sgd_step as ks

    fixed, regs, rest, ws, m = _lambda_case(cuda, Bv, 3, 5, 3,
                                            nan_target=True)
    outs = []
    for kernel in (True, False):
        rw, rv = (r.clone() for r in regs)
        if kernel:
            ks.sgda_lambda(*fixed[:3], rw, rv, *rest, ws, m)
        else:
            ks.sgda_lambda_plain(*fixed[:3], rw, rv, *rest, m)
        outs.append([rw, rv])
    torch.cuda.synchronize()
    chip_smoke.compare(outs[0], outs[1], f"sgda_lambda NaN Bv={Bv}")
    assert all(torch.isnan(o).all() for o in outs[0])


@pytest.mark.parametrize("P", [2, 3, 40])
@pytest.mark.parametrize("K", [1, 5, 20, 40])
@pytest.mark.parametrize("mode", ["regression", "exp", "sgda", "pair",
                                  "classification", "poisson"])
def test_sgd_grad_scatter_matches_twin(cuda, mode, K, P):
    """X9a from one gather a row against its twin in every mode: a user,
    an item and P - 2 attribute entries a row (P = 40: more entries than
    a warp has lanes, and than the four a lane holds), x = 0 entries,
    valid-0 rows, duplicate ids, a pair whose negative equals its own
    item.  acc, acc0 and SGDA's record match; the owner record names, at
    every attribute of the batch (the pairs' sampled items too), an entry
    naming it; X9b's kernel on that record gives the twin's step."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import sgd_step as ks

    rng = np.random.default_rng(1000 * K + P + {
        "regression": 0, "exp": 1, "sgda": 2, "pair": 3, "classification": 4,
        "poisson": 5}[mode])
    B, U, I, D = 600, 300, 200, 700

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(cuda)

    ids = np.concatenate([rng.integers(0, U, (B, 1)),
                          rng.integers(U, U + I, (B, 1)),
                          rng.integers(U + I, D, (B, P - 2))], 1)[:, :P]
    vals = rng.uniform(0.5, 1.5, (B, P)) * (rng.random((B, P)) > 0.1)
    valid = (rng.random(B) > 0.1).astype(np.float32)
    neg = rng.integers(U, U + I, B)
    neg[0] = ids[0, 1] if P > 1 else neg[0]
    m = ks.StepMode({"exp": ks.LOSS_EXP, "pair": ks.LOSS_PAIR,
                     "classification": ks.LOSS_CLASSIFICATION,
                     "poisson": ks.LOSS_POISSON}.get(
        mode, ks.LOSS_REGRESSION), K=K, lr=0.05, stdev=1.5,
        mult_scale=2.0 if mode == "sgda" else 1.0, min_target=1.0,
        max_target=5.0, base_w=0.999, base_v=0.998, w0_base=0.9999,
        w0_grad=mode != "pair")
    y = (np.where(rng.random(B) < 0.5, 1.0, -1.0) if mode == "classification"
         else rng.uniform(1, 5, B))
    bt = (t(ids, np.int32), t(vals), t(y), t(valid))
    tab, w0 = t(rng.normal(0, 0.1, (D, 1 + K))), torch.tensor(3.0,
                                                             device=cuda)
    sgda = mode == "sgda"
    pair = (t(neg, np.int32), U, U + I) if mode == "pair" else None
    wss = [ks.make_workspace(D, K, cuda, sgda_batch=(B, P) if sgda else None)
           for _ in range(2)]
    ks.sgd_grad_scatter(tab, w0, *bt, wss[0], m, pair, record=sgda)
    ks.sgd_grad_scatter_plain(tab, w0, *bt, wss[1].acc, wss[1].acc0,
                              wss[1].owner, m, pair,
                              (wss[1].gw_e, wss[1].gv_e, wss[1].winner)
                              if sgda else None)
    torch.cuda.synchronize()
    chip_smoke.compare(
        *([w.acc, w.acc0] + ([w.gw_e, w.gv_e, w.winner] if sgda else [])
          for w in wss), f"sgd_grad_scatter {mode} K={K} P={P}")
    assert wss[0].acc.any()
    entries = ks.apply_entries(bt[0], pair and pair[0]).long()
    assert torch.equal(entries[wss[0].owner[entries].long()], entries)
    # X9b on each accumulator: the kernel on X9a's kernel's, the twin on
    # the twin's
    regs = ((t(rng.uniform(0, 0.5, 2)), t(rng.uniform(0, 0.5, (2, K))),
             t(np.arange(D) >= U, np.int32)) if sgda else ())
    steps = []
    for w, kernel in zip(wss, (True, False)):
        tb, w0s = tab.clone(), w0.clone()
        gt = torch.zeros(D, 1 + K, device=cuda)
        if kernel:
            ks.sgd_apply(tb, w0s, w, m, bt[0], pair and pair[0],
                         regs + (gt,) if sgda else None)
        else:
            ks.sgd_apply_plain(tb, w0s, w.acc, w.acc0, m, regs + (
                w.winner, w.gw_e, w.gv_e, gt) if sgda else None)
        steps.append([tb, w0s, w.acc, w.acc0, gt])
    torch.cuda.synchronize()
    chip_smoke.compare(*steps, f"sgd_apply after X9a {mode} K={K} P={P}")


def _offset_view(a, aligned, dev, shift=1):
    """``a`` on ``dev``, contiguous, at a 16-byte-aligned address or, not
    ``aligned``, ``shift`` elements past one (a view into a flat buffer:
    4 bytes past it, or 8 with shift 2), so that the kernels' vector
    loads must give way."""
    if aligned:
        return a.to(dev).contiguous()
    buf = torch.zeros(a.numel() + shift, dtype=a.dtype, device=dev)
    v = buf[shift:].view(a.shape)
    v.copy_(a)
    assert v.is_contiguous() and (v.numel() == 0 or v.data_ptr() % 16 != 0)
    return v


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("npos", [1, 6])
@pytest.mark.parametrize("R", [1, 301])
@pytest.mark.parametrize("F", [0, 1, 2, 3, 4, 5, 8, 16, 20, 31, 32, 33, 64,
                               128, 251])
def test_rel_patch_forms_match_twin(cuda, F, R, npos, aligned):
    """X10c in each form (a thread a row at F <= 1, G lanes a row to
    F = 32, a block a row past it) against its twin: R = 1 and R = 301 (no
    multiple of any form's rows a block), one position and six (two
    chunks of staged positions, out of order), the relation table and ptab
    at aligned and unaligned bases; row 0 holds an Inf (wcc, at F = 0 wn)
    and ptab some zero dv, so that 0 inf makes NaN where the twin does;
    two launches give the same bits."""
    _rel_patch_case(cuda, F, R, npos, aligned)


@pytest.mark.parametrize("npos", [1, 6])
@pytest.mark.parametrize("rounds", [None, 2])
@pytest.mark.parametrize("F", [2, 8, 20, 32])
def test_rel_patch_persistent_walk_matches_twin(cuda, F, rounds, npos):
    """X10c's lanes form on more rows than its persistent grid holds at
    once, so that each group walks several rows: R = 70,001 and, from the
    card's SM count, two rounds of the most blocks an SM holds (four, at
    the kernel's 64 registers a thread) plus 13 rows (the last rows past R
    inside a warp of several rows at G < 32); one position and six (the
    k0 > 0 restage of ptab while the next row's copies are in flight);
    against the twin, two launches the same bits."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    p = ks.patch_plan(F)
    assert p.form == "lanes"
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    R = 70_001 if rounds is None else rounds * sms * 4 * p.rows + 13
    _rel_patch_case(cuda, F, R, npos, True)


def _rel_patch_case(cuda, F, R, npos, aligned):
    import chip_smoke
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    g = torch.Generator().manual_seed(100 * F + R + npos)
    Fo, Pr, Dr = max(F, 1), 7, 40
    lay = ks.rel_layout(F)
    rids = torch.randint(0, Dr, (R, Pr), generator=g, dtype=torch.int32)
    rvals = torch.rand(R, Pr, generator=g) + 0.5
    rvals[::5, 3] = 0.0  # padding entries
    pos = torch.tensor([3, 0, 6, 2, 5, 1][:npos], dtype=torch.int32)
    ptab = torch.cat([0.1 * torch.randn(Dr, Fo, generator=g),
                      0.05 * torch.randn(Dr, Fo, generator=g)], 1)
    ptab[:5, Fo:] = 0.0  # columns the bin left as they were
    rids[0, :] = torch.arange(Pr, dtype=torch.int32) % 5
    rtab = _rel_table(g, F, R)
    rtab[0, lay["wcc"] if F else lay["wn"]] = float("inf")
    dy = 0.1 * torch.randn(R, Fo, generator=g)
    outs = []
    for run in ("kernel", "kernel", "cpu"):
        dev = "cpu" if run == "cpu" else cuda
        rt = _offset_view(rtab, aligned or run == "cpu", dev)
        pt = _offset_view(ptab, aligned or run == "cpu", dev)
        d = dy.to(dev)
        args = (rids.to(dev), rvals.to(dev), pos.to(dev), pt)
        if F:
            ks.bs_rel_patch(*args, F, rt, d)
        else:
            ks.bs_rel_w_patch(*args, rt, d)
        outs.append([rt.cpu(), d.cpu()])
    torch.cuda.synchronize()
    what = f"bs_rel_patch F={F} R={R} npos={npos} aligned={aligned}"
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    assert not torch.isfinite(outs[2][0][0]).all(), what
    chip_smoke.compare(outs[0], outs[2], what)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("N", [1, 1001])
@pytest.mark.parametrize("form", ["full", "q-build", "dy"])
@pytest.mark.parametrize("F", [1, 2, 3, 5, 8, 20, 33, 64, 251])
def test_resync_forms_match_twin(cuda, F, form, N, aligned):
    """X10d's resync in its three forms (after a v sweep: dy, qB1, qB0, q
    and e; the q build: qB1 and q alone; the w resync: dy and e) against
    its twin: qB1 a strided view of a wider table at an aligned row stride
    (a multiple of 4) and at an odd one, q and e at aligned and unaligned
    bases, a join with repeats over 37 relation rows, N = 1 and 1,001 (no
    multiple of the rows a warp or a thread); two launches give the same
    bits."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import bs_forward as kf

    g = torch.Generator().manual_seed(10 * F + N)
    R = 37
    ld1 = (F + 4) // 4 * 4 if aligned else F + 1 + F % 2
    join = torch.randint(0, R, (N,), generator=g, dtype=torch.int32)
    big = torch.randn(R, ld1, generator=g)
    qb0 = 0.5 * torch.randn(R, F, generator=g)
    dy = 0.1 * torch.randn(R, F, generator=g)
    q = torch.randn(N, F, generator=g)
    e = torch.randn(N, generator=g)
    use = dict(full=(True, True, True, True), dy=(True, False, False, True),
               **{"q-build": (False, True, False, False)})[form]
    outs = []
    for run in ("kernel", "kernel", "cpu"):
        dev = "cpu" if run == "cpu" else cuda
        qb1 = big.to(dev)[:, :F]
        assert qb1.stride(0) == ld1
        qr = _offset_view(q, aligned or run == "cpu", dev)
        er = _offset_view(e, aligned or run == "cpu", dev)
        args = [a.to(dev) if u else None
                for a, u in zip((dy, qb1, qb0), use)]
        kf.bs_resync(join.to(dev), F, *args, qr if use[1] else None,
                     er if use[3] else None)
        outs.append([qr.cpu(), er.cpu()])
    torch.cuda.synchronize()
    what = f"bs_resync {form} F={F} N={N} aligned={aligned}"
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    chip_smoke.compare(outs[0], outs[2], what)


_K1_K = [0, 1, 3, 4, 5, 8, 20, 21, 32, 33, 64, 130]
_K1_LAYOUTS = ["padded", "sgd", "sliced"]
_K1_POISONS = [None, "nan_row", "inf_row", "nan_x", "inf_pad"]


def _k1_case(cuda, tterms, K, P, N, layout, poison):
    """K1a (``tterms`` False) or K1b on a seeded case, on the card, against
    its twin on the same view; returns the plan."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import fm_forward as k1
    from svbfm_tpu_torch.ops import forward as fwd

    rng = np.random.default_rng([K, P, N, _K1_LAYOUTS.index(layout),
                                 _K1_POISONS.index(poison), int(tterms)])
    D = 40
    ids = rng.integers(0, D - 1, (N, P))
    vals = rng.uniform(0.5, 1.5, (N, P))
    # padding entries: x = 0 at the pad row D - 1 (at P = 1, empty rows)
    ids[1::3, -1], vals[1::3, -1] = D - 1, 0.0
    w = rng.normal(0, 0.3, D)
    sw = rng.uniform(0.01, 0.1, D)
    v = rng.normal(0, 0.3, (K, D))
    sv = rng.uniform(0.01, 0.1, (K, D))
    lin, fac = (sw, sv) if tterms else (w, v)
    if N > 3:
        ids[0, 0], ids[3, 0] = 5, 7
    if poison == "nan_row":  # a factor channel of row 5 (w at K = 0)
        if K:
            fac[K - 1, 5] = np.nan
        else:
            lin[5] = np.nan
    elif poison == "inf_row":  # the linear channel of row 7
        lin[7] = np.inf
    elif poison == "nan_x" and N > 2:
        vals[2, 0] = np.nan
    elif poison == "inf_pad":  # x = 0 there: the twin's Inf * 0
        lin[D - 1] = np.inf

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(cuda)

    if tterms:
        dense = np.concatenate([sw[:, None], v.T, sv.T], 1)
    else:
        dense = np.concatenate([w[:, None], v.T], 1)
    if layout == "padded":  # as ops/forward.py builds it
        tab = (fwd.t_term_table(t(sw), t(v), t(sv)) if tterms
               else fwd.score_table(t(w), t(v)))
    elif layout == "sgd":  # contiguous [D, 1+K]: the SGD family's
        tab = t(dense)
    else:  # one float into a wider table: base and stride unaligned
        buf = torch.zeros(D, dense.shape[1] + 1, device=cuda)
        buf[:, 1:] = t(dense)
        tab = buf[:, 1:]
    ids_t, vals_t = t(ids, torch.int32), t(vals)
    scalar = torch.tensor(0.02 if tterms else 0.3, device=cuda)
    name = "fm_t_terms" if tterms else "fm_scores"
    op = k1.fm_t_terms_op if tterms else k1.fm_scores_op
    plain = k1.fm_t_terms_plain if tterms else k1.fm_scores_plain
    before = build.launch_counts[name]
    outs = [op(tab, scalar, ids_t, vals_t), op(tab, scalar, ids_t, vals_t),
            plain(tab, scalar, ids_t, vals_t)]
    torch.cuda.synchronize()
    assert build.launch_counts[name] == before + (2 if N else 0)
    p = k1.fm_plan(tab, K, P)
    what = f"{name} K={K} P={P} N={N} {layout} {poison} {p}"
    assert outs[0].shape == (N,), what
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    chip_smoke.compare(outs[:1], outs[2:], what)
    if poison and N > 3:
        assert not torch.isfinite(outs[0]).all(), what
    return p


@pytest.mark.parametrize("poison", _K1_POISONS)
@pytest.mark.parametrize("layout", _K1_LAYOUTS)
@pytest.mark.parametrize("N", [0, 1001])
@pytest.mark.parametrize("P", [1, 2, 3, 7])
@pytest.mark.parametrize("K", _K1_K)
def test_fm_scores_forms_match_twin(cuda, K, P, N, layout, poison):
    """K1a in its chunked form (min(ceil(K / 4), 32) lanes a row, several
    rows a warp, lanes looping past K = 128), in its P = 2 build and at any
    P, on the padded table ops/forward.py builds (16-byte loads where K
    allows), on the SGD family's contiguous [D, 1+K] and on a table one
    float into a wider one (loads narrowed); N = 1,001 (a ragged last
    warp) and 0; padding entries at the pad row; a NaN in a table row, an
    Inf in w, a NaN x and an Inf at the pad row (x = 0): the twin's values,
    NaN and Inf where it has them; two launches the same bits."""
    p = _k1_case(cuda, False, K, P, N, layout, poison)
    assert p.lanes == max(1, min(-(-K // 4), 32)) and p.rows == 32 // p.lanes
    if layout == "padded" and K % 4 == 0 and K:
        assert p.vec == 4
    if layout != "padded":
        assert p.vec == 1


@pytest.mark.parametrize("poison", _K1_POISONS)
@pytest.mark.parametrize("layout", _K1_LAYOUTS)
@pytest.mark.parametrize("N", [0, 1001])
@pytest.mark.parametrize("P", [1, 2, 3, 7])
@pytest.mark.parametrize("K", _K1_K)
def test_fm_t_terms_forms_match_twin(cuda, K, P, N, layout, poison):
    """K1b in the same forms, cases and poisons as K1a's test (the NaN in
    a row is in its s channel, the Inf in its sw)."""
    p = _k1_case(cuda, True, K, P, N, layout, poison)
    if layout == "padded" and K % 4 == 0 and K:
        assert p.vec == 4


_BS_K = [0, 1, 3, 8, 20, 33, 130]


@pytest.mark.parametrize("poison", [None, "nan", "inf"])
@pytest.mark.parametrize("layout", ["table", "sliced"])
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("nrel", [0, 1, 2, 9])
@pytest.mark.parametrize("K", _BS_K)
def test_bs_scores_forms_match_twin(cuda, K, nrel, P, layout, poison):
    """bs_scores, K1a's kernel in its relations mode: K1a's lanes (1 at
    K <= 4, 5 at K = 20, 32 looping at K = 130), its P = 1 build and any
    P, 0-9 relations (five batches of two at 9), on moments tables at
    the stride moments_table gives (16-byte loads where K allows) and on
    rows one float into a wider buffer (4-byte loads); a ragged last warp;
    padding entries; a NaN or an Inf in a moments row's qB and in another
    row's sumsB: the twin's values, NaN and Inf where it has them; two
    launches the same bits, the launch counted."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import bs_forward as kf

    rng = np.random.default_rng(1000 * K + 100 * nrel + 10 * P)
    N, D = 1001, 30

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(cuda)

    ids = rng.integers(1, D, (N, P))
    vals = rng.uniform(-1, 2, (N, P))
    if P > 1:
        ids[1::2, -1], vals[1::2, -1] = 0, 0.0
    stab = t(rng.normal(0, 0.3, (D, 1 + K)))
    joins, moms = [], []
    for r in range(nrel):
        R = 5 + 3 * r
        m = rng.normal(0, 0.3, (R, K + 2))
        m[:, K + 1] = np.abs(m[:, K + 1])
        if poison and r == 0:
            m[2, min(1, K)] = np.nan if poison == "nan" else np.inf
            m[3, K + 1] = np.nan if poison == "nan" else np.inf
        if layout == "table":
            tab = kf.moments_table(R, K, cuda)
        else:
            tab = torch.zeros(R, K + 3, device=cuda)[:, 1:]
        moms.append(tab.copy_(t(m)))
        j = rng.integers(0, R, N)
        j[:4] = [2, 3, 2, 3]
        joins.append(t(j, np.int32))
    args = (stab, torch.tensor(0.2, device=cuda), t(ids, np.int32), t(vals),
            joins, moms)
    before = build.launch_counts["bs_scores"]
    outs = [kf.bs_scores(*args), kf.bs_scores(*args),
            kf.bs_scores_plain(*args)]
    torch.cuda.synchronize()
    assert build.launch_counts["bs_scores"] == before + 2
    p = kf.scores_plan_of(stab, args[2], moms)
    what = f"bs_scores K={K} relations={nrel} P={P} {layout} {poison} {p}"
    assert p.vec == (4 if K and K % 4 == 0 and (layout == "table" or not nrel)
                     else 1), what
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    chip_smoke.compare(outs[:1], outs[2:], what)
    if poison and nrel:  # rows 0-3 join the poisoned rows 2 and 3 (at
        # K = 0 sumsB is not read: row 3's poison shows only where K > 0)
        bad = outs[0][:4] if K else outs[0][0:4:2]
        assert not torch.isfinite(bad).any(), what


@pytest.mark.parametrize("mode", ["qt", "q", "q0"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("stride", ["2F", "5F+2"])
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("F", [1, 2, 3, 20, 33])
def test_build_qt_forms_match_twin(cuda, F, P, stride, aligned, mode):
    """K2 (mode "qt": q, tq, tz) and X8d (q alone, from 0 or from a
    starting q0) in their forms: a thread a row at F = 1 (its P = 2 build
    on 8-byte aligned ids and x), lanes over a row's chunks of 4, 2 or 1
    factors at F >= 2 (32 lanes looping at F = 33), on patch tables of
    stride 2F (X8d's) and 5F + 2 (K2's fast mode); not ``aligned``: ptab,
    ids, vals and q0 one element past a 16-byte boundary, where the
    vector loads must give way; padding entries; a NaN mu and an Inf sig
    in the row of attribute 7, which row 0 holds: the twin's values, NaN
    and Inf where it has them; two launches the same bits."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    rng = np.random.default_rng(1000 * F + 100 * P + 10 * aligned
                                + (stride == "2F"))
    N, D = 1001, 30
    CH = 2 * F if stride == "2F" else 5 * F + 2
    ids = rng.integers(1, D, (N, P))
    vals = rng.uniform(-1, 2, (N, P))
    if P > 1:
        ids[1::2, -1], vals[1::2, -1] = 0, 0.0
    ids[0, 0] = 7
    ptab = rng.normal(0, 0.3, (D, CH))
    ptab[:, F:2 * F] = rng.uniform(0.01, 0.1, (D, F))
    ptab[7, 0], ptab[7, 2 * F - 1] = np.nan, np.inf
    ptab_t = _offset_view(torch.from_numpy(ptab.astype(np.float32)),
                          aligned, cuda)
    ids_t = _offset_view(torch.from_numpy(ids.astype(np.int32)), aligned,
                         cuda)
    vals_t = _offset_view(torch.from_numpy(vals.astype(np.float32)),
                          aligned, cuda)
    q0 = None
    if mode == "q0":
        q0 = _offset_view(torch.from_numpy(
            rng.normal(0, 1, (N, F)).astype(np.float32)), aligned, cuda)
    name = "vb_build_qt" if mode == "qt" else "build_q"
    before = build.launch_counts[name]
    if mode == "qt":
        fns = (kv.vb_build_qt, kv.vb_build_qt, kv.vb_build_qt_plain)
        outs = [list(fn(ptab_t, F, ids_t, vals_t)) for fn in fns]
    else:
        fns = (kv.build_q, kv.build_q, kv.build_q_plain)
        outs = [[fn(ptab_t, F, ids_t, vals_t, q0)] for fn in fns]
    torch.cuda.synchronize()
    assert build.launch_counts[name] == before + 2
    p = kv.qt_plan_of(ptab_t, F, ids_t, vals_t, q0)
    what = f"{name} F={F} P={P} CH={CH} aligned={aligned} {mode} {p}"
    if F == 1:
        assert p.build == ("p2" if P == 2 and aligned else "any"), what
    elif not aligned:
        assert p.vec == 1, what
    else:
        assert p.vec == (4 if F % 4 == 0 and CH % 4 == 0 else
                         2 if F % 2 == 0 else 1), what
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    chip_smoke.compare(outs[0], outs[2], what)
    assert not torch.isfinite(outs[0][0][0]).all(), what


@pytest.mark.parametrize("als", [False, True])
def test_bs_main_block_on_gpu_matches_cpu(cuda, als):
    """The block-structure sampler with a main block that is not empty
    (chip_smoke.py's small problem with the users as one-hot main columns,
    the items a relation, K = 5, factor_block 0): the blocked main-block
    pass starts X8d from the relations' part of the q cache (q_extra),
    card against CPU from one init and one host-table draw source, 3
    sweeps."""
    import chip_smoke
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.models.fm import init_fm_params

    hists = []
    for dev in (cuda, "cpu"):
        learner = chip_smoke.small_bs_learner(dev, K=5, als=als,
                                              main_users=True)
        assert learner.train_row.ids.shape[1] == 1
        p = init_fm_params(torch.Generator().manual_seed(3),
                           learner.cfg.num_attributes, 5, init_w_normal=True)
        state = learner.state_from_params(p.w0, p.w, p.v, host_draws(4, dev))
        before = build.launch_counts["build_q"]
        hists.append(learner.run(state, num_iter=3, verbose=False)[1])
        if dev == cuda:
            assert build.launch_counts["build_q"] > before
    for g, c in zip(*hists):
        for k in ("rmse", "rmse_this", "mae", "alpha"):
            np.testing.assert_allclose(g[k], c[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("K", [1, 5, 20, 40])
@pytest.mark.parametrize("Bv", [1, 113, 1000])
def test_sgda_lambda_classification_matches_twin(cuda, Bv, K):
    """X9c's classification grad_loss y (sigmoid(y p) - 1), p not clamped
    (sgd.py:226-229; the Poisson task takes it too) against the twin on
    +-1 targets; two launches give the same bits."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import sgd_step as ks

    fixed, regs, rest, ws, m = _lambda_case(cuda, Bv, 3, K, 3,
                                            loss=ks.LOSS_CLASSIFICATION)
    assert ks.lambda_class_loss(m)
    outs = []
    for kernel in (True, False, True):
        rw, rv = (r.clone() for r in regs)
        if kernel:
            ks.sgda_lambda(*fixed[:3], rw, rv, *rest, ws, m)
        else:
            ks.sgda_lambda_plain(*fixed[:3], rw, rv, *rest, m)
        outs.append([rw, rv])
    torch.cuda.synchronize()
    chip_smoke.compare(outs[0], outs[1], f"sgda_lambda classification "
                       f"Bv={Bv} K={K}")
    for a, b in zip(outs[0], outs[2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(outs[0][0], regs[0])


def _probit_rows(cuda, n, seed):
    """X12a/X12b inputs of n rows: e and scores N(0, 2.5) with NaN, +-Inf
    and large values, y +-1 with y = 0 rows, u at both clip ends."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(cuda)

    e = rng.normal(0, 2.5, n)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    u = rng.uniform(1e-7, 1 - 1e-7, n)
    for i, (ev, yv, uv) in enumerate([(np.nan, 1, 0.3), (np.inf, -1, 0.5),
                                      (-np.inf, 1, 0.5), (9.0, 0, 1e-7),
                                      (-9.0, 1, 1 - 1e-7), (0.0, 0, 0.5),
                                      (30.0, -1, 0.2)]):
        j = (i * 37) % n
        e[j], y[j], u[j] = ev, yv, uv
    u[::11] = 1e-7
    u[5::11] = 1 - 1e-7
    return t(e), t(y), t(u), t(rng.uniform(0, 4, n))


@pytest.mark.parametrize("n", [1, 7, 300, 1_000_022, 2, 3, 5, 1026, 4099])
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["vb", "als", "gibbs"])
def test_probit_latent_matches_twin(cuda, mode, n):
    """X12a in its three modes against its twin on the card: NaN and Inf
    in e (the same non-finite pattern), y = 0 rows (the positive branch),
    u at both clip ends, 1M rows; two launches give the same bits."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import probit as kp

    e, y, u, _ = _probit_rows(cuda, n, 11 + mode)
    u = u if mode == kp.PROBIT_GIBBS else None
    outs = []
    for kernel in (True, False, True):
        t = e.clone()
        if kernel:
            kp.probit_latent(t, y, u, mode)
        else:
            kp.probit_latent_plain(t, y, u, mode)
        outs.append(t)
    torch.cuda.synchronize()
    chip_smoke.compare([outs[0]], [outs[1]], f"probit_latent {mode} n={n}")
    assert torch.equal(outs[0].view(torch.int32), outs[2].view(torch.int32))


# X12b's blocks take 1,024 rows each, at most 264 of them: sizes on both
# sides of a block, of the 98 blocks of the 100k test rows, of the cap and
# of a second pass over the capped grid
EVAL_EDGES = [1023, 1025, 98 * 1024, 98 * 1024 + 1, 264 * 1024,
              264 * 1024 + 1, 264 * 1024 + 3, 2 * 264 * 1024 + 6]


@pytest.mark.parametrize("n", [1, 7, 300, 99_978, 1_000_022] + EVAL_EDGES)
@pytest.mark.parametrize("gibbs_it", [None, 3, 7])
def test_probit_eval_matches_twin(cuda, gibbs_it, n):
    """X12b against its twin: VB's eval (no accumulators) and Gibbs's at
    iterations 3 and 7 (all_but5 added to from 5 on), padding rows, a NaN
    and an Inf score (the sums NaN, as the twin's), then finite scores;
    two launches on the same inputs give the same bits."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import probit as kp

    s, y, _, acc = _probit_rows(cuda, n, 5)
    valid = (torch.arange(n, device=cuda) < max(1, n - 5)).float()
    for scores in (s, torch.nan_to_num(s, nan=0.3, posinf=4.0,
                                       neginf=-4.0)):
        outs, sums = [], []
        for kernel in (True, False, True):
            pa = pb = None
            if gibbs_it is not None:
                pa, pb = acc.clone(), acc.clone() * 0.5
            fn = kp.probit_eval if kernel else kp.probit_eval_plain
            outs.append(fn(scores, y, valid, float(n), pa, pb,
                           gibbs_it or 0))
            sums.append([] if pa is None else [pa, pb])
        torch.cuda.synchronize()
        chip_smoke.compare([outs[0]] + sums[0], [outs[1]] + sums[1],
                           f"probit_eval it={gibbs_it} n={n}")
        assert torch.equal(outs[0].view(torch.int32),
                           outs[2].view(torch.int32))


@pytest.mark.parametrize("n", [1, 6, 1025, 99_979])
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["vb", "als", "gibbs"])
def test_probit_latent_misaligned_view(cuda, mode, n):
    """X12a on views one float in (e[1:], y[1:], u[1:]): four 4-byte loads a
    chunk in place of one 16-byte load, the twin's values and the aligned
    launch's bits; the row before the view is left alone."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import probit as kp

    e, y, u, _ = _probit_rows(cuda, n + 1, 31 + mode)
    uv = u[1:] if mode == kp.PROBIT_GIBBS else None
    ua = None if uv is None else uv.clone()
    view, aligned, plain = e.clone(), e[1:].clone(), e[1:].clone()
    kp.probit_latent(view[1:], y[1:], uv, mode)
    kp.probit_latent(aligned, y[1:].clone(), ua, mode)
    kp.probit_latent_plain(plain, y[1:], uv, mode)
    torch.cuda.synchronize()
    chip_smoke.compare([view[1:]], [plain], f"probit_latent view n={n}")
    assert torch.equal(view[1:].view(torch.int32),
                       aligned.view(torch.int32))
    assert torch.equal(view[:1].view(torch.int32), e[:1].view(torch.int32))


@pytest.mark.parametrize("n", [1, 6, 1025, 99_978])
@pytest.mark.parametrize("gibbs_it", [None, 7])
def test_probit_eval_misaligned_view(cuda, gibbs_it, n):
    """X12b on views one float in (scores[1:] and the rest): the twin's sums
    and accumulators, and the aligned launch's bits (the rows go to the
    same threads in the same order)."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import probit as kp

    s, y, _, acc = _probit_rows(cuda, n + 1, 41)
    s = torch.nan_to_num(s, nan=0.3, posinf=4.0, neginf=-4.0)
    valid = (torch.arange(n + 1, device=cuda) < n - 1).float()
    outs, sums = [], []
    for fn, cut in ((kp.probit_eval, lambda t: t[1:]),
                    (kp.probit_eval, lambda t: t[1:].clone()),
                    (kp.probit_eval_plain, lambda t: t[1:])):
        pa = pb = None
        if gibbs_it is not None:
            pa, pb = cut(acc.clone()), cut(acc.clone() * 0.5)
        outs.append(fn(cut(s), cut(y), cut(valid), float(n), pa, pb,
                       gibbs_it or 0))
        sums.append([] if pa is None else [pa, pb])
    torch.cuda.synchronize()
    chip_smoke.compare([outs[0]] + sums[0], [outs[2]] + sums[2],
                       f"probit_eval view it={gibbs_it} n={n}")
    for a, b in zip([outs[0]] + sums[0], [outs[1]] + sums[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("method", ["vb", "vb_exact", "mcmc", "als", "ovb"])
def test_classification_learners_on_gpu_match_cpu(cuda, method):
    """Classification, 3 sweeps (OVB: epochs) from one host-made init (and
    host-drawn numbers for Gibbs and ALS) on the card and on the CPU: the
    accuracy and log-likelihood agree to 1e-5, and the card's run launched
    X12b (and X12a where the method updates the latent targets), never a
    twin."""
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr, te, D, meta, cfg = _small(K=5, task=1, regw=0.5, regv=0.5,
                                  num_batches=4,
                                  factor_block=1 if method == "vb_exact"
                                  else 0)
    for c in (tr, te):
        c.target = np.where(c.target > 3.5, 1.0, -1.0).astype(np.float32)
    cfg = dataclasses.replace(cfg, min_target=-1.0, max_target=1.0)
    vbp = init_vb_params(torch.Generator().manual_seed(3), cfg, "cpu")
    fmp = init_fm_params(torch.Generator().manual_seed(3), D, 5,
                         init_w_normal=True)
    ovb0 = init_ovb_state(torch.Generator().manual_seed(3), cfg, "cpu")
    hists = []
    for dev in (cuda, "cpu"):
        args = (cfg, SparseDataset.from_coo(tr, D),
                SparseDataset.from_coo(te, D), meta)
        if method.startswith("vb"):
            learner = VBLearner(*args, device=dev, write_files=False)
            state = learner.state_from_params(vbp)
        elif method == "ovb":
            learner = OVBLearner(*args, device=dev, write_files=False)
            state = type(ovb0)(**{k: v.to(dev) for k, v in vars(ovb0).items()})
        else:
            cls = ALSLearner if method == "als" else MCMCLearner
            learner = cls(*args, device=dev, write_files=False)
            state = learner.state_from_params(fmp.w0, fmp.w, fmp.v,
                                              host_draws(4, dev))
        build.reset_launch_counts()
        hists.append(learner.run(state, num_iter=3, verbose=False)[1])
        if dev != "cpu":
            assert build.launch_counts["probit_eval"] == 3
            assert build.launch_counts["probit_latent"] == (
                0 if method == "ovb" else 3)
    for g, c in zip(*hists):
        for k in ("accuracy", "loglik"):
            np.testing.assert_allclose(g[k], c[k], rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# The serving path: K1a's serve epilogue, BatchScorer; group_sum; resume
# ---------------------------------------------------------------------------

_SERVE_POISONS = [None, "nan_row", "inf_row", "ninf_row", "nan_x"]
_SERVE_BOUNDS = [(1.0, 5.0), (-float("inf"), 0.5), (-0.5, float("inf")),
                 (float("nan"), 2.0)]


@pytest.mark.parametrize("poison", _SERVE_POISONS)
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("K", [0, 5, 20, 33])
def test_fm_serve_forms_match_twin(cuda, K, P, mode, poison):
    """fm_serve (K1a with its epilogue: the scores, clamped to the finite
    sides of one of four bound pairs, or Phi) in the P = 2 build and at any
    P, 16-byte loads or 4-byte, on 1,001 rows with padding entries; a NaN
    factor, a +Inf or -Inf w, a NaN x: the twin's values and its NaN/Inf
    pattern (a NaN score stays NaN, +-Inf clamps to a finite bound); two
    launches the same bits; N = 0 launches nothing."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import fm_forward as k1
    from svbfm_tpu_torch.ops import forward as fwd

    rng = np.random.default_rng([K, P, mode, _SERVE_POISONS.index(poison)])
    D, N = 40, 1001
    ids = rng.integers(0, D - 1, (N, P))
    vals = rng.uniform(0.5, 1.5, (N, P))
    ids[1::3, -1], vals[1::3, -1] = D - 1, 0.0
    w = rng.normal(0, 2.0, D)
    v = rng.normal(0, 0.5, (K, D))
    ids[0, 0], ids[3, 0] = 5, 7
    if poison == "nan_row":
        if K:
            v[K - 1, 5] = np.nan
        else:
            w[5] = np.nan
    elif poison == "inf_row":
        w[7] = np.inf
    elif poison == "ninf_row":
        w[7] = -np.inf
    elif poison == "nan_x":
        vals[2, 0] = np.nan

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(cuda)

    tab = fwd.score_table(t(w), t(v))
    w0 = torch.tensor(0.3, device=cuda)
    lo, hi = _SERVE_BOUNDS[(K + P) % len(_SERVE_BOUNDS)]
    ids_t, vals_t = t(ids, torch.int32), t(vals)
    before = build.launch_counts["fm_serve"]
    outs = [k1.fm_serve_op(tab, w0, ids_t, vals_t, mode, lo, hi),
            k1.fm_serve_op(tab, w0, ids_t, vals_t, mode, lo, hi),
            k1.fm_serve_plain(tab, w0, ids_t, vals_t, mode, lo, hi)]
    empty = k1.fm_serve_op(tab, w0, ids_t[:0], vals_t[:0], mode, lo, hi)
    torch.cuda.synchronize()
    assert build.launch_counts["fm_serve"] == before + 2 and empty.numel() == 0
    what = f"fm_serve K={K} P={P} mode={mode} {poison} [{lo}, {hi}]"
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    chip_smoke.compare(outs[:1], outs[2:], what)
    if poison in ("nan_row", "nan_x"):
        assert torch.isnan(outs[0]).any(), what


def test_batch_scorer_on_card(cuda):
    """BatchScorer on the card: 1,001 rows in batches of 7, two in flight
    (143 batches through two slots), equal to one-shot scoring bit for bit
    and to the CPU scorer within the kernel tolerance; a row pad wider
    than the rows; the probit scorer; score_device on device rows; and
    no rows."""
    import chip_smoke
    from svbfm_tpu_torch.learners.base import TASK_CLASSIFICATION
    from svbfm_tpu_torch.serve import BatchScorer

    rng = np.random.default_rng(0)
    D, K, N = 50, 8, 1001
    w0 = 0.5
    w = rng.normal(0, 0.5, D).astype(np.float32)
    v = rng.normal(0, 0.5, (K, D)).astype(np.float32)
    ids = rng.integers(0, D, (N, 2)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (N, 2)).astype(np.float32)
    for kw in (dict(min_target=-1.0, max_target=2.0),
               dict(task=TASK_CLASSIFICATION)):
        before = build.launch_counts["fm_serve"]
        many = BatchScorer(w0, w, v, batch_rows=7, inflight=2, device=cuda,
                           **kw).score_rows(ids, vals)
        assert build.launch_counts["fm_serve"] == before + 143
        one = BatchScorer(w0, w, v, device=cuda, **kw)
        np.testing.assert_array_equal(many, one.score_rows(ids, vals))
        padded = BatchScorer(w0, w, v, device=cuda, row_pad=5, **kw)
        np.testing.assert_array_equal(padded.score_rows(ids, vals), many)
        cpu = BatchScorer(w0, w, v, device="cpu", **kw).score_rows(ids, vals)
        chip_smoke.compare([torch.from_numpy(many)], [torch.from_numpy(cpu)],
                           f"BatchScorer {kw}")
        dev_out = one.score_device(torch.from_numpy(ids).to(cuda),
                                   torch.from_numpy(vals).to(cuda))
        np.testing.assert_array_equal(dev_out.cpu().numpy(), many)
        assert one.score_rows(ids[:0], vals[:0]).shape == (0,)


def test_group_sum_on_card_matches_index_add(cuda):
    """group_sum on the card (rows in group order, torch.sum a group) gives
    index_add_'s sums within float32 reordering, an empty group 0, a NaN
    only in its own group, and the same bits call after call."""
    from svbfm_tpu_torch.learners.base import group_sum

    rng = np.random.default_rng(1)
    D, K, G = 3000, 7, 4
    g = rng.integers(0, 3, D)  # group 3 empty; unsorted
    x = rng.normal(size=(D, K)).astype(np.float32)
    x[np.where(g == 1)[0][0], 2] = np.nan
    for xs in (x, x[:, 0]):
        gx = torch.from_numpy(g).to(cuda)
        xt = torch.from_numpy(np.ascontiguousarray(xs)).to(cuda)
        a, b = group_sum(xt, gx, G), group_sum(xt, gx, G)
        want = torch.zeros((G,) + xt.shape[1:], device=cuda).index_add_(
            0, gx, xt)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
        assert torch.equal(torch.isnan(a), torch.isnan(want))
        assert (a[3] == 0).all()


@pytest.mark.parametrize("method", ["vb", "gibbs", "ovb"])
def test_checkpoint_resume_on_card_is_bitwise(cuda, method, tmp_path):
    """2 sweeps, a checkpoint, a resume and 2 more equal 4 uninterrupted
    sweeps bit for bit on the card (Gibbs: the CUDA generator's state in
    the checkpoint)."""
    from svbfm_tpu_torch.learners.mcmc import MCMCLearner
    from svbfm_tpu_torch.utils.checkpoint import CheckpointManager

    tr, te, D, meta, cfg = _small(K=5, num_batches=4)
    cls = {"vb": VBLearner, "gibbs": MCMCLearner, "ovb": OVBLearner}[method]

    def run(**kw):
        lr = cls(cfg, SparseDataset.from_coo(tr, D),
                 SparseDataset.from_coo(te, D), meta, device=cuda,
                 write_files=False)
        return lr.run(num_iter=kw.pop("n"), verbose=False, **kw)
    full, hf = run(n=4)
    mgr = CheckpointManager(str(tmp_path))
    run(n=2, ckpt=mgr, ckpt_every=2)
    res, hr = run(n=4, ckpt=mgr, ckpt_every=100)
    assert [h["iter"] for h in hr] == [2, 3]
    for f in dataclasses.fields(full):
        a, b = getattr(full, f.name), getattr(res, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert [h["rmse"] for h in hr] == [h["rmse"] for h in hf[2:]]


def test_tp_vb_on_gpu_matches_cpu(cuda):
    """The feature-sharded VB (T1-T4) in one process on a (1, 1) mesh, card
    against CPU from one init, 3 sweeps; every T kernel launched."""
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.parallel.tp_vb import TPVBLearner

    coo = make_movielens_like(num_users=60, num_items=40, num_ratings=3000,
                              seed=4)
    tr, te = train_test_split(coo, 0.2, seed=5)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 60])
    hists = []
    for K in (6, 0):
        cfg = FMConfig(num_attributes=D, num_factor=K, num_groups=2, seed=7,
                       min_target=float(tr.target.min()),
                       max_target=float(tr.target.max()))
        params = init_vb_params(torch.Generator().manual_seed(7), cfg, "cpu")
        for dev in (cuda, "cpu"):
            lr = TPVBLearner(cfg, SparseDataset.from_coo(tr, D),
                             SparseDataset.from_coo(te, D), meta,
                             mesh=make_mesh2d(device=dev))
            before = dict(build.launch_counts)
            _, h = lr.run(lr.state_from_params(params), num_iter=3,
                          verbose=False)
            hists.append(h)
            if dev is cuda:
                names = (("tp_build_qt", "tp_col_stats", "tp_col_update")
                         if K else ("tp_w_stats", "tp_w_update"))
                assert all(build.launch_counts[k] > before[k] for k in
                           names + ("tp_fm_partials", "tp_patch_delta"))
        for a, b in zip(hists[-2], hists[-1]):
            for k in ("rmse", "free_energy", "alpha"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5)


@pytest.mark.parametrize("K", [1, 4, 20])
def test_tp_mcmc_kernels_match_twins(cuda, K):
    """T5-T8 (the feature-sharded Gibbs/ALS) against their twins on a small
    problem of odd D, so that the second of two feature shards holds a
    padding column, at F = K (T7 in its exact mode on every bucket, its
    factor-Jacobi mode and F = 1 on the widest), on each shard of Sf = 2
    and 1; the Sf = 2 partials of T6 and T8 summed against X8d and X8b;
    two launches give the same bits."""
    import chip_smoke

    s = chip_smoke.ragged_tp_tensors(cuda, K)
    cases = chip_smoke.make_cases(s)
    names = ("tp_w_draw", "tp_build_q", "tp_col_draw_stats", "tp_col_draw",
             "tp_mcmc_patch_delta")
    before = dict(build.launch_counts)
    for name in names:
        assert cases[name]
        for label, prepare, call, _ in cases[name]:
            ok, op = call("kernel", prepare()), call("plain", prepare())
            again = call("kernel", prepare())
            torch.cuda.synchronize()
            chip_smoke.compare(ok, op, f"{name} ({label})")
            for a, b in zip(ok, again):
                assert torch.equal(a, b), f"{name} ({label})"
    assert all(build.launch_counts[k] > before[k] for k in names)


@pytest.mark.parametrize("method", ["gibbs", "als", "jacobi", "class"])
def test_tp_mcmc_on_gpu_matches_cpu(cuda, method):
    """The feature-sharded Gibbs/ALS in one process on a (1, 1) mesh, card
    against CPU from one init and one host-table draw source, 3 sweeps
    (ALS under -factor_jacobi too; Gibbs under -task c); every kernel of
    the path launched."""
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.models.fm import init_fm_params
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.parallel.tp_mcmc import TPALSLearner, TPMCMCLearner

    coo = make_movielens_like(num_users=61, num_items=40, num_ratings=3000,
                              seed=4)
    tr, te = train_test_split(coo, 0.2, seed=5)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 61])
    kw = dict(regw=2.0, regv=2.0)
    task = 0
    if method == "jacobi":
        kw.update(mcmc_factor_jacobi=True)
    if method == "class":
        task = 1
        for c in (tr, te):
            c.target = np.where(c.target > 3.5, 1.0, -1.0).astype(np.float32)
    cfg = FMConfig(num_attributes=D, num_factor=6, num_groups=2, seed=7,
                   task=task, min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), **kw)
    cls = TPMCMCLearner if method in ("gibbs", "class") else TPALSLearner
    p = init_fm_params(torch.Generator().manual_seed(7), D, 6,
                       init_stdev=cfg.init_stdev, init_w_normal=True)
    hists = []
    for dev in (cuda, "cpu"):
        lr = cls(cfg, SparseDataset.from_coo(tr, D),
                 SparseDataset.from_coo(te, D), meta,
                 mesh=make_mesh2d(device=dev))
        before = dict(build.launch_counts)
        _, h = lr.run(lr.state_from_params(p.w0, p.w, p.v,
                                           host_draws(7, dev)),
                      num_iter=3, verbose=False)
        hists.append(h)
        if dev is cuda:
            names = ("tp_fm_partials", "tp_w_stats", "tp_w_draw",
                     "tp_patch_delta", "tp_build_q", "tp_col_draw_stats",
                     "tp_col_draw", "tp_mcmc_patch_delta") + (
                ("probit_latent", "probit_eval") if task else ())
            assert all(build.launch_counts[k] > before[k] for k in names)
    key = "accuracy" if task else "rmse"
    for a, b in zip(*hists):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-5)
        np.testing.assert_allclose(a["alpha"], b["alpha"], rtol=1e-5)


def test_tp_ovb_kernels_match_twins(cuda):
    """T9's stats and blend launches and T10's (the feature-sharded OVB)
    against their twins on every bin of a small problem's chunk, odd D so
    that the second of two feature shards holds a padding column, buckets
    with padding columns, each shard's eta2 NaN at one column (counted
    candidates); with the chunk's T1, T2 at F = 1 and T4 at F = 1 and 0;
    two launches give the same bits."""
    import chip_smoke

    s = chip_smoke.ragged_tp_ovb_tensors(cuda)
    cases = chip_smoke.make_cases(s)
    names = ("tp_ovb_stats", "tp_ovb_blend", "tp_w_ovb_stats",
             "tp_w_ovb_blend", "tp_build_qt", "tp_patch_delta",
             "tp_fm_partials")
    before = dict(build.launch_counts)
    for name in names:
        assert cases[name]
        for label, prepare, call, _ in cases[name]:
            ok, op = call("kernel", prepare()), call("plain", prepare())
            again = call("kernel", prepare())
            torch.cuda.synchronize()
            chip_smoke.compare(ok, op, f"{name} ({label})")
            for a, b in zip(ok, again):  # the NaN candidates' too
                assert _same_bits(a, b), f"{name} ({label})"
    assert all(build.launch_counts[k] > before[k] for k in names)


def test_tp_ovb_on_gpu_matches_cpu(cuda):
    """The feature-sharded OVB in one process on a (1, 1) mesh, card
    against CPU from one init, 3 epochs of 4 chunks; every kernel of its
    path launched; and the resident OVBLearner on the card from the same
    init, within 1e-5."""
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.parallel.tp_ovb import TPOVBLearner

    coo = make_movielens_like(num_users=61, num_items=40, num_ratings=3000,
                              seed=4)
    tr, te = train_test_split(coo, 0.2, seed=5)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 61])
    cfg = FMConfig(num_attributes=D, num_factor=6, num_groups=2, seed=7,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), num_batches=4)
    data = (SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta)
    hists = []
    for dev in (cuda, "cpu"):
        lr = TPOVBLearner(cfg, *data, mesh=make_mesh2d(device=dev))
        before = dict(build.launch_counts)
        _, h = lr.run(num_iter=3, verbose=False)
        hists.append(h)
        if dev is cuda:
            names = ("tp_fm_partials", "tp_w_ovb_stats", "tp_w_ovb_blend",
                     "tp_patch_delta", "tp_build_qt", "tp_ovb_stats",
                     "tp_ovb_blend")
            assert all(build.launch_counts[k] > before[k] for k in names)
    res = OVBLearner(cfg, *data, device=cuda, write_files=False)
    _, hr = res.run(num_iter=3, verbose=False)
    for other in (hists[1], hr):
        for a, b in zip(hists[0], other):
            for k in ("rmse", "mae", "free_energy"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5)


def test_tp_sgd_scatter_and_dense_apply_match_twins(cuda):
    """T11 (X9a's window mode) at every loss on each window of Sf = 2 and 1
    of chip_smoke's ragged batch (padding entries, an x = 0 entry at a real
    id, valid = 0 rows, a NaN target; D odd, so the second window holds a
    padding row), and X9b's dense form on each window's accumulator as
    T11's twin leaves it, against their twins."""
    import chip_smoke

    cases = chip_smoke.make_cases(chip_smoke.ragged_tp_sgd_tensors(cuda))
    before = dict(build.launch_counts)
    for name, count in (("tp_sgd_scatter", 12), ("sgd_apply", 3)):
        assert len(cases[name]) == count
        for label, prepare, call, _ in cases[name]:
            ok, op = call("kernel", prepare()), call("plain", prepare())
            torch.cuda.synchronize()
            chip_smoke.compare(ok, op, f"{name} ({label})")
        assert build.launch_counts[name] == before[name] + count


@pytest.mark.parametrize("K", [0, 1, 20, 40])
def test_tp_serve_matches_twin_and_repeats_its_bits(cuda, K):
    """T12 in its three modes on partials of 3,001 rows, K = 0 to 40 (past
    a warp of factors), the lin channel NaN, +Inf or -Inf every few rows:
    the twin's values and NaN/Inf pattern, and two launches the same
    bits (no atomics)."""
    import chip_smoke
    from svbfm_tpu_torch.kernels import fm_forward as k1

    g = torch.Generator(device=cuda).manual_seed(K)
    part = torch.randn(3001, 1 + 2 * K, generator=g, device=cuda)
    part[::7, 0], part[1::11, 0], part[2::13, 0] = (
        float("nan"), float("inf"), float("-inf"))
    w0 = torch.tensor(0.4, device=cuda)
    for mode in (k1.SERVE_SCORE, k1.SERVE_CLAMP, k1.SERVE_PROBIT):
        got = k1.tp_serve_op(part, w0, K, mode, -1.0, 2.0)
        again = k1.tp_serve_op(part, w0, K, mode, -1.0, 2.0)
        want = k1.tp_serve_plain(part, w0, K, mode, -1.0, 2.0)
        torch.cuda.synchronize()
        chip_smoke.compare([got], [want], f"tp_serve K={K} mode={mode}")
        assert _same_bits(got, again)
    assert k1.tp_serve_op(part[:0], w0, K, k1.SERVE_CLAMP).shape == (0,)


def test_tp_sgd_on_gpu_matches_cpu(cuda):
    """The feature-sharded SGD in one process on a (1, 1) mesh, card
    against CPU from one init and host-drawn permutations, 3 epochs (T1,
    T11 and X9b dense launched), and the resident SGDLearner on the card
    from the same start, within the SGD family's card-vs-CPU bound (X9a's
    and T11's float atomics)."""
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.sgd import SGDLearner
    from svbfm_tpu_torch.models.fm import init_fm_params
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.parallel.tp_sgd import TPSGDLearner

    coo = make_movielens_like(num_users=61, num_items=40, num_ratings=5000,
                              seed=4)
    tr, te = train_test_split(coo, 0.2, seed=5)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 61])
    cfg = FMConfig(num_attributes=D, num_factor=6, num_groups=2, seed=7,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), learn_rate=0.05,
                   batch_size=256)
    data = (SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta)
    p = init_fm_params(torch.Generator().manual_seed(7), D, 6,
                       init_stdev=0.1)
    hists = []
    for dev in (cuda, "cpu"):
        lr = TPSGDLearner(cfg, *data, mesh=make_mesh2d(device=dev))
        before = dict(build.launch_counts)
        _, h = lr.run(lr.state_from_params(p.w0, p.w, p.v,
                                           host_draws(7, dev)),
                      num_iter=3, verbose=False)
        hists.append(h)
        if dev is cuda:
            assert all(build.launch_counts[k] > before[k] for k in (
                "tp_fm_partials", "tp_sgd_scatter", "sgd_apply"))
    res = SGDLearner(cfg, *data, device=cuda, write_files=False)
    _, hr = res.run(res.state_from_params(p.w0, p.w, p.v, host_draws(7,
                                                                      cuda)),
                    num_iter=3, verbose=False)
    for other in (hists[1], hr):
        for a, b in zip(hists[0], other):
            for k in ("rmse", "mae"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5)


def test_batch_scorer_over_a_world_of_one_on_card(cuda):
    """BatchScorer over a (1, 1) mesh on the card: replicated, fm_serve's
    bits; feature-sharded (T1, then T12 launched, a batch each), within
    1e-6 of the one-card scorer, relative, or absolute near 0 (the square
    after the sum in T12 against K1a's chunks: a few ulps of scores near
    1), clamp and probit, 1,001 rows in batches of 100 through the window
    of two."""
    from svbfm_tpu_torch.learners.base import TASK_CLASSIFICATION
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.serve import BatchScorer

    rng = np.random.default_rng(1)
    D, K, N = 53, 8, 1001
    w = rng.normal(0, 0.5, D).astype(np.float32)
    v = rng.normal(0, 0.5, (K, D)).astype(np.float32)
    ids = rng.integers(0, D, (N, 2)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (N, 2)).astype(np.float32)
    mesh = make_mesh2d(device=cuda)
    for kw in (dict(min_target=-1.0, max_target=2.0),
               dict(task=TASK_CLASSIFICATION)):
        one = BatchScorer(0.5, w, v, device=cuda, **kw).score_rows(ids, vals)
        rep = BatchScorer(0.5, w, v, mesh=mesh, batch_rows=100,
                          **kw).score_rows(ids, vals)
        np.testing.assert_array_equal(rep, one)
        before = build.launch_counts["tp_serve"]
        sh = BatchScorer(0.5, w, v, mesh=mesh, feature_sharded=True,
                         batch_rows=100, **kw).score_rows(ids, vals)
        assert build.launch_counts["tp_serve"] == before + 11
        np.testing.assert_allclose(sh, one, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("K", [1, 4, 20])
def test_dp_split_forms_match_twins_at_the_replicated_shapes(cuda, K):
    """T3 (stats, then the update with no w rider), T7 (stats, then the
    exact draw) at F = K on every bucket of the replicated learners' plan
    (lo = 0, D_loc = D), T3 at K = 0 and T5 on every bin, against their
    twins (chip_smoke's dp cases on a small problem); two launches give
    the same bits."""
    import chip_smoke
    from svbfm_tpu_torch.learners.mcmc import MCMCLearner

    tr, te, D, meta, cfg = _small(K=K)
    args = (cfg, SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta)
    vb = VBLearner(*args, device=cuda, write_files=False)
    gibbs = MCMCLearner(*args, device=cuda, write_files=False)
    vb0 = vb.state_from_params(init_vb_params(
        torch.Generator().manual_seed(3), cfg, cuda))
    mc1, _ = gibbs.step(gibbs.init_state())
    kf = chip_smoke.DP_KERNEL_F
    chip_smoke.DP_KERNEL_F = (K,)
    try:
        s = chip_smoke.dp_tensors(vb, vb0, gibbs, mc1)
    finally:
        chip_smoke.DP_KERNEL_F = kf
    s["timed"] = False
    cases = chip_smoke.make_cases(s)
    names = ("tp_col_stats", "tp_col_update", "tp_col_draw_stats",
             "tp_col_draw", "tp_w_stats", "tp_w_update", "tp_w_draw")
    before = dict(build.launch_counts)
    for name in names:
        assert cases[name]
        for label, prepare, call, _ in cases[name]:
            ok, op = call("kernel", prepare()), call("plain", prepare())
            again = call("kernel", prepare())
            torch.cuda.synchronize()
            chip_smoke.compare(ok, op, f"{name} ({label})")
            for a, b in zip(ok, again):
                assert torch.equal(a, b), f"{name} ({label})"
    assert all(build.launch_counts[k] > before[k] for k in names)


@pytest.mark.parametrize("method", ["vb-fast", "vb-exact", "vb-k0",
                                    "vb-class", "gibbs", "als", "class"])
def test_dp_learners_on_gpu_match_cpu(cuda, method):
    """The data-parallel replicated learners on a data mesh of one rank
    (no process group: the split forms around no collective), card
    against CPU from one init and one host-table draw source, 3 sweeps,
    and beside the resident learner on the card; every kernel of the path
    launched."""
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.models.fm import init_fm_params
    from svbfm_tpu_torch.parallel.mesh import make_mesh

    kw = dict(factor_block=1) if method in ("vb-exact", "vb-class") else {}
    tr, te, D, meta, cfg = _small(K=0 if method == "vb-k0" else 5,
                                  regw=2.0, regv=2.0, **kw)
    if method in ("vb-class", "class"):
        for c in (tr, te):
            c.target = np.where(c.target > 3.5, 1.0, -1.0).astype(np.float32)
        cfg = dataclasses.replace(cfg, task=1, min_target=-1.0,
                                  max_target=1.0)
    args = (cfg, SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta)
    vb = method.startswith("vb")
    cls = VBLearner if vb else ALSLearner if method == "als" else MCMCLearner
    p = init_fm_params(torch.Generator().manual_seed(7), D, cfg.num_factor,
                       init_stdev=cfg.init_stdev, init_w_normal=True)
    params = init_vb_params(torch.Generator().manual_seed(7), cfg, "cpu")
    hists = []
    for dev, mesh in ((cuda, True), ("cpu", True), (cuda, False)):
        where = dict(mesh=make_mesh(device=dev)) if mesh else dict(device=dev)
        lr = cls(*args, write_files=False, **where)
        state = (lr.state_from_params(params) if vb else
                 lr.state_from_params(p.w0, p.w, p.v, host_draws(7, dev)))
        before = dict(build.launch_counts)
        _, h = lr.run(state, num_iter=3, verbose=False)
        hists.append(h)
        if dev is cuda and mesh:
            names = (("tp_w_stats", "tp_w_update", "w_patch_rows")
                     if method in ("vb-exact", "vb-k0", "vb-class") else ())
            names += (("tp_build_qt", "tp_col_stats", "tp_col_update",
                       "tp_patch_delta") if vb and cfg.num_factor else ()) + (
                () if vb else ("build_q", "tp_w_stats", "tp_w_draw",
                               "tp_col_draw_stats", "tp_col_draw",
                               "mcmc_patch_rows"))
            assert all(build.launch_counts[k] > before[k] for k in names)
    keys = ("accuracy",) if cfg.task else ("rmse",)
    keys += ("free_energy",) if vb else ("alpha",)
    for other in hists[1:]:
        for a, b in zip(hists[0], other):
            for k in keys:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
