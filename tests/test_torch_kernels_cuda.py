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


@pytest.mark.parametrize("nrel", [9, 12])
def test_bs_scores_many_relations_match_twin(cuda, nrel):
    """X10d's scores over 9 and 12 relations, read through device arrays
    of pointers: every relation's qB adds into one s_f before it is
    squared."""
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
    moms = [t(rng.normal(0, 0.3, (R, 1 + 2 * K))) for R in sizes]
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


def _join_agg_case(cuda, F, shapes, seed):
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
    e_t = torch.from_numpy(e.astype(np.float32)).to(cuda)
    q = (torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
         .to(cuda) if F else None)
    got, want = rtab.clone(), rtab.clone()
    before = build.launch_counts["bs_join_agg"]
    ks.bs_join_agg(buckets, e_t, q, F, got)
    ks.bs_join_agg_plain(buckets, e_t, q, F, want)
    torch.cuda.synchronize()
    live = any(b.rows.shape[0] for b in buckets)
    assert build.launch_counts["bs_join_agg"] == before + int(live)
    chip_smoke.compare([got], [want], f"bs_join_agg F={F} {shapes}")
    for b in buckets:
        if b.rows.shape[0] > 5:
            assert torch.isnan(got[int(b.cols[5]), F]).item()
            assert (got[int(b.cols[3]), F:F + ks.agg_channels(F)] == 0).all()


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
