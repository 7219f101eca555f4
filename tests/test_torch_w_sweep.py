"""K5's bin launch (``kernels/w_sweep.py``) and P1
(``kernels/gather_probe.py``) on the CPU: the bin twins against the
per-bucket twins run in turn, bit for bit, in every mode; the plan table
and the launch it makes against the rule of ``csrc/w_sweep.cu``; the
bin-level VB update against the JAX package's ``vb_w_bin_update`` at
test_torch_vb_exact.py's tolerances (rtol 1e-4 / atol 1e-5, float32 sums
in another order); each learner calling K5 once a bin; P1's twin on
ragged and offset index sets.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from svbfm_tpu.learners import vb as jvb
from svbfm_tpu.learners.base import plan_specs_for
from svbfm_tpu.parallel.mesh import DATA_AXIS
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.kernels import gather_probe as kg
from svbfm_tpu_torch.kernels import w_sweep as kw
from svbfm_tpu_torch.kernels.vb_sweep import w_patch_rows
from svbfm_tpu_torch.learners import exp_sgd as lexp
from svbfm_tpu_torch.learners import mcmc as lmcmc
from svbfm_tpu_torch.learners import vb as lvb
from svbfm_tpu_torch.learners import vb_online as lovb
from svbfm_tpu_torch.learners.base import BlockData, FMConfig
from svbfm_tpu_torch.utils.convert import state_from_jax

from test_torch_vb import _pair

MODES = ("vb", "ovb", "gibbs", "als", "grad")


def _ragged():
    import chip_smoke

    return chip_smoke.ragged_w_tensors("cpu")


def _run(mode, s, bins, per_bucket: bool):
    """One bin of ``mode`` on fresh copies of the tensor set's outputs, by
    the bin twin or by the per-bucket twins in turn; returns the outputs."""
    vb, ov, mw = s
    if mode in ("vb", "ovb"):
        t = vb if mode == "vb" else ov
        out = [t["mu_w"].clone(), t["sig_w"].clone(),
               torch.zeros_like(t["dtab"]), torch.zeros(4, dtype=torch.int32)]
        extra = None
        if mode == "ovb":
            out += [ov["n_mu_w"].clone(), ov["n_sig_w"].clone(),
                    ov["t_wj"].clone()]
            extra = (out[4], out[5], ov["rho_w"], out[6])
        args = (t["e"], out[0], out[1], t["w_sigma_w"], t["alpha"], out[2],
                out[3])
        if not per_bucket:
            kw.w_bin_update_plain(bins, *args, ovb=extra)
        for b in bins if per_bucket else ():
            kw.w_col_update_plain(
                b.rows, b.x, b.cols, b.group, b.sx2, *args,
                ovb=None if extra is None else (b.cnt, b.col_count, *extra))
        return out
    if mode in ("gibbs", "als"):
        z = mw["mw_z"] if mode == "gibbs" else None
        out = [mw["mw_w"].clone(), torch.zeros_like(mw["mw_dtab"]),
               torch.zeros(4, dtype=torch.int32)]
        args = (mw["mw_e"], out[0], mw["mw_mu"], mw["mw_lambda"],
                mw["mw_alpha"], z, out[1], out[2])
        if not per_bucket:
            kw.mcmc_w_bin_draw_plain(bins, *args)
        for b in bins if per_bucket else ():
            kw.mcmc_w_draw_plain(b.rows, b.x, b.cols, b.group, b.sx2, *args)
        return out
    out = [mw["x_w"].clone(), torch.zeros_like(mw["mw_dtab"])]
    if not per_bucket:
        kw.w_bin_grad_step_plain(bins, mw["x_e"], *out, *mw["x_step"])
    for b in bins if per_bucket else ():
        kw.w_grad_step_plain(b.rows, b.x, b.cols, mw["x_e"], *out,
                             *mw["x_step"])
    return out


@pytest.mark.parametrize("which", [0, 1], ids=["mixed L", "40 buckets"])
@pytest.mark.parametrize("mode", MODES)
def test_bin_twin_is_the_bucket_twins_in_turn(mode, which):
    """Each mode's bin twin gives the per-bucket twins' outputs, run in the
    bin's order, bit for bit, counters included; the ragged bins reach
    every path of the closing step (NaN sums, NaN priors, cnt = 0, an Inf
    noise number)."""
    s = _ragged()
    bins = s[0]["w_bins"][which]
    got = _run(mode, s, bins, per_bucket=False)
    want = _run(mode, s, bins, per_bucket=True)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    if mode != "grad" and which == 0:
        assert int(got[3 if mode in ("vb", "ovb") else 2].sum()) > 0


def _cover(buckets):
    """(bucket, column) of each closing lane and (bucket, column, slot) of
    each slot a lane adds, as ``csrc/w_sweep.cu`` maps blocks and lanes:
    the block's bucket the last whose first block is <= the block, U lanes
    a column, lane li taking slots li, li + U, ..."""
    table, blocks = kw.w_plan_rows(buckets)
    firsts = [r[9] for r in table]
    heads, slots = [], []
    for blk in range(blocks):
        b = max(i for i, f in enumerate(firsts) if f <= blk)
        *_, C, L, first = table[b]
        U = kw.col_lanes(L)
        for th in range(256):
            c, li = ((blk - first) * 256 + th) // U, th % U
            if c >= C:
                continue
            if li == 0:
                heads.append((b, c))
            slots += [(b, c, l) for l in range(li, L, U)]
    return heads, slots


def _bin(widths, shift=0, seed=0):
    """A bin of buckets [C, L] for (C, L) in ``widths``, its columns
    numbered in order; ``shift`` floats past a 16-byte boundary for rows
    and x."""
    rng = np.random.default_rng(seed)
    out, col = [], 0
    for C, L in widths:
        rows = torch.zeros(C * L + 4, dtype=torch.int32)
        x = torch.zeros(C * L + 4)
        assert rows.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
        rows = rows[shift:shift + C * L].view(C, L)
        rows.copy_(torch.from_numpy(rng.integers(0, 50, (C, L))))
        x = x[shift:shift + C * L].view(C, L)
        x.fill_(1.0)
        ones = torch.ones(C)
        out.append(BlockData(
            rows=rows, x=x, cols=torch.arange(col, col + C, dtype=torch.int32),
            group=torch.zeros(C, dtype=torch.int32), sx2=ones * L,
            cnt=ones * L, col_count=ones * L))
        col += C
    return out


@pytest.mark.parametrize("widths,shift,lanes", [
    ([(5, 1), (9, 7), (0, 16), (40, 16), (3, 33), (2, 300), (4, 512)], 0,
     [1, 8, 16, 16, 32, 32, 32]),
    ([(3, 64), (2, 66), (0, 1)], 0, [32, 32, 1]),
    ([(3, 64), (2, 66)], 2, [32, 32]),    # 8 bytes on
    ([(3, 64), (2, 66)], 1, [32, 32]),    # 4 bytes on
    ([(33, 8), (0, 16), (17, 16), (9, 32)], 0, [8, 16, 16, 32]),
    ([(0, 4)], 0, [4]),
    ([], 0, [])])
def test_w_plan_is_the_cu_rule(widths, shift, lanes):
    """K5's plan of a bin (``csrc/w_sweep.cu`` kPlanCols): the table holds
    each bucket's seven pointers, C, L and first block in the bin's order,
    ceil(C U / 256) blocks a bucket (U the next power of two >= L, at most
    32), on aligned and unaligned bases alike; the launch it makes closes
    every column of every bucket once (an empty bucket is stepped over)
    and adds every slot once."""
    buckets = _bin(widths, shift)
    table, blocks = kw.w_plan_rows(buckets)
    first = 0
    for row, b, (C, L) in zip(table, buckets, widths):
        assert row == (b.rows.data_ptr(), b.x.data_ptr(), b.cols.data_ptr(),
                       b.group.data_ptr(), b.sx2.data_ptr(),
                       b.cnt.data_ptr(), b.col_count.data_ptr(), C, L, first)
        first += -(-C * kw.col_lanes(L) // 256)
    assert blocks == first
    assert [kw.col_lanes(b.rows.shape[1]) for b in buckets] == lanes
    heads, slots = _cover(buckets)
    assert sorted(heads) == [(b, c) for b, (C, _) in enumerate(widths)
                             for c in range(C)]
    assert sorted(slots) == [(b, c, l) for b, (C, L) in enumerate(widths)
                             for c in range(C) for l in range(L)]


@pytest.mark.parametrize("C,L,blocks", [(3353, 8, 105), (2660, 16, 167),
                                        (24, 32, 3), (6026, 256, 754),
                                        (1613, 512, 202), (14, 128, 2)])
def test_w_plan_blocks_at_the_recipe_shapes(C, L, blocks):
    """The blocks the ML-1M recipe's buckets take: 256 / U columns a block
    (U = 8 at an OVB chunk's L = 8, 16 at L = 16, a warp past it)."""
    b = _bin([(C, L)])
    assert kw.w_plan_rows(b)[1] == blocks


@pytest.mark.parametrize("seed", [4, 9])
def test_w_bin_update_matches_jax(seed):
    """The bin-level VB entry and the w patch, bin by bin, against the JAX
    ``vb_w_bin_update`` under shard_map on a one-device mesh."""
    jl, tl = _pair(num_rows=300, num_users=14, num_items=11, K=2, seed=seed,
                   factor_block=1)
    js = jax.device_get(jl.init_state())
    ts = state_from_jax(js, "cpu")
    rep, shd = P(), P(DATA_AXIS)
    specs = plan_specs_for(jl.plan_data)
    e, t = ts.e.clone(), ts.t.clone()
    mw, sw = ts.mu_w.clone(), ts.sigma_w_dash.clone()
    je, jt, jmw, jsw = js.e, js.t, js.mu_w, js.sigma_w_dash
    D = tl.cfg.num_attributes
    bad = torch.zeros(4, dtype=torch.int32)
    for b, bin_blocks in enumerate(jl.plan_data.blocks):
        fn = jax.jit(jax.shard_map(
            lambda e, t, mw, sw, blocks, row: jvb.vb_w_bin_update(
                e, t, mw, sw, js.sigma_w, js.alpha, blocks, row),
            mesh=jl.mesh,
            in_specs=(shd, shd, rep, rep, specs.blocks[b], jvb._row_specs()),
            out_specs=(shd, shd, rep, rep)))
        je, jt, jmw, jsw = fn(je, jt, jmw, jsw, bin_blocks, jl.train_row)
        dtab = torch.zeros(D, 2)
        kw.w_bin_update(tl.plan_data.blocks[b], e, mw, sw, ts.sigma_w,
                        ts.alpha, dtab, bad)
        w_patch_rows(dtab, tl.train_row.ids, tl.train_row.vals, e, t)
        for name, got, ref in (("e", e, je), ("t", t, jt), ("mu_w", mw, jmw),
                               ("sigma_w_dash", sw, jsw)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    assert bad.tolist() == [0, 0, 0, 0]


def _small(**cfg_kw):
    coo = make_movielens_like(num_users=30, num_items=20, num_ratings=600,
                              rank=2, seed=1)
    tr, te = train_test_split(coo, 0.2, seed=2)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 30])
    cfg = FMConfig(num_attributes=D, num_factor=3, num_groups=2, seed=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), **cfg_kw)
    return (cfg, SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta)


@pytest.mark.parametrize("path", ["vb-exact", "ovb", "gibbs", "exp_sgd"])
def test_learners_call_k5_once_a_bin(monkeypatch, path):
    """Each learner hands K5 a whole bin: one call a bin of a sweep (an
    OVB epoch: a bin of each chunk), each with that bin's buckets."""
    cfg, *data = _small()
    rep = dataclasses.replace
    mod, name, learner = {
        "vb-exact": (lvb, "w_bin_update", lambda: lvb.VBLearner(
            rep(cfg, factor_block=1), *data, device="cpu",
            write_files=False)),
        "ovb": (lovb, "w_bin_update", lambda: lovb.OVBLearner(
            rep(cfg, num_batches=3), *data, device="cpu",
            write_files=False)),
        "gibbs": (lmcmc, "mcmc_w_bin_draw", lambda: lmcmc.MCMCLearner(
            cfg, *data, device="cpu", write_files=False)),
        "exp_sgd": (lexp, "w_bin_grad_step", lambda: lexp.ExpSGDLearner(
            rep(cfg, learn_rate=0.5), *data, device="cpu",
            write_files=False)),
    }[path]
    learner = learner()
    calls = []
    real = getattr(mod, name)

    def counted(buckets, *args, **kwargs):
        calls.append(tuple(buckets))
        return real(buckets, *args, **kwargs)

    monkeypatch.setattr(mod, name, counted)
    learner.run(num_iter=1, verbose=False)
    if path == "ovb":
        want = [tuple(p.buckets) for _, bins in learner.chunks
                for p in bins]
    else:
        want = [tuple(bb) for bb in learner.plan_data.blocks]
    assert len(want) >= 2 and calls == want


@pytest.mark.parametrize("n,offset,W", [(40, 0, 1), (37, 0, 1), (37, 1, 1),
                                        (1, 3, 1), (640, 0, 128),
                                        (640, 1, 128), (12, 1, 6),
                                        (12, 0, 3)])
def test_gather_twin_on_ragged_and_offset_indices(n, offset, W):
    """P1's twin: o[r, l] = t[idx[r, l], l] on index sets whose count is not
    a multiple of 4 and whose base is ``offset`` elements past a 16-byte
    boundary, as the kernel's tail and 4-byte loads take them."""
    rng = np.random.default_rng(n + offset)
    t = torch.from_numpy(rng.standard_normal((9, W)).astype(np.float32))
    buf = torch.from_numpy(rng.integers(0, 9, n + offset).astype(np.int32))
    idx = buf[offset:].view(n // W, W)
    o = kg.gather_rows(t, idx)
    want = t.numpy()[idx.numpy(), np.arange(W)[None, :]]
    np.testing.assert_array_equal(o.numpy(), want)


def test_long_bin_splits_into_launches_of_max_buckets():
    """A bin of more buckets than a launch's parameters hold goes in
    launches of ``MAX_BUCKETS`` buckets, each plan's first blocks counted
    from its own first; empty launches are dropped."""
    widths = [(2, 3)] * 40 + [(0, 8)] * 40
    buckets = _bin(widths)
    e = torch.zeros(50)
    launches = kw._bin_launches(buckets, e, ("group", "sx2"), "t")
    assert [(nb, blocks) for _, nb, blocks in launches] == [(32, 32),
                                                             (32, 8)]
    for (table, _, blocks), part in zip(launches, (buckets[:32],
                                                   buckets[32:64])):
        rows, want = kw.w_plan_rows(part)
        assert list(table) == [v for r in rows for v in r]
        assert blocks == want  # a block a bucket of 2 columns
