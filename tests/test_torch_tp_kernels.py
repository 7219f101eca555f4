"""The plain twins of the feature-sharded kernels T1-T8, in one process.

For Sf = 1, 2 and 4 feature shards the shards' partials, summed, must equal
the port's unsharded twins (K1a/K1b, K2, K3, K4, K5 and the w patch) and
the JAX package's ``tp_scores``, ``tp_t_terms`` (``parallel/tp_vb.py``)
and ``make_tp_scorer`` (``parallel/tp.py``) on conftest's 8-device CPU
mesh.  D = 37 is divided by none of 2 and 4, so the last shard holds
padding columns, and the rows hold ids on the shards' boundaries; the
edge dims of ``tests/test_tp.py`` (k0 and k1 off; K = 0) are covered.
T5-T8, the feature-sharded Gibbs/ALS's, are run shard by shard in lockstep
(each collective a sum over the shards in the test) and held to the port's
unsharded twins (X8c, X8d, X8a, X8b) and to the JAX package's
``tp_w_sweep`` and ``tp_v_block_pass`` (``parallel/tp_mcmc.py``) on a
(1, Sf) mesh, Gibbs with the JAX key chain replayed (JaxKeyDraws).
Tolerance: ``test_tp.py:29``'s rtol 2e-4 / atol 2e-4 for JAX, 1e-5 / 1e-6
for the port's own twins (the same sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from svbfm_tpu.parallel.mesh import DATA_AXIS, FEATURE_AXIS
from svbfm_tpu.parallel.mesh import make_mesh as jmesh
from svbfm_tpu.parallel.mesh import make_mesh2d as jmesh2d
from svbfm_tpu.parallel.tp import make_tp_scorer as jscorer
from svbfm_tpu.parallel.tp import shard_params_by_feature as jshard
from svbfm_tpu.parallel.tp_vb import tp_scores as jtp_scores
from svbfm_tpu.parallel.tp_vb import tp_t_terms as jtp_t_terms
from svbfm_tpu_torch.data.dataset import SweepPlan
from svbfm_tpu_torch.data.libfm_text import COOData
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels import fm_forward as k1
from svbfm_tpu_torch.kernels import mcmc_sweep as km
from svbfm_tpu_torch.kernels import vb_sweep as kv
from svbfm_tpu_torch.kernels import w_sweep as kw
from svbfm_tpu_torch.learners.base import build_plan_data
from svbfm_tpu_torch.ops.forward import (fm_scores, fm_t_terms, score_table,
                                         t_term_table)
from svbfm_tpu_torch.parallel.tp import (make_tp_scorer, pad_feature_dim,
                                         scores_from_partials,
                                         shard_params_by_feature,
                                         t_terms_from_partials)
from svbfm_tpu_torch.parallel.tp_vb import _build_tp_plan, local_plan

D, N, P_ROW, NU = 37, 300, 2, 20
SHARDS = (1, 2, 4)
TOL = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(seed=0):
    """N rows of a user id in [0, NU) and an item id in [NU, D), the ids on
    the shards' boundaries (D_loc = 37, 19, 10) among them."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, NU, N), rng.integers(NU, D, N)], 1)
    ids[:6, 0] = [0, 9, 10, 18, 19, NU - 1]
    ids[:6, 1] = [NU, 29, 30, 36, 36, 28]
    vals = rng.uniform(0.5, 1.5, (N, P_ROW))
    return ids.astype(np.int32), vals.astype(np.float32)


def _tables(K, seed=1):
    rng = np.random.default_rng(seed)
    return dict(w0=np.float32(0.3),
                w=rng.standard_normal(D).astype(np.float32),
                v=(0.3 * rng.standard_normal((K, D))).astype(np.float32),
                sw=rng.uniform(0.01, 0.1, D).astype(np.float32),
                sv=rng.uniform(0.01, 0.1, (K, D)).astype(np.float32),
                s0=np.float32(0.02))


def _shard(a, Sf, f):
    D_loc = -(-D // Sf)
    a = pad_feature_dim(a, D_loc * Sf)
    return _t(a[..., f * D_loc:(f + 1) * D_loc]).contiguous(), f * D_loc, D_loc


def _summed(Sf, part_of):
    """The sum over the Sf shards f of part_of(f, sh), ``sh(a)`` giving
    shard f of a table (its slice, lo and D_loc)."""
    return sum(part_of(f, lambda a: _shard(a, Sf, f)) for f in range(Sf))


def _jax_fwd(Sf, fn, ids, vals, k0, k1, table_args):
    """JAX's tp_scores / tp_t_terms on a (1, Sf) mesh."""
    D_loc = -(-D // Sf)
    mesh = jmesh2d(n_data=1, n_feature=Sf)

    def body(*a):
        *tabs, i, v = a
        return fn(*tabs, i, v, D_loc, k0, k1)

    specs = tuple(P() if t.ndim == 0 else P(FEATURE_AXIS) if t.ndim == 1
                  else P(None, FEATURE_AXIS) for t in table_args)
    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=specs + (P(DATA_AXIS), P(DATA_AXIS)),
                              out_specs=P(DATA_AXIS)))
    tabs = [jnp.asarray(pad_feature_dim(t, D_loc * Sf)) if t.ndim else
            jnp.asarray(t) for t in table_args]
    return np.asarray(f(*tabs, jnp.asarray(ids), jnp.asarray(vals)))


CASES = [(4, True, True), (4, False, False), (0, True, True),
         (5, True, False)]


@pytest.mark.parametrize("Sf", SHARDS)
@pytest.mark.parametrize("K,k0,k1", CASES)
def test_t1_scores_partials(Sf, K, k0, k1):
    ids, vals = _rows()
    tb = _tables(K)
    it, vt = _t(ids), _t(vals)

    def part(f, sh):
        w, lo, D_loc = sh(tb["w"])
        v = sh(tb["v"])[0]
        return k1_partials(score_table(w, v, k1), K, False, it, vt, lo, D_loc)

    summed = _summed(Sf, part)
    w0 = torch.tensor(tb["w0"] if k0 else 0.0)
    ours = scores_from_partials(summed, w0, K).numpy()
    ref = fm_scores(_t(tb["w0"]), _t(tb["w"]), _t(tb["v"]), it, vt, k0=k0,
                    k1=k1).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    jax_out = _jax_fwd(Sf, jtp_scores, ids, vals, k0, k1,
                       [tb["w0"], tb["w"], tb["v"]])
    np.testing.assert_allclose(ours, jax_out, **JAX_TOL)


def k1_partials(tab, K, t_terms, ids, vals, lo, D_loc):
    out = k1.tp_fm_partials(tab, K, t_terms, ids, vals, lo, D_loc)
    assert out.shape == (ids.shape[0], k1.tp_channels(K, t_terms))
    return out


@pytest.mark.parametrize("Sf", SHARDS)
@pytest.mark.parametrize("K,k0,k1", CASES)
def test_t1_t_terms_partials(Sf, K, k0, k1):
    ids, vals = _rows(2)
    tb = _tables(K, 3)
    it, vt = _t(ids), _t(vals)

    def part(f, sh):
        sw, lo, D_loc = sh(tb["sw"])
        tab = t_term_table(sw, sh(tb["v"])[0], sh(tb["sv"])[0], k1)
        return k1_partials(tab, K, True, it, vt, lo, D_loc)

    summed = _summed(Sf, part)
    s0 = torch.tensor(tb["s0"] if k0 else 0.0)
    ours = t_terms_from_partials(summed, s0, K).numpy()
    ref = fm_t_terms(_t(tb["s0"]), _t(tb["sw"]), _t(tb["v"]), _t(tb["sv"]),
                     it, vt, k0=k0, k1=k1).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    jax_out = _jax_fwd(Sf, jtp_t_terms, ids, vals, k0, k1,
                       [tb["s0"], tb["sw"], tb["v"], tb["sv"]])
    np.testing.assert_allclose(ours, jax_out, **JAX_TOL)


class _OneRank:
    """A stand-in mesh of Sf ranks for ``make_tp_scorer`` run rank by rank:
    its all-reduce keeps the partials, summed by the test."""

    def __init__(self, size, rank):
        self.size, self.rank, self.device = size, rank, torch.device("cpu")
        self.parts = []

    def all_reduce(self, t):
        self.parts.append(t.clone())
        return t


@pytest.mark.parametrize("Sf", SHARDS)
@pytest.mark.parametrize("k0,k1", [(True, True), (False, False)])
def test_make_tp_scorer_matches_jax(Sf, k0, k1):
    ids, vals = _rows(4)
    tb = _tables(8, 5)
    parts = []
    for r in range(Sf):
        m = _OneRank(Sf, r)
        scorer, d_pad = make_tp_scorer(m, D, k0, k1)
        w0, w, v = shard_params_by_feature(
            m, tb["w0"], pad_feature_dim(tb["w"], d_pad),
            pad_feature_dim(tb["v"], d_pad))
        scorer(w0, w, v, _t(ids), _t(vals))
        parts += m.parts
    w0 = torch.tensor(tb["w0"] if k0 else 0.0)
    ours = scores_from_partials(sum(parts), w0, 8).numpy()
    mesh = jmesh(Sf)
    fn, d_pad = jscorer(mesh, D, k0=k0, k1=k1)
    args = jshard(mesh, tb["w0"], pad_feature_dim(tb["w"], d_pad),
                  pad_feature_dim(tb["v"], d_pad))
    ref = np.asarray(fn(*args, jnp.asarray(ids), jnp.asarray(vals)))
    np.testing.assert_allclose(ours, ref, **JAX_TOL)


# ---- T2-T4 against the unsharded sweep twins ------------------------------

def _sweep_setup(K, seed=6):
    """A conflict-free plan over the rows, caches and a patch table as the
    fast-mode sweep has them at a bin's start."""
    ids, vals = _rows(seed)
    rows = np.repeat(np.arange(N), P_ROW)
    coo = COOData(row=rows, col=ids.reshape(-1).astype(np.int64),
                  val=vals.reshape(-1), target=np.zeros(N, np.float32),
                  num_rows=N, num_features=D)
    meta = DataMetaInfo.from_field_offsets(D, [0, NU])
    plan = SweepPlan.build(coo, D, meta_groups=meta.attr_group)
    rng = np.random.default_rng(seed)
    F = K
    CH = 5 * F + 2 if F else 2
    ptab = torch.zeros(D, CH)
    if F:
        ptab[:, :F] = _t(0.3 * rng.standard_normal((D, F)).astype(np.float32))
        ptab[:, F:2 * F] = _t(rng.uniform(0.01, 0.1, (D, F)).astype(
            np.float32))
    e = _t(rng.standard_normal(N).astype(np.float32))
    return dict(ids=_t(ids), vals=_t(vals), plan=plan, meta=meta, ptab=ptab,
                e=e, F=F, CH=CH, rng=rng)


def _tp_plans(s, Sf):
    plan_np, D_loc = _build_tp_plan((1, Sf), s["plan"], s["meta"], D)
    return [local_plan(plan_np, 0, f, "cpu") for f in range(Sf)], D_loc


def _pad_rows(a, D_loc, Sf):
    out = torch.zeros((D_loc * Sf,) + tuple(a.shape[1:]))
    out[:a.shape[0]] = a
    return out


@pytest.mark.parametrize("Sf", SHARDS)
@pytest.mark.parametrize("K", [4, 3])
def test_t2_t3_t4_match_the_unsharded_sweep(Sf, K):
    s = _sweep_setup(K)
    F, ids, vals, e = s["F"], s["ids"], s["vals"], s["e"]
    plans, D_loc = _tp_plans(s, Sf)
    gptab = _pad_rows(s["ptab"], D_loc, Sf)
    # T2: the caches
    qt = sum(kv.tp_build_qt(gptab[f * D_loc:(f + 1) * D_loc].contiguous(),
                            F, ids, vals, f * D_loc, D_loc)
             for f in range(Sf))
    q, tq, tz = kv.vb_build_qt(s["ptab"], F, ids, vals)
    np.testing.assert_allclose(qt.numpy(), torch.cat([q, tq, tz], 1).numpy(),
                               **TOL)
    # T3 on bin 0: stats (the column sums, padding columns' rows zero),
    # then the update, against K3's twin with the w rider
    G = s["meta"].num_attr_groups
    sv = torch.rand(G, F, generator=torch.Generator().manual_seed(1)) + 0.5
    sigma_w = torch.rand(G, generator=torch.Generator().manual_seed(2)) + 0.5
    alpha = torch.tensor(1.3)
    mu_w0 = _t(s["rng"].standard_normal(D).astype(np.float32))
    ref = dict(ptab=s["ptab"].clone(), mu_t=s["ptab"][:, :F].clone(),
               sig_t=s["ptab"][:, F:2 * F].clone(), mu_w=mu_w0.clone(),
               sig_w=torch.full((D,), 0.02),
               nans=torch.zeros(2, dtype=torch.int32))
    for blk in build_plan_data(s["plan"], s["meta"], "cpu").blocks[0]:
        kv.vb_col_stats_update_plain(
            blk.rows, blk.x, blk.cols, blk.group, blk.sx2, e, q, tq,
            ref["ptab"], ref["mu_t"], ref["sig_t"], sv, alpha,
            (ref["mu_w"], ref["sig_w"], sigma_w), ref["nans"])
    got_ptab = gptab.clone()
    got_mu, got_sig = (_pad_rows(a, D_loc, Sf) for a in
                       (s["ptab"][:, :F], s["ptab"][:, F:2 * F]))
    got_mw = _pad_rows(mu_w0, D_loc, Sf)
    got_sw = _pad_rows(torch.full((D,), 0.02), D_loc, Sf)
    nans = torch.zeros(2, dtype=torch.int32)
    saw_padding = False
    for f, pl in enumerate(plans):
        sl = slice(f * D_loc, (f + 1) * D_loc)
        views = [a[sl] for a in (got_ptab, got_mu, got_sig, got_mw, got_sw)]
        pt, mt, st, mw, sw = views
        for blk in pl.blocks[0]:
            saw_padding |= bool((blk.cols == D_loc).any())
            acc = kv.tp_col_stats(blk.rows, blk.x, blk.cols, D_loc, e, qt,
                                  pt, F)
            assert acc.shape == (blk.cols.shape[0], 2 * F + 1)
            pad = blk.cols == D_loc
            assert (acc[pad] == 0).all()
            real = ~pad
            vm, vs, sxe = kv._col_sums(blk.rows[real], blk.x[real],
                                       blk.cols[real], e, q, tq, pt, F)
            np.testing.assert_allclose(
                acc[real].numpy(), torch.cat([vm, vs, sxe[:, None]],
                                             1).numpy(), **TOL)
            kv.tp_col_update(acc, blk.cols, D_loc, blk.group, blk.sx2, pt,
                             mt, st, sv, alpha, (mw, sw, sigma_w), nans)
    assert Sf == 1 or saw_padding
    for got, want in ((got_mu, ref["mu_t"]), (got_sig, ref["sig_t"]),
                      (got_mw, ref["mu_w"]), (got_sw, ref["sig_w"]),
                      (got_ptab, ref["ptab"])):
        np.testing.assert_allclose(got[:D].numpy(), want.numpy(), **TOL)
    assert torch.equal(nans, ref["nans"])
    # T4: the bin's patch, summed over the shards, is what K4's twin adds
    patch = sum(kv.tp_patch_delta(got_ptab[f * D_loc:(f + 1) * D_loc]
                                  .contiguous(), F, True, ids, vals, qt,
                                  f * D_loc, D_loc) for f in range(Sf))
    caches = [c.clone() for c in (q, tq, tz)]
    e1, t1 = e.clone(), torch.zeros(N)
    kv.vb_patch_rows_plain(ref["ptab"], F, True, ids, vals, *caches, e1, t1)
    assert patch.shape == (N * (3 * F + 2),)
    want = (torch.cat([caches[0] - q, caches[1] - tq, caches[2] - tz], 1),
            e1 - e, t1)
    for got, w in zip(kv.tp_patch_views(patch, N, F), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("Sf", SHARDS)
def test_t3_t4_at_k0_match_k5_and_the_w_patch(Sf):
    s = _sweep_setup(0, seed=8)
    ids, vals, e = s["ids"], s["vals"], s["e"]
    plans, D_loc = _tp_plans(s, Sf)
    G = s["meta"].num_attr_groups
    sigma_w = torch.rand(G, generator=torch.Generator().manual_seed(3)) + 0.5
    alpha = torch.tensor(0.7)
    mu_w0 = _t(s["rng"].standard_normal(D).astype(np.float32))
    for b in range(len(s["plan"].blocks)):
        ref_mw, ref_sw = mu_w0.clone(), torch.full((D,), 0.02)
        ref_dt, ref_bad = torch.zeros(D, 2), torch.zeros(4, dtype=torch.int32)
        kw.w_bin_update_plain(
            build_plan_data(s["plan"], s["meta"], "cpu").blocks[b], e,
            ref_mw, ref_sw, sigma_w, alpha, ref_dt, ref_bad)
        mw, sw = (_pad_rows(a, D_loc, Sf) for a in (mu_w0,
                                                     torch.full((D,), 0.02)))
        dtab = torch.zeros(D_loc * Sf, 2)
        bad = torch.zeros(4, dtype=torch.int32)
        for f, pl in enumerate(plans):
            sl = slice(f * D_loc, (f + 1) * D_loc)
            acc = torch.zeros(D_loc)
            kw.tp_w_stats(pl.blocks[b], e, acc, D_loc)
            kw.tp_w_update(pl.blocks[b], acc, D_loc, mw[sl], sw[sl], sigma_w,
                           alpha, dtab[sl], bad)
        np.testing.assert_allclose(mw[:D].numpy(), ref_mw.numpy(), **TOL)
        np.testing.assert_allclose(sw[:D].numpy(), ref_sw.numpy(), **TOL)
        np.testing.assert_allclose(dtab[:D].numpy(), ref_dt.numpy(), **TOL)
        assert torch.equal(bad, ref_bad)
        patch = sum(kv.tp_patch_delta(dtab[f * D_loc:(f + 1) * D_loc]
                                      .contiguous(), 0, True, ids, vals,
                                      None, f * D_loc, D_loc)
                    for f in range(Sf))
        e1, t1 = e.clone(), torch.zeros(N)
        kv.w_patch_rows_plain(ref_dt, ids, vals, e1, t1)
        _, de, dt = kv.tp_patch_views(patch, N, 0)
        np.testing.assert_allclose(de.numpy(), (e1 - e).numpy(), **TOL)
        np.testing.assert_allclose(dt.numpy(), t1.numpy(), **TOL)


def test_t1_reads_no_row_for_another_shards_id():
    """An id outside [lo, lo + D_loc) adds nothing and reads no table row:
    a NaN at the shard's last row, where JAX's clip puts the ids past the
    window (and multiplies them by 0, so NaN), reaches only the rows that
    hold that row's own id."""
    ids, vals = _rows(9)
    tb = _tables(4, 9)
    w, lo, D_loc = _shard(tb["w"], 2, 0)
    tab = score_table(w, _shard(tb["v"], 2, 0)[0])
    tab[D_loc - 1, :] = float("nan")
    out = k1.tp_fm_partials(tab, 4, False, _t(ids), _t(vals), lo, D_loc)
    mine = torch.from_numpy((ids == D_loc - 1).any(1))
    assert mine.any() and (~mine).any()
    assert torch.isnan(out[mine]).any(1).all()
    assert torch.isfinite(out[~mine]).all()


# ---- T5-T8: the feature-sharded Gibbs/ALS ----------------------------------

def _gibbs_inputs(F, seed):
    """The sweep setup of F factors with a v table, its group priors and
    an unobserved column (the last item's id appears in no row)."""
    s = _sweep_setup(0, seed=seed)
    rng = s["rng"]
    G = s["meta"].num_attr_groups
    s.update(
        F=F, G=G, v=_t(0.3 * rng.standard_normal((D, F)).astype(np.float32)),
        w=_t(rng.standard_normal(D).astype(np.float32)),
        mu=_t(0.1 * rng.standard_normal((G, F)).astype(np.float32)),
        lam=_t(rng.uniform(0.5, 2.0, (G, F)).astype(np.float32)),
        w_mu=_t(0.1 * rng.standard_normal(G).astype(np.float32)),
        w_lam=_t(rng.uniform(0.5, 2.0, G).astype(np.float32)),
        alpha=torch.tensor(1.3))
    return s


@pytest.mark.parametrize("Sf", SHARDS)
def test_t5_matches_x8c_and_the_w_patch(Sf):
    """T3's w stats, T5's draw (the shard's slice of a [D] z table) and
    T4 at F = 0, bin by bin, against X8c and the w patch."""
    s = _gibbs_inputs(1, seed=11)
    ids, vals, e = s["ids"], s["vals"], s["e"]
    plans, D_loc = _tp_plans(s, Sf)
    z = torch.randn(D_loc * Sf, generator=torch.Generator().manual_seed(4))
    for b in range(len(s["plan"].blocks)):
        ref_w, ref_dt = s["w"].clone(), torch.zeros(D, 2)
        ref_bad = torch.zeros(4, dtype=torch.int32)
        kw.mcmc_w_bin_draw_plain(
            build_plan_data(s["plan"], s["meta"], "cpu").blocks[b], e, ref_w,
            s["w_mu"], s["w_lam"], s["alpha"], z[:D], ref_dt, ref_bad)
        w = _pad_rows(s["w"], D_loc, Sf)
        dtab = torch.zeros(D_loc * Sf, 2)
        bad = torch.zeros(4, dtype=torch.int32)
        for f, pl in enumerate(plans):
            sl = slice(f * D_loc, (f + 1) * D_loc)
            acc = torch.zeros(D_loc)
            kw.tp_w_stats(pl.blocks[b], e, acc, D_loc)
            kw.tp_w_draw(pl.blocks[b], acc, D_loc, w[sl], s["w_mu"],
                         s["w_lam"], s["alpha"], z[sl].contiguous(), dtab[sl],
                         bad)
        np.testing.assert_allclose(w[:D].numpy(), ref_w.numpy(), **TOL)
        np.testing.assert_allclose(dtab[:D].numpy(), ref_dt.numpy(), **TOL)
        assert torch.equal(bad, ref_bad)
        _, de, _ = kv.tp_patch_views(sum(
            kv.tp_patch_delta(dtab[f * D_loc:(f + 1) * D_loc].contiguous(),
                              0, True, ids, vals, None, f * D_loc, D_loc)
            for f in range(Sf)), N, 0)
        e1 = e.clone()
        kv.w_patch_rows_plain(ref_dt, ids, vals, e1)
        np.testing.assert_allclose((e + de).numpy(), e1.numpy(), **TOL)


@pytest.mark.parametrize("Sf", SHARDS)
@pytest.mark.parametrize("F,exact", [(4, True), (4, False), (1, True),
                                     (5, True)])
def test_t6_t7_t8_match_x8d_x8a_x8b(Sf, F, exact):
    """Bin 0 of a factor block: T6's q partials summed against X8d; T7's
    stats (padding columns' rows zero) against X8a's sums, its draw from
    them against X8a (exact, or factor-Jacobi); T8's patch summed against
    X8b's."""
    s = _gibbs_inputs(F, seed=12)
    ids, vals, e = s["ids"], s["vals"], s["e"]
    plans, D_loc = _tp_plans(s, Sf)
    ptab = torch.zeros(D, 2 * F)
    ptab[:, :F] = s["v"]
    gptab = _pad_rows(ptab, D_loc, Sf)
    shard = [gptab[f * D_loc:(f + 1) * D_loc] for f in range(Sf)]
    q = sum(kv.tp_build_q(shard[f].contiguous(), F, ids, vals, f * D_loc,
                          D_loc) for f in range(Sf))
    q_ref = kv.build_q_plain(ptab, F, ids, vals)
    np.testing.assert_allclose(q.numpy(), q_ref.numpy(), **TOL)
    z = torch.randn(F, D_loc * Sf, generator=torch.Generator().manual_seed(5))
    ref_pt, ref_v = ptab.clone(), s["v"].clone()
    ref_nans = torch.zeros(2, dtype=torch.int32)
    for blk in build_plan_data(s["plan"], s["meta"], "cpu").blocks[0]:
        km.mcmc_col_draw_plain(blk.rows, blk.x, blk.cols, blk.group, e, q_ref,
                               ref_pt, ref_v, s["mu"], s["lam"], s["alpha"],
                               z[:, :D].contiguous(), exact, ref_nans)
    v_t = _pad_rows(s["v"], D_loc, Sf)
    nans = torch.zeros(2, dtype=torch.int32)
    saw_padding = False
    for f, pl in enumerate(plans):
        sl = slice(f * D_loc, (f + 1) * D_loc)
        for blk in pl.blocks[0]:
            pad = blk.cols == D_loc
            saw_padding |= bool(pad.any())
            acc = km.tp_col_draw_stats(blk.rows, blk.x, blk.cols, D_loc, e,
                                       q, shard[f], F, exact)
            assert acc.shape == (blk.cols.shape[0],
                                 km.tp_col_outputs(F, exact))
            assert (acc[pad] == 0).all()
            s0, sh2, m_x = km._col_sums(blk.rows[~pad], blk.x[~pad],
                                        blk.cols[~pad], e, q, shard[f], F,
                                        exact)
            want = (km.pack_sums(s0, sh2, m_x) if exact
                    else torch.cat([s0, sh2], 0).T)
            np.testing.assert_allclose(acc[~pad].numpy(), want.numpy(), **TOL)
            km.tp_col_draw(acc, blk.cols, blk.group, D_loc, shard[f],
                           v_t[sl], s["mu"], s["lam"], s["alpha"],
                           z[:, sl].contiguous(), exact, nans)
    assert Sf == 1 or saw_padding
    np.testing.assert_allclose(v_t[:D].numpy(), ref_v.numpy(), **TOL)
    np.testing.assert_allclose(gptab[:D].numpy(), ref_pt.numpy(), **TOL)
    assert torch.equal(nans, ref_nans)
    patch = sum(km.tp_mcmc_patch_delta(shard[f].contiguous(), F, ids, vals,
                                       q, f * D_loc, D_loc)
                for f in range(Sf))
    assert patch.shape == (N * (F + 1),)
    q1, e1 = q_ref.clone(), e.clone()
    km.mcmc_patch_rows_plain(ref_pt, F, ids, vals, q1, e1)
    dq, de = km.tp_mcmc_patch_views(patch, N, F)
    np.testing.assert_allclose((q - dq).numpy(), q1.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose((e - de).numpy(), e1.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_t8_reads_no_row_for_another_shards_id():
    """T8 skips an id outside [lo, lo + D_loc): a NaN in the shard's last
    ptab row reaches only the rows holding that row's own id."""
    s = _gibbs_inputs(4, seed=13)
    ids, vals = s["ids"], s["vals"]
    D_loc = -(-D // 2)
    ptab = torch.ones(D_loc, 8)
    ptab[D_loc - 1] = float("nan")
    q = torch.ones(N, 4)
    out = km.tp_mcmc_patch_delta(ptab, 4, ids, vals, q, 0, D_loc)
    dq, de = km.tp_mcmc_patch_views(out, N, 4)
    mine = (ids == D_loc - 1).any(1)
    assert mine.any() and (~mine).any()
    assert torch.isnan(de[mine]).all() and torch.isfinite(de[~mine]).all()
    assert torch.isfinite(dq[~mine]).all()


def _jax_plan(s, Sf):
    """The JAX package's TPPlanData of the same plan on a (1, Sf) mesh."""
    from svbfm_tpu.data.dataset import SweepPlan as JPlan
    from svbfm_tpu.data.libfm_text import COOData as JCOO
    from svbfm_tpu.data.meta import DataMetaInfo as JMeta
    from svbfm_tpu.parallel import tp_vb as jtv

    ids = s["ids"].numpy()
    coo = JCOO(row=np.repeat(np.arange(N), P_ROW).astype(np.int32),
               col=ids.reshape(-1).astype(np.int32),
               val=s["vals"].numpy().reshape(-1),
               target=np.zeros(N, np.float32), num_rows=N, num_features=D)
    meta = JMeta.from_field_offsets(D, [0, NU])
    mesh = jmesh2d(n_data=1, n_feature=Sf)
    plan = JPlan.build(coo, D, meta_groups=meta.attr_group)
    plan_data, D_loc = jtv._build_tp_plan(mesh, plan, meta, D)
    return mesh, plan_data, jtv._plan_specs(plan_data), D_loc


def _jax_row(s):
    from svbfm_tpu.learners.base import RowData as JRow
    return JRow(ids=jnp.asarray(s["ids"].numpy()),
                vals=jnp.asarray(s["vals"].numpy()),
                target=jnp.zeros(N, jnp.float32),
                valid=jnp.ones(N, jnp.float32))


def _row_specs():
    from svbfm_tpu.learners.base import RowData as JRow
    d = P(DATA_AXIS)
    return JRow(ids=d, vals=d, target=d, valid=d)


class _ThreadMesh:
    """Shard f of the feature group of a (1, Sf) mesh run as one of Sf
    threads: ``all_reduce_feature`` sums the shards' tensors in shard
    order (every thread gets the same bits); the data group is one."""

    def __init__(self, Sf, f, shared):
        self.n_data, self.n_feature, self.d_index, self.f_index = 1, Sf, 0, f
        self.shared = shared

    def all_reduce_data(self, t):
        return t

    def all_reduce_feature(self, t):
        sh = self.shared
        sh["slots"][self.f_index] = t.clone()
        sh["barrier"].wait()
        tot = sh["slots"][0].clone()
        for x in sh["slots"][1:]:
            tot += x
        sh["barrier"].wait()
        return t.copy_(tot)


def _on_threads(Sf, fn, mesh_cls=None):
    """fn(f, mesh) on Sf threads, one a feature shard (its mesh a
    ``mesh_cls``, by default ``_ThreadMesh``): their results."""
    import threading

    shared = dict(barrier=threading.Barrier(Sf), slots=[None] * Sf)
    out, errors = [None] * Sf, []

    def run(f):
        try:
            out[f] = fn(f, (mesh_cls or _ThreadMesh)(Sf, f, shared))
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)
            shared["barrier"].abort()

    threads = [threading.Thread(target=run, args=(f,)) for f in range(Sf)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _port_row(s):
    from svbfm_tpu_torch.learners.base import RowData
    return RowData(ids=s["ids"], vals=s["vals"], target=torch.zeros(N),
                   valid=torch.ones(N))


@pytest.mark.parametrize("Sf", SHARDS)
@pytest.mark.parametrize("sample", [False, True], ids=["als", "gibbs"])
def test_t5_w_sweep_matches_jax(Sf, sample):
    """The port's tp_w_sweep (T3's w stats, T5, T4 at F = 0 and the
    unobserved columns' prior draws) on Sf threads against JAX's on a
    (1, Sf) mesh; Gibbs replays the key (the [1, D_loc] column table)."""
    from svbfm_tpu.learners.base import FMConfig as JConfig
    from svbfm_tpu.parallel import tp_mcmc as jtm
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.parallel.tp_mcmc import tp_w_sweep
    from test_torch_mcmc import JaxKeyDraws

    s = _gibbs_inputs(1, seed=14)
    mesh, jplan, specs, D_loc = _jax_plan(s, Sf)
    jcfg = JConfig(num_attributes=D, num_factor=0, do_sample=sample)
    key = jax.random.PRNGKey(3)

    def body(e, w_l, w_mu, w_lam, alpha, key, plan, row):
        k = [key]

        def next_key():
            k[0], sub = jax.random.split(k[0])
            return sub
        return jtm.tp_w_sweep(e, w_l, w_mu, w_lam, alpha, plan, row, jcfg,
                              next_key, D_loc, plan.attr_group[0],
                              plan.unobserved[0])

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(
        P(DATA_AXIS), P(FEATURE_AXIS), P(), P(), P(), P(), specs,
        _row_specs()), out_specs=(P(DATA_AXIS), P(FEATURE_AXIS))))
    w_pad = pad_feature_dim(s["w"].numpy(), D_loc * Sf)
    je, jw = f(jnp.asarray(s["e"].numpy()), jnp.asarray(w_pad),
               jnp.asarray(s["w_mu"].numpy()),
               jnp.asarray(s["w_lam"].numpy()), jnp.asarray(1.3, jnp.float32),
               key, jplan, _jax_row(s))
    plans, _ = _tp_plans(s, Sf)
    cfg = FMConfig(num_attributes=D, num_factor=0, do_sample=sample)
    row = _port_row(s)

    def shard(f, m):
        e, w = s["e"].clone(), _t(w_pad[f * D_loc:(f + 1) * D_loc]).clone()
        tp_w_sweep(e, w, s["w_mu"], s["w_lam"], s["alpha"], plans[f], row,
                   cfg, JaxKeyDraws(np.asarray(key)), m, D_loc, f * D_loc)
        return e, w

    out = _on_threads(Sf, shard)
    for e, _ in out:
        np.testing.assert_allclose(e.numpy(), np.asarray(je), **JAX_TOL)
    np.testing.assert_allclose(torch.cat([w for _, w in out]).numpy(),
                               np.asarray(jw), **JAX_TOL)


@pytest.mark.parametrize("Sf", SHARDS)
@pytest.mark.parametrize("F,sample,exact", [
    (4, False, True), (4, True, True), (4, False, False), (1, True, True)],
    ids=["als", "gibbs", "jacobi", "gibbs-f1"])
def test_t6_t7_t8_block_pass_matches_jax(Sf, F, sample, exact):
    """The port's tp_v_block_pass (T6's q, T7's two launches a bucket, T8's
    patch a bin, the unobserved columns' prior draws) on Sf threads
    against JAX's on a (1, Sf) mesh: e and the block's v after the
    sweep; Gibbs replays the key (the block's [F, D_loc] table)."""
    from svbfm_tpu.learners.base import FMConfig as JConfig
    from svbfm_tpu.parallel import tp_mcmc as jtm
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.parallel.tp_mcmc import tp_v_block_pass
    from test_torch_mcmc import JaxKeyDraws

    s = _gibbs_inputs(F, seed=15)
    mesh, jplan, specs, D_loc = _jax_plan(s, Sf)
    jcfg = JConfig(num_attributes=D, num_factor=F, do_sample=sample)
    key = jax.random.PRNGKey(5)
    # the columns' priors as JAX's learner takes them (take_rows with
    # mode="clip": the padding columns' group G reads group G - 1's)
    ag = np.full(D_loc * Sf, s["G"] - 1)
    ag[:D] = s["meta"].attr_group
    mu_t, lam_t = (a.numpy()[ag] for a in (s["mu"], s["lam"]))

    def body(e, v_t, mu_t, lam_t, alpha, key, plan, row):
        e, v_t, _ = jtm.tp_v_block_pass(e, v_t, mu_t, lam_t, key, plan, row,
                                        jcfg, alpha, exact, D_loc,
                                        plan.unobserved[0])
        return e, v_t

    fsh = P(FEATURE_AXIS)
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(
        P(DATA_AXIS), fsh, fsh, fsh, P(), P(), specs, _row_specs()),
        out_specs=(P(DATA_AXIS), fsh)))
    v_pad = pad_feature_dim(s["v"].numpy().T, D_loc * Sf).T
    je, jv = f(jnp.asarray(s["e"].numpy()), jnp.asarray(v_pad),
               jnp.asarray(np.ascontiguousarray(mu_t)),
               jnp.asarray(np.ascontiguousarray(lam_t)),
               jnp.asarray(1.3, jnp.float32), key, jplan, _jax_row(s))
    plans, _ = _tp_plans(s, Sf)
    cfg = FMConfig(num_attributes=D, num_factor=F, do_sample=sample)
    row = _port_row(s)

    def shard(f, m):
        e = s["e"].clone()
        v_t = _t(v_pad[f * D_loc:(f + 1) * D_loc]).contiguous()
        v_t = tp_v_block_pass(e, v_t, s["mu"], s["lam"], plans[f], row, cfg,
                              s["alpha"], exact,
                              JaxKeyDraws(np.asarray(key)), m, D_loc,
                              f * D_loc)
        return e, v_t

    out = _on_threads(Sf, shard)
    for e, _ in out:
        np.testing.assert_allclose(e.numpy(), np.asarray(je), **JAX_TOL)
    np.testing.assert_allclose(torch.cat([v for _, v in out]).numpy(),
                               np.asarray(jv), **JAX_TOL)


# ---- T9 and T10, the feature-sharded online VB (parallel/tp_ovb.py) -------

def _ovb_inputs(seed=21):
    """A conflict-free plan (with chunk counts) and, at F = 1, the caches
    qt = (q | tq | tz), a patch table [D, 5] and the naturals, rates and
    counters of the w and v tables."""
    s = _sweep_setup(1, seed=seed)
    rng = s["rng"]
    G = s["meta"].num_attr_groups
    ptab = torch.zeros(D, 5)
    ptab[:, :2] = s["ptab"][:, :2]
    q, tq, tz = kv.vb_build_qt(ptab, 1, s["ids"], s["vals"])

    def uni(lo, hi, *shape):
        return _t(rng.uniform(lo, hi, shape).astype(np.float32))
    s.update(ptab=ptab, qt=torch.cat([q, tq, tz], 1), q=q, tq=tq, G=G,
             nmu=uni(-5, 5, D, 1), nsig=uni(20, 60, D, 1),
             rho=uni(0.2, 1.0, D), sv=uni(0.5, 2.0, G, 1),
             mu_w=_t(rng.standard_normal(D).astype(np.float32)),
             sig_w=uni(0.01, 0.1, D), nmu_w=uni(-5, 5, D),
             nsig_w=uni(20, 60, D), t_wj=uni(0, 3, D),
             sigma_w=uni(0.5, 2.0, G), alpha=torch.tensor(1.3))
    return s


@pytest.mark.parametrize("Sf", SHARDS)
def test_t9_t10_match_k6_and_k5_ovb(Sf):
    """T9's stats and blend launches on every shard of each bin against
    K6's twin on the unsharded bin (the sums themselves, at Sf = 1, the
    bits of K6's), and T10's against K5's OVB twin: the tables, the patch
    table's deltas, tv_add / t_wj and the counts; the padding columns get
    zero sums and no update."""
    from svbfm_tpu_torch.kernels import ovb_sweep as ko

    s = _ovb_inputs()
    plans, D_loc = _tp_plans(s, Sf)
    full = build_plan_data(s["plan"], s["meta"], "cpu").blocks
    e, qt, alpha = s["e"], s["qt"], s["alpha"]
    saw_padding = False
    for b in range(len(full)):
        # K6 on the whole bin
        ref = dict(ptab=s["ptab"].clone(), mu=s["ptab"][:, :1].clone(),
                   sig=s["ptab"][:, 1:2].clone(), nmu=s["nmu"].clone(),
                   nsig=s["nsig"].clone(), tv=torch.zeros(D),
                   bad=torch.zeros(4, dtype=torch.int32))
        ko.ovb_bin_update_plain(
            ko.BinPlan(full[b]), e, s["q"], s["tq"], ref["ptab"], ref["mu"],
            ref["sig"], ref["nmu"], ref["nsig"], s["sv"], alpha, s["rho"],
            ref["tv"], ref["bad"])
        got = {k: _pad_rows(ref_v, D_loc, Sf) for k, ref_v in (
            ("ptab", s["ptab"]), ("mu", s["ptab"][:, :1]),
            ("sig", s["ptab"][:, 1:2]), ("nmu", s["nmu"]),
            ("nsig", s["nsig"]), ("tv", torch.zeros(D)),
            ("rho", s["rho"]))}
        bad = torch.zeros(4, dtype=torch.int32)
        for f, pl in enumerate(plans):
            sl = slice(f * D_loc, (f + 1) * D_loc)
            v = {k: a[sl] for k, a in got.items()}
            plan = ko.BinPlan(pl.blocks[b])
            sums = ko.tp_ovb_stats(plan, D_loc, e, qt,
                                   v["ptab"].contiguous())
            assert sums.shape == (plan.num_cols, 2)
            at = 0
            for blk in pl.blocks[b]:
                C = blk.cols.shape[0]
                pad = blk.cols == D_loc
                saw_padding |= bool(pad.any())
                assert (sums[at:at + C][pad] == 0).all()
                if Sf == 1:  # K6's own sums, bit for bit
                    vm, vs = ko._v_sums(blk.rows, blk.x, blk.cols, e,
                                        s["q"], s["tq"], s["ptab"], 1)
                    assert torch.equal(sums[at:at + C],
                                       torch.cat([vm, vs], 1))
                at += C
            ko.tp_ovb_blend(plan, D_loc, sums, v["ptab"], v["mu"], v["sig"],
                            v["nmu"], v["nsig"], s["sv"], alpha, v["rho"],
                            v["tv"], bad)
        for k in ("ptab", "mu", "sig", "nmu", "nsig", "tv"):
            np.testing.assert_allclose(got[k][:D].numpy(), ref[k].numpy(),
                                       err_msg=k, **TOL)
            assert (got[k][D:] == 0).all() or k == "ptab"
        assert torch.equal(bad, ref["bad"])

        # T10 against K5's OVB mode on the same bin
        ref_w = {k: s[k].clone() for k in ("mu_w", "sig_w", "nmu_w",
                                            "nsig_w", "t_wj")}
        ref_w.update(dtab=torch.zeros(D, 2),
                     bad=torch.zeros(4, dtype=torch.int32))
        rho_w = (1.0 + s["t_wj"]) ** -0.5
        kw.w_bin_update_plain(
            full[b], e, ref_w["mu_w"], ref_w["sig_w"], s["sigma_w"], alpha,
            ref_w["dtab"], ref_w["bad"],
            ovb=(ref_w["nmu_w"], ref_w["nsig_w"], rho_w, ref_w["t_wj"]))
        gw = {k: _pad_rows(s[k], D_loc, Sf) for k in ("mu_w", "sig_w",
                                                      "nmu_w", "nsig_w",
                                                      "t_wj")}
        gw.update(dtab=torch.zeros(D_loc * Sf, 2),
                  rho=_pad_rows(rho_w, D_loc, Sf))
        wbad = torch.zeros(4, dtype=torch.int32)
        for f, pl in enumerate(plans):
            sl = slice(f * D_loc, (f + 1) * D_loc)
            v = {k: a[sl] for k, a in gw.items()}
            acc = torch.zeros(D_loc)
            kw.tp_w_ovb_stats(pl.blocks[b], e, v["mu_w"], acc, D_loc)
            if Sf == 1:  # K5's OVB sums
                for blk in pl.blocks[b]:
                    e_g = e[blk.rows.long()]
                    want = (blk.x * (e_g + blk.x * s["mu_w"][
                        blk.cols.long()][:, None])).sum(1)
                    assert torch.equal(acc[blk.cols.long()], want)
            kw.tp_w_ovb_blend(pl.blocks[b], acc, D_loc, v["mu_w"],
                              v["sig_w"], s["sigma_w"], alpha, v["dtab"],
                              wbad, (v["nmu_w"], v["nsig_w"], v["rho"],
                                     v["t_wj"]))
        for k, want in (("mu_w", ref_w["mu_w"]), ("sig_w", ref_w["sig_w"]),
                        ("nmu_w", ref_w["nmu_w"]), ("nsig_w", ref_w["nsig_w"]),
                        ("t_wj", ref_w["t_wj"]), ("dtab", ref_w["dtab"])):
            np.testing.assert_allclose(gw[k][:D].numpy(), want.numpy(),
                                       err_msg=k, **TOL)
        assert torch.equal(wbad, ref_w["bad"])
    assert Sf == 1 or saw_padding


class _OVBThreadMesh(_ThreadMesh):
    """``_ThreadMesh`` with what a learner's constructor reads of a mesh."""

    def __init__(self, Sf, f, shared):
        super().__init__(Sf, f, shared)
        self.shape, self.device, self.rank = (1, Sf), torch.device("cpu"), f


@pytest.mark.parametrize("Sf", [2, 4])
def test_t9_t10_chunk_update_matches_jax(Sf):
    """One chunk of the port's tp_ovb_chunk_update (T1, T10's two launches,
    T2, T9's two launches, T4 at F = 0 and 1) on Sf threads against JAX's
    on a (1, Sf) mesh, from the JAX learner's init: every table of the
    shards, the hyperparameters and the chunk's free energy."""
    from svbfm_tpu.data.dataset import SparseDataset as JDataset
    from svbfm_tpu.parallel import tp_ovb as jto
    from svbfm_tpu_torch.parallel.tp_ovb import (TPOVBLearner,
                                                 tp_ovb_chunk_update)
    from svbfm_tpu_torch.utils.convert import tp_ovb_state_from_jax
    from test_tp_ovb import _setup
    from torch_tp_ranks import ovb_setup

    tr, te, Dj, jmeta, jcfg = _setup(num_batches=2)
    jl = jto.TPOVBLearner(jcfg, JDataset.from_coo(tr, Dj),
                          JDataset.from_coo(te, Dj), jmeta,
                          mesh=jmesh2d(n_data=1, n_feature=Sf),
                          write_files=False)
    js0 = jl.init_state()
    init = {f.name: np.asarray(getattr(jax.device_get(js0), f.name))
            for f in js0.__dataclass_fields__.values()}
    row = jax.tree.map(lambda a: a[0], jl.chunk_row)
    js, jfe, _ = jl._step(js0, row, jto._pick_chunk(jl.chunk_blocks, 0),
                          jnp.asarray(float(jl.chunk_sizes[0]), jnp.float32),
                          jl.attr_group_sh, jl.col_valid_sh, jl.napg)
    js = jax.device_get(js)
    cfg, ptr_, pte, meta, _ = ovb_setup(num_batches=2)

    def shard(f, m):
        lr = TPOVBLearner(cfg, ptr_, pte, meta, mesh=m)
        st = tp_ovb_state_from_jax(init, "cpu", d=0, f=f, D_loc=lr.D_loc)
        c = lr.chunks[0]
        return tp_ovb_chunk_update(
            st, c.row, c, lr.cfg, float(lr.train_n),
            float(lr.chunk_sizes[0]), lr.columns, m, lr.D_loc, lr.lo)

    out = _on_threads(Sf, shard, _OVBThreadMesh)
    for k in ("mu_w", "sigma_w_dash", "n_mu_w", "n_sig_w", "t_wj", "mu_v",
              "sigma_v_dash", "n_mu_v", "n_sig_v", "t_vj"):
        got = torch.cat([getattr(st, k) for st, _, _ in out], -1)
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(js, k)),
                                   err_msg=k, **JAX_TOL)
    for st, fe, nans in out:
        for k in ("mu_0", "alpha", "sigma_w", "sigma_v", "t_w0"):
            np.testing.assert_allclose(getattr(st, k).numpy(),
                                       np.asarray(getattr(js, k)),
                                       err_msg=k, **JAX_TOL)
        np.testing.assert_allclose(float(fe), float(jfe), rtol=2e-4)
        assert all(int(v) == 0 for v in nans.values())
