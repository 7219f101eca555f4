"""Pairwise (BPR) SGD in the port (CPU twins of X9a's pair mode, X9b and K1)
against the JAX package's ``svbfm_tpu.learners.bpr``, on test_bpr.py's
data.  Both start from the JAX learner's init
(``utils.convert.bpr_state_from_jax``); the test draw sources replay JAX's
key chain (bpr.py:164-179) and its fixed eval negatives (bpr.py:191, 233).

Tolerances: one pair step rtol 1e-5 / atol 1e-6; 2 epochs rtol 1e-4 /
atol 1e-6 on the parameters and 1e-5 on the pair loss, the pair accuracy
exactly (float32 sums taken in another order; the step passes at rtol
1e-6 / atol 1e-7).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.libfm_text import COOData
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import bpr as jb
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.kernels import sgd_step as ks
from svbfm_tpu_torch.learners import bpr as tb
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.sgd import table
from svbfm_tpu_torch.utils.convert import bpr_state_from_jax


class JaxBPRKeys:
    """Replays BPR's chain: an epoch splits the key in three, permutes
    with the second (folded with shard 0) and draws batch b's negatives
    from split(fold_in(third, 0), nb)[b]."""

    def __init__(self, key):
        self.key, self.kneg = key, None

    def permutation(self, n):
        self.key, kperm, kneg = jax.random.split(self.key, 3)
        self.kneg = jax.random.fold_in(kneg, 0)
        return torch.from_numpy(np.asarray(jax.random.permutation(
            jax.random.fold_in(kperm, 0), n)).astype(np.int64))

    def randint(self, shape, lo, hi):
        nb, bl = shape
        keys = jax.random.split(self.kneg, nb)
        return torch.from_numpy(np.stack([np.asarray(
            jax.random.randint(k, (bl,), lo, hi)) for k in keys]).astype(
                np.int32))


class JaxEvalNegatives:
    """bpr.py:233 + :191: PRNGKey(seed + 17) folded with shard 0."""

    def __init__(self, seed):
        self.key = jax.random.fold_in(jax.random.PRNGKey(seed + 17), 0)

    def randint(self, shape, lo, hi):
        return torch.from_numpy(np.asarray(jax.random.randint(
            self.key, tuple(shape), lo, hi)).astype(np.int32))


def _data():
    """test_bpr.py:_setup: above-median ratings as positives."""
    coo = make_movielens_like(num_users=30, num_items=25, num_ratings=4000,
                              rank=3, noise=0.3, seed=5)
    keep = coo.target > np.median(coo.target)
    kept = np.where(keep)[0]
    remap = np.full(coo.num_rows, -1, np.int64)
    remap[kept] = np.arange(len(kept))
    m = remap[coo.row] >= 0
    pos = COOData(row=remap[coo.row[m]].astype(np.int32), col=coo.col[m],
                  val=coo.val[m], target=np.ones(len(kept), np.float32),
                  num_rows=len(kept), num_features=coo.num_features)
    tr, te = train_test_split(pos, 0.2, seed=6)
    return tr, te, coo.num_features


def _cfg_kw(D):
    return dict(num_attributes=D, num_factor=4, num_groups=2, min_target=0.0,
                max_target=1.0, learn_rate=0.05, reg0=0.01, regw=0.002,
                regv=0.002, num_batches=8, seed=9)


def _pair():
    tr, te, D = _data()
    kw = _cfg_kw(D)
    jl = jb.BPRLearner(JConfig(**kw), JDataset.from_coo(tr, D),
                       JDataset.from_coo(te, D),
                       JMeta.from_field_offsets(D, [0, 30]),
                       mesh=make_mesh(1), write_files=False)
    tl = tb.BPRLearner(FMConfig(**kw), SparseDataset.from_coo(tr, D),
                       SparseDataset.from_coo(te, D),
                       DataMetaInfo.from_field_offsets(D, [0, 30]),
                       device="cpu", write_files=False)
    return jl, tl


def test_bpr_epochs_match_jax():
    jl, tl = _pair()
    assert (tl.neg_lo, tl.neg_hi) == (jl.neg_lo, jl.neg_hi) == (30, 55)
    js = jl.init_state()
    ts = bpr_state_from_jax(jax.device_get(js), "cpu", JaxBPRKeys(js.key))
    jend, jh = jl.run(js, num_iter=2, verbose=False)
    tend, th = tl.run(ts, num_iter=2, verbose=False,
                      eval_draws=JaxEvalNegatives(tl.cfg.seed))
    for a, b in zip(jh, th):
        assert b["accuracy"] == a["accuracy"]
        np.testing.assert_allclose(b["pair_loss"], a["pair_loss"], rtol=1e-5)
    for k in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(tend, k).numpy(),
                                   np.asarray(getattr(jend, k)), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(np.asarray(tend.draws.key),
                                  np.asarray(jend.key))
    # reg0 > 0: w0 only shrinks, by max(1 - reg0, 0) per pair, from 0
    assert float(tend.w0) == 0.0


def test_bpr_pair_update_matches_jax():
    """One pair batch: a padding pair (valid 0), a pair whose negative is
    its own item (no count, the gradients cancel) and random negatives."""
    tr, _, D = _data()
    ds = SparseDataset.from_coo(tr, D)
    B = 64
    rng = np.random.default_rng(0)
    ids = ds.ids[:B].astype(np.int32)
    vals = ds.vals[:B].astype(np.float32)
    lo, hi = 30, 55
    neg = rng.integers(lo, hi, size=B).astype(np.int32)
    neg[5] = ids[5, 1]
    valid = np.ones(B, np.float32)
    valid[-1] = 0.0
    w0 = np.float32(0.2)
    w = rng.normal(0, 0.1, D).astype(np.float32)
    v = rng.normal(0, 0.1, (4, D)).astype(np.float32)
    kw = _cfg_kw(D)
    jcfg = JConfig(**kw)
    mask = (ids >= lo) & (ids < hi)
    ids_n = np.where(mask, neg[:, None], ids).astype(np.int32)

    @jax.jit
    @partial(jax.shard_map, mesh=make_mesh(1), in_specs=(P(),) * 9,
             out_specs=(P(),) * 3)
    def jstep(w0, w, v, ids, vals, ids_n, vals_n, m, valid):
        return jb.bpr_pair_update(w0, w, v, ids, vals, ids_n, vals_n, m,
                                  valid, jcfg, jcfg.learn_rate)

    want = [np.asarray(a) for a in jstep(
        *map(jnp.asarray, (w0, w, v, ids, vals, ids_n, vals,
                           mask.astype(np.float32), valid)))]
    state = tb.BPRState(w0=torch.tensor(w0),
                        tab=table(torch.from_numpy(w), torch.from_numpy(v)),
                        draws=None)
    ws = ks.make_workspace(D, 4, "cpu")
    tb.bpr_pair_update(state, torch.from_numpy(ids), torch.from_numpy(vals),
                       torch.from_numpy(valid), torch.from_numpy(neg), lo, hi,
                       tb.bpr_step_mode(FMConfig(**kw)), ws)
    for got, ref, k in zip((state.w0, state.w, state.v), want,
                           ("w0", "w", "v")):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert not np.allclose(want[2], v)
    assert not ws.acc.any() and not ws.acc0.any()


def test_bpr_learns_to_rank_with_own_generator():
    _, tl = _pair()
    _, hist = tl.run(num_iter=15, verbose=False)
    assert hist[-1]["accuracy"] > 0.55
    assert hist[-1]["pair_loss"] < hist[0]["pair_loss"]


def test_bpr_negative_field_choice():
    """-bpr_neg_field 0 samples negatives from the user field; the JAX
    learner picks the same range."""
    tr, te, D = _data()
    kw = _cfg_kw(D)
    tl = tb.BPRLearner(FMConfig(**kw), SparseDataset.from_coo(tr, D),
                       SparseDataset.from_coo(te, D), device="cpu",
                       neg_field=0, write_files=False)
    jl = jb.BPRLearner(JConfig(**kw), JDataset.from_coo(tr, D),
                       JDataset.from_coo(te, D), mesh=make_mesh(1),
                       neg_field=0, write_files=False)
    assert (tl.neg_lo, tl.neg_hi) == (jl.neg_lo, jl.neg_hi) == (0, 30)
    neg = tl.eval_negatives()
    assert ((neg >= 0) & (neg < 30)).all()
