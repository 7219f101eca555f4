"""The port's serving path (``svbfm_tpu_torch.serve.BatchScorer``, K1a with
its serve epilogue) on the CPU, where the epilogue is the plain twin
(``kernels/fm_forward.py:fm_serve_plain``), against the JAX package's
``svbfm_tpu.serve.BatchScorer`` and the port's own learners.

Counterparts of the six cases of ``tests/test_serve.py`` (feature sharding
is a refusal here: several GPUs are ROADMAP.md queue 1, item 13), plus the
same numpy parameters through both scorers (regression, one-sided bounds
and probit) and the epilogue on NaN, +-Inf and one-sided bounds.
Tolerance: rtol 1e-5, atol 1e-6, as ``test_serve.py:46``; windowed and
one-shot scoring agree bit for bit."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu.serve import BatchScorer as JScorer
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.kernels import fm_forward as k1
from svbfm_tpu_torch.learners.base import (TASK_CLASSIFICATION, FMConfig,
                                           ref_cdf_gaussian)
from svbfm_tpu_torch.serve import BatchScorer

RTOL, ATOL = 1e-5, 1e-6


def _trained(task=0):
    """The port's ALS learner after 3 sweeps (test_serve.py's _trained)."""
    from svbfm_tpu_torch.learners.mcmc import ALSLearner
    coo = make_movielens_like(num_users=40, num_items=25, num_ratings=1500,
                              rank=2, noise=0.3, seed=1)
    tr, te = train_test_split(coo, 0.2, seed=2)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 40])
    cfg = FMConfig(num_attributes=D, num_factor=4, num_groups=2, seed=5,
                   task=task, min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()))
    if task == TASK_CLASSIFICATION:
        thr = float(np.median(tr.target))
        tr.target = np.where(tr.target >= thr, 1.0, -1.0).astype(np.float32)
        te.target = np.where(te.target >= thr, 1.0, -1.0).astype(np.float32)
    lr = ALSLearner(cfg, SparseDataset.from_coo(tr, D),
                    SparseDataset.from_coo(te, D), meta, device="cpu",
                    write_files=False)
    state, _ = lr.run(num_iter=3, verbose=False)
    return lr, state, cfg, te, D


def test_scorer_matches_learner_predictions():
    lr, state, cfg, te, D = _trained()
    scorer = BatchScorer.from_state(state, cfg, device="cpu")
    got = scorer.score_coo(te)
    want = np.clip(lr.predict_test_scores(state), cfg.min_target,
                   cfg.max_target)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_scorer_batching_and_inflight_window():
    """Small batch_rows forces many batches through the in-flight window;
    the predictions are one-shot scoring's, bit for bit."""
    lr, state, cfg, te, D = _trained()
    one = BatchScorer.from_state(state, cfg, device="cpu")
    many = BatchScorer.from_state(state, cfg, device="cpu", batch_rows=64,
                                  inflight=2)
    np.testing.assert_array_equal(many.score_coo(te), one.score_coo(te))


def test_scorer_classification_probit():
    lr, state, cfg, te, D = _trained(task=TASK_CLASSIFICATION)
    scorer = BatchScorer.from_state(state, cfg, device="cpu")
    got = scorer.score_coo(te)
    raw = lr.predict_test_scores(state)
    want = ref_cdf_gaussian(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got >= 0).all() and (got <= 1).all()


def test_scorer_feature_sharded_refused():
    with pytest.raises(NotImplementedError, match="item 13"):
        BatchScorer(0.0, np.zeros(10, np.float32),
                    np.zeros((2, 10), np.float32), device="cpu",
                    feature_sharded=True)


def test_scorer_row_pad_and_empty():
    lr, state, cfg, te, D = _trained()
    s = BatchScorer.from_state(state, cfg, device="cpu", row_pad=6)
    got = s.score_coo(te)
    assert got.shape == (te.num_rows,)
    np.testing.assert_array_equal(
        got, BatchScorer.from_state(state, cfg, device="cpu").score_coo(te))
    # rows wider than row_pad are rejected
    with pytest.raises(ValueError):
        s.score_rows(np.zeros((4, 9), np.int32), np.zeros((4, 9), np.float32))
    # no rows: an empty result, and nothing dispatched
    s._dispatch = None
    assert s.score_rows(np.zeros((0, 2), np.int32),
                        np.zeros((0, 2), np.float32)).shape == (0,)


def test_scorer_inflight_bound(monkeypatch):
    """At most `inflight` batches are dispatched and not fetched at any time:
    the oldest is drained BEFORE each dispatch (serve.py:190-194), in
    dispatch order, and slot k of the window holds batch k mod inflight."""
    sc = BatchScorer(0.0, np.zeros(10, np.float32),
                     np.zeros((2, 10), np.float32), batch_rows=4,
                     inflight=2, device="cpu")
    events = []
    counter = [0]

    def fake_dispatch(slot, ids, vals, width):
        i = counter[0]
        counter[0] += 1
        assert slot == i % 2
        events.append(("dispatch", i))
        return i, ids.shape[0]

    def fake_fetch(handle):
        i, n = handle
        events.append(("drain", i))
        return np.zeros(n, np.float32)

    monkeypatch.setattr(sc, "_dispatch", fake_dispatch)
    monkeypatch.setattr(sc, "_fetch", fake_fetch)
    out = sc.score_rows(np.zeros((20, 1), np.int32),
                        np.ones((20, 1), np.float32))
    assert out.shape == (20,)
    outstanding = 0
    for ev, _ in events:
        outstanding += 1 if ev == "dispatch" else -1
        assert 0 <= outstanding <= 2
    drains = [i for ev, i in events if ev == "drain"]
    assert drains == sorted(drains) and len(drains) == counter[0] == 5


def _params(seed=3, D=30, K=4):
    rng = np.random.default_rng(seed)
    return (np.float32(rng.normal()), rng.normal(0, 0.8, D).astype(np.float32),
            rng.normal(0, 0.8, (K, D)).astype(np.float32))


def _rows(seed=4, N=300, P=3, D=30):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, D, (N, P)).astype(np.int32)
    vals = rng.uniform(0.2, 2.0, (N, P)).astype(np.float32)
    ids[::7, 2], vals[::7, 2] = 0, 0.0  # padding entries
    return ids, vals


@pytest.mark.parametrize("kw", [
    dict(min_target=1.0, max_target=5.0),
    dict(min_target=-np.inf, max_target=2.0),
    dict(min_target=0.5, max_target=np.inf),
    dict(task=TASK_CLASSIFICATION),
    dict(k0=False, k1=False, min_target=-1.0, max_target=1.0),
], ids=["clamp", "hi-only", "lo-only", "probit", "k0k1-off"])
def test_scorer_matches_jax_scorer(kw):
    """The same numpy parameters and rows through both packages' scorers
    (the JAX one on one device), batches of 64 rows, two in flight."""
    w0, w, v = _params()
    ids, vals = _rows()
    want = JScorer(w0, w, v, mesh=make_mesh(1), batch_rows=64,
                   **kw).score_rows(ids, vals)
    got = BatchScorer(w0, w, v, device="cpu", batch_rows=64,
                      **kw).score_rows(ids, vals)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


SPECIAL = np.array([np.nan, np.inf, -np.inf, -3.0, -0.5, 0.0, 0.7, 2.5,
                    40.0, -40.0], np.float32)


@pytest.mark.parametrize("task,lo,hi", [
    (0, 0.0, 1.0), (0, -np.inf, 1.0), (0, -1.0, np.inf),
    (0, -np.inf, np.inf), (0, np.nan, 1.0), (0, 2.0, -2.0),
    (TASK_CLASSIFICATION, -np.inf, np.inf)],
    ids=["both", "hi", "lo", "none", "nan-lo", "crossed", "probit"])
def test_serve_epilogue_plain_matches_jax_transform(task, lo, hi):
    """The plain epilogue against the JAX scorer's _transform on NaN, +-Inf
    and ordinary scores: the same NaN/Inf pattern, a NaN score stays NaN,
    +-Inf clamps to a finite bound; the kernel's bounds (serve_bounds)
    open a non-finite side."""
    js = JScorer(0.0, np.zeros(3, np.float32), np.zeros((1, 3), np.float32),
                 mesh=make_mesh(1), task=task, min_target=lo, max_target=hi)
    want = np.asarray(js._transform(jnp.asarray(SPECIAL)))
    mode = k1.SERVE_PROBIT if task == TASK_CLASSIFICATION else k1.SERVE_CLAMP
    got = k1.serve_epilogue_plain(torch.from_numpy(SPECIAL), mode, lo,
                                  hi).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    b_lo, b_hi = k1.serve_bounds(lo, hi)
    if mode == k1.SERVE_CLAMP:  # the kernel's select form on these bounds
        sel = np.where(SPECIAL < b_lo, b_lo, SPECIAL)
        sel = np.where(sel > b_hi, b_hi, sel)
        np.testing.assert_array_equal(sel, want)
    assert math.isinf(b_lo) or b_lo == lo
    assert math.isinf(b_hi) or b_hi == hi


def test_fm_serve_op_on_cpu_is_the_plain_twin():
    """fm_serve_op on CPU tensors is the twin; out= receives it; N = 0
    gives an empty result; an unknown mode is refused."""
    from svbfm_tpu_torch.ops.forward import score_table
    w0, w, v = _params()
    ids, vals = _rows()
    tab = score_table(torch.from_numpy(w), torch.from_numpy(v))
    tw0 = torch.tensor(w0)
    ti, tv = torch.from_numpy(ids), torch.from_numpy(vals)
    for mode in (k1.SERVE_SCORE, k1.SERVE_CLAMP, k1.SERVE_PROBIT):
        want = k1.fm_serve_plain(tab, tw0, ti, tv, mode, -1.0, 1.0)
        out = torch.empty(ids.shape[0])
        got = k1.fm_serve_op(tab, tw0, ti, tv, mode, -1.0, 1.0, out=out)
        assert got is out
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        k1.fm_serve_op(tab, tw0, ti, tv, k1.SERVE_SCORE),
        k1.fm_scores_op(tab, tw0, ti, tv), rtol=0, atol=0)
    assert k1.fm_serve_op(tab, tw0, ti[:0], tv[:0],
                          k1.SERVE_CLAMP).shape == (0,)
    with pytest.raises(ValueError, match="unknown serve mode"):
        k1.fm_serve_op(tab, tw0, ti, tv, 7)


@pytest.mark.parametrize("kind", ["vb", "sgd"])
def test_from_state_reads_each_state_kind(kind):
    """from_state takes VB's variational means and the SGD table's
    w/v properties, as svbfm_tpu's name lookup does."""
    from svbfm_tpu_torch.learners.draws import device_draws
    from svbfm_tpu_torch.learners.sgd import SGDState, table
    from svbfm_tpu_torch.learners.vb import VBState
    w0, w, v = _params()
    cfg = FMConfig(num_attributes=w.shape[0], num_factor=v.shape[0],
                   min_target=-2.0, max_target=2.0)
    t = torch.from_numpy
    if kind == "vb":
        z = torch.zeros(())
        state = VBState(mu_0=t(np.array(w0)), sigma_0_dash=z, mu_w=t(w),
                        sigma_w_dash=t(w), mu_v=t(v), sigma_v_dash=t(v),
                        alpha=z, sigma_0=z, sigma_w=z, sigma_v=z, e=z, t=z)
    else:
        state = SGDState(w0=t(np.array(w0)), tab=table(t(w), t(v)),
                         draws=device_draws(0, "cpu"))
    ids, vals = _rows()
    got = BatchScorer.from_state(state, cfg, device="cpu").score_rows(ids,
                                                                      vals)
    want = BatchScorer(w0, w, v, device="cpu", min_target=-2.0,
                       max_target=2.0).score_rows(ids, vals)
    np.testing.assert_array_equal(got, want)
