"""Checkpoint/resume in the port (``svbfm_tpu_torch/utils/checkpoint.py``
and each learner's ``run(ckpt=...)``) on the CPU.

Counterparts of the eight cases of ``tests/test_checkpoint.py``: a resumed
run executes only the remaining iterations and ends where the
uninterrupted one ends, here bit for bit (the port's runs are eager and
deterministic; Gibbs and the SGD family draw from a generator whose state
rides in the checkpoint).  The resumed trajectories are also held to the
JAX package's uninterrupted runs from one injected state (VB, OVB and
ALS, whose steps draw no random numbers) at the JAX tests' rtol 1e-5; and
the file format (``leaf_<i>``, ``__names__``, ``__step__``, ``__meta__``)
and its guards to ``svbfm_tpu/utils/checkpoint.py``'s."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.draws import device_draws
from svbfm_tpu_torch.learners.vb import VBLearner
from svbfm_tpu_torch.utils.checkpoint import (CheckpointManager,
                                              latest_checkpoint,
                                              load_checkpoint,
                                              save_checkpoint)


def _data(seed=2):
    coo = make_movielens_like(num_users=12, num_items=9, num_ratings=400,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 12])
    return coo, tr, te, D, meta


def _cfg(tr, D, meta, **kw):
    return FMConfig(num_attributes=D, num_factor=3,
                    min_target=float(tr.target.min()),
                    max_target=float(tr.target.max()),
                    num_groups=meta.num_attr_groups, seed=7, **kw)


def _learner():
    coo, tr, te, D, meta = _data()
    return VBLearner(_cfg(tr, D, meta), SparseDataset.from_coo(tr, D),
                     SparseDataset.from_coo(te, D), meta, device="cpu",
                     write_files=False)


def _ckpt_files(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".npz"))


def test_save_load_roundtrip(tmp_path):
    """The JAX package's file format and guards; a Draws source's generator
    comes back with its state."""
    lr = _learner()
    s = lr.init_state()
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, s, 5, {"k": "v"})
    s2, step, meta = load_checkpoint(p, s)
    assert step == 5 and meta == {"k": "v"}
    np.testing.assert_array_equal(s.mu_v.numpy(), s2.mu_v.numpy())
    np.testing.assert_array_equal(s.e.numpy(), s2.e.numpy())
    with np.load(p) as z:
        assert {"__names__", "__step__", "__meta__", "leaf_0"} <= set(z.files)
        assert list(z["__names__"])[:3] == [".mu_0", ".sigma_0_dash", ".mu_w"]
    # structure and shape guards
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(p, {"other": s.mu_v})
    bad = dataclasses.replace(s, mu_v=torch.zeros(2, 2))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(p, bad)
    draws = device_draws(11, "cpu")
    draws.normal((3,))
    save_checkpoint(p, {"d": draws, "x": torch.ones(2)}, 1)
    blob, _, _ = load_checkpoint(p, {"d": device_draws(0, "cpu"),
                                     "x": torch.zeros(2)})
    torch.testing.assert_close(blob["d"].normal((4,)), draws.normal((4,)),
                               rtol=0, atol=0)
    assert latest_checkpoint(str(tmp_path)) is None  # no ckpt_<step>.npz


def test_resume_matches_uninterrupted(tmp_path):
    s_full, h_full = _learner().run(num_iter=6, verbose=False, chunk=3)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _learner().run(num_iter=3, verbose=False, chunk=3, ckpt=mgr,
                   ckpt_every=3)
    assert _ckpt_files(str(tmp_path / "ck")), "first run wrote no checkpoint"
    s_res, h_res = _learner().run(num_iter=6, verbose=False, chunk=3,
                                  ckpt=mgr, ckpt_every=100)
    # the resumed run executed ONLY the remaining 3 iterations
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_array_equal(s_res.mu_v.numpy(), s_full.mu_v.numpy())
    assert float(s_res.alpha) == float(s_full.alpha)
    assert h_res[-1]["iter"] == 5
    assert [h["rmse"] for h in h_res] == [h["rmse"] for h in h_full[3:]]


def _mcmc_learner(cls, **kw):
    coo, tr, te, D, meta = _data()
    cfg = _cfg(tr, D, meta, regw=0.1, regv=0.1)
    return cls(cfg, SparseDataset.from_coo(tr, D),
               SparseDataset.from_coo(te, D), meta, device="cpu",
               write_files=False, **kw)


@pytest.mark.parametrize("kind", ["als", "gibbs"])
def test_mcmc_resume_matches(tmp_path, kind):
    """ALS and Gibbs sampling resume: the state, the posterior-mean
    accumulators and (Gibbs) the draw source's generator ride in the
    checkpoint, so the resumed chain is the uninterrupted one bit for bit."""
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    cls = ALSLearner if kind == "als" else MCMCLearner
    s_full, h_full = _mcmc_learner(cls).run(num_iter=6, verbose=False,
                                            chunk=3)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _mcmc_learner(cls).run(num_iter=3, verbose=False, chunk=3, ckpt=mgr,
                           ckpt_every=3)
    assert _ckpt_files(str(tmp_path / "ck")), "MCMC run wrote no checkpoint"
    with np.load(os.path.join(str(tmp_path / "ck"), "ckpt_3.npz")) as z:
        names = list(z["__names__"])
    assert "['state'].draws.generator" in names
    assert {"['psum_all']", "['psum_but5']"} <= set(names)
    lr = _mcmc_learner(cls)
    s_res, h_res = lr.run(num_iter=6, verbose=False, chunk=3, ckpt=mgr,
                          ckpt_every=100)
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_array_equal(s_res.v.numpy(), s_full.v.numpy())
    # posterior-mean accumulator continuity: running-mean RMSE matches
    assert h_res[-1]["rmse"] == h_full[-1]["rmse"]
    assert lr._pred_iters == 6


def test_bs_sampling_resume_matches(tmp_path):
    """Block-structure Gibbs checkpoints and resumes as the flat sampler
    (the same MCMCState; relation caches rebuilt from the state)."""
    from test_torch_bs import _pair

    def mk():
        return _pair(False, factor_block=1)[1]
    s_full, h_full = mk().run(num_iter=6, verbose=False)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mk().run(num_iter=3, verbose=False, ckpt=mgr, ckpt_every=3)
    assert _ckpt_files(str(tmp_path / "ck")), "BS run wrote no checkpoint"
    s_res, h_res = mk().run(num_iter=6, verbose=False, ckpt=mgr,
                            ckpt_every=100)
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_array_equal(s_res.v.numpy(), s_full.v.numpy())
    assert h_res[-1]["rmse"] == h_full[-1]["rmse"]


def test_mcmc_final_predictions_posterior_mean():
    """Sampling MCMC's final predictions are pred_sum_all / iterations (the
    reference's predict(), fm_learn_mcmc.h:355-379), not the last
    sample's."""
    from svbfm_tpu_torch.learners.mcmc import MCMCLearner
    lr = _mcmc_learner(MCMCLearner)
    state, h = lr.run(num_iter=4, verbose=False, chunk=2)
    final = lr.final_test_predictions(state)
    target = lr.test_row.target.numpy()[: lr.test_n]
    rmse = float(np.sqrt(np.mean((final - target) ** 2)))
    np.testing.assert_allclose(rmse, h[-1]["rmse"], rtol=1e-5)
    last = np.clip(lr.predict_test_scores(state), lr.cfg.min_target,
                   lr.cfg.max_target)
    assert not np.allclose(final, last)


SGD_FAMILY = ["sgd", "sgda", "sgd_online", "exp_sgd", "exp_sgd_stoc"]


@pytest.mark.parametrize("name", SGD_FAMILY)
def test_sgd_family_resume(tmp_path, name):
    """Every SGD-family learner resumes to the exact state of an
    uninterrupted run (the draw source's generator and, for sgd_online,
    the replayed chunk orders)."""
    from svbfm_tpu_torch.learners.exp_sgd import (ExpSGDLearner,
                                                  ExpSGDStocLearner)
    from svbfm_tpu_torch.learners.sgd import (SGDALearner, SGDLearner,
                                              SGDOnlineLearner)
    coo, tr, te, D, meta = _data()
    va, te2 = train_test_split(te, 0.5, seed=4)
    cfg = _cfg(tr, D, meta, learn_rate=0.02, regw=0.01, regv=0.01,
               num_batches=2)
    tr_ds, te_ds, va_ds = (SparseDataset.from_coo(c, D)
                           for c in (tr, te2, va))
    kw = dict(device="cpu", write_files=False)
    mk = {"sgd": lambda: SGDLearner(cfg, tr_ds, te_ds, meta, **kw),
          "sgda": lambda: SGDALearner(cfg, tr_ds, te_ds, va_ds, meta, **kw),
          "sgd_online": lambda: SGDOnlineLearner(cfg, tr_ds, te_ds, meta,
                                                 **kw),
          "exp_sgd": lambda: ExpSGDLearner(cfg, tr_ds, te_ds, meta, **kw),
          "exp_sgd_stoc": lambda: ExpSGDStocLearner(cfg, tr_ds, te_ds, meta,
                                                    **kw)}[name]
    s_full, h_full = mk().run(num_iter=4, verbose=False)
    ckdir = str(tmp_path / "ck")
    mgr = CheckpointManager(ckdir)
    mk().run(num_iter=2, verbose=False, ckpt=mgr, ckpt_every=2)
    assert _ckpt_files(ckdir), f"{name} wrote no checkpoint"
    s_res, h_res = mk().run(num_iter=4, verbose=False, ckpt=mgr,
                            ckpt_every=100)
    assert len(h_res) == 2 and h_res[0]["iter"] == 2, name
    np.testing.assert_array_equal(s_res.v.numpy(), s_full.v.numpy())
    assert [h["rmse"] for h in h_res] == [h["rmse"] for h in h_full[2:]]


def _ovb(**kw):
    from svbfm_tpu_torch.learners.vb_online import OVBLearner
    coo, tr, te, D, meta = _data()
    return OVBLearner(_cfg(tr, D, meta, num_batches=3, **kw),
                      SparseDataset.from_coo(tr, D),
                      SparseDataset.from_coo(te, D), meta, device="cpu",
                      write_files=False)


@pytest.mark.parametrize("reshuffle", [False, True])
def test_ovb_resume_matches(tmp_path, reshuffle):
    """OVB resumes with the epoch order (and, reshuffled, the membership)
    replayed."""
    s_full, h_full = _ovb(reshuffle=reshuffle).run(num_iter=6, verbose=False)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    _ovb(reshuffle=reshuffle).run(num_iter=3, verbose=False, ckpt=mgr,
                                  ckpt_every=3)
    assert _ckpt_files(str(tmp_path / "ck")), "OVB run wrote no checkpoint"
    s_res, h_res = _ovb(reshuffle=reshuffle).run(num_iter=6, verbose=False,
                                                 ckpt=mgr, ckpt_every=100)
    assert len(h_res) == 3 and h_res[0]["iter"] == 3
    np.testing.assert_array_equal(s_res.mu_v.numpy(), s_full.mu_v.numpy())
    assert h_res[-1]["rmse"] == h_full[-1]["rmse"]


def test_resume_leaves_trajectory_files(tmp_path, monkeypatch):
    """A resumed run leaves the trajectory files as the first run wrote
    them, neither truncated nor appended to (vb.py:1407: the files are
    enabled only when done == 0), and checkpoint_every counts from the
    resumed iteration; max_to_keep prunes the oldest."""
    monkeypatch.chdir(tmp_path)
    coo, tr, te, D, meta = _data()
    mk = lambda: VBLearner(_cfg(tr, D, meta), SparseDataset.from_coo(tr, D),
                           SparseDataset.from_coo(te, D), meta, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    mk().run(num_iter=3, verbose=False, chunk=1, ckpt=mgr, ckpt_every=2)
    assert _ckpt_files(str(tmp_path / "ck")) == ["ckpt_2.npz", "ckpt_3.npz"]
    mk().run(num_iter=6, verbose=False, chunk=1, ckpt=mgr, ckpt_every=2)
    assert _ckpt_files(str(tmp_path / "ck")) == ["ckpt_5.npz", "ckpt_6.npz"]
    assert np.loadtxt("test_rmse_113_vb").shape == (3,)
    assert np.loadtxt("free_energy_113_vb").shape == (3,)


def test_windowed_learners_refuse_checkpoints(tmp_path):
    from svbfm_tpu_torch.learners.vb_windowed import WindowedVBLearner
    coo, tr, te, D, meta = _data()
    lr = WindowedVBLearner(_cfg(tr, D, meta, factor_block=1),
                           SparseDataset.from_coo(tr, D),
                           SparseDataset.from_coo(te, D), meta, device="cpu",
                           write_files=False, cache_bytes=4000)
    with pytest.raises(ValueError, match="does not resume"):
        lr.run(num_iter=1, verbose=False,
               ckpt=CheckpointManager(str(tmp_path)))


# ---------------------------------------------------------------------------
# the port's resumed trajectory against svbfm_tpu's uninterrupted run
# ---------------------------------------------------------------------------

def _jax_pair(kind):
    """The JAX learner, the port's maker and the port's start state from
    the JAX learner's init, on test_checkpoint.py's data."""
    from svbfm_tpu.data.dataset import SparseDataset as JDataset
    from svbfm_tpu.data.meta import DataMetaInfo as JMeta
    from svbfm_tpu.learners.base import FMConfig as JConfig
    from svbfm_tpu.parallel.mesh import make_mesh
    from svbfm_tpu_torch.utils import convert
    coo, tr, te, D, meta = _data()
    kw = dict(num_attributes=D, num_factor=3, seed=7,
              min_target=float(tr.target.min()),
              max_target=float(tr.target.max()),
              num_groups=meta.num_attr_groups, regw=0.1, regv=0.1,
              num_batches=3)
    jmeta = JMeta.from_field_offsets(D, [0, 12])
    jds = (JDataset.from_coo(tr, D), JDataset.from_coo(te, D), jmeta)
    tds = (SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
           meta)
    if kind == "vb":
        from svbfm_tpu.learners.vb import VBLearner as J
        T, conv = VBLearner, convert.state_from_jax
    elif kind == "ovb":
        from svbfm_tpu.learners.vb_online import OVBLearner as J
        from svbfm_tpu_torch.learners.vb_online import OVBLearner as T
        conv = convert.ovb_state_from_jax
    else:
        from svbfm_tpu.learners.mcmc import ALSLearner as J
        from svbfm_tpu_torch.learners.mcmc import ALSLearner as T

        def conv(s, dev):
            return convert.mcmc_state_from_jax(s, dev,
                                               device_draws(0, dev))
    jl = J(JConfig(**kw), *jds, mesh=make_mesh(1), write_files=False)
    js = jl.init_state()
    start = jax.device_get(js)

    def mk():
        return T(FMConfig(**kw), *tds, device="cpu", write_files=False)
    return jl, js, mk, lambda: conv(start, "cpu")


@pytest.mark.parametrize("kind", ["vb", "ovb", "als"])
def test_resumed_trajectory_matches_jax(tmp_path, kind):
    jl, js, mk, start = _jax_pair(kind)
    extra = {} if kind == "ovb" else dict(chunk=3)
    _, h_jax = jl.run(js, num_iter=6, verbose=False, **extra)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mk().run(start(), num_iter=3, verbose=False, ckpt=mgr, ckpt_every=3,
             **extra)
    _, h_res = mk().run(start(), num_iter=6, verbose=False, ckpt=mgr,
                        ckpt_every=100, **extra)
    assert [h["iter"] for h in h_res] == [3, 4, 5]
    np.testing.assert_allclose([h["rmse"] for h in h_res],
                               [h["rmse"] for h in h_jax[3:]], rtol=1e-5)
