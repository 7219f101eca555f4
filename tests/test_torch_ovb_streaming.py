"""Out-of-core OVBFM in the port (``OVBLearner.from_reader``: the chunks
streamed from a binary file, the CPU twins of the kernels) against the JAX
package's ``OVBLearner.from_reader`` on the same file, both started from
the JAX learner's init (``utils.convert.ovb_state_from_jax``).

Tolerances are ``tests/test_torch_vb_online.py``'s: parameters,
precisions and caches rtol 1e-4 / atol 1e-5; naturals rtol 1e-3 / atol
1e-4; rmse, mae and free energy rtol 1e-5; t_w0, t_wj, t_vj and the
nan/inf counters equal.  One streamed chunk against the port's in-memory
learner (whose one chunk holds the rows in another order, so the column
sums are taken in another order): the JAX test's own bound
(test_ovb_streaming.py:53-55), mu_v rtol 2e-4 / atol 1e-6, rmse rtol
1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from svbfm_tpu.data.binary import save_coo_binary
from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.stream import BinaryChunkReader as JReader
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import vb_online as jov
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.stream import BinaryChunkReader
from svbfm_tpu_torch.learners import vb_online as tov
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.streaming import DeviceFeed
from svbfm_tpu_torch.utils.convert import ovb_state_from_jax

FIELDS = [f.name for f in dataclasses.fields(tov.OVBState)]
NATURALS = ("n_mu_0", "n_sig_0", "n_mu_w", "n_sig_w", "n_mu_v", "n_sig_v")
COUNTERS = ("t_w0", "t_wj", "t_vj")


def _setup(tmp_path, num_batches, task=0, seed=2, **cfg_kw):
    """test_ovb_streaming.py's data (500 ratings, 15 users, 11 items, K =
    3) written as tr.x/tr.y, the configs of both packages and a reader of
    each."""
    coo = make_movielens_like(num_users=15, num_items=11, num_ratings=500,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    if task == 1:  # the test targets binarised as the CLI does
        te.target = np.where(te.target > 3, 1.0, -1.0).astype(np.float32)
    kw = dict(num_attributes=D, num_factor=3, task=task,
              min_target=-1.0 if task else float(tr.target.min()),
              max_target=1.0 if task else float(tr.target.max()),
              num_groups=2, seed=7, num_batches=num_batches, **cfg_kw)
    prefix = str(tmp_path / "tr")
    save_coo_binary(prefix, tr)
    return dict(
        D=D, tr=tr, te=te, jcfg=JConfig(**kw), tcfg=FMConfig(**kw),
        jmeta=JMeta.from_field_offsets(D, [0, 15]),
        tmeta=DataMetaInfo.from_field_offsets(D, [0, 15]),
        jreader=JReader(prefix + ".x", prefix + ".y"),
        treader=BinaryChunkReader(prefix + ".x", prefix + ".y"))


def _pair(tmp_path, num_batches, task=0, **cfg_kw):
    s = _setup(tmp_path, num_batches, task, **cfg_kw)
    D = s["D"]
    jl = jov.OVBLearner.from_reader(
        s["jcfg"], s["jreader"], JDataset.from_coo(s["te"], D), s["jmeta"],
        mesh=make_mesh(1), write_files=False,
        cache_dir=str(tmp_path / "jplans"))
    tl = tov.OVBLearner.from_reader(
        s["tcfg"], s["treader"], SparseDataset.from_coo(s["te"], D),
        s["tmeta"], device="cpu", write_files=False,
        cache_dir=str(tmp_path / "tplans"))
    return jl, tl, s


def _np(state):
    if isinstance(state, tov.OVBState):
        return {k: getattr(state, k).numpy() for k in FIELDS}
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _run_both(jl, tl, epochs):
    js = jl.init_state()
    ts = ovb_state_from_jax(jax.device_get(js), "cpu")
    js, jh = jl.run(js, num_iter=epochs, verbose=False)
    ts, th = tl.run(ts, num_iter=epochs, verbose=False)
    return _np(ts), th, _np(jax.device_get(js)), jh


def _assert_close(tn, th, jn, jh, metrics=("rmse", "mae")):
    for k in FIELDS:
        if k in COUNTERS:
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)
        elif k in NATURALS:
            np.testing.assert_allclose(tn[k], jn[k], rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(tn[k], jn[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert len(th) == len(jh)
    for a, b in zip(jh, th):
        for k in metrics + ("free_energy",):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
        counters = [k for k in a if k.startswith(("nan_", "inf_"))]
        assert len(counters) == 20
        assert {k: b[k] for k in counters} == {k: int(a[k]) for k in counters}


def test_three_chunks_two_epochs_match_jax(tmp_path):
    jl, tl, _ = _pair(tmp_path, num_batches=3)
    np.testing.assert_array_equal(tl.chunk_sizes, jl.chunk_sizes)
    np.testing.assert_array_equal(tl.chunk_bounds, jl.chunk_bounds)
    np.testing.assert_array_equal(tl.col_count, jl.col_count)
    assert tl.cfg.factor_block == 1 == jl.cfg.factor_block
    _assert_close(*_run_both(jl, tl, 2))


def test_epoch_orders_match_jax(tmp_path):
    jl, tl, _ = _pair(tmp_path, num_batches=4)
    for _ in range(3):
        np.testing.assert_array_equal(tl.rng.permutation(tl.num_chunks),
                                      jl.rng.permutation(jl.num_chunks))


def test_one_streamed_chunk_matches_in_memory(tmp_path):
    _jl, tl, s = _pair(tmp_path, num_batches=1)
    D = s["D"]
    mem = tov.OVBLearner(s["tcfg"], SparseDataset.from_coo(s["tr"], D),
                         SparseDataset.from_coo(s["te"], D), s["tmeta"],
                         device="cpu", write_files=False)
    init = tl.init_state()
    s_str, h_str = tl.run(init, num_iter=3, verbose=False)
    s_mem, h_mem = mem.run(init, num_iter=3, verbose=False)
    np.testing.assert_allclose(s_str.mu_v.numpy(), s_mem.mu_v.numpy(),
                               rtol=2e-4, atol=1e-6)
    for a, b in zip(h_str, h_mem):
        np.testing.assert_allclose(a["rmse"], b["rmse"], rtol=1e-4)


def test_classification_streams_binarised_chunks(tmp_path):
    """-task c: each chunk's targets are binarised as it is read (the
    reader holds the ratings); JAX's streaming learner does the same."""
    jl, tl, s = _pair(tmp_path, num_batches=3, task=1)
    assert (s["treader"].targets > 1).any()  # ratings, not +-1
    _, rows, _ = tl._read_chunk(0)
    assert set(np.unique(rows[2])) <= {-1.0, 1.0}
    _assert_close(*_run_both(jl, tl, 2), metrics=("accuracy", "loglik"))


def test_reshuffle_is_turned_off_with_a_note(tmp_path, capsys):
    s = _setup(tmp_path, num_batches=3, reshuffle=True)
    tl = tov.OVBLearner.from_reader(
        s["tcfg"], s["treader"], SparseDataset.from_coo(s["te"], s["D"]),
        s["tmeta"], device="cpu", write_files=False)
    assert not tl.cfg.reshuffle
    assert "-reshuffle is not supported for out-of-core streaming" in \
        capsys.readouterr().out
    plans = tl.plan_cache_dir
    import os
    assert sorted(os.listdir(plans)) == [f"plan_{i}.npz" for i in range(3)]
    del tl
    import gc
    gc.collect()
    assert not os.path.exists(plans)  # the learner's own folder goes with it


def test_device_feed_order_depth_and_errors():
    """On the CPU the feed yields upload(load(key)) in key order, with and
    without reader threads; a reader's exception reaches the consumer."""
    seen = []

    def load(k):
        seen.append(k)
        if k == 7:
            raise RuntimeError("bad chunk 7")
        return torch.full((2,), float(k))

    feed = DeviceFeed("cpu", depth=3, workers=2)
    out = list(feed([4, 1, 3], load, lambda h, put: put(h) * 2))
    assert [float(t[0]) for t in out] == [8.0, 2.0, 6.0]
    out = list(DeviceFeed("cpu", depth=1)([2, 0], load,
                                          lambda h, put: put(h)))
    assert [float(t[0]) for t in out] == [2.0, 0.0]
    with pytest.raises(RuntimeError, match="bad chunk 7"):
        list(feed([1, 7, 2], load, lambda h, put: h))


_OUT_OF_CORE_WITHOUT_JAX = r"""
import os
import sys
import tempfile
for name in ("jax", "flax", "svbfm_tpu"):
    sys.modules[name] = None  # any import of them now raises
from svbfm_tpu_torch.data.binary import save_coo_binary
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.stream import BinaryChunkReader
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.sgd import SGDOnlineLearner
from svbfm_tpu_torch.learners.vb_online import OVBLearner
from svbfm_tpu_torch.learners.vb_windowed import WindowedVBLearner

coo = make_movielens_like(num_users=12, num_items=9, num_ratings=2500, seed=2)
tr, te = train_test_split(coo, 0.2, seed=3)
D = coo.num_features
meta = DataMetaInfo.from_field_offsets(D, [0, 12])
cfg = FMConfig(num_attributes=D, num_factor=2, num_groups=2, seed=7,
               min_target=1.0, max_target=5.0, num_batches=3)
test = SparseDataset.from_coo(te, D)
with tempfile.TemporaryDirectory() as d:
    save_coo_binary(os.path.join(d, "tr"), tr)
    reader = BinaryChunkReader(os.path.join(d, "tr.x"), os.path.join(d, "tr.y"))
    runs = [OVBLearner.from_reader(cfg, reader, test, meta, device="cpu",
                                   write_files=False),
            SGDOnlineLearner.from_reader(cfg, reader, test, meta,
                                         device="cpu", write_files=False),
            WindowedVBLearner(cfg, reader, test, meta, device="cpu",
                              num_windows=2, write_files=False)]
    hists = [r.run(num_iter=1, verbose=False)[1] for r in runs]
loaded = [m for m, v in sys.modules.items() if v is not None and
          m.split(".")[0] in ("jax", "flax", "svbfm_tpu")]
assert not loaded, loaded
print("out of core", len(hists), runs[2].num_windows)
"""


def test_out_of_core_runs_without_jax():
    """The new modules (binary IO, the chunk reader, the feed, the streamed
    and windowed learners) import and run with JAX and svbfm_tpu
    blocked."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _OUT_OF_CORE_WITHOUT_JAX],
                       cwd=repo, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "out of core 3 2" in r.stdout


def test_plan_cache_round_trip(tmp_path):
    """SweepPlan.save/load, the streamed chunks' plan cache: every array
    (dtype, shape, values; an empty bin, columns of no entry) and scalar
    comes back, and the arrays can be written."""
    from svbfm_tpu_torch.data.dataset import SweepPlan

    s = _setup(tmp_path, num_batches=3)
    coo = s["treader"].read_rows(0, 40)
    plan = SweepPlan.build(coo, s["D"] + 3, bins="greedy",
                           col_count=np.arange(s["D"] + 3, dtype=np.int32))
    plan.blocks.append([])  # an empty bin
    path = str(tmp_path / "plan.bin")
    plan.save(path)
    back = SweepPlan.load(path)
    for k in ("num_bins", "num_features", "rows_per_shard",
              "conflict_free"):
        assert getattr(back, k) == getattr(plan, k), k
    for k in ("unobserved", "color"):
        a, b = getattr(back, k), getattr(plan, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert [len(b) for b in back.blocks] == [len(b) for b in plan.blocks]
    for got, want in zip(back.blocks, plan.blocks):
        for g, w in zip(got, want):
            for f in SweepPlan._FIELDS:
                a, b = getattr(g, f), getattr(w, f)
                assert a.dtype == b.dtype and a.shape == b.shape, f
                np.testing.assert_array_equal(a, b, err_msg=f)
                assert a.flags.writeable
    with pytest.raises(ValueError, match="not a saved SweepPlan"):
        (tmp_path / "bad.bin").write_bytes(b"0" * 32)
        SweepPlan.load(str(tmp_path / "bad.bin"))
