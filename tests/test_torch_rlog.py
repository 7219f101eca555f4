"""The RLog (``svbfm_tpu_torch/utils/rlog.py``) and its reference-parity
schemas (``utils/rlog_schema.py``) against ``svbfm_tpu``'s: for every
method, the port's learner registers the JAX learner's header and streams
one row an iteration, as many rows as the JAX learner; VB's and OVB's
rows from one injected state hold the JAX rows' values within
``test_vb.py``'s rtol 3e-3 (the time columns aside, and NaN where JAX
leaves NaN)."""

import dataclasses

import jax
import numpy as np
import pytest

from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu.utils.rlog import RLog as JRLog
from svbfm_tpu.utils.rlog_schema import register_for as jregister
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.utils.convert import ovb_state_from_jax, state_from_jax
from svbfm_tpu_torch.utils.rlog import RLog
from svbfm_tpu_torch.utils.rlog_schema import register_for

TIME_COLUMNS = ("time_pred", "time_learn", "time_learn2", "time_learn4")


def _data(task=0, seed=2):
    coo = make_movielens_like(num_users=12, num_items=9, num_ratings=400,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    if task == 1:
        thr = np.median(tr.target)
        for c in (tr, te):
            c.target = np.where(c.target > thr, 1.0, -1.0).astype(np.float32)
    return coo.num_features, tr, te


def _learners(method, task=0):
    """(JAX learner, port learner) of ``method`` on the same data/config."""
    D, tr, te = _data(task)
    va, te2 = train_test_split(te, 0.5, seed=4)
    kw = dict(num_attributes=D, num_factor=3, seed=7, task=task,
              min_target=float(tr.target.min()),
              max_target=float(tr.target.max()), regw=0.05, regv=0.05,
              num_batches=3, learn_rate=0.02, factor_block=1)
    jmeta = JMeta.from_field_offsets(D, [0, 12])
    tmeta = DataMetaInfo.from_field_offsets(D, [0, 12])
    jcfg = JConfig(num_groups=jmeta.num_attr_groups, **kw)
    tcfg = FMConfig(num_groups=tmeta.num_attr_groups, **kw)
    jd = [JDataset.from_coo(c, D) for c in (tr, te2, va)]
    td = [SparseDataset.from_coo(c, D) for c in (tr, te2, va)]
    jx = dict(mesh=make_mesh(1), write_files=False)
    tx = dict(device="cpu", write_files=False)
    if method in ("vb", "vb_online", "mcmc", "als", "sgd", "sgd_online",
                  "exp_sgd", "exp_sgd_stoc", "bpr"):
        mod, name = {
            "vb": ("vb", "VBLearner"), "vb_online": ("vb_online",
                                                     "OVBLearner"),
            "mcmc": ("mcmc", "MCMCLearner"), "als": ("mcmc", "ALSLearner"),
            "sgd": ("sgd", "SGDLearner"),
            "sgd_online": ("sgd", "SGDOnlineLearner"),
            "exp_sgd": ("exp_sgd", "ExpSGDLearner"),
            "exp_sgd_stoc": ("exp_sgd", "ExpSGDStocLearner"),
            "bpr": ("bpr", "BPRLearner")}[method]
        import importlib
        J = getattr(importlib.import_module(f"svbfm_tpu.learners.{mod}"),
                    name)
        T = getattr(importlib.import_module(
            f"svbfm_tpu_torch.learners.{mod}"), name)
        return (J(jcfg, jd[0], jd[1], jmeta, **jx),
                T(tcfg, td[0], td[1], tmeta, **tx))
    if method == "sgda":
        from svbfm_tpu.learners.sgd import SGDALearner as J
        from svbfm_tpu_torch.learners.sgd import SGDALearner as T
        return (J(jcfg, jd[0], jd[1], jd[2], jmeta, **jx),
                T(tcfg, td[0], td[1], td[2], tmeta, **tx))
    if method in ("vb_windowed", "mcmc_windowed"):
        if method == "vb_windowed":
            from svbfm_tpu.learners.vb_windowed import WindowedVBLearner as J
            from svbfm_tpu_torch.learners.vb_windowed import (
                WindowedVBLearner as T)
        else:
            from svbfm_tpu.learners.mcmc_windowed import (
                WindowedMCMCLearner as J)
            from svbfm_tpu_torch.learners.mcmc_windowed import (
                WindowedMCMCLearner as T)
        return (J(jcfg, jd[0], jd[1], jmeta, num_windows=2,
                  write_files=False),
                T(tcfg, td[0], td[1], tmeta, num_windows=2, **tx))
    assert method == "mcmc_bs"
    from test_torch_bs import _pair
    return tuple(_pair(False, factor_block=1))


def _rows(path):
    lines = path.read_text().splitlines()
    return lines[0].split("\t"), [ln.split("\t") for ln in lines[1:]]


METHODS = [("vb", 0), ("vb", 1), ("vb_online", 0), ("vb_online", 1),
           ("mcmc", 0), ("mcmc", 1), ("als", 0), ("sgd", 0),
           ("sgd_online", 0), ("sgda", 0), ("exp_sgd", 0),
           ("exp_sgd_stoc", 0), ("bpr", 0), ("vb_windowed", 0),
           ("mcmc_windowed", 0), ("mcmc_bs", 0)]


@pytest.mark.parametrize("method,task", METHODS,
                         ids=[f"{m}-{'rc'[t]}" for m, t in METHODS])
def test_header_and_rows_match_jax(method, task, tmp_path):
    """The JAX learner's column set and one row an iteration."""
    jl, tl = _learners(method, task)
    jlog = JRLog(str(tmp_path / "jax.tsv"))
    tlog = RLog(str(tmp_path / "torch.tsv"))
    jregister(jl, jlog)
    register_for(tl, tlog)
    assert tl.rlog is tlog
    jl.run(num_iter=2, verbose=False)
    tl.run(num_iter=2, verbose=False)
    jlog.close()
    tlog.close()
    jh, jrows = _rows(tmp_path / "jax.tsv")
    th, trows = _rows(tmp_path / "torch.tsv")
    assert th == jh
    assert len(trows) == len(jrows) == 2
    # the columns JAX fills, the port fills (and the other way round)
    for jr, tr_ in zip(jrows, trows):
        assert [v == "nan" for v in tr_] == [v == "nan" for v in jr], (
            [h for h, a, b in zip(th, tr_, jr) if (a == "nan") != (b == "nan")])


@pytest.mark.parametrize("method", ["vb", "vb_online"])
def test_rows_from_one_state_match_jax(method, tmp_path):
    """VB and OVB from the JAX learner's init: every column but the times
    within test_vb.py's rtol 3e-3."""
    jl, tl = _learners(method)
    js = jl.init_state()
    conv = state_from_jax if method == "vb" else ovb_state_from_jax
    ts = conv(jax.device_get(js), "cpu")
    jlog = JRLog(str(tmp_path / "jax.tsv"))
    tlog = RLog(str(tmp_path / "torch.tsv"))
    jregister(jl, jlog)
    register_for(tl, tlog)
    jl.run(js, num_iter=3, verbose=False)
    tl.run(ts, num_iter=3, verbose=False)
    jlog.close()
    tlog.close()
    jh, jrows = _rows(tmp_path / "jax.tsv")
    _, trows = _rows(tmp_path / "torch.tsv")
    keep = [i for i, h in enumerate(jh) if h not in TIME_COLUMNS]
    j = np.array([[float(r[i]) for i in keep] for r in jrows])
    t = np.array([[float(r[i]) for i in keep] for r in trows])
    np.testing.assert_allclose(t, j, rtol=3e-3, equal_nan=True)


def test_rlog_semantics_match_jax(tmp_path):
    """Defaults (NaN unless given), duplicate and unregistered fields, the
    header on init and a row a new_line, reset to the defaults."""
    out = []
    for cls, name in ((RLog, "t.tsv"), (JRLog, "j.tsv")):
        log = cls(str(tmp_path / name))
        log.add_field("a")
        log.add_field("b", 2.5)
        with pytest.raises(ValueError, match="duplicate"):
            log.add_field("a")
        log.init()
        log.log("a", 1.0)
        log.new_line()
        log.new_line()
        with pytest.raises(ValueError, match="not registered"):
            log.log("c", 1.0)
        assert log.has_field("b") and not log.has_field("c")
        log.close()
        out.append((tmp_path / name).read_text())
    assert out[0] == out[1] == "a\tb\n1.0\t2.5\nnan\t2.5\n"
    off = RLog(None)
    off.add_field("x")
    off.init()
    off.new_line()
    off.close()


def test_unattached_learner_streams_nothing(tmp_path):
    """Without register_for the learners carry no rlog and write none."""
    _, tl = _learners("vb")
    assert getattr(tl, "rlog", None) is None
    tl.run(num_iter=1, verbose=False)
    assert not any(p.suffix == ".tsv" for p in tmp_path.iterdir())


def test_stream_row_reads_the_ports_state_fields():
    """SGDA's columns come from the state (w, v as the table's views, the
    regularisation tensors), as the JAX schema reads them."""
    from svbfm_tpu_torch.utils import rlog_schema

    _, tl = _learners("sgda")
    state = tl.init_state()
    log = RLog(None)
    register_for(tl, log)
    rows = []
    log.new_line = lambda: rows.append(dict(log._value))
    rlog_schema.stream_row(tl, {"rmse": 1.0, "rmse_train": 0.5}, state)
    w = state.w.numpy().astype(np.float64)
    assert rows[0]["wmean"] == pytest.approx(w.mean())
    assert rows[0]["regw[0]"] == 0.0 and rows[0]["rmse_train"] == 0.5
    assert dataclasses.is_dataclass(state)
