"""The port's CLI (``python -m svbfm_tpu_torch.cli``) on tiny libFM text
files with ``-device cpu``: vb, vb_online and the SGD family (exp_sgd
included) run end to end (mcmc and als: tests/test_torch_mcmc.py), and so
does ``-relation``, natively for mcmc/als and as the materialised join for
vb; each writes what the JAX CLI writes, under the same names; every flag
or method the port does not run exits non-zero with a message that names
its ROADMAP item, and a flag the chosen method does not read is refused."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from svbfm_tpu.cli import main as jax_main
from svbfm_tpu_torch import cli
from svbfm_tpu_torch.data.libfm_text import save_libfm_text
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHOD_ARGS = {"vb": ["-method", "vb", "-factor_block", "1"],
               "vb_online": ["-method", "vb_online", "-batch", "3"]}


@pytest.fixture
def data(tmp_path):
    coo = make_movielens_like(num_users=30, num_items=20, num_ratings=600,
                              seed=1)
    tr, te = train_test_split(coo, 0.2, seed=2)
    save_libfm_text(str(tmp_path / "tr.libfm"), tr)
    save_libfm_text(str(tmp_path / "te.libfm"), te)
    tr_part, va = train_test_split(tr, 0.1, seed=3)
    save_libfm_text(str(tmp_path / "va.libfm"), va)
    return tmp_path, te, coo.num_features


def _args(d, method="vb", *extra, task="r"):
    return ["-task", task, "-train", str(d / "tr.libfm"), "-test",
            str(d / "te.libfm"), "-dim", "1,1,4", "-iter", "2",
            *METHOD_ARGS.get(method, ["-method", method]), *extra]


def _run_in(path, fn, argv, monkeypatch):
    path.mkdir()
    monkeypatch.chdir(path)
    assert fn(argv) == 0
    return sorted(os.listdir(path))


@pytest.mark.parametrize("method", ["vb", "vb_online"])
def test_cli_runs_and_writes_reference_files(data, method, monkeypatch,
                                             capsys):
    d, te, D = data
    names = _run_in(d / "torch", cli.main,
                    _args(d, method, "-device", "cpu", "-out", "pred.txt"),
                    monkeypatch)
    out = capsys.readouterr().out
    assert names == sorted(["v_file.txt", "pred.txt",
                            f"test_rmse_114_{method}",
                            f"free_energy_114_{method}"])
    assert out.count("#Iter=") == 2
    assert np.loadtxt("v_file.txt").shape == (4, D)
    pred = np.loadtxt("pred.txt")
    assert pred.shape == (te.num_rows,)
    assert ((pred >= 1.0) & (pred <= 5.0)).all()
    final = float(out.split("Final\tTest=")[1].split()[0])
    np.testing.assert_allclose(
        final, np.sqrt(np.mean((pred - te.target) ** 2)), rtol=1e-4)
    assert np.loadtxt(f"test_rmse_114_{method}").shape == (2,)
    # OVB writes the free energy of the first and last chunk of each epoch
    fe_rows = 4 if method == "vb_online" else 2
    assert np.loadtxt(f"free_energy_114_{method}").shape == (fe_rows,)


@pytest.mark.parametrize("method", ["vb", "vb_online"])
def test_file_names_match_jax_cli(data, method, monkeypatch, capsys):
    d, _, _ = data
    ours = _run_in(d / "torch", cli.main,
                   _args(d, method, "-device", "cpu", "-out", "pred.txt"),
                   monkeypatch)
    theirs = _run_in(d / "jax", jax_main, _args(d, method, "-out", "pred.txt"),
                     monkeypatch)
    assert ours == theirs
    for name in ours:
        assert (np.loadtxt(d / "torch" / name).shape
                == np.loadtxt(d / "jax" / name).shape), name


@pytest.mark.parametrize("extra,kw,message", [
    (["-relation", "rel"], dict(task="p"), "item 15"),
    # -cache_size runs mcmc (item 10 done); its -bins stays refused
    pytest.param(["-cache_size", "1000", "-bins", "fields"],
                 dict(method="mcmc"), "-bins is not read",
                 id="extra1-kw1-item 10"),
    # -checkpoint (item 12 done) stays refused where the JAX CLI refuses
    # it (-cache_size, svbfm_tpu/cli.py:388-389) and where the method
    # keeps no checkpoint (bpr)
    pytest.param(["-checkpoint", "ck", "-cache_size", "1000"],
                 dict(method="mcmc"), "-checkpoint is not supported with "
                 "-cache_size", id="extra2-kw2-item 12"),
    pytest.param(["-checkpoint", "ck"], dict(method="bpr"),
                 "-checkpoint is not read by -method bpr",
                 id="extra3-kw3-item 12"),
    # -feature_shards runs batch VB, online VB, Gibbs, ALS and SGD (item
    # 13's slices 13.1-13.3); the other methods still refuse it
    pytest.param(["-feature_shards", "2"], dict(method="sgd_online"),
                 "item 13", id="extra4-kw4-item 13"),
    pytest.param(["-num_eval_cases", "5", "-cache_size", "1000"], {},
                 "not supported with -cache_size", id="extra5-kw5-item 4"),
    (["-learn_rate", "0.1"], {}, "not read"),
    (["-bogus", "1"], {}, "unknown parameter"),
    ([], dict(task="p"), "item 15"),
    (["-factor_jacobi", "1"], dict(method="exp_sgd"),
     "not read by -method exp_sgd"),
    (["-validation", "va.libfm"], {}, "only by sgda"),
    ([], dict(method="sgda"), "mandatory for SGDA"),
    (["-stdev", "2"], dict(method="sgd"), "only by exp_sgd, exp_sgd_stoc"),
    (["-bpr_neg_field", "0"], dict(method="sgd"), "only by bpr"),
    (["-learn_rate", "0.1,0.2"], dict(method="sgd"), "1 or 3 values"),
    (["-regular", "0.1"], dict(method="sgda"), "not read by -method sgda"),
    ([], dict(method="nonsense"), "unknown method"),
    (["-relation", "rel", "-factor_jacobi", "1"], dict(method="als"),
     "not read by the block-structure sampler"),
])
def test_refused_flags_and_methods(data, extra, kw, message):
    d, _, _ = data
    argv = _args(d, kw.get("method", "vb"), "-device", "cpu", *extra,
                 task=kw.get("task", "r"))
    with pytest.raises(SystemExit) as ei:
        cli.main(argv)
    assert message in str(ei.value.code)


def test_binary_input_refused(data, monkeypatch, capsys):
    """The reference's binary .x/.y beside a file's name is read in place
    of its text, as the JAX CLI reads it: here the text is not libFM at
    all, and the run takes the binary."""
    from svbfm_tpu_torch.data.binary import save_coo_binary
    from svbfm_tpu_torch.data.libfm_text import load_libfm_text

    d, te, _ = data
    save_coo_binary(str(d / "tr.libfm"), load_libfm_text(str(d / "tr.libfm")))
    (d / "tr.libfm").write_text("not libFM text\n")
    _run_in(d / "torch", cli.main,
            _args(d, "vb", "-device", "cpu", "-out", "pred.txt"), monkeypatch)
    assert "Final\tTest=" in capsys.readouterr().out
    assert np.loadtxt(d / "torch" / "pred.txt").shape == (te.num_rows,)


def test_device_cuda_without_gpu_refused(data):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: -device cuda runs")
    d, _, _ = data
    with pytest.raises(SystemExit) as ei:
        cli.main(_args(d, "vb_online"))  # -device defaults to cuda
    assert "does not fall back" in str(ei.value.code)


def test_module_exit_codes(data):
    """Through the interpreter: a refusal exits non-zero, -help exits 0."""
    d, _, _ = data
    env = dict(os.environ, PYTHONPATH=REPO)
    run = [sys.executable, "-m", "svbfm_tpu_torch.cli"]
    r = subprocess.run(run + _args(d, "mcmc", "-cache_size", "10",
                                   "-num_eval_cases", "5", "-device", "cpu"),
                       cwd=d, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and "not supported with -cache_size" in r.stderr
    r = subprocess.run(run + ["-help"], cwd=d, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "-device" in r.stdout


SGD_ARGS = {
    "sgd": ["-learn_rate", "0.05", "-regular", "0,0.01,0.01"],
    "sgd_online": ["-learn_rate", "0.05", "-batch", "3"],
    "sgda": ["-learn_rate", "0.05", "-validation", "va.libfm"],
    "exp_sgd": ["-learn_rate", "0.5", "-stdev", "1.5", "-regular", "0.01"],
    "exp_sgd_stoc": ["-learn_rate", "0.02", "-stdev", "1.5"],
    "bpr": ["-learn_rate", "0.05", "-batch", "4", "-bpr_neg_field", "-1"],
}


@pytest.mark.parametrize("method", list(SGD_ARGS))
def test_cli_sgd_family_writes_the_jax_cli_files(data, method, monkeypatch,
                                                 capsys):
    """-method sgd|sgd_online|sgda|exp_sgd|exp_sgd_stoc|bpr at -device cpu: the
    JAX CLI's file names and shapes, 2 trajectory lines, the Final line
    (the clipped test predictions' RMSE) and -out."""
    d, te, D = data
    extra = [a if a != "va.libfm" else str(d / "va.libfm")
             for a in SGD_ARGS[method]]
    ours = _run_in(d / "torch", cli.main,
                   _args(d, method, *extra, "-device", "cpu", "-out",
                         "pred.txt"), monkeypatch)
    out = capsys.readouterr().out
    theirs = _run_in(d / "jax", jax_main,
                     _args(d, method, *extra, "-out", "pred.txt"),
                     monkeypatch)
    assert ours == theirs == sorted(["v_file.txt", "pred.txt",
                                     f"test_rmse_114_{method}"])
    for name in ours:
        assert (np.loadtxt(d / "torch" / name).shape
                == np.loadtxt(d / "jax" / name).shape), name
    assert np.loadtxt(d / "torch" / "v_file.txt").shape == (4, D)
    traj = np.loadtxt(d / "torch" / f"test_rmse_114_{method}")
    assert traj.shape == (2,) and np.isfinite(traj).all()
    pred = np.loadtxt(d / "torch" / "pred.txt")
    final = float(out.split("Final\tTest=")[1].split()[0])
    np.testing.assert_allclose(
        final, np.sqrt(np.mean((pred - te.target) ** 2)), rtol=1e-4)
    if method == "sgda":
        assert "Train=" in out
    if method == "bpr":
        assert "PairAcc=" in out


@pytest.fixture
def rel_data(tmp_path):
    """A main block of user one-hots and an item relation (one-hot + two
    attribute slots, with groups) joined through items.train/items.test."""
    return _write_rel_data(tmp_path)


def _write_rel_data(tmp_path):
    """``rel_data``'s files in ``tmp_path``: (tmp_path, joined D)."""
    rng = np.random.default_rng(5)
    n_users, n_items = 12, 8
    for split, n in (("tr", 300), ("te", 60)):
        users = rng.integers(0, n_users, n)
        items = rng.integers(0, n_items, n)
        y = np.clip(np.round(3 + 0.1 * users - 0.2 * items
                             + rng.standard_normal(n)), 1, 5)
        (tmp_path / f"{split}.libfm").write_text("".join(
            f"{t:g} {u}:1\n" for t, u in zip(y, users)))
        (tmp_path / f"items.{'train' if split == 'tr' else 'test'}"
         ).write_text("".join(f"{i}\n" for i in items))
    (tmp_path / "items").write_text("".join(
        f"0 {i}:1 {n_items + i % 2}:0.5 {n_items + 2 + i % 2}:1.5\n"
        for i in range(n_items)))
    (tmp_path / "items.groups").write_text(
        "".join("0\n" for _ in range(n_items)) + "1\n1\n2\n2\n")
    return tmp_path, n_users + n_items + 4


@pytest.mark.parametrize("method", ["mcmc", "als", "vb"])
def test_cli_relation_runs_like_the_jax_cli(rel_data, method, monkeypatch,
                                            capsys):
    """-relation: native block structure for mcmc/als, the materialised
    join for vb; the JAX CLI's file names and shapes, v_file over the
    joined attributes, finite trajectories and the Final line."""
    d, D = rel_data
    args = ["-task", "r", "-train", str(d / "tr.libfm"), "-test",
            str(d / "te.libfm"), "-dim", "1,1,3", "-iter", "3", "-method",
            method, "-relation", str(d / "items"), "-out", "pred.txt"]
    if method != "vb":
        args += ["-regular", "0.1"]
    ours = _run_in(d / "torch", cli.main, args + ["-device", "cpu"],
                   monkeypatch)
    out = capsys.readouterr().out
    theirs = _run_in(d / "jax", jax_main, args, monkeypatch)
    assert ours == theirs
    for name in ours:
        assert (np.loadtxt(d / "torch" / name).shape
                == np.loadtxt(d / "jax" / name).shape), name
    assert np.loadtxt(d / "torch" / "v_file.txt").shape == (3, D)
    # the reference rewrites als to mcmc before it names the file
    traj = np.loadtxt(d / "torch" / ("test_rmse_113_"
                                     + ("vb" if method == "vb" else "mcmc")))
    assert traj.shape == (3,) and np.isfinite(traj).all()
    pred = np.loadtxt(d / "torch" / "pred.txt")
    assert pred.shape == (60,) and ((pred >= 1) & (pred <= 5)).all()
    assert "Final\tTest=" in out


def _start_from_jax_inits(monkeypatch):
    """The port's learners start, as the JAX CLI's do, from the JAX init
    of the same config (and Gibbs and SGD with the JAX key chain
    replayed), and the JAX CLI's learners run on a one-device mesh, as the
    port does (shards fold their index into their draws), so that the two
    CLIs run the same computation."""
    import dataclasses

    import jax

    from svbfm_tpu.learners import mcmc as jm
    from svbfm_tpu.learners import sgd as js
    from svbfm_tpu.parallel import mesh as jmesh

    from svbfm_tpu.learners import vb as jvb
    from svbfm_tpu.learners import vb_online as jov
    from svbfm_tpu.learners.base import FMConfig as JConfig
    from svbfm_tpu.models.fm import init_fm_params as jinit
    from svbfm_tpu_torch.learners import mcmc as tm
    from svbfm_tpu_torch.learners import sgd as ts
    from svbfm_tpu_torch.learners import vb as tvb
    from svbfm_tpu_torch.learners import vb_online as tov
    from svbfm_tpu_torch.utils.convert import ovb_state_from_jax
    from test_torch_mcmc import JaxKeyDraws
    from test_torch_sgd import JaxSGDKeys

    def jcfg(cfg):
        return JConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def vb_init(self, generator=None):
        p = jvb.init_vb_params(jax.random.PRNGKey(self.cfg.seed),
                               jcfg(self.cfg))
        return self.state_from_params({k: t(v) for k, v in p.items()})

    def ovb_init(self, generator=None):
        return ovb_state_from_jax(jax.device_get(jov.init_ovb_state(
            jax.random.PRNGKey(self.cfg.seed), jcfg(self.cfg),
            self.col_count)), "cpu")

    def fm_init(draws_cls, normal_w):
        def init(self, generator=None, draws=None):
            key, kinit = jax.random.split(jax.random.PRNGKey(self.cfg.seed))
            p = jinit(kinit, self.cfg.num_attributes, self.cfg.num_factor,
                      init_stdev=self.cfg.init_stdev,
                      **(dict(init_w_normal=True) if normal_w else {}))
            return self.state_from_params(t(p.w0), t(p.w), t(p.v),
                                          draws_cls(key))
        return init

    for mod in (jvb, jov, jm, js):
        monkeypatch.setattr(mod, "make_mesh",
                            lambda *a, **k: jmesh.make_mesh(1))
    monkeypatch.setattr(tvb.VBLearner, "init_state", vb_init)
    monkeypatch.setattr(tov.OVBLearner, "init_state", ovb_init)
    monkeypatch.setattr(tm.MCMCLearner, "init_state",
                        fm_init(JaxKeyDraws, True))
    monkeypatch.setattr(ts.SGDLearner, "init_state",
                        fm_init(JaxSGDKeys, False))


@pytest.mark.parametrize("method,task", [
    ("vb", "c"), ("mcmc", "c"), ("als", "c"), ("vb_online", "c"),
    ("sgd", "c"), ("sgd", "p")])
def test_cli_tasks_match_the_jax_cli(data, method, task, monkeypatch, capsys):
    """-task c (the targets binarised at 0, min/max = -1/1; here the stars
    less 3.5) and -task p (the stars above 3, a count of 0-2): exit 0, the
    JAX CLI's files, -out probabilities in [0, 1] (Phi for vb and
    vb_online, the posterior mean of Phi for mcmc, Phi of the last scores
    for als, the sigmoid for sgd) equal to the JAX CLI's on the same
    files, and the Final line the accuracy of -out."""
    d, _, _ = data
    coo = make_movielens_like(num_users=30, num_items=20, num_ratings=600,
                              seed=1)
    coo.target = (coo.target - 3.5 if task == "c"
                  else np.maximum(coo.target - 3.0, 0.0)).astype(np.float32)
    tr, te = train_test_split(coo, 0.2, seed=2)
    save_libfm_text(str(d / "tr.libfm"), tr)
    save_libfm_text(str(d / "te.libfm"), te)
    assert (te.target > 0).any() and (te.target <= 0).any()
    _start_from_jax_inits(monkeypatch)
    extra = (["-learn_rate", "0.05", "-regular", "0,0.01,0.01"]
             if method == "sgd" else ["-regular", "0.1"]
             if method in ("mcmc", "als") else [])
    argv = _args(d, method, *extra, "-out", "pred.txt", task=task)
    ours = _run_in(d / "torch", cli.main, argv + ["-device", "cpu"],
                   monkeypatch)
    out = capsys.readouterr().out
    theirs = _run_in(d / "jax", jax_main, argv, monkeypatch)
    jout = capsys.readouterr().out
    assert ours == theirs
    pred = np.loadtxt(d / "torch" / "pred.txt")
    assert pred.shape == (te.num_rows,)
    assert ((pred >= 0) & (pred <= 1)).all()
    np.testing.assert_allclose(pred, np.loadtxt(d / "jax" / "pred.txt"),
                               rtol=1e-4, atol=1e-6)
    final = float(out.split("Final\tTest=")[1].split()[0])
    assert final == float(jout.split("Final\tTest=")[1].split()[0])
    np.testing.assert_allclose(
        final, np.mean((pred >= 0.5) == (te.target > 0)), atol=1e-6)


# ---- binary input, streaming and -cache_size ------------------------------

BINARY_ARGS = dict(SGD_ARGS, mcmc=["-regular", "0.1"],
                   als=["-regular", "0.1"], vb=[], vb_online=[])


def _binary_files(d, tr_name="tr.libfm", te_name="te.libfm"):
    """The data fixture's train and test files also as binary .x/.y, with
    the text's feature count (max id + 1), so that both forms load the
    same arrays."""
    from svbfm_tpu_torch.data.binary import save_coo_binary
    from svbfm_tpu_torch.data.libfm_text import load_libfm_text

    for name in (tr_name, te_name):
        save_coo_binary(str(d / name), load_libfm_text(str(d / name)))


@pytest.mark.parametrize("method", ["mcmc", "als", "vb", "vb_online", "sgd",
                                    "sgd_online", "sgda", "exp_sgd",
                                    "exp_sgd_stoc", "bpr"])
def test_cli_binary_input_matches_text(data, method, monkeypatch, capsys):
    """Every method on binary train and test files gives what it gives on
    the same data as libFM text, bit for bit (vb_online and sgd_online
    here read the train text and the test binary: with a binary train file
    they stream it, test_cli_streams_binary_train_like_the_jax_cli)."""
    d, te, _ = data
    extra = [a if a != "va.libfm" else str(d / "va.libfm")
             for a in BINARY_ARGS[method]]
    argv = _args(d, method, *extra, "-device", "cpu", "-out", "pred.txt")
    _run_in(d / "text", cli.main, argv, monkeypatch)
    text_out = capsys.readouterr().out
    _binary_files(d, te_name="te.libfm")
    if method in ("vb_online", "sgd_online"):
        for ext in (".x", ".y"):
            os.remove(d / f"tr.libfm{ext}")
    else:  # the text must not be read
        (d / "tr.libfm").rename(d / "tr.text")
        (d / "tr.libfm").write_text("not libFM text\n")
    (d / "te.libfm").write_text("not libFM text\n")
    _run_in(d / "binary", cli.main, argv, monkeypatch)
    bin_out = capsys.readouterr().out
    np.testing.assert_array_equal(np.loadtxt(d / "binary" / "pred.txt"),
                                  np.loadtxt(d / "text" / "pred.txt"))
    assert (bin_out.split("Final\tTest=")[1].split()[0]
            == text_out.split("Final\tTest=")[1].split()[0])


@pytest.mark.parametrize("method,extra", [
    ("vb_online", []), ("sgd_online", ["-learn_rate", "0.05", "-batch", "3"]),
    ("vb", ["-cache_size", "4000"]),
    ("vb_online", ["-task", "c"])])
def test_cli_streams_binary_train_like_the_jax_cli(data, method, extra,
                                                   monkeypatch, capsys):
    """vb_online, sgd_online and -method vb -cache_size with a binary train
    file: the file streams from disk (the port never loads it whole) and
    the -out predictions equal the JAX CLI's on the same files, both from
    the JAX init."""
    from svbfm_tpu_torch.data import binary as tbin
    from svbfm_tpu_torch.learners import vb_windowed as tvw

    d, te, _ = data
    _binary_files(d)
    _start_from_jax_inits(monkeypatch)
    from svbfm_tpu_torch.learners import vb as tvb
    monkeypatch.setattr(tvw.WindowedVBLearner, "init_state",
                        tvb.VBLearner.init_state)
    loaded = []
    real = tbin.load_coo_binary
    monkeypatch.setattr(tbin, "load_coo_binary",
                        lambda p: loaded.append(p) or real(p))
    task = "r"
    if "-task" in extra:
        task, extra = extra[1], extra[2:]
    argv = _args(d, method, *extra, "-out", "pred.txt", task=task)
    _run_in(d / "torch", cli.main, argv + ["-device", "cpu"], monkeypatch)
    out = capsys.readouterr().out
    assert loaded == [str(d / "te.libfm")]  # the train file streamed
    _run_in(d / "jax", jax_main, argv, monkeypatch)
    jout = capsys.readouterr().out
    np.testing.assert_allclose(np.loadtxt(d / "torch" / "pred.txt"),
                               np.loadtxt(d / "jax" / "pred.txt"),
                               rtol=1e-4, atol=1e-6)
    for o in (out, jout):
        assert "Final\tTest=" in o


def test_cli_cache_size_vb_runs_windowed(data, monkeypatch, capsys):
    """-method vb -cache_size on text input: the windowed learner over the
    in-memory rows, as the JAX CLI, at the -factor_block given (it divides
    K = 4)."""
    from svbfm_tpu_torch.learners import vb_windowed as tvw

    d, te, _ = data
    made = []
    real_init = tvw.WindowedVBLearner.__init__

    def spy(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)
    monkeypatch.setattr(tvw.WindowedVBLearner, "__init__", spy)
    _run_in(d / "torch", cli.main,
            _args(d, "vb", "-cache_size", "1000", "-device", "cpu"),
            monkeypatch)
    assert len(made) == 1 and made[0].cfg.factor_block == 1
    assert "Final\tTest=" in capsys.readouterr().out


@pytest.mark.parametrize("method,extra,message", [
    ("mcmc", ["-cache_size", "1000", "-do_sampling", "0", "-factor_jacobi",
              "1"], "windowed Gibbs/ALS"),
    pytest.param("als", ["-cache_size", "1000", "-num_eval_cases", "5"],
                 "-num_eval_cases is not supported with -cache_size",
                 id="als-extra1-item 10"),
    ("vb", ["-cache_size", "1000", "-num_eval_cases", "5"],
     "-num_eval_cases is not supported with -cache_size"),
    ("sgd", ["-cache_size", "1000"], "not read by -method sgd"),
    # -feature_shards runs vb_online (item 13.2): on one rank its two
    # shards do not divide the world
    pytest.param("vb_online", ["-feature_shards", "2"],
                 "does not divide the world size 1",
                 id="vb_online-extra4-item 13"),
    ("vb", ["-cache_size", "1000", "-bins", "greedy"], "-bins is not read"),
])
def test_cli_out_of_core_refusals(data, method, extra, message):
    """The JAX CLI's refusals are kept with -cache_size, for vb, mcmc
    and als, and -factor_jacobi is refused there (the windowed Gibbs/ALS
    draws exactly)."""
    d, _, _ = data
    with pytest.raises(SystemExit) as ei:
        cli.main(_args(d, method, *extra, "-device", "cpu"))
    assert message in str(ei.value.code)


@pytest.mark.parametrize("method", ["sgd"])
def test_coordinator_refused_outside_tp_methods(data, method, tmp_path,
                                                monkeypatch):
    """With SVBFM_COORDINATOR set, a method that does not run across ranks
    yet is refused before any group is joined, and no rank runs its own
    copy of the learner."""
    import torch.distributed as dist

    d, _, _ = data
    monkeypatch.setenv("SVBFM_COORDINATOR", f"file://{tmp_path / 'store'}")
    monkeypatch.setenv("SVBFM_NUM_PROCESSES", "2")
    monkeypatch.setenv("SVBFM_PROCESS_ID", "0")
    with pytest.raises(SystemExit) as ei:
        cli.main(_args(d, method, "-device", "cpu"))
    assert "item 13.4" in str(ei.value.code)
    assert not dist.is_initialized()


def _both(d, argv_of, monkeypatch, capsys, sub=""):
    """Run both CLIs, each in its own directory (d/torch<sub>,
    d/jax<sub>); returns {"torch": (dir, stdout), "jax": (dir, stdout)}."""
    out = {}
    for name, fn, extra in (("torch", cli.main, ["-device", "cpu"]),
                            ("jax", jax_main, [])):
        path = d / f"{name}{sub}"
        path.mkdir(exist_ok=True)
        monkeypatch.chdir(path)
        assert fn(argv_of(path) + extra) == 0
        out[name] = (path, capsys.readouterr().out)
    return out


@pytest.mark.parametrize("method", ["vb", "mcmc", "vb_online", "sgda"])
def test_cli_rlog_like_the_jax_cli(data, method, monkeypatch, capsys):
    """-rlog: the JAX CLI's header and one row an iteration."""
    d, _, _ = data
    extra = (["-validation", str(d / "va.libfm"), "-learn_rate", "0.05"]
             if method == "sgda" else [])
    res = _both(d, lambda p: _args(d, method, *extra, "-rlog",
                                   str(p / "log.tsv")), monkeypatch, capsys)
    heads = {}
    for name, (path, _) in res.items():
        lines = (path / "log.tsv").read_text().splitlines()
        heads[name] = lines[0]
        assert len(lines) == 3, name  # header + 2 iterations
    assert heads["torch"] == heads["jax"]


@pytest.mark.parametrize("method", ["vb", "mcmc", "vb_online", "sgd"])
def test_cli_checkpoint_then_resume_like_the_jax_cli(data, method,
                                                     monkeypatch, capsys):
    """-checkpoint: a 2-iteration run saves, a 4-iteration run on the same
    directory resumes at iteration 2 and runs 2 more; both CLIs keep the
    same newest checkpoint and print the same #Iter lines.  (Which other
    iterations leave a file depends on each learner's chunk of sweeps a
    metrics fetch, which the two packages size differently.)"""
    d, _, _ = data
    res = {}
    for it in ("2", "4"):
        res[it] = _both(d, lambda p, it=it: [
            a if a != "2" else it for a in _args(
                d, method, "-checkpoint", str(p / "ck"),
                "-checkpoint_every", "1")], monkeypatch, capsys)
    for name in ("torch", "jax"):
        path, out = res["4"][name]
        iters = [ln for ln in out.splitlines() if ln.startswith("#Iter=")]
        assert [int(ln.split("=")[1].split()[0]) for ln in iters] == [2, 3]
        files = sorted(os.listdir(path / "ck"))
        assert "ckpt_2.npz" in files and files[-1] == "ckpt_4.npz", name


def test_cli_profile_writes_a_trace(data, monkeypatch, capsys):
    """-profile: both CLIs run under their profilers; the port's writes a
    Chrome trace of the run."""
    import json
    d, _, _ = data
    res = _both(d, lambda p: _args(d, "vb", "-profile", str(p / "prof")),
                monkeypatch, capsys)
    for name, (path, out) in res.items():
        assert "Final\tTest=" in out and os.listdir(path / "prof"), name
    with open(res["torch"][0] / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_cli_map_eval_like_the_jax_cli(data, monkeypatch, capsys):
    """-map_eval with vb_online -task c: MAP@5 on every #Iter line and the
    final MAP@5 line in both CLIs."""
    d, te, _ = data
    order = np.lexsort((te.col, te.row))
    col = te.col[order].reshape(-1, 2)
    fix = d / "fix.txt"
    fix.write_text("".join(f"{int(y > 3)} {u}:1 {i}:1\n" for u, i, y in
                           zip(col.min(1), col.max(1), te.target)))
    res = _both(d, lambda p: _args(d, "vb_online", "-map_eval", str(fix),
                                   "-map_k", "5", task="c"),
                monkeypatch, capsys)
    for name, (_, out) in res.items():
        lines = out.splitlines()
        assert sum("MAP@5= " in ln for ln in lines) == 2, name
        assert sum(ln.startswith("MAP@5\t") for ln in lines) == 1, name


def test_cli_feature_shards_like_the_jax_cli(data, tmp_path, monkeypatch,
                                             capsys):
    """-feature_shards 2 -distributed 1 on two spawned gloo ranks (a (1, 2)
    mesh) beside the JAX CLI's -feature_shards 2 on the 8-device mesh (a
    (4, 2) mesh), both from the JAX init: the same files (rank 0 writes
    them, the RLog's header and rows among them), the trajectories within
    test_tp.py's rtol 1e-4."""
    from svbfm_tpu.parallel import tp_vb as jtp
    from torch_tp_ranks import cli_rank, run_ranks

    d, _, D = data
    argv = _args(d, "vb", "-feature_shards", "2", "-out", "pred.txt",
                 "-rlog", "log.tsv")
    argv = [a for a in argv if a not in ("-factor_block", "1")]
    seen = {}
    init = jtp.TPVBLearner.init_state

    def keep_init(self, key=None):
        seen["state"] = init(self, key)
        return seen["state"]

    monkeypatch.setattr(jtp.TPVBLearner, "init_state", keep_init)
    theirs = _run_in(d / "jax", jax_main, argv, monkeypatch)
    st = seen["state"]
    params = {k: np.asarray(getattr(st, k))[..., :D] if k in (
        "mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash")
        else np.asarray(getattr(st, k)) for k in (
        "mu_0", "sigma_0_dash", "mu_w", "sigma_w_dash", "mu_v",
        "sigma_v_dash", "alpha", "sigma_0", "sigma_w", "sigma_v")}
    np.savez(tmp_path / "init.npz", **params)
    (d / "torch").mkdir()
    run_ranks(cli_rank, 2, tmp_path / "ranks", timeout=120,
              argv=argv + ["-distributed", "1", "-device", "cpu"],
              cwd=str(d / "torch"), init=str(tmp_path / "init.npz"))
    ours = sorted(os.listdir(d / "torch"))
    assert ours == theirs
    for name in ("test_rmse_114_vb", "free_energy_114_vb", "pred.txt"):
        np.testing.assert_allclose(np.loadtxt(d / "torch" / name),
                                   np.loadtxt(d / "jax" / name), rtol=1e-4,
                                   err_msg=name)
    # the RLog: rank 0's header and a row an iteration, as the JAX CLI's
    ours_log = (d / "torch" / "log.tsv").read_text().splitlines()
    theirs_log = (d / "jax" / "log.tsv").read_text().splitlines()
    assert ours_log[0] == theirs_log[0]
    assert len(ours_log) == len(theirs_log) == 3


@pytest.mark.parametrize("method", ["vb", "als", "mcmc", "vb_online",
                                    "vb_online_binary", "als_relation",
                                    "mcmc_relation"])
def test_cli_data_parallel_like_the_jax_cli(data, tmp_path, monkeypatch,
                                            capsys, method):
    """-method vb (-factor_block 1), vb_online (-batch 3; in memory, and
    streamed from a binary train file), als or mcmc (also with -relation:
    block structure) with -distributed 1 and no -feature_shards on two
    spawned gloo ranks (the replicated learner on a data mesh of the two)
    beside the JAX CLI on its 8-device data mesh, both from the JAX init
    (Gibbs replaying the JAX key chain): the same files (rank 0 writes
    them) and the trajectories, the predictions and v_file.txt within rtol
    1e-4, -num_eval_cases (not with -relation, which the JAX CLI does not
    pass it) and -rlog read."""
    from svbfm_tpu.learners import mcmc as jm
    from svbfm_tpu.learners import mcmc_bs as jbs
    from svbfm_tpu.learners import vb as jv
    from svbfm_tpu.learners import vb_online as jov
    from torch_tp_ranks import cli_dp_rank, run_ranks

    d, _, _ = data
    method, _, form = method.partition("_")
    if method == "vb" and form:  # vb_online, vb_online_binary
        method, form = "vb_online", form.partition("_")[2]
    if form == "binary":
        _binary_files(d)
    if form == "relation":
        (tmp_path / "rel").mkdir()
        d, _ = _write_rel_data(tmp_path / "rel")
        argv = ["-task", "r", "-train", str(d / "tr.libfm"), "-test",
                str(d / "te.libfm"), "-dim", "1,1,3", "-iter", "2",
                "-method", method, "-relation", str(d / "items")]
    else:
        argv = _args(d, method, "-num_eval_cases", "100")
    argv += ["-out", "pred.txt", "-rlog", "log.tsv", *(
        ["-regular", "0.1"] if method in ("als", "mcmc") else [])]
    import jax

    cls = {"vb": jv.VBLearner, "vb_online": jov.OVBLearner}.get(
        method, jbs.MCMCBSLearner if form == "relation" else jm.MCMCLearner)
    seen = {}
    init = cls.init_state

    def keep_init(self, key=None):  # a host copy: the VB run donates it
        s = init(self, key)
        seen["state"] = jax.device_get(s)
        return s

    monkeypatch.setattr(cls, "init_state", keep_init)
    theirs = _run_in(d / "jax", jax_main, argv, monkeypatch)
    st = seen["state"]
    from svbfm_tpu_torch.learners.vb import PARAM_FIELDS
    from torch_tp_ranks import OVB_FIELDS
    names = {"vb": PARAM_FIELDS, "vb_online": OVB_FIELDS}.get(
        method, ("w0", "w", "v", "key"))
    np.savez(tmp_path / "init.npz",
             **{k: np.asarray(getattr(st, k)) for k in names})
    (d / "torch").mkdir()
    run_ranks(cli_dp_rank, 2, tmp_path / "ranks", timeout=120,
              argv=argv + ["-distributed", "1", "-device", "cpu"],
              cwd=str(d / "torch"), init=str(tmp_path / "init.npz"))
    assert sorted(os.listdir(d / "torch")) == theirs
    tag = "mcmc" if method in ("als", "mcmc") else method
    dim = "113" if form == "relation" else "114"
    for name in (f"test_rmse_{dim}_{tag}", "pred.txt", "v_file.txt") + (
            (f"free_energy_{dim}_{tag}",) if tag != "mcmc" else ()):
        np.testing.assert_allclose(np.loadtxt(d / "torch" / name),
                                   np.loadtxt(d / "jax" / name), rtol=1e-4,
                                   err_msg=name)
    ours_log = (d / "torch" / "log.tsv").read_text().splitlines()
    theirs_log = (d / "jax" / "log.tsv").read_text().splitlines()
    assert ours_log[0] == theirs_log[0]
    assert len(ours_log) == len(theirs_log) == 3


@pytest.mark.parametrize("method", ["als", "mcmc"])
def test_cli_feature_shards_mcmc_als(data, tmp_path, monkeypatch, capsys,
                                     method):
    """-method als|mcmc -feature_shards 2 -distributed 1 on two spawned
    gloo ranks (a (1, 2) mesh) beside the JAX CLI's -feature_shards 2 on
    the 8-device mesh (a (4, 2) mesh), both from the JAX init: the same
    files (rank 0 writes them); ALS's trajectory and predictions within
    test_tp_mcmc.py's rtol 2e-4, Gibbs (its own draws) finite and its
    posterior-mean predictions in the target range."""
    from svbfm_tpu.parallel import tp_mcmc as jtm
    from torch_tp_ranks import cli_mcmc_rank, run_ranks

    d, te, D = data
    argv = _args(d, method, "-feature_shards", "2", "-out", "pred.txt",
                 "-regular", "0.1")
    seen = {}
    init = jtm.TPMCMCLearner.init_state

    def keep_init(self, key=None):
        seen["state"] = init(self, key)
        return seen["state"]

    monkeypatch.setattr(jtm.TPMCMCLearner, "init_state", keep_init)
    theirs = _run_in(d / "jax", jax_main, argv, monkeypatch)
    st = seen["state"]
    np.savez(tmp_path / "init.npz", w0=np.asarray(st.w0),
             w=np.asarray(st.w)[:D], v=np.asarray(st.v)[:, :D])
    (d / "torch").mkdir()
    run_ranks(cli_mcmc_rank, 2, tmp_path / "ranks", timeout=120,
              argv=argv + ["-distributed", "1", "-device", "cpu"],
              cwd=str(d / "torch"), init=str(tmp_path / "init.npz"))
    assert sorted(os.listdir(d / "torch")) == theirs
    ours = {n: np.loadtxt(d / "torch" / n)
            for n in ("test_rmse_114_mcmc", "pred.txt", "v_file.txt")}
    np.testing.assert_allclose(ours["v_file.txt"],
                               np.loadtxt(d / "jax" / "v_file.txt"),
                               rtol=1e-6)
    if method == "als":
        for name in ("test_rmse_114_mcmc", "pred.txt"):
            np.testing.assert_allclose(ours[name],
                                       np.loadtxt(d / "jax" / name),
                                       rtol=2e-4, err_msg=name)
    else:
        assert np.isfinite(ours["test_rmse_114_mcmc"]).all()
        assert ours["pred.txt"].shape == (te.num_rows,)
        assert ((ours["pred.txt"] >= 1.0) & (ours["pred.txt"] <= 5.0)).all()


@pytest.mark.parametrize("method,extra,message", [
    ("mcmc", ["-cache_size", "1000"], "not read by the feature-sharded"),
    ("als", ["-num_eval_cases", "5"], "not read by the feature-sharded"),
    ("mcmc", ["-map_eval", "fixture"], "not read by the feature-sharded"),
    ("vb", [], "-factor_block is not read by the feature-sharded VB"),
    ("mcmc", ["-factor_block", "2"], "does not divide the world size 1"),
    ("als", ["-task", "c"], "does not divide the world size 1"),
    ("vb_online", ["-task", "c"], "feature-sharded OVB runs -task r alone"),
    ("vb_online", ["-factor_block", "2"],
     "-factor_block is read by the feature-sharded OVB as 0 or 1"),
    ("vb_online", ["-reshuffle", "1"],
     "-reshuffle is not read by the feature-sharded OVB"),
    ("vb_online", ["-checkpoint", "ck"],
     "-checkpoint is not read by the feature-sharded OVB"),
    ("vb_online", ["-cache_size", "1000"],
     "-cache_size is not read by -method vb_online"),
    ("vb_online", ["-num_eval_cases", "5"], "not read by the feature-sharded"),
    ("vb_online", ["-factor_block", "1"], "does not divide the world size 1"),
    # sgd's feature-sharded learner reads -task c and -checkpoint
    pytest.param("sgd", ["-task", "c", "-checkpoint", "ck"],
                 "does not divide the world size 1",
                 id="sgd-extra13-item 13.3"),
])
def test_cli_feature_shards_refusals(data, method, extra, message):
    """What the feature-sharded learners do not read is refused by name
    (vb: -factor_block; vb_online: -task c, -factor_block other than 0 and
    1, -reshuffle 1, -checkpoint; every method: -cache_size,
    -num_eval_cases, -map_eval), before the world size is checked; Gibbs
    and ALS read -factor_block and -task c, sgd -task c and
    -checkpoint."""
    d, _, _ = data
    argv = _args(d, method, "-feature_shards", "2", "-device", "cpu")
    if extra[:1] == ["-task"]:
        argv = argv[2:]
    with pytest.raises(SystemExit) as ei:
        cli.main(argv + extra)
    assert message in str(ei.value.code)


def test_cli_feature_shards_refuses_streamed_vb_online(data):
    """A binary train file streams vb_online from disk; the feature-sharded
    OVB holds its rows, so -feature_shards refuses it as the JAX CLI does
    (svbfm_tpu/cli.py:429-432)."""
    from svbfm_tpu_torch.data.binary import save_coo_binary
    from svbfm_tpu_torch.data.libfm_text import load_libfm_text

    d, _, _ = data
    save_coo_binary(str(d / "tr.libfm"), load_libfm_text(str(d / "tr.libfm")))
    with pytest.raises(SystemExit) as ei:
        cli.main(_args(d, "vb_online", "-feature_shards", "2", "-device",
                       "cpu"))
    assert "out-of-core vb_online streaming" in str(ei.value.code)


def test_cli_feature_shards_vb_online(data, tmp_path, monkeypatch, capsys):
    """-method vb_online -feature_shards 2 -distributed 1 on two spawned
    gloo ranks (a (1, 2) mesh) from the JAX CLI's init: the JAX CLI's files
    (rank 0 writes them); its test_rmse / free_energy files those that the
    library's TPOVBLearner writes on one rank from the same state (rtol
    1e-5), and within test_tp_ovb.py's rtol 2e-3 of the JAX CLI's
    -feature_shards 2 on the 8-device mesh (a (4, 2) mesh)."""
    import dataclasses

    import jax

    from svbfm_tpu.parallel import tp_ovb as jto
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.libfm_text import load_libfm_text
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.parallel.tp_ovb import TPOVBLearner
    from svbfm_tpu_torch.utils.convert import ovb_state_from_jax
    from torch_tp_ranks import cli_ovb_rank, run_ranks

    d, _, D = data
    argv = _args(d, "vb_online", "-feature_shards", "2", "-out", "pred.txt")
    seen = {}
    init = jto.TPOVBLearner.init_state

    def keep_init(self, key=None):  # a host copy: the step donates it
        s = init(self, key)
        seen["state"] = jax.device_get(s)
        return s

    monkeypatch.setattr(jto.TPOVBLearner, "init_state", keep_init)
    theirs = _run_in(d / "jax", jax_main, argv, monkeypatch)
    st = seen["state"]
    np.savez(tmp_path / "init.npz", **{
        f.name: np.asarray(getattr(st, f.name))[..., :D]
        if np.ndim(getattr(st, f.name)) and f.name not in (
            "sigma_w", "sigma_v") else np.asarray(getattr(st, f.name))
        for f in dataclasses.fields(st)})
    (d / "torch").mkdir()
    run_ranks(cli_ovb_rank, 2, tmp_path / "ranks", timeout=120,
              argv=argv + ["-distributed", "1", "-device", "cpu"],
              cwd=str(d / "torch"), init=str(tmp_path / "init.npz"))
    assert sorted(os.listdir(d / "torch")) == theirs
    traj = [n for n in theirs if n.startswith(("test_rmse", "free_energy"))]
    assert len(traj) == 2
    for name in traj + ["pred.txt"]:
        np.testing.assert_allclose(np.loadtxt(d / "torch" / name),
                                   np.loadtxt(d / "jax" / name), rtol=2e-3,
                                   err_msg=name)
    # the library's run on one rank from the same state and data
    tr, te = (load_libfm_text(str(d / n)) for n in ("tr.libfm", "te.libfm"))
    Dl = max(tr.num_features, te.num_features)
    cfg = FMConfig(num_attributes=Dl, num_factor=4, num_groups=1,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), num_iter=2,
                   num_batches=3)
    lib = tmp_path / "lib"
    lib.mkdir()
    lr = TPOVBLearner(cfg, SparseDataset.from_coo(tr, Dl),
                      SparseDataset.from_coo(te, Dl), DataMetaInfo(Dl),
                      mesh=make_mesh2d(device="cpu"), out_dir=str(lib),
                      write_files=True)
    with np.load(tmp_path / "init.npz") as z:
        state = lr.local_state(ovb_state_from_jax(dict(z), "cpu"))
    lr.run(state, num_iter=2, verbose=False)
    assert sorted(os.listdir(lib)) == traj
    for name in traj:
        np.testing.assert_allclose(np.loadtxt(d / "torch" / name),
                                   np.loadtxt(lib / name), rtol=1e-5,
                                   err_msg=name)


def test_cli_feature_shards_sgd(data, tmp_path, monkeypatch, capsys):
    """-method sgd -feature_shards 2 -distributed 1 on two spawned gloo
    ranks (a (1, 2) mesh; T1, T11 and X9b dense): the files of the world
    of one (rank 0 writes them; the resident SGD from the same seed's init
    and permutations), its RMSE file and predictions within
    test_tp_sgd.py's rtol 2e-4 / atol 2e-5; the JAX CLI's files among
    them (its feature-sharded SGD writes no trajectory file: its
    TPSGDLearner's write_files defaults to False)."""
    from torch_tp_ranks import cli_sgd_rank, run_ranks

    d, _, _ = data
    argv = _args(d, "sgd", "-learn_rate", "0.05", "-out", "pred.txt")
    one = _run_in(d / "one", cli.main, argv + ["-device", "cpu"],
                  monkeypatch)
    theirs = _run_in(d / "jax", jax_main, argv + ["-feature_shards", "2"],
                     monkeypatch)
    (d / "torch").mkdir()
    run_ranks(cli_sgd_rank, 2, tmp_path / "ranks", timeout=120,
              argv=argv + ["-feature_shards", "2", "-distributed", "1",
                           "-device", "cpu"], cwd=str(d / "torch"))
    assert sorted(os.listdir(d / "torch")) == one
    assert set(theirs) < set(one)
    for name in ("test_rmse_114_sgd", "pred.txt", "v_file.txt"):
        np.testing.assert_allclose(np.loadtxt(d / "torch" / name),
                                   np.loadtxt(d / "one" / name), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("method", ["sgd_online", "sgda", "exp_sgd", "bpr"])
def test_cli_feature_shards_refuses_the_other_sgd_methods(data, method):
    """sgda, sgd_online, exp_sgd and bpr have no feature-sharded learner,
    as the JAX CLI has none (svbfm_tpu/cli.py:349-354): -feature_shards is
    refused with the replicated learners' item."""
    d, _, _ = data
    extra = ["-validation", str(d / "va.libfm")] if method == "sgda" else []
    with pytest.raises(SystemExit) as ei:
        cli.main(_args(d, method, "-feature_shards", "2", "-device", "cpu",
                       *extra))
    assert "item 13.4" in str(ei.value.code)
