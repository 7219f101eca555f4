"""The port's CLI (``python -m svbfm_tpu_torch.cli``) on tiny libFM text
files with ``-device cpu``: vb, vb_online and the SGD family run end to end
(mcmc and als: tests/test_torch_mcmc.py) and write what the JAX CLI
writes, under the same names; every flag or method the port does not run
exits non-zero with a message that names its ROADMAP item, and a flag the
chosen method does not read is refused."""

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
    (["-relation", "rel"], {}, "item 11"),
    (["-cache_size", "1000"], {}, "item 10"),
    (["-checkpoint", "ck"], {}, "item 12"),
    (["-rlog", "log.tsv"], {}, "item 12"),
    (["-feature_shards", "2"], {}, "item 13"),
    (["-num_eval_cases", "5"], {}, "item 4"),
    (["-learn_rate", "0.1"], {}, "not read"),
    (["-bogus", "1"], {}, "unknown parameter"),
    ([], dict(task="c"), "Next C"),
    ([], dict(method="exp_sgd"), "item 8"),
    (["-validation", "va.libfm"], {}, "only by sgda"),
    ([], dict(method="sgda"), "mandatory for SGDA"),
    (["-stdev", "2"], dict(method="sgd"), "only by exp_sgd_stoc"),
    (["-bpr_neg_field", "0"], dict(method="sgd"), "only by bpr"),
    (["-learn_rate", "0.1,0.2"], dict(method="sgd"), "1 or 3 values"),
    (["-regular", "0.1"], dict(method="sgda"), "not read by -method sgda"),
    ([], dict(method="nonsense"), "unknown method"),
])
def test_refused_flags_and_methods(data, extra, kw, message):
    d, _, _ = data
    argv = _args(d, kw.get("method", "vb"), "-device", "cpu", *extra,
                 task=kw.get("task", "r"))
    with pytest.raises(SystemExit) as ei:
        cli.main(argv)
    assert message in str(ei.value.code)


def test_binary_input_refused(data):
    d, _, _ = data
    for suffix in (".x", ".y"):
        (d / f"tr.libfm{suffix}").write_bytes(b"")
    with pytest.raises(SystemExit) as ei:
        cli.main(_args(d, "vb", "-device", "cpu"))
    assert "binary input" in str(ei.value.code) and "item 10" in str(
        ei.value.code)


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
    r = subprocess.run(run + _args(d, "exp_sgd", "-device", "cpu"), cwd=d,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "item 8" in r.stderr
    r = subprocess.run(run + ["-help"], cwd=d, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "-device" in r.stdout


SGD_ARGS = {
    "sgd": ["-learn_rate", "0.05", "-regular", "0,0.01,0.01"],
    "sgd_online": ["-learn_rate", "0.05", "-batch", "3"],
    "sgda": ["-learn_rate", "0.05", "-validation", "va.libfm"],
    "exp_sgd_stoc": ["-learn_rate", "0.02", "-stdev", "1.5"],
    "bpr": ["-learn_rate", "0.05", "-batch", "4", "-bpr_neg_field", "-1"],
}


@pytest.mark.parametrize("method", list(SGD_ARGS))
def test_cli_sgd_family_writes_the_jax_cli_files(data, method, monkeypatch,
                                                 capsys):
    """-method sgd|sgd_online|sgda|exp_sgd_stoc|bpr at -device cpu: the
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
