"""The port imports neither JAX, nor flax, nor the JAX package."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN_WITHOUT_JAX = r"""
import dataclasses
import sys
for name in ("jax", "flax", "svbfm_tpu"):
    sys.modules[name] = None  # any import of them now raises
import svbfm_tpu_torch
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.vb import VBLearner
from svbfm_tpu_torch.learners.vb_online import OVBLearner
from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
from svbfm_tpu_torch.learners.sgd import SGDALearner, SGDLearner
from svbfm_tpu_torch.learners.bpr import BPRLearner
from svbfm_tpu_torch.learners.exp_sgd import ExpSGDLearner
from svbfm_tpu_torch.learners.mcmc_bs import ALSBSLearner, MCMCBSLearner
from svbfm_tpu_torch.data.relation import build_joined_meta
from svbfm_tpu_torch.data.synth import make_bs_problem
from svbfm_tpu_torch.utils import convert  # noqa: F401
from svbfm_tpu_torch import cli  # noqa: F401

coo = make_movielens_like(num_users=9, num_items=7, num_ratings=96, seed=2)
tr, te = train_test_split(coo, 0.25, seed=3)
D = coo.num_features
meta = DataMetaInfo.from_field_offsets(D, [0, 9])
cfg = FMConfig(num_attributes=D, num_factor=3, num_groups=2, seed=7,
               min_target=float(tr.target.min()),
               max_target=float(tr.target.max()))
learner = VBLearner(cfg, SparseDataset.from_coo(tr, D),
                    SparseDataset.from_coo(te, D), meta, device="cpu",
                    write_files=False)
_, hist = learner.run(num_iter=2, verbose=False)
train, test = SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D)
exact = VBLearner(dataclasses.replace(cfg, factor_block=1), train, test,
                  meta, device="cpu", write_files=False)
_, hx = exact.run(num_iter=1, verbose=False)
ovb = OVBLearner(dataclasses.replace(cfg, num_batches=3), train, test, meta,
                 device="cpu", write_files=False)
_, ho = ovb.run(num_iter=1, verbose=False)
gibbs = MCMCLearner(cfg, train, test, meta, device="cpu", write_files=False)
_, hm = gibbs.run(num_iter=2, verbose=False)
als = ALSLearner(dataclasses.replace(cfg, factor_block=1), train, test, meta,
                 device="cpu", write_files=False)
_, ha = als.run(num_iter=2, verbose=False)
sgd_cfg = dataclasses.replace(cfg, batch_size=16, learn_rate=0.05)
_, hs = SGDLearner(sgd_cfg, train, test, meta, device="cpu",
                   write_files=False).run(num_iter=1, verbose=False)
_, hg = SGDALearner(sgd_cfg, train, test, test, meta, device="cpu",
                    write_files=False).run(num_iter=1, verbose=False)
_, hb = BPRLearner(dataclasses.replace(sgd_cfg, num_batches=4), train, test,
                   meta, device="cpu", write_files=False).run(
                       num_iter=1, verbose=False)
_, he = ExpSGDLearner(dataclasses.replace(cfg, learn_rate=0.3), train, test,
                      meta, device="cpu", write_files=False).run(
                          num_iter=2, verbose=False)
main, ru, ri, users, items, y = make_bs_problem(300, 2, 2)
jmeta = build_joined_meta(DataMetaInfo(0), [ru, ri])
bcfg = dataclasses.replace(cfg, num_attributes=jmeta.num_attributes,
                           num_groups=jmeta.num_attr_groups,
                           min_target=float(y.min()),
                           max_target=float(y.max()))
mds = SparseDataset.from_coo(main, jmeta.num_attributes)
bs_args = (mds, mds, [ru, ri], [users, items], [users, items], jmeta, 0)
_, hbm = MCMCBSLearner(bcfg, *bs_args, device="cpu",
                       write_files=False).run(num_iter=2, verbose=False)
_, hba = ALSBSLearner(dataclasses.replace(bcfg, factor_block=1), *bs_args,
                      device="cpu", write_files=False).run(num_iter=1,
                                                           verbose=False)
from svbfm_tpu_torch.learners.mcmc_windowed import WindowedMCMCLearner
_, hw = WindowedMCMCLearner(dataclasses.replace(cfg, factor_block=1), train,
                            test, meta, device="cpu", num_windows=2,
                            write_files=False).run(num_iter=1, verbose=False)
loaded = [m for m, v in sys.modules.items() if v is not None and
          m.split(".")[0] in ("jax", "flax", "svbfm_tpu")]
assert not loaded, loaded
print("sweeps", len(hist), "rmse", hist[-1]["rmse"])
print("exact", len(hx), "ovb", len(ho), ho[-1]["rmse"])
print("mcmc", len(hm), "als", len(ha), hm[-1]["rmse"], ha[-1]["rmse_this"])
print("sgd", len(hs), "sgda", len(hg), "bpr", len(hb), hs[-1]["rmse"],
      hg[-1]["rmse_val"], hb[-1]["accuracy"])
print("exp_sgd", len(he), "bs", len(hbm), len(hba), he[-1]["rmse"],
      hbm[-1]["rmse"])
print("windowed", len(hw))
"""


def test_port_runs_two_sweeps_without_jax():
    r = subprocess.run([sys.executable, "-c", _RUN_WITHOUT_JAX], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "sweeps 2" in r.stdout
    assert "exact 1 ovb 1" in r.stdout
    assert "mcmc 2 als 2" in r.stdout
    assert "sgd 1 sgda 1 bpr 1" in r.stdout
    assert "exp_sgd 2 bs 2 1" in r.stdout
    assert "windowed 1" in r.stdout


def test_no_jax_import_statement_in_port():
    pat = re.compile(r"^\s*(import|from) (jax|flax|svbfm_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "svbfm_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            bad += [f"{path}:{i}" for i, line in enumerate(f, 1)
                    if pat.match(line)]
    assert len(files) > 10 and not bad, bad
