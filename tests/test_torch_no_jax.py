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
from svbfm_tpu_torch.parallel import make_mesh, make_mesh2d
from svbfm_tpu_torch.parallel.mesh import distributed_init
from svbfm_tpu_torch.parallel.tp import make_tp_scorer  # noqa: F401
from svbfm_tpu_torch.parallel.tp_vb import TPVBLearner
assert distributed_init(device="cpu") is False  # no configuration
_, ht = TPVBLearner(cfg, train, test, meta, mesh=make_mesh2d(device="cpu")
                    ).run(num_iter=2, verbose=False)
from svbfm_tpu_torch.parallel.tp_mcmc import TPALSLearner, TPMCMCLearner
_, htm = TPMCMCLearner(cfg, train, test, meta, mesh=make_mesh2d(device="cpu")
                       ).run(num_iter=2, verbose=False)
_, hta = TPALSLearner(cfg, train, test, meta, mesh=make_mesh2d(device="cpu")
                      ).run(num_iter=1, verbose=False)
from svbfm_tpu_torch.parallel.tp_ovb import TPOVBLearner
_, hto = TPOVBLearner(dataclasses.replace(cfg, num_batches=3), train, test,
                      meta, mesh=make_mesh2d(device="cpu")
                      ).run(num_iter=1, verbose=False)
from svbfm_tpu_torch.parallel.tp_sgd import TPSGDLearner
_, hts = TPSGDLearner(sgd_cfg, train, test, meta,
                      mesh=make_mesh2d(device="cpu")).run(num_iter=1,
                                                          verbose=False)
import numpy as np
from svbfm_tpu_torch.serve import BatchScorer
scored = BatchScorer(0.5, np.zeros(D, np.float32),
                     np.zeros((3, D), np.float32),
                     mesh=make_mesh2d(device="cpu"),
                     feature_sharded=True).score_rows(
                         test.ids[:5], test.vals[:5])
assert make_mesh(device="cpu").shape == (1, 1)
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
print("tp", len(ht))
print("tp_mcmc", len(htm), "tp_als", len(hta))
print("tp_ovb", len(hto))
print("tp_sgd", len(hts), "served", scored.shape[0])
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
    assert "tp 2" in r.stdout
    assert "tp_mcmc 2 tp_als 1" in r.stdout
    assert "tp_ovb 1" in r.stdout
    assert "tp_sgd 1 served 5" in r.stdout


def test_nccl_refuses_two_ranks_on_one_device(tmp_path):
    """NCCL needs a device a rank: two ranks on one card raise, before any
    group is joined, and nothing switches to gloo quietly; gloo may share
    a card."""
    import pytest

    from svbfm_tpu_torch.parallel.mesh import check_backend, distributed_init

    with pytest.raises(ValueError, match="NCCL cannot run 2 ranks on 1"):
        check_backend("nccl", "cuda", 2, 1)
    with pytest.raises(ValueError, match="NCCL runs on CUDA devices only"):
        check_backend("nccl", "cpu", 1, 0)
    check_backend("gloo", "cuda", 4, 1)
    check_backend("nccl", "cuda", 1, 1)
    with pytest.raises(ValueError, match="NCCL cannot run 2 ranks"):
        distributed_init(init_method=f"file://{tmp_path / 'store'}",
                         world_size=2, rank=0, backend="nccl",
                         device="cuda")
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_nccl_across_hosts_leaves_the_card_count_to_nccl(monkeypatch):
    """Ranks across hosts (a coordinator at another host, no
    LOCAL_WORLD_SIZE) are not held to this host's card count: a world of
    8 over hosts of 4 cards reaches the process group; LOCAL_WORLD_SIZE,
    a file:// store or a loopback address still count the host's ranks."""
    import pytest

    from svbfm_tpu_torch.parallel import mesh

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert mesh.local_world_size("tcp://coordinator.invalid:1234", 8) \
        is None
    assert mesh.local_world_size("file:///store", 8) == 8
    assert mesh.local_world_size("tcp://localhost:1234", 4) == 4
    assert mesh.local_world_size("tcp://127.0.0.1:1234", 4) == 4
    mesh.check_backend("nccl", "cuda", None, 4)
    joined = {}

    def init_process_group(backend, **kw):  # records, contacts nothing
        joined.update(kw, backend=backend)

    monkeypatch.setattr(mesh.dist, "init_process_group", init_process_group)
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(mesh, "rank_device", lambda device, rank: None)
    monkeypatch.setattr(mesh.torch.cuda, "device_count", lambda: 4)
    assert mesh.distributed_init(
        init_method="tcp://coordinator.invalid:1234", world_size=8, rank=5,
        device="cuda") is True
    assert joined == dict(backend="nccl",
                          init_method="tcp://coordinator.invalid:1234",
                          world_size=8, rank=5)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="NCCL cannot run 8 ranks on 4"):
        mesh.distributed_init(init_method="tcp://coordinator.invalid:1234",
                              world_size=8, rank=5, device="cuda")


def test_distributed_init_without_configuration_is_a_noop(monkeypatch):
    """As tests/test_distributed.py:22 holds of the JAX package's."""
    from svbfm_tpu_torch.parallel import mesh

    monkeypatch.delenv("SVBFM_COORDINATOR", raising=False)
    assert mesh.distributed_init(device="cpu") is False
    assert mesh.process_info() == (0, 1)


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
