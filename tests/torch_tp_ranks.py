"""Spawned gloo ranks for the tests of the port's feature-sharded learner.

``run_ranks(fn, world, workdir, **kw)`` starts ``world`` processes
(``torch.multiprocessing``, the spawn method), joins them into one gloo
group through a ``file://`` store in ``workdir`` (no TCP port: several
test workers run at once), calls ``fn(rank, **kw)`` in each and returns
the ranks' results in rank order.  A child's failure or a run past
``timeout`` fails the call.  ``fn`` must be a module-level function of an
importable module; this module imports no JAX, so a child does not.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, fn, world: int, workdir: str, kw: dict) -> None:
    out = os.path.join(workdir, f"rank{rank}.pkl")
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
            world_size=world, rank=rank)
        res = fn(rank, **kw)
        dist.barrier()
        dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(("ok", res), f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def run_ranks(fn, world: int, workdir, timeout: float = 90.0, **kw) -> list:
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(fn, world, workdir, kw),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks ran past {timeout} s")
    except mp.ProcessRaisedException as exc:
        raise AssertionError(f"a rank failed:\n{exc}") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            status, res = pickle.load(f)
        assert status == "ok", res
        results.append(res)
    return results


# ---- the recipe and the ranks' work -----------------------------------------

def tp_setup(seed: int = 2, K: int = 4):
    """``tests/test_tp.py:_tp_train_setup``'s recipe in the port (700
    ratings, 20 users, 14 items, K = 4): (cfg, train, test, meta, D)."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import (make_movielens_like,
                                            train_test_split)
    from svbfm_tpu_torch.learners.base import FMConfig

    coo = make_movielens_like(num_users=20, num_items=14, num_ratings=700,
                              rank=2, noise=0.4, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 20])
    cfg = FMConfig(num_attributes=D, num_factor=K,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7)
    return (cfg, SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta, D)


def _learner(shape, setup: dict):
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.parallel.tp_vb import TPVBLearner

    cfg, tr, te, meta, _ = tp_setup(**setup)
    mesh = make_mesh2d(n_data=shape[0], n_feature=shape[1], device="cpu")
    return TPVBLearner(cfg, tr, te, meta, mesh=mesh)


def _numpy(state) -> dict:
    import dataclasses
    return {f.name: getattr(state, f.name).numpy()
            for f in dataclasses.fields(state)}


def train(rank: int, shape, setup: dict, num_iter: int,
          init: str = "") -> dict:
    """``num_iter`` sweeps on a mesh of ``shape``, from the JAX learner's
    global state saved as npz at ``init`` (else the port's own init):
    the history and the gathered global state."""
    import numpy as np

    from svbfm_tpu_torch.utils.convert import tp_vb_state_from_jax

    lr = _learner(shape, setup)
    state = None
    if init:
        with np.load(init) as z:
            state = tp_vb_state_from_jax(
                dict(z), "cpu", d=lr.mesh.d_index, f=lr.mesh.f_index,
                n_data=lr.mesh.n_data, D_loc=lr.D_loc)
    state, hist = lr.run(state, num_iter=num_iter, verbose=False)
    return dict(hist=hist, state=_numpy(lr.global_state(state)),
                D_loc=lr.D_loc, scores=lr.predict_test_scores(state))


def train_ckpt(rank: int, shape, setup: dict, num_iter: int, ckpt_dir: str,
               ckpt_every: int) -> dict:
    """Sweeps up to ``num_iter`` through a checkpoint directory (resuming
    from it where it holds one): the history and the global state."""
    from svbfm_tpu_torch.utils.checkpoint import CheckpointManager

    lr = _learner(shape, setup)
    state, hist = lr.run(num_iter=num_iter, verbose=False,
                         ckpt=CheckpointManager(ckpt_dir),
                         ckpt_every=ckpt_every)
    return dict(hist=hist, state=_numpy(lr.global_state(state)))


def full_and_first(rank: int, setup: dict, ck: str):
    """On a (1, 2) mesh: 6 uninterrupted sweeps, then 3 that save a
    checkpoint in ``ck``."""
    return (train(rank, (1, 2), setup, 6),
            train_ckpt(rank, (1, 2), setup, 3, ck, 3))


def cli_rank(rank: int, argv: list, cwd: str, init: str) -> int:
    """The port's CLI on this rank, from the JAX init parameters saved as
    npz at ``init`` (whole [D] tables), run in ``cwd``."""
    import numpy as np
    import torch

    from svbfm_tpu_torch import cli
    from svbfm_tpu_torch.parallel import tp_vb

    def init_state(self, generator=None):
        with np.load(init) as z:
            return self.state_from_params(
                {k: torch.from_numpy(z[k]) for k in z.files})

    tp_vb.TPVBLearner.init_state = init_state
    os.chdir(cwd)
    return cli.main(argv)


def cli_mcmc_rank(rank: int, argv: list, cwd: str, init: str) -> int:
    """The port's CLI (-method mcmc or als) on this rank, the tables of
    its start (w0, w [D], v [K, D]) from the npz at ``init``, run in
    ``cwd``."""
    import numpy as np
    import torch

    from svbfm_tpu_torch import cli
    from svbfm_tpu_torch.learners.draws import device_draws
    from svbfm_tpu_torch.parallel import tp_mcmc

    def init_state(self, generator=None, draws=None):
        with np.load(init) as z:
            t = {k: torch.from_numpy(z[k]) for k in z.files}
        return self.state_from_params(t["w0"], t["w"], t["v"], device_draws(
            self.cfg.seed, self.device))

    tp_mcmc.TPMCMCLearner.init_state = init_state
    os.chdir(cwd)
    return cli.main(argv)


# ---- the feature-sharded Gibbs/ALS (parallel/tp_mcmc.py) ---------------------

def mcmc_setup(seed: int = 3, n: int = 900, **cfg_kw):
    """``tests/test_tp_mcmc.py:_setup``'s recipe in the port (900 ratings,
    25 users, 16 items, K = 4): (cfg, train, test, meta, D)."""
    import dataclasses

    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import (make_movielens_like,
                                            train_test_split)
    from svbfm_tpu_torch.learners.base import FMConfig

    coo = make_movielens_like(num_users=25, num_items=16, num_ratings=n,
                              rank=2, noise=0.3, seed=seed)
    tr, te = train_test_split(coo, 0.2, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 25])
    cfg = FMConfig(num_attributes=D, num_factor=4,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=11, regw=0.1,
                   regv=0.1)
    return (dataclasses.replace(cfg, **cfg_kw),
            SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta, D)


def binarized(setup):
    """``test_tp_mcmc.py:test_tp_mcmc_classification``'s binarised recipe:
    the targets above the train median are +1, the others -1."""
    import dataclasses

    import numpy as np

    cfg, tr, te, meta, D = setup
    med = float(np.median(tr.target[: tr.num_rows]))

    def binarize(ds):
        t = np.where(ds.target > med, 1.0, -1.0).astype(np.float32)
        return dataclasses.replace(ds, target=t)
    cfg = dataclasses.replace(cfg, task=1, min_target=-1.0, max_target=1.0)
    return cfg, binarize(tr), binarize(te), meta, D


def _mcmc_learner(shape, setup, als: bool = False, **kw):
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.parallel.tp_mcmc import TPALSLearner, TPMCMCLearner

    cfg, tr, te, meta, _ = setup
    mesh = make_mesh2d(n_data=shape[0], n_feature=shape[1], device="cpu")
    cls = TPALSLearner if als else TPMCMCLearner
    return cls(cfg, tr, te, meta, mesh=mesh, **kw)


def _mcmc_result(lr, state, hist) -> dict:
    import dataclasses

    g = lr.global_state(state)
    return dict(hist=hist, D_loc=lr.D_loc,
                state={f.name: getattr(g, f.name).numpy()
                       for f in dataclasses.fields(g) if f.name != "draws"})


def mcmc_run(shape, setup, num_iter: int, init: str = "", als=False,
             replay=False, **run_kw) -> dict:
    """``num_iter`` sweeps of the TP Gibbs (``als``: ALS) on a mesh of
    ``shape`` from the JAX learner's global ``MCMCState`` saved as npz at
    ``init`` (else the port's own init), the draws from the JAX key chain
    replayed (``replay``: test_torch_mcmc.py's JaxKeyDraws, from the key
    saved beside the state) or from a host generator of the seed: the
    history, the gathered global state and, under replay, the key."""
    import numpy as np

    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.utils.convert import tp_mcmc_state_from_jax

    lr = _mcmc_learner(shape, setup, als)
    state = None
    if init:
        with np.load(init) as z:
            z = dict(z)
        if replay:
            from test_torch_mcmc import JaxKeyDraws
            draws = JaxKeyDraws(z["key"])
        else:
            draws = host_draws(lr.cfg.seed, "cpu")
        state = tp_mcmc_state_from_jax(
            z, "cpu", draws, d=lr.mesh.d_index, f=lr.mesh.f_index,
            n_data=lr.mesh.n_data, D_loc=lr.D_loc)
    state, hist = lr.run(state, num_iter=num_iter, verbose=False, **run_kw)
    out = _mcmc_result(lr, state, hist)
    if replay:
        out["key"] = np.asarray(state.draws.key)
    return out


def mcmc_ckpt(shape, setup, num_iter: int, ckpt_dir: str,
              ckpt_every: int) -> dict:
    """Sweeps up to ``num_iter`` (chunks of 3) through a checkpoint
    directory, resuming from it where it holds one."""
    from svbfm_tpu_torch.utils.checkpoint import CheckpointManager

    lr = _mcmc_learner(shape, setup)
    state, hist = lr.run(num_iter=num_iter, verbose=False, chunk=3,
                         ckpt=CheckpointManager(ckpt_dir),
                         ckpt_every=ckpt_every)
    return _mcmc_result(lr, state, hist)


def mcmc_two_ranks(rank: int, inits: dict, ck: str) -> dict:
    """Two ranks: ALS and the replayed Gibbs, 4 sweeps each from the JAX
    init, on the meshes (1, 2) and (2, 1); the port's own Gibbs on (1, 2)
    (mesh invariance); 6 Gibbs sweeps against 3 that save a checkpoint in
    ``ck`` on (1, 2), resumed to 6 on (2, 1); dim 1,1,0 Gibbs and 0,0,4
    ALS, 3 sweeps."""
    import dataclasses

    base = mcmc_setup()
    out = {}
    for shape in ((1, 2), (2, 1)):
        path = inits[shape]
        out[shape, "als"] = mcmc_run(shape, base, 4, path, als=True)
        out[shape, "gibbs"] = mcmc_run(shape, base, 4, path, replay=True)
    out["own"] = mcmc_run((1, 2), mcmc_setup(seed=9), 4)
    ck_setup = mcmc_setup(seed=23)
    out["full"] = mcmc_run((1, 2), ck_setup, 6, chunk=3)
    out["first"] = mcmc_ckpt((1, 2), ck_setup, 3, ck, 3)
    out["resumed"] = mcmc_ckpt((2, 1), ck_setup, 6, ck, 100)
    cfg, tr, te, meta, D = mcmc_setup(seed=31, n=600)
    out["k0"] = mcmc_run((1, 2), (dataclasses.replace(cfg, num_factor=0),
                                  tr, te, meta, D), 3)
    out["bias_off"] = mcmc_run(
        (1, 2), (dataclasses.replace(cfg, k0=False, k1=False), tr, te, meta,
                 D), 3, als=True)
    return out


def mcmc_four_ranks(rank: int, init: str, ml_init: str) -> dict:
    """Four ranks, the mesh (2, 2): ALS and the replayed Gibbs, 4 sweeps
    from the JAX init; one deterministic multilevel step (do_sample=False,
    do_multilevel=True) from its JAX init; the port's own Gibbs (mesh
    invariance); 10 Gibbs sweeps of the binarised recipe under -task c."""
    out = {"als": mcmc_run((2, 2), mcmc_setup(), 4, init, als=True),
           "gibbs": mcmc_run((2, 2), mcmc_setup(), 4, init, replay=True),
           "multilevel": mcmc_run((2, 2), mcmc_setup(
               seed=41, do_sample=False, do_multilevel=True), 1, ml_init,
               replay=True),
           "own": mcmc_run((2, 2), mcmc_setup(seed=9), 4),
           "class": mcmc_run((2, 2), binarized(mcmc_setup(seed=13)), 10)}
    return out


# ---- the feature-sharded online VB (parallel/tp_ovb.py) ---------------------

def ovb_setup(**cfg_kw):
    """``tests/test_tp_ovb.py:_setup``'s recipe in the port (900 ratings,
    18 users, 14 items, K = 3, 4 chunks): (cfg, train, test, meta, D)."""
    import dataclasses

    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import (make_movielens_like,
                                            train_test_split)
    from svbfm_tpu_torch.learners.base import FMConfig

    coo = make_movielens_like(num_users=18, num_items=14, num_ratings=900,
                              rank=2, noise=0.4, seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 18])
    cfg = FMConfig(num_attributes=D, num_factor=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7, num_batches=4)
    return (dataclasses.replace(cfg, **cfg_kw),
            SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta, D)


def ovb_run(shape, num_iter: int, init: str = "") -> dict:
    """``num_iter`` epochs of the TP OVB on a mesh of ``shape`` from the
    JAX learner's global ``TPOVBState`` saved as npz at ``init`` (else the
    port's own init): the history, the gathered global state and the test
    scores."""
    import dataclasses

    import numpy as np

    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.parallel.tp_ovb import TPOVBLearner
    from svbfm_tpu_torch.utils.convert import tp_ovb_state_from_jax

    cfg, tr, te, meta, _ = ovb_setup()
    lr = TPOVBLearner(cfg, tr, te, meta, mesh=make_mesh2d(
        n_data=shape[0], n_feature=shape[1], device="cpu"))
    state = None
    if init:
        with np.load(init) as z:
            state = tp_ovb_state_from_jax(dict(z), "cpu", d=lr.mesh.d_index,
                                          f=lr.mesh.f_index, D_loc=lr.D_loc)
    state, hist = lr.run(state, num_iter=num_iter, verbose=False)
    g = lr.global_state(state)
    return dict(hist=hist, D_loc=lr.D_loc,
                state={f.name: getattr(g, f.name).numpy()
                       for f in dataclasses.fields(g)},
                scores=lr.predict_test_scores(state))


def ovb_ranks(rank: int, runs: list, num_iter: int) -> dict:
    """Each (shape, init) of ``runs`` in turn on this world's ranks:
    ``ovb_run``'s results by shape (a second run of one shape: by
    (shape, "own"))."""
    out = {}
    for shape, init in runs:
        out[tuple(shape) if init else (tuple(shape), "own")] = ovb_run(
            tuple(shape), num_iter, init)
    return out


def cli_ovb_rank(rank: int, argv: list, cwd: str, init: str) -> int:
    """The port's CLI (-method vb_online -feature_shards) on this rank, its
    start the JAX init state saved as npz at ``init`` (the global
    ``TPOVBState``), run in ``cwd``."""
    import numpy as np

    from svbfm_tpu_torch import cli
    from svbfm_tpu_torch.parallel import tp_ovb
    from svbfm_tpu_torch.utils.convert import ovb_state_from_jax

    def init_state(self, generator=None):
        with np.load(init) as z:
            return self.local_state(ovb_state_from_jax(dict(z), "cpu"))

    tp_ovb.TPOVBLearner.init_state = init_state
    os.chdir(cwd)
    return cli.main(argv)


# ---- the feature-sharded SGD (parallel/tp_sgd.py) ----------------------------

class RecordedPerms:
    """A draw source of recorded permutations ``perms`` [epochs, Sd, n]
    (the JAX learner's, replayed by the test in the parent): an epoch's
    call takes the next epoch's, its data shard's."""

    def __init__(self, perms):
        self.perms, self.epoch = perms, 0

    def permutation(self, n: int, shard: int = 0, n_shards: int = 1):
        import torch

        p = self.perms[self.epoch]
        self.epoch += 1
        assert p.shape == (n_shards, n), (p.shape, n_shards, n)
        return torch.from_numpy(p[shard].astype("int64"))


def sgd_setup(task: int = 0, **cfg_kw):
    """``tests/test_tp_sgd.py:_setup``'s recipe in the port (900 ratings, 18
    users, 14 items, K = 3, batch 128, learn rate 0.05); ``task`` 1: the
    targets binarised at the rating midpoint, as
    ``test_tp_sgd_classification`` does.  (cfg, train, test, meta, D)."""
    import dataclasses

    import numpy as np

    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import (make_movielens_like,
                                            train_test_split)
    from svbfm_tpu_torch.learners.base import FMConfig

    coo = make_movielens_like(num_users=18, num_items=14, num_ratings=900,
                              rank=2, noise=0.4, seed=2)
    tr, te = train_test_split(coo, 0.25, seed=3)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 18])
    cfg = FMConfig(num_attributes=D, num_factor=3, task=task,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7,
                   learn_rate=0.05, regw=0.01, regv=0.01, batch_size=128)
    if task == 1:
        mid = 0.5 * (cfg.min_target + cfg.max_target)
        for c in (tr, te):
            c.target = np.where(c.target > mid, 1.0, -1.0).astype(
                np.float32)
        cfg = dataclasses.replace(cfg, min_target=-1.0, max_target=1.0)
    return (dataclasses.replace(cfg, **cfg_kw), SparseDataset.from_coo(tr, D),
            SparseDataset.from_coo(te, D), meta, D)


def sgd_run(shape, setup: dict, num_iter: int, init: str = "",
            ckpt: str = "", ckpt_every: int = 100) -> dict:
    """``num_iter`` epochs of the TP SGD on a mesh of ``shape`` from the
    JAX learner's global state and replayed permutations saved as npz at
    ``init`` (else the port's own init, the draws from a host generator of
    the seed), through the checkpoint directory ``ckpt`` where given: the
    history, the gathered table and w0, the test scores."""
    import numpy as np

    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.parallel.mesh import make_mesh2d
    from svbfm_tpu_torch.parallel.tp_sgd import TPSGDLearner
    from svbfm_tpu_torch.utils.checkpoint import CheckpointManager
    from svbfm_tpu_torch.utils.convert import tp_sgd_state_from_jax

    cfg, tr, te, meta, _ = sgd_setup(**setup)
    lr = TPSGDLearner(cfg, tr, te, meta, mesh=make_mesh2d(
        n_data=shape[0], n_feature=shape[1], device="cpu"))
    if init:
        with np.load(init) as z:
            z = dict(z)
        state = tp_sgd_state_from_jax(
            z, "cpu", RecordedPerms(z["perms"]), d=lr.mesh.d_index,
            f=lr.mesh.f_index, D_loc=lr.D_loc)
    else:
        state = lr.init_state(draws=host_draws(cfg.seed, "cpu"))
    kw = dict(ckpt=CheckpointManager(ckpt), ckpt_every=ckpt_every) \
        if ckpt else {}
    state, hist = lr.run(state, num_iter=num_iter, verbose=False, **kw)
    g = lr.global_state(state)
    return dict(hist=hist, D_loc=lr.D_loc, num_batches=lr.num_batches,
                w0=float(g.w0), tab=g.tab.numpy(),
                scores=lr.predict_test_scores(state))


def sgd_ranks(rank: int, runs: list) -> dict:
    """Each (name, shape, setup, num_iter, init, ckpt, ckpt_every) of
    ``runs`` in turn on this world's ranks: ``sgd_run``'s results by
    name."""
    return {name: sgd_run(tuple(shape), setup, n, init, ck, every)
            for name, shape, setup, n, init, ck, every in runs}


# ---- serving over the ranks (serve.py BatchScorer with a mesh) ----------------

def serve_ranks(rank: int, model: str, cases: list) -> dict:
    """BatchScorer over the 1-D mesh of every rank, for each (name,
    feature_sharded, scorer kwargs) of ``cases``, on the parameters and
    rows saved as npz at ``model``: the predictions by name."""
    import numpy as np

    from svbfm_tpu_torch.parallel.mesh import make_mesh
    from svbfm_tpu_torch.serve import BatchScorer

    with np.load(model) as z:
        z = dict(z)
    mesh = make_mesh(device="cpu")
    return {name: BatchScorer(z["w0"], z["w"], z["v"], mesh=mesh,
                              feature_sharded=fs, **kw).score_rows(
                                  z["ids"], z["vals"])
            for name, fs, kw in cases}


def cli_sgd_rank(rank: int, argv: list, cwd: str) -> int:
    """The port's CLI on this rank (``-method sgd -feature_shards``, the
    port's own init), run in ``cwd``."""
    from svbfm_tpu_torch import cli

    os.chdir(cwd)
    return cli.main(argv)


# ---- the data-parallel replicated learners (VBLearner/MCMCLearner(mesh=)) --

def dp_setup(num_rows: int = 96, num_users: int = 9, num_items: int = 7,
             K: int = 3, seed: int = 2, task: int = 0, **cfg_kw):
    """``tests/test_vb.py:_setup``'s and ``test_mcmc.py:_setup``'s recipe
    in the port (96 ratings, 9 users, 7 items, K = 3, a 75/25 split);
    ``task`` 1: the targets above the train median +1, the others -1.
    (cfg, train, test, meta, D)."""
    import numpy as np

    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import (make_movielens_like,
                                            train_test_split)
    from svbfm_tpu_torch.learners.base import FMConfig

    coo = make_movielens_like(num_users=num_users, num_items=num_items,
                              num_ratings=num_rows, rank=2, noise=0.4,
                              seed=seed)
    tr, te = train_test_split(coo, 0.25, seed=seed + 1)
    D = coo.num_features
    if task == 1:
        thr = np.median(tr.target)
        for c in (tr, te):
            c.target = np.where(c.target > thr, 1.0, -1.0).astype(
                np.float32)
    meta = DataMetaInfo.from_field_offsets(D, [0, num_users])
    cfg = FMConfig(num_attributes=D, num_factor=K, task=task,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=7, **cfg_kw)
    return (cfg, SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta, D)


def _dp_learner(mesh, setup: dict, mcmc: str = "", **kw):
    """VBLearner (``mcmc`` "": batch VB), MCMCLearner ("gibbs") or
    ALSLearner ("als") on ``mesh`` (None: one device) for the
    ``dp_setup(**setup)`` recipe."""
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.learners.vb import VBLearner

    cfg, tr, te, meta, _ = dp_setup(**setup)
    cls = {"": VBLearner, "gibbs": MCMCLearner, "als": ALSLearner}[mcmc]
    dev = dict(device="cpu") if mesh is None else dict(mesh=mesh)
    return cls(cfg, tr, te, meta, write_files=False, **dev, **kw)


def _dp_start(lr, init: str):
    """The learner's state from the JAX learner's parameters saved as npz
    at ``init`` (VB: the ten parameter arrays; Gibbs/ALS: w0, w, v and
    the key, whose chain ``JaxKeyDraws`` replays), else its own init."""
    import numpy as np
    import torch

    if not init:
        return lr.init_state()
    with np.load(init) as z:
        z = dict(z)
    if lr.method == "vb":
        return lr.state_from_params({k: torch.from_numpy(a)
                                     for k, a in z.items()})
    from test_torch_mcmc import JaxKeyDraws
    return lr.state_from_params(*(torch.from_numpy(z[k])
                                  for k in ("w0", "w", "v")),
                                JaxKeyDraws(z["key"]))


def dp_run(mesh, setup: dict, num_iter: int, init: str = "",
           mcmc: str = "", num_eval_cases=None, ckpt: str = "",
           ckpt_every: int = 100) -> dict:
    """``num_iter`` iterations of a replicated learner on ``mesh`` (None:
    one device), each a sweep and the test eval as ``run`` makes them
    (through the checkpoint directory ``ckpt`` where given, resuming from
    it): the history, the tables after every sweep (``sweeps``, to hold
    the ranks' bits equal), the final state in the global layout and the
    test predictions."""
    from svbfm_tpu_torch.learners.base import gather_rows
    from svbfm_tpu_torch.utils.checkpoint import CheckpointManager

    lr = _dp_learner(mesh, setup, mcmc, num_eval_cases=num_eval_cases)
    state = _dp_start(lr, init)
    tables = (("mu_0", "mu_w", "sigma_w_dash", "mu_v", "sigma_v_dash",
               "alpha", "sigma_w", "sigma_v") if lr.method == "vb" else
              ("w0", "w", "v", "alpha", "w_mu", "w_lambda", "v_mu",
               "v_lambda"))
    sweeps = []

    def keep(step):
        def step_and_keep(st):
            st, out = step(st)
            sweeps.append({k: getattr(st, k).numpy().copy() for k in tables})
            return st, out
        return step_and_keep

    lr.step = keep(lr.step)
    kw = dict(ckpt=CheckpointManager(ckpt), ckpt_every=ckpt_every) \
        if ckpt else {}
    state, hist = lr.run(state, num_iter=num_iter, verbose=False, chunk=1,
                         **kw)
    final = {k: getattr(state, k).numpy() for k in tables}
    e = state.e if mesh is None else gather_rows(mesh, state.e, lr.rps)
    final["e"] = e[: lr.train_n].numpy()
    preds = (lr.final_test_predictions(state) if mcmc
             else lr.predict_test_scores(state))
    return dict(hist=hist, sweeps=sweeps, final=final, preds=preds)


def dp_ranks(rank: int, runs: list) -> dict:
    """Each (name, setup, num_iter, init, mcmc, num_eval_cases, ckpt,
    ckpt_every) of ``runs`` in turn on the data mesh of every rank:
    ``dp_run``'s results by name."""
    from svbfm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    return {name: dp_run(mesh, setup, n, init, mcmc, nec, ck, every)
            for name, setup, n, init, mcmc, nec, ck, every in runs}


def cli_dp_rank(rank: int, argv: list, cwd: str, init: str) -> int:
    """The port's CLI (-method vb, mcmc or als, no -feature_shards) on this
    rank, the replicated learner's start from the JAX CLI's init saved as
    npz at ``init`` (VB: the ten parameters; Gibbs/ALS: w0, w, v and the
    key, replayed by ``JaxKeyDraws``), run in ``cwd``."""
    from svbfm_tpu_torch import cli
    from svbfm_tpu_torch.learners.mcmc import MCMCLearner
    from svbfm_tpu_torch.learners.vb import VBLearner

    def init_state(self, generator=None, draws=None):
        return _dp_start(self, init)

    VBLearner.init_state = init_state
    MCMCLearner.init_state = init_state
    os.chdir(cwd)
    return cli.main(argv)
