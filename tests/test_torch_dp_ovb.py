"""The port's online VB data-parallel (``OVBLearner(mesh=)``, in memory and
``from_reader``) on spawned gloo ranks, against the JAX package's
``OVBLearner`` on ``make_mesh(4)`` (streamed: ``make_mesh(2)``) of
conftest's 8-device CPU mesh, against the port's one-device learner and
against the float64 ``OVBOracle``, every run from the JAX learner's init
(``utils.convert.ovb_state_from_jax``).

Each case runs once on four ranks (one spawn for the module, beside a
two-rank spawn that streams a binary file and writes a checkpoint):
factor_block 1 and 4, ``reshuffle``, ``-task c``, and a recipe whose last
rank holds only padding rows in every chunk; T13's twins split over two
row shards against K6's twin on the whole bin.  Tolerances:
  * against JAX: ``tests/test_torch_ovb_streaming.py``'s, parameters and
    precisions rtol 1e-4 / atol 1e-5, naturals rtol 1e-3 / atol 1e-4,
    metrics rtol 1e-5, the Robbins-Monro counters equal (the JAX learner
    sums over its four devices, and pads the chunks' plans to one shape);
  * against the float64 oracle: ``test_vb_online.py:60-67``'s;
  * against the port on one device, the same init: rtol 1e-4 / atol 1e-6
    on the state after every chunk, rtol 1e-5 on the metrics (float32 sums
    over four blocks of rows instead of one);
  * the four ranks' states after every chunk: equal bit for bit.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from svbfm_tpu.data.binary import save_coo_binary
from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.stream import BinaryChunkReader as JReader
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.learners.vb_online import OVBLearner as JOVBLearner
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SweepPlan
from svbfm_tpu_torch.kernels import ovb_sweep as ko
from svbfm_tpu_torch.kernels.vb_sweep import vb_build_qt_plain
from svbfm_tpu_torch.learners.base import build_plan_data
from svbfm_tpu_torch.parallel.mesh import make_mesh as port_mesh
from torch_tp_ranks import (OVB_FIELDS, dp_ovb_ranks, dp_ovb_run, dp_setup,
                            run_ranks)

from oracle import OVBOracle

NUM_ITER = 2
OVB = dict(num_rows=120, num_batches=3)
CASES = {
    "factor_block=1": dict(OVB, factor_block=1),
    "factor_block=4": dict(OVB, K=8, factor_block=4),
    "reshuffle": dict(OVB, factor_block=1, reshuffle=True),
    "task_c": dict(OVB, num_rows=160, task=1, factor_block=1),
    # 10 train rows in two chunks of 5, each padded to 8 over four ranks
    # (two rows a rank): rank 3 holds padding alone in every chunk, and of
    # the 5 test rows
    "padding_rank": dict(num_rows=15, num_users=4, num_items=3, K=2,
                         num_batches=2, factor_block=1),
}
STREAM = dict(num_rows=200, num_batches=3, factor_block=1)
# factor_block 1 with the row quantum padding from the first row: the test
# rows padded to 2 x 16,384, each chunk still to its common n_chunk alone
QUANTUM = dict(CASES["factor_block=1"], quantum_from=0)
CKPT = dict(num_rows=128, seed=5, num_batches=4, factor_block=1)
NATURALS = ("n_mu_0", "n_sig_0", "n_mu_w", "n_sig_w", "n_mu_v", "n_sig_v")
COUNTERS = ("t_w0", "t_wj", "t_vj")


def _jax_recipe(num_rows=96, num_users=9, num_items=7, K=3, seed=2, task=0,
                **cfg_kw):
    """``dp_setup``'s recipe through the JAX package: (cfg, train coo, test
    coo, meta, D)."""
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
    meta = JMeta.from_field_offsets(D, [0, num_users])
    cfg = JConfig(num_attributes=D, num_factor=K, task=task,
                  min_target=float(tr.target.min()),
                  max_target=float(tr.target.max()),
                  num_groups=meta.num_attr_groups, seed=7, **cfg_kw)
    return cfg, tr, te, meta, D


def _host(state) -> dict:
    s = jax.device_get(state)
    return {k: np.asarray(getattr(s, k)) for k in OVB_FIELDS}


def _jax_run(d, name, setup, n_dev, stream=""):
    """The JAX learner on ``make_mesh(n_dev)``: its init saved as npz, its
    history, final state and test scores."""
    cfg, tr, te, meta, D = _jax_recipe(**setup)
    test = JDataset.from_coo(te, D)
    if stream:
        jl = JOVBLearner.from_reader(
            cfg, JReader(stream + ".x", stream + ".y"), test, meta,
            mesh=make_mesh(n_dev), write_files=False,
            cache_dir=str(d / f"{name}_plans"))
    else:
        jl = JOVBLearner(cfg, JDataset.from_coo(tr, D), test, meta,
                         mesh=make_mesh(n_dev), write_files=False)
    s0 = jl.init_state()
    path = str(d / f"{name}.npz")
    init = _host(s0)  # the run donates the state
    np.savez(path, **init)
    s, h = jl.run(s0, num_iter=NUM_ITER, verbose=False)
    return dict(path=path, init=init, hist=h, final=_host(s),
                preds=np.asarray(jl.predict_test_scores(s)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runs, the port's on one device from the same inits, the
    port's on four ranks (one spawn, the last run resuming the checkpoint
    that two ranks wrote) and on two ranks (streamed, and the checkpoint's
    first epochs)."""
    d = tmp_path_factory.mktemp("dp_ovb")
    jax_out = {name: _jax_run(d, name, setup, 4)
               for name, setup in CASES.items()}
    one = {name: dp_ovb_run(None, setup, NUM_ITER, jax_out[name]["path"])
           for name, setup in CASES.items()}
    prefix = str(d / "tr")
    _, tr, _, _, _ = _jax_recipe(**STREAM)
    save_coo_binary(prefix, tr)
    jax_out["stream"] = _jax_run(d, "stream", STREAM, 2, prefix)
    ck = d / "ck"
    two = run_ranks(dp_ovb_ranks, 2, d / "two", timeout=150, runs=[
        ("stream", STREAM, NUM_ITER, jax_out["stream"]["path"], "", 100,
         prefix),
        ("first", CKPT, 2, "", str(ck), 2, ""),
        ("quantum", QUANTUM, NUM_ITER, jax_out["factor_block=1"]["path"],
         "", 100, ""),
        ("plain", CASES["factor_block=1"], NUM_ITER,
         jax_out["factor_block=1"]["path"], "", 100, "")])
    for n in ("1", "4"):
        shutil.copytree(ck, d / f"ck{n}")
    four = run_ranks(dp_ovb_ranks, 4, d / "four", timeout=150, runs=[
        (name, setup, NUM_ITER, jax_out[name]["path"], "", 100, "")
        for name, setup in CASES.items()] + [
        ("full", CKPT, 4, "", "", 100, ""),
        ("resumed", CKPT, 4, "", str(d / "ck4"), 100, "")])
    resumed_one = dp_ovb_run(port_mesh(device="cpu"), CKPT, 4,
                             ckpt=str(d / "ck1"))
    return dict(jax=jax_out, one=one, two=two, four=four,
                resumed_one=resumed_one)


def _metric_keys(rec):
    return [k for k in ("rmse", "mae", "accuracy", "loglik", "free_energy")
            if k in rec]


def _close_to_jax(got, ref):
    assert len(got["hist"]) == len(ref["hist"]) == NUM_ITER
    for a, b in zip(got["hist"], ref["hist"]):
        for k in _metric_keys(b):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    for k in OVB_FIELDS:
        g, r = got["final"][k], ref["final"][k]
        if k in COUNTERS:
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k in NATURALS:
            np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["preds"], ref["preds"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_ovb_matches_jax_on_four_devices(runs, case):
    _close_to_jax(runs["four"][0][case], runs["jax"][case])


def test_dp_ovb_streamed_matches_jax_on_two_devices(runs):
    """``OVBLearner.from_reader(mesh=)`` on two ranks (each reading every
    chunk window, padding it to the common row count and keeping its
    block, its plans in a folder of its own) against the JAX learner
    streaming the same file on ``make_mesh(2)``; both ranks the same."""
    two = runs["two"]
    _close_to_jax(two[0]["stream"], runs["jax"]["stream"])
    for a, b in zip(two[1]["stream"]["chunks"], two[0]["stream"]["chunks"]):
        for k in OVB_FIELDS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dp_ovb_row_quantum_pads_the_test_rows_alone(runs):
    """On the row quantum padding's path (2M rows or more; here from the
    first row) two ranks still cut each chunk at n_chunk / 2, as the plan
    built over n_chunk rows expects: the state after every chunk is the
    two ranks' run off that path bit for bit on both ranks (only the test
    rows' padding differs), the metrics within f32 of it, and the run
    agrees with the JAX learner."""
    two = runs["two"]
    got, plain = two[0]["quantum"], two[0]["plain"]
    _close_to_jax(got, runs["jax"]["factor_block=1"])
    assert len(got["chunks"]) == len(plain["chunks"]) > 0
    for rank in two:
        for a, b in zip(rank["quantum"]["chunks"], plain["chunks"]):
            for k in OVB_FIELDS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(got["hist"], plain["hist"]):
        for k in _metric_keys(b):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["preds"], plain["preds"])


@pytest.mark.parametrize("case", list(CASES))
def test_dp_ovb_matches_one_device(runs, case):
    one, got = runs["one"][case], runs["four"][0][case]
    assert len(got["chunks"]) == len(one["chunks"]) > 0
    for a, b in zip(got["chunks"], one["chunks"]):
        for k in OVB_FIELDS:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for a, b in zip(got["hist"], one["hist"]):
        for k in _metric_keys(b):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["preds"], one["preds"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", list(CASES) + ["full", "resumed"])
def test_dp_ovb_ranks_hold_the_same_bits(runs, case):
    """Every rank's state equals rank 0's bit for bit after every chunk,
    and every rank saw the same metrics."""
    four = runs["four"]
    assert len(four) == 4
    for r in four[1:]:
        assert len(r[case]["chunks"]) == len(four[0][case]["chunks"]) > 0
        for a, b in zip(r[case]["chunks"], four[0][case]["chunks"]):
            for k in OVB_FIELDS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for a, b in zip(r[case]["hist"], four[0][case]["hist"]):
            for k in _metric_keys(b):
                assert a[k] == b[k], k


def test_dp_ovb_factor_block_1_matches_the_oracle(runs):
    """factor_block 1 on four ranks against the float64 serial oracle from
    the same init, chunk membership and epoch order, after every epoch
    (test_vb_online.py:60-67's tolerances)."""
    setup = CASES["factor_block=1"]
    cfg, tr, _, meta, D = dp_setup(**setup)
    init = runs["jax"]["factor_block=1"]["init"]
    coo = tr.to_coo()
    orc = OVBOracle(coo.row, coo.col, coo.val, coo.target, D,
                    cfg.num_factor, tr.col_count(), tr.num_rows,
                    groups=meta.attr_group)
    orc.init(float(init["mu_0"]), float(init["sigma_0_dash"]),
             init["mu_w"], init["sigma_w_dash"], init["mu_v"],
             init["sigma_v_dash"])
    perm = np.random.default_rng(cfg.seed).permutation(tr.num_rows)
    members = np.array_split(perm, cfg.num_batches)
    order_rng = np.random.default_rng(cfg.seed + 1)
    chunks = runs["four"][0]["factor_block=1"]["chunks"]
    for epoch in range(NUM_ITER):
        for ci in order_rng.permutation(cfg.num_batches):
            orc.chunk_update(members[ci])
        st = chunks[(epoch + 1) * cfg.num_batches - 1]
        np.testing.assert_allclose(float(st["mu_0"]), orc.mu_0, rtol=3e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(st["mu_w"], orc.mu_w, rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(st["mu_v"], orc.mu_v, rtol=5e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(st["sigma_w_dash"], orc.sigma_w_dash,
                                   rtol=5e-3, atol=1e-5)
        np.testing.assert_allclose(float(st["alpha"]), orc.alpha, rtol=5e-3)
        np.testing.assert_allclose(st["t_wj"], orc.t_wj)
        np.testing.assert_allclose(st["t_vj"], orc.t_vj)


@pytest.mark.parametrize("where", ["one_rank", "four_ranks"])
def test_dp_ovb_checkpoint_resumes_on_another_number_of_ranks(runs, where):
    """Two epochs on two ranks save a checkpoint (the replicated state,
    written by rank 0); a world of one and four ranks resume it to four
    epochs, the last two as the uninterrupted four-rank run's."""
    first = runs["two"][0]["first"]
    full = runs["four"][0]["full"]
    res = runs["resumed_one"] if where == "one_rank" \
        else runs["four"][0]["resumed"]
    assert [h["iter"] for h in first["hist"]] == [0, 1]
    assert [h["iter"] for h in res["hist"]] == [2, 3]
    for a, b in zip(res["hist"], full["hist"][2:]):
        for k in ("rmse", "mae", "free_energy"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    for k in OVB_FIELDS:
        np.testing.assert_allclose(res["final"][k], full["final"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(res["preds"], full["preds"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("F", [1, 4, 20])
def test_t13_twins_split_over_two_shards_match_k6(F):
    """T13's stats twin on each of two row shards of a ragged bin (a chunk
    plan built for two shards: shard-local rows, x = 0 pad slots), summed,
    then its blend twin, against K6's twin on the whole bin; the stats'
    shards sum to the whole bin's sums."""
    cfg, tr, _, meta, D = dp_setup(num_rows=300, num_users=23, num_items=17,
                                   K=F)
    gen = torch.Generator().manual_seed(F)
    N = tr.num_rows
    n_pad = -(-N // 2) * 2
    ds = tr.padded_to(n_pad)
    ids, vals = (torch.from_numpy(a.copy()) for a in (ds.ids, ds.vals))
    e = torch.randn(n_pad, generator=gen)
    e[N:] = 0.0
    ptab = torch.zeros(D, 5 * F)
    ptab[:, :F] = 0.1 * torch.randn(D, F, generator=gen)
    ptab[:, F:2 * F] = 0.01 + 0.02 * torch.rand(D, F, generator=gen)
    q, tq, _ = vb_build_qt_plain(ptab, F, ids, vals)
    coo, cc = tr.to_coo(), tr.col_count()
    whole = build_plan_data(SweepPlan.build(
        coo, D, meta_groups=meta.attr_group, col_count=cc), meta, "cpu")
    split = SweepPlan.build(coo, D, meta_groups=meta.attr_group,
                            col_count=cc, n_shards=2, n_rows_total=n_pad)
    tabs = [0.1 * torch.randn(D, F, generator=gen),
            0.01 + 0.02 * torch.rand(D, F, generator=gen),
            torch.randn(D, F, generator=gen),
            50.0 + torch.rand(D, F, generator=gen)]
    sv = 1.0 + torch.rand(meta.num_attr_groups, F, generator=gen)
    alpha = torch.tensor(1.7)
    rho_v = 0.2 + 0.5 * torch.rand(D, generator=gen)
    half = n_pad // 2
    assert len(whole.blocks) == len(split.blocks) > 1
    for b, bb in enumerate(whole.blocks):
        plan = ko.BinPlan(bb)
        shards = [ko.BinPlan([dict_block(blk, s) for blk in split.blocks[b]])
                  for s in range(2)]
        sums = sum(ko.dp_ovb_stats_plain(
            shards[s], D, e[s * half:(s + 1) * half],
            q[s * half:(s + 1) * half], tq[s * half:(s + 1) * half], ptab)
            for s in range(2))
        # the column sums, whatever the buckets' order in the two plans
        by_col = torch.zeros(D, 2 * F)
        by_col[torch.cat([blk.cols for blk in shards[0].buckets]).long()] \
            = sums
        ref = torch.zeros(D, 2 * F)
        ref[torch.cat([blk.cols for blk in bb]).long()] = \
            ko.dp_ovb_stats_plain(plan, D, e, q, tq, ptab)
        np.testing.assert_allclose(by_col.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6)
        want = [t.clone() for t in tabs] + [ptab.clone(), torch.zeros(D),
                                            torch.zeros(4, dtype=torch.int32)]
        got = [t.clone() for t in tabs] + [ptab.clone(), torch.zeros(D),
                                           torch.zeros(4, dtype=torch.int32)]
        ko.ovb_bin_update_plain(plan, e, q, tq, want[4], *want[:4], sv,
                                alpha, rho_v, want[5], want[6])
        ko.dp_ovb_blend_plain(shards[0], D, sums, got[4], *got[:4], sv,
                              alpha, rho_v, got[5], got[6])
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6)


def dict_block(blk, s):
    """Shard ``s``'s slice of a plan's bucket as the device bundle."""
    from svbfm_tpu_torch.learners.base import BlockData

    return BlockData(*(torch.from_numpy(a.copy()) for a in (
        blk.rows[s], blk.x[s], blk.cols, blk.group, blk.sx2, blk.cnt,
        blk.col_count)))
