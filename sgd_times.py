"""Time the SGD family's kernels X9a and X9c on the card, and profile an SGD
epoch and an SGDA iteration, for one checkout.

    python3 sgd_times.py [--tree DIR] [--label NAME]

Runs the kernels and learners of the checkout at ``--tree`` (default: the
one holding this script) on the inputs ``chip_smoke.py`` (of this
script's checkout) gives them at the ML-1M recipe, K = 20: X9a on a batch
of 1,024 rows in the regression, exponential-family and SGDA modes and on
BPR's batch of 11,063 pairs; X9c on SGDA's validation batch of 113 rows
(G = 2), at K = 8, and on 1,000 rows.  Prints the card, the launch floor
(a graph replay of a one-element ``zero_()``), for each case the least and
the most of three means of a CUDA graph replay of 20 calls, then
``chip_smoke.profile_run`` of one SGD epoch (X9a's share) and one SGDA
iteration with its lambda steps (X9c's share).  The data comes from
seeded generators, so two checkouts get the same inputs.  To hold a change
against its parent, run it on both in one call, in turns (parent, change,
change, parent), the parent unpacked with ``git archive`` into a
git-ignored directory.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sgd_times: needs an NVIDIA GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.synth import train_test_split
    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.kernels import sgd_step as ks
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.bpr import BPRLearner
    from svbfm_tpu_torch.learners.exp_sgd import ExpSGDStocLearner
    from svbfm_tpu_torch.learners.sgd import SGDALearner, SGDLearner

    tag = a.label or os.path.basename(os.path.abspath(a.tree))
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"[{tag}] {cs.card_line()} tree={os.path.abspath(a.tree)}",
          flush=True)
    build.build_all()

    def spread(fn):
        return [cs.cuda_ms(fn, 20) for _ in range(3)]

    def line(label, times):
        print(f"[{tag}] {label}: ms={min(times):.4f}-{max(times):.4f}",
              flush=True)

    one = torch.zeros(1, device=dev)
    line("launch floor (zero_ of one element)", spread(one.zero_))

    tr, te, train, test, meta = cs.ml_data(cs.NUM_TRAIN)
    D = tr.num_features
    base = dict(num_attributes=D, num_factor=cs.K,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()),
                num_groups=meta.num_attr_groups, seed=cs.SEED)
    cfg = FMConfig(factor_block=0, **base)
    sgd = SGDLearner(cfg, train, test, meta, device=dev, write_files=False)
    exp = ExpSGDStocLearner(cfg, train, test, meta, device=dev,
                            write_files=False)
    tr90, va10 = (SparseDataset.from_coo(c, D)
                  for c in train_test_split(tr, 0.1, seed=cs.SEED))
    sgda = SGDALearner(FMConfig(learn_rate=cs.SGDA_LR, **base), tr90, test,
                       va10, meta, device=dev, write_files=False)
    bpr = BPRLearner(FMConfig(learn_rate=cs.BPR_LR, **base),
                     SparseDataset.from_coo(cs.positives(tr), D),
                     SparseDataset.from_coo(cs.positives(te), D), meta,
                     device=dev, write_files=False)
    g = cs.sgd_tensors(sgd, exp, sgda, bpr, dev)["sgd"]
    G = g["reg_w"].shape[0]
    # the workspace of either checkout's API (before X9c's cluster, its
    # lambda sums and counter took the groups' count)
    by_groups = "G" in inspect.signature(ks.make_workspace).parameters

    def workspace(K, sgda_batch=None):
        return ks.make_workspace(D, K, dev, sgda_batch=sgda_batch,
                                 **({"G": G} if by_groups else {}))

    tab, w0 = g["tab"], g["w0"]
    for label, m, kind, batch in g["modes"]:
        ids, vals, y, valid = batch[:4]
        ws = workspace(cs.K, ids.shape if kind == "sgda" else None)
        pair = (batch[4], *g["range"]) if kind == "pair" else None
        line(f"X9a {label} B={ids.shape[0]}", spread(
            lambda: ks.sgd_grad_scatter(tab, w0, ids, vals, y, valid, ws, m,
                                        pair, record=kind == "sgda")))
    sgda_mode = g["modes"][2][1]
    for tab_v, grad_tab, reg_v, val, m in [
            (tab, g["grad_tab"], g["reg_v"], g["val"], sgda_mode),
            *g["lambda_more"]]:
        ws = workspace(m.K, (1, 1))
        rw, rv = g["reg_w"].clone(), reg_v.clone()
        line(f"X9c Bv={val[0].shape[0]} G={G} K={m.K}", spread(
            lambda: ks.sgda_lambda(tab_v, grad_tab, w0, rw, rv,
                                   g["attr_group"], *val, ws, m)))

    sstate, _ = sgd.run(num_iter=1, verbose=False)
    cs.profile_run(lambda: sgd.run(sstate, num_iter=1, verbose=False), 1,
                   "epoch", f"{tag} sgd-profile", focus="sgd_grad_scatter")
    astate, _ = sgda.run(num_iter=2, verbose=False)
    sgda.epoch(astate, 1)
    cs.profile_run(lambda: sgda.epoch(astate, 1), 1, "iteration",
                   f"{tag} sgda-profile", focus="sgda_lambda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
