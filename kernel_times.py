"""Time one family of the port's kernels on the card and profile the paths
that launch them, for one checkout.

    python3 kernel_times.py {bs,forward,mcmc,probit,sass,sgd,stream,w,win} [--tree DIR] [--label NAME]

Runs the kernels and learners of the checkout at ``--tree`` (default: the
one holding this script) on the inputs ``chip_smoke.py`` (of this script's
checkout) gives them, K = 20.  The data comes from seeded generators, so
two checkouts get the same inputs.  Prints the card, the launch floor (a
graph replay of a one-element ``zero_()``), the ptxas lines of the timed
kernels, for each case the least and the most of three means of a CUDA
graph replay of 20 calls, then the family's profiles:

- ``bs``: the block-structure sampler's join aggregation X10a (F = 20,
  the w sweep's F = 0, F = 1 and, in its block form, F = 33, 64, 128 and
  251, the widest the learners give it), its
  relation-row patch X10c (F = 20, F = 1 and the w mode, after each timed
  bin), its data-row resync (X10d: full, q-build and w forms), its
  relation-row moments (X10d, K = 20) and its joined scores (X10d,
  ``bs_scores``: the 1M train rows and the 100k test rows with two
  relations, and nine relations) on the 1M-rating relational recipe
  (``scripts/bench_bs.py``), for the users and the items relation, each
  with its form (the scores' moments stride among it); their launches in
  one sweep of each BS path; and ``chip_smoke.profile_run`` of one blocked
  Gibbs sweep, of one factor-sequential sweep (factor_block 1) and of one
  blocked sweep at K = 64 (``bs-k64``: X10a's block form at F = 64), twice
  each, with X10a's, X10c's, the resync's, the moments' and
  ``bs_scores``' device time and share (``fm_rows``: K1a's kernel in its
  relations mode).
- ``forward``: K1a (the FM score) on the 1,000,022 train rows of the
  ML-1M recipe (``bench.py``; the Gibbs/ALS/exp_sgd re-score), the 99,978
  test rows (every path's eval), OVB's first chunk of 50,002 rows, and the
  test rows on the SGD family's own [D, 1+K] table; K1b (the T-terms) on
  the train rows (VB's init) and the OVB chunk; each on the tables the
  checkout's ``ops/forward.py`` builds from seeded parameters, with its
  form; K2 (``vb_build_qt``) at F = 20 on VB's fast-mode table, at F = 1
  on exact mode's over the train rows and over OVB's first chunk, and X8d
  (``build_q``) at F = 20 on the Gibbs table and at F = 1 (factor_block
  1), each with its form; and ``profile_run`` of one Gibbs sweep, one VB
  fast-mode sweep and one OVB epoch, twice each, with K1's and K2's (or
  X8d's) device time and share.
- ``mcmc``: X8a at F = 1 on every degree bucket of the ML-1M recipe
  (``bench.py``), in the Gibbs draw mode (with a noise table) and in
  exp_sgd's gradient mode, each with its form; X8b at F = 20 on the
  patch table as each of the two bins leaves it, with its form; and
  ``profile_run`` of one Gibbs sweep at factor_block 0 (X8a's and X8b's
  device time) and one at factor_block 1 (X8a's), twice each.
- ``probit``: X12a in its VB, ALS and Gibbs modes on the 1,000,022 train
  rows of the ML-1M recipe and X12b on its 99,978 test rows (VB's eval,
  and Gibbs's at iteration 6 with its accumulators), the inputs
  ``chip_smoke.probit_tensors`` makes, each with its grid.  X12a is timed
  twice: the replay of 20 calls on one e, each reading the one before's
  output (in the ALS mode e drifts to -+Inf), and the path's single
  application, each call on its own fresh copy of e (``fresh_ms``).  The
  first tree run in a checkout saves these inputs
  (``build/probit_outputs/inputs.pt``) and every later one reads them.
  The outputs of one application of each (X12a on a fresh copy, X12b's
  [4] and accumulators) go to ``build/probit_outputs/<label>.pt``; against
  every other label's file there (a tree run before in the same
  checkout) it prints the count of X12a's output words whose bits differ
  and X12b's largest relative difference.  Then ``profile_run`` of one
  sweep of classification VB (exact mode), Gibbs, ALS (``-regular`` 5)
  and block-structure Gibbs on the recipes binarised as ``chip_smoke``'s
  class phases do, twice each, with X12a's and X12b's device time and
  share (``probit``).
- ``sgd``: X9a on a batch of 1,024 rows of the ML-1M recipe in the
  regression, exponential-family and SGDA modes and on BPR's batch of
  11,063 pairs; X9c on SGDA's validation batch of 113 rows (G = 2), at
  K = 8, and on 1,000 rows; ``profile_run`` of one SGD epoch (X9a's share)
  and one SGDA iteration with its lambda steps (X9c's share).
- ``w``: K5 on each bin of the ML-1M recipe in each of its modes (batch
  VB, the Gibbs draw with a noise table, ALS's mean, exp_sgd's gradient
  step), and in the online mode on both bins of OVB's first chunk, each
  bin in one launch and each bucket alone, with its form (lanes a column
  a bucket); an older tree, which launches K5 once a
  bucket, runs its per-bucket launches in turn for a bin.  P1 on
  ``chip_smoke.gather_sets`` with ``torch.take`` or ``take_along_dim``
  beside it.  Then K5's launches in one sweep of exact VB, Gibbs and
  exp_sgd and one OVB epoch, and ``profile_run`` of each, twice, with
  K5's device time and share.

- ``win``: the windowed paths' column kernels on the ML-1M recipe at
  factor_block 4, 4 windows (``chip_smoke.WIN_CACHE_BYTES``): X13a (K3's
  window mode) at F = 4 and F = 1 and X14a (X8a's) at F = 4 and F = 1,
  each on the user bin's largest window bucket, one launch of the last
  window and one of the first; the resident shapes their forms share: X8a's
  exact mode and K3 at F = 4 on every bucket of the sweep
  (``chip_smoke.resident4_cases``) and K3 in exact mode (F = 1) on
  ``[14,128]``; each with its form (``form=?`` for a tree without the
  mirrors); then ``profile_run`` of one windowed VB sweep and one windowed
  Gibbs sweep, twice each, with the column kernels' device time and share
  (``col_stats``: X13a; ``col_draw``: X14a).
- ``sass``: no timing and no card: every CUDA library of ``--tree`` and
  of this checkout compiled to a cubin (the build's nvcc flags) and
  disassembled by ``cuobjdump -sass``; for each kernel of ``--tree``,
  whether this checkout's build of it is the same instructions (under
  its name or, where it became a template, as one of ``name<...>``, or,
  where its template took one more parameter, as ``name<its arguments,
  ...>``), and the kernels this checkout adds.
- ``stream``: the out-of-core learners' host side: OVB (20 chunks) and
  sgd_online (50 chunks) on the ML-1M recipe written as binary files,
  four epochs each (the first is a warm-up) in memory and streamed from
  the file with 0 (the reads inline), 1 and 2 reader threads; and the
  serial cost of reading the 20 OVB chunks (rows and cached plans).

To hold a change against its parent, run it on both in one call, in turns
(parent, change, change, parent), the parent unpacked with ``git archive``
into a git-ignored directory.  The inputs and bounds are this script's
``chip_smoke.py``'s, so the other tree must share their layouts (for
``bs``, the (qB | lin | sumsB) moments rows).  Exits non-zero without a
card (``sass``: without nvcc).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# each family's libraries and the kernels of them whose ptxas lines are
# printed (a part of their names)
FAMILIES = {
    "bs": (("bs_sweep", "bs_forward", "fm_forward"),
           ("join_agg", "patch", "resync", "moments", "fm_rows",
            "bs_scores")),
    "forward": (("fm_forward", "vb_sweep"), ("fm_", "build_qt")),
    "mcmc": (("mcmc_sweep",), ("col_draw_f1", "row_patch")),
    "probit": (("probit",), ("probit",)),
    "sass": ((), ()),
    "sgd": (("sgd_step",), ("grad_scatter", "lambda")),
    "w": (("w_sweep", "gather_probe"), ("w_", "gather")),
    "stream": ((), ()),
    "win": (("mcmc_sweep", "vb_sweep"), ("col_draw", "col_stats")),
}
# K5's kernel, by its name in this tree and in one that launches it once a
# bucket
W_FOCUS = ("w_bin_kernel", "w_col_update_kernel")
# X10a's block form is timed at these widths (F > 32) on the K = 20
# learner's join plans, from seeded q and qB0
BS_AGG_WIDTHS = (33, 64, 128, 251)
# the bs family's timed kernels, by their wrappers' launch-count names
BS_TIMED = ("bs_join_agg", "bs_rel_patch", "bs_rel_w_patch", "bs_resync",
            "bs_rel_moments", "bs_scores")
# a part of the names of X8a's kernels and of X8b's (in an older tree
# patch_rows_kernel<32> at F >= 2, patch_rows_kernel<1> at F = 1)
GIBBS_FOCUS = ("col_draw", "row_patch", "patch_rows_kernel<32>",
               "patch_rows_kernel<1>")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("family", choices=sorted(FAMILIES))
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    if a.family == "sass":
        return sass_family(os.path.abspath(a.tree))
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs an NVIDIA GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from svbfm_tpu_torch.kernels import build

    tag = a.label or os.path.basename(os.path.abspath(a.tree))
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"[{tag}] {cs.card_line()} tree={os.path.abspath(a.tree)}",
          flush=True)
    build.build_all()
    libs, fns = FAMILIES[a.family]
    for name in libs:
        fn = "?"
        for ln in build.build_logs.get(name, "").splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1]
            elif ("registers" in ln or "spill" in ln) and any(
                    k in fn for k in fns):
                print(f"[{tag}] ptxas {name} {fn}: {ln.strip()}")

    def line(label, fn):
        times = [cs.cuda_ms(fn, 20) for _ in range(3)]
        print(f"[{tag}] {label}: ms={min(times):.4f}-{max(times):.4f}",
              flush=True)

    one = torch.zeros(1, device=dev)
    line("launch floor (zero_ of one element)", one.zero_)
    family = {"bs": bs_family, "forward": forward_family,
              "mcmc": mcmc_family, "probit": probit_family,
              "sgd": sgd_family, "w": w_family, "stream": stream_family,
              "win": win_family}
    family[a.family](cs, build, dev, tag, line)
    return 0


def sass_family(tree: str) -> int:
    """See the module docstring: this checkout's SASS beside ``tree``'s."""
    import re
    import subprocess
    import tempfile

    sys.path.insert(0, HERE)
    from svbfm_tpu_torch.kernels import build

    nvcc = build._nvcc()
    objdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    drop = {"-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"))

    def kernels(root, lib):
        """{kernel name: its instructions} of ``root``'s csrc/<lib>.cu."""
        src = os.path.join(root, "svbfm_tpu_torch", "csrc", f"{lib}.cu")
        if not os.path.exists(src):
            return {}
        out = os.path.join(work.name, "k.cubin")
        flags = [f for f in build._flags(lib) if f not in drop]
        subprocess.run([nvcc, *flags, "-cubin", "-o", out, src], check=True)
        txt = subprocess.run([objdump, "-sass", out], check=True,
                             capture_output=True, text=True).stdout
        funcs, name = {}, None
        for ln in txt.splitlines():
            m = re.match(r"\s*Function : (\S+)", ln)
            if m:
                name = subprocess.run(["c++filt", m.group(1)],
                                      capture_output=True, text=True
                                      ).stdout.strip()
                name = re.sub(r"^void ", "", name.replace(
                    "(anonymous namespace)::", "")).split("(")[0]
                funcs[name] = []
            elif name:  # the instruction, without addresses and encodings
                ins = re.sub(r"/\*.*?\*/", "", ln.split(";")[0]).strip()
                if ins:
                    funcs[name].append(ins)
        return funcs

    with work:
        for lib in build.LIBRARIES:
            old, new = kernels(tree, lib), kernels(HERE, lib)
            matched = set()
            for k, v in sorted(old.items()):
                # the same name; a function become a template; a template
                # given one more parameter (k's arguments, then more)
                hit = [n for n in new if (n == k or n.startswith(f"{k}<") or (
                    k.endswith(">") and n.startswith(f"{k[:-1]}, ")))
                       and new[n] == v]
                matched.update(hit[:1])
                print(f"[sass] {lib} {k}: "
                      f"{'same as ' + hit[0] if hit else 'DIFFERENT'} "
                      f"({len(v)} instructions)", flush=True)
            print(f"[sass] {lib} new: "
                  f"{sorted(n for n in new if n not in set(old) | matched)}",
                  flush=True)
    return 0


def bs_family(cs, build, dev, tag, line) -> None:
    import torch

    bsp = cs.bs_problem(cs.BS_ROWS, cs.BS_SLOTS, holdout=False)
    bs = cs.bs_learner(bsp, dev, num_factor=cs.K, regw=cs.BS_REG,
                       regv=cs.BS_REG)
    st, _ = bs.step(bs.init_state())
    s = cs.bs_tensors(bs, st, "bs", True, (cs.K, 0, 1),
                      agg_widths=BS_AGG_WIDTHS)
    cases = cs.make_cases(s)
    for name in BS_TIMED:
        for label, prepare, call, c in cases[name]:
            inp = prepare()
            line(f"{name} {label} {c['note']}".rstrip(),
                 lambda: call("kernel", inp))
    del s, cases

    seq = cs.bs_learner(bsp, dev, num_factor=cs.K, regw=cs.BS_REG,
                        regv=cs.BS_REG, factor_block=1)
    k64 = cs.bs_learner(bsp, dev, num_factor=cs.BS_K64, regw=cs.BS_REG,
                        regv=cs.BS_REG)
    for path, lr in (("bs", bs), ("bs-seq", seq), ("bs-k64", k64)):
        state, _ = lr.run(num_iter=1, verbose=False)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        lr.run(state, num_iter=1, verbose=False)
        torch.cuda.synchronize()
        counts = {k: build.launch_counts[k] for k in BS_TIMED}
        print(f"[{tag}] {path} launches a sweep: "
              f"{json.dumps(counts, separators=(',', ':'))}", flush=True)
        for _ in range(2):
            cs.profile_run(lambda: lr.run(state, num_iter=1, verbose=False),
                           1, "sweep", f"{tag} {path}-profile",
                           focus=cs.BS_FOCUS)


def forward_family(cs, build, dev, tag, line) -> None:
    import numpy as np
    import torch

    from svbfm_tpu_torch.kernels import fm_forward as k1
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.mcmc import MCMCLearner
    from svbfm_tpu_torch.learners.vb import VBLearner
    from svbfm_tpu_torch.learners.vb_online import OVBLearner
    from svbfm_tpu_torch.ops import forward as fwd

    tr, te, train, test, meta = cs.ml_data(cs.NUM_TRAIN)
    D, K = tr.num_features, cs.K
    base = dict(num_attributes=D, num_factor=K,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()),
                num_groups=meta.num_attr_groups, seed=cs.SEED)
    gibbs = MCMCLearner(FMConfig(factor_block=0, **base), train, test, meta,
                        device=dev, write_files=False)
    vb = VBLearner(FMConfig(factor_block=0, **base), train, test, meta,
                   device=dev, write_files=False)
    ovb = OVBLearner(FMConfig(num_batches=cs.OVB_CHUNKS, **base), train,
                     test, meta, device=dev, write_files=False)
    rng = np.random.default_rng(cs.SEED)

    def t(*shape, lo=None):
        a = (rng.uniform(lo, 2 * lo, shape) if lo else
             rng.normal(0, 0.3, shape))
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    w, v, sw, sv = t(D), t(K, D), t(D, lo=0.01), t(K, D, lo=0.01)
    if hasattr(fwd, "score_table"):  # the padded tables
        stab, ttab = fwd.score_table(w, v), fwd.t_term_table(sw, v, sv)
    else:
        stab = torch.cat([w[:, None], v.T], 1).contiguous()
        ttab = torch.cat([sw[:, None], v.T, sv.T], 1).contiguous()
    sgd_tab = torch.cat([w[:, None], v.T], 1).contiguous()
    w0 = torch.tensor(0.3, device=dev)
    s0 = torch.tensor(0.02, device=dev)
    chunk = ovb.chunks[0][0]
    for name, op, tab, scalar, label, row in (
            ("K1a", k1.fm_scores_op, stab, w0, "train", gibbs.train_row),
            ("K1a", k1.fm_scores_op, stab, w0, "eval", gibbs.test_row),
            ("K1a", k1.fm_scores_op, stab, w0, "ovb-chunk", chunk),
            ("K1a", k1.fm_scores_op, sgd_tab, w0, "sgd-table eval",
             gibbs.test_row),
            ("K1b", k1.fm_t_terms_op, ttab, s0, "train", gibbs.train_row),
            ("K1b", k1.fm_t_terms_op, ttab, s0, "ovb-chunk", chunk)):
        N, P = row.ids.shape
        note = cs.plan_note(k1, "fm_plan", (tab, K, P),
                            ("vec", "lanes", "rows", "build"))
        line(f"{name} {label} N={N} stride={tab.stride(0)} {note}",
             lambda: op(tab, scalar, row.ids, row.vals))

    # K2 on VB's fast-mode table [D, 5F + 2], on exact mode's [D, 5] over
    # the train rows and over OVB's first chunk; X8d on the Gibbs table
    # [D, 2F] and at factor_block 1 on v_f [D, 1]
    mu, sig = t(D, K), t(D, K, lo=0.01)
    fast = torch.zeros(D, 5 * K + 2, device=dev)
    fast[:, :K], fast[:, K:2 * K] = mu, sig
    exact = torch.zeros(D, 5, device=dev)
    exact[:, 0], exact[:, 1] = mu[:, 0], sig[:, 0]
    gtab = torch.cat([mu, torch.zeros_like(mu)], 1)
    vf = mu[:, :1].contiguous()
    train = gibbs.train_row
    for name, fn, ptab, F, label, row in (
            ("K2", kv.vb_build_qt, fast, K, "vb-fast", train),
            ("K2", kv.vb_build_qt, exact, 1, "exact", train),
            ("K2", kv.vb_build_qt, exact, 1, "ovb-chunk", chunk),
            ("X8d", kv.build_q, gtab, K, "gibbs", train),
            ("X8d", kv.build_q, vf, 1, "factor_block 1", train)):
        N = row.ids.shape[0]
        note = cs.plan_note(kv, "qt_plan_of", (ptab, F, row.ids, row.vals),
                            ("form", "vec", "lanes", "rows", "build"))
        line(f"{name} {label} F={F} N={N} stride={ptab.stride(0)} {note}",
             lambda: fn(ptab, F, row.ids, row.vals))

    for path, lr, unit in (("mcmc", gibbs, "sweep"), ("vb", vb, "sweep"),
                           ("ovb", ovb, "epoch")):
        state, _ = lr.run(num_iter=1, verbose=False)
        for _ in range(2):
            cs.profile_run(lambda: lr.run(state, num_iter=1, verbose=False),
                           1, unit, f"{tag} {path}-profile",
                           focus=("fm_", "build_qt"))


def mcmc_family(cs, build, dev, tag, line) -> None:
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.exp_sgd import ExpSGDLearner
    from svbfm_tpu_torch.learners.mcmc import MCMCLearner

    tr, te, train, test, meta = cs.ml_data(cs.NUM_TRAIN)
    base = dict(num_attributes=tr.num_features, num_factor=cs.K,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()),
                num_groups=meta.num_attr_groups, seed=cs.SEED)
    gibbs = MCMCLearner(FMConfig(factor_block=0, **base), train, test, meta,
                        device=dev, write_files=False)
    exp = ExpSGDLearner(FMConfig(learn_rate=cs.EXP_SGD_LR, **base), train,
                        test, meta, device=dev, write_files=False)
    mc1, _ = gibbs.step(gibbs.init_state())
    ms = cs.make_cases(cs.mcmc_tensors(gibbs, mc1))
    xs = cs.make_cases(cs.exp_sgd_tensors(exp, exp.init_state()))
    for cases, name, key in ((ms, "mcmc_col_draw", " F=1 exact+z "),
                             (xs, "mcmc_col_grad", " F=1 "),
                             (ms, "mcmc_patch_rows", f" F={cs.K} ")):
        for label, prepare, call, c in cases[name]:
            if key in f" {label} ":
                inp = prepare()
                line(f"{name} {label} {c['note']}".rstrip(),
                     lambda: call("kernel", inp))
    del mc1, ms, xs

    state, _ = gibbs.run(num_iter=1, verbose=False)
    for _ in range(2):
        cs.profile_run(lambda: gibbs.run(state, num_iter=1, verbose=False), 1,
                       "sweep", f"{tag} mcmc-profile", focus=GIBBS_FOCUS)

    seq = MCMCLearner(FMConfig(factor_block=1, **base), train, test, meta,
                      device=dev, write_files=False)
    state, _ = seq.run(num_iter=1, verbose=False)
    for _ in range(2):
        cs.profile_run(lambda: seq.run(state, num_iter=1, verbose=False), 1,
                       "sweep", f"{tag} mcmc-seq-profile", focus=GIBBS_FOCUS)


def probit_family(cs, build, dev, tag, line) -> None:
    import numpy as np
    import torch

    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.learners.vb import VBLearner

    tr, te, train, test, meta = cs.ml_data(cs.NUM_TRAIN)
    base = dict(num_attributes=tr.num_features, num_factor=cs.K,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()),
                num_groups=meta.num_attr_groups, seed=cs.SEED)
    # the inputs of the first tree run in this checkout, so that every tree
    # reads the same values (a Gibbs sweep's e differs from run to run in
    # its last bits: its sums go by atomics)
    folder = os.path.join(HERE, "build", "probit_outputs")
    os.makedirs(folder, exist_ok=True)
    saved = os.path.join(folder, "inputs.pt")
    if os.path.exists(saved):
        s = torch.load(saved, map_location=dev)
    else:
        gibbs = MCMCLearner(FMConfig(factor_block=0, **base), train, test,
                            meta, device=dev, write_files=False)
        s = cs.probit_tensors(gibbs, gibbs.step(gibbs.init_state())[0])
        torch.save(s, saved)
        del gibbs
    cases = cs.make_cases(s)
    outs = {}
    for name in ("probit_latent", "probit_eval"):
        for label, prepare, call, c in cases[name]:
            text = f"{name} {label} {c['note']}".rstrip()
            if c["fresh"]:
                times = cs.fresh_ms(prepare, lambda i: call("kernel", i), 20,
                                    3)
                print(f"[{tag}] {text}: ms={min(times):.4f}-"
                      f"{max(times):.4f}", flush=True)
            else:
                inp = prepare()
                line(text, lambda: call("kernel", inp))
            if c["fresh"] or name == "probit_eval":
                outs[f"{name} {label}"] = [
                    t.cpu() for t in call("kernel", prepare())]
    del cases, s
    torch.save(outs, os.path.join(folder, f"{tag}.pt"))
    for fn in sorted(os.listdir(folder)):
        other = fn[:-len(".pt")]
        if other in (tag, "inputs") or not fn.endswith(".pt"):
            continue
        theirs = torch.load(os.path.join(folder, fn))
        for key, mine in outs.items():
            if key.startswith("probit_latent"):
                a, b = mine[0].view(torch.int32), theirs[key][0].view(
                    torch.int32)
                print(f"[{tag}] vs {other}: {key}: "
                      f"{int((a != b).sum())} of {a.numel()} output words "
                      "differ in their bits", flush=True)
            else:
                rel = max(float(((x.double() - y.double()).abs()
                                 / y.double().abs().clamp_min(1e-30)).max())
                          for x, y in zip(mine, theirs[key]))
                print(f"[{tag}] vs {other}: {key}: max relative "
                      f"difference {rel:.3e}", flush=True)

    ctr, cte = (cs.binarised(d, cs.CLASS_THRESHOLD) for d in (train, test))
    ccfg = dict(base, task=1, min_target=-1.0, max_target=1.0)
    kw = dict(device=dev, write_files=False)
    bsp = cs.bs_problem(cs.BS_ROWS, cs.BS_SLOTS, holdout=False)
    thr = float(np.median(bsp["train"].target[: bsp["train"].num_rows]))
    bspc = dict(bsp, train=cs.binarised(bsp["train"], thr),
                test=cs.binarised(bsp["test"], thr))
    paths = (
        ("vb-class", lambda: VBLearner(FMConfig(factor_block=1, **ccfg), ctr,
                                       cte, meta, **kw)),
        ("mcmc-class", lambda: MCMCLearner(FMConfig(factor_block=0, **ccfg),
                                           ctr, cte, meta, **kw)),
        ("als-class", lambda: ALSLearner(FMConfig(factor_block=0, **dict(
            ccfg, reg0=cs.ALS_REG, regw=cs.ALS_REG, regv=cs.ALS_REG)), ctr,
            cte, meta, **kw)),
        ("bs-class", lambda: cs.bs_learner(
            bspc, dev, num_factor=cs.K, regw=cs.BS_REG, regv=cs.BS_REG,
            task=1, min_target=-1.0, max_target=1.0)))
    for path, make in paths:
        lr = make()
        state, _ = lr.run(lr.init_state(), num_iter=1, verbose=False)
        for _ in range(2):
            cs.profile_run(lambda: lr.run(state, num_iter=1, verbose=False),
                           1, "sweep", f"{tag} {path}-profile",
                           focus=("probit",))
        del lr, state


def sgd_family(cs, build, dev, tag, line) -> None:
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.synth import train_test_split
    from svbfm_tpu_torch.kernels import sgd_step as ks
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.bpr import BPRLearner
    from svbfm_tpu_torch.learners.exp_sgd import ExpSGDStocLearner
    from svbfm_tpu_torch.learners.sgd import SGDALearner, SGDLearner

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
    tab, w0 = g["tab"], g["w0"]
    for label, m, kind, batch in g["modes"]:
        ids, vals, y, valid = batch[:4]
        ws = ks.make_workspace(D, cs.K, dev, G=G, sgda_batch=(
            ids.shape if kind == "sgda" else None))
        pair = (batch[4], *g["range"]) if kind == "pair" else None
        line(f"X9a {label} B={ids.shape[0]}", lambda: ks.sgd_grad_scatter(
            tab, w0, ids, vals, y, valid, ws, m, pair,
            record=kind == "sgda"))
    sgda_mode = g["modes"][2][1]
    for tab_v, grad_tab, reg_v, val, m, cap in [
            (tab, g["grad_tab"], g["reg_v"], g["val"], sgda_mode, 0),
            *g["lambda_more"]]:
        ws = ks.make_workspace(D, m.K, dev, G=G, sgda_batch=(1, 1))
        rw, rv = g["reg_w"].clone(), reg_v.clone()
        kw = dict(max_blocks=cap) if cap else {}
        line(f"X9c Bv={val[0].shape[0]} G={G} K={m.K}"
             + (f" blocks<={cap}" if cap else ""), lambda: ks.sgda_lambda(
                 tab_v, grad_tab, w0, rw, rv, g["attr_group"], *val, ws, m,
                 **kw))

    sstate, _ = sgd.run(num_iter=1, verbose=False)
    cs.profile_run(lambda: sgd.run(sstate, num_iter=1, verbose=False), 1,
                   "epoch", f"{tag} sgd-profile", focus=("sgd_grad_scatter",))
    astate, _ = sgda.run(num_iter=2, verbose=False)
    sgda.epoch(astate, 1)
    cs.profile_run(lambda: sgda.epoch(astate, 1), 1, "iteration",
                   f"{tag} sgda-profile", focus=("sgda_lambda",))


def bucket_launches(kw) -> None:
    """Give an older tree's ``w_sweep``, which launches K5 once a bucket,
    the bin-level names ``chip_smoke`` calls: each runs the tree's
    per-bucket op (kernel or twin) on the bin's buckets in turn."""
    kw.col_lanes = lambda L: 32  # a warp a column
    for sfx in ("", "_plain"):
        col, draw, step = (getattr(kw, n + sfx) for n in (
            "w_col_update", "mcmc_w_draw", "w_grad_step"))

        def update(bins, e, *a, ovb=None, col=col):
            for b in bins:
                col(b.rows, b.x, b.cols, b.group, b.sx2, e, *a,
                    ovb=None if ovb is None else (b.cnt, b.col_count, *ovb))

        def mcmc(bins, e, *a, draw=draw):
            for b in bins:
                draw(b.rows, b.x, b.cols, b.group, b.sx2, e, *a)

        def grad(bins, e, *a, step=step):
            for b in bins:
                step(b.rows, b.x, b.cols, e, *a)

        setattr(kw, "w_bin_update" + sfx, update)
        setattr(kw, "mcmc_w_bin_draw" + sfx, mcmc)
        setattr(kw, "w_bin_grad_step" + sfx, grad)


def w_family(cs, build, dev, tag, line) -> None:
    import torch

    from svbfm_tpu_torch.kernels import w_sweep as kw
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.exp_sgd import ExpSGDLearner
    from svbfm_tpu_torch.learners.mcmc import MCMCLearner
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
    from svbfm_tpu_torch.learners.vb_online import OVBLearner

    if not hasattr(kw, "w_bin_update"):
        bucket_launches(kw)
    tr, te, train, test, meta = cs.ml_data(cs.NUM_TRAIN)
    base = dict(num_attributes=tr.num_features, num_factor=cs.K,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()),
                num_groups=meta.num_attr_groups, seed=cs.SEED)
    args = (train, test, meta)
    kw_ = dict(device=dev, write_files=False)
    vb = VBLearner(FMConfig(factor_block=1, **base), *args, **kw_)
    ovb = OVBLearner(FMConfig(num_batches=cs.OVB_CHUNKS, **base), *args,
                     **kw_)
    gibbs = MCMCLearner(FMConfig(factor_block=0, **base), *args, **kw_)
    exp = ExpSGDLearner(FMConfig(learn_rate=cs.EXP_SGD_LR, **base), *args,
                        **kw_)
    vb0 = vb.state_from_params(init_vb_params(
        torch.Generator().manual_seed(cs.SEED), vb.cfg, dev))
    sets = [(cs.fast_tensors(vb, vb0), "w_col_update", "w_bins"),
            (cs.ovb_tensors(ovb, ovb.init_state()), "w_col_update",
             "w_bins"),
            (cs.mcmc_tensors(gibbs, gibbs.step(gibbs.init_state())[0]),
             "mcmc_w_draw", "mw_bins"),
            (cs.exp_sgd_tensors(exp, exp.init_state()), "w_grad_step",
             "xw_bins")]
    for s, name, key in sets:  # each bin, then each of its buckets alone
        for bins in (s[key], [[b] for bb in s[key] for b in bb]):
            for label, prepare, call, c in cs.make_cases(
                    dict(s, **{key: bins}))[name]:
                inp = prepare()
                line(f"{name} {label} {c['note']}".rstrip(),
                     lambda: call("kernel", inp))
    del sets
    for label, prepare, call, c in cs.make_cases(dict(
            tag="probe", gathers=cs.gather_sets(dev)))["gather_probe"]:
        line(f"gather_probe {label}", lambda: call("kernel", ()))
        line(f"gather_probe {label} library", c["library"])

    names = ("w_col_update", "mcmc_w_draw", "w_grad_step")
    for path, lr, unit in (("vb-exact", vb, "sweep"), ("mcmc", gibbs, "sweep"),
                           ("exp-sgd", exp, "sweep"), ("ovb", ovb, "epoch")):
        state, _ = lr.run(num_iter=1, verbose=False)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        lr.run(state, num_iter=1, verbose=False)
        torch.cuda.synchronize()
        counts = {k: build.launch_counts[k] for k in names}
        print(f"[{tag}] {path} K5 launches a {unit}: "
              f"{json.dumps(counts, separators=(',', ':'))}", flush=True)
        for _ in range(2):
            cs.profile_run(lambda: lr.run(state, num_iter=1, verbose=False),
                           1, unit, f"{tag} {path}-profile", focus=W_FOCUS)


def win_family(cs, build, dev, tag, line) -> None:
    import torch

    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.mcmc import MCMCLearner
    from svbfm_tpu_torch.learners.mcmc_windowed import WindowedMCMCLearner
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
    from svbfm_tpu_torch.learners.vb_windowed import WindowedVBLearner

    tr, te, train, test, meta = cs.ml_data(cs.NUM_TRAIN)
    base = dict(num_attributes=tr.num_features, num_factor=cs.K,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()),
                num_groups=meta.num_attr_groups, seed=cs.SEED)
    kw_ = dict(device=dev, write_files=False)
    wcfg = FMConfig(factor_block=4, **base)
    win = WindowedVBLearner(wcfg, train, test, meta,
                            cache_bytes=cs.WIN_CACHE_BYTES, **kw_)
    win0 = win.state_from_params(init_vb_params(
        torch.Generator().manual_seed(cs.SEED), wcfg, dev))
    mwin = WindowedMCMCLearner(wcfg, train, test, meta,
                               cache_bytes=cs.WIN_CACHE_BYTES, **kw_)
    mwin1, _ = mwin.step(mwin.init_state())
    cfg = FMConfig(factor_block=0, **base)
    vb = VBLearner(cfg, train, test, meta, **kw_)
    vb0 = vb.state_from_params(init_vb_params(
        torch.Generator().manual_seed(cs.SEED), cfg, dev))
    gibbs = MCMCLearner(cfg, train, test, meta, **kw_)
    sets = [(cs.win_tensors(win, win0, "vb-windowed", widths=(None, 1)),
             ("vb_col_stats_window",), ""),
            (cs.mwin_tensors(mwin, mwin1, "mcmc-windowed"),
             ("mcmc_col_draw_window",), ""),
            (cs.resident4_tensors(gibbs, gibbs.step(gibbs.init_state())[0],
                                  vb, vb0),
             ("mcmc_col_draw", "vb_col_stats_update"), ""),
            (cs.fast_tensors(vb, vb0), ("vb_col_stats_update",),
             "exact F=1 [14,128]")]
    for s, names, only in sets:
        cases = cs.make_cases(s)
        for name in names:
            for label, prepare, call, c in cases[name]:
                if c is None or only not in label:
                    continue
                inp = prepare()
                line(f"{name} {label} {c['note']}".rstrip(),
                     lambda: call("kernel", inp))
    del sets, cases

    for path, lr, focus in (("vb-windowed", win, "col_stats"),
                            ("mcmc-windowed", mwin, "col_draw")):
        state, _ = lr.run(num_iter=1, verbose=False)
        for _ in range(2):
            cs.profile_run(lambda: lr.run(state, num_iter=1, verbose=False),
                           1, "sweep", f"{tag} {path}-profile",
                           focus=(focus, "Memcpy HtoD"))


def stream_family(cs, build, dev, tag, line) -> None:
    import time

    import torch

    from svbfm_tpu_torch.data.binary import save_coo_binary
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.sgd import SGDOnlineLearner
    from svbfm_tpu_torch.learners.streaming import DeviceFeed
    from svbfm_tpu_torch.learners.vb_online import OVBLearner

    tr, te, train, test, meta = cs.ml_data(cs.NUM_TRAIN)
    work = cs.ooc_work("kernel_times_stream")
    save_coo_binary(os.path.join(work, "tr"), tr)
    reader = cs.binary_reader(os.path.join(work, "tr"))
    base = dict(num_attributes=tr.num_features, num_factor=cs.K,
                min_target=float(tr.target.min()),
                max_target=float(tr.target.max()),
                num_groups=meta.num_attr_groups, seed=cs.SEED)
    kw_ = dict(device=dev, write_files=False)

    def epochs(lr, label, n=4):
        state, ts = lr.init_state(), []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = lr.run(state, num_iter=1, verbose=False)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        print(f"[{tag}] {label}: s/epoch {' '.join(f'{t:.3f}' for t in ts)}"
              f" (median of the last {n - 1}: "
              f"{sorted(ts[1:])[(n - 1) // 2]:.3f})", flush=True)

    ocfg = FMConfig(num_batches=cs.OVB_CHUNKS, **base)
    epochs(OVBLearner(ocfg, train, test, meta, **kw_), "ovb in memory")
    so = OVBLearner.from_reader(ocfg, reader, test, meta, **kw_)
    t = time.perf_counter()
    for ci in range(so.num_chunks):
        so._read_chunk(ci)
    print(f"[{tag}] ovb: reading the {so.num_chunks} chunks serially: "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    for w in (0, 1, 2):
        so.feed = DeviceFeed(dev, min(3, so.num_chunks), workers=w,
                             staged=True)
        epochs(so, f"ovb streamed, {w} reader threads")
    scfg = FMConfig(num_batches=cs.SGD_ONLINE_CHUNKS, **base)
    epochs(SGDOnlineLearner(scfg, train, test, meta, **kw_),
           "sgd_online in memory")
    ss = SGDOnlineLearner.from_reader(scfg, reader, test, meta, **kw_)
    for w in (0, 1):
        ss.feed = DeviceFeed(dev, 2, workers=w, staged=True)
        epochs(ss, f"sgd_online streamed, {w} reader threads")


if __name__ == "__main__":
    sys.exit(main())
