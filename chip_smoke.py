#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  0. card: require CUDA; print the nvidia-smi name and power limit.
  1. build: compile every CUDA kernel of svbfm_tpu_torch, one nvcc per
     source, all started together.
  2. kernels: each kernel against its plain PyTorch twin on the card, at the
     shapes the paths give it (ML-1M, K=20; batch VB fast mode, exact mode
     at F=1 with the w patch, and an online-VB chunk of 1/20 of the rows
     at F=1) and on a small ragged case with a NaN-producing column; time
     both.
  3. vb-fast: batch VBFM (fast mode) init + 10 sweeps through VBLearner;
     every kernel of the path must have been launched; the free energy must
     not fall and the test RMSE must drop.
  4. gpu-vs-cpu: 3 fast-mode sweeps from one host-made init on the card
     (kernels) and on the CPU (twins); the trajectories must agree.
  5. quality: test RMSE and free energy after 30 fast-mode sweeps, printed
     beside the JAX package's record on the same recipe (information).
  6. profile: device time per fast-mode sweep by kernel (torch.profiler).
  7. vb-exact: batch VBFM with factor_block=1 (the reference's order),
     5 sweeps: kernels launched, free energy non-decreasing, RMSE falling.
  8. vb-exact gpu-vs-cpu: 2 exact-mode sweeps at full size from one
     host-made init on the card and on the CPU; the trajectories must agree.
  9. ovb: online VBFM, 20 chunks of fixed membership, 5 epochs: kernels
     launched, RMSE falling; sec/epoch and peak memory.
 10. ovb gpu-vs-cpu: 2 epochs of the 100k-row recipe from one host-made
     init on the card and on the CPU; the trajectories must agree.
 11. ovb quality: -reshuffle 1, 20 chunks, 30 epochs; test RMSE at epochs
     10 and 30 beside the reference C++ run's (information).
 12. cli: python -m svbfm_tpu_torch.cli -method vb_online -device cuda on
     small libFM files; it must exit 0 and write its files.
 13. ovb-profile: device time of one online-VB epoch by kernel.
Then the nvidia-smi line again, a JSON line with each kernel's launches
(summed over the runs of phases 3, 7 and 9, each read just after its run
with the counts zeroed just before), error and times, and as the last line
{"ok": true, "device": {...}}.

Imports only svbfm_tpu_torch, torch and numpy: never JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
K = 20
NUM_USERS, NUM_ITEMS, NUM_TRAIN = 6040, 3952, 1_000_000
OVB_CHUNKS = 20
# kernel vs twin: max |kernel - twin| <= KERNEL_TOL * max(1, max |twin|)
# where the twin is finite, and the same NaN/Inf pattern where it is not;
# float32 sums of at most a few hundred terms, taken in another order
KERNEL_TOL = 1e-4
# GPU (kernels) vs CPU (twins) trajectories over 3 fast-mode sweeps,
# relative: the H100 measured 1.2e-7 at most (float32, other summation
# orders, atomics in index_add_); 1e-5 leaves a wide margin and still
# catches a wrong sum.  Exact mode (2 sweeps) is held to the same bound.
TRAJ_RTOL = 1e-5
# the same for online VB over 2 epochs of the 100k-row recipe: the H100
# measured 9.4e-8 at most, so the same margin holds
OVB_TRAJ_RTOL = 1e-5
# the JAX package's record on this recipe, measured on a TPU v5e
# (BENCH_r05.json); quality numbers, not speed
JAX_RMSE_30, JAX_FE_30 = 0.68206, -1093193.6
# the reference C++ OVBFM on this recipe, -reshuffle 1, 20 chunks
# (PARITY_RUNS.md:130): test RMSE by epoch; other init draws
REF_OVB_RMSE = {10: 0.7012, 30: 0.6852}

SOURCES = {
    "fm_scores": ("svbfm_tpu_torch/csrc/fm_forward.cu",
                  "svbfm_tpu/ops/forward.py:61"),
    "fm_t_terms": ("svbfm_tpu_torch/csrc/fm_forward.cu",
                   "svbfm_tpu/ops/forward.py:111"),
    "vb_build_qt": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                    "svbfm_tpu/learners/vb.py:317"),
    "vb_col_stats_update": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                            "svbfm_tpu/learners/vb.py:382"),
    "vb_patch_rows": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                      "svbfm_tpu/learners/vb.py:508"),
    "w_col_update": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                     "svbfm_tpu/learners/vb.py:125"),
    "w_patch_rows": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                     "svbfm_tpu/learners/vb.py:149"),
    "ovb_col_stats_update": ("svbfm_tpu_torch/csrc/ovb_sweep.cu",
                             "svbfm_tpu/learners/vb_online.py:476"),
}
# the kernels each driven path must launch
PATH_KERNELS = {
    "vb-fast": ("fm_scores", "fm_t_terms", "vb_build_qt",
                "vb_col_stats_update", "vb_patch_rows"),
    "vb-exact": ("fm_scores", "fm_t_terms", "vb_build_qt",
                 "vb_col_stats_update", "vb_patch_rows", "w_col_update",
                 "w_patch_rows"),
    "ovb": ("fm_scores", "fm_t_terms", "vb_build_qt", "vb_patch_rows",
            "w_col_update", "w_patch_rows", "ovb_col_stats_update"),
}


def say(phase: str, t0: float, **kv) -> None:
    body = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {body} seconds={time.perf_counter() - t0:.3f}",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call: ``reps`` calls captured in a CUDA graph
    and replayed between two CUDA events.  The replay launches them back to
    back, so a call's Python wrapper (tens of µs, more than a small
    kernel's run time) is not in the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    graph.reset()  # frees the graph's memory pool
    return a.elapsed_time(b) / reps


def compare(outs_k, outs_p, what: str) -> float:
    """Max abs error of kernel outputs against the twin's where the twin is
    finite; where it is not, the kernel must have the same NaN/Inf there.
    Raises past the tolerance.  Returns the max abs error."""
    worst = 0.0
    for a, b in zip(outs_k, outs_p):
        a, b = a.double(), b.double()
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin) or not torch.equal(
                a[~fin].nan_to_num(), b[~fin].nan_to_num()):
            raise AssertionError(f"{what}: kernel and twin differ in their "
                                 "non-finite values")
        a, b = a[fin], b[fin]
        err = (a - b).abs().max().item() if a.numel() else 0.0
        scale = max(1.0, b.abs().max().item() if b.numel() else 0.0)
        if err > KERNEL_TOL * scale:
            raise AssertionError(f"{what}: max abs err {err:.3e} > "
                                 f"{KERNEL_TOL:g} * {scale:.3g}")
        worst = max(worst, err)
    return worst


def _clones(s: dict, *keys) -> tuple:
    return tuple(s[k].clone() for k in keys)


def _bad(device):
    return torch.zeros(4, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Kernel cases.  A case is (label, prepare, call, timed): prepare() makes
# fresh copies of the inputs an op updates in place; call(variant, inputs)
# runs the CUDA op ("kernel") or its twin ("plain") once and returns the
# outputs.  Timing repeats call() on one prepared input set, so it times
# the op alone.  A tensor dict ``s`` holds one shape family; a case whose
# inputs it lacks is skipped.
# ---------------------------------------------------------------------------

def make_cases(s: dict):
    from svbfm_tpu_torch.kernels import fm_forward as k1
    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw

    cases = {name: [] for name in SOURCES}
    tag = s["tag"]

    def nothing():
        return ()

    def k2(F, ptab, ids, vals):
        def call(variant, _):
            fn = kv.vb_build_qt if variant == "kernel" else kv.vb_build_qt_plain
            return list(fn(ptab, F, ids, vals))
        return call

    def k4(F, merge_w, seq, ptab, ids, vals, keys):
        def prepare():
            return _clones(s, *keys)

        def call(variant, inp):
            fn = (kv.vb_patch_rows if variant == "kernel"
                  else kv.vb_patch_rows_plain)
            fn(ptab, F, merge_w, ids, vals, *inp, sequential=seq)
            return list(inp)
        return prepare, call

    if "stab" in s:  # K1: scores (test eval, OVB chunk e) and T-terms
        def k1_scores(variant, _):
            fn = k1.fm_scores_op if variant == "kernel" else k1.fm_scores_plain
            return [fn(s["stab"], s["w0"], s["eval_ids"], s["eval_vals"])]

        def k1_tterms(variant, _):
            fn = k1.fm_t_terms_op if variant == "kernel" else k1.fm_t_terms_plain
            return [fn(s["ttab"], s["s0"], s["ids"], s["vals"])]

        cases["fm_scores"].append(
            (f"{tag} scores N={s['eval_ids'].shape[0]}", nothing, k1_scores,
             True))
        cases["fm_t_terms"].append(
            (f"{tag} t-terms N={s['ids'].shape[0]}", nothing, k1_tterms,
             True))

    if "buckets" in s:  # batch VB, fast mode (all K factors in one block)
        F = s["F"]

        def k3_prepare():
            return _clones(s, "mu_t", "sig_t", "ptab", "mu_w", "sig_w") + (
                torch.zeros(2, dtype=torch.int32, device=s["e"].device),)

        def k3(blk, sv, sigma_w):
            def call(variant, inp):
                fn = (kv.vb_col_stats_update if variant == "kernel"
                      else kv.vb_col_stats_update_plain)
                mu_t, sig_t, ptab, mu_w, sig_w, nans = inp
                fn(blk["rows"], blk["x"], blk["cols"], blk["group"],
                   blk["sx2"], s["e"], s["q"], s["tq"], ptab, mu_t, sig_t, sv,
                   s["alpha"], (mu_w, sig_w, sigma_w), nans)
                return [mu_t, sig_t, ptab, mu_w, sig_w, nans]
            return call

        cases["vb_build_qt"].append(
            (f"{tag} F={F}", nothing, k2(F, s["ptab"], s["ids"], s["vals"]),
             True))
        for i, b in enumerate(s["buckets"]):
            cases["vb_col_stats_update"].append(
                (f"{tag} F={F} [{b['rows'].shape[0]},{b['rows'].shape[1]}]",
                 k3_prepare, k3(b, s["sv"], s["sigma_w"]), i == 0))
        cases["vb_patch_rows"].append(
            (f"{tag} F={F} seq",) + k4(F, True, True, s["ptab_patch"],
                                       s["ids"], s["vals"],
                                       ("q", "tq", "tz", "e", "t")) + (True,))

    if "w_buckets" in s:  # the standalone linear-term sweep (K5, w patch)
        def k5_prepare(ovb):
            def prepare():
                base = _clones(s, "mu_w", "sig_w") + (
                    torch.zeros_like(s["dtab"]), _bad(s["e"].device))
                return base + (_clones(s, "n_mu_w", "n_sig_w", "t_wj")
                               if ovb else ())
            return prepare

        def k5(blk, ovb):
            def call(variant, inp):
                fn = (kw.w_col_update if variant == "kernel"
                      else kw.w_col_update_plain)
                mu_w, sig_w, dtab, bad = inp[:4]
                extra = None
                if ovb:
                    n_mu, n_sig, t_wj = inp[4:]
                    extra = (blk["cnt"], blk["col_count"], n_mu, n_sig,
                             s["rho_w"], t_wj)
                fn(blk["rows"], blk["x"], blk["cols"], blk["group"],
                   blk["sx2"], s["e"], mu_w, sig_w, s["w_sigma_w"],
                   s["alpha"], dtab, bad, ovb=extra)
                return list(inp)
            return call

        def wpatch_prepare():
            return _clones(s, "e", "t")

        def wpatch(variant, inp):
            fn = kv.w_patch_rows if variant == "kernel" else kv.w_patch_rows_plain
            fn(s["dtab"], s["ids"], s["vals"], *inp)
            return list(inp)

        ovb = s["ovb"]
        mode = "ovb" if ovb else "vb"
        for i, b in enumerate(s["w_buckets"]):
            cases["w_col_update"].append(
                (f"{tag} {mode} [{b['rows'].shape[0]},{b['rows'].shape[1]}]",
                 k5_prepare(ovb), k5(b, ovb), i == 0))
        cases["w_patch_rows"].append((f"{tag} N={s['ids'].shape[0]}",
                                      wpatch_prepare, wpatch, True))

    if "v_buckets" in s:  # online VB factor block (K2, K6, K4 seq=False)
        F = s["vF"]

        def k6_prepare():
            return _clones(s, "v_ptab", "v_mu", "v_sig", "v_nmu",
                           "v_nsig") + (torch.zeros_like(s["rho_v"]),
                                        _bad(s["e"].device))

        def k6(blk):
            def call(variant, inp):
                fn = (ko.ovb_col_stats_update if variant == "kernel"
                      else ko.ovb_col_stats_update_plain)
                ptab, mu, sig, nmu, nsig, tv_add, bad = inp
                fn(blk["rows"], blk["x"], blk["cols"], blk["group"],
                   blk["cnt"], blk["col_count"], s["e"], s["vq"], s["vtq"],
                   ptab, mu, sig, nmu, nsig, s["v_sv"], s["alpha"],
                   s["rho_v"], tv_add, bad)
                return [ptab, mu, sig, nmu, nsig, tv_add, bad]
            return call

        cases["vb_build_qt"].append(
            (f"{tag} F={F}", nothing,
             k2(F, s["v_ptab"], s["ids"], s["vals"]), True))
        for i, b in enumerate(s["v_buckets"]):
            cases["ovb_col_stats_update"].append(
                (f"{tag} F={F} [{b['rows'].shape[0]},{b['rows'].shape[1]}]",
                 k6_prepare, k6(b), i == 0))
        cases["vb_patch_rows"].append(
            (f"{tag} F={F} simultaneous",) + k4(
                F, False, False, s["v_ptab_patch"], s["ids"], s["vals"],
                ("vq", "vtq", "vtz", "e", "t")) + (True,))

    if "exact_buckets" in s:  # batch VB exact mode: K2, K3, K4 at F = 1
        def k3x_prepare():
            return _clones(s, "x_mu", "x_sig", "x_ptab") + (
                torch.zeros(2, dtype=torch.int32, device=s["e"].device),)

        def k3x(blk):
            def call(variant, inp):
                fn = (kv.vb_col_stats_update if variant == "kernel"
                      else kv.vb_col_stats_update_plain)
                mu_t, sig_t, ptab, nans = inp
                fn(blk["rows"], blk["x"], blk["cols"], blk["group"],
                   blk["sx2"], s["e"], s["xq"], s["xtq"], ptab, mu_t, sig_t,
                   s["x_sv"], s["alpha"], None, nans)
                return [mu_t, sig_t, ptab, nans]
            return call

        cases["vb_build_qt"].append(
            (f"{tag} exact F=1", nothing,
             k2(1, s["x_ptab"], s["ids"], s["vals"]), True))
        for b in s["exact_buckets"]:
            cases["vb_col_stats_update"].append(
                (f"{tag} exact F=1 [{b['rows'].shape[0]},{b['rows'].shape[1]}]",
                 k3x_prepare, k3x(b), True))
        cases["vb_patch_rows"].append(
            (f"{tag} exact F=1 seq",) + k4(
                1, False, True, s["x_ptab_patch"], s["ids"], s["vals"],
                ("xq", "xtq", "xtz", "e", "t")) + (True,))
    return cases


def check_cases(s: dict, timed: bool) -> dict:
    """Hold every kernel against its twin on the cases ``s`` gives; with
    ``timed``, also time both on the cases marked for it.  Returns per
    kernel {max_abs_err, times: [(label, ms, plain_ms)]}."""
    out = {}
    for name, cases in make_cases(s).items():
        if not cases:
            continue
        r = out.setdefault(name, dict(max_abs_err=0.0, times=[]))
        for label, prepare, call, want_time in cases:
            ok, op = call("kernel", prepare()), call("plain", prepare())
            torch.cuda.synchronize()
            r["max_abs_err"] = max(r["max_abs_err"],
                                   compare(ok, op, f"{name} ({label})"))
            if timed and want_time:
                inp_k, inp_p = prepare(), prepare()
                r["times"].append((
                    label, cuda_ms(lambda: call("kernel", inp_k), 20),
                    cuda_ms(lambda: call("plain", inp_p), 5)))
    return out


def merge_reports(*reports) -> dict:
    out = {}
    for rep in reports:
        for name, r in rep.items():
            o = out.setdefault(name, dict(max_abs_err=0.0, times=[]))
            o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
            o["times"] += r["times"]
    return out


def _bucket_dict(blk) -> dict:
    return {f.name: getattr(blk, f.name) for f in dataclasses.fields(blk)}


def fast_tensors(learner, state) -> dict:
    """Batch VB fast-mode kernel inputs at the path's shapes, from a real
    init state; also the exact-mode inputs: K5 and the w patch, and K2, K3
    and K4 at F = 1."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw

    plan = learner.plan_data
    D, F = learner.cfg.num_attributes, learner.cfg.num_factor
    dev = state.e.device
    mu_t = state.mu_v.T.contiguous()
    sig_t = state.sigma_v_dash.T.contiguous()
    ptab = torch.zeros(D, 5 * F + 2, device=dev)
    ptab[:, :F], ptab[:, F:2 * F] = mu_t, sig_t
    row = learner.train_row
    q, tq, tz = kv.vb_build_qt_plain(ptab, F, row.ids, row.vals)
    s = dict(
        tag="vb", F=F, w0=state.mu_0, s0=state.sigma_0_dash,
        stab=torch.cat([state.mu_w[:, None], mu_t], 1).contiguous(),
        ttab=torch.cat([state.sigma_w_dash[:, None], mu_t, sig_t],
                       1).contiguous(),
        ids=row.ids, vals=row.vals, eval_ids=learner.test_row.ids,
        eval_vals=learner.test_row.vals, mu_t=mu_t, sig_t=sig_t, ptab=ptab,
        mu_w=state.mu_w.clone(), sig_w=state.sigma_w_dash.clone(),
        sigma_w=state.sigma_w, w_sigma_w=state.sigma_w,
        sv=state.sigma_v.contiguous(), alpha=state.alpha, e=state.e.clone(),
        t=state.t.clone(), q=q, tq=tq, tz=tz, ovb=False)
    # the largest bucket of each bin ([6026,256] and [1613,512] here)
    big = [max(bb, key=lambda b: b.rows.numel()) for bb in plan.blocks]
    s["buckets"] = [_bucket_dict(b) for b in big]
    s["w_buckets"] = s["buckets"]
    # a patch table as bin 0 leaves it: deltas at bin 0's columns
    pt = ptab.clone()
    mt, st, mw, sw = (a.clone() for a in (mu_t, sig_t, s["mu_w"], s["sig_w"]))
    nans = torch.zeros(2, dtype=torch.int32, device=dev)
    for blk in plan.blocks[0]:
        kv.vb_col_stats_update_plain(
            blk.rows, blk.x, blk.cols, blk.group, blk.sx2, s["e"], q, tq, pt,
            mt, st, s["sv"], s["alpha"], (mw, sw, s["sigma_w"]), nans)
    s["ptab_patch"] = pt
    # exact mode: the w patch table as bin 0 of K5 leaves it; factor 0 alone
    # for K2, K3 and K4 at F = 1, the K4 table as bin 0 of K3 leaves it
    dtab = torch.zeros(D, 2, device=dev)
    mw, sw = s["mu_w"].clone(), s["sig_w"].clone()
    for blk in plan.blocks[0]:
        kw.w_col_update_plain(blk.rows, blk.x, blk.cols, blk.group, blk.sx2,
                              s["e"], mw, sw, s["sigma_w"], s["alpha"], dtab,
                              _bad(dev))
    s["dtab"] = dtab
    s["x_ptab"] = torch.zeros(D, 5, device=dev)
    s["x_ptab"][:, 0], s["x_ptab"][:, 1] = mu_t[:, 0], sig_t[:, 0]
    s["x_mu"], s["x_sig"] = mu_t[:, :1].contiguous(), sig_t[:, :1].contiguous()
    s["x_sv"] = s["sv"][:, :1].contiguous()
    s["xq"], s["xtq"] = q[:, :1].contiguous(), tq[:, :1].contiguous()
    s["xtz"] = tz[:, :1].contiguous()
    s["exact_buckets"] = s["buckets"]
    pt = s["x_ptab"].clone()
    mt, st = s["x_mu"].clone(), s["x_sig"].clone()
    for blk in plan.blocks[0]:
        kv.vb_col_stats_update_plain(
            blk.rows, blk.x, blk.cols, blk.group, blk.sx2, s["e"], s["xq"],
            s["xtq"], pt, mt, st, s["x_sv"], s["alpha"], None, nans)
    s["x_ptab_patch"] = pt
    return s


def ovb_tensors(learner, state) -> dict:
    """Online-VB kernel inputs at the path's shapes: chunk 0 of the
    learner's fixed membership, factor 0 (F = 1), from a real init; K1 on
    the chunk's rows, as each chunk's e/t caches take it."""
    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw
    from svbfm_tpu_torch.ops.forward import fm_scores, fm_t_terms

    cfg = learner.cfg
    row, plan = learner.chunks[0]
    D = cfg.num_attributes
    dev = row.ids.device
    e = row.target - fm_scores(state.mu_0, state.mu_w, state.mu_v, row.ids,
                               row.vals)
    t = fm_t_terms(state.sigma_0_dash, state.sigma_w_dash, state.mu_v,
                   state.sigma_v_dash, row.ids, row.vals)
    big = [max(bb, key=lambda b: b.rows.numel()) for bb in plan.blocks]
    mu_t = state.mu_v.T.contiguous()
    s = dict(
        tag="ovb-chunk", ovb=True, ids=row.ids, vals=row.vals, e=e, t=t,
        w0=state.mu_0, s0=state.sigma_0_dash, eval_ids=row.ids,
        eval_vals=row.vals,
        stab=torch.cat([state.mu_w[:, None], mu_t], 1).contiguous(),
        ttab=torch.cat([state.sigma_w_dash[:, None], mu_t,
                        state.sigma_v_dash.T], 1).contiguous(),
        alpha=state.alpha, mu_w=state.mu_w.clone(),
        sig_w=state.sigma_w_dash.clone(), n_mu_w=state.n_mu_w.clone(),
        n_sig_w=state.n_sig_w.clone(), t_wj=state.t_wj.clone(),
        w_sigma_w=state.sigma_w, rho_w=(1.0 + state.t_wj) ** -0.5,
        w_buckets=[_bucket_dict(b) for b in big], vF=1)
    dtab = torch.zeros(D, 2, device=dev)
    tw = s["t_wj"].clone()
    for blk in plan.blocks[0]:
        kw.w_col_update_plain(
            blk.rows, blk.x, blk.cols, blk.group, blk.sx2, e,
            s["mu_w"].clone(), s["sig_w"].clone(), s["w_sigma_w"],
            s["alpha"], dtab, _bad(dev),
            ovb=(blk.cnt, blk.col_count, s["n_mu_w"].clone(),
                 s["n_sig_w"].clone(), s["rho_w"], tw))
    s["dtab"] = dtab
    mu, sig = state.mu_v[:1].T.contiguous(), state.sigma_v_dash[:1].T.contiguous()
    ptab = torch.zeros(D, 5, device=dev)
    ptab[:, :1], ptab[:, 1:2] = mu, sig
    vq, vtq, vtz = kv.vb_build_qt_plain(ptab, 1, row.ids, row.vals)
    s.update(v_ptab=ptab, v_mu=mu, v_sig=sig,
             v_nmu=state.n_mu_v[:1].T.contiguous(),
             v_nsig=state.n_sig_v[:1].T.contiguous(),
             v_sv=state.sigma_v[:, :1].contiguous(),
             rho_v=(1.0 + state.t_vj) ** -0.5, vq=vq, vtq=vtq, vtz=vtz,
             v_buckets=[_bucket_dict(b) for b in big])
    pt = ptab.clone()
    tmp = (mu.clone(), sig.clone(), s["v_nmu"].clone(), s["v_nsig"].clone())
    for blk in plan.blocks[0]:
        ko.ovb_col_stats_update_plain(
            blk.rows, blk.x, blk.cols, blk.group, blk.cnt, blk.col_count, e,
            vq, vtq, pt, *tmp, s["v_sv"], s["alpha"], s["rho_v"],
            torch.zeros(D, device=dev), _bad(dev))
    s["v_ptab_patch"] = pt
    return s


def ragged_tensors(device) -> list:
    """Three small ragged cases: P = 3 with padding entries, K = 5, one [3, 8]
    bucket with padding entries (x = 0 at the last row).  For K5 and K6,
    column 9 produces NaN candidates (its eta2, and in batch-VB mode its
    group's sigma_w, are NaN) and column 17 has no entries in the chunk
    (cnt = 0)."""
    rng = np.random.default_rng(11)
    N, P, D, F, G = 40, 3, 30, 5, 2
    ids = rng.integers(0, D, size=(N, P)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, size=(N, P)).astype(np.float32)
    nnz = rng.integers(1, P + 1, size=N)
    pad = np.arange(P)[None, :] >= nnz[:, None]
    ids[pad], vals[pad] = 0, 0.0
    CH = 5 * F + 2
    ptab = rng.normal(0, 0.3, size=(D, CH)).astype(np.float32)
    ptab[:, F:2 * F] = rng.uniform(0.01, 0.1, size=(D, F))
    rows = rng.integers(0, N, size=(3, 8)).astype(np.int32)
    x = rng.uniform(0.5, 1.5, size=(3, 8)).astype(np.float32)
    rows[:, 5:], x[:, 5:] = N - 1, 0.0
    nsig = rng.uniform(20.0, 60.0, size=(D, F)).astype(np.float32)
    nsig[9] = np.nan
    n_sig_w = rng.uniform(20.0, 60.0, size=D).astype(np.float32)
    n_sig_w[9] = np.nan

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    s = dict(
        tag="ragged", F=F, w0=scalar(0.3), s0=scalar(0.02),
        stab=t(rng.normal(0, 0.3, size=(D, 1 + F)).astype(np.float32)),
        ttab=t(np.abs(rng.normal(0, 0.3, size=(D, 1 + 2 * F)))
               .astype(np.float32)),
        ids=t(ids), vals=t(vals), eval_ids=t(ids), eval_vals=t(vals),
        mu_t=t(ptab[:, :F]), sig_t=t(ptab[:, F:2 * F]), ptab=t(ptab),
        mu_w=t(rng.normal(0, 0.1, size=D).astype(np.float32)),
        sig_w=t(np.full(D, 0.02, np.float32)),
        sigma_w=t(np.array([1.0, 2.0], np.float32)),
        sv=t(rng.uniform(0.5, 2.0, size=(G, F)).astype(np.float32)),
        alpha=scalar(1.3),
        e=t(rng.normal(0, 1, size=N).astype(np.float32)),
        t=t(rng.uniform(0, 1, size=N).astype(np.float32)),
        q=t(rng.normal(0, 1, size=(N, F)).astype(np.float32)),
        tq=t(rng.uniform(0, 1, size=(N, F)).astype(np.float32)),
        tz=t(rng.uniform(0, 1, size=(N, F)).astype(np.float32)),
        ptab_patch=t(ptab))
    bucket = dict(rows=t(rows), x=t(x), cols=t(np.array([2, 9, 17], np.int32)),
                  group=t(np.array([0, 1, 1], np.int32)),
                  sx2=t((x * x).sum(1)),
                  cnt=t(np.array([5.0, 5.0, 0.0], np.float32)),
                  col_count=t(np.array([40.0, 12.0, 7.0], np.float32)))
    s["buckets"] = [bucket]
    common = {k: s[k] for k in ("ids", "vals", "e", "t", "alpha", "mu_w",
                                "sig_w")}
    dtab = t(rng.normal(0, 0.1, size=(D, 2)).astype(np.float32))
    # K5 in batch-VB mode: group 1's sigma_w is NaN (columns 9 and 17)
    vb = dict(common, tag="ragged", ovb=False, w_buckets=[bucket], dtab=dtab,
              w_sigma_w=t(np.array([1.0, np.nan], np.float32)))
    # K5 in online mode, K6 (F = 5: three idle factor lanes) and K4 with
    # every position reading the pre-patch caches
    ov = dict(common, tag="ragged", ovb=True, w_buckets=[bucket], dtab=dtab,
              w_sigma_w=s["sigma_w"],
              n_mu_w=t(rng.normal(0, 5, size=D).astype(np.float32)),
              n_sig_w=t(n_sig_w),
              t_wj=t(rng.integers(0, 30, size=D).astype(np.float32)),
              rho_w=t(rng.uniform(0.1, 1.0, size=D).astype(np.float32)),
              vF=F, v_ptab=t(ptab[:, :5 * F]), v_mu=s["mu_t"],
              v_sig=s["sig_t"],
              v_nmu=t(rng.normal(0, 5, size=(D, F)).astype(np.float32)),
              v_nsig=t(nsig), v_sv=s["sv"],
              rho_v=t(rng.uniform(0.1, 1.0, size=D).astype(np.float32)),
              vq=s["q"], vtq=s["tq"], vtz=s["tz"], v_buckets=[bucket],
              v_ptab_patch=t(ptab[:, :5 * F]))
    return [s, vb, ov]


def profile_run(fn, n: int, unit: str, phase: str) -> None:
    """Device time by kernel over ``n`` units of ``fn`` (one call), and the
    device's busy share of the wall time under the profiler (which slows
    the host, so the share reads low)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        raise AssertionError(f"{phase}: the profiler saw no device time")
    for us, count, key in rows[:15]:
        print(f"  profile {us / n:10.1f} us/{unit} {count // n:6d}x/{unit} "
              f"{100 * us / busy:5.1f}% {key[:90]}")
    say(phase, t0, **{f"{unit}s": n,
                      f"wall_us_per_{unit}": f"{wall_us / n:.1f}",
                      f"device_us_per_{unit}": f"{busy / n:.1f}",
                      "device_busy_share": f"{busy / wall_us:.3f}",
                      f"device_ops_per_{unit}": sum(r[1] for r in rows) // n})


def drive(build, path: str, fn):
    """Run one path with the launch counts zeroed just before and read just
    after; every kernel of the path must have been launched."""
    torch.cuda.synchronize()
    build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched on the path: "
                             f"{missing}")
    return out, launches


def check_history(hist, path: str, keys, fe_monotone: bool) -> None:
    for h in hist:
        vals = [h[k] for k in keys]
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"{path}: non-finite metrics at iter "
                                 f"{h['iter']}")
        for k in ("sigma_v", "sigma_w"):
            if k in h and not np.all(np.isfinite(h[k])):
                raise AssertionError(f"{path}: non-finite {k} at iter "
                                     f"{h['iter']}")
    if fe_monotone:
        fes = [h["free_energy"] for h in hist]
        for a, b in zip(fes, fes[1:]):
            if b < a - abs(a) * 1e-4:
                raise AssertionError(f"{path}: free energy fell: {a} -> {b}")
    if not hist[-1]["rmse"] < hist[0]["rmse"]:
        raise AssertionError(f"{path}: test RMSE did not drop over "
                             f"{len(hist)} iterations")


def ml_data(num_train: int, seed: int = 42):
    """bench.py's recipe: synthetic MovieLens-1M shape, 1/11 held out."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split

    coo = make_movielens_like(NUM_USERS, NUM_ITEMS, num_train + num_train // 10,
                              rank=8, noise=0.6, seed=seed)
    tr, te = train_test_split(coo, 1.0 / 11.0, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, NUM_USERS])
    return (tr, te, SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta)


def to_device(state, device):
    return type(state)(**{f.name: getattr(state, f.name).to(device)
                          for f in dataclasses.fields(state)})


def compare_traj(hg, hc, keys, rtol: float, what: str) -> float:
    worst = 0.0
    for a, b in zip(hg, hc):
        for k in keys:
            r = abs(a[k] - b[k]) / abs(b[k])
            if r > rtol:
                raise AssertionError(f"{what} {k} at iter {a['iter']}: "
                                     f"{a[k]} vs {b[k]} (rel {r:.3e})")
            worst = max(worst, r)
    return worst


def run_cli(dev_index: int) -> None:
    """The port's CLI in a child process on small libFM files."""
    from svbfm_tpu_torch.data.libfm_text import save_libfm_text
    from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    coo = make_movielens_like(200, 150, 5000, seed=3)
    tr, te = train_test_split(coo, 0.2, seed=4)
    save_libfm_text(os.path.join(work, "train.libfm"), tr)
    save_libfm_text(os.path.join(work, "test.libfm"), te)
    env = dict(os.environ, PYTHONPATH=repo,
               CUDA_VISIBLE_DEVICES=os.environ.get("CUDA_VISIBLE_DEVICES",
                                                   str(dev_index)))
    cmd = [sys.executable, "-m", "svbfm_tpu_torch.cli", "-task", "r",
           "-train", "train.libfm", "-test", "test.libfm", "-dim", "1,1,8",
           "-method", "vb_online", "-batch", "5", "-iter", "2", "-device",
           "cuda", "-out", "pred.txt"]
    r = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"cli exited {r.returncode}:\n{r.stderr[-2000:]}")
    want = ("v_file.txt", "pred.txt", "test_rmse_118_vb_online",
            "free_energy_118_vb_online")
    missing = [f for f in want if not os.path.exists(os.path.join(work, f))]
    if missing or "Final\tTest=" not in r.stdout:
        raise AssertionError(f"cli output incomplete: missing {missing}")
    final = [ln for ln in r.stdout.splitlines() if ln.startswith("Final")][0]
    shutil.rmtree(work, ignore_errors=True)
    say("cli", t0, rc=r.returncode, final=final.split("=")[1])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    say("card", t0, kind=repr(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    from svbfm_tpu_torch.data.dataset import SweepPlan
    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
    from svbfm_tpu_torch.learners.vb_online import OVBLearner, init_ovb_state

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    say("build", t0, libraries=len(build.LIBRARIES), build_s=f"{secs:.2f}")

    # ---- data (bench.py's recipe) ------------------------------------------
    t0 = time.perf_counter()
    tr, te, train, test, meta = ml_data(NUM_TRAIN)
    D = tr.num_features
    base_cfg = dict(num_attributes=D, num_factor=K,
                    min_target=float(tr.target.min()),
                    max_target=float(tr.target.max()),
                    num_groups=meta.num_attr_groups, seed=SEED)
    cfg = FMConfig(factor_block=0, **base_cfg)
    plan = SweepPlan.build(tr, D, meta_groups=meta.attr_group)
    learner = VBLearner(cfg, train, test, meta, device=dev, plan=plan,
                        write_files=False)
    ovb = OVBLearner(FMConfig(num_batches=OVB_CHUNKS, **base_cfg), train,
                     test, meta, device=dev, write_files=False)
    shapes = [[tuple(b.rows.shape[1:]) for b in bb] for bb in plan.blocks]
    cshapes = [[tuple(b.rows.shape) for b in bb] for bb in ovb.chunks[0][1].blocks]
    say("data", t0, train_rows=tr.num_rows, test_rows=te.num_rows,
        features=D, buckets=str(shapes).replace(" ", ""),
        ovb_chunk_rows=int(ovb.chunk_sizes[0]),
        ovb_chunk0_buckets=str(cshapes).replace(" ", ""))

    # ---- 2. each kernel against its twin -----------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    vb0 = learner.state_from_params(init_vb_params(gen, cfg, dev))
    ovb0 = ovb.init_state()
    report = merge_reports(
        check_cases(fast_tensors(learner, vb0), timed=True),
        check_cases(ovb_tensors(ovb, ovb0), timed=True),
        *(check_cases(s, timed=False) for s in ragged_tensors(dev)))
    missing = sorted(set(SOURCES) - set(report))
    if missing:
        raise AssertionError(f"kernels with no case: {missing}")
    for name, r in report.items():
        print(f"  kernel {name}: max_abs_err={r['max_abs_err']:.3e} "
              f"(tol {KERNEL_TOL:g} x scale)", flush=True)
        for label, ms, pms in r["times"]:
            print(f"    {label}: ms={ms:.4f} plain_ms={pms:.4f}")
    say("kernels", t0, compared=len(report), tol=KERNEL_TOL)

    # ---- 3. batch VB, fast mode, on the card ---------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (state, hist), l_fast = drive(build, "vb-fast", lambda: learner.run(
        learner.init_state(), num_iter=10, verbose=False, chunk=1))
    peak = torch.cuda.max_memory_allocated()
    check_history(hist, "vb-fast", ("rmse", "mae", "train_rmse",
                                    "free_energy", "alpha"), True)
    sec_iter = statistics.median(h["time_learn"] for h in hist[1:10])
    say("vb-fast", t0, sweeps=len(hist), sec_per_iter=f"{sec_iter:.6f}",
        rmse_first=f"{hist[0]['rmse']:.6f}", rmse_last=f"{hist[-1]['rmse']:.6f}",
        fe_last=f"{hist[-1]['free_energy']:.2f}", peak_mem_bytes=peak,
        launches=json.dumps(l_fast, separators=(",", ":")), card=repr(card))

    # ---- 4. GPU kernels vs CPU twins, full size ------------------------------
    t0 = time.perf_counter()
    params = init_vb_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    cpu = VBLearner(cfg, train, test, meta, device="cpu", plan=plan,
                    write_files=False)
    _, hg = learner.run(learner.state_from_params(params), num_iter=3,
                        verbose=False)
    _, hc = cpu.run(cpu.state_from_params(params), num_iter=3, verbose=False)
    worst = compare_traj(hg, hc, ("rmse", "train_rmse", "free_energy"),
                         TRAJ_RTOL, "vb gpu vs cpu")
    say("gpu-vs-cpu", t0, sweeps=3, max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL)

    # ---- 5. quality after 30 sweeps (information) --------------------------
    t0 = time.perf_counter()
    state, h30 = learner.run(state, num_iter=20, verbose=False)
    say("quality", t0, sweeps=30, test_rmse=f"{h30[-1]['rmse']:.5f}",
        free_energy=f"{h30[-1]['free_energy']:.1f}",
        jax_tpu_record=f"{JAX_RMSE_30}/{JAX_FE_30}")

    # ---- 6. where a fast-mode sweep's device time goes -----------------------
    learner.run(state, num_iter=1, verbose=False)
    profile_run(lambda: learner.run(state, num_iter=5, verbose=False), 5,
                "sweep", "profile")

    # ---- 7. batch VB, exact mode (factor_block=1) ----------------------------
    t0 = time.perf_counter()
    exact = VBLearner(FMConfig(factor_block=1, **base_cfg), train, test, meta,
                      device=dev, plan=plan, write_files=False)
    torch.cuda.reset_peak_memory_stats()
    (_, hx), l_exact = drive(build, "vb-exact", lambda: exact.run(
        exact.init_state(), num_iter=5, verbose=False, chunk=1))
    check_history(hx, "vb-exact", ("rmse", "mae", "train_rmse",
                                   "free_energy", "alpha"), True)
    say("vb-exact", t0, sweeps=len(hx),
        sec_per_iter=f"{statistics.median(h['time_learn'] for h in hx[1:]):.6f}",
        rmse_first=f"{hx[0]['rmse']:.6f}", rmse_last=f"{hx[-1]['rmse']:.6f}",
        fe_last=f"{hx[-1]['free_energy']:.2f}",
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=json.dumps(l_exact, separators=(",", ":")))

    # ---- 8. exact mode, GPU kernels vs CPU twins, full size -----------------
    t0 = time.perf_counter()
    xcfg = FMConfig(factor_block=1, **base_cfg)
    params = init_vb_params(torch.Generator().manual_seed(SEED), xcfg, "cpu")
    cpu = VBLearner(xcfg, train, test, meta, device="cpu", plan=plan,
                    write_files=False)
    _, hg = exact.run(exact.state_from_params(params), num_iter=2,
                      verbose=False)
    _, hc = cpu.run(cpu.state_from_params(params), num_iter=2, verbose=False)
    worst = compare_traj(hg, hc, ("rmse", "train_rmse", "free_energy"),
                         TRAJ_RTOL, "vb-exact gpu vs cpu")
    say("vb-exact-gpu-vs-cpu", t0, sweeps=2, max_rel=f"{worst:.3e}",
        rtol=TRAJ_RTOL)
    del cpu

    # ---- 9. online VB, 20 chunks of fixed membership -------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (ostate, ho), l_ovb = drive(build, "ovb", lambda: ovb.run(
        ovb.init_state(), num_iter=5, verbose=False))
    check_history(ho, "ovb", ("rmse", "mae", "free_energy"), False)
    bad = {k: v for h in ho for k, v in h.items()
           if k.startswith(("nan_", "inf_")) and v}
    if bad:
        raise AssertionError(f"ovb: non-finite candidates {bad}")
    say("ovb", t0, epochs=len(ho), chunks=OVB_CHUNKS,
        sec_per_epoch=f"{statistics.median(h['time_learn'] for h in ho[1:]):.6f}",
        rmse=",".join(f"{h['rmse']:.5f}" for h in ho),
        fe_last=f"{ho[-1]['free_energy']:.2f}",
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=json.dumps(l_ovb, separators=(",", ":")))

    # ---- 10. online VB, GPU kernels vs CPU twins (100k-row recipe) -----------
    t0 = time.perf_counter()
    tr1, _, train1, test1, meta1 = ml_data(100_000)
    cfg1 = FMConfig(num_attributes=tr1.num_features, num_factor=8,
                    min_target=float(tr1.target.min()),
                    max_target=float(tr1.target.max()),
                    num_groups=meta1.num_attr_groups, seed=SEED,
                    num_batches=10)
    init1 = init_ovb_state(torch.Generator().manual_seed(SEED), cfg1, "cpu")
    hists = []
    for d in (dev, "cpu"):
        lr = OVBLearner(cfg1, train1, test1, meta1, device=d,
                        write_files=False)
        hists.append(lr.run(to_device(init1, d), num_iter=2,
                            verbose=False)[1])
    worst = compare_traj(*hists, ("rmse", "mae", "free_energy"),
                         OVB_TRAJ_RTOL, "ovb gpu vs cpu")
    say("ovb-gpu-vs-cpu", t0, train_rows=tr1.num_rows, epochs=2, chunks=10,
        max_rel=f"{worst:.3e}", rtol=OVB_TRAJ_RTOL)

    # ---- 11. online VB quality, -reshuffle 1 (information) ------------------
    t0 = time.perf_counter()
    qual = OVBLearner(FMConfig(num_batches=OVB_CHUNKS, reshuffle=True,
                               **base_cfg), train, test, meta, device=dev,
                      write_files=False)
    _, hq = qual.run(num_iter=max(REF_OVB_RMSE), verbose=False)
    check_history(hq, "ovb-quality", ("rmse", "mae", "free_energy"), False)
    say("ovb-quality", t0, epochs=len(hq),
        sec_per_epoch=f"{statistics.median(h['time_learn'] for h in hq[1:]):.6f}",
        **{f"test_rmse_epoch{e}": f"{hq[e - 1]['rmse']:.5f}"
           for e in REF_OVB_RMSE},
        reference_cpp=",".join(f"{e}:{v}" for e, v in REF_OVB_RMSE.items()))

    # ---- 12. the port's CLI -------------------------------------------------
    run_cli(dev.index)

    # ---- 13. where an online-VB epoch's device time goes --------------------
    profile_run(lambda: ovb.run(ostate, num_iter=1, verbose=False), 1,
                "epoch", "ovb-profile")

    launches = {n: sum(lp[n] for lp in (l_fast, l_exact, l_ovb))
                for n in SOURCES}
    kernels = [dict(name=n, route="cuda", source=SOURCES[n][0],
                    replaces=SOURCES[n][1], launches=launches[n],
                    max_abs_err=report[n]["max_abs_err"],
                    ms=report[n]["times"][0][1],
                    plain_ms=report[n]["times"][0][2]) for n in SOURCES]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
