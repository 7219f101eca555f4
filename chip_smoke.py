#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  0. card: require CUDA; print the nvidia-smi name and power limit.
  1. build: compile every CUDA kernel of svbfm_tpu_torch with nvcc.
  2. kernels: each kernel against its plain PyTorch twin on the card, at the
     main path's shapes (ML-1M, K=20) and on one small ragged case; time both.
  3. slice: batch VBFM (fast mode) init + 10 sweeps through VBLearner on the
     card; every kernel must have been launched; the free energy must not
     fall and the test RMSE must drop.
  4. gpu-vs-cpu: 3 sweeps from one host-made init on the card (kernels) and
     on the CPU (twins); the trajectories must agree.
  5. quality: test RMSE and free energy after 30 sweeps, printed beside the
     JAX package's record on the same data recipe (information only).
  6. profile: device time per sweep by kernel (torch.profiler).
Then the nvidia-smi line again, a JSON line with each kernel's launches
(on the phase-3 run), error and times, and as the last line
{"ok": true, "device": {...}}.

Imports only svbfm_tpu_torch, torch and numpy: never JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
K = 20
NUM_USERS, NUM_ITEMS, NUM_TRAIN = 6040, 3952, 1_000_000
# kernel vs twin: max |kernel - twin| <= KERNEL_TOL * max(1, max |twin|);
# float32 sums of at most a few hundred terms, taken in another order
KERNEL_TOL = 1e-4
# GPU (kernels) vs CPU (twins) trajectories over 3 sweeps, relative: the
# H100 measured 1.2e-7 at most (float32, other summation orders, atomics
# in index_add_); 1e-5 leaves a wide margin and still catches a wrong sum
TRAJ_RTOL = 1e-5
# the JAX package's record on this recipe, measured on a TPU v5e
# (BENCH_r05.json); quality numbers, not speed
JAX_RMSE_30, JAX_FE_30 = 0.68206, -1093193.6

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
    """Mean device time of one call, by CUDA events over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare(outs_k, outs_p, what: str) -> float:
    """Max abs error of kernel outputs against the twin's; raises past the
    tolerance.  Returns the max abs error."""
    worst = 0.0
    for a, b in zip(outs_k, outs_p):
        a, b = a.double(), b.double()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: kernel output not finite")
        err = (a - b).abs().max().item() if a.numel() else 0.0
        scale = max(1.0, b.abs().max().item() if b.numel() else 0.0)
        if err > KERNEL_TOL * scale:
            raise AssertionError(f"{what}: max abs err {err:.3e} > "
                                 f"{KERNEL_TOL:g} * {scale:.3g}")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Kernel cases.  A case is (prepare, call): prepare() makes fresh copies of
# the inputs an op updates in place; call(variant, inputs) runs the CUDA op
# ("kernel") or its twin ("plain") once and returns the outputs.  Timing
# repeats call() on one prepared input set, so it times the op alone.
# ---------------------------------------------------------------------------

def make_cases(s: dict):
    from svbfm_tpu_torch.kernels import fm_forward as k1
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    F = s["F"]

    def nothing():
        return ()

    def k1_scores(variant, _):
        fn = k1.fm_scores_op if variant == "kernel" else k1.fm_scores_plain
        return [fn(s["stab"], s["w0"], s["eval_ids"], s["eval_vals"])]

    def k1_tterms(variant, _):
        fn = k1.fm_t_terms_op if variant == "kernel" else k1.fm_t_terms_plain
        return [fn(s["ttab"], s["s0"], s["ids"], s["vals"])]

    def k2(variant, _):
        fn = kv.vb_build_qt if variant == "kernel" else kv.vb_build_qt_plain
        return list(fn(s["ptab"], F, s["ids"], s["vals"]))

    def k3_prepare():
        return tuple(s[k].clone() for k in
                     ("mu_t", "sig_t", "ptab", "mu_w", "sig_w")) + (
            torch.zeros(2, dtype=torch.int32, device=s["e"].device),)

    def k3(blk):
        def call(variant, inp):
            fn = (kv.vb_col_stats_update if variant == "kernel"
                  else kv.vb_col_stats_update_plain)
            mu_t, sig_t, ptab, mu_w, sig_w, nans = inp
            fn(blk["rows"], blk["x"], blk["cols"], blk["group"], blk["sx2"],
               s["e"], s["q"], s["tq"], ptab, mu_t, sig_t, s["sv"],
               s["alpha"], (mu_w, sig_w, s["sigma_w"]), nans)
            return [mu_t, sig_t, ptab, mu_w, sig_w, nans.float()]
        return call

    def k4_prepare():
        return tuple(s[k].clone() for k in ("q", "tq", "tz", "e", "t"))

    def k4(variant, inp):
        fn = kv.vb_patch_rows if variant == "kernel" else kv.vb_patch_rows_plain
        fn(s["ptab_patch"], F, True, s["ids"], s["vals"], *inp)
        return list(inp)

    return {"fm_scores": [(nothing, k1_scores)],
            "fm_t_terms": [(nothing, k1_tterms)],
            "vb_build_qt": [(nothing, k2)],
            "vb_col_stats_update": [(k3_prepare, k3(b))
                                    for b in s["buckets"]],
            "vb_patch_rows": [(k4_prepare, k4)]}


def check_cases(s: dict, label: str, timed: bool) -> dict:
    """Hold every kernel against its twin on ``s``; with ``timed``, also
    time both on the first case of each kernel."""
    out = {}
    for name, cases in make_cases(s).items():
        err = 0.0
        for prepare, call in cases:
            ok, op = call("kernel", prepare()), call("plain", prepare())
            torch.cuda.synchronize()
            err = max(err, compare(ok, op, f"{name} ({label})"))
        out[name] = dict(max_abs_err=err)
        if timed:
            prepare, call = cases[0]
            inp_k, inp_p = prepare(), prepare()
            out[name]["ms"] = cuda_ms(lambda: call("kernel", inp_k), 20)
            out[name]["plain_ms"] = cuda_ms(lambda: call("plain", inp_p), 5)
    return out


def slice_tensors(learner, state) -> dict:
    """Kernel inputs at the main path's shapes, from a real init state."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    plan = learner.plan_data
    D, F = learner.cfg.num_attributes, learner.cfg.num_factor
    mu_t = state.mu_v.T.contiguous()
    sig_t = state.sigma_v_dash.T.contiguous()
    ptab = torch.zeros(D, 5 * F + 2, device=mu_t.device)
    ptab[:, :F], ptab[:, F:2 * F] = mu_t, sig_t
    row = learner.train_row
    q, tq, tz = kv.vb_build_qt_plain(ptab, F, row.ids, row.vals)
    s = dict(
        F=F, w0=state.mu_0, s0=state.sigma_0_dash,
        stab=torch.cat([state.mu_w[:, None], mu_t], 1).contiguous(),
        ttab=torch.cat([state.sigma_w_dash[:, None], mu_t, sig_t],
                       1).contiguous(),
        ids=row.ids, vals=row.vals, eval_ids=learner.test_row.ids,
        eval_vals=learner.test_row.vals, mu_t=mu_t, sig_t=sig_t, ptab=ptab,
        mu_w=state.mu_w.clone(), sig_w=state.sigma_w_dash.clone(),
        sigma_w=state.sigma_w, sv=state.sigma_v.contiguous(),
        alpha=state.alpha, e=state.e.clone(), t=state.t.clone(),
        q=q, tq=tq, tz=tz)
    # the two largest buckets, one of each bin ([6026,256] and [1613,512]
    # at this shape)
    s["buckets"] = [
        vars(max(bb, key=lambda b: b.rows.numel())) for bb in plan.blocks]
    # a patch table as bin 0 leaves it: deltas at bin 0's columns
    pt = ptab.clone()
    mt, st, mw, sw = (a.clone() for a in (mu_t, sig_t, s["mu_w"], s["sig_w"]))
    nans = torch.zeros(2, dtype=torch.int32, device=mu_t.device)
    for blk in plan.blocks[0]:
        kv.vb_col_stats_update_plain(
            blk.rows, blk.x, blk.cols, blk.group, blk.sx2, s["e"], q, tq, pt,
            mt, st, s["sv"], s["alpha"], (mw, sw, s["sigma_w"]), nans)
    s["ptab_patch"] = pt
    return s


def ragged_tensors(device) -> dict:
    """A small ragged case: P = 3 with padding entries, K = 5, one [3, 8]
    bucket with padding entries (x = 0 at the last row)."""
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
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    s = dict(
        F=F, w0=scalar(0.3), s0=scalar(0.02),
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
    s["buckets"] = [dict(rows=t(rows), x=t(x),
                         cols=t(np.array([2, 9, 17], np.int32)),
                         group=t(np.array([0, 1, 1], np.int32)),
                         sx2=t((x * x).sum(1)))]
    return s


def profile_sweeps(learner, state, n: int) -> None:
    """Device time by kernel over ``n`` sweeps (one chunk, test eval
    included), and the device's busy share of the wall time under the
    profiler (which slows the host, so the share reads low)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    learner.run(state, num_iter=1, verbose=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        learner.run(state, num_iter=n, verbose=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    for us, count, key in rows[:15]:
        print(f"  profile {us / n:9.1f} us/sweep {count // n:4d}x/sweep "
              f"{100 * us / busy:5.1f}% {key[:90]}")
    say("profile", t0, sweeps=n, wall_us_per_sweep=f"{wall_us / n:.1f}",
        device_us_per_sweep=f"{busy / n:.1f}",
        device_busy_share=f"{busy / wall_us:.3f}",
        device_ops_per_sweep=sum(r[1] for r in rows) // n)


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

    from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params

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
    coo = make_movielens_like(NUM_USERS, NUM_ITEMS,
                              NUM_TRAIN + NUM_TRAIN // 10, rank=8, noise=0.6,
                              seed=42)
    tr, te = train_test_split(coo, 1.0 / 11.0, seed=43)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, NUM_USERS])
    cfg = FMConfig(num_attributes=D, num_factor=K,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()),
                   num_groups=meta.num_attr_groups, seed=SEED, factor_block=0)
    train, test = SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D)
    plan = SweepPlan.build(tr, D, meta_groups=meta.attr_group)
    learner = VBLearner(cfg, train, test, meta, device=dev, plan=plan,
                        write_files=False)
    shapes = [[tuple(b.rows.shape[1:]) for b in bb] for bb in plan.blocks]
    say("data", t0, train_rows=tr.num_rows, test_rows=te.num_rows,
        features=D, buckets=str(shapes).replace(" ", ""))

    # ---- 2. each kernel against its twin -----------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    full = slice_tensors(learner, learner.state_from_params(
        init_vb_params(gen, cfg, dev)))
    report = check_cases(full, "slice", timed=True)
    for name, r in check_cases(ragged_tensors(dev), "ragged",
                               timed=False).items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                          r["max_abs_err"])
    for name, r in report.items():
        print(f"  kernel {name}: max_abs_err={r['max_abs_err']:.3e} "
              f"(tol {KERNEL_TOL:g} x scale) ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f}", flush=True)
    say("kernels", t0, compared=len(report), tol=KERNEL_TOL)

    # ---- 3. the slice on the card ------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    state = learner.init_state()
    state, hist = learner.run(state, num_iter=10, verbose=False, chunk=1)
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    for h in hist:
        vals = [h[k] for k in ("rmse", "mae", "train_rmse", "free_energy",
                               "alpha")]
        if not (np.all(np.isfinite(vals)) and np.all(np.isfinite(h["sigma_v"]))
                and np.all(np.isfinite(h["sigma_w"]))):
            raise AssertionError(f"non-finite metrics at iter {h['iter']}")
    fes = [h["free_energy"] for h in hist]
    for a, b in zip(fes, fes[1:]):
        if b < a - abs(a) * 1e-4:
            raise AssertionError(f"free energy fell: {a} -> {b}")
    if not hist[-1]["rmse"] < hist[0]["rmse"]:
        raise AssertionError("test RMSE did not drop over 10 sweeps")
    sec_iter = statistics.median(h["time_learn"] for h in hist[1:10])
    say("slice", t0, sweeps=len(hist), sec_per_iter=f"{sec_iter:.6f}",
        rmse_first=f"{hist[0]['rmse']:.6f}", rmse_last=f"{hist[-1]['rmse']:.6f}",
        fe_last=f"{fes[-1]:.2f}", peak_mem_bytes=peak,
        launches=json.dumps(launches, separators=(",", ":")),
        card=repr(card))

    # ---- 4. GPU kernels vs CPU twins, full size ------------------------------
    t0 = time.perf_counter()
    params = init_vb_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    cpu = VBLearner(cfg, train, test, meta, device="cpu", plan=plan,
                    write_files=False)
    _, hg = learner.run(learner.state_from_params(params), num_iter=3,
                        verbose=False)
    _, hc = cpu.run(cpu.state_from_params(params), num_iter=3, verbose=False)
    worst = 0.0
    for a, b in zip(hg, hc):
        for k in ("rmse", "train_rmse", "free_energy"):
            r = abs(a[k] - b[k]) / abs(b[k])
            if r > TRAJ_RTOL:
                raise AssertionError(f"gpu vs cpu {k} at iter {a['iter']}: "
                                     f"{a[k]} vs {b[k]} (rel {r:.3e})")
            worst = max(worst, r)
    say("gpu-vs-cpu", t0, sweeps=3, max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL)

    # ---- 5. quality after 30 sweeps (information) --------------------------
    t0 = time.perf_counter()
    state, h30 = learner.run(state, num_iter=20, verbose=False)
    say("quality", t0, sweeps=30, test_rmse=f"{h30[-1]['rmse']:.5f}",
        free_energy=f"{h30[-1]['free_energy']:.1f}",
        jax_tpu_record=f"{JAX_RMSE_30}/{JAX_FE_30}")

    # ---- 6. where a sweep's device time goes ---------------------------------
    profile_sweeps(learner, state, 5)

    kernels = [dict(name=n, route="cuda", source=SOURCES[n][0],
                    replaces=SOURCES[n][1], launches=launches[n],
                    **report[n]) for n in SOURCES]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
