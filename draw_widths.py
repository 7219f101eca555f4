"""Time X8a's exact mode and X10b at several factor widths on the card.

    python3 draw_widths.py [--tree DIR] [--label NAME]

Runs the kernels of the checkout at ``--tree`` (default: the one holding
this script) on synthetic buckets of the shapes of the two recipes that
run them: X8a's exact mode on the ML-1M recipe's ``[6026,256]`` bucket
(1,000,022 rows, 9,992 attributes), at F = 20, 33, 64, 128 and 256; X10b
on the block-structure recipe's users relation (71,567 rows), its one-hot
bucket ``[71567,8]`` (one real entry a column) and an attribute-slot
bucket ``[2,65536]`` (35,500 and 36,100 real entries), at F = 20, 33, 64,
128 and 251.  The data comes from a seeded generator on the card, so two
checkouts get the same inputs.

For each case it prints the least and the most of three means of a CUDA
graph replay of 20 calls between CUDA events; for X8a (exact mode at
F = 20, 33, 64, 128, 256 and 303, the Jacobi mode at F = 20 and 64, and
F = 1) a sha256 of the outputs of one call, so that two checkouts' draws
can be compared bit for bit; and the ptxas register, spill and
shared-memory lines of the two libraries.  To hold a change against its parent, run it on both in one
call, in turns (parent, change, change, parent), the parent unpacked with
``git archive`` into a git-ignored directory.  Exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import os
import sys

import numpy as np

X8A_TIMED = (20, 33, 64, 128, 256)
X8A_DIGESTS = ((20, True), (33, True), (64, True), (128, True), (256, True),
               (303, True), (20, False), (64, False), (1, True))
X10B_TIMED = (20, 33, 64, 128, 251)


def graph_ms(torch, fn, reps: int = 20, rounds: int = 3):
    """(least, most) of ``rounds`` means of ``reps`` calls captured in a
    CUDA graph and replayed between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    g.reset()
    return min(times), max(times)


def x8a_inputs(torch, F: int, dev, seed: int):
    """The [6026,256] bucket of 129-256 real entries a column, padding after
    them, over 1,000,022 rows and 9,992 attributes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    N, D, C, L, G = 1_000_022, 9_992, 6026, 256, 2
    n = torch.randint(129, L + 1, (C, 1), generator=gen, device=dev)
    real = torch.arange(L, device=dev)[None, :] < n
    rows = torch.randint(0, N, (C, L), generator=gen, device=dev,
                         dtype=torch.int32) * real
    x = real.float()
    cols = torch.randperm(D, generator=gen, device=dev)[:C].to(torch.int32)
    group = (torch.arange(C, device=dev) % G).to(torch.int32)
    e = torch.randn(N, generator=gen, device=dev)
    q = 0.1 * torch.randn(N, F, generator=gen, device=dev)
    v_t = 0.1 * torch.randn(D, F, generator=gen, device=dev)
    ptab = torch.cat([v_t, torch.zeros_like(v_t)], 1)
    mu = 0.1 * torch.randn(G, F, generator=gen, device=dev)
    lam = torch.rand(G, F, generator=gen, device=dev) + 1.0
    alpha = torch.tensor(1.3, device=dev)
    z = torch.randn(F, D, generator=gen, device=dev)
    return [rows, x, cols, group, e, q, ptab, v_t, mu, lam, alpha, z]


def rel_table(torch, F: int, R: int, dev, gen):
    """[R, 3F + 2 + P] relation rows, each the aggregate of one joined row
    (wn = 1, we = e, weq = e qO, wc = qO, wcc = qO qO^T packed), so every
    sh2 and M is a sum of squares, as in a sweep."""
    ld = 3 * F + 2 + F * (F + 1) // 2
    rtab = torch.empty(R, ld, device=dev)
    iu0, iu1 = (torch.from_numpy(a).to(dev) for a in np.triu_indices(F))
    for r0 in range(0, R, 4096):
        r1 = min(R, r0 + 4096)
        e = torch.randn(r1 - r0, 1, generator=gen, device=dev)
        qo = 0.5 * torch.randn(r1 - r0, F, generator=gen, device=dev)
        blk = rtab[r0:r1]
        blk[:, :F] = 0.5 * torch.randn(r1 - r0, F, generator=gen, device=dev)
        blk[:, F:F + 1] = e
        blk[:, F + 1:2 * F + 1] = e * qo
        blk[:, 2 * F + 1:3 * F + 1] = qo
        blk[:, 3 * F + 1:ld - 1] = qo[:, iu0] * qo[:, iu1]
        blk[:, ld - 1] = 1.0
    return rtab


def x10b_inputs(torch, F: int, dev, seed: int):
    """The users relation's table, its one-hot bucket and a slot bucket,
    and the draw's per-column inputs."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    R, C1, L2 = 71_567, 71_567, 65_536
    Dr, G = C1 + 40, 2
    rtab = rel_table(torch, F, R, dev, gen)
    one_rows = torch.zeros(C1, 8, dtype=torch.int32, device=dev)
    one_rows[:, 0] = torch.randperm(R, generator=gen, device=dev).to(
        torch.int32)
    one_x = torch.zeros(C1, 8, device=dev)
    one_x[:, 0] = 1.0
    n = torch.tensor([[35_500], [36_100]], device=dev)
    real = torch.arange(L2, device=dev)[None, :] < n
    slot_rows = torch.randint(0, R, (2, L2), generator=gen, device=dev,
                              dtype=torch.int32) * real
    slot_x = real.float()
    buckets = {
        f"one-hot [{C1},8]": (one_rows, one_x,
                              torch.arange(C1, dtype=torch.int32, device=dev),
                              torch.zeros(C1, dtype=torch.int32, device=dev)),
        f"slot [2,{L2}]": (slot_rows, slot_x,
                           torch.tensor([C1, C1 + 1], dtype=torch.int32,
                                        device=dev),
                           torch.ones(2, dtype=torch.int32, device=dev)),
    }
    v_t = 0.1 * torch.randn(Dr, F, generator=gen, device=dev)
    ptab = torch.cat([v_t, torch.zeros_like(v_t)], 1)
    mu = 0.1 * torch.randn(G, F, generator=gen, device=dev)
    lam = torch.rand(G, F, generator=gen, device=dev) + 1.0
    z = torch.randn(F, Dr, generator=gen, device=dev)
    return rtab, buckets, dict(ptab=ptab, v_t=v_t, mu=mu, lam=lam, z=z,
                               alpha=torch.tensor(1.7, device=dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="the checkout whose kernels run")
    ap.add_argument("--label", default="", help="a name for the lines")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        print("draw_widths.py: no CUDA device", file=sys.stderr)
        return 1
    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.kernels import bs_sweep as ks
    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    tag = a.label or os.path.basename(os.path.abspath(a.tree))
    print(f"[widths] {tag}: {os.path.dirname(build.__file__)}", flush=True)
    build.build_all()
    for name in ("mcmc_sweep", "bs_sweep"):
        fn = "?"
        for line in build.build_logs.get(name, "").splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {fn}: {line.strip()}")
    dev = torch.device("cuda")

    for F, exact in X8A_DIGESTS:
        t = x8a_inputs(torch, F, dev, seed=F)
        nans = torch.zeros(2, dtype=torch.int32, device=dev)
        km.mcmc_col_draw(*t, exact, nans)
        h = hashlib.sha256()
        for out in (t[6], t[7], nans):
            h.update(out.cpu().numpy().tobytes())
        print(f"[widths] {tag} X8a {'exact' if exact else 'jacobi'} F={F} "
              f"digest={h.hexdigest()[:16]} nans={nans.tolist()}", flush=True)
        del t
    for F in X8A_TIMED:
        t = x8a_inputs(torch, F, dev, seed=F)
        nans = torch.zeros(2, dtype=torch.int32, device=dev)
        lo, hi = graph_ms(torch, lambda: km.mcmc_col_draw(*t, True, nans))
        print(f"[widths] {tag} X8a exact F={F} [6026,256] "
              f"ms={lo:.4f}-{hi:.4f}", flush=True)
        del t

    takes_real = "real" in inspect.signature(ks.bs_rel_draw).parameters
    for F in X10B_TIMED:
        rtab, buckets, c = x10b_inputs(torch, F, dev, seed=1000 + F)
        for shape, (rows, x, cols, group) in buckets.items():
            extra = (ks.real_counts(x),) if takes_real else ()
            nans = torch.zeros(2, dtype=torch.int32, device=dev)

            def call():
                ks.bs_rel_draw(rows, x, cols, group, rtab, F, c["ptab"],
                               c["v_t"], c["mu"], c["lam"], c["alpha"],
                               c["z"], nans, *extra)

            lo, hi = graph_ms(torch, call)
            form = ""
            if takes_real:
                sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                p = ks.draw_plan(F, *rows.shape, extra[0].lo, extra[0].hi,
                                 sms)
                form = f" form={p.form} k={p.k} S={p.S}"
            print(f"[widths] {tag} X10b F={F} {shape} ms={lo:.4f}-{hi:.4f}"
                  f" nans={nans.tolist()}{form}", flush=True)
        del rtab, buckets, c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
