"""X10d: the block-structure forward pass and the data-row resync
(``csrc/bs_forward.cu``; the joined scores in ``csrc/fm_forward.cu``).

``bs_rel_moments`` builds a relation's moments rows (qB | lin | sumsB),
K + 2 channels at a row stride of a multiple of 8 floats
(``moments_table``), from the parameter table, lanes over the channels of
a row (``moments_plan``); ``bs_scores`` scores data rows from their main
row layout and each relation's moments at the joined row, never
materialising the join: K1a's kernel in its relations mode
(``scores_plan``), which reads any number of relations through two device
arrays of pointers (``pointer_table``), built once per set of tensors;
``bs_resync`` carries a relation sweep's per-row deltas back to the data
rows (e += sum dy[j] + sum qO dqB[j], q += dqB[j]), and with no e builds
the q cache (q += qB[j]).  On CUDA tensors each op launches its
hand-written kernel; on CPU tensors it runs the plain PyTorch twin beside
it, the JAX arithmetic.  The resync's form (``resync_plan``) follows F and
its operands' alignment: four data rows a thread at F = 1, lanes over
16-byte (else 8- or 4-byte) chunks of a row at F >= 2.

The scores use a relation row's sB only through its sum over the factors
(1/2 sum_f (s_f^2 - s2_f), s2_f = sum_p (v_f x)^2 + sum_r sB_r,f), so a
moments row holds that sum alone: 24 floats at K = 20, three 32-byte
sectors for the scores' gathers, where (lin | qB | sB) took 41 at no
alignment, six or seven.

Layouts (see ``csrc/bs_forward.cu``): stab [D_all, 1+K] = (w | v^T), as
kernel K1 reads it; rids/rvals [R, Pr] a relation's row layout in its local
attribute ids, which sit at stab rows off .. off + Dr - 1.

Replaces ``svbfm_tpu/learners/mcmc_bs.py:bs_scores`` (:215-268), the qB
build at the v sweep's entry (:700-708) and the resyncs (:463-468,
:490-497, :689-690, :820-824).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.kernels.fm_forward import fm_lanes

_I32, _F32 = torch.int32, torch.float32


# ---- the relation-row moments -------------------------------------------------

class MomentsPlan(NamedTuple):
    """How the moments kernel lays a relation's rows over a warp:
    ``lanes`` lanes a row, lane l taking ``channels`` of its channels
    (w | v) a pass, l, l + lanes, ...; ``rows`` rows a warp."""

    lanes: int
    channels: int
    rows: int


def moments_plan(K: int) -> MomentsPlan:
    """The moments kernel's form at K factors
    (``csrc/bs_forward.cu:moments_lanes``, ``svbfm_bs_rel_moments``): 3
    channels a lane a pass, the next power of two >= (K + 1) / 3 lanes a
    row, at most 32 (8 lanes and 4 rows a warp at K = 20)."""
    need = -(-(K + 1) // 3)
    G = 1
    while G < need and G < 32:
        G *= 2
    return MomentsPlan(G, 3, 32 // G)


def moments_stride(K: int) -> int:
    """A moments row's stride: K + 2 channels rounded up to 8 floats, so
    that every row starts on a 32-byte sector (24 at K = 20)."""
    return -(-(K + 2) // 8) * 8


def moments_table(R: int, K: int, device) -> torch.Tensor:
    """A moments table to write into: the [R, K+2] view of the channels of
    an [R, moments_stride(K)] buffer.  Its padding is never written or
    read."""
    return torch.empty(R, moments_stride(K), dtype=_F32,
                       device=device)[:, :K + 2]


def lane_tree_sum(c, lanes: int):
    """The moments kernel's sum of ``c`` [R, C] over its channels 1..C-1
    in its order: lane l sums channels l, l + lanes, ... in ascending
    order (channel 0, lin, adds nothing), then lane l adds lane l + d for
    d = 1, 2, 4, ... below ``lanes`` (the segmented shuffle); lane 0's
    sum."""
    R, C = c.shape
    M = -(-C // lanes)
    t = torch.zeros(R, M * lanes, dtype=c.dtype, device=c.device)
    t[:, 1:C] = c[:, 1:]
    t = t.view(R, M, lanes)
    part = t[:, 0]
    for m in range(1, M):
        part = part + t[:, m]
    d = 1
    while d < lanes:
        part = torch.cat([part[:, :lanes - d] + part[:, d:],
                          part[:, lanes - d:]], 1)
        d *= 2
    return part[:, 0]


def bs_rel_moments_plain(rids, rvals, stab, off: int, k1: bool = True):
    """(qB | lin | sumsB) [R, K+2] over the relation's positions in order
    (mcmc_bs.py:230-234, :251-258), at ``moments_table``'s stride; lin is 0
    without k1; sumsB = sum_f sB_f in the kernel's order
    (``lane_tree_sum``)."""
    R = rids.shape[0]
    K = stab.shape[1] - 1
    s = torch.zeros(R, K + 1, dtype=_F32, device=stab.device)
    s2 = torch.zeros_like(s)
    for p in range(rids.shape[1]):
        d = stab.index_select(0, rids[:, p] + off) * rvals[:, p, None]
        s = s + d
        s2 = s2 + d * d
    out = moments_table(R, K, stab.device)
    out[:, :K] = s[:, 1:]
    out[:, K] = s[:, 0] if k1 else 0.0
    out[:, K + 1] = lane_tree_sum(s2, moments_plan(K).lanes)
    return out


def bs_rel_moments(rids, rvals, stab, off: int, k1: bool = True, out=None):
    """The moments [R, K+2]; written into ``out`` when one is given (a
    ``moments_table`` whose address stays fixed, so that ``bs_scores``
    finds its pointer table built)."""
    if build.on_cpu(rids):
        m = bs_rel_moments_plain(rids, rvals, stab, off, k1)
        return m if out is None else out.copy_(m)
    R, Pr = rids.shape
    K = stab.shape[1] - 1
    dev = rids.device
    build.require(rids, _I32, (R, Pr), dev, "bs_rel_moments.rids")
    build.require(rvals, _F32, (R, Pr), dev, "bs_rel_moments.rvals")
    build.require(stab, _F32, (stab.shape[0], K + 1), dev,
                  "bs_rel_moments.stab")
    if out is None:
        out = moments_table(R, K, dev)
    ldm = build.require_rows(out, _F32, (R, K + 2), dev, "bs_rel_moments.out")
    if R == 0:
        return out
    lib = build.load_library("bs_forward")
    with torch.cuda.device(dev):
        rc = lib.svbfm_bs_rel_moments(
            build.ptr(rids), build.ptr(rvals), R, Pr, build.ptr(stab), off, K,
            int(k1), build.ptr(out), ldm, build.stream_of(rids))
    build.check_launch(lib, rc, "bs_rel_moments")
    return out


# ---- the joined scores --------------------------------------------------------

class ScoresPlan(NamedTuple):
    vec: int     # floats a moments-row load (4 or 1)
    lanes: int   # lanes a data row (4-factor chunks)
    rows: int    # data rows a warp
    build: str   # "p1": the kernel built for rows of one position; "any"
    stride: int  # the moments rows' stride


def scores_plan(K: int, P: int, ldm: int, aligned: bool) -> ScoresPlan:
    """``bs_scores``' form (``csrc/fm_forward.cu:svbfm_bs_scores``,
    ``moments_width``, ``row_lanes``): K1a's lanes and rows at K, its
    build for rows of one position, and moments rows read in
    16-byte loads where K and their stride ``ldm`` are multiples of 4 and
    every table's base is 16-byte aligned (``aligned``), else 4-byte
    loads."""
    vec = 4 if K > 0 and K % 4 == 0 and ldm % 4 == 0 and aligned else 1
    lanes = fm_lanes(K)
    return ScoresPlan(vec, lanes, 32 // lanes,
                      "p1" if P == 1 else "any", ldm)


def scores_plan_of(stab, ids, moms) -> ScoresPlan:
    """``scores_plan`` for the tensors of one ``bs_scores`` call."""
    K = stab.shape[1] - 1
    ldm = moms[0].stride(0) if moms else moments_stride(K)
    return scores_plan(K, ids.shape[1], ldm,
                       all(m.data_ptr() % 16 == 0 for m in moms))


def bs_scores_plain(stab, w0, ids, vals, joins, moms):
    """Scores [N] (mcmc_bs.py:224-268): the main row layout, then each
    relation's moments row at the joined row,
    w0 + sum w x + sum_r lin_r + 1/2 [sum_f (s_f^2 - s2_f) - sum_r sumsB_r]
    with s_f = sum_p v_f x + sum_r qB_r,f and s2_f = sum_p (v_f x)^2."""
    K = stab.shape[1] - 1
    acc = w0 + torch.zeros(ids.shape[0], dtype=_F32, device=stab.device)
    s = s2 = 0.0
    for p in range(ids.shape[1]):
        g = stab.index_select(0, ids[:, p])
        xp = vals[:, p]
        acc = acc + g[:, 0] * xp
        d = g[:, 1:] * xp[:, None]
        s = s + d
        s2 = s2 + d * d
    for j, m in zip(joins, moms):
        acc = acc + m[:, K].index_select(0, j)
    if K == 0:
        return acc
    sb = 0.0
    for j, m in zip(joins, moms):
        g = m.index_select(0, j)
        s = s + g[:, :K]
        sb = sb + g[:, K + 1]
    return acc + 0.5 * ((s * s - s2).sum(1) - sb)


def pointer_table(tensors, dev) -> torch.Tensor:
    """int64 [n] of the tensors' ``data_ptr()``s on ``dev``
    (``build.device_table``): the device arrays through which
    ``bs_scores`` reads any number of relations."""
    return build.device_table(tuple(t.data_ptr() for t in tensors) or (0,),
                              dev)


def bs_scores(stab, w0, ids, vals, joins, moms):
    if build.on_cpu(ids):
        return bs_scores_plain(stab, w0, ids, vals, joins, moms)
    N, P = ids.shape
    K = stab.shape[1] - 1
    dev = ids.device
    req = build.require
    ld = build.require_rows(stab, _F32, (stab.shape[0], K + 1), dev,
                            "bs_scores.stab")
    req(w0, _F32, (), dev, "bs_scores.w0")
    req(ids, _I32, (N, P), dev, "bs_scores.ids")
    req(vals, _F32, (N, P), dev, "bs_scores.vals")
    if len(joins) != len(moms):
        raise ValueError(f"bs_scores: {len(joins)} joins, {len(moms)} "
                         "moment tables")
    strides = set()
    for r, (j, m) in enumerate(zip(joins, moms)):
        req(j, _I32, (N,), dev, f"bs_scores.joins[{r}]")
        strides.add(build.require_rows(m, _F32, (m.shape[0], K + 2), dev,
                                       f"bs_scores.moms[{r}]"))
    if len(strides) > 1:
        raise ValueError(f"bs_scores: the moments tables' row strides "
                         f"differ ({sorted(strides)})")
    ldm = strides.pop() if strides else moments_stride(K)
    out = torch.empty(N, dtype=_F32, device=dev)
    if N == 0:
        return out
    aligned = all(m.data_ptr() % 16 == 0 for m in moms)
    jp, mp = pointer_table(joins, dev), pointer_table(moms, dev)
    lib = build.load_library("fm_forward")
    with torch.cuda.device(dev):
        rc = lib.svbfm_bs_scores(
            build.ptr(stab), ld, K, build.ptr(w0), build.ptr(ids),
            build.ptr(vals), N, P, len(joins), build.ptr(jp), build.ptr(mp),
            ldm, int(aligned), build.ptr(out), build.stream_of(ids))
    build.check_launch(lib, rc, "bs_scores")
    return out


# ---- the resync ---------------------------------------------------------------

_RESYNC_ROWS = 4  # csrc/bs_forward.cu kResyncRows: data rows a thread, F = 1


class ResyncPlan(NamedTuple):
    """How the resync runs: its form ("rows": F = 1, ``rows`` data rows a
    thread; "chunks": F >= 2, ``lanes`` lanes a data row over chunks of
    ``vec`` floats, ``rows`` data rows a warp); vec, the floats a load
    (at F = 1: 4 where join, q and e take 16-byte loads, else 1)."""

    form: str
    vec: int
    lanes: int
    rows: int


def resync_plan(F: int, ld1: int, addrs: dict) -> ResyncPlan:
    """The resync's form at F >= 1 factors, qB1's row stride ld1 and the
    operands' device addresses ``addrs`` (join, dy, qB1, qB0, q, e; 0 or
    absent for one not given), a function of F and of alignment
    (``csrc/bs_forward.cu:svbfm_bs_resync``, ``resync_vec``)."""
    a = {k: addrs.get(k, 0) for k in ("join", "dy", "qB1", "qB0", "q", "e")}
    if F == 1:
        v4 = (a["join"] % 16 == 0 and (not a["qB1"] or a["q"] % 16 == 0)
              and a["e"] % 16 == 0)
        return ResyncPlan("rows", 4 if v4 else 1, 1, _RESYNC_ROWS)
    vec = next((v for v in (4, 2) if F % v == 0
                and (not a["qB1"] or ld1 % v == 0)
                and all(a[k] % (4 * v) == 0
                        for k in ("dy", "qB1", "qB0", "q"))), 1)
    G = min(F // vec, 32)
    return ResyncPlan("chunks", vec, G, 32 // G)


def resync_plan_of(join, F: int, dy, qB1, qB0, q, e) -> ResyncPlan:
    """``resync_plan`` for the tensors of one ``bs_resync`` call."""
    ts = dict(join=join, dy=dy, qB1=qB1, qB0=qB0, q=q, e=e)
    return resync_plan(F, 0 if qB1 is None else qB1.stride(0),
                       {k: t.data_ptr() for k, t in ts.items()
                        if t is not None})


def bs_resync_plain(join, F: int, dy, qB1, qB0, q, e) -> None:
    """In place on q [N, F] and e [N] (either may be None): e += sum_f
    dy[j] + sum_f (q - qB0[j]) (qB1 - qB0)[j], then q += (qB1 - qB0)[j]
    (mcmc_bs.py:463-468, :820-824; the w resync :689-690 has dy alone, the
    q build :490-497 qB1 alone)."""
    de = None
    if dy is not None:
        de = dy.index_select(0, join).sum(1)
    if qB1 is not None:
        dq = qB1 - qB0 if qB0 is not None else qB1
        gq = dq.index_select(0, join)
        if e is not None:
            t = ((q - qB0.index_select(0, join)) * gq).sum(1)
            de = t if de is None else de + t
        q += gq
    if e is not None and de is not None:
        e += de


def bs_resync(join, F: int, dy, qB1, qB0, q, e) -> None:
    if build.on_cpu(join):
        return bs_resync_plain(join, F, dy, qB1, qB0, q, e)
    N = join.shape[0]
    dev = join.device
    req = build.require
    req(join, _I32, (N,), dev, "bs_resync.join")
    ld1 = 0
    if dy is not None:
        req(dy, _F32, (dy.shape[0], F), dev, "bs_resync.dy")
    if qB1 is not None:
        ld1 = build.require_rows(qB1, _F32, (qB1.shape[0], F), dev,
                                 "bs_resync.qB1")
    if qB0 is not None:
        req(qB0, _F32, (qB0.shape[0], F), dev, "bs_resync.qB0")
    if q is not None:
        req(q, _F32, (N, F), dev, "bs_resync.q")
    if e is not None:
        req(e, _F32, (N,), dev, "bs_resync.e")
    if qB1 is not None and q is None:
        raise ValueError("bs_resync: qB1 needs the q it updates")
    if N == 0 or F == 0:
        return
    lib = build.load_library("bs_forward")

    def p(t):
        return None if t is None else build.ptr(t)

    with torch.cuda.device(dev):
        rc = lib.svbfm_bs_resync(build.ptr(join), N, F, p(dy), p(qB1), ld1,
                                 p(qB0), p(q), p(e), build.stream_of(join))
    build.check_launch(lib, rc, "bs_resync")
