"""K1: FM score and VBFM T-term forward (``csrc/fm_forward.cu``).

Each op takes a channel-stacked, row-major parameter table at any row
stride (``ops/forward.py`` builds it padded, 16-byte aligned channels at a
stride of a multiple of 4 floats; the SGD family passes its own contiguous
[D, 1+K] table) and the padded row layout.  On a CUDA tensor it launches
the hand-written kernel; on a CPU tensor it runs the plain PyTorch twin
beside it.  The twin is also what ``chip_smoke.py`` holds the kernel
against on the card.  ``fm_plan`` mirrors the kernel's form.

Replaces ``svbfm_tpu/ops/forward.py:fm_scores`` (:61) and ``:fm_t_terms``
(:111); ``fm_serve_op`` is K1a with the serving path's output epilogue
(``svbfm_tpu/serve.py:125-155``: the scores clamped to the target range,
or Phi of them), fused into the same kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from svbfm_tpu_torch.kernels import build

_CHUNK = 4  # csrc/fm_forward.cu kChunk: factors a lane takes a pass

# fm_serve_op's output modes (csrc/fm_forward.cu kOutScore, kOutClamp,
# kOutProbit)
SERVE_SCORE, SERVE_CLAMP, SERVE_PROBIT = 0, 1, 2


class FMPlan(NamedTuple):
    vec: int    # floats a table load (4 or 1)
    lanes: int  # lanes a row
    rows: int   # rows a warp
    build: str  # "p2": the kernel built for rows of two positions; "any"


def fm_lanes(K: int) -> int:
    """Lanes a row (``csrc/fm_forward.cu:row_lanes``): min(ceil(K / 4),
    32), 1 at K = 0."""
    return max(1, min(-(-K // _CHUNK), 32))


def fm_plan(tab: torch.Tensor, K: int, P: int) -> FMPlan:
    """K1's form for its table ``tab`` (a [D, 1+K] or [D, 1+2K] view at row
    stride ``tab.stride(0)``) and rows of P positions
    (``csrc/fm_forward.cu:load_width``, ``row_lanes``): 16-byte loads where
    K and the row stride are multiples of 4 floats and the factor
    channels' base (tab + 1) is 16-byte aligned, else 4-byte loads;
    min(ceil(K / 4), 32) lanes a row (1 at K = 0) and 32 // lanes rows a
    warp (5 lanes, 6 rows at K = 20)."""
    wide = (K > 0 and K % 4 == 0 and tab.stride(0) % 4 == 0
            and (tab.data_ptr() + 4) % 16 == 0)
    lanes = fm_lanes(K)
    return FMPlan(4 if wide else 1, lanes, 32 // lanes,
                  "p2" if P == 2 else "any")


# ---- plain twins ------------------------------------------------------------

def fm_scores_plain(tab: torch.Tensor, w0: torch.Tensor, ids: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """tab [D, 1+K] = (w | v^T) at any row stride, w0 0-d; returns scores
    [N]."""
    acc = w0 + torch.zeros(ids.shape[0], dtype=tab.dtype, device=tab.device)
    s = s2 = 0.0
    for p in range(ids.shape[1]):
        g = tab.index_select(0, ids[:, p])  # [N, 1+K]
        xp = vals[:, p]
        acc = acc + g[:, 0] * xp
        d = g[:, 1:] * xp[:, None]
        s = s + d
        s2 = s2 + d * d
    if tab.shape[1] == 1:
        return acc
    return acc + 0.5 * (s * s - s2).sum(1)


def fm_t_terms_plain(tab: torch.Tensor, s0: torch.Tensor, ids: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """tab [D, 1+2K] = (sigma'_w | mu'_v^T | sigma'_v^T) at any row stride,
    s0 0-d; returns T-terms [N]."""
    K = (tab.shape[1] - 1) // 2
    x2 = vals * vals
    acc = s0 + torch.zeros(ids.shape[0], dtype=tab.dtype, device=tab.device)
    q2 = z = neg = 0.0
    for p in range(ids.shape[1]):
        g = tab.index_select(0, ids[:, p])  # [N, 1+2K]
        x2p = x2[:, p]
        acc = acc + g[:, 0] * x2p
        mg, sg = g[:, 1:1 + K], g[:, 1 + K:]
        x2c = x2p[:, None]
        mx = mg * vals[:, p, None]
        q2 = q2 + mx * mx
        z = z + sg * x2c
        neg = neg + mg * mg * (x2c * x2c) * sg + 0.5 * (x2c * x2c) * sg * sg
    if K == 0:
        return acc
    t = 0.5 * z * z + z * q2 - neg
    return acc + t.sum(1)


def serve_bounds(lo: float, hi: float) -> tuple:
    """The clamp's bounds as the kernel takes them: a side whose bound is
    not finite is left open (-Inf / +Inf), as ``serve.py:150-154`` applies
    only finite bounds."""
    return (float(lo) if math.isfinite(lo) else -math.inf,
            float(hi) if math.isfinite(hi) else math.inf)


def serve_epilogue_plain(s: torch.Tensor, mode: int, lo: float,
                         hi: float) -> torch.Tensor:
    """The serving path's output transform of scores ``s``
    (``svbfm_tpu/serve.py:147-155``): ``torch.maximum`` / ``torch.minimum``
    on the finite sides (a NaN stays NaN), or the reference's Phi."""
    if mode == SERVE_PROBIT:
        from svbfm_tpu_torch.learners.base import ref_cdf_gaussian
        return ref_cdf_gaussian(s)
    if mode == SERVE_CLAMP:  # the bounds made on the device (a fill, no
        # host copy: the twin is captured in CUDA graphs)
        if math.isfinite(lo):
            s = torch.maximum(s, s.new_full((), lo))
        if math.isfinite(hi):
            s = torch.minimum(s, s.new_full((), hi))
        return s
    if mode != SERVE_SCORE:
        raise ValueError(f"unknown serve mode {mode}")
    return s


def fm_serve_plain(tab: torch.Tensor, w0: torch.Tensor, ids: torch.Tensor,
                   vals: torch.Tensor, mode: int, lo: float = -math.inf,
                   hi: float = math.inf) -> torch.Tensor:
    """``fm_scores_plain``, then the serve epilogue of ``mode``."""
    return serve_epilogue_plain(fm_scores_plain(tab, w0, ids, vals), mode,
                                lo, hi)


# ---- wrappers ---------------------------------------------------------------

def _launch(kname: str, tab, scalar, ids, vals, channels_per_k):
    N, P = ids.shape
    dev = ids.device
    K = (tab.shape[1] - 1) // channels_per_k
    build.require(ids, torch.int32, (N, P), dev, f"{kname}.ids")
    build.require(vals, torch.float32, (N, P), dev, f"{kname}.vals")
    ld = build.require_rows(tab, torch.float32,
                            (tab.shape[0], 1 + channels_per_k * K), dev,
                            f"{kname}.tab")
    build.require(scalar, torch.float32, (), dev, f"{kname}.scalar")
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    lib = build.load_library("fm_forward")
    with torch.cuda.device(dev):
        rc = getattr(lib, f"svbfm_{kname}")(
            build.ptr(tab), ld, K, build.ptr(scalar),
            build.ptr(ids), build.ptr(vals), N, P, build.ptr(out),
            build.stream_of(ids))
    build.check_launch(lib, rc, kname)
    return out


def fm_scores_op(tab, w0, ids, vals) -> torch.Tensor:
    """Kernel on CUDA tensors, plain twin on CPU tensors."""
    if build.on_cpu(ids):
        return fm_scores_plain(tab, w0, ids, vals)
    return _launch("fm_scores", tab, w0, ids, vals, 1)


def fm_t_terms_op(tab, s0, ids, vals) -> torch.Tensor:
    """Kernel on CUDA tensors, plain twin on CPU tensors."""
    if build.on_cpu(ids):
        return fm_t_terms_plain(tab, s0, ids, vals)
    return _launch("fm_t_terms", tab, s0, ids, vals, 2)


def fm_serve_op(tab, w0, ids, vals, mode: int, lo: float = -math.inf,
                hi: float = math.inf, out=None) -> torch.Tensor:
    """The serving path's predictions [N] of rows ``ids``/``vals`` [N, P]
    over K1a's table: the scores (``SERVE_SCORE``), clamped to the finite
    sides of [lo, hi] (``SERVE_CLAMP``) or Phi of them (``SERVE_PROBIT``).
    Kernel on CUDA tensors, written into ``out`` (a float32 [N] tensor)
    where given; plain twin on CPU tensors.  N = 0 launches nothing."""
    if mode not in (SERVE_SCORE, SERVE_CLAMP, SERVE_PROBIT):
        raise ValueError(f"unknown serve mode {mode}")
    if build.on_cpu(ids):
        s = fm_serve_plain(tab, w0, ids, vals, mode, lo, hi)
        return s if out is None else out.copy_(s)
    N, P = ids.shape
    dev = ids.device
    K = tab.shape[1] - 1
    build.require(ids, torch.int32, (N, P), dev, "fm_serve.ids")
    build.require(vals, torch.float32, (N, P), dev, "fm_serve.vals")
    ld = build.require_rows(tab, torch.float32, (tab.shape[0], 1 + K), dev,
                            "fm_serve.tab")
    build.require(w0, torch.float32, (), dev, "fm_serve.w0")
    if out is None:
        out = torch.empty(N, dtype=torch.float32, device=dev)
    build.require(out, torch.float32, (N,), dev, "fm_serve.out")
    if N == 0:
        return out
    b_lo, b_hi = serve_bounds(lo, hi)
    lib = build.load_library("fm_forward")
    with torch.cuda.device(dev):
        rc = lib.svbfm_fm_serve(
            build.ptr(tab), ld, K, build.ptr(w0), build.ptr(ids),
            build.ptr(vals), N, P, mode, b_lo, b_hi, build.ptr(out),
            build.stream_of(ids))
    build.check_launch(lib, rc, "fm_serve")
    return out
