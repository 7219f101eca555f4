"""Factorization-machine model core (point-estimate parameters).

Counterpart of ``svbfm_tpu/models/fm.py``: the global bias w0, the linear
weights w [D] and the factor matrix V [K, D], and the regression
prediction, clamped to the target range.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from svbfm_tpu_torch.ops.forward import fm_scores


class FMParams(nn.Module):
    """Holds w0 (scalar), w [D] and v [K, D] as buffers (no gradients)."""

    def __init__(self, w0: torch.Tensor, w: torch.Tensor, v: torch.Tensor):
        super().__init__()
        self.register_buffer("w0", w0)
        self.register_buffer("w", w)
        self.register_buffer("v", v)


def init_fm_params(generator: torch.Generator, D: int, K: int,
                   init_stdev: float = 0.1,
                   init_w_normal: bool = False) -> FMParams:
    """``fm_model::init`` (svbfm_tpu/models/fm.py:33-48): v ~ init_stdev
    N(0,1) of shape [K, D]; w drawn the same way with ``init_w_normal``
    (MCMC re-draws it, libfm.cpp:298), else 0; w0 = 0.  The draws come from
    ``generator``, on its device; move the result where it is needed."""
    v = init_stdev * torch.randn(K, D, generator=generator,
                                 device=generator.device)
    w = (init_stdev * torch.randn(D, generator=generator,
                                  device=generator.device)
         if init_w_normal else torch.zeros(D, device=generator.device))
    return FMParams(torch.zeros((), device=generator.device), w, v)


def fm_predict(params: FMParams, ids: torch.Tensor, vals: torch.Tensor,
               min_target: Optional[float] = None,
               max_target: Optional[float] = None,
               k0: bool = True, k1: bool = True) -> torch.Tensor:
    """Regression predictions: FM scores (kernel K1) clamped to
    [min_target, max_target]."""
    p = fm_scores(params.w0, params.w, params.v, ids, vals, k0=k0, k1=k1)
    if min_target is None and max_target is None:
        return p
    return torch.clamp(p, min_target, max_target)
