"""FM forward over the padded row layout: scores and VBFM T-terms.

The public functions keep the JAX package's signatures and its [K, D]
factor layout (``svbfm_tpu/ops/forward.py``); they stack the parameters
into the row-major [D, 1+K] / [D, 1+2K] tables that kernel K1 reads
(``kernels/fm_forward.py``), which runs the CUDA kernel on a GPU and its
plain twin on the CPU.

    y(x) = w0 + sum_i w_i x_i + 0.5 * sum_f [ (sum_i v_fi x_i)^2
                                              - sum_i v_fi^2 x_i^2 ]
    T(x) = sigma'_0 + sum_i sigma'_w,i x_i^2
         + sum_f [ 0.5 * z_f^2 + z_f * q2_f
                   - sum_i (m_fi^2 x_i^4 s_fi + 0.5 x_i^4 s_fi^2) ]

Padding entries have value 0, so they contribute nothing.
"""

from __future__ import annotations

import torch

from svbfm_tpu_torch.kernels.fm_forward import fm_scores_op, fm_t_terms_op


def _scalar(a, on: bool, like: torch.Tensor) -> torch.Tensor:
    if on:
        return torch.as_tensor(a, dtype=torch.float32, device=like.device)
    return torch.zeros((), dtype=torch.float32, device=like.device)


def _column(a, on: bool, D: int, like: torch.Tensor) -> torch.Tensor:
    if on:
        return a.to(torch.float32)[:, None]
    return torch.zeros(D, 1, dtype=torch.float32, device=like.device)


def fm_scores(w0, w, v, ids, vals, k0: bool = True,
              k1: bool = True) -> torch.Tensor:
    """FM scores [N] for rows ``ids``/``vals`` [N, P]; v is [K, D]."""
    D = v.shape[1]
    tab = torch.cat([_column(w, k1, D, v), v.T], dim=1).contiguous()
    return fm_scores_op(tab, _scalar(w0, k0, v), ids, vals)


def fm_t_terms(sigma_0_dash, sigma_w_dash, mu_v_dash, sigma_v_dash, ids, vals,
               k0: bool = True, k1: bool = True) -> torch.Tensor:
    """VBFM T-terms (predictive-variance propagation) [N] per row."""
    D = mu_v_dash.shape[1]
    tab = torch.cat([_column(sigma_w_dash, k1, D, mu_v_dash), mu_v_dash.T,
                     sigma_v_dash.T], dim=1).contiguous()
    return fm_t_terms_op(tab, _scalar(sigma_0_dash, k0, mu_v_dash), ids, vals)
