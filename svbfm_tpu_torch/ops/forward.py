"""FM forward over the padded row layout: scores and VBFM T-terms.

The public functions keep the JAX package's signatures and its [K, D]
factor layout (``svbfm_tpu/ops/forward.py``); they stack the parameters
into the row-major [D, 1+K] / [D, 1+2K] tables that kernel K1 reads
(``kernels/fm_forward.py``), which runs the CUDA kernel on a GPU and its
plain twin on the CPU.  A table is built in one ``torch.cat`` with three
pad floats ahead of each row and its stride rounded up to 4 floats
(``score_table``, ``t_term_table``: 24 floats at K = 20, 44 for the
T-terms), so that the kernel reads the factor channels in 16-byte loads
and a score row (96 bytes at K = 20) spans three 32-byte sectors; the op
gets the view of the channels.

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


_LEAD = 3  # pad floats ahead of a row: the factor channels start at 16 bytes


def _padded(cols: list) -> torch.Tensor:
    """``cols`` ([D, c] each) side by side in one row-major table, behind
    _LEAD pad floats a row at a stride of a multiple of 4 floats; returns
    the view of the columns."""
    D = cols[0].shape[0]
    width = sum(c.shape[1] for c in cols)
    ld = -(-(_LEAD + width) // 4) * 4
    pad = torch.zeros(D, ld - width, dtype=torch.float32,
                      device=cols[0].device)
    buf = torch.cat([pad[:, :_LEAD], *cols, pad[:, _LEAD:]], dim=1)
    return buf[:, _LEAD:_LEAD + width]


def score_table(w, v, k1: bool = True) -> torch.Tensor:
    """K1a's table (w | v^T), [D, 1+K] at the padded stride; v is [K, D]."""
    D = v.shape[1]
    return _padded([_column(w, k1, D, v), v.T])


def t_term_table(sigma_w_dash, mu_v_dash, sigma_v_dash,
                 k1: bool = True) -> torch.Tensor:
    """K1b's table (sigma'_w | mu'_v^T | sigma'_v^T), [D, 1+2K] at the
    padded stride."""
    D = mu_v_dash.shape[1]
    return _padded([_column(sigma_w_dash, k1, D, mu_v_dash), mu_v_dash.T,
                    sigma_v_dash.T])


def fm_scores(w0, w, v, ids, vals, k0: bool = True,
              k1: bool = True) -> torch.Tensor:
    """FM scores [N] for rows ``ids``/``vals`` [N, P]; v is [K, D]."""
    return fm_scores_op(score_table(w, v, k1), _scalar(w0, k0, v), ids, vals)


def fm_t_terms(sigma_0_dash, sigma_w_dash, mu_v_dash, sigma_v_dash, ids, vals,
               k0: bool = True, k1: bool = True) -> torch.Tensor:
    """VBFM T-terms (predictive-variance propagation) [N] per row."""
    tab = t_term_table(sigma_w_dash, mu_v_dash, sigma_v_dash, k1)
    return fm_t_terms_op(tab, _scalar(sigma_0_dash, k0, mu_v_dash), ids, vals)
