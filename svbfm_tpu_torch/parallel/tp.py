"""Feature-sharded (tensor-parallel) FM scoring.

Counterpart of ``svbfm_tpu/parallel/tp.py``: where the tables outgrow one
device, w [D] and V [K, D] shard along D and each rank scores the rows
over its own id range; out-of-range ids add nothing.  What the ranks sum
are partials, not scores:

    y = w0 + sum_shards(sum_{i in shard} w_i x_i)
        + 0.5 * sum_f [ (sum_shards s_f)^2 - sum_shards s2_f ],

s_f = sum_{i in shard} v_fi x_i: the square comes AFTER the all-reduce of
s_f, so the collective carries the [N, 1 + 2K] partials of kernel T1
(``kernels/fm_forward.py:tp_fm_partials``) and the finalize
(``kernels/fm_forward.py:scores_from_partials``; the T-terms' below)
squares their sums.  ``make_tp_scorer`` keeps the rows replicated and shards the
tables over every rank of a mesh; the learners of ``tp_vb`` shard the
tables over a mesh's feature group and the rows over its data group.
"""

from __future__ import annotations

import numpy as np
import torch

from svbfm_tpu_torch.kernels.fm_forward import (scores_from_partials,
                                                tp_fm_partials)
from svbfm_tpu_torch.ops.forward import _scalar, score_table, t_term_table
from svbfm_tpu_torch.parallel.mesh import Mesh


def t_terms_from_partials(part: torch.Tensor, s0, K: int) -> torch.Tensor:
    """T-terms [N] from T1's (lin | q2 | z | neg) partials summed over the
    shards (``ops/forward.py``'s T(x)); ``s0`` a 0-d tensor."""
    out = part[:, 0]
    if K:
        q2, z = part[:, 1:1 + K], part[:, 1 + K:1 + 2 * K]
        neg = part[:, 1 + 2 * K:1 + 3 * K]
        out = out + (0.5 * z * z + z * q2 - neg).sum(1)
    return out + s0


def sharded_scores(all_reduce, w0, w_l, v_l, ids, vals, lo: int,
                   D_loc: int, k0: bool = True,
                   k1: bool = True) -> torch.Tensor:
    """Scores [N] of rows ``ids``/``vals`` with the tables' shard w_l
    [D_loc], v_l [K, D_loc] of ids [lo, lo + D_loc): T1's partials,
    ``all_reduce`` (in place, over the shards of the tables), the
    finalize."""
    K = v_l.shape[0]
    part = tp_fm_partials(score_table(w_l, v_l, k1), K, False, ids, vals, lo,
                          D_loc)
    return scores_from_partials(all_reduce(part), _scalar(w0, k0, v_l), K)


def sharded_t_terms(all_reduce, s0, sw_l, m_l, s_l, ids, vals, lo: int,
                    D_loc: int, k0: bool = True,
                    k1: bool = True) -> torch.Tensor:
    """VBFM T-terms [N] with the shard's sigma'_w [D_loc], mu'_v and
    sigma'_v [K, D_loc], as ``sharded_scores``."""
    K = m_l.shape[0]
    part = tp_fm_partials(t_term_table(sw_l, m_l, s_l, k1), K, True, ids,
                          vals, lo, D_loc)
    return t_terms_from_partials(all_reduce(part), _scalar(s0, k0, m_l), K)


def shard_params_by_feature(mesh: Mesh, w0, w, v):
    """This rank's shard of (w0, w [D_pad], v [K, D_pad]), tables padded to
    ``make_tp_scorer``'s width: (w0, w[lo:hi], v[:, lo:hi]) on the mesh's
    device, w0 replicated."""
    w, v = torch.as_tensor(np.asarray(w)), torch.as_tensor(np.asarray(v))
    n_loc = w.shape[-1] // mesh.size
    lo = mesh.rank * n_loc
    dev = mesh.device
    return (torch.as_tensor(np.float32(w0), device=dev),
            w[lo:lo + n_loc].to(dev, torch.float32).contiguous(),
            v[:, lo:lo + n_loc].to(dev, torch.float32).contiguous())


def make_tp_scorer(mesh: Mesh, num_attributes: int, k0: bool = True,
                   k1: bool = True):
    """Returns (fn(w0, w_l, v_l, ids, vals) -> scores [N], d_pad): the rows
    ``ids``/``vals`` [N, P] replicated on every rank, the tables sharded
    over all of the mesh's ranks (``shard_params_by_feature``), the
    partials summed over them."""
    n_loc = -(-num_attributes // mesh.size)

    def scorer(w0, w_l, v_l, ids, vals):
        return sharded_scores(mesh.all_reduce, w0, w_l, v_l, ids, vals,
                              mesh.rank * n_loc, n_loc, k0, k1)

    return scorer, n_loc * mesh.size


def pad_feature_dim(arr: np.ndarray, d_pad: int) -> np.ndarray:
    """Zero-pad the last (feature) dimension to the sharded width."""
    pad = d_pad - arr.shape[-1]
    if pad <= 0:
        return arr
    widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
    return np.pad(np.asarray(arr), widths)
