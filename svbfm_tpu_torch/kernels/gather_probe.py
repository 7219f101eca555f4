"""P1: the gather-cost probe (``csrc/gather_probe.cu``).

``gather_rows(t, idx)`` returns o[r, l] = t[idx[r, l], l] for a table ``t``
[S, W] and indices ``idx`` [R, W]: with W = 1 the 1-D gather of
``torch.take``, with W = 128 the lane-local form of
``scripts/pallas_gather_probe.py``.  On a CUDA tensor it launches the
hand-written kernel; on a CPU tensor it runs the plain twin,
``torch.take_along_dim``.  ``chip_smoke.py`` times it to measure what a
gather at a data-dependent address costs on the card.

Replaces ``scripts/pallas_gather_probe.py:main`` (:83), the repository's one
``pl.pallas_call``.
"""

from __future__ import annotations

import torch

from svbfm_tpu_torch.kernels import build


def gather_rows_plain(t, idx):
    return torch.take_along_dim(t, idx.long(), dim=0)


def gather_rows(t, idx):
    if build.on_cpu(idx):
        return gather_rows_plain(t, idx)
    R, W = idx.shape
    dev = idx.device
    build.require(t, torch.float32, (t.shape[0], W), dev, "gather_rows.t")
    build.require(idx, torch.int32, (R, W), dev, "gather_rows.idx")
    out = torch.empty(R, W, dtype=torch.float32, device=dev)
    if R * W == 0:
        return out
    lib = build.load_library("gather_probe")
    with torch.cuda.device(dev):
        rc = lib.svbfm_gather_probe(build.ptr(t), build.ptr(idx), R * W, W,
                                    build.ptr(out), build.stream_of(idx))
    build.check_launch(lib, rc, "gather_probe")
    return out
