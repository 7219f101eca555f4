"""Attribute-group metadata (grouped priors / regularization).

Parity with ``DataMetaInfo`` (reference ``src/libfm/src/Data.h:35-69``): maps
each attribute id to a group id; groups drive per-group hyperpriors in
ALS/MCMC (w_mu/w_lambda per group) and per-group precisions in VB
(sigma_w(g), sigma_v(g,f)).
"""

from __future__ import annotations

import numpy as np


class DataMetaInfo:
    def __init__(self, num_attributes: int):
        self.attr_group = np.zeros(num_attributes, dtype=np.int32)
        self.num_attr_groups = 1
        self.num_attr_per_group = np.array([num_attributes], dtype=np.int32)

    @property
    def num_attributes(self) -> int:
        return int(self.attr_group.shape[0])

    def load_groups_from_file(self, filename: str) -> None:
        """One group id per line, one line per attribute (Data.h:49-61)."""
        groups = np.loadtxt(filename, dtype=np.int64).reshape(-1)
        if groups.shape[0] != self.attr_group.shape[0]:
            # the reference DVector::load reads exactly `dim` entries; emulate
            # by truncating / zero-padding
            g = np.zeros(self.attr_group.shape[0], dtype=np.int64)
            n = min(groups.shape[0], g.shape[0])
            g[:n] = groups[:n]
            groups = g
        self.set_groups(groups.astype(np.int32))

    def set_groups(self, groups: np.ndarray) -> None:
        assert groups.shape[0] == self.attr_group.shape[0]
        self.attr_group = groups.astype(np.int32)
        self.num_attr_groups = int(groups.max()) + 1 if groups.size else 1
        self.num_attr_per_group = np.bincount(
            self.attr_group, minlength=self.num_attr_groups
        ).astype(np.int32)

    @staticmethod
    def from_field_offsets(num_attributes: int, offsets: list[int]) -> "DataMetaInfo":
        """Groups = contiguous id ranges starting at each offset."""
        meta = DataMetaInfo(num_attributes)
        groups = np.zeros(num_attributes, dtype=np.int32)
        for g, off in enumerate(offsets):
            groups[off:] = g
        meta.set_groups(groups)
        return meta
