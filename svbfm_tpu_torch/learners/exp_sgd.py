"""Exponential-family SGD: the stochastic learner (``-method exp_sgd_stoc``).

Counterpart of ``svbfm_tpu/learners/exp_sgd.py:ExpSGDStocLearner``
(:264-273): ``SGDLearner`` with the exponential-family multiplier
p / stdev - y, unclamped (exp_fm_learn_sgd_stoc_element.h:29-43), on the
same kernels X9a and X9b.  The full-batch coordinate sweep ``exp_sgd``
(``exp_sgd.py:62-153``, kernel X9d) is not ported yet.
"""

from __future__ import annotations

import dataclasses

from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.sgd import SGDLearner


class ExpSGDStocLearner(SGDLearner):
    """Per-example exponential-family SGD, minibatch-damped as
    ``SGDLearner``."""

    method = "exp_sgd_stoc"

    def __init__(self, cfg: FMConfig, *args, **kwargs):
        super().__init__(dataclasses.replace(cfg, exp_family=True), *args,
                         **kwargs)


class ExpSGDLearner:
    """The full-batch exp-family coordinate sweep: not ported yet."""

    method = "exp_sgd"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "-method exp_sgd (the full-batch exp-family coordinate sweep, "
            "kernel X9d) is not ported yet (ROADMAP.md queue 1, item 8: the "
            "next slice)")
