"""The hand-written CUDA kernels against their plain twins, on the card.

These need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU mode); without
a GPU they skip.  On the card:  python -m pytest -m cuda tests/
"""

import numpy as np
import pytest
import torch

from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def test_kernels_match_twins_on_ragged_case(cuda):
    import chip_smoke

    before = dict(build.launch_counts)
    out = chip_smoke.check_cases(chip_smoke.ragged_tensors(cuda), "ragged",
                                 timed=False)
    assert set(out) == set(build.launch_counts)
    assert all(build.launch_counts[k] > before[k] for k in before)


def test_learner_on_gpu_matches_cpu(cuda):
    coo = make_movielens_like(num_users=60, num_items=40, num_ratings=5000,
                              rank=2, seed=1)
    tr, te = train_test_split(coo, 0.2, seed=2)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 60])
    cfg = FMConfig(num_attributes=D, num_factor=5, num_groups=2, seed=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()))
    params = init_vb_params(torch.Generator().manual_seed(3), cfg, "cpu")
    hists = []
    for dev in (cuda, "cpu"):
        learner = VBLearner(cfg, SparseDataset.from_coo(tr, D),
                            SparseDataset.from_coo(te, D), meta, device=dev,
                            write_files=False)
        _, h = learner.run(learner.state_from_params(params), num_iter=3,
                           verbose=False)
        hists.append(h)
    for g, c in zip(*hists):
        for k in ("rmse", "train_rmse", "free_energy"):
            np.testing.assert_allclose(g[k], c[k], rtol=1e-5, err_msg=k)
