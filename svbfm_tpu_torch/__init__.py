"""svbfm_tpu_torch — the PyTorch/CUDA port of svbfm_tpu for NVIDIA Hopper.

Gibbs MCMC and ALS (``-method mcmc|als``), batch VBFM (``-method vb``, fast
and exact mode), online VBFM (``-method vb_online``) and the SGD family,
on one device, run through hand-written CUDA kernels (``csrc/``, built
with nvcc for sm_90a at first use); every kernel has a plain PyTorch twin
that runs on CPU tensors.  ``serve.BatchScorer`` scores new rows with a
trained model; ``utils/`` holds checkpoints, the RLog, profiling hooks
and the sparse containers.  The CLI is ``python -m svbfm_tpu_torch.cli``.  The JAX package ``svbfm_tpu`` stays
beside it as the reference; this package imports neither it nor JAX.
"""

__version__ = "0.1.0"

from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan  # noqa: F401
from svbfm_tpu_torch.models.fm import FMParams, fm_predict  # noqa: F401
