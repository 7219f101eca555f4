from svbfm_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    FEATURE_AXIS,
    make_mesh,
    make_mesh2d,
)

# Feature-sharded (tensor-parallel) batch VB lives in tp_vb, imported by
# its users:
#   from svbfm_tpu_torch.parallel.tp_vb import TPVBLearner
