"""Kernel K1 (FM score and T-term forward): the port's CPU path (the plain
twin) against the JAX package's ``ops.forward`` and the float64 oracle.

Tolerance: rtol 1e-5 (float32 sums over P positions and K factors taken
in another order; measured agreement is ~1e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbfm_tpu.ops import forward as jfwd
from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.kernels import fm_forward as k1
from svbfm_tpu_torch.models.fm import FMParams, fm_predict
from svbfm_tpu_torch.ops import forward as tfwd

from oracle import fm_scores_dense, t_terms_dense

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed=0, N=60, P=3, D=25, K=4):
    """Padded row layout with padding entries (id 0, value 0) and random
    variational parameters."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, D, size=(N, P)).astype(np.int32)
    vals = rng.uniform(0.2, 2.0, size=(N, P)).astype(np.float32)
    nnz = rng.integers(1, P + 1, size=N)
    pad = np.arange(P)[None, :] >= nnz[:, None]
    ids[pad], vals[pad] = 0, 0.0
    p = dict(
        w0=np.float32(rng.normal()), w=rng.normal(0, 0.3, D).astype(np.float32),
        v=rng.normal(0, 0.3, (K, D)).astype(np.float32),
        s0=np.float32(0.05), sw=rng.uniform(0.01, 0.1, D).astype(np.float32),
        sv=rng.uniform(0.01, 0.1, (K, D)).astype(np.float32))
    return ids, vals, ~pad, p


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("k0,k1", [(True, True), (False, True),
                                   (True, False)])
@pytest.mark.parametrize("K", [1, 4])
def test_scores_and_t_terms_match_jax_and_oracle(k0, k1, K):
    ids, vals, real, p = _inputs(K=K)
    N = ids.shape[0]
    got_s = tfwd.fm_scores(_t(p["w0"]), _t(p["w"]), _t(p["v"]), _t(ids),
                           _t(vals), k0=k0, k1=k1).numpy()
    got_t = tfwd.fm_t_terms(_t(p["s0"]), _t(p["sw"]), _t(p["v"]), _t(p["sv"]),
                            _t(ids), _t(vals), k0=k0, k1=k1).numpy()
    ref_s = np.asarray(jfwd.fm_scores(p["w0"], p["w"], p["v"], jnp.asarray(ids),
                                      jnp.asarray(vals), k0=k0, k1=k1))
    ref_t = np.asarray(jfwd.fm_t_terms(p["s0"], p["sw"], p["v"], p["sv"],
                                       jnp.asarray(ids), jnp.asarray(vals),
                                       k0=k0, k1=k1))
    np.testing.assert_allclose(got_s, ref_s, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_t, ref_t, rtol=RTOL, atol=ATOL)

    # float64 oracle on the COO view (padding entries dropped)
    row = np.broadcast_to(np.arange(N)[:, None], ids.shape)[real]
    col, val = ids[real], vals[real]
    zero_w = np.zeros_like(p["w"])
    ora_s = fm_scores_dense(p["w0"] if k0 else 0.0, p["w"] if k1 else zero_w,
                            p["v"], row, col, val, N)
    ora_t = t_terms_dense(p["s0"] if k0 else 0.0, p["sw"] if k1 else zero_w,
                          p["v"], p["sv"], row, col, val, N)
    np.testing.assert_allclose(got_s, ora_s, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got_t, ora_t, rtol=RTOL, atol=1e-5)


def test_fm_predict_clamps_like_jax():
    from svbfm_tpu.models.fm import FMParams as JParams
    from svbfm_tpu.models.fm import fm_predict as jpredict

    ids, vals, _, p = _inputs(seed=3)
    params = FMParams(_t(p["w0"]), _t(p["w"]), _t(p["v"]))
    got = fm_predict(params, _t(ids), _t(vals), min_target=-0.5,
                     max_target=0.5).numpy()
    ref = np.asarray(jpredict(JParams(p["w0"], p["w"], p["v"]),
                              jnp.asarray(ids), jnp.asarray(vals),
                              min_target=-0.5, max_target=0.5))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert got.min() >= -0.5 and got.max() <= 0.5


def test_cpu_tensors_take_the_twin_and_launch_nothing():
    ids, vals, _, p = _inputs(seed=5)
    tab = torch.cat([_t(p["w"])[:, None], _t(p["v"]).T], 1).contiguous()
    before = dict(build.launch_counts)
    out = k1.fm_scores_op(tab, _t(p["w0"]), _t(ids), _t(vals))
    torch.testing.assert_close(out, k1.fm_scores_plain(tab, _t(p["w0"]),
                                                       _t(ids), _t(vals)),
                               rtol=0, atol=0)
    assert build.launch_counts == before


def test_other_devices_raise():
    ids, vals, _, p = _inputs(seed=6)
    meta = _t(ids).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.fm_scores_op(_t(p["w"]), _t(p["w0"]), meta, _t(vals))
