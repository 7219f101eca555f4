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


@pytest.mark.parametrize("k0,k1", [(True, True), (False, True),
                                   (True, False), (False, False)])
@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("K", [0, 1, 4, 5, 20])
def test_padded_tables_match_jax(K, P, k0, k1):
    """The tables ops/forward.py builds for K1 (three pad floats ahead of
    each row, the stride a multiple of 4 floats, the factor channels at
    16-byte addresses) hold the channels and
    zeros elsewhere, and the twins read at that stride give
    svbfm_tpu.ops.forward's scores and T-terms on seeded inputs (rtol
    1e-5, atol 1e-6, as above)."""
    ids, vals, _, p = _inputs(seed=10 * K + P, N=50, P=P, D=23, K=K)
    stab = tfwd.score_table(_t(p["w"]), _t(p["v"]), k1)
    ttab = tfwd.t_term_table(_t(p["sw"]), _t(p["v"]), _t(p["sv"]), k1)
    zero_w = np.zeros_like(p["w"])
    want_s = np.concatenate([(p["w"] if k1 else zero_w)[:, None], p["v"].T],
                            1)
    want_t = np.concatenate([(p["sw"] if k1 else zero_w)[:, None], p["v"].T,
                             p["sv"].T], 1)
    for tab, want in ((stab, want_s), (ttab, want_t)):
        np.testing.assert_array_equal(tab.numpy(), want)
        ld = tab.stride(0)
        assert ld % 4 == 0 and (tab.data_ptr() + 4) % 16 == 0
        assert ld == -(-(3 + tab.shape[1]) // 4) * 4
        buf = torch.as_strided(tab, (tab.shape[0], ld), (ld, 1),
                               tab.storage_offset() - 3)
        pad = torch.ones(ld, dtype=torch.bool)
        pad[3:3 + tab.shape[1]] = False
        assert not buf[:, pad].any()
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
    # the twins give the same at the padded stride as on a contiguous copy
    from svbfm_tpu_torch.kernels.fm_forward import (fm_scores_plain,
                                                    fm_t_terms_plain)

    w0 = _t(np.float32(p["w0"] if k0 else 0.0))
    for plain, tab in ((fm_scores_plain, stab), (fm_t_terms_plain, ttab)):
        torch.testing.assert_close(plain(tab, w0, _t(ids), _t(vals)),
                                   plain(tab.contiguous(), w0, _t(ids),
                                         _t(vals)), rtol=0, atol=0)


@pytest.mark.parametrize("K,width,shift,P,plan", [
    (20, "padded", 0, 2, (4, 5, 6, "p2")),
    (20, "padded", 0, 3, (4, 5, 6, "any")),
    (20, "sgd", 0, 2, (1, 5, 6, "p2")),      # stride 21, base + 1 at 4 bytes
    (20, "padded", 1, 2, (1, 5, 6, "p2")),   # the view one float on
    (20, "padded", 2, 2, (1, 5, 6, "p2")),
    (0, "sgd", 0, 1, (1, 1, 32, "any")),
    (1, "padded", 0, 2, (1, 1, 32, "p2")),
    (2, "padded", 0, 2, (1, 1, 32, "p2")),
    (4, "padded", 0, 7, (4, 1, 32, "any")),
    (5, "padded", 0, 2, (1, 2, 16, "p2")),
    (8, "sgd", 0, 2, (1, 2, 16, "p2")),
    (21, "padded", 0, 2, (1, 6, 5, "p2")),
    (33, "padded", 0, 2, (1, 9, 3, "p2")),
    (64, "padded", 0, 1, (4, 16, 2, "any")),
    (128, "padded", 0, 2, (4, 32, 1, "p2")),
    (130, "padded", 0, 2, (1, 32, 1, "p2"))])
@pytest.mark.parametrize("tterms", [False, True])
def test_fm_plan_is_the_cu_rule(K, width, shift, P, plan, tterms):
    """K1's form (csrc/fm_forward.cu:load_width, row_lanes): 16-byte
    loads where K and the row stride are multiples of 4 and tab + 1 is
    16-byte aligned, else 4-byte loads; min(ceil(K / 4), 32) lanes a row
    (1 at K = 0), 32 // lanes rows a warp, the P = 2 build for rows of two
    positions.  The padded table one or two floats on (``shift``), K not a
    multiple of 4 and SGD's contiguous [D, 1+K] take 4-byte loads.
    Walking the launch over a ragged N reaches every (row, chunk) once,
    and the linear channel of each row on one lane."""
    D, N = 7, 53
    C = 1 + (2 if tterms else 1) * K
    if width == "sgd":
        buf = torch.zeros(D * C + 4)
        assert buf.data_ptr() % 16 == 0
        tab = buf[:D * C].view(D, C)
    else:
        ld = -(-(3 + C) // 4) * 4
        buf = torch.zeros(D * ld + 8)
        assert buf.data_ptr() % 16 == 0
        tab = buf[shift:shift + D * ld].view(D, ld)[:, 3:3 + C]
    p = k1.fm_plan(tab, K, P)
    assert tuple(p) == plan
    G = -(-K // 4)
    warps = -(-N // p.rows)
    blocks = -(-warps * 32 // 128)  # csrc/fm_forward.cu kThreads
    seen, lin = [], []
    for w in range(blocks * 4):
        if w * p.rows >= N:
            continue
        for lane in range(32):
            slot, j = divmod(lane, p.lanes)
            n = w * p.rows + slot
            if slot >= p.rows or n >= N:
                continue
            ch = j
            while ch < G or ch == 0:
                if ch < G:
                    seen.append((n, ch))
                if ch == 0:
                    lin.append(n)
                ch += 32
    assert sorted(seen) == [(n, c) for n in range(N) for c in range(G)]
    assert sorted(lin) == list(range(N))
