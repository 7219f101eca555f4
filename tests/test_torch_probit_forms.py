"""The Python mirrors of X12a's and X12b's launch geometry
(``csrc/probit.cu``): the grid each wrapper gives N rows, which thread takes
which rows (every row once, in chunks of 4, the N % 4 rows past the last
chunk to the first threads), X12b's sum order (a function of N alone)
emulated in float32 against the plain twin, and the constants the mirrors
share with the source.  CPU only: the kernels run on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from svbfm_tpu_torch.kernels import probit as kp
from svbfm_tpu_torch.learners.base import ref_cdf_gaussian

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "svbfm_tpu_torch", "csrc", "probit.cu")

# sizes on both sides of X12b's block boundaries (1,024 rows a block), of
# its cap (264 blocks) and of a second pass over the capped grid
EVAL_NS = [1, 2, 3, 4, 5, 1023, 1024, 1025, 2047, 2049, 99_978,
           97 * 1024 + 1, 98 * 1024, 98 * 1024 + 1, 264 * 1024 - 1,
           264 * 1024, 264 * 1024 + 1, 264 * 1024 + 3, 2 * 264 * 1024 + 7]


def chunk_rows(n, blocks, threads):
    """The rows each of the grid's threads takes, in the order it adds them:
    its chunks t, t + T, ... (T = blocks * threads), 4 rows each, then row
    4 (n // 4) + t where that is below n (csrc/probit.cu's loops)."""
    T, n4 = blocks * threads, n // kp.CHUNK
    out = []
    for t in range(T):
        rows = [kp.CHUNK * c + j for c in range(t, n4, T)
                for j in range(kp.CHUNK)]
        if kp.CHUNK * n4 + t < n:
            rows.append(kp.CHUNK * n4 + t)
        out.append(rows)
    return out


def test_block_width_matches_the_source():
    src = open(SRC).read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert threads == kp.LATENT_THREADS == kp.EVAL_THREADS
    assert kp.CHUNK == 4


@pytest.mark.parametrize("n,blocks", [(1, 1), (3, 1), (1024, 1), (1025, 2),
                                      (1_000_022, 977), (99_978, 98)])
def test_latent_blocks(n, blocks):
    assert kp.latent_blocks(n) == blocks


@pytest.mark.parametrize("n,blocks", [(1, 1), (1024, 1), (1025, 2),
                                      (99_978, 98), (264 * 1024, 264),
                                      (264 * 1024 + 1, 264),
                                      (2 * 264 * 1024 + 7, 264)])
def test_eval_blocks(n, blocks):
    assert kp.eval_blocks(n) == blocks


def _covered(n, blocks, threads):
    rows = chunk_rows(n, blocks, threads)
    assert len(rows) == blocks * threads
    flat = [r for t in rows for r in t]
    assert sorted(flat) == list(range(n))
    return rows


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 1023, 1025, 4097, 99_979])
def test_latent_grid_takes_every_row_once(n):
    """X12a: a thread a chunk, so every thread takes at most one chunk and,
    among the first N % 4 threads, one row past the chunks."""
    rows = _covered(n, kp.latent_blocks(n), kp.LATENT_THREADS)
    assert all(len(t) <= kp.CHUNK + 1 for t in rows)
    assert all(len(t) <= kp.CHUNK for t in rows[n % 4:])


@pytest.mark.parametrize("n", EVAL_NS)
def test_eval_grid_takes_every_row_once(n):
    rows = _covered(n, kp.eval_blocks(n), kp.EVAL_THREADS)
    # chunks in order, 4 rows each, then the thread's tail row
    for t, r in enumerate(rows[:64]):
        body = r[:len(r) - (1 if 4 * (n // 4) + t < n else 0)]
        assert body == sorted(body) and len(body) % 4 == 0


def _butterfly(v, axis_len):
    """Lane 0 of a xor butterfly over the last axis (warp_sum's order)."""
    o = axis_len // 2
    while o:
        v = v + v[..., np.arange(axis_len) ^ o]
        o //= 2
    return v[..., 0]


def _emulated_sums(terms, n):
    """X12b's four sums of per-row terms [n, 4] in the kernel's order, in
    float32: each thread's rows in order, a butterfly over each warp, over
    the block's warps (warp 0's lanes past the warps add zeros), then lane
    l of the last block's warp 0 adds partials l, l + 32, ... in order, and
    a butterfly."""
    blocks, T = kp.eval_blocks(n), kp.eval_blocks(n) * kp.EVAL_THREADS
    per_thread = np.zeros((T, 4), np.float32)
    for t, rows in enumerate(chunk_rows(n, blocks, kp.EVAL_THREADS)):
        for r in rows:
            per_thread[t] += terms[r]
    w = per_thread.reshape(blocks, kp.EVAL_THREADS // 32, 32, 4)
    warps = _butterfly(np.moveaxis(w, 3, 2), 32)          # [B, W, 4]
    lanes = np.zeros((blocks, 4, 32), np.float32)
    lanes[:, :, :warps.shape[1]] = np.moveaxis(warps, 2, 1)
    part = _butterfly(lanes, 32)                          # [B, 4]
    acc = np.zeros((4, 32), np.float32)
    for b in range(blocks):
        acc[:, b % 32] += part[b]
    return _butterfly(acc, 32)


@pytest.mark.parametrize("n", [1, 7, 1025, 4099, 99_978, 264 * 1024 + 3])
@pytest.mark.parametrize("it", [None, 6])
def test_eval_order_emulated_matches_twin(n, it):
    """The kernel's sum order, emulated in float32 over the twin's per-row
    terms, gives the twin's four means within float32 rounding: the order
    covers every row once and needs nothing but N."""
    rng = np.random.default_rng(n)
    scores = torch.from_numpy(rng.normal(0, 1.5, n).astype(np.float32))
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, 1.0, -1.0)
                         .astype(np.float32))
    valid = torch.from_numpy((rng.random(n) < 0.9).astype(np.float32))
    acc = torch.from_numpy(rng.uniform(0, 4, n).astype(np.float32))
    pa = pb = None
    if it is not None:
        pa, pb = acc.clone(), acc.clone()
    want = kp.probit_eval_plain(scores, y, valid, float(n), pa, pb,
                                it or 0).numpy()
    prob = ref_cdf_gaussian(scores)
    pm = prob if it is None else (acc + prob) / (it + 1.0)
    hit, ll = kp._scored(pm, y, valid)
    hit_t, ll_t = kp._scored(prob, y, valid)
    terms = torch.stack([hit, ll, hit_t, ll_t], 1).numpy()
    s = _emulated_sums(terms, n)
    got = np.array([s[0] / n, -s[1] / n, s[2] / n, -s[3] / n], np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    assert np.array_equal(_emulated_sums(terms, n), s)
