"""The Python mirrors of the form choices of X8a/X14a
(``csrc/mcmc_sweep.cu``) and K3/X13a (``csrc/vb_sweep.cu``): the form each
launcher takes for F factors on a [C, L] bucket, held to a table worked out
from the launchers' C formulas, and the constants the mirrors share with
the sources.  CPU only: the kernels themselves run on the card
(``tests/test_torch_out_of_core_cuda.py``, ``tests/test_torch_kernels_cuda.py``).
"""

import os
import re

import pytest
import torch

from svbfm_tpu_torch.kernels import mcmc_sweep as km
from svbfm_tpu_torch.kernels import vb_sweep as kv

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "svbfm_tpu_torch", "csrc")
LS = (1, 16, 40, 64, 128, 256)

# X8a's exact mode on a bucket of 6,028 columns: F = 1 takes f1_lanes
# (a slot a lane up to L = 16, else a warp: 256 slots a warp at C >= 2048),
# 2 <= F <= 4 the lanes form (col_lanes: the next power of two >= L / 8, 4
# to 32; lanes_block_cols: ceil(6028 / 128) = 48 columns a block, at most
# 256 / U), F = 20 a block of 256 threads (230 sums a column > 128)
DRAW = {
    1: [("f1", 1, 1), ("f1", 16, 1), ("f1", 32, 1), ("f1", 32, 1),
        ("f1", 32, 1), ("f1", 32, 1)],
    2: [("lanes", 4, 48), ("lanes", 4, 48), ("lanes", 8, 32),
        ("lanes", 8, 32), ("lanes", 16, 16), ("lanes", 32, 8)],
    20: [("block", 256, 1)] * 6,
}
DRAW[3] = DRAW[4] = DRAW[2]

# K3 on 6,028 columns with q and tq aligned (vec = 4 at F = 4 and 20, 2 at
# F = 2, else 1): the lanes form at F <= 4 on L <= 128 (stat_lanes: the
# next power of two >= L / 4, 8 to 32; lanes_block_cols: 48 columns a block,
# at most 256 / U: 8 warps), as (form, lanes, warps, groups, columns a
# block); past it launch_col_stats' blocks (warps: ceil(L / (entries a
# slot a round x slots a warp)), at least one thread a value a slot sums,
# at most 8; F = 20: 5 chunks, 6 slots a warp)
STATS = {
    F: [("lanes", 8, 8, 1, 32), ("lanes", 8, 8, 1, 32),
        ("lanes", 16, 8, 1, 16), ("lanes", 16, 8, 1, 16),
        ("lanes", 32, 8, 1, 8)] for F in (1, 2, 3, 4)}
STATS[1].append(("block", 1, 2, 1, 1))
STATS[2].append(("block", 1, 2, 1, 1))
STATS[3].append(("block", 3, 7, 1, 1))
STATS[4].append(("block", 1, 4, 1, 1))
STATS[20] = [("block", 5, w, 1, 1) for w in (2, 2, 4, 6, 8, 8)]
VEC = {1: 1, 2: 2, 3: 1, 4: 4, 20: 4}


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("F", [1, 2, 3, 4, 20])
def test_col_draw_form_matches_the_launcher(F, L):
    assert km.col_draw_form(F, 6028, L) == DRAW[F][LS.index(L)]


@pytest.mark.parametrize("L", LS)
@pytest.mark.parametrize("F", [1, 2, 3, 4, 20])
def test_col_stats_form_matches_the_launcher(F, L):
    form, lanes, warps, groups, cols = STATS[F][LS.index(L)]
    assert kv.col_stats_form(F, 6028, L, VEC[F]) == (
        form, lanes, warps, groups, VEC[F], cols)


# small buckets (fewer than 2,048 columns): half the slots a lane, and the
# columns spread over about 128 blocks, but 64 to 256 threads a block;
# (C, L, X8a's lanes and columns a block, K3's lanes, columns a block and
# warps)
SMALL = [(14, 128, 32, 2, 32, 2, 2), (12, 128, 32, 2, 32, 2, 2),
         (413, 64, 16, 4, 32, 4, 4), (413, 16, 4, 16, 8, 8, 2),
         (1, 1, 4, 16, 8, 8, 2), (1613, 512, 32, 8, None, None, None),
         (2047, 64, 16, 16, 32, 8, 8), (2048, 64, 8, 16, 16, 16, 8)]


@pytest.mark.parametrize("F", [2, 3, 4])
@pytest.mark.parametrize("C,L,U,cols,Us,cols_s,warps", SMALL)
def test_small_buckets_take_more_lanes_and_smaller_blocks(F, C, L, U, cols,
                                                          Us, cols_s, warps):
    assert km.col_draw_form(F, C, L) == ("lanes", U, cols)
    st = kv.col_stats_form(F, C, L, VEC[F])
    if Us is None:
        assert st.form == "block"
    else:
        assert st == ("lanes", Us, warps, 1, VEC[F], cols_s)


@pytest.mark.parametrize("mode,F,threads", [
    ("jacobi", 2, 128), ("jacobi", 4, 128), ("jacobi", 20, 128),
    ("grad", 4, 128), ("grad", 20, 128), ("exact", 5, 128),
    ("exact", 32, 256), ("exact", 303, 256)])
def test_other_x8a_modes_keep_the_block_form(mode, F, threads):
    """Only the exact mode takes the lanes form, and only up to F = 4: the
    Jacobi and gradient modes and F >= 5 keep a block a column."""
    assert km.col_draw_form(F, 6028, 64, mode) == ("block", threads, 1)


@pytest.mark.parametrize("mode", ["exact", "jacobi", "grad"])
@pytest.mark.parametrize("C,L,lanes", [(14, 128, 32), (14, 256, 64),
                                       (6028, 600, 96), (6028, 2000, 128),
                                       (6028, 7, 8)])
def test_f1_keeps_its_lanes(mode, C, L, lanes):
    """X8a at F = 1 keeps col_draw_f1_lanes in every mode (2-4 warps on
    long columns, more at fewer than 2,048 columns)."""
    assert km.col_draw_form(1, C, L, mode) == ("f1", lanes, 1)


@pytest.mark.parametrize("F", [2, 3, 4])
@pytest.mark.parametrize("C,L", [(6028, 64), (12, 128), (1613, 512),
                                 (6026, 256), (14, 128)])
def test_windowed_and_resident_shapes_take_the_lanes_forms(F, C, L):
    """The windowed paths' shapes at F <= 4 (the ML-1M user bin's window
    buckets [6028,64] and [12,128] at 4 windows) take both new forms; the
    resident buckets take X8a's lanes form at any L and K3's up to L =
    128, so one window gives the resident kernels' form."""
    assert km.col_draw_form(F, C, L).form == "lanes"
    stats = kv.col_stats_form(F, C, L, VEC[F]).form
    assert stats == ("lanes" if L <= kv.STAT_LANES_MAX_L else "block")


@pytest.mark.parametrize("F", [2, 3, 4])
def test_small_windowed_learner_buckets_take_the_lanes_forms(F):
    """Every window bucket of a small windowed problem at factor block F
    takes X14a's and X13a's lanes forms."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import make_movielens_like
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.vb_windowed import WindowedVBLearner

    coo = make_movielens_like(40, 30, 1200, seed=F)
    D = coo.num_features
    cfg = FMConfig(num_attributes=D, num_factor=2 * F, factor_block=F,
                   num_groups=2, min_target=1.0, max_target=5.0, seed=3)
    lr = WindowedVBLearner(cfg, SparseDataset.from_coo(coo, D),
                           SparseDataset.from_coo(coo, D),
                           DataMetaInfo.from_field_offsets(D, [0, 40]),
                           device="cpu", num_windows=3, write_files=False)
    assert lr.F == F
    shapes = {bu.rows[w].shape for bins in lr.plan.bins for bu in bins
              for w in range(lr.num_windows)}
    assert shapes
    for C, L in shapes:
        U = km.col_draw_lanes(C, L)
        assert km.col_draw_form(F, C, L) == (
            "lanes", U, km.lanes_block_cols(C, U))
        assert kv.col_stats_form(F, C, L, VEC[F]).form == (
            "lanes" if L <= kv.STAT_LANES_MAX_L else "block")


@pytest.mark.parametrize("F,vec", [(4, 2), (4, 1), (2, 1)])
def test_col_stats_form_of_misaligned_caches(F, vec):
    """Caches one float off a 16-byte boundary: the lanes form reads them
    in narrower loads; past L = 128 the blocks split F into more chunks."""
    q = torch.zeros(9, F + 1)[:, 1:] if vec == 1 else torch.zeros(10 * F + 2)
    if vec == 2:
        q = q[2:].view(10, F)
    tq = torch.zeros(10, F)
    assert kv.col_stats_vec(F, q, tq) == vec
    assert kv.col_stats_form(F, 6028, 64, vec) == ("lanes", 16, 8, 1, vec,
                                                   16)
    blocks = kv.col_stats_form(F, 6028, 256, vec)
    G = F // vec
    assert blocks.form == "block" and blocks.lanes == G
    assert blocks.warps == min(8, -(-256 // ((2 if vec == 4 else 4)
                                             * (32 // G))))


def _c_col_draw_smem(F, exact):
    """csrc/mcmc_sweep.cu:col_draw_smem, written out: sizeof(float) x
    (col_outputs + F (kTile + 1) + kTile + 4 F), kTile = 32."""
    nout = 2 * F + (F * (F - 1) // 2 if exact else 0)
    return 4 * (nout + F * 33 + 32 + 4 * F)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("F", [2, 4, 20, 64, 303, 304, 1451, 1452])
def test_col_draw_smem_and_fits_agree_with_the_c_formulas(F, exact):
    assert km.col_draw_smem(F, exact) == _c_col_draw_smem(F, exact)
    fits = (F <= (303 if exact else 1451)
            and _c_col_draw_smem(F, exact) <= 227 * 1024)
    assert km.col_draw_fits(F, exact) == fits
    assert km.col_draw_fits(1, exact)


def _constants(name):
    with open(os.path.join(CSRC, name)) as f:
        return {m.group(1): int(m.group(2)) for m in re.finditer(
            r"constexpr int (k\w+) = (\d+);", f.read())}


def test_mirror_constants_match_the_sources():
    m, v = _constants("mcmc_sweep.cu"), _constants("vb_sweep.cu")
    assert m["kLanesMaxF"] == km.LANES_MAX_F
    assert m["kLanesDraw"] == km.col_draw_lanes(1, 1) == 4
    assert m["kTile"] == 32
    assert _constants("svbfm_common.cuh")["kSpreadBlocks"] == (
        km.SPREAD_BLOCKS)
    assert m["kLanesThreads"] == v["kStatLanesThreads"] == 256
    assert v["kStatLanesMaxF"] == kv.STAT_LANES_MAX_F
    assert 32 * v["kStatLanesSlots"] == kv.STAT_LANES_MAX_L
    assert kv.col_stats_lanes(1, 1) == 8
    with open(os.path.join(CSRC, "mcmc_draw.cuh")) as f:
        assert "kW == 4 ||" in f.read()  # the lanes form's draw group


@pytest.mark.parametrize("C", [1, 413, 2047, 2048, 6028])
def test_lane_counts_cover_each_bucket(C):
    """Lanes a column are powers of two that give a lane at most 8 slots
    (X8a, up to a warp; 4 below 2,048 columns) or 4 (K3's lanes form; 2
    below 2,048 columns), and a block of 64 to 256 threads."""
    small = C < 2048
    for L in range(1, 600):
        U = km.col_draw_lanes(C, L)
        assert U in (4, 8, 16, 32) and (U * (4 if small else 8) >= L
                                        or U == 32)
        assert 64 <= km.lanes_block_cols(C, U) * U <= 256
        if L <= kv.STAT_LANES_MAX_L:
            U = kv.col_stats_lanes(C, L)
            assert U in (8, 16, 32) and (U * (2 if small else 4) >= L
                                         or U == 32)
            assert 64 <= km.lanes_block_cols(C, U) * U <= 256
