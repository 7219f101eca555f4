"""Synthetic one-hot interaction data generators.

The reference repo bundles ``data/sa.test_libfm`` (100k rows, 2 nnz/row,
one-hot user+item, 9992 features) but its training file is missing
(``.MISSING_LARGE_BLOBS``).  These generators produce MovieLens-shaped data
with a planted low-rank structure so convergence behaviour is meaningful.
"""

from __future__ import annotations

import numpy as np

from svbfm_tpu_torch.data.libfm_text import COOData


def make_movielens_like(
    num_users: int = 6040,
    num_items: int = 3952,
    num_ratings: int = 1_000_000,
    rank: int = 8,
    noise: float = 0.6,
    seed: int = 0,
) -> COOData:
    """One-hot user+item regression data with a planted latent-factor model.

    Ratings are generated from mu + b_u + b_i + <p_u, q_i> + noise, clipped
    and rounded to the 1..5 star scale (MovieLens-like marginals).
    """
    rng = np.random.default_rng(seed)
    users = rng.integers(0, num_users, size=num_ratings, endpoint=False)
    items = rng.integers(0, num_items, size=num_ratings, endpoint=False)
    bu = 0.3 * rng.standard_normal(num_users)
    bi = 0.3 * rng.standard_normal(num_items)
    p = rng.standard_normal((num_users, rank)) / np.sqrt(rank)
    q = rng.standard_normal((num_items, rank)) / np.sqrt(rank)
    y = 3.6 + bu[users] + bi[items] + np.einsum("nk,nk->n", p[users], q[items])
    y = y + noise * rng.standard_normal(num_ratings)
    y = np.clip(np.round(y), 1.0, 5.0).astype(np.float32)

    row = np.repeat(np.arange(num_ratings, dtype=np.int32), 2)
    col = np.empty(2 * num_ratings, dtype=np.int32)
    col[0::2] = users
    col[1::2] = num_users + items
    val = np.ones(2 * num_ratings, dtype=np.float32)
    return COOData(
        row=row, col=col, val=val, target=y,
        num_rows=num_ratings, num_features=num_users + num_items,
    )


def train_test_split(coo: COOData, test_frac: float = 0.1, seed: int = 1):
    rng = np.random.default_rng(seed)
    test_mask_rows = rng.random(coo.num_rows) < test_frac
    def subset(mask_rows: np.ndarray) -> COOData:
        keep_rows = np.where(mask_rows)[0]
        remap = -np.ones(coo.num_rows, dtype=np.int64)
        remap[keep_rows] = np.arange(len(keep_rows))
        sel = mask_rows[coo.row]
        return COOData(
            row=remap[coo.row[sel]].astype(np.int32),
            col=coo.col[sel].copy(),
            val=coo.val[sel].copy(),
            target=coo.target[keep_rows].copy(),
            num_rows=len(keep_rows),
            num_features=coo.num_features,
        )
    return subset(~test_mask_rows), subset(test_mask_rows)


def make_relation(num_rows, num_onehot, num_attrs, seed):
    """One-hot id + ``num_attrs`` shared attributes per relation row, each
    attribute slot with 2 possible columns (conflict-free pairs); a copy of
    ``scripts/bench_bs.py:make_relation``."""
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.relation import RelationData

    rng = np.random.default_rng(seed)
    D = num_onehot + 2 * max(num_attrs, 1)
    rows = [np.arange(num_rows, dtype=np.int32)]
    cols = [np.arange(num_rows, dtype=np.int32) % num_onehot]
    vals = [np.ones(num_rows, np.float32)]
    for a in range(num_attrs):
        rows.append(np.arange(num_rows, dtype=np.int32))
        cols.append(num_onehot + 2 * a
                    + rng.integers(0, 2, num_rows).astype(np.int32))
        vals.append(rng.uniform(0.2, 1.0, num_rows).astype(np.float32))
    order = np.argsort(np.concatenate(rows), kind="stable")
    return RelationData(
        row=np.concatenate(rows)[order], col=np.concatenate(cols)[order],
        val=np.concatenate(vals)[order], num_rows=num_rows, num_features=D,
        meta=DataMetaInfo(D))


def make_bs_problem(rows, ua, ia):
    """The relational (VLDB'13) recipe of ``scripts/bench_bs.py:
    make_bs_problem``: ML/Netflix-shaped ratings whose features live entirely
    in a user relation (one-hot + ``ua`` attribute slots) and an item
    relation (one-hot + ``ia`` slots); the main design block is empty.
    Returns (main, rel_u, rel_i, users, items, y)."""
    nu, ni = (71567, 10681) if rows <= 20_000_000 else (480189, 17770)
    rng = np.random.default_rng(5)
    users = rng.integers(0, nu, rows)
    items = rng.integers(0, ni, rows)
    bu = 0.4 * rng.standard_normal(nu)
    bi = 0.4 * rng.standard_normal(ni)
    y = (3.6 + bu[users] + bi[items]
         + 0.5 * rng.standard_normal(rows)).astype(np.float32)
    main = COOData(row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
                   val=np.zeros(0, np.float32), target=y,
                   num_rows=rows, num_features=0)
    rel_u = make_relation(nu, nu, ua, seed=7)
    rel_i = make_relation(ni, ni, ia, seed=8)
    return main, rel_u, rel_i, users, items, y


def make_tiny(seed: int = 0, num_rows: int = 64, num_users: int = 8, num_items: int = 6) -> COOData:
    """Small deterministic dataset for unit tests."""
    return make_movielens_like(
        num_users=num_users, num_items=num_items, num_ratings=num_rows,
        rank=2, noise=0.3, seed=seed,
    )
