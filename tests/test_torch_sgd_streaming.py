"""Out-of-core sgd_online in the port (``SGDOnlineLearner.from_reader``: the
chunks streamed from a binary file, X9a/X9b's CPU twins) against the JAX
package's ``SGDOnlineLearner.from_reader`` on the same file.  Both start
from the JAX learner's init, and the port's draw source replays JAX's key
chain (``JaxSGDKeys`` of ``tests/test_torch_sgd.py``: a chunk splits the
key and permutes its rows).

Tolerances are ``tests/test_torch_sgd.py``'s for 3 epochs of a learner:
rtol 1e-4 / atol 1e-6 on w0, w and v; rtol 1e-5 on the per-epoch RMSE and
MAE (classification: the accuracy, which counts rows, equal); the key
chains end on the same key.
"""

import jax
import numpy as np
import pytest

from svbfm_tpu.data.binary import save_coo_binary
from svbfm_tpu.data.dataset import SparseDataset as JDataset
from svbfm_tpu.data.meta import DataMetaInfo as JMeta
from svbfm_tpu.data.stream import BinaryChunkReader as JReader
from svbfm_tpu.data.synth import make_movielens_like, train_test_split
from svbfm_tpu.learners import sgd as js
from svbfm_tpu.learners.base import FMConfig as JConfig
from svbfm_tpu.parallel.mesh import make_mesh
from svbfm_tpu_torch.data.dataset import SparseDataset
from svbfm_tpu_torch.data.meta import DataMetaInfo
from svbfm_tpu_torch.data.stream import BinaryChunkReader
from svbfm_tpu_torch.learners import sgd as ts
from svbfm_tpu_torch.learners.base import FMConfig
from svbfm_tpu_torch.utils.convert import sgd_state_from_jax

from test_torch_sgd import JaxSGDKeys


def _pair(tmp_path, task=0, num_batches=4):
    """test_stream.py's file (2000 ratings, 20 users, 15 items, K = 3) and
    test_torch_sgd.py's step settings."""
    coo = make_movielens_like(num_users=20, num_items=15, num_ratings=2000,
                              rank=2, noise=0.4, seed=5)
    tr, te = train_test_split(coo, 0.2, seed=6)
    D = coo.num_features
    if task == 1:
        te.target = np.where(te.target > 3, 1.0, -1.0).astype(np.float32)
    save_coo_binary(str(tmp_path / "tr"), tr)
    x, y = str(tmp_path / "tr.x"), str(tmp_path / "tr.y")
    kw = dict(num_attributes=D, num_factor=3, task=task,
              min_target=-1.0 if task else float(tr.target.min()),
              max_target=1.0 if task else float(tr.target.max()),
              learn_rate=0.05, regw=0.01, regv=0.01, batch_size=128,
              num_batches=num_batches, seed=7)
    jl = js.SGDOnlineLearner.from_reader(
        JConfig(**kw), JReader(x, y), JDataset.from_coo(te, D), JMeta(D),
        mesh=make_mesh(1), write_files=False)
    tl = ts.SGDOnlineLearner.from_reader(
        FMConfig(**kw), BinaryChunkReader(x, y),
        SparseDataset.from_coo(te, D), DataMetaInfo(D), device="cpu",
        write_files=False)
    return jl, tl


def _run_both(jl, tl, epochs=3):
    jstate = jl.init_state()
    tstate = sgd_state_from_jax(jax.device_get(jstate), "cpu",
                                JaxSGDKeys(jstate.key))
    jend, jh = jl.run(jstate, num_iter=epochs, verbose=False)
    tend, th = tl.run(tstate, num_iter=epochs, verbose=False)
    return jend, jh, tend, th


def _assert_params(tend, jend):
    for k in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(tend, k).numpy(),
                                   np.asarray(getattr(jend, k)), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(np.asarray(tend.draws.key),
                                  np.asarray(jend.key))


@pytest.mark.parametrize("num_batches", [4, 1])
def test_streamed_epochs_match_jax(tmp_path, num_batches):
    jl, tl = _pair(tmp_path, num_batches=num_batches)
    jend, jh, tend, th = _run_both(jl, tl)
    assert len(th) == 3
    for a, b in zip(jh, th):
        for k in ("rmse", "mae"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    _assert_params(tend, jend)
    assert th[-1]["rmse"] < th[0]["rmse"]


def test_streamed_classification_matches_jax(tmp_path):
    """-task c: each chunk's targets binarised as it is read."""
    jl, tl = _pair(tmp_path, task=1)
    jend, jh, tend, th = _run_both(jl, tl, epochs=2)
    assert [b["accuracy"] for b in th] == [a["accuracy"] for a in jh]
    _assert_params(tend, jend)


def test_chunk_orders_match_jax(tmp_path):
    """The epoch's chunk order: a permutation of min(num_batches, rows)
    from default_rng(seed), as JAX's _chunks draws it."""
    jl, tl = _pair(tmp_path)
    for _ in range(3):
        np.testing.assert_array_equal(tl.rng.permutation(4),
                                      jl.rng.permutation(4))
