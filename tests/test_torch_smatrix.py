"""The port's copy of the map-based sparse containers
(``svbfm_tpu_torch/utils/smatrix.py``, reference ``src/util/smatrix.h``)
against ``svbfm_tpu/utils/smatrix.py``: the same seeded entries give the
same text files, the same lookups (0 / False for absent keys, with no
insertion) and the same containers read back."""

import io

import numpy as np
import pytest

from svbfm_tpu.utils import smatrix as jsm
from svbfm_tpu_torch.utils import smatrix as tsm


def _fill(mod, kind, seed=0):
    """A container of ``kind`` with seeded entries (indices 0-5)."""
    rng = np.random.default_rng(seed)
    idx = [tuple(int(i) for i in rng.integers(0, 6, 3)) for _ in range(12)]
    vals = [float(v) for v in np.round(rng.normal(size=12), 3)]
    c = getattr(mod, kind)()
    for (a, b, d), v in zip(idx, vals):
        if kind == "SparseVector":
            c[a] = v
        elif kind == "SparseMatrix":
            c[a][b] = v
        elif kind == "SparseTensor":
            c[a][b][d] = v
        elif kind == "SparseMatrixBoolean":
            c[a].add(b)
        else:
            c[a][b].add(d)
    return c


def _text(c):
    s = io.StringIO()
    c.to_stream(s)
    return s.getvalue()


KINDS = ["SparseVector", "SparseMatrix", "SparseTensor",
         "SparseMatrixBoolean", "SparseTensorBoolean"]


@pytest.mark.parametrize("kind", KINDS)
def test_containers_match_jax_package(kind, tmp_path):
    ours, theirs = _fill(tsm, kind), _fill(jsm, kind)
    probes = [(a, b, d) for a in range(7) for b in range(7) for d in (0, 3)]
    arity = {"SparseVector": 1, "SparseMatrix": 2, "SparseTensor": 3,
             "SparseMatrixBoolean": 2, "SparseTensorBoolean": 3}[kind]
    for p in probes:
        assert ours.get(*p[:arity]) == theirs.get(*p[:arity]), p
    assert len(ours) == len(theirs)  # absent lookups inserted nothing
    if kind == "SparseMatrixBoolean":  # no writer: read the same file
        path = tmp_path / "m.txt"
        path.write_text("3 1\n5 0\n\n  \n")
        a = tsm.SparseMatrixBoolean().from_file(str(path))
        b = jsm.SparseMatrixBoolean().from_file(str(path))
        assert {k: set(v) for k, v in a.items()} == \
            {k: set(v) for k, v in b.items()}
        return
    assert _text(ours) == _text(theirs)
    if kind == "SparseVector":
        return
    path = str(tmp_path / "c.txt")
    ours.to_file(path)
    back = getattr(tsm, kind)().from_file(path)
    assert _text(back) == _text(theirs)


def test_from_file_tolerates_trailing_whitespace(tmp_path):
    p = str(tmp_path / "w.txt")
    with open(p, "w") as f:
        f.write("0 0 1.0\n\n  \n")   # eof-guarded >> loop semantics
    m = tsm.SparseMatrix().from_file(p)
    assert m.get(0, 0) == 1.0 and len(m) == 1
