"""chip_smoke.py refuses to pass where it cannot drive the GPU: without
CUDA, and in a directory that holds nothing else of the repository."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(r):
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py is meant to pass here")
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run(cwd)
    _assert_refused(r)
    assert "CUDA" in r.stderr or "cuda" in r.stderr
