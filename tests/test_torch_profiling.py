"""The port's profiling hooks (``svbfm_tpu_torch/utils/profiling.py``) on
the CPU: ``StepTimer`` keeps ``svbfm_tpu/utils/profiling.py``'s
accounting and report; ``trace`` is a no-op without a directory and
otherwise writes a Chrome trace of the block's CPU activities (the CUDA
activities join on a card); ``device_memory_stats`` is empty without
CUDA."""

import json
import os

import pytest
import torch

from svbfm_tpu.utils import profiling as jprof
from svbfm_tpu_torch.utils import profiling as tprof


def test_step_timer_matches_jax_accounting():
    ours, theirs = tprof.StepTimer(), jprof.StepTimer()
    x = torch.ones(64)
    for t in (ours, theirs):
        for _ in range(3):
            with t.phase("learn", sync=x if t is ours else None):
                pass
        with t.phase("pred"):
            pass
        t.totals = {"learn": 0.003, "pred": 0.0125}  # fixed for the report
    assert ours.counts == theirs.counts == {"learn": 3, "pred": 1}
    assert ours.report() == theirs.report() == "learn=1.0ms  pred=12.5ms"
    assert ours.mean("absent") == theirs.mean("absent") == 0.0


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_off_is_a_no_op(log_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with tprof.trace(log_dir) as prof:
        torch.ones(4).sum()
    assert prof is None and os.listdir(tmp_path) == []


def test_trace_writes_chrome_trace_of_the_block(tmp_path):
    d = str(tmp_path / "prof")
    a = torch.ones(32, 32)
    with tprof.trace(d) as prof:
        (a @ a).sum()
    assert prof is not None
    assert os.listdir(d) == [tprof.TRACE_FILE]
    with open(os.path.join(d, tprof.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names


def test_device_memory_stats_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card's statistics are returned")
    assert tprof.device_memory_stats() == {}
