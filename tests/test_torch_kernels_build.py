"""The kernel build: keyed by the sources, and no silent fallback when the
CUDA compiler is missing."""

import os
import shutil

import pytest

from svbfm_tpu_torch.kernels import build


def test_library_path_keyed_by_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, src)
    monkeypatch.setattr(build, "CSRC_DIR", str(src))
    p1 = build.library_path("vb_sweep")
    assert p1 == build.library_path("vb_sweep")
    assert os.path.dirname(p1) == build.BUILD_DIR
    with open(src / "svbfm_common.cuh", "a") as f:
        f.write("// edited\n")
    assert build.library_path("vb_sweep") != p1
    assert build.library_path("fm_forward") != p1


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "no_nvcc"))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library("fm_forward")
    assert not os.path.exists(build.BUILD_DIR)


def test_every_kernel_has_a_signature_and_a_counter():
    kernels = [k for names in build.LIBRARIES.values() for k in names]
    assert sorted(kernels) == sorted(build.launch_counts)
    assert sorted(f"svbfm_{k}" for k in kernels) == sorted(build.SIGNATURES)
    for lib in build.LIBRARIES:
        assert os.path.exists(os.path.join(build.CSRC_DIR, f"{lib}.cu"))


def test_launch_counts_reset(monkeypatch):
    monkeypatch.setattr(build, "launch_counts",
                        {k: 3 for k in build.launch_counts})
    build.count_launch("vb_patch_rows")
    assert build.launch_counts["vb_patch_rows"] == 4
    build.reset_launch_counts()
    assert set(build.launch_counts.values()) == {0}


def _no_libs(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_logs", {})


def test_build_all_without_nvcc_raises(tmp_path, monkeypatch):
    _no_libs(tmp_path, monkeypatch)
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "no_nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not os.path.exists(build.BUILD_DIR)


def test_build_all_stops_the_other_compilers_on_a_failure(tmp_path,
                                                          monkeypatch):
    """One compiler per source, all started together: when the first fails,
    the ones still running are stopped, not waited for."""
    import time

    _no_libs(tmp_path, monkeypatch)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "case \"$*\" in *fm_forward.cu*) echo broken >&2; "
                    "exit 3;; esac\nexec sleep 60\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="nvcc failed for fm_forward.cu"):
        build.build_all()
    assert time.monotonic() - t0 < 30
    assert not any(n.endswith(".so") for n in os.listdir(build.BUILD_DIR))


def test_probit_library_builds_without_contraction(monkeypatch):
    """csrc/probit.cu is compiled with -fmad=false, so that no multiply-add
    is contracted and each operation rounds as its plain twin's; the flag
    keys its library, and no other library takes it."""
    assert "-fmad=false" in build._flags("probit")
    assert all("-fmad=false" not in build._flags(n)
               for n in build.LIBRARIES if n != "probit")
    p = build.library_path("probit")
    monkeypatch.setattr(build, "EXTRA_FLAGS", {})
    assert build.library_path("probit") != p
