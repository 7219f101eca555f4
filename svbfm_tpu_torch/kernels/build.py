"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface: no PyTorch headers, so a build
takes seconds, not minutes.  Libraries land in ``build/svbfm_tpu_torch/``
under the repository root (git-ignored), named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.

Every kernel wrapper bumps its entry in :data:`launch_counts` where it
launches its kernel, and nowhere else: a run can show that its main path
went through the kernels.

Nothing is built at import: this module imports on machines without nvcc
or a GPU (the CPU tests import every module).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "svbfm_tpu_torch")
HEADERS = ("svbfm_common.cuh", "mcmc_draw.cuh")
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"  # where the CUDA toolkit puts it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# one source file per library; the kernels each library holds
LIBRARIES = {
    "fm_forward": ("fm_scores", "fm_t_terms", "bs_scores", "fm_serve",
                   "tp_fm_partials", "tp_serve"),
    "vb_sweep": ("vb_build_qt", "vb_col_stats_update", "vb_patch_rows",
                 "w_patch_rows", "build_q", "vb_col_stats_window",
                 "tp_build_qt", "tp_col_stats", "tp_col_update",
                 "tp_patch_delta", "tp_build_q"),
    "w_sweep": ("w_col_update", "mcmc_w_draw", "w_grad_step",
                "w_col_window", "mcmc_w_window", "tp_w_stats",
                "tp_w_update", "tp_w_draw", "tp_w_ovb_stats",
                "tp_w_ovb_blend"),
    "ovb_sweep": ("ovb_col_stats_update", "tp_ovb_stats", "tp_ovb_blend"),
    "mcmc_sweep": ("mcmc_col_draw", "mcmc_patch_rows", "mcmc_col_grad",
                   "mcmc_col_draw_window", "tp_col_draw_stats", "tp_col_draw",
                   "tp_mcmc_patch_delta"),
    "gather_probe": ("gather_probe",),
    "sgd_step": ("sgd_grad_scatter", "sgd_apply", "sgda_lambda",
                 "tp_sgd_scatter"),
    "bs_sweep": ("bs_join_agg", "bs_rel_draw", "bs_rel_w_draw",
                 "bs_rel_patch", "bs_rel_w_patch"),
    "bs_forward": ("bs_rel_moments", "bs_resync"),
    "probit": ("probit_latent", "probit_eval"),
}
# flags a library adds to NVCC_FLAGS: probit.cu rounds every operation as
# its plain twin does, so no multiply-add is contracted
EXTRA_FLAGS = {"probit": ("-fmad=false",)}

# C signatures of the exported launch functions (P: pointer or stream,
# I: int, L: int64, F: float); every one returns cudaGetLastError() as an int
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
SIGNATURES = {
    "svbfm_fm_scores": (_P, _L, _I, _P, _P, _P, _L, _I, _P, _P),
    "svbfm_fm_t_terms": (_P, _L, _I, _P, _P, _P, _L, _I, _P, _P),
    "svbfm_fm_serve": (_P, _L, _I, _P, _P, _P, _L, _I, _I, _F, _F, _P, _P),
    "svbfm_vb_build_qt": (_P, _L, _I, _P, _P, _L, _I, _P, _P, _P, _P),
    "svbfm_vb_col_stats_update": (
        _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
        _P, _P, _P, _P, _P),
    "svbfm_vb_col_stats_window": (
        _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
        _I, _P),
    "svbfm_w_col_window": (_P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _P),
    "svbfm_vb_patch_rows": (_P, _I, _I, _I, _I, _P, _P, _L, _I, _P, _P, _P,
                            _P, _P, _P),
    "svbfm_w_col_update": (_P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                           _P, _P, _P, _P),
    "svbfm_w_patch_rows": (_P, _P, _P, _L, _I, _P, _P, _P),
    "svbfm_ovb_col_stats_update": (
        _P, _I, _L, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P),
    "svbfm_build_q": (_P, _L, _I, _P, _P, _L, _I, _P, _P, _P),
    "svbfm_mcmc_w_draw": (_P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "svbfm_mcmc_col_draw": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                            _P, _P, _P, _L, _I, _P, _P),
    "svbfm_mcmc_patch_rows": (_P, _I, _P, _P, _L, _I, _P, _P, _P),
    "svbfm_mcmc_col_draw_window": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _P,
                                   _P, _P, _P, _P, _P, _L, _P, _P, _I, _P),
    "svbfm_mcmc_w_window": (_P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _P),
    "svbfm_w_grad_step": (_P, _I, _L, _P, _P, _P, _F, _F, _F, _P),
    "svbfm_mcmc_col_grad": (_P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _F, _F,
                            _F, _P),
    "svbfm_bs_join_agg": (_P, _I, _L, _P, _P, _I, _P, _P),
    "svbfm_bs_rel_draw": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                          _P, _P, _P, _P, _P, _L, _P, _P, _P, _P),
    "svbfm_bs_rel_w_draw": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _P, _L, _P, _P, _P, _P),
    "svbfm_bs_rel_patch": (_P, _P, _L, _I, _P, _I, _P, _I, _P, _P, _P),
    "svbfm_bs_rel_w_patch": (_P, _P, _L, _I, _P, _I, _P, _P, _P, _P),
    "svbfm_bs_rel_moments": (_P, _P, _L, _I, _P, _L, _I, _I, _P, _L, _P),
    "svbfm_bs_scores": (_P, _L, _I, _P, _P, _P, _L, _I, _I, _P, _P, _L, _I,
                        _P, _P),
    "svbfm_bs_resync": (_P, _L, _I, _P, _P, _L, _P, _P, _P, _P),
    "svbfm_gather_probe": (_P, _P, _L, _I, _P, _P),
    "svbfm_sgd_grad_scatter": (
        _P, _I, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _F, _F, _F, _F, _P,
        _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "svbfm_sgd_apply": (
        _P, _I, _P, _F, _F, _F, _F, _F, _P, _P, _P, _I, _I, _P, _P, _F, _I,
        _P, _P, _P, _P, _P, _L, _P, _L, _P, _P),
    "svbfm_sgda_lambda": (
        _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _L, _I, _F, _F, _F,
        _F, _F, _I, _I, _I, _I, _P),
    "svbfm_probit_latent": (_P, _P, _P, _L, _I, _I, _P),
    # T1-T4, the feature-sharded batch VB (parallel/tp_vb.py)
    "svbfm_tp_fm_partials": (_P, _L, _I, _I, _L, _I, _P, _P, _L, _I, _P, _P),
    "svbfm_tp_build_qt": (_P, _L, _I, _L, _I, _P, _P, _L, _I, _P, _P),
    "svbfm_tp_col_stats": (_P, _P, _I, _I, _P, _I, _P, _P, _I, _P, _I, _P,
                           _P),
    "svbfm_tp_col_update": (_P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P),
    "svbfm_tp_patch_delta": (_P, _I, _I, _I, _L, _I, _P, _P, _L, _I, _P, _P,
                             _P),
    "svbfm_tp_w_stats": (_P, _I, _L, _P, _P, _I, _P),
    "svbfm_tp_w_update": (_P, _I, _L, _P, _I, _P, _P, _P, _P, _P, _P, _P),
    # T5-T8, the feature-sharded Gibbs/ALS (parallel/tp_mcmc.py)
    "svbfm_tp_w_draw": (_P, _I, _L, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    "svbfm_tp_build_q": (_P, _L, _I, _L, _I, _P, _P, _L, _I, _P, _P),
    "svbfm_tp_col_draw_stats": (_P, _P, _I, _I, _P, _P, _P, _I, _P, _L, _I,
                                _P, _P),
    "svbfm_tp_col_draw": (_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _L,
                          _I, _P, _P, _P),
    "svbfm_tp_mcmc_patch_delta": (_P, _I, _L, _I, _P, _P, _L, _I, _P, _P,
                                  _P),
    # T9 and T10, the feature-sharded online VB (parallel/tp_ovb.py)
    "svbfm_tp_ovb_stats": (_P, _I, _L, _P, _P, _P, _P, _L, _P),
    "svbfm_tp_ovb_blend": (_P, _I, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P),
    "svbfm_tp_w_ovb_stats": (_P, _I, _L, _P, _P, _P, _I, _P),
    "svbfm_tp_w_ovb_blend": (_P, _I, _L, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P),
    "svbfm_probit_eval": (_P, _P, _P, _L, _P, _P, _I, _F, _I, _P, _P, _P),
    # T11, the feature-sharded SGD (parallel/tp_sgd.py), and T12, the
    # feature-sharded scorer's finalize (serve.py)
    "svbfm_tp_sgd_scatter": (_P, _I, _P, _P, _P, _P, _P, _L, _I, _P, _L, _I,
                             _I, _I, _I, _F, _F, _F, _F, _P, _P, _P),
    "svbfm_tp_serve": (_P, _I, _P, _L, _I, _F, _F, _P, _P),
}

launch_counts: dict[str, int] = {
    k: 0 for names in LIBRARIES.values() for k in names}
# ptxas resource report (registers, spills) of each library's last build
build_logs: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}
# device_table's tables by (device, values), the oldest dropped past
# _TABLES_KEPT; a table holds only numbers (pointers, shapes), so it is
# right for whatever tensors sit at those addresses
_tables: dict = {}
_host_tables: dict = {}  # host_table's, the same way
_TABLES_KEPT = 64


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists(NVCC_FALLBACK):
        path = NVCC_FALLBACK
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of svbfm_tpu_torch "
                           "are built from source at first use")
    return path


def library_path(name: str) -> str:
    """Where ``name``'s library goes: keyed by sources and flags."""
    h = hashlib.sha256()
    for fn in (f"{name}.cu",) + HEADERS:
        with open(os.path.join(CSRC_DIR, fn), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists; returns
    the running job (library path, temp path, process) or None."""
    so = library_path(name)
    if os.path.exists(so):
        return None
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc, *_flags(name), "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    return so, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)


def _finish_build(name: str, job) -> None:
    so, tmp, proc = job
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc={proc.returncode}):\n{err}{out}")
    build_logs[name] = err + out
    os.replace(tmp, so)  # atomic: a concurrent build never half-loads


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    job = _start_build(name)
    if job is not None:
        _finish_build(name, job)
    lib = ctypes.CDLL(library_path(name))
    lib.svbfm_error_string.restype = ctypes.c_char_p
    lib.svbfm_error_string.argtypes = [ctypes.c_int]
    for kernel in LIBRARIES[name]:
        fn = getattr(lib, f"svbfm_{kernel}")
        fn.argtypes = list(SIGNATURES[f"svbfm_{kernel}"])
        fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def build_all() -> float:
    """Build every library, one nvcc per source, all started together, and
    load them; returns the seconds it took.  On a failed build the other
    compilers are stopped before the error is raised."""
    t0 = time.perf_counter()
    jobs = {}
    try:
        for name in LIBRARIES:
            if name not in _libs:
                jobs[name] = _start_build(name)
        for name, job in jobs.items():
            if job is not None:
                _finish_build(name, job)
    finally:
        for job in jobs.values():
            if job is not None and job[2].poll() is None:
                job[2].kill()
                job[2].communicate()
    for name in LIBRARIES:
        load_library(name)
    return time.perf_counter() - t0


def check_launch(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error, else count it."""
    if rc != 0:
        msg = lib.svbfm_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({rc})")
    count_launch(name)


# -- argument helpers shared by the wrappers --------------------------------

def _kept(cache: dict, key, make):
    """``cache[key]``, made by ``make()`` the first time ``key`` is seen;
    the oldest entry is dropped past ``_TABLES_KEPT``."""
    table = cache.get(key)
    if table is None:
        table = cache[key] = make()
        while len(cache) > _TABLES_KEPT:
            del cache[next(iter(cache))]
    return table


def device_table(values: tuple, device) -> torch.Tensor:
    """An int64 tensor of ``values`` (ints, or equal-length tuples of ints
    for a 2-D table) on ``device``: the device arrays of pointers and shapes
    that a kernel reads in place of a fixed-size argument list.  Built by
    one host-to-device copy the first time ``values`` is seen, then found
    again; the learners keep the tensors a table describes at fixed
    addresses, so each of their tables is built once."""
    return _kept(_tables, (device, values), lambda: torch.tensor(
        values, dtype=torch.int64).to(device))


def host_table(values: tuple) -> ctypes.Array:
    """An int64 ctypes array of ``values`` (equal-length tuples of ints),
    row-major: a table of pointers and shapes that a launch function copies
    into its kernel's parameters.  Built the first time ``values`` is seen,
    then found again, as ``device_table``'s tables are."""
    def make():
        flat = [v for row in values for v in row]
        return (ctypes.c_int64 * len(flat))(*flat)
    return _kept(_host_tables, values, make)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require_kind(t, dtype, shape, device, name: str) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def require(t, dtype, shape, device, name: str) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    _require_kind(t, dtype, shape, device, name)
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_rows(t, dtype, shape, device, name: str) -> int:
    """Validate a [R, C] table handed to a kernel as rows at a row stride
    (a view of a wider table): device, dtype, shape, adjacent columns, a
    row stride of at least C.  Returns the row stride."""
    _require_kind(t, dtype, shape, device, name)
    R, C = shape
    if (C > 1 and t.stride(1) != 1) or (R > 1 and t.stride(0) < C):
        raise ValueError(f"{name}: rows must be contiguous, at a stride of "
                         f"at least {C} (got {t.stride()})")
    return t.stride(0)


def on_cpu(t) -> bool:
    """True for a CPU tensor (plain twin); False for CUDA (kernel).  Any
    other device raises: there is no silent fallback."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")
