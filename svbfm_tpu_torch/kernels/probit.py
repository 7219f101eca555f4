"""X12a-X12b: the probit task's train-row latent update and test-row eval
(``csrc/probit.cu``).

``probit_latent`` (X12a) updates the train residual e in place once a sweep
under ``-task c``: batch VB and ALS by the truncated-normal mean T(e) of the
latent target, by the sign of y (VB: e <- T(e) - e; ALS: e <- e - T(e)),
Gibbs by a draw from the truncated normal through the inverse cdf of the
uniforms ``u``.  ``probit_eval`` (X12b) scores the test rows: Phi(score)
by the reference's erf, with Gibbs's posterior-mean accumulators added to
in place, and returns [4] = (accuracy, loglik, accuracy_this,
loglik_this) on the device (the first two of the posterior mean under
Gibbs; all four of Phi(score) elsewhere).

Both kernels take the rows in chunks of 4, a chunk a thread
(``latent_blocks``, ``eval_blocks``), so X12b's sums go in an order fixed
by N alone.

On CUDA tensors each op launches its hand-written kernel; on CPU tensors it
runs the plain twin beside it, the JAX arithmetic in the same order:
``svbfm_tpu/learners/vb.py:1002-1019`` and ``mcmc.py:1046-1090``, the
reference's erf (``learners/base.py``) and Giles' erfinv polynomial, which
XLA lowers ``jax.scipy.special.erfinv`` to (``erfinv_plain``; the kernel
writes out the same polynomial, never CUDA's ``erfinvf``).
"""

from __future__ import annotations

from typing import Optional

import torch

from svbfm_tpu_torch.kernels import build
from svbfm_tpu_torch.learners.base import (ref_cdf_gaussian,
                                           truncnorm_mean_negative,
                                           truncnorm_mean_positive)

_F32 = torch.float32

PROBIT_VB, PROBIT_ALS, PROBIT_GIBBS = 0, 1, 2
# the clip of the Gibbs draw's cdf and the range of its uniforms
# (svbfm_tpu/learners/mcmc.py:1082-1085)
CDF_EPS = 1e-7
# sqrt(2) in float32, as jnp.sqrt(2.0)
SQRT2 = float(torch.sqrt(torch.tensor(2.0, dtype=_F32)))
# rows go by chunks of 4 (csrc/probit.cu), a chunk a thread
CHUNK = 4
# X12a: 256-thread blocks, as many as the chunks need
LATENT_THREADS = 256
# X12b: 256-thread blocks, at most 2 a streaming multiprocessor of an
# H100; the grid is a function of N alone
EVAL_THREADS, EVAL_MAX_BLOCKS = 256, 264

# Giles' single-precision erfinv ("Approximating the erfinv function",
# GPU Computing Gems, 2011), the coefficients XLA expands it with
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


# ---- plain twins ------------------------------------------------------------

def erfinv_plain(x: torch.Tensor) -> torch.Tensor:
    """Giles' erfinv in float32: w = -log1p(-x^2), a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at x = +-1."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):  # Python floats: no host-to-device copy on a card
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, 9):
        p = coef(i) + p * w
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def probit_latent_plain(e, y, u, mode: int) -> None:
    """X12a's twin, in place on e."""
    if mode == PROBIT_GIBBS:
        lo = ref_cdf_gaussian(-e)  # P(z < 0), z ~ N(e, 1)
        cdf = torch.where(y >= 0, lo + u * (1 - lo), u * lo)
        cdf = torch.clamp(cdf, CDF_EPS, 1 - CDF_EPS)
        sampled = e + SQRT2 * erfinv_plain(2 * cdf - 1)
        e.copy_(e - sampled)
        return
    t = torch.where(y >= 0, truncnorm_mean_positive(e),
                    truncnorm_mean_negative(e))
    e.copy_(t - e if mode == PROBIT_VB else e - t)


def _scored(p, yt, valid):
    """Hits and log10 likelihoods of probabilities p, times valid."""
    hit = ((p >= 0.5) & (yt > 0)) | ((p < 0.5) & (yt < 0))
    m = (yt + 1.0) * 0.5
    pll = torch.clamp(p, 0.01, 0.99)
    ll = (m * torch.log10(pll) + (1 - m) * torch.log10(1 - pll)) * valid
    return hit.to(_F32) * valid, ll


def probit_eval_plain(scores, target, valid, nt: float,
                      psum_all: Optional[torch.Tensor] = None,
                      psum_but5: Optional[torch.Tensor] = None,
                      it: int = 0) -> torch.Tensor:
    """X12b's twin: updates psum_all/psum_but5 in place (Gibbs) and returns
    [4] = (acc, loglik, acc_this, loglik_this)."""
    prob = ref_cdf_gaussian(scores)
    pm = prob
    if psum_all is not None:
        psum_all += prob
        if it >= 5:
            psum_but5 += prob
        pm = psum_all / (it + 1.0)
    hit, ll = _scored(pm, target, valid)
    hit_t, ll_t = _scored(prob, target, valid)
    return torch.stack([torch.sum(hit) / nt, -torch.sum(ll) / nt,
                        torch.sum(hit_t) / nt, -torch.sum(ll_t) / nt])


def latent_blocks(n: int) -> int:
    """X12a's grid for n rows: a thread a chunk of 4 (the N % 4 rows past
    the chunks go to the first threads)."""
    return max(1, -(-n // (CHUNK * LATENT_THREADS)))


def eval_blocks(n: int) -> int:
    """X12b's grid for n rows: a thread a chunk of 4, at most
    EVAL_MAX_BLOCKS blocks (past that each thread strides over several)."""
    return max(1, min(EVAL_MAX_BLOCKS, -(-n // (CHUNK * EVAL_THREADS))))


# ---- wrappers ---------------------------------------------------------------

# per device: X12b's scratch, a ticket (zero between launches) and then the
# blocks' 16-byte partials rows
_scratch: dict = {}


def probit_latent(e, y, u: Optional[torch.Tensor], mode: int) -> None:
    """X12a in place on e [N]; ``u`` [N] holds the Gibbs draw's uniforms
    (None in the VB and ALS modes)."""
    if mode not in (PROBIT_VB, PROBIT_ALS, PROBIT_GIBBS):
        raise ValueError(f"probit_latent: unknown mode {mode}")
    if (u is None) != (mode != PROBIT_GIBBS):
        raise ValueError("probit_latent: u is read by the Gibbs mode alone")
    if build.on_cpu(e):
        return probit_latent_plain(e, y, u, mode)
    dev, (N,) = e.device, e.shape
    build.require(e, _F32, (N,), dev, "probit_latent.e")
    build.require(y, _F32, (N,), dev, "probit_latent.y")
    if u is not None:
        build.require(u, _F32, (N,), dev, "probit_latent.u")
    lib = build.load_library("probit")
    with torch.cuda.device(dev):
        rc = lib.svbfm_probit_latent(
            build.ptr(e), build.ptr(y), None if u is None else build.ptr(u),
            N, mode, latent_blocks(N), build.stream_of(e))
    build.check_launch(lib, rc, "probit_latent")


def probit_eval(scores, target, valid, nt: float,
                psum_all: Optional[torch.Tensor] = None,
                psum_but5: Optional[torch.Tensor] = None,
                it: int = 0) -> torch.Tensor:
    """X12b over the test rows: [4] = (acc, loglik, acc_this, loglik_this)
    on the device, each a sum over ``nt`` rows; with Gibbs's accumulators
    ``psum_all``/``psum_but5`` [N] (updated in place) the first two score
    their posterior mean after iteration ``it``."""
    if (psum_all is None) != (psum_but5 is None):
        raise ValueError("probit_eval: psum_all and psum_but5 go together")
    if build.on_cpu(scores):
        return probit_eval_plain(scores, target, valid, nt, psum_all,
                                 psum_but5, it)
    dev, (N,) = scores.device, scores.shape
    for t, name in ((scores, "scores"), (target, "target"), (valid, "valid"),
                    (psum_all, "psum_all"), (psum_but5, "psum_but5")):
        if t is not None:
            build.require(t, _F32, (N,), dev, f"probit_eval.{name}")
    lib = build.load_library("probit")
    scratch = _scratch.get(dev)
    if scratch is None:
        scratch = _scratch[dev] = torch.zeros(4 * (1 + EVAL_MAX_BLOCKS),
                                              dtype=_F32, device=dev)
    out = torch.empty(4, dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.svbfm_probit_eval(
            build.ptr(scores), build.ptr(target), build.ptr(valid), N,
            None if psum_all is None else build.ptr(psum_all),
            None if psum_but5 is None else build.ptr(psum_but5), it,
            float(nt), eval_blocks(N), build.ptr(scratch), build.ptr(out),
            build.stream_of(scores))
    build.check_launch(lib, rc, "probit_eval")
    return out
