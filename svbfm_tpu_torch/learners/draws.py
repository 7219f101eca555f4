"""The random numbers of the Gibbs sampler and of the SGD family.

Every random number of an MCMC sweep or an SGD epoch comes from one draw
source, an object with these methods:

* ``normal(shape)``: standard normal draws of that shape;
* ``gamma(a)``: standard Gamma(a, 1) draws, elementwise in the tensor ``a``;
* ``permutation(n, shard=0, n_shards=1)``: a random permutation of
  range(n) (int64), for data shard ``shard`` of ``n_shards`` (JAX folds
  the data shard's index into its sub-key, ``svbfm_tpu/learners/
  sgd.py:163``; every shard takes one item of the chain);
* ``randint(shape, lo, hi)``: uniform integers in [lo, hi) (int32);
* ``uniform(shape, lo, hi, shard=0, n_shards=1)``: uniform floats in
  [lo, hi) (float32), the Gibbs probit draw's (``mcmc.py:1079-1082``,
  which also splits its key under ALS and uses no number: the port then
  asks for a zero-length draw), for data shard ``shard`` of ``n_shards``
  (JAX folds the shard's index into its sub-key; every shard takes one
  item of the chain);
* ``column_normal(F, lo, D_loc)``: the [F, D_loc] standard normals of the
  columns [lo, lo + D_loc) of a conceptual [F, D] table whose numbers
  depend only on the item of the chain and the global column, so that a
  feature shard draws its slice alone and every mesh draws the same
  numbers (``svbfm_tpu/parallel/tp_mcmc.py:_z_table_local``: chunks of
  ``Z_CHUNK`` columns aligned to the global index, each from the sub-key
  folded with the chunk's index);
* ``window_uniform(windows, length, lo, hi)``: the same for the windowed
  Gibbs (``mcmc_windowed.py:499-516``): JAX splits its key once and draws
  each window's ``length`` numbers from that sub-key folded with the
  window's index; the windows' numbers in window order, one
  [windows * length] tensor (``length`` 0 under ALS).

The learner calls them in the JAX package's order and with its shapes
(``svbfm_tpu/learners/mcmc.py``, where each draw splits the key chain and
uses the sub-key), including the few places where JAX splits a key whose
numbers it does not use; so a source that replays that key chain, one
sub-key a call, gives the port JAX's numbers.  The SGD learners draw one
permutation an epoch (SGDA two: train, then validation), or per chunk
(sgd_online), and BPR its negatives for a whole epoch, [nb, B], after the
permutation; a test source replays each learner's chain
(``svbfm_tpu/learners/sgd.py:163-177``, ``bpr.py:164-179``).  The port
itself never calls a global random number generator.

On a data mesh (the replicated learners' ``mesh=``) every rank holds a
source seeded alike and makes every call, its share of the rows or of a
bucket notwithstanding, so the ranks draw the same numbers in the same
order and their tables stay equal; only ``uniform`` and ``permutation``
keep the rank's shard of the numbers they draw for every shard.

``Draws`` draws on ``generator``'s device and moves the result to
``device``: with a generator on the learner's device it is the default
source (``device_draws``); with a CPU generator it is a host-table source
(``host_draws``), which gives a card and the CPU the same numbers.  Gamma
draws use ``torch._standard_gamma`` with the generator.  Its
``uniform`` and ``permutation`` draw the ``n_shards`` shards' numbers and
keep the shard's, so the chain moves alike on every rank; its ``column_normal`` takes one
64-bit seed from the chain and draws chunk c from a fresh generator on the
same device seeded with ``chunk_seed(seed, c)``.
"""

from __future__ import annotations

import torch

_F32 = torch.float32
#: the columns of a chunk of ``column_normal``'s table (tp_mcmc.py:138)
Z_CHUNK = 8192
_MASK64 = (1 << 64) - 1


def chunk_seed(seed: int, chunk: int) -> int:
    """The seed of chunk ``chunk`` of a column table drawn from ``seed``:
    splitmix64 of the pair, below 2**63 (a torch seed)."""
    z = (seed + (chunk + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class Draws:
    """Normal and Gamma draws from ``generator``, moved to ``device``."""

    def __init__(self, generator: torch.Generator, device):
        self.generator = generator
        self.device = torch.device(device)

    def normal(self, shape) -> torch.Tensor:
        z = torch.randn(tuple(shape), generator=self.generator, dtype=_F32,
                        device=self.generator.device)
        return z.to(self.device)

    def gamma(self, a: torch.Tensor) -> torch.Tensor:
        a = torch.as_tensor(a, dtype=_F32).to(self.generator.device)
        return torch._standard_gamma(a, generator=self.generator).to(
            self.device)

    def permutation(self, n: int, shard: int = 0,
                    n_shards: int = 1) -> torch.Tensor:
        perms = [torch.randperm(n, generator=self.generator,
                                device=self.generator.device)
                 for _ in range(n_shards)]
        return perms[shard].to(self.device)

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, tuple(shape), generator=self.generator,
                             dtype=torch.int32,
                             device=self.generator.device).to(self.device)

    def uniform(self, shape, lo: float, hi: float, shard: int = 0,
                n_shards: int = 1) -> torch.Tensor:
        u = torch.rand((n_shards,) + tuple(shape), generator=self.generator,
                       dtype=_F32, device=self.generator.device)[shard]
        return (u * (hi - lo) + lo).to(self.device)

    def column_normal(self, F: int, lo: int, D_loc: int) -> torch.Tensor:
        gdev = self.generator.device
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.generator,
                                 device=gdev))
        parts = []
        for c in range(lo // Z_CHUNK, -(-(lo + D_loc) // Z_CHUNK)):
            g = torch.Generator(device=gdev).manual_seed(chunk_seed(seed, c))
            parts.append(torch.randn(F, Z_CHUNK, generator=g, dtype=_F32,
                                     device=gdev))
        z = torch.cat(parts, 1)
        off = lo - (lo // Z_CHUNK) * Z_CHUNK
        return z[:, off:off + D_loc].contiguous().to(self.device)

    def window_uniform(self, windows: int, length: int, lo: float,
                       hi: float) -> torch.Tensor:
        return self.uniform((windows * length,), lo, hi)


def device_draws(seed: int, device) -> Draws:
    """The default source: a generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return Draws(gen, device)


def host_draws(seed: int, device) -> Draws:
    """A host-table source: CPU draws from ``seed``, moved to ``device``."""
    return Draws(torch.Generator().manual_seed(seed), device)
