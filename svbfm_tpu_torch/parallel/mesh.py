"""Process groups of the feature-sharded learners on ``torch.distributed``.

Counterpart of ``svbfm_tpu/parallel/mesh.py``.  JAX runs one SPMD program
over a device mesh and combines sums with ``psum`` inside ``shard_map``;
here every rank is one process on one device, and the sums are
``all_reduce``s over the groups of a 2-D ``(data, feature)`` mesh:

* rank r sits at mesh coordinate (d, f) = (r // n_feature, r % n_feature),
  JAX's process-major ``reshape(n_data, n_feature)`` of its device list;
* the data group of feature index f holds the ranks (0, f), (1, f), ...:
  a column's statistics, summed over the rows of every data shard;
* the feature group of data index d holds (d, 0), (d, 1), ...: a row's
  partial sums, summed over the feature shards of the tables.

Every rank creates every group, in the same order.  A group of one does
nothing: a one-rank mesh is the single-device learner, and no collective
runs.  Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo
has no other collective on CUDA tensors.

The backend is NCCL for ``cuda`` and gloo for ``cpu``.  A caller may ask
for gloo on ``cuda``, which is how several ranks share one card; NCCL with
two ranks on one device is refused with an error, never switched quietly.
A rank's device is ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank,
modulo the cards), set with ``torch.cuda.set_device`` before any launch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


def check_backend(backend: str, device_type: str,
                  local_ranks: Optional[int], n_devices: int) -> None:
    """Raise where ``backend`` cannot serve ``local_ranks`` ranks of one
    host on ``n_devices`` devices of ``device_type``: NCCL needs CUDA and a
    device of its own for each rank (it refuses two ranks on one device;
    ask for gloo to share a card).  ``local_ranks`` None: the ranks of
    this host are not known, and NCCL's own error stands."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use nccl or gloo")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("NCCL runs on CUDA devices only; use gloo on the "
                         "CPU")
    if backend == "nccl" and local_ranks is not None \
            and local_ranks > n_devices:
        raise ValueError(
            f"NCCL cannot run {local_ranks} ranks on {n_devices} CUDA "
            "device(s): it needs one device a rank.  Ask for the gloo "
            "backend to put several ranks on one card")


def local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def local_world_size(init_method: str, world_size: int) -> Optional[int]:
    """The ranks on this host: ``LOCAL_WORLD_SIZE`` where it is set, the
    whole world where the rendezvous is a ``file://`` store or a loopback
    address (every rank on one host), else None (ranks across hosts, as
    ``SVBFM_COORDINATOR`` at another host gives, with no count of this
    host's)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if init_method.startswith("file://"):
        return world_size
    host = init_method.split("://", 1)[-1].rsplit(":", 1)[0].strip("[]")
    if host in ("localhost", "127.0.0.1", "::1"):
        return world_size
    return None


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank`` for ``device`` ("cuda" or "cpu"): on CUDA the
    card of its local rank (several ranks share a card where there are
    fewer cards than ranks), made the current device."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("device cuda: torch.cuda.is_available() is "
                           "False; pass device='cpu' to run the plain "
                           "PyTorch twins")
    dev = torch.device("cuda", local_rank(rank) % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Join the process group of a multi-process run.

    The configuration comes from the arguments, else from
    ``SVBFM_COORDINATOR`` (``host:port``, or a ``tcp://`` or ``file://``
    URL), ``SVBFM_NUM_PROCESSES`` and ``SVBFM_PROCESS_ID``, the JAX
    package's variables.  Returns False, and does nothing, where there is
    none (a single-process run may call this unconditionally); True once
    the group is joined.  Idempotent.  ``backend`` None: NCCL on ``cuda``,
    gloo on ``cpu``."""
    if dist.is_initialized():
        return True
    init_method = init_method or os.environ.get("SVBFM_COORDINATOR")
    if init_method is None:
        return False
    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    if world_size is None:
        world_size = int(os.environ.get("SVBFM_NUM_PROCESSES", "1"))
    if rank is None:
        rank = int(os.environ.get("SVBFM_PROCESS_ID", "0"))
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    local_ranks = local_world_size(init_method, world_size)
    n_dev = torch.cuda.device_count() if dev_type == "cuda" else 0
    check_backend(backend, dev_type, local_ranks, n_dev)
    rank_device(device, rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) in a single-process run."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class Mesh:
    """A ``(data, feature)`` mesh of the ranks, this rank's place in it and
    its groups; ``shape`` is (n_data, n_feature), JAX's
    ``mesh.devices.shape``."""

    n_data: int
    n_feature: int
    rank: int
    device: torch.device
    data_group: object = field(default=None, repr=False)
    feature_group: object = field(default=None, repr=False)

    @property
    def shape(self) -> tuple[int, int]:
        return self.n_data, self.n_feature

    @property
    def size(self) -> int:
        return self.n_data * self.n_feature

    @property
    def d_index(self) -> int:
        return self.rank // self.n_feature

    @property
    def f_index(self) -> int:
        return self.rank % self.n_feature

    def all_reduce_data(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the data group (nothing on a group of
        one); returns it."""
        if self.n_data > 1:
            dist.all_reduce(t, group=self.data_group)
        return t

    def all_reduce_feature(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the feature group (nothing on a group
        of one); returns it."""
        if self.n_feature > 1:
            dist.all_reduce(t, group=self.feature_group)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over every rank of the mesh."""
        if self.size > 1:
            dist.all_reduce(t)
        return t

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def make_mesh2d(n_data: Optional[int] = None, n_feature: int = 1,
                device="cuda") -> Mesh:
    """The ``(data, feature)`` mesh over every rank of the process group
    (one rank, the mesh (1, 1), without one); ``n_data`` None: the world
    size over ``n_feature``.  Must be called by every rank, in the same
    order: it creates the groups."""
    rank, world = process_info()
    if n_feature < 1 or world % n_feature:
        raise ValueError(f"n_feature={n_feature} does not divide the world "
                         f"size {world}")
    if n_data is None:
        n_data = world // n_feature
    if n_data * n_feature != world:
        raise ValueError(f"a ({n_data}, {n_feature}) mesh needs "
                         f"{n_data * n_feature} ranks; the world has "
                         f"{world}")
    mesh = Mesh(n_data, n_feature, rank, rank_device(device, rank))
    if world > 1:
        for f in range(n_feature):
            g = dist.new_group([d * n_feature + f for d in range(n_data)])
            if f == mesh.f_index:
                mesh.data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_feature + f for f in range(n_feature)])
            if d == mesh.d_index:
                mesh.feature_group = g
    return mesh


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The 1-D data mesh: every rank a data shard (JAX's ``make_mesh``)."""
    _, world = process_info()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} needs as many ranks; the "
                         f"world has {world}")
    return make_mesh2d(n_data=world, n_feature=1, device=device)
