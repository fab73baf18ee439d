"""Meshes and data parallelism; counterpart of the JAX package's
`parallel/mesh.py`.

The JAX package runs one program over a mesh of devices, and its SPMD
partitioner inserts the gradient all-reduce. PyTorch splits that in two:

- data parallelism is one process per GPU (`torch.distributed` and
  `DistributedDataParallel`): a data-parallel mesh holds the RANKS of a
  process group, each rank holding a copy of the state and its rows of
  the global batch;
- spatial partitioning (`parallel/spatial.py`) is one process driving
  several devices: its mesh holds DEVICES, in band order.

`make_mesh` and `make_mesh_2d` build either kind. `init_process_group`
joins the process group that `python -m torch.distributed.run` describes
in the environment (or one named by the caller) and returns the rank's
`DataParallel`: its place in the mesh, its device, its rows of a batch
(`shard`) and the mean all-reduce of scalars (`mean`). NCCL is the
backend of a CUDA device and gloo of the CPU; a caller may name either,
and nothing switches from one to the other silently.
"""

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"        # ranks (or devices) of one host
REPLICA_AXIS = "replica"  # hosts


class Mesh:
    """An n-dimensional array of ranks or devices with named axes."""

    def __init__(self, members, axis_names: Sequence[str]):
        arr = np.empty(np.shape(members), dtype=object)
        arr[...] = members
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d mesh with axes {axis_names}")
        self.members = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.members.shape))

    @property
    def size(self) -> int:
        return int(self.members.size)

    @property
    def devices(self) -> list:
        """The members in the mesh's order (the row-band or batch-shard
        order: the last axis fastest)."""
        return list(self.members.reshape(-1))

    def __repr__(self):
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({shape}: {self.devices})"


def visible_devices(device_type: str = "cuda") -> list:
    """The devices of a type that this process sees: every CUDA device,
    or the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh of `devices` (every visible CUDA device by default) in
    the order given. A list may name one device several times: n bands
    on one device are the n-device mesh's work done in turn."""
    if devices is None:
        devices = visible_devices()
    return Mesh([d if isinstance(d, int) else _indexed(torch.device(d))
                 for d in devices], (axis_name,))


def _indexed(device: torch.device) -> torch.device:
    """`cuda` -> `cuda:<current device>`, the name its tensors carry."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def infer_n_slices() -> int:
    """Distinct hosts of the process group `torch.distributed.run`
    started: WORLD_SIZE / LOCAL_WORLD_SIZE (1 outside it)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return max(world // max(local, 1), 1)


def make_mesh_2d(n_slices: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None) -> Mesh:
    """(replica, data) mesh of ranks, slice-major: each row is one host's
    ranks. `torch.distributed.run` numbers ranks host by host, so the rows
    are runs of consecutive ranks. The batch is sharded over both axes
    (row-major), as the JAX package's `batch_sharding` shards it; the
    gradient all-reduce is DDP's over the whole group, which NCCL splits
    into its intra-host and inter-host parts itself."""
    if ranks is None:
        ranks = range(dist.get_world_size() if dist.is_initialized() else 1)
    ranks = sorted(int(r) for r in ranks)
    if n_slices is None:
        n_slices = infer_n_slices()
    if len(ranks) % n_slices:
        raise ValueError(f"{len(ranks)} ranks not divisible into "
                         f"{n_slices} slices")
    return Mesh(np.asarray(ranks, dtype=object).reshape(n_slices, -1),
                (REPLICA_AXIS, DATA_AXIS))


def shard_rows(batch, index: int, count: int):
    """Rows [index * n, (index + 1) * n) of a global batch (numpy array or
    tensor) of count * n rows: shard `index` of `count`."""
    size = int(batch.shape[0])
    if size % count:
        raise ValueError(f"batch_size {size} not divisible by the "
                         f"{count}-rank mesh")
    n = size // count
    return batch[index * n:(index + 1) * n]


class DataParallel:
    """This rank's view of a data-parallel process group: the mesh of
    ranks, this rank, its device and its position in the batch."""

    def __init__(self, mesh: Mesh, rank: int, device: torch.device,
                 backend: str, owns_group: bool = False):
        self.mesh = mesh
        self.rank = rank
        self.device = device
        self.backend = backend
        self.index = mesh.devices.index(rank)  # shard of the batch
        self.owns_group = owns_group  # close() destroys the group

    @property
    def world(self) -> int:
        return self.mesh.size

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard(self, batch):
        """This rank's rows of a global batch."""
        return shard_rows(batch, self.index, self.world)

    def mean(self, values):
        """All-reduced mean over the ranks of a scalar tensor or of a dict
        of them, in one collective; no gradient."""
        if torch.is_tensor(values):
            return self.mean({"v": values})["v"]
        keys = list(values)
        flat = torch.stack([values[k].detach().float().reshape(())
                            for k in keys])
        dist.all_reduce(flat)
        flat = flat / self.world
        return {k: flat[i].to(values[k].dtype) for i, k in enumerate(keys)}

    def max(self, value: float) -> float:
        """The largest of a host number over the ranks."""
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self) -> None:
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()

    def __repr__(self):
        return (f"DataParallel(rank {self.rank} of {self.world}, shard "
                f"{self.index}, {self.device}, {self.backend}, {self.mesh})")


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_process_group(device=None, backend: Optional[str] = None,
                       n_slices: Optional[int] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: str = "env://",
                       timeout_s: float = 600.0) -> DataParallel:
    """Join the process group and return this rank's `DataParallel`.

    rank, world_size: from RANK / WORLD_SIZE (set by torch.distributed.run)
    unless given, with `init_method` the rendezvous (`env://` reads
    MASTER_ADDR / MASTER_PORT; `file://<path>` needs no port). device: the
    rank's device; `cuda` (the default) means `cuda:LOCAL_RANK`, and a
    named `cuda:i` is kept, so several ranks may share a card (gloo only:
    NCCL refuses two ranks on one GPU). backend: NCCL for a CUDA device,
    gloo for the CPU, unless named. n_slices: a (replica, data) mesh of
    that many rows (`infer_n_slices()` by default); it must divide the
    world. Where the caller has initialised the default process group
    already, that group is used (its rank, size and backend) and left
    open by `DataParallel.close`."""
    joined = dist.is_initialized()
    if joined:
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", "0")) if rank is None else rank
        world = (int(os.environ.get("WORLD_SIZE", "1"))
                 if world_size is None else world_size)
    n_slices = infer_n_slices() if n_slices is None else n_slices
    if n_slices < 1 or world % n_slices:
        raise ValueError(f"--n_slices {n_slices} does not divide the "
                         f"world of {world} ranks")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' "
                               "(with the gloo backend) to train on the CPU")
        if device.index is None:
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", str(rank))))
        torch.cuda.set_device(device)
    if joined:
        if backend is not None and backend != dist.get_backend():
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"not the {backend} asked for")
        backend = dist.get_backend()
    else:
        backend = backend or default_backend(device)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
    ranks = range(world)
    mesh = (make_mesh_2d(n_slices, ranks) if n_slices > 1
            else make_mesh(list(ranks)))
    return DataParallel(mesh, rank, device, backend, owns_group=not joined)
