"""The device mesh on ``torch.distributed`` (counterpart of
``sfmfromscratch_tpu/parallel/mesh.py``).

The engine scales over a 2-D :class:`~torch.distributed.device_mesh.DeviceMesh`
with the JAX package's axes:

* ``data``: images of the feature batch, image pairs of the relative-pose
  RANSAC and BA observations shard here;
* ``model``: the matcher's descriptor database shards here
  (``parallel/sharded_match.py``).

Execution model: one rank per JAX device, SPMD. Every rank runs the whole
engine on the full host state; what the JAX package shards is split by rank,
computed, then all-gathered or all-reduced, and everything else is computed
the same way on every rank. Every branch is therefore decided on values that
are equal on every rank (the reduced sums, the gathered lane masks), so the
ranks never part. ``put_global`` (``mesh.py:48-64``) has no counterpart: every
rank already holds the full arrays.

The backend is chosen explicitly and printed: NCCL when every rank has a
card of its own, gloo on the CPU and for ranks that share one card (NCCL
refuses two ranks on one GPU). gloo takes CUDA tensors for ``all_reduce`` and
``all_gather`` (it stages them through host memory itself), so the same
collectives serve every backend.
"""

from __future__ import annotations

import sys
from datetime import timedelta
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "mesh_shape", "init_distributed", "choose_backend", "MeshAxis",
           "mesh_axis", "is_writer", "all_reduce_sum", "all_gather_cat"]

# A process group waits this long for a collective before it raises, so that
# ranks that part fail instead of hanging.
DEFAULT_TIMEOUT = timedelta(seconds=300)


def mesh_shape(n: int, model_parallel: Optional[int] = None) -> Tuple[int, int]:
    """(data, model) sizes of an ``n``-rank mesh: ``model_parallel`` defaults
    to 2 when ``n`` is even and at least 4, else 1 (``mesh.py:27-45``)."""
    if model_parallel is None:
        model_parallel = 2 if n % 2 == 0 and n >= 4 else 1
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model groups of {model_parallel}")
    return n // model_parallel, model_parallel


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Tuple[str, str] = ("data", "model"),
    model_parallel: Optional[int] = None,
) -> DeviceMesh:
    """A (data, model) mesh over ranks ``0 .. n_devices-1`` of the process
    group that is already initialised (every rank calls it). Its device type
    names where the backend moves data: ``"cuda"`` for NCCL, ``"cpu"`` for
    gloo, whatever device the tensors are on."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (init_distributed)")
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    shape = mesh_shape(n, model_parallel)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def choose_backend(num_processes: int, device=None) -> Tuple[str, str]:
    """(backend, reason) for ``num_processes`` ranks that compute on
    ``device`` (the CUDA card unless ``"cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if num_processes <= cards:
        return "nccl", f"{num_processes} ranks on {cards} cards, one card each"
    return "gloo", (f"{num_processes} ranks share {cards} card(s); "
                    "NCCL refuses two ranks on one card")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> Optional[str]:
    """Bring up the process group of ``num_processes`` ranks, this one
    ``process_id``, at ``coordinator_address`` (``host:port`` for TCP, or a
    ``file://`` or ``tcp://`` URL). Does nothing for one process or fewer
    (``mesh.py:67-81``) and returns the backend it chose, which it prints."""
    if num_processes is None or num_processes <= 1:
        return None
    backend, reason = choose_backend(num_processes, device)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    print(f"init_distributed: rank {process_id} of {num_processes}, backend {backend} ({reason})",
          file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return backend


class MeshAxis(NamedTuple):
    """This rank's place on one axis of a mesh."""

    rank: int           # position on the axis
    size: int           # ranks on the axis
    group: object       # the axis's process group


def mesh_axis(mesh: Optional[DeviceMesh], axis: str) -> Optional[MeshAxis]:
    """This rank's place on ``axis`` of ``mesh``; None without a mesh or
    when the mesh has no such axis (it then shards nothing there, as every
    JAX site tests ``axis in mesh.shape``). Anything but a ``DeviceMesh``
    raises ``TypeError``."""
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got {type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        return None
    sub = mesh[axis]
    return MeshAxis(rank=sub.get_local_rank(), size=sub.size(), group=sub.get_group())


def is_writer(mesh: Optional[DeviceMesh]) -> bool:
    """True on the one rank of ``mesh`` that writes the engine's outputs (the
    JAX engine writes each output once); always True without a mesh."""
    return mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])


def all_reduce_sum(x: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``ax`` (``lax.psum``), equal to the
    bit on every rank; ``x`` is reduced in place and returned."""
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=ax.group)
    return x


def all_gather_cat(x: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) concatenated along
    dimension 0 in rank order (``lax.all_gather`` flattened)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=0)
