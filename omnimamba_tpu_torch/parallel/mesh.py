"""The mesh of ranks: counterpart of ``omnimamba_tpu/parallel/mesh.py``.

Axes:
    dp    data parallel: each rank its own rows, gradients summed over ranks
          (the reference's 8-way DDP, its only strategy)
    fsdp  parameters, gradients and AdamW moments cut into one slice a rank;
          a leaf is gathered whole where it is used and its gradient
          reduce-scattered back (ZeRO-3)
    tp    tensor parallel over Mamba-2 heads (Megatron style): each rank
          runs its heads' columns of in_proj, the conv, the scan and the
          gated RMSNorm (in partial-sum form, K3b-tp, K6b-tp, K4-tp) and
          its rows of out_proj, summed over the tp ranks
          (``parallel/tensor.py``); the group is the mesh's ``tp`` axis

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, dp outermost, then fsdp, tp and any extra axis
(``{"sp": n}`` for the sequence-parallel prefill). One rank is one process
on one card (NCCL on ``cuda:LOCAL_RANK``, ``torchrun`` sets the variables);
gloo carries the collectives where the caller asks for the CPU.
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp")


def mesh_sizes(shape: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """The sizes of every axis of a mesh of ``shape`` over ``n`` ranks, in
    mesh order: the canonical three, then the extra axes in the given order.
    An axis not mentioned has size 1, except an absent ``dp``, which takes
    the remainder when the axes given divide ``n``; the product must be
    ``n``. With no shape every rank goes to dp."""
    shape = dict(shape or {})
    axes = list(AXES) + [ax for ax in shape if ax not in AXES]
    sizes = {ax: int(shape.get(ax, 1)) for ax in axes}
    if any(s < 1 for s in sizes.values()):
        raise ValueError(f"mesh axes must have a size of at least 1: {shape}")
    given = math.prod(sizes.values())
    if "dp" not in shape and given < n and n % given == 0:
        sizes["dp"] = n // given
    if math.prod(sizes.values()) != n:
        raise ValueError(f"mesh {sizes} does not cover the {n} ranks of the process group")
    return sizes


def create_mesh(shape: Optional[Dict[str, int]] = None, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``mesh_sizes(shape, world size)`` over the ranks of
    the initialised default process group, its axes named in mesh order."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialised process group (init_distributed)")
    sizes = mesh_sizes(shape, dist.get_world_size())
    return init_device_mesh(device_type, tuple(sizes.values()), mesh_dim_names=tuple(sizes))


def local_mesh_1d(n: Optional[int] = None, device_type: str = "cuda"):
    """A one-axis dp mesh over the ranks of the process group (``n``, where
    given, must be their number)."""
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a dp mesh of {n} ranks in a process group of {world}")
    return create_mesh({"dp": world}, device_type)


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` in ``mesh`` (1 where the mesh lacks it or is None)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 where the mesh lacks it)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


class RankInfo(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    device: torch.device


def init_distributed(device: str = "cuda") -> RankInfo:
    """Join this process to its job's process group and give it its device.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT`` set) ``device="cuda"`` takes NCCL on
    ``cuda:LOCAL_RANK`` and raises where the host has no such card: two ranks
    never share a card. ``device="cpu"`` takes gloo. A process group that is
    already initialised is kept as it is (its rank, its backend). Without
    torchrun's variables the process is rank 0 of 1 and no group is made;
    under torchrun a group is made at any world size, one included."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
        local = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} needs cuda:{local}; this host has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} card(s) "
                "(one rank a card; pass device='cpu' for gloo ranks on the CPU)")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized() and "RANK" in os.environ:
        dist.init_process_group("nccl" if device == "cuda" else "gloo", rank=rank,
                                world_size=world, device_id=dev if device == "cuda" else None)
    return RankInfo(rank, world, local, dev)
