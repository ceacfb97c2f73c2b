"""Process groups and device meshes for multi-card runs (PyTorch port of
``splatjax/parallel/mesh.py``).

splatjax runs one program that sees every device through ``shard_map``;
the port runs one process per rank (``torchrun``), each on its own card.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with splatjax's
axis names: an axis is one mesh dimension (``mesh.get_group(name)``), and
a tuple of names is the flattened group of those dimensions, the last name
minor. :func:`make_mesh_2d` builds that flattened group once and keeps it
on the mesh (``mesh.flat_group``); :func:`axis_group` resolves either form.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from splatjax_torch.device import resolve_device

AxisName = Union[str, Sequence[str]]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> bool:
    """Start the default process group if a multi-process environment is
    configured; call once per process before building meshes.

    ``coordinator_address`` is an init URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``; without it torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` are read (``env://``), and
    ``num_processes``/``process_id`` default to ``WORLD_SIZE``/``RANK``.
    ``device="cuda"`` starts NCCL on card ``LOCAL_RANK`` (default: the
    rank) and runs one all_reduce there, so a failed start raises here;
    it never falls back to gloo or the CPU. ``device="cpu"`` starts gloo.
    Returns True once the group is up (also when it already was), False
    when no address is given or configured: a single process needs none.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            return False
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = int(env.get("WORLD_SIZE", 1)) if num_processes is None \
        else num_processes
    rank = int(env.get("RANK", 0)) if process_id is None else process_id
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
        dist.init_process_group("nccl", init_method=init_method,
                                world_size=world, rank=rank)
        probe = torch.ones(1, device="cuda")
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        if float(probe) != world:
            raise RuntimeError(f"NCCL start: all_reduce of ones over {world} "
                               f"ranks gave {float(probe)}")
    else:
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank)
    return True


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() "
                           "(or torch.distributed.init_process_group) "
                           "first")
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "dev",
              device="cuda") -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (default: all). Every
    rank of the process group calls it; ranks outside the mesh get no
    group and must not call the mesh's collectives."""
    world = _world()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError(f"n_devices must be in [1, {world}], got {n}")
    return DeviceMesh(resolve_device(device).type, torch.arange(n),
                      mesh_dim_names=(axis_name,))


def make_mesh_2d(shape: Sequence[int],
                 axis_names: Sequence[str] = ("host", "chip"),
                 device="cuda") -> DeviceMesh:
    """2-D mesh over the first ``prod(shape)`` ranks, row-major.

    ``render_sharded(..., axis=("host", "chip"))`` flattens both axes into
    one band axis with 'chip' minor: band ``host * n_chip + chip``, which
    is the rank's index in ``mesh.flat_group`` (all the mesh's ranks, in
    order), built here once."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    world = _world()
    if len(shape) != 2 or not 0 < n <= world:
        raise ValueError(f"mesh shape {shape} must be 2-D with at most "
                         f"{world} ranks")
    mesh = DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))
    # every rank of the default group takes part in new_group
    mesh.flat_group = dist.new_group(list(range(n)))
    return mesh


class AxisGroup(NamedTuple):
    """This rank's group along a mesh axis, its size and the rank's index
    in it (splatjax's ``axis_size`` and ``_axis_flat_index``)."""

    group: dist.ProcessGroup
    size: int
    index: int


def mesh_axis_size(mesh: DeviceMesh, axis: AxisName) -> int:
    """Ranks along ``axis`` (a name or a tuple of names); every rank can
    ask, in the mesh or not."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    dims = mesh.mesh_dim_names
    return int(np.prod([mesh.size(dims.index(a)) for a in names]))


def axis_group(mesh: DeviceMesh, axis: AxisName) -> AxisGroup:
    """The group of ``axis``: a mesh dimension's name, or a tuple naming
    every dimension in the mesh's order (flattened, last name minor)."""
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh")
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    dims = tuple(mesh.mesh_dim_names)
    if len(names) == 1:
        return AxisGroup(mesh.get_group(names[0]),
                         mesh.size(dims.index(names[0])),
                         mesh.get_local_rank(names[0]))
    if names != dims or not hasattr(mesh, "flat_group"):
        raise ValueError(f"a tuple axis must name every dimension of a "
                         f"make_mesh_2d mesh in order {dims}, got {names}")
    group = mesh.flat_group
    return AxisGroup(group, dist.get_world_size(group),
                     dist.get_rank(group))


def mesh_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The group of all of the mesh's ranks."""
    dims = tuple(mesh.mesh_dim_names)
    return axis_group(mesh, dims[0] if len(dims) == 1 else dims).group
