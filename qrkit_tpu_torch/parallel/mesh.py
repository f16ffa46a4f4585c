"""Device-mesh helpers on ``torch.distributed``, and the port's collectives.

Counterpart of ``qrkit_tpu/parallel/mesh.py`` (``default_mesh``,
``shard_leading_axis``).  The distribution axis is the block axis, as in the
reference: block-diagonal QR is embarrassingly parallel over blocks, and
collectives appear only where composition needs them (the TSQR all-gather,
the boundary chain of the segmented solver, the LM cost).

The reference hands XLA sharded global arrays and lets its SPMD partitioner
insert the collectives.  The port is explicit SPMD instead: every rank of a
:class:`~torch.distributed.device_mesh.DeviceMesh` runs the same program on
the same global inputs, works on its own contiguous chunk of the leading
axis, and calls the collectives below itself.  Every public result is the
global value on every rank.  The default process group must already be
initialized (``torch.distributed.init_process_group``); NCCL on the card,
gloo on the CPU.

Each helper issues one collective (an all-gather is one
``all_gather_into_tensor`` into one flat buffer), so a captured program
holds it as one graph node, and counts it
(:func:`qrkit_tpu_torch.profiling.collective_counts`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import _device, profiling

__all__ = [
    "all_gather_leading",
    "all_reduce_sum",
    "default_mesh",
    "mesh_rank",
    "shard_bounds",
    "shard_leading_axis",
    "shard_sizes",
]


def default_mesh(n_devices: Optional[int] = None, axis: str = "dp", device=None) -> DeviceMesh:
    """A one-dimensional mesh named ``axis`` over every rank of the default
    process group, on ``device``'s type (CUDA unless the caller asks for the
    CPU).  ``n_devices`` must be None or the world size: under SPMD every rank
    runs the program, so the mesh spans them all."""
    if not dist.is_initialized():
        raise RuntimeError(
            "default_mesh needs an initialized default process group "
            "(torch.distributed.init_process_group)"
        )
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"default_mesh spans all {world} ranks of the process group, not {n}")
    return init_device_mesh(_device.resolve(device).type, (n,), mesh_dim_names=(axis,))


def mesh_rank(mesh: DeviceMesh, axis: str = "dp") -> Tuple[int, int]:
    """(this rank's index, number of ranks) along the mesh axis."""
    group = mesh.get_group(axis)
    return dist.get_rank(group), dist.get_world_size(group)


def shard_sizes(n: int, world: int) -> List[int]:
    """Leading-axis lengths of the ``world`` contiguous chunks of ``n`` rows
    (``torch.tensor_split`` sizes: the first ``n % world`` one longer)."""
    q, rem = divmod(n, world)
    return [q + (r < rem) for r in range(world)]


def shard_bounds(n: int, mesh: DeviceMesh, axis: str = "dp", even: bool = True) -> Tuple[int, int]:
    """[lo, hi) of this rank's chunk of a leading axis of length ``n``.
    ``even=True`` refuses an axis the mesh does not divide (where the
    reference's ``jax.device_put`` refuses the sharding)."""
    rank, world = mesh_rank(mesh, axis)
    if even and n % world:
        raise ValueError(
            f"a leading axis of {n} does not divide over the {world} ranks of "
            f"mesh axis {axis!r}"
        )
    sizes = shard_sizes(n, world)
    lo = sum(sizes[:rank])
    return lo, lo + sizes[rank]


def shard_leading_axis(x, mesh: DeviceMesh, axis: str = "dp"):
    """This rank's contiguous chunk of the leading axis of a tensor, or of
    every tensor in a tuple, list or dict (the reference places the whole
    array sharded; each rank here keeps its chunk).  Raises ValueError when
    the mesh does not divide the axis."""
    if isinstance(x, dict):
        return {k: shard_leading_axis(v, mesh, axis) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(shard_leading_axis(v, mesh, axis) for v in x)
    lo, hi = shard_bounds(x.shape[0], mesh, axis)
    return x[lo:hi]


def _issue(name: str, fn, *args, **kwargs) -> None:
    """Issue the ``torch.distributed`` collective ``fn`` and count it
    (:func:`qrkit_tpu_torch.profiling.collective_counts`; a captured
    program counts those its capture issued at each replay)."""
    profiling._note_collective(name)
    fn(*args, **kwargs)


def all_gather_leading(
    x: torch.Tensor, mesh: DeviceMesh, axis: str = "dp", sizes: Optional[List[int]] = None
) -> torch.Tensor:
    """Concatenate every rank's ``x`` along the leading axis, in rank order:
    one ``all_gather_into_tensor`` into one flat ``[world·top, ...]``
    buffer (a capture holds it as one collective).  ``sizes`` gives each
    rank's leading length where they differ; the shards are then padded to
    the longest for the exchange and cut after it."""
    group = mesh.get_group(axis)
    world = dist.get_world_size(group)
    sizes = sizes if sizes is not None else [x.shape[0]] * world
    top = max(sizes)
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))])
    x = x.contiguous()
    flat = x.new_empty((world * top,) + tuple(x.shape[1:]))
    _issue("all_gather_into_tensor", dist.all_gather_into_tensor, flat, x, group=group)
    if all(s == top for s in sizes):
        return flat
    return torch.cat([flat[r * top : r * top + s] for r, s in enumerate(sizes)])


def all_reduce_sum(x: torch.Tensor, mesh: DeviceMesh, axis: str = "dp") -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor, on every rank): one
    ``all_reduce``."""
    out = x.clone(memory_format=torch.contiguous_format)
    _issue("all_reduce", dist.all_reduce, out, group=mesh.get_group(axis))
    return out
