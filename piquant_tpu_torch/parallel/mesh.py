"""Mesh construction (counterpart of piquant_tpu/parallel/mesh.py).

A JAX mesh names the axes of an array of devices, and collectives inside
`shard_map` name the axis they run along.  Here a `Mesh` names the axes of
a row-major array of ranks, and `Mesh.axis(name)` is the handle the
collectives take in place of JAX's axis name.  A mesh takes one of two
forms:
  * over processes: with torch.distributed initialised and no `devices`,
    the mesh covers the world, one process a rank.  Every rank creates the
    process group of every slice along every axis (dist.new_group, in the
    same order on every rank), and `axis(name)` is the calling rank's group
    along that axis;
  * in one process: given `devices` (torch devices, repeats allowed, e.g.
    ["cpu"] * 8 or ["cuda:0"] * 8), every rank runs in this process, and
    `axis(name)` is a `StackedAxis`: the collectives then take tensors
    stacked over the axis, a leading dimension of one row a rank, as
    `shard_map` hands each device its row of a P(axis) input.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from piquant_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class StackedAxis:
    """A mesh axis whose ranks all run in this process: the collectives
    take tensors with a leading dimension of `size` rows, one a rank."""

    name: str
    size: int
    devices: Tuple[torch.device, ...]

    def check(self, x: torch.Tensor) -> None:
        if not x.dim() or x.shape[0] != self.size:
            raise ValueError(f"axis {self.name!r}: expected a tensor stacked "
                             f"over its {self.size} ranks, got shape "
                             f"{tuple(x.shape)}")
        if x.device not in self.devices:
            raise ValueError(f"axis {self.name!r}: the tensor lies on "
                             f"{x.device}, the axis on {set(self.devices)}")


Axis = Union[StackedAxis, dist.ProcessGroup]


class Mesh:
    """(name, size) axes over a row-major array of ranks (`ranks`)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Sequence[torch.device]] = None):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.ranks = np.arange(int(np.prod(sizes))).reshape(tuple(sizes))
        self.devices = None if devices is None else tuple(devices)
        self._groups: Dict[str, dist.ProcessGroup] = {}
        if self.devices is None:
            self._make_groups()

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def spans_processes(self) -> bool:
        return self.devices is None

    def _make_groups(self) -> None:
        me = dist.get_rank()
        for i, name in enumerate(self.axis_names):
            others = [range(s) for j, s in enumerate(self.ranks.shape)
                      if j != i]
            for idx in itertools.product(*others):
                lead = tuple(idx[:i]) + (slice(None),) + tuple(idx[i:])
                members = [int(r) for r in self.ranks[lead]]
                group = dist.new_group(members)
                if me in members:
                    self._groups[name] = group

    def axis(self, name: str) -> Axis:
        """The collectives' handle of axis `name`: this rank's process group
        along it, or a StackedAxis in the single-process form."""
        if name not in self.shape:
            raise ValueError(f"no axis {name!r} in mesh axes "
                             f"{self.axis_names}")
        if self.spans_processes:
            return self._groups[name]
        return StackedAxis(name, self.shape[name],
                           tuple(dict.fromkeys(self.devices)))


def make_mesh(axes: Sequence[Tuple[str, int]], *,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """Build a Mesh from (name, size) pairs; size -1 means "the rest".

    Example: make_mesh([("dp", 2), ("tp", -1)]) in a world of 8 processes
    -> a 2x4 mesh of process groups; make_mesh([("x", 8)], devices=["cpu"]
    * 8) -> 8 ranks stacked in this process.  Without `devices` and
    without torch.distributed the mesh is over this process's CUDA devices.
    """
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        n = len(devs)
    elif dist.is_available() and dist.is_initialized():
        devs = None
        n = dist.get_world_size()
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        n = len(devs)
    names = [a for a, _ in axes]
    sizes = [s for _, s in axes]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    known = int(np.prod([s for s in sizes if s != -1]))
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh wants {total} devices, have {n}")
    return Mesh(sizes, names, devs)
