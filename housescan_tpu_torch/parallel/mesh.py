"""Device meshes and the collectives over them, from one controller.

The JAX package's mesh has a single controller: one process owns every
device of the mesh and runs one program over all of them (its CPU tests
run 8 virtual devices in one process). The port keeps that design: a
``Mesh`` is a list of ``torch.device``s with axis names, the sharded code
holds one tensor a shard (a list, shard order), and a collective is a
plain function over such a list that gives each receiving shard its
result on its own device. One process, no process group: the same code
runs 8 shards on the CPU in the tests, several shards on one card, or
one shard a card on a multi-card host, and every result is the same
floats as the single-device run where the reference's is (no
reduction's order depends on a transport).

A caller may pass ``devices`` that repeat an entry (8 x ``cpu`` in the
tests, 4 x ``cuda:0`` to run four slabs on one card); nothing repeats a
device unasked.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

VOLUME_AXIS = "shard"
ROOMS_AXIS = "rooms"


class Mesh:
    """``devices`` laid out in ``shape`` (row-major) with one name an axis."""

    def __init__(self, devices: Sequence, axis_names: Tuple[str, ...], shape=None):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None else (len(self.devices),)
        n = 1
        for s in self.shape:
            n *= s
        if n != len(self.devices) or len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} / axes {self.axis_names} do not fit "
                             f"{len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def row(self, i: int) -> "Mesh":
        """Row ``i`` of a 2-D mesh as a 1-D mesh over its last axis."""
        n = self.shape[-1]
        return Mesh(self.devices[i * n:(i + 1) * n], self.axis_names[-1:])


def _devices(need: int, devices, what: str) -> List[torch.device]:
    if devices is None:
        have = torch.cuda.device_count()
        if need > have:
            raise ValueError(f"requested {what} CUDA devices, have {have}; pass devices=[...] "
                             "to lay the mesh on others (an entry may repeat)")
        return [torch.device("cuda", i) for i in range(need)]
    devices = [torch.device(d) for d in devices]
    if need > len(devices):
        raise ValueError(f"requested {what} devices, {len(devices)} given")
    return devices[:need]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = VOLUME_AXIS,
              *, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: the
    visible CUDA devices, all of them when ``n_devices`` is None)."""
    if n_devices is None:
        n_devices = torch.cuda.device_count() if devices is None else len(devices)
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device; no CUDA device is visible")
    return Mesh(_devices(n_devices, devices, str(n_devices)), (axis_name,))


def make_mesh2d(n_rooms: int, n_slabs: int, *, devices: Optional[Sequence] = None) -> Mesh:
    """2-D (rooms x slabs) mesh: rooms on the outer axis, each room's
    volume X-slabs on the inner one."""
    need = n_rooms * n_slabs
    return Mesh(_devices(need, devices, f"{n_rooms}x{n_slabs}"), (ROOMS_AXIS, VOLUME_AXIS),
                shape=(n_rooms, n_slabs))


def _reduce(xs: Sequence[torch.Tensor], op, devices) -> List[torch.Tensor]:
    """Every shard's value reduced in shard order, on each of ``devices``
    (default: every shard's own)."""
    out = []
    for d in devices or [x.device for x in xs]:
        acc = xs[0].to(d)
        for x in xs[1:]:
            acc = op(acc, x.to(d))
        out.append(acc)
    return out


def psum(xs: Sequence[torch.Tensor], devices=None) -> List[torch.Tensor]:
    """All-reduce sum, x_0 + x_1 + ... in shard order, for every shard
    (or only onto ``devices``: a replicated result needs one copy)."""
    return _reduce(xs, torch.add, devices)


def pmin(xs: Sequence[torch.Tensor], devices=None) -> List[torch.Tensor]:
    """All-reduce elementwise minimum (see ``psum``)."""
    return _reduce(xs, torch.minimum, devices)


def pmax(xs: Sequence[torch.Tensor], devices=None) -> List[torch.Tensor]:
    """All-reduce elementwise maximum (see ``psum``)."""
    return _reduce(xs, torch.maximum, devices)


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[Optional[torch.Tensor]]:
    """Send shard ``src``'s value to shard ``dst`` for each (src, dst) of
    ``perm``, onto the receiver's device; a shard that no pair sends to
    gets None."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return out
