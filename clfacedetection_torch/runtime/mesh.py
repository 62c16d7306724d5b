"""Device meshes, and the work of a mesh's positions.

Port of ``clfacedetection_tpu/runtime/mesh.py``.  The JAX package's
multi-device layer is single-controller: one process drives every device
through ``shard_map``, and its only collective is an ``all_gather`` of
fixed-size survivor buffers.  The port keeps that model with one process
and an explicit list of devices: a shard's work is launched on its own
device and stream, and the gather is a copy onto the home device (position
0), ordered by CUDA events.

A :class:`Mesh` position may repeat a device.  That is the counterpart of
the JAX tests' virtual CPU devices: ``Mesh([torch.device("cpu")] * 8)``
on the CPU, or eight positions of ``cuda:0`` on one card, runs the same
k-way logic (strip offsets, per-shard caps, round-robin dispatch, the
merges) as k devices would.  On the card each position has a stream of
its own (``program_stream(device, slot=position)``), so that k positions
on one card overlap as k cards would.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from .program import indexed, program_stream

__all__ = ["Fork", "Mesh", "data_parallel_mesh"]


class Mesh:
    """A 1-D mesh: a tuple of devices (a device may repeat) and its axis
    name, as ``jax.sharding.Mesh(np.array(devices), (axis_name,))``.
    ``shape`` maps the axis name to the size."""

    def __init__(self, devices: Sequence, axis_names=("data",)):
        devs = tuple(indexed(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got "
                             f"{[str(d) for d in devs]}")
        names = (axis_names,) if isinstance(axis_names, str) \
            else tuple(axis_names)
        if len(names) != 1:
            raise ValueError(f"the port's meshes have one axis, got "
                             f"{names}")
        self.devices = devs
        self.axis_names = names

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.size}

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.axis_names})")


def data_parallel_mesh(devices: Optional[Sequence] = None,
                       axis_name: str = "data") -> Mesh:
    """1-D mesh over every CUDA device (or the given devices).  With no
    card and no devices it raises: there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass the devices of the "
                               "mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis_name,))


class Fork:
    """The work of mesh positions, each on its own device and stream,
    forked from the home device's current stream and joined back to it.

    ``with fork.at(i):`` runs a block on position ``i``: its device is
    current, and on the card its stream (``program_stream(device, i)``),
    which first waits for the home stream's work so far.  ``fork.home(t,
    i)`` brings a tensor of position ``i`` to the home device: a copy
    across cards, else the tensor itself, marked as read by the home
    stream.  ``fork.join()`` makes the home stream wait for every
    position.  Inside a CUDA graph capture the forks and the join are
    captured too, so that one graph runs the positions on their streams.
    On the CPU every block runs in line."""

    def __init__(self, devices: Sequence[torch.device], home=None):
        self.devices = [indexed(d) for d in devices]
        self.home_device = indexed(home) if home is not None \
            else self.devices[0]
        self.cuda = self.home_device.type == "cuda"
        self.origin = torch.cuda.current_stream(self.home_device) \
            if self.cuda else None
        self.streams: List = [program_stream(d, slot=i) if self.cuda
                              else None
                              for i, d in enumerate(self.devices)]

    @contextlib.contextmanager
    def at(self, i: int):
        d = self.devices[i]
        if not self.cuda:
            yield d
            return
        s = self.streams[i]
        if s != self.origin:
            s.wait_stream(self.origin)
        with torch.cuda.device(d), torch.cuda.stream(s):
            yield d

    def home(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Tensor ``t`` of position ``i`` on the home device; call inside
        ``at(i)``."""
        if t.device != self.home_device:
            # a copy across cards runs on the source's stream, ordered
            # with the home device's current stream both ways
            return t.to(self.home_device, non_blocking=True)
        if self.cuda and self.streams[i] != self.origin:
            t.record_stream(self.origin)
        return t

    def join(self) -> None:
        if not self.cuda:
            return
        for s in dict.fromkeys(self.streams):
            if s != self.origin:
                self.origin.wait_stream(s)
