"""Meshes and replica groups over a pool of torch devices (the port of
``repro.launch.mesh``'s ``make_host_mesh`` and ``replica_groups``).

A pool is a list of ``torch.device`` entries, which may repeat: two
entries naming ``cuda:0`` are two shards on one card, as XLA's forced
host devices are for ``repro`` on the CPU.  A device id is the entry's
index in the pool (``repro``'s ids are the jax device ids of its pool,
0..n-1 for the forced host devices, so the two line up).

``make_host_mesh`` lays a pool out as a ``(data, model)`` grid: the mesh
that ``sharding.specs.mesh_context`` installs and the expert-parallel
MoE (``models.moe_ep``) and the EDRA collectives read.  There is no
GSPMD in one process, so a mesh is only the grid of entries: code that
runs "on" it moves each shard's tensors to the shard's entry itself.

``make_production_mesh`` is ``repro``'s production grid, (16, 16) over
``(data, model)`` or (2, 16, 16) over ``(pod, data, model)``, with a
``meta`` entry at every place: the dry run (``launch.dryrun``) reads its
axis names and sizes and allocates nothing on it.  ``HARDWARE`` holds the
figures of the card those meshes are reckoned on, an H100 SXM, in place
of ``repro``'s TPU v5e.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels.backend import resolve_device


class DeviceGroup(NamedTuple):
    """The devices of one replica group and their ids in the pool."""

    devices: Tuple[torch.device, ...]
    ids: Tuple[int, ...]


class DeviceMesh(NamedTuple):
    """A grid of pool entries, nested one tuple an axis: ``devices[i][j]``
    is the entry at index i of the first axis and j of the second (and
    ``devices[i][j][k]`` on a third), ``axis_names`` names the axes."""

    devices: Tuple
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        sizes, level = [], self.devices
        for _ in self.axis_names:
            sizes.append(len(level))
            level = level[0]
        return dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        """The number of entries (jax's ``mesh.devices.size``)."""
        return math.prod(self.shape.values())

    def entries(self) -> List[torch.device]:
        """Every entry in row-major order (jax's ``mesh.devices.flat``)."""
        out = list(self.devices)
        for _ in self.axis_names[1:]:
            out = [d for row in out for d in row]
        return out


def _pool(pool: Optional[Sequence]) -> List[torch.device]:
    """The entries of ``pool``; ``None`` means one per visible CUDA card
    (raises without one)."""
    if pool is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in pool]


def make_host_mesh(model_axis: int = 1,
                   pool: Optional[Sequence] = None) -> DeviceMesh:
    """A ``(data, model)`` mesh of ``(n // model_axis, model_axis)`` over
    the ``n`` entries of ``pool``, row-major (``repro``'s
    ``make_host_mesh`` over its devices).  ``model_axis`` must divide
    ``n``; entries may repeat, so ``["cuda:0"] * 4`` is four shards on
    one card."""
    devices = _pool(pool)
    n = len(devices)
    if model_axis < 1 or n % model_axis:
        raise ValueError(
            f"model_axis={model_axis} must be >= 1 and divide the "
            f"{n} available device(s) exactly; pick a divisor of {n} "
            f"(or pass a pool of a multiple of {model_axis} entries)")
    return DeviceMesh(tuple(tuple(devices[i:i + model_axis])
                            for i in range(0, n, model_axis)))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """``repro``'s production mesh, (16, 16) over ``(data, model)`` or
    (2, 16, 16) over ``(pod, data, model)``, with a ``meta`` entry at every
    place: a mesh to reckon shardings on, not to run on."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = torch.device("meta")
    for n in reversed(shape):
        grid = (grid,) * n
    return DeviceMesh(grid, axes)


def replica_groups(pool: Optional[Sequence], tp: int) -> List[DeviceGroup]:
    """Carve a device pool into per-replica tensor-parallel groups of
    ``tp`` consecutive entries: the unit a ring node maps to in the serve
    plane (node = replica group, not device).  ``pool=None`` means one
    entry per visible CUDA card (raises without one)."""
    devices = _pool(pool)
    n = len(devices)
    if tp < 1 or n % tp:
        raise ValueError(
            f"tp={tp} must be >= 1 and divide the {n} pooled device(s) "
            f"exactly — a partial group cannot hold a full weight shard "
            f"set")
    return [DeviceGroup(tuple(devices[i:i + tp]), tuple(range(i, i + tp)))
            for i in range(0, n, tp)]


HARDWARE = {
    # NVIDIA H100 SXM5 80GB, NVIDIA's data sheet (dense, without sparsity)
    "peak_bf16_flops": 989e12,       # FLOP/s, bf16 on the tensor cores
    "hbm_bandwidth": 3.35e12,        # B/s, HBM3
    # NVLink 4: 900 GB/s in all per GPU (18 links), 450e9 each way
    "nvlink_bandwidth": 450e9,       # B/s each way per GPU
    "hbm_bytes": 80 * 10**9,         # the data sheet's 80 GB
}
