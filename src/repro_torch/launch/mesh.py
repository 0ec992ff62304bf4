"""Replica groups over a pool of torch devices (the port of
``repro.launch.mesh.replica_groups``).

A pool is a list of ``torch.device`` entries, which may repeat: two
entries naming ``cuda:0`` are two shards on one card, as XLA's forced
host devices are for ``repro`` on the CPU.  A device id is the entry's
index in the pool (``repro``'s ids are the jax device ids of its pool,
0..n-1 for the forced host devices, so the two line up).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels.backend import resolve_device


class DeviceGroup(NamedTuple):
    """The devices of one replica group and their ids in the pool."""

    devices: Tuple[torch.device, ...]
    ids: Tuple[int, ...]


def replica_groups(pool: Optional[Sequence], tp: int) -> List[DeviceGroup]:
    """Carve a device pool into per-replica tensor-parallel groups of
    ``tp`` consecutive entries: the unit a ring node maps to in the serve
    plane (node = replica group, not device).  ``pool=None`` means one
    entry per visible CUDA card (raises without one)."""
    if pool is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(d) for d in pool]
    n = len(devices)
    if tp < 1 or n % tp:
        raise ValueError(
            f"tp={tp} must be >= 1 and divide the {n} pooled device(s) "
            f"exactly — a partial group cannot hold a full weight shard "
            f"set")
    return [DeviceGroup(tuple(devices[i:i + tp]), tuple(range(i, i + tp)))
            for i in range(0, n, tp)]
