"""Elastic re-meshing and straggler eviction driven by membership events
(the port's copy of ``repro.runtime.elastic``, numpy-free host code).

  * A membership event triggers a re-mesh plan: keep the model axis fixed
    (the tensor-parallel group's size), resize the data axis to the
    largest power of two of healthy groups, and drop the hosts left over.
  * Straggler detection generalizes the paper's Rule 5: a host whose
    step time lags ``factor`` x the fleet median is evicted (a leave
    event), and the fleet re-meshes without it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .membership import Membership


@dataclass
class MeshPlan:
    data_axis: int
    model_axis: int
    participants: List[int]
    dropped: List[int] = field(default_factory=list)

    @property
    def size(self) -> int:
        return self.data_axis * self.model_axis


class ElasticController:
    def __init__(self, membership: Membership, *, model_axis: int,
                 min_data_axis: int = 1):
        self.membership = membership
        self.model_axis = model_axis
        self.min_data_axis = min_data_axis
        self.generation = 0
        self.plan: Optional[MeshPlan] = None
        self._heartbeats: Dict[int, float] = {}
        membership.subscribe(lambda ev: self.replan())

    # -- re-meshing -------------------------------------------------------------
    def replan(self) -> MeshPlan:
        members = self.membership.members()
        hosts_per_group = self.model_axis
        groups = len(members) // hosts_per_group
        data_axis = 1 << max(0, int(math.floor(math.log2(max(groups, 1)))))
        data_axis = max(self.min_data_axis, data_axis)
        used = members[: data_axis * hosts_per_group]
        dropped = members[data_axis * hosts_per_group:]
        self.generation += 1
        self.plan = MeshPlan(data_axis, self.model_axis, used, dropped)
        return self.plan

    # -- straggler detection (Rule 5 generalized) ----------------------------------
    def heartbeat(self, node_id: int, step_time_s: float) -> None:
        self._heartbeats[node_id] = step_time_s

    def stragglers(self, factor: float = 2.0) -> List[int]:
        if len(self._heartbeats) < 3:
            return []
        times = sorted(self._heartbeats.values())
        median = times[len(times) // 2]
        t_detect = factor * max(median, 1e-9)
        return [nid for nid, t in self._heartbeats.items() if t > t_detect]

    def evict_stragglers(self, factor: float = 2.0) -> List[int]:
        out = self.stragglers(factor)
        for nid in out:
            self.membership.fail(nid)          # leave event -> replan()
            self._heartbeats.pop(nid, None)
        return out
