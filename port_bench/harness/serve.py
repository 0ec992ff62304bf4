"""The system under test and the loop that offers it the cell's traffic.

The port is reached through its public entry points only:
``repro_torch.models.Model``, ``repro_torch.runtime.Membership`` and
``repro_torch.serve.ServeCluster`` (``submit`` admits a whole prompt on
the session's owner replica and returns its first token; ``step`` runs
one decode round on every replica).  The loop is single-threaded, as a
front end over the cluster would be: between two steps it moves the
requests that came due into a queue and submits every queued request
whose replica set has a free slot.  Every request is timed from when it
was due.
"""
from __future__ import annotations

import contextlib
import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .traffic import Plan

WAIT_AFTER_CLOSE_S = 60.0          # first tokens still owed after the close


@dataclass
class Req:
    i: int
    sid: str
    prompt_len: int
    output_len: int
    due: float                      # host clock
    queued: float = 0.0             # when the loop saw it come due
    admit_start: float = 0.0
    admit_end: float = 0.0
    tokens_t: List[float] = field(default_factory=list)
    client: int = -1
    prompt: Optional[np.ndarray] = None
    failed: bool = False

    @property
    def done(self) -> bool:
        return len(self.tokens_t) >= self.output_len


@dataclass
class Window:
    t0: float
    t_end: float
    reqs: List[Req]
    traced: Optional[tuple] = None  # (start, stop) of the profiled part
    backlog_at_close: int = 0       # requests due, not yet admitted
    live_at_close: int = 0          # sessions decoding

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0

    def due_in_window(self) -> List[Req]:
        return [r for r in self.reqs if r.due < self.t_end]


def build_cluster(cfg_kwargs: Dict[str, Any], server: Dict[str, Any],
                  params, device):
    """The port's model over ``server["nodes"]`` ring nodes of one
    ``Membership``, one ``Replica`` a node, all on ``device``; returns
    (cluster, membership, [(host, port)] of the nodes)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    from repro_torch.runtime import Membership
    from repro_torch.serve import ServeCluster
    model = Model(ModelConfig(**cfg_kwargs))
    mem = Membership(t_q=60.0, now=lambda: 0.0, device=device)
    addrs = [(f"10.9.0.{i}", 9000) for i in range(int(server["nodes"]))]
    for host, port in addrs:
        mem.request_join(host, port)
    cluster = ServeCluster(mem, model, params, slots=int(server["slots"]),
                           max_len=int(server["max_len"]),
                           prefill_chunk=server["prefill_chunk"],
                           replication=int(server["replication"]),
                           device=device)
    return cluster, mem, addrs


def abstract_params(cfg_kwargs: Dict[str, Any]):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import Model
    return Model(ModelConfig(**cfg_kwargs)).abstract_params()


def _no_capacity(exc: BaseException) -> bool:
    return isinstance(exc, RuntimeError) and "no capacity" in str(exc)


def warm_up(cluster, warm: Dict[str, Any], vocab: int, seed: int) -> None:
    """Admit ``warm["sessions"]`` sessions at the mix's prompt lengths,
    with 1 .. ``warm["output"]`` tokens each (so the replicas' decode
    batches shrink through every bucket), and decode them to the end."""
    from repro_torch.serve import Request
    rng = np.random.default_rng([seed, 11])
    todo = deque()
    for j in range(int(warm["sessions"])):
        n = int(warm["prompts"][j % len(warm["prompts"])])
        todo.append(Request(f"warm-{j}", rng.integers(0, vocab, n,
                                                      dtype=np.int32),
                            1 + j % int(warm["output"])))
    while todo or cluster.live_sessions:
        while todo:
            try:
                cluster.submit(todo[0])
            except RuntimeError as exc:
                if not _no_capacity(exc):
                    raise
                break
            todo.popleft()
        if cluster.live_sessions:
            cluster.step()


def serve(cluster, plan: Plan, seconds: float, *,
          trace_span: Optional[tuple] = None, tracer=None,
          clock: Callable[[], float] = time.perf_counter) -> Window:
    """Offer ``plan`` for ``seconds`` and serve until every request due in
    the window has its first token (at most ``WAIT_AFTER_CLOSE_S`` past
    the close).  ``trace_span`` (start, seconds) into the window runs
    ``tracer`` (start / stop) between two iterations of the loop."""
    from repro_torch.serve import Request
    t0 = clock()
    t_end = t0 + seconds
    reqs: List[Req] = []
    queue: deque = deque()
    live: Dict[str, Req] = {}
    nxt = 0
    free_clients = [(t0 + c * plan.stagger, c) for c in range(plan.clients)]
    heapq.heapify(free_clients)         # (due, client) of idle clients
    traced = None
    at_close = None
    label = tracer.label if tracer is not None \
        else (lambda name: contextlib.nullcontext())

    def arrive(due: float, client: int, now: float) -> None:
        nonlocal nxt
        r = Req(nxt, f"s{plan.seed}-{nxt}", int(plan.prompt_len[nxt]),
                int(plan.output_len[nxt]), due, queued=now, client=client,
                prompt=plan.tokens(nxt))
        nxt += 1
        reqs.append(r)
        queue.append(r)

    def finished(r: Req, now: float) -> None:
        live.pop(r.sid, None)
        if r.client >= 0:
            heapq.heappush(free_clients, (now, r.client))

    while True:
        now = clock()
        open_ = now < t_end
        if tracer is not None and trace_span is not None:
            if traced is None and now >= t0 + trace_span[0]:
                tracer.start()
                traced = [now, None]
            elif traced is not None and traced[1] is None \
                    and (now >= traced[0] + trace_span[1] or not open_):
                tracer.stop()
                traced[1] = now
        if plan.due is not None:
            while nxt < len(plan) and t0 + plan.due[nxt] <= min(now, t_end) \
                    and plan.due[nxt] < seconds:
                arrive(t0 + float(plan.due[nxt]), -1, now)
        elif open_:
            while free_clients and free_clients[0][0] <= now \
                    and nxt < len(plan):
                due, c = heapq.heappop(free_clients)
                arrive(due, c, now)
        for r in list(queue):
            start = clock()
            try:
                with label("pb.submit"):
                    cluster.submit(Request(r.sid, r.prompt, r.output_len))
            except Exception as exc:        # noqa: BLE001  (counted as failed)
                if _no_capacity(exc):
                    continue
                from repro_torch.kernels.backend import DEVICE_FAULTS
                if isinstance(exc, DEVICE_FAULTS):
                    raise
                r.failed = True
                queue.remove(r)
                finished(r, clock())
                continue
            end = clock()
            queue.remove(r)
            r.admit_start, r.admit_end = start, end
            r.tokens_t.append(end)
            live[r.sid] = r
            if r.done:
                finished(r, end)
        if live:
            with label("pb.step"):
                toks = cluster.step()
            end = clock()
            for sid in toks:
                r = live.get(sid)
                if r is None:
                    continue
                r.tokens_t.append(end)
                if r.done:
                    finished(r, end)
        elif not queue and open_:
            nxt_due = None
            if plan.due is not None and nxt < len(plan):
                nxt_due = t0 + float(plan.due[nxt])
            elif free_clients:
                nxt_due = free_clients[0][0]
            wait = None if nxt_due is None else nxt_due - clock()
            if wait is not None and wait > 0:
                time.sleep(min(wait, 0.005))
        if not open_:
            if at_close is None:
                at_close = (len(queue), len(live))
            owed = [r for r in reqs if r.due < t_end and not r.tokens_t
                    and not r.failed]
            if not owed or clock() > t_end + WAIT_AFTER_CLOSE_S:
                break
    if traced is not None and traced[1] is None:
        tracer.stop()
        traced[1] = clock()
    return Window(t0, t_end, reqs, None if traced is None else tuple(traced),
                  *(at_close or (0, 0)))
